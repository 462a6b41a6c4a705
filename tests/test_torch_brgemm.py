"""``paddle_tpu_torch.ops.kernels.brgemm`` (the BRGEMM kernel's plain twin
and its 1x1-conv row map) against the JAX package's ``tpp.brgemm``, run as
``tests/test_tpp.py`` runs it on the CPU: the Pallas kernel in interpret
mode and its jnp reference.

Tolerance: atol = rtol = 2e-5 on y and on the column sums, 2e-3 atol on
the sums of squares (they reach ~1e2 at these shapes) — the f32
summation-order bound ``tests/test_tpp.py`` holds the Pallas kernel to.
The kernel itself is held against the twin on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import tpp
from paddle_tpu_torch.ops.kernels import brgemm as BR

SHAPES = [(1, 8, 4, 8), (3, 17, 9, 21), (2, 30, 12, 7), (1, 130, 5, 129)]
MODES = ["none", "relu", "affine", "affine_relu", "stats",
         "affine_relu_stats"]


def _inputs(rng, g, m, k, n, mode):
    a = rng.normal(size=(g, m, k)).astype(np.float32)
    b = rng.normal(size=(g, k, n)).astype(np.float32)
    kw = {}
    if "affine" in mode:
        kw["scale"] = rng.normal(size=(n,)).astype(np.float32)
        kw["shift"] = rng.normal(size=(n,)).astype(np.float32)
    if "relu" in mode:
        kw["act"] = "relu"
    return a, b, kw, "stats" in mode


def _check(got, want, stats):
    got = got if stats else (got,)
    want = want if stats else (want,)
    tols = [(2e-5, 2e-5), (2e-5, 2e-4), (2e-5, 2e-3)]
    for x, y, (rtol, atol) in zip(got, want, tols):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", MODES)
def test_brgemm_twin_matches_jax_kernel_and_reference(shape, mode):
    rng = np.random.default_rng(sum(shape))
    a, b, kw, stats = _inputs(rng, *shape, mode)
    got = BR.brgemm(torch.from_numpy(a), torch.from_numpy(b), stats=stats,
                    **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                           else v) for k, v in kw.items()})
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ker = tpp.brgemm(jnp.asarray(a), jnp.asarray(b), stats=stats,
                     impl="kernel", interpret=True, **jkw)
    ref = tpp.brgemm_reference(jnp.asarray(a), jnp.asarray(b), stats=stats,
                               **jkw)
    _check(got, ker, stats)
    _check(got, ref, stats)
    if "relu" in mode:
        y = got[0] if stats else got
        assert float(y.min()) >= 0.0


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("stats", [False, True])
def test_conv1x1_row_map_equals_brgemm_on_strided_rows(stride, stats):
    """The 1x1-conv entry reads pixel rows at a stride; its twin equals
    the JAX package's route (slice x[:, ::s, ::s], then brgemm)."""
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 13, 14, 5)).astype(np.float32)
    w = rng.normal(size=(1, 1, 5, 9)).astype(np.float32)
    got = BR.conv1x1(torch.from_numpy(x), torch.from_numpy(w),
                     (stride, stride), stats=stats)
    xs = jnp.asarray(x)[:, ::stride, ::stride]
    n, oh, ow, _ = xs.shape
    want = tpp.brgemm(xs.reshape(1, n * oh * ow, 5),
                      jnp.asarray(w).reshape(1, 5, 9), stats=stats,
                      impl="kernel", interpret=True)
    if stats:
        assert got[0].shape == (n, oh, ow, 9)
        _check((got[0].reshape(-1, 9), got[1], got[2]), want, True)
    else:
        assert got.shape == (n, oh, ow, 9)
        _check(got.reshape(-1, 9), want, False)


def test_epilogue_arguments_are_checked():
    a, b = torch.zeros(1, 2, 3), torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="act"):
        BR.brgemm(a, b, act="tanh")
    with pytest.raises(ValueError, match="scale and shift"):
        BR.brgemm(a, b, scale=torch.ones(4))


def test_an_edited_shared_header_rebuilds_the_libraries(tmp_path, monkeypatch):
    """Both conv kernels include ``csrc/gemm_f32.cuh``: a library is keyed
    by its source AND the shared headers, so an edited header is never
    served from a stale build."""
    from paddle_tpu_torch.ops.kernels import _build

    (tmp_path / "k.cu").write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    (tmp_path / "g.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before
    assert _build.library_path("k") == _build.library_path("k")


# -- the shared tile's plan (csrc/gemm_f32.cuh's tile and copy form) ----------

H100_SMS = 132


@pytest.mark.parametrize("run,n,ptrs,vec", [
    (64, 256, (0, 256), True),      # ResNet's 1x1 and 3x3 convs
    (96, 256, (16, 4096), True),    # AlexNet conv2: Cin 96
    (8, 12, (0, 0), True),          # Cin 8: slices straddle the taps
    (3, 64, (0, 0), False),         # the stem, AlexNet conv1: Cin 3
    (1, 16, (0, 0), False),         # the CRNN's first conv: Cin 1
    (147, 64, (0, 0), False),       # an odd K
    (64, 9, (0, 0), False),         # N not a multiple of 4
    (64, 64, (4, 0), False),        # A at a storage offset of one float
    (64, 64, (0, 8), False),        # B 8 bytes past a 16-byte boundary
])
def test_plan_picks_the_copy_form_by_shape_and_alignment(run, n, ptrs, vec):
    assert BR.plan(4096, n, 9 * run, run, ptrs, H100_SMS).vec is vec


@pytest.mark.parametrize("m,n,kred,plan", [
    (64 * 56 * 56, 64, 576, (64, 64, 1)),       # res2 3x3: 3.96 waves
    (64 * 56 * 56, 256, 64, (128, 64, 1)),      # res2 branch2c: 15.8
    (64 * 112 * 112, 64, 147, (128, 64, 1)),    # the stem: 15.8
    (64 * 28 * 28, 128, 1152, (64, 64, 1)),     # res3 3x3
    (64 * 14 * 14, 256, 2304, (64, 64, 1)),     # res4 3x3: 784 blocks
    (64 * 7 * 7, 512, 4608, (64, 64, 2)),       # res5 3x3: 392 for 792
    (64 * 7 * 7, 512, 2048, (64, 64, 2)),       # res5 branch2a
    (64 * 7 * 7, 2048, 512, (64, 64, 1)),       # res5 branch2c: 1,568
    (128 * 4 * 4, 512, 4608, (64, 64, 3)),      # small_vgg's last group
    (128 * 32 * 32, 64, 576, (64, 64, 1)),      # small_vgg's widest
    (64 * 27 * 27, 256, 2400, (64, 64, 1)),     # AlexNet conv2
    (5, 9, 576, (64, 64, 2)),                   # 36 slices: 2 splits of 18
    (300, 130, 64, (64, 64, 1)),                # 4 slices: no split
    (98, 512, 4608, (64, 64, 8)),               # res5 3x3 at batch 2
])
def test_plan_picks_the_tile_and_split_for_the_card(m, n, kred, plan):
    p = BR.plan(m, n, kred, 64, (0, 0), H100_SMS)
    assert (p.block_m, p.block_n, p.splits) == plan
    slices = -(-kred // BR.F32.block_k)
    assert 1 <= p.splits <= max(1, min(BR.MAX_SPLITS,
                                       slices // BR.MIN_SPLIT_SLICES))
    if p.splits > 1:    # a split only where the grid holds fewer blocks
        assert BR.Plan(p.block_m, p.block_n, True).blocks(m, n) \
            < H100_SMS * BR.F32.resident[(p.block_m, p.block_n, True)]
    if (p.block_m, p.block_n) != BR.F32.tiles[-1]:
        assert p.blocks(m, n) >= BR.MIN_WAVES * H100_SMS * BR.F32.resident[
            (p.block_m, p.block_n, True)]


@pytest.mark.parametrize("block_m,m,tiles", [
    (128, 64 * 56 * 56, 1568), (128, 129, 2), (128, 1, 1),
    (64, 128 * 4 * 4, 32), (64, 129, 3), (64, 64, 1),
])
def test_stats_partials_are_sized_by_the_plans_row_tiles(block_m, m, tiles):
    assert BR.Plan(block_m, 64, True).row_tiles(m) == tiles


def test_plan_tiles_are_the_ones_the_cuda_tile_instantiates():
    """Every form's ``tiles`` (``F32``, ``BF16``) and the one tile
    dispatch of ``csrc/gemm_f32.cuh`` (``gemm::dispatch``, which both
    headers' launches and occupancy queries go through) name the same
    (block_m, block_n) pairs, so the plan never asks for a tile the
    library does not have."""
    import re
    from pathlib import Path

    csrc = Path(BR.__file__).parent / "csrc"
    src = (csrc / "gemm_f32.cuh").read_text()
    body = src[src.index("cudaError_t dispatch("):]
    body = body[:body.index("return cudaErrorInvalidValue")]
    found = re.findall(r"block_m == (\d+) && block_n == (\d+)", body)
    for form in BR.FORMS.values():
        assert tuple((int(a), int(b)) for a, b in found) == form.tiles
    for name in ("gemm_f32.cuh", "gemm_bf16.cuh", "brgemm.cu",
                 "conv2d_direct.cu"):
        text = (csrc / name).read_text()
        assert name == "gemm_f32.cuh" or "block_m == " not in text, name


def test_direct_plan_reads_cin_and_the_operands_alignment():
    """The direct conv's plan: Cin is the reduction's contiguous run, and a
    contiguous view at a storage offset of one float takes the 4-byte
    form."""
    from paddle_tpu_torch.ops.kernels import conv as CV

    w = torch.zeros(3, 3, 64, 64)
    x = torch.zeros(2, 8, 8, 64)
    buf = torch.zeros(x.numel() + 1)
    shifted = buf[1:].view(2, 8, 8, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert CV.direct_plan(x, w, 128, H100_SMS).vec
    assert not CV.direct_plan(shifted, w, 128, H100_SMS).vec
    stem = CV.direct_plan(torch.zeros(2, 8, 8, 3), torch.zeros(7, 7, 3, 64),
                          64 * 112 * 112, H100_SMS)
    assert stem == BR.Plan(128, 64, False, 1)
    res5 = CV.direct_plan(torch.zeros(2, 7, 7, 512),
                          torch.zeros(3, 3, 512, 512), 64 * 7 * 7, H100_SMS)
    assert res5 == BR.Plan(64, 64, True, 2)     # Kred 4608 reaches the plan


# -- the Hopper bf16 tile (csrc/gemm_wgmma.cuh) and the host path ------------


@pytest.mark.parametrize("run,n,ptrs,wgmma", [
    (64, 256, (0, 256), True),      # ResNet's 1x1 and 3x3 convs
    (96, 256, (16, 4096), True),    # AlexNet conv2: Cin 96
    (8, 16, (0, 0), True),          # Cin 8
    (3, 64, (0, 0), False),         # the stem, AlexNet conv1: Cin 3
    (1, 16, (0, 0), False),         # the CRNN's first conv: Cin 1
    (12, 16, (0, 0), False),        # Cin 12: 4 mod 8
    (64, 12, (0, 0), False),        # N 12
    (64, 64, (2, 0), False),        # A at a storage offset of one bf16
    (64, 64, (0, 8), False),        # B 8 bytes past a 16-byte boundary
])
def test_plan_takes_the_hopper_tile_exactly_where_copies_are_16_bytes(
        run, n, ptrs, wgmma):
    """bf16 shapes whose run and N are multiples of 8 on 16-byte aligned
    operands take the wgmma tile (block_m 128, the 16-byte form); every
    other bf16 shape the mma.sync tile's register-staged form; f32 never
    the Hopper tile."""
    p = BR.plan(4096, n, 9 * run, run, ptrs, H100_SMS, BR.BF16)
    assert p.wgmma is wgmma and p.vec is wgmma
    if wgmma:
        assert (p.block_m, p.block_n) in BR.WGMMA.tiles
    else:
        assert (p.block_m, p.block_n) in BR.BF16.tiles
    assert not BR.plan(4096, n, 9 * run, run, ptrs, H100_SMS).wgmma


#: the Hopper tile's plan at every bf16 shape chip_smoke.py times
#: (RESNET_1X1, DIRECT_SHAPES but the Cin-3 convs): (block_n, splits)
WGMMA_PLANS = {
    "res2_1_branch2a": (64, 1), "res2_2a": (64, 1), "res2_2c": (256, 1),
    "res3_1_branch2a_s2": (128, 1), "res3_1_branch1_s2": (256, 1),
    "res3_2a": (128, 1), "res3_2c": (256, 1),
    "res4_1_branch2a_s2": (256, 1), "res4_1_branch1_s2": (256, 1),
    "res4_2a": (256, 1), "res4_2c": (256, 1),
    "res5_1_branch2a_s2": (128, 1), "res5_1_branch1_s2": (256, 1),
    "res5_2a": (128, 1), "res5_2c": (256, 1),
    "res2_3x3": (64, 1), "res3_3x3": (128, 1), "res4_3x3": (256, 1),
    "res5_3x3": (128, 1), "alexnet_conv2": (256, 1),
    "small_vgg_widest": (64, 1), "small_vgg_narrowest": (64, 1),
}


def _smoke_shapes():
    import chip_smoke as S

    for label, (n, h, w, cin), cout, s in S.RESNET_1X1:
        oh = (h - 1) // s + 1
        yield label, n * oh * ((w - 1) // s + 1), cout, cin, cin
    for label, (n, h, w, cin), (k, cout, s, p), _ in S.DIRECT_SHAPES:
        if cin % 8 == 0:
            oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            yield label, n * oh * ow, cout, k * k * cin, cin


@pytest.mark.parametrize("label", sorted(WGMMA_PLANS))
def test_hopper_tile_width_and_split_follow_n_and_the_persistent_grid(
        label):
    """BN follows N (Cout 64 on the 64-wide tile, so it wastes no
    columns); a split only where the widest tiles leave most of the
    persistent grid (132 blocks, one an SM) idle, each split at least
    MIN_SPLIT_SLICES stages; the table is the plan's at every smoke
    shape."""
    m, n, kred, run = next((m, n, kred, run) for lab, m, n, kred, run
                           in _smoke_shapes() if lab == label)
    p = BR.plan(m, n, kred, run, (0, 0), H100_SMS, BR.BF16)
    assert p.wgmma and p.block_m == 128
    assert (p.block_n, p.splits) == WGMMA_PLANS[label]
    assert p.block_n <= max(64, n)      # no tile wider than N needs
    tiles = -(-m // 128) * -(-n // p.block_n)
    grid = H100_SMS * BR.WGMMA.resident[(128, p.block_n, True)]
    if p.splits > 1:
        assert tiles < grid
        assert -(-kred // 64) // p.splits >= BR.MIN_SPLIT_SLICES


def test_hopper_tile_cost_model_prefers_fewer_rounds_and_wider_tiles():
    """The model's pieces: at one round a wider tile wins; a split pays
    only when it cuts the rounds' stages by more than its second pass
    costs."""
    # 98 row tiles x 1 of 256: one round of 98 blocks
    assert BR._wgmma_tile(98 * 128, 256, 2304, H100_SMS) == (256, 1)
    # 16 row tiles x 8 of 64: one round of 128 narrow blocks beats 32
    # wide ones split 4 ways (their second pass)
    assert BR._wgmma_tile(16 * 128, 512, 4608, H100_SMS) == (64, 1)
    # res5's 3x3 at batch 2: 8 blocks of 72 stages; 4 splits of 18
    assert BR._wgmma_tile(98, 512, 4608, H100_SMS) == (64, 4)
    # a short reduction is never split
    assert BR._wgmma_tile(128, 64, 576, H100_SMS) == (64, 1)


def test_wgmma_tiles_are_the_ones_the_header_instantiates():
    """``WGMMA.tiles`` names the block_n of ``wgmma::dispatch`` in
    ``csrc/gemm_wgmma.cuh`` (widest first) at block_m ``kBM``, and its
    ``resident`` table covers each in the 16-byte form only."""
    import re
    from pathlib import Path

    src = (Path(BR.__file__).parent / "csrc" / "gemm_wgmma.cuh").read_text()
    body = src[src.index("cudaError_t dispatch("):]
    body = body[:body.index("return cudaErrorInvalidValue")]
    widths = tuple(int(b) for b in re.findall(r"block_n == (\d+)", body))
    bm = int(re.search(r"constexpr int kBM = (\d+);", src).group(1))
    assert tuple((bm, b) for b in widths) == BR.WGMMA.tiles
    assert set(BR.WGMMA.resident) == {t + (True,) for t in BR.WGMMA.tiles}
    assert BR.WGMMA.block_k == int(
        re.search(r"constexpr int kBK = (\d+);", src).group(1))


def _c_struct(source: str, name: str) -> list:
    import re
    from pathlib import Path

    src = (Path(BR.__file__).parent / "csrc" / source).read_text()
    body = src[src.index(f"struct {name} {{"):]
    body = body[body.index("{") + 1:body.index("};")]
    return [re.fullmatch(r"\s*(.+?)\s*(\w+);", line).groups()
            for line in body.strip().splitlines()]


@pytest.mark.parametrize("source,name,cls", [
    ("brgemm.cu", "BrgemmParams", "BR.BrgemmParams"),
    ("conv2d_direct.cu", "ConvParams", "CV.ConvParams"),
])
def test_parameter_blocks_match_the_c_structs(source, name, cls):
    """Each ctypes parameter block has the C struct's fields in order,
    by name and type: a pointer as ``c_void_p``, an int as ``c_int``."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import conv as CV

    struct = eval(cls, {"BR": BR, "CV": CV})
    fields = _c_struct(source, name)
    assert [n for _, n in fields] == [n for n, _ in struct._fields_]
    for (ctype, n), (_, pytype) in zip(fields, struct._fields_):
        assert pytype is (ctypes.c_void_p if ctype.endswith("*")
                          else ctypes.c_int), (n, ctype)
        assert ctype.endswith("*") or ctype == "int", (n, ctype)


def test_every_entry_takes_the_parameter_block_and_the_stream():
    """Each C entry of the shared tiles takes (const <Params>*, void*):
    what ``ENTRY_ARGS`` passes."""
    import ctypes
    import re
    from pathlib import Path

    from paddle_tpu_torch.ops.kernels import conv as CV

    csrc = Path(BR.__file__).parent / "csrc"
    assert BR.ENTRY_ARGS == [ctypes.c_void_p, ctypes.c_void_p]
    for source, params, kernels in (
            ("brgemm.cu", "BrgemmParams", (BR.KERNEL, BR.KERNEL_BF16,
                                           BR.KERNEL_WGMMA)),
            ("conv2d_direct.cu", "ConvParams", (CV.KERNEL, CV.KERNEL_BF16,
                                                CV.KERNEL_WGMMA))):
        src = (csrc / source).read_text()
        for k in kernels:
            assert k.argtypes == BR.ENTRY_ARGS
            assert re.search(rf'extern "C" int {k.symbol}\(const {params}\* '
                             rf'p, void\* stream\)', src), k.symbol


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    """On the CPU every entry takes its plain twin: no kernel counter
    moves, and bf16 conv and 1x1 outputs equal the twins' bits."""
    from paddle_tpu_torch.ops.kernels import conv as CV

    kernels = [BR.KERNEL, BR.KERNEL_BF16, BR.KERNEL_WGMMA, CV.KERNEL,
               CV.KERNEL_BF16, CV.KERNEL_WGMMA]
    before = [k.launches for k in kernels]
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.normal(size=(2, 9, 9, 16)).astype(
        np.float32)).to(torch.bfloat16)
    w3 = torch.from_numpy(rng.normal(size=(3, 3, 16, 24)).astype(
        np.float32)).to(torch.bfloat16)
    w1 = w3[:1, :1].contiguous()
    for w, pads in ((w3, (1, 1)), (w1, (0, 0))):
        got = CV.fwd_raw(x, w, (1, 1), pads, stats=True)
        want = CV.fwd_raw_reference(x, w, (1, 1), pads, stats=True)
        assert all(torch.equal(a, b.reshape(a.shape))
                   for a, b in zip(got, want))
    assert [k.launches for k in kernels] == before
