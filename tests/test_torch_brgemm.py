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
