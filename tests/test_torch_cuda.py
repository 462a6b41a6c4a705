"""The port's CUDA kernels against their plain twins, on the card.

Run on a machine with an NVIDIA card (sm_90a) and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips: the decision is made inside the
``cuda`` fixture, never at import, so every pytest-xdist worker collects
the same tests.  Tolerance: 1e-4 absolute, the f32 round-off of a
different summation order (FMA chains in the kernel vs cuBLAS in the
twin) at these magnitudes; TF32 is off on both sides."""

import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.dtype import set_policy
from paddle_tpu_torch.ops.kernels import _kept
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import paged_attention as PA

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU host)")
    set_policy()
    return torch.device("cuda", 0)


def _rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("b,t,h,d,causal", [
    (2, 64, 2, 64, True),
    (2, 100, 3, 64, True),
    (1, 333, 2, 64, False),
    (2, 130, 2, 16, True),
    (1, 70, 2, 32, False),
    (1, 129, 2, 128, True),
])
def test_flash_kernel_matches_plain(cuda, b, t, h, d, causal):
    rng = np.random.default_rng(t * d)
    q, k, v = (_rand(rng, b, t, h, d).to(cuda) for _ in range(3))
    before = FA.KERNEL.launches
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.KERNEL.launches == before + 1
    qp, kp, vp = FA._prep(q, k, v)
    o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t, causal, d ** -0.5)
    o_ref = FA._from_bh(o_ref, b, h, t, d)
    assert o.shape == (b, t, h, d) and lse.shape == (b * h, t, 1)
    assert (o - o_ref).abs().max().item() <= TOL
    assert (lse - lse_ref[:, :t]).abs().max().item() <= TOL
    ref = FA.flash_attention_reference(q, k, v, causal=causal)
    assert (o - ref).abs().max().item() <= TOL


def _paged(rng, lens, h, d, ps, maxp, device):
    b = len(lens)
    pool = 1 + sum(-(-n // ps) for n in lens) + 3
    table = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, pool))  # scattered page ids
    nxt = 0
    for i, n in enumerate(lens):
        for j in range(-(-n // ps)):
            table[i, j] = perm[nxt]
            nxt += 1
    kp = _rand(rng, h, pool, ps, d).to(device)
    vp = _rand(rng, h, pool, ps, d).to(device)
    q = _rand(rng, b, h, d).to(device)
    return (q, kp, vp, torch.from_numpy(table).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


@pytest.mark.parametrize("d,ps", [(64, 16), (16, 8), (128, 16), (32, 4)])
def test_paged_kernel_matches_plain(cuda, d, ps):
    rng = np.random.default_rng(d + ps)
    lens = [0, 1, 16, 17, 5, 0, 33, 64]
    maxp = -(-64 // ps)
    q, kp, vp, table, seq = _paged(rng, lens, 3, d, ps, maxp, cuda)
    before = PA.KERNEL.launches
    out = PA.ragged_paged_attention(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    assert PA.KERNEL.launches == before + 1
    ref = PA.ragged_paged_attention_reference(q, kp, vp, table, seq)
    assert (out - ref).abs().max().item() <= TOL
    idle = torch.tensor(lens, device=cuda) == 0
    assert torch.equal(out[idle], torch.zeros_like(out[idle]))
    assert torch.isfinite(out).all()


# The bf16 paged kernel against its twin (``chip_smoke.paged_bf16_agreement``:
# equal on all but 1% of the elements, each within one bf16 ulp plus 2^-7
# of sum_j p_j |v_j| / l, a rounded p flipped; a rerun in the same bits;
# idle rows exactly 0).
@pytest.mark.parametrize("d,ps", [(32, 8), (32, 16), (64, 8), (64, 16),
                                  (128, 8), (128, 16)])
def test_paged_bf16_kernel_matches_its_twin(cuda, d, ps):
    import chip_smoke as S

    rng = np.random.default_rng(d * ps)
    lens = [0, 1, 16, 17, 5, 0, 33, 200]
    maxp = -(-200 // ps)
    q, kp, vp, table, seq = _paged(rng, lens, 3, d, ps, maxp, cuda)
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    before = PA.KERNEL.launches, PA.KERNEL_BF16.launches
    a = S.paged_bf16_agreement(q, kp, vp, table, seq)
    assert a["agrees"], a
    assert a["idle_rows_zero"] and a["rerun_bit_identical"]
    assert (PA.KERNEL.launches, PA.KERNEL_BF16.launches) == (
        before[0], before[1] + 2)


def test_paged_bf16_refuses_what_it_does_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError

    bf = torch.bfloat16
    table = torch.ones(3, 2, dtype=torch.int32, device=cuda)
    lens = torch.full((3,), 5, dtype=torch.int32, device=cuda)

    def call(d=64, q_dtype=bf, pool_dtype=bf, offset=0):
        flat = torch.zeros(3 * 2 * d + offset, dtype=q_dtype, device=cuda)
        q = flat[offset:].view(3, 2, d)
        pool = torch.zeros(2, 4, 8, d, dtype=pool_dtype, device=cuda)
        return PA.ragged_paged_attention(q, pool, pool, table, lens)

    with pytest.raises(EnforceError, match="one dtype"):
        call(pool_dtype=torch.float32)
    with pytest.raises(EnforceError, match="one dtype"):
        call(q_dtype=torch.float32)
    with pytest.raises(EnforceError, match="16-byte aligned"):
        call(offset=1)
    with pytest.raises(EnforceError, match="head_dim 136 > 128"):
        call(d=136)
    with pytest.raises(EnforceError, match="multiple of 8"):
        call(d=20)
    assert call().dtype == bf   # the same call, well formed, runs


def test_engine_on_card_serves_bf16_through_both_bf16_kernels(cuda):
    import chip_smoke as S
    from paddle_tpu_torch.core.dtype import cast_floats
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = T.TransformerConfig(vocab_size=512, num_layers=2, num_heads=2,
                              embed_dim=64, mlp_dim=128, max_seq_len=256,
                              attn_impl="flash")
    params = cast_floats(
        T.init_params(cfg, torch.Generator().manual_seed(1), cuda),
        torch.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 512, size=n)) for n in (3, 40, 130, 9)]
    eng = ServingEngine(cfg, params, ServingConfig(
        max_slots=2, page_size=16, num_pages=40, max_prompt_len=160,
        max_new_tokens=16, prefill_batch=2, seed=0), device=cuda)
    assert eng.cache.k.dtype == torch.bfloat16
    kernels = (FA.KERNEL, PA.KERNEL, FA.KERNEL_BF16, PA.KERNEL_BF16)
    before = [k.launches for k in kernels]
    results = eng.generate(prompts, max_new_tokens=12)
    moved = [k.launches - b for k, b in zip(kernels, before)]
    assert moved[:2] == [0, 0] and moved[2] > 0 and moved[3] > 0, moved
    assert moved[2] % 2 == 0 and moved[3] % 2 == 0   # one a layer
    margin = S.served_margin_check(cfg, params, results)
    assert margin["ok"], margin


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError

    for dtype in (torch.float64, torch.float16):
        q = torch.zeros(1, 64, 2, 64, dtype=dtype, device=cuda)
        with pytest.raises(EnforceError, match="float32"):
            FA.flash_attention_fwd(q, q, q, causal=True)
    q = torch.zeros(1, 64, 2, 48, device=cuda)
    with pytest.raises(EnforceError, match="head_dim"):
        FA.flash_attention_fwd(q, q, q, causal=True)
    pool = torch.zeros(2, 4, 8, 16, device=cuda)
    table = torch.zeros(3, 2, dtype=torch.int64, device=cuda)
    lens = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(EnforceError, match="int32"):
        PA.ragged_paged_attention(torch.zeros(3, 2, 16, device=cuda), pool,
                                  pool, table, lens)


def test_engine_on_card_greedy_equals_full_context_argmax(cuda):
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = T.TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                              embed_dim=64, mlp_dim=128, max_seq_len=128,
                              attn_impl="flash")
    params = T.init_params(cfg, torch.Generator().manual_seed(1), cuda)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 64, size=n)) for n in (3, 40, 70, 9)]
    eng = ServingEngine(cfg, params, ServingConfig(
        max_slots=2, page_size=16, num_pages=32, max_prompt_len=80,
        max_new_tokens=8, prefill_batch=2, seed=0), device=cuda)
    fa0, pa0 = FA.KERNEL.launches, PA.KERNEL.launches
    results = eng.generate(prompts, max_new_tokens=6)
    assert FA.KERNEL.launches > fa0 and PA.KERNEL.launches > pa0
    for prompt, res in zip(prompts, results):
        full = torch.tensor([prompt + res.tokens], device=cuda)
        logits = T.forward(cfg, params, full)
        want = logits[0, len(prompt) - 1:-1].argmax(-1).tolist()
        assert res.tokens == want


# -- BRGEMM and direct conv (the ResNet-50 conv path) --------------------------


@pytest.mark.parametrize("g,m,k,n", [
    (1, 300, 64, 256),    # M not a multiple of the 128-row tile
    (3, 17, 9, 21),       # ragged everything, G > 1
    (1, 129, 147, 64),    # odd K, N at the 64-column tile
    (2, 1, 5, 130),       # one row, N past the 128-column tile
])
@pytest.mark.parametrize("mode", ["none", "stats", "affine_relu"])
def test_brgemm_kernel_matches_plain(cuda, g, m, k, n, mode):
    from paddle_tpu_torch.ops.kernels import brgemm as BR

    rng = np.random.default_rng(g * 1000 + m + k + n)
    a, b = _rand(rng, g, m, k).to(cuda), _rand(rng, g, k, n).to(cuda)
    kw = {}
    if mode == "affine_relu":
        kw = dict(scale=_rand(rng, n).to(cuda), shift=_rand(rng, n).to(cuda),
                  act="relu")
    stats = mode == "stats"
    before = BR.KERNEL.launches
    got = BR.brgemm(a, b, stats=stats, **kw)
    torch.cuda.synchronize()
    assert BR.KERNEL.launches == before + 1
    want = BR.brgemm_reference(a, b, stats=stats, **kw)
    got, want = (got, want) if stats else ((got,), (want,))
    for x, y in zip(got, want):
        assert x.shape == y.shape
        scale = max(1.0, y.abs().max().item())
        assert (x - y).abs().max().item() <= TOL * scale
    if stats:   # fixed summation order: a rerun is bit-identical
        again = BR.brgemm(a, b, stats=True)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


CONV_CFGS = [(3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0), (7, 2, 3)]


@pytest.mark.parametrize("k,s,p", CONV_CFGS)
@pytest.mark.parametrize("mode", ["none", "stats", "affine_relu"])
def test_conv_kernels_match_plain_on_odd_shapes(cuda, k, s, p, mode):
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    rng = np.random.default_rng(k * 10 + s)
    x = _rand(rng, 2, 13, 14, 5).to(cuda)
    w = (_rand(rng, k, k, 5, 9) * 0.3).to(cuda)
    kw = {}
    if mode == "affine_relu":
        kw = dict(scale=_rand(rng, 9).to(cuda), shift=_rand(rng, 9).to(cuda),
                  act="relu")
    stats = mode == "stats"
    kern = BR.KERNEL if k == 1 else CV.KERNEL
    before = kern.launches
    got = CV.fwd_raw(x, w, (s, s), (p, p), stats=stats, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = CV.fwd_raw_reference(x, w, (s, s), (p, p), stats=stats, **kw)
    got, want = (got, want) if stats else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= TOL * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("is_train", [True, False])
def test_conv_bn_act_on_card_matches_reference_and_grads(cuda, is_train):
    from paddle_tpu_torch.ops.kernels import conv as CV

    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 13, 14, 4).to(cuda).requires_grad_()
    w = (_rand(rng, 3, 3, 4, 8) * 0.3).to(cuda).requires_grad_()
    ga = (_rand(rng, 8) * 0.2 + 1).to(cuda).requires_grad_()
    be = (_rand(rng, 8) * 0.2).to(cuda).requires_grad_()
    rm = (_rand(rng, 8) * 0.1).to(cuda)
    rv = (_rand(rng, 8).abs() + 0.5).to(cuda)
    r = _rand(rng, 2, 7, 7, 8).to(cuda)   # a random output cotangent
    outs = []
    for fn in (CV.conv2d_bn_act, CV.conv2d_bn_act_reference):
        y, nm, nv = fn(x, w, ga, be, rm, rv, is_train, stride=2, padding=1)
        grads = torch.autograd.grad((y * r).sum(), (x, w, ga, be))
        outs.append([y, nm, nv, *grads])
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 1e-3 * max(1.0, b.abs().max().item())


def test_conv_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    a = torch.zeros(1, 4, 3, dtype=torch.float64, device=cuda)
    with pytest.raises(EnforceError, match="float32"):
        BR.brgemm(a, torch.zeros(1, 3, 2, dtype=torch.float64, device=cuda))
    x = torch.zeros(1, 5, 5, 3, device=cuda).half()
    with pytest.raises(EnforceError, match="float32"):
        CV.fwd_raw(x, torch.zeros(3, 3, 3, 4, device=cuda).half(), (1, 1),
                   (1, 1))


# -- the shared f32 GEMM tile (csrc/gemm_f32.cuh): forms, tiles, tails ---------


def _tile_case(cuda, fn, kern, args, want_fn, stats):
    """One launch through ``fn`` against the twin: one launch counted,
    within TOL x max(1, |ref|) (the sums as the moments they feed), and,
    with stats, a rerun in the same bits."""
    before = kern.launches
    got = fn(*args, stats=stats)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = want_fn(*args, stats=stats)
    got, want = (got, want) if stats else ((got,), (want,))
    count = got[0].numel() // got[0].shape[-1]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        if i:
            a, b = a / count, b / count
        assert (a - b).abs().max().item() <= TOL * max(
            1.0, b.abs().max().item())
    if stats:
        again = fn(*args, stats=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got[0]


@pytest.mark.parametrize("shape,k,cout,s,p,vec", [
    ((2, 9, 11, 8), 3, 12, 1, 1, True),     # Cin 8: slices straddle taps
    ((2, 9, 11, 4), 3, 132, 2, 1, True),    # Kred 36; N past 128, % 4 == 0
    ((2, 6, 7, 12), 1, 20, 1, 1, True),     # Kred 12: below one slice
    ((3, 17, 19, 3), 7, 64, 2, 3, False),   # the stem's Cin 3, Kred 147
    ((2, 13, 14, 1), 3, 16, 1, 1, False),   # Cin 1, Kred 9
    ((2, 13, 14, 16), 3, 9, 1, 1, False),   # N = 9: the 4-byte form
    ((64, 7, 7, 512), 3, 512, 1, 1, True),  # res5 3x3: 2 splits
    ((128, 4, 4, 512), 3, 512, 1, 1, True),  # small_vgg's last group: 3
])
@pytest.mark.parametrize("stats", [False, True])
def test_gemm_tile_direct_conv_forms_and_tails(cuda, shape, k, cout, s, p,
                                               vec, stats):
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    rng = np.random.default_rng(shape[-1] * 100 + cout)
    x = _rand(rng, *shape).to(cuda)
    w = (_rand(rng, k, k, shape[-1], cout)
         * (2.0 / (k * k * shape[-1])) ** 0.5).to(cuda)
    m = shape[0] * ((shape[1] + 2 * p - k) // s + 1) * (
        (shape[2] + 2 * p - k) // s + 1)
    plan = CV.direct_plan(x, w, m, BR.sm_count(x.device))
    assert plan.vec is vec
    if BR.sm_count(x.device) == 132:    # an H100 SXM
        if shape == (64, 7, 7, 512):
            assert plan == BR.Plan(64, 64, True, 2)
        if shape == (128, 4, 4, 512):
            assert plan == BR.Plan(64, 64, True, 3)
    _tile_case(cuda, CV.fwd_raw, CV.KERNEL, (x, w, (s, s), (p, p)),
               CV.fwd_raw_reference, stats)


@pytest.mark.parametrize("g,m,k,n,vec,splits", [
    (3, 300, 64, 128, True, 1),     # G > 1, K % 16 == 0
    (4, 77, 36, 200, True, 1),      # G > 1, K % 16 != 0: slices straddle g
    (2, 50, 7, 64, False, 1),       # odd K: the 4-byte form
    (5, 33, 12, 44, True, 1),       # G K = 60: the tail of the last slice
    (1, 129, 4, 8, True, 1),        # Kred below one slice
    (2, 40, 512, 64, True, 4),      # a split: 4 x 16 slices across g
    (3, 21, 333, 30, False, 3),     # a ragged split in the 4-byte form
])
@pytest.mark.parametrize("stats", [False, True])
def test_gemm_tile_brgemm_stacks_forms_and_tails(cuda, g, m, k, n, vec,
                                                 splits, stats):
    from paddle_tpu_torch.ops.kernels import brgemm as BR

    rng = np.random.default_rng(g * 1000 + m + k + n)
    a, b = _rand(rng, g, m, k).to(cuda), _rand(rng, g, k, n).to(cuda)
    plan = BR.plan(m, n, g * k, k, (a.data_ptr(), b.data_ptr()),
                   BR.sm_count(a.device))
    assert plan.vec is vec
    if BR.sm_count(a.device) == 132:    # an H100 SXM
        assert plan.splits == splits
    _tile_case(cuda, BR.brgemm, BR.KERNEL, (a, b), BR.brgemm_reference,
               stats)


@pytest.mark.parametrize("tile", [(128, 64), (64, 64)])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("splits", [1, 3])
def test_gemm_tile_every_instantiation(cuda, monkeypatch, tile, vec, splits):
    """Each tile in each copy form, whole and split in 3, forced through
    the plan, on a conv and a strided 1x1 conv with ragged M and N past
    one column tile: against the twin, stats rerun in the same bits."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    monkeypatch.setattr(BR, "plan", lambda *a: BR.Plan(*tile, vec, splits))
    rng = np.random.default_rng(tile[0] + tile[1] + vec)
    x = _rand(rng, 3, 15, 13, 48).to(cuda)     # the 1x1's K: 3 slices
    w3 = (_rand(rng, 3, 3, 48, 136) * 0.1).to(cuda)
    w1 = (_rand(rng, 1, 1, 48, 136) * 0.2).to(cuda)
    _tile_case(cuda, CV.fwd_raw, CV.KERNEL, (x, w3, (1, 1), (1, 1)),
               CV.fwd_raw_reference, True)
    _tile_case(cuda, CV.fwd_raw, BR.KERNEL, (x, w1, (2, 2), (0, 0)),
               CV.fwd_raw_reference, True)


@pytest.mark.parametrize("tile", [(128, 64), (64, 64)])
@pytest.mark.parametrize("vec", [True, False])
def test_gemm_tile_resident_blocks_match_the_plan(cuda, tile, vec):
    """The plan's ``F32.resident`` (blocks an SM holds, which sets its waves and
    splits) is what the CUDA runtime computes for every instantiation of
    the tile, in both kernels: a change of registers or shared memory that
    moves it fails here, not silently in the plan."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    assert tile in BR.F32.tiles
    for kernel in (BR.KERNEL, CV.KERNEL):
        assert BR.resident(kernel, *tile, vec) == BR.F32.resident[
            tile + (vec,)]


def test_gemm_tile_copy_forms_give_the_same_bits(cuda):
    """An input at a storage offset of one float is not 16-byte aligned and
    takes the 4-byte form; both forms sum in the same order, so the
    outputs and the stats are equal bit for bit to the aligned input's."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    rng = np.random.default_rng(7)
    x = _rand(rng, 4, 14, 14, 64).to(cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    sms = BR.sm_count(x.device)
    for k, p, kern in ((3, 1, CV.KERNEL), (1, 0, BR.KERNEL)):
        w = (_rand(rng, k, k, 64, 96) * 0.1).to(cuda)
        m = 4 * 14 * 14
        if k == 3:
            assert CV.direct_plan(x, w, m, sms).vec
            assert not CV.direct_plan(shifted, w, m, sms).vec
        n = kern.launches
        aligned = CV.fwd_raw(x, w, (1, 1), (p, p), stats=True)
        offset = CV.fwd_raw(shifted, w, (1, 1), (p, p), stats=True)
        torch.cuda.synchronize()
        assert kern.launches == n + 2
        assert all(torch.equal(a, b) for a, b in zip(aligned, offset))
        want = CV.fwd_raw_reference(x, w, (1, 1), (p, p))
        assert (aligned[0] - want).abs().max().item() <= TOL * max(
            1.0, want.abs().max().item())


def test_gemm_tile_refuses_a_form_the_operands_do_not_allow(cuda):
    """The C entry checks the plan it is handed: the 16-byte form on a
    Cin-3 conv or a misaligned BRGEMM operand is refused, not run."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    x = torch.zeros(1, 8, 8, 3, device=cuda)
    w = torch.zeros(3, 3, 3, 8, device=cuda)
    p = BR.Plan(128, 64, True)
    conv = (1, 8, 8, 3, 3, 3, 8, 8, 8, 1, 1, 1, 1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.launch_gemm(CV.CONV, cuda, torch.float32, (64, 8), p, False, None,
                       None, None, x.data_ptr(), w.data_ptr(), conv)
    # more splits than the reduction (27) has slices (2)
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.launch_gemm(CV.CONV, cuda, torch.float32, (64, 8),
                       BR.Plan(64, 64, False, 3), False, None, None, None,
                       x.data_ptr(), w.data_ptr(), conv)
    a = torch.zeros(65, device=cuda)[1:].view(1, 8, 8)
    b = torch.zeros(1, 8, 8, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.launch_gemm(BR.BRGEMM, cuda, torch.float32, (8, 8), p, False, None,
                       None, None, a.data_ptr(), b.data_ptr(),
                       (1, 8, 8, 8, 1, 8, 1, 8, 1, 1))
    # the Hopper tile: bf16 only in its 16-byte form, block_m 128; the
    # mma.sync tile: the register-staged form only
    xb = torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16, device=cuda)
    wb = torch.zeros(3, 3, 16, 8, dtype=torch.bfloat16, device=cuda)
    convb = (1, 8, 8, 16, 3, 3, 8, 8, 8, 1, 1, 1, 1)
    for bad in (BR.Plan(128, 64, False, 1, True), BR.Plan(64, 64, True, 1,
                                                           True),
                BR.Plan(128, 96, True, 1, True), BR.Plan(128, 64, True)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            BR.launch_gemm(CV.CONV, cuda, torch.bfloat16, (64, 8), bad, False,
                           None, None, None, xb.data_ptr(), wb.data_ptr(),
                           convb)


# -- the bf16 forms (csrc/gemm_bf16.cuh, channel_stats_bf16) ----------------------


def _bf16_case(cuda, fn, kern, args, twin, stats, mag, kred):
    """One launch of a bf16 form through ``fn`` against ``twin`` on the
    f64 operands, rounded once to bf16: one launch counted, equal on all
    but 1% of the elements and each within one bf16 ulp of its own
    magnitude plus an f32 sum's error (sqrt(``kred``) 2^-24 ``mag``, the
    element's sum of |products|: ``chip_smoke.bf16_agrees``), the stats
    (f32) within 1e-4 as the moments they feed, a rerun in the same
    bits."""
    from chip_smoke import bf16_agreement, bf16_agrees

    before = kern.launches
    got = fn(*args, stats=stats)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    wide = [a.double() if torch.is_tensor(a) and a.is_floating_point()
            and a.dtype == torch.bfloat16 else a for a in args]
    want = twin(*wide, stats=stats)
    got, want = (got, want) if stats else ((got,), (want,))
    assert got[0].dtype == torch.bfloat16 and got[0].shape == want[0].shape
    assert bf16_agrees(got[0], want[0].to(torch.bfloat16), mag, kred), \
        bf16_agreement(got[0], want[0].to(torch.bfloat16), mag, kred)
    count = got[0].numel() // got[0].shape[-1]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        assert (a.double() / count - b / count).abs().max().item() <= TOL * \
            max(1.0, (b / count).abs().max().item())
    again = fn(*args, stats=stats)
    again = again if stats else (again,)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got[0]


def _conv_mag(x, w, s, p):
    """Each output's sum of |products| of a conv (the f32 sum's scale)."""
    from paddle_tpu_torch.ops.kernels import conv as CV

    return CV.fwd_raw_reference(x.double().abs(), w.double().abs(), s, p)


def _bf16(rng, *shape, scale=1.0):
    return (_rand(rng, *shape) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("shape,k,cout,s,p,vec", [
    ((2, 9, 11, 8), 3, 16, 1, 1, True),     # Cin 8: Kred 72, past a stage
    ((2, 9, 11, 16), 3, 136, 2, 1, True),   # N past 128, % 8 == 0
    ((2, 6, 7, 24), 1, 24, 1, 1, True),     # Kred 24: below one slice
    ((3, 17, 19, 3), 7, 64, 2, 3, False),   # the stem's Cin 3, Kred 147
    ((2, 13, 14, 1), 3, 16, 1, 1, False),   # Cin 1, Kred 9
    ((2, 13, 14, 16), 3, 12, 1, 1, False),  # N = 12: register-staged
    ((2, 13, 14, 12), 3, 16, 1, 1, False),  # Cin 12: register-staged
    ((64, 7, 7, 512), 3, 512, 1, 1, True),  # res5 3x3 at batch 64
    ((128, 4, 4, 512), 3, 512, 1, 1, True),  # small_vgg's last group
    ((16, 56, 56, 64), 3, 64, 1, 1, True),  # 392 tiles: past the grid
    ((3, 10, 10, 32), 3, 200, 1, 1, True),  # M 300, N 200: ragged tiles
])
@pytest.mark.parametrize("stats", [False, True])
def test_bf16_direct_conv_forms_and_tails(cuda, shape, k, cout, s, p, vec,
                                          stats):
    """The bf16 direct conv (and a 1x1 through the BRGEMM): the Hopper
    tile exactly where the copies can be 16 bytes wide, the mma.sync
    tile elsewhere, each against the f64 twin rounded once."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    rng = np.random.default_rng(shape[-1] * 100 + cout)
    x = _bf16(rng, *shape).to(cuda)
    w = _bf16(rng, k, k, shape[-1], cout,
              scale=(2.0 / (k * k * shape[-1])) ** 0.5).to(cuda)
    m = shape[0] * ((shape[1] + 2 * p - k) // s + 1) * (
        (shape[2] + 2 * p - k) // s + 1)
    plan = CV.direct_plan(x, w, m, BR.sm_count(x.device))
    assert plan.vec is vec and plan.wgmma is vec
    mod = BR if (k, p) == (1, 0) else CV
    kern = mod.KERNEL_WGMMA if vec else mod.KERNEL_BF16
    _bf16_case(cuda, CV.fwd_raw, kern, (x, w, (s, s), (p, p)),
               CV.fwd_raw_reference, stats,
               _conv_mag(x, w, (s, s), (p, p)), k * k * shape[-1])


@pytest.mark.parametrize("g,m,k,n,vec", [
    (3, 300, 64, 128, True),     # G > 1
    (4, 77, 40, 200, True),      # G > 1, K % 32 != 0: slices straddle g
    (2, 50, 7, 64, False),       # odd K: register-staged
    (5, 33, 16, 44, False),      # N % 8 != 0: register-staged
    (1, 129, 8, 8, True),        # Kred below one slice
    (2, 40, 512, 64, True),      # a long reduction across g
    (1, 128, 64, 64, True),      # one tile, one stage
    (3, 1000, 72, 264, True),    # K % 64 != 0 across g; N % 64 != 0
])
@pytest.mark.parametrize("mode", ["none", "stats", "affine_relu"])
def test_bf16_brgemm_stacks_forms_and_epilogues(cuda, g, m, k, n, vec,
                                                mode):
    from paddle_tpu_torch.ops.kernels import brgemm as BR

    rng = np.random.default_rng(g * 1000 + m + k + n)
    a, b = _bf16(rng, g, m, k).to(cuda), _bf16(rng, g, k, n).to(cuda)
    plan = BR.plan(m, n, g * k, k, (a.data_ptr(), b.data_ptr()),
                   BR.sm_count(a.device), BR.BF16)
    assert plan.vec is vec and plan.wgmma is vec
    kw = {}
    if mode == "affine_relu":
        kw = dict(scale=_rand(rng, n).to(cuda), shift=_rand(rng, n).to(cuda),
                  act="relu")

    def fn(a, b, stats):
        return BR.brgemm(a, b, stats=stats, **kw)

    def twin(a, b, stats):
        return BR.brgemm_reference(a, b, stats=stats, **kw)

    mag = BR.brgemm_reference(a.double().abs(), b.double().abs())
    if mode == "affine_relu":
        mag = mag * kw["scale"].double().abs()
    _bf16_case(cuda, fn, BR.KERNEL_WGMMA if vec else BR.KERNEL_BF16, (a, b),
               twin, mode == "stats", mag, g * k)


#: every bf16 instantiation: (tile, copy form, the Hopper tile); the
#: mma.sync tile has the register-staged form only
BF16_TILES = [((128, 64), False, False), ((64, 64), False, False),
              ((128, 256), True, True), ((128, 128), True, True),
              ((128, 64), True, True)]


@pytest.mark.parametrize("tile,vec,wgmma", BF16_TILES)
@pytest.mark.parametrize("splits", [1, 3])
def test_bf16_tile_every_instantiation(cuda, monkeypatch, tile, vec, wgmma,
                                       splits):
    """Each bf16 tile in each copy form, the mma.sync tile's and the
    Hopper tile's, whole and split in 3, forced through the plan, on a
    conv and a strided 1x1 conv with ragged M and N past one column
    tile.  The Hopper tile's 1x1 reads Cin 192 (3 of its 64-deep
    stages), the mma.sync tile's 96 (3 of its 32-deep slices)."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    monkeypatch.setattr(BR, "plan",
                        lambda *a: BR.Plan(*tile, vec, splits, wgmma))
    rng = np.random.default_rng(tile[0] + tile[1] + vec)
    cin = 192 if wgmma else 96
    x = _bf16(rng, 3, 15, 13, cin).to(cuda)
    w3 = _bf16(rng, 3, 3, cin, 136, scale=0.1).to(cuda)
    w1 = _bf16(rng, 1, 1, cin, 136, scale=0.2).to(cuda)
    kern = "KERNEL_WGMMA" if wgmma else "KERNEL_BF16"
    _bf16_case(cuda, CV.fwd_raw, getattr(CV, kern),
               (x, w3, (1, 1), (1, 1)), CV.fwd_raw_reference, True,
               _conv_mag(x, w3, (1, 1), (1, 1)), 9 * cin)
    _bf16_case(cuda, CV.fwd_raw, getattr(BR, kern), (x, w1, (2, 2), (0, 0)),
               CV.fwd_raw_reference, True,
               _conv_mag(x, w1, (2, 2), (0, 0)), cin)


@pytest.mark.parametrize("tile,vec,wgmma", BF16_TILES)
def test_bf16_tile_resident_blocks_match_the_plan(cuda, tile, vec, wgmma):
    """The plan's tables (``BF16.resident``, ``WGMMA.resident``) are the
    CUDA runtime's occupancy of every bf16 instantiation, in both
    kernels (the Hopper tile's after its shared-memory opt-in)."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    form = BR.WGMMA if wgmma else BR.BF16
    kern = "KERNEL_WGMMA" if wgmma else "KERNEL_BF16"
    assert tile in form.tiles
    for mod in (BR, CV):
        assert BR.resident(getattr(mod, kern), *tile, vec) == form.resident[
            tile + (vec,)]


def test_bf16_tile_planted_fault_fails_the_criterion(cuda):
    """A product whose accumulator is rounded to bf16 after every 16-deep
    slice (a bf16 accumulator) differs from the f64 twin's one rounding
    on more than 1% of the elements; the kernel does not."""
    from chip_smoke import bf16_agrees, slice_rounded_product
    from paddle_tpu_torch.ops.kernels import brgemm as BR

    rng = np.random.default_rng(3)
    a, b = _bf16(rng, 1, 4096, 256).to(cuda), _bf16(rng, 1, 256, 128).to(cuda)
    want = BR.brgemm_reference(a.double(), b.double()).to(torch.bfloat16)
    mag = BR.brgemm_reference(a.double().abs(), b.double().abs())
    assert bf16_agrees(BR.brgemm(a, b), want, mag, 256)
    assert not bf16_agrees(slice_rounded_product(a[0], b[0]), want, mag, 256)


def test_wgmma_tile_planted_faults_fail_the_criterion(cuda):
    """The Hopper tile's planted faults (``chip_smoke.WGMMA_FAULTS``: A's
    shared-memory writes one chunk off the swizzle; a stage's empty
    barrier released before its wgmma group retired), each built into
    both sources and run in place of the real entry at res4's shapes,
    fail ``bf16_agrees`` (``chip_smoke.wgmma_faults`` raises if one
    passes)."""
    import chip_smoke as S

    libs = S.built(S.wgmma_fault_builds())
    out = S.wgmma_faults(cuda, libs)
    assert len(out) == 2 * len(S.WGMMA_FAULTS)
    assert all(a["share_off"] > 0.01 for a in out.values())


def test_bf16_forms_refuse_mixed_operands_and_f32_epilogues(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import brgemm as BR

    a = torch.zeros(1, 4, 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(EnforceError, match="one dtype"):
        BR._launch(a, torch.zeros(1, 8, 8, device=cuda), 1, 4, 8, 8,
                   (1, 4, 1, 4, 1, 1), None, None, None, False, (4, 8))
    half = torch.zeros(8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(EnforceError, match="float32 scale"):
        BR.brgemm(a, torch.zeros(1, 8, 8, dtype=torch.bfloat16, device=cuda),
                  scale=half, shift=half)


@pytest.mark.parametrize("r,c", [(131072, 64), (1000, 128), (77, 512),
                                 (300, 3), (5, 24), (1, 40), (64, 4104)])
def test_channel_stats_bf16_matches_the_f64_twin(cuda, r, c):
    """The bf16 form (16-byte reads where C % 8 == 0) against the sums of
    the same bf16 values in float64: within 1e-4 x max(1, |ref|) as the
    moments, f32 out, a rerun in the same bits; one launch each."""
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    rng = np.random.default_rng(r + c)
    x = (_rand(rng, r, c) * 2 + 0.5).to(torch.bfloat16).to(cuda)
    before = CS.KERNEL_BF16.launches, CS.KERNEL.launches
    got, again = CS.channel_stats(x), CS.channel_stats(x)
    torch.cuda.synchronize()
    assert (CS.KERNEL_BF16.launches - before[0],
            CS.KERNEL.launches - before[1]) == (2, 0)
    want = CS.channel_stats_reference(x.double())
    for a, b, a2 in zip(got, want, again):
        assert a.dtype == torch.float32 and torch.equal(a, a2)
        assert (a.double() / r - b / r).abs().max().item() <= TOL * max(
            1.0, (b / r).abs().max().item())


def test_channel_stats_bf16_at_an_unaligned_view(cuda):
    """A view two bytes past a 16-byte boundary takes the one-channel
    form (another grouping of the rows): the same moments within 1e-4."""
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    rng = np.random.default_rng(4)
    x = _bf16(rng, 1000, 64).to(cuda)
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 2
    for a, b in zip(CS.channel_stats(x), CS.channel_stats(shifted)):
        assert ((a - b) / 1000).abs().max().item() <= TOL


def test_bf16_conv_bn_act_grads_on_card_match_the_cpu(cuda):
    """``conv2d_bn_act`` in bf16, train mode: the card's kernels against
    the CPU's twins, output and every gradient (dx, dw in bf16; dgamma,
    dbeta), within a few bf16 ulps of the largest entry (another
    accumulation order, then bf16 rounding)."""
    from paddle_tpu_torch.ops.kernels import conv as CV

    rng = np.random.default_rng(5)
    args = [_bf16(rng, 4, 13, 14, 16), _bf16(rng, 3, 3, 16, 24, scale=0.2),
            _bf16(rng, 24, scale=0.1) + 1, _bf16(rng, 24, scale=0.1)]
    rm, rv = torch.zeros(24), torch.ones(24)
    r = _bf16(rng, 4, 7, 7, 24)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in args]
        before = CV.KERNEL_WGMMA.launches
        y, nm, nv = CV.conv2d_bn_act(*leaves, rm.to(dev), rv.to(dev), True,
                                     stride=2, padding=1)
        grads = torch.autograd.grad((y.float() * r.to(dev).float()).sum(),
                                    leaves)
        assert CV.KERNEL_WGMMA.launches == before + (dev.type == "cuda")
        assert y.dtype == torch.bfloat16 and nm.dtype == torch.float32
        assert [g.dtype for g in grads] == [torch.bfloat16] * 4
        outs.append([t.float().cpu() for t in (y, nm, nv, *grads)])
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 3e-2 * max(1.0, b.abs().max())


_C1_SCRIPT = """
import json, sys
import torch
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import dtype
from paddle_tpu_torch.trainer.step import build_train_step
if sys.argv[1] == "control":      # the policy counted as set: never applied
    dtype._applied = True
L, D = paddle.layer, paddle.data_type
img = L.data(name="image", type=D.dense_vector(3 * 8 * 8, channels=3),
             height=8, width=8)
t = L.img_conv_bn(input=img, filter_size=3, num_filters=8, padding=1,
                  name="c")
p = L.fc(input=t, size=4, act=paddle.activation.SoftmaxActivation())
lab = L.data(name="label", type=D.integer_value(4))
cost = L.cross_entropy_cost(input=p, label=lab)
topo = paddle.topology.Topology(cost)
params = paddle.parameters.create(cost)
dev = torch.device("cuda", 0)
ps = {n: torch.as_tensor(params[n]).to(dev) for n in params.names()}
opt = paddle.optimizer.Momentum(momentum=0.9, learning_rate=0.1)
specs = {s.name: s for s in topo.param_specs()}
step = build_train_step(topo, opt, compute_dtype=torch.bfloat16)
states = topo.init_states(dev)
feed = {"image": torch.randn(4, 192, device=dev),
        "label": torch.tensor([0, 1, 2, 3], device=dev)}
opt_state = opt.init({n: v for n, v in ps.items() if not specs[n].is_static},
                     specs)
step(ps, opt_state, states, feed, 0)
torch.cuda.synchronize()
print(json.dumps({
    "cudnn_tf32": torch.backends.cudnn.allow_tf32,
    "bf16_reduced": torch.backends.cuda.matmul
        .allow_bf16_reduced_precision_reduction}))
"""


@pytest.mark.parametrize("mode", ["fix", "control"])
def test_policy_holds_on_a_step_built_by_hand(cuda, mode):
    """C1: in a fresh process, a bf16 conv step through
    ``build_train_step`` on tensors moved to the card by hand (no
    ``resolve_device``) runs under the port's policy: cuDNN TF32 off and
    bf16 GEMMs reduced in f32.  The control marks the policy applied
    without applying it (the tree before the repair): its flags keep
    PyTorch's defaults, so the same assertion would fail."""
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", _C1_SCRIPT, mode],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    flags = json.loads(out.stdout.strip().splitlines()[-1])
    fixed = flags == {"cudnn_tf32": False, "bf16_reduced": False}
    assert fixed is (mode == "fix"), flags


# -- flash backward (the LM training path) ---------------------------------------


@pytest.mark.parametrize("b,t_q,t_k,h,d,causal", [
    (2, 64, 64, 2, 64, True),
    (2, 100, 100, 3, 64, True),
    (1, 333, 333, 2, 64, False),
    (2, 130, 130, 2, 16, True),
    (1, 70, 70, 2, 32, False),
    (1, 129, 129, 2, 128, True),
    (1, 40, 90, 2, 64, True),      # t_q < t_k: absolute-position mask
    (1, 90, 40, 2, 64, True),      # t_q > t_k
])
def test_flash_backward_kernels_match_plain(cuda, b, t_q, t_k, h, d, causal):
    """dq, dk, dv of the Function on the card (the dQ and dK/dV kernels)
    against the plain backward twin on the same padded problem, and
    against autograd through exact attention; a rerun is bit-identical
    (each output is written by one block, no atomics)."""
    rng = np.random.default_rng(t_q * 7 + t_k + d)
    q, k, v = (_rand(rng, b, t, h, d).to(cuda).requires_grad_()
               for t in (t_q, t_k, t_k))
    g = _rand(rng, b, t_q, h, d).to(cuda)
    n_dq, n_dkv = FA.KERNEL_BWD_DQ.launches, FA.KERNEL_BWD_DKV.launches
    o = FA.flash_attention(q, k, v, causal=causal)
    assert o.grad_fn._forward_cls is FA._FlashAttention
    got = torch.autograd.grad(o, (q, k, v), g)
    torch.cuda.synchronize()
    assert FA.KERNEL_BWD_DQ.launches == n_dq + 1
    assert FA.KERNEL_BWD_DKV.launches == n_dkv + 1
    again = torch.autograd.grad(FA.flash_attention(q, k, v, causal=causal),
                                (q, k, v), g)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    with torch.no_grad():
        scale = d ** -0.5
        qp, kp, vp = FA._prep(q, k, v)
        op, lsep = FA._fwd_plain(qp, kp, vp, t_k, causal, scale)
        dop = torch.nn.functional.pad(
            g.permute(0, 2, 1, 3).reshape(b * h, t_q, d),
            (0, 0, 0, qp.shape[1] - t_q)).contiguous()
        plain = FA._bwd_plain(qp, kp, vp, op, lsep, dop, t_k, causal, scale)
    exact = torch.autograd.grad(
        FA.flash_attention_reference(q, k, v, causal=causal), (q, k, v), g)
    for x, p, e, t in zip(got, plain, exact, (t_q, t_k, t_k)):
        p = FA._from_bh(p, b, h, t, d)
        assert x.shape == e.shape and torch.isfinite(x).all()
        for want in (p, e):
            assert ((x - want).abs().max().item()
                    <= TOL * max(1.0, want.abs().max().item()))


def test_lm_train_step_on_card_matches_the_cpu(cuda):
    """One ``loss_and_grads`` of a small flash LM on the card (kernels)
    and on the CPU (plain twins), from the same weights and ids: loss and
    every gradient leaf within 1e-4 of the leaf's scale; exactly one
    forward, one dQ and one dK/dV launch per layer (two forwards with
    remat, which re-runs each block); a rerun bit-identical."""
    from paddle_tpu_torch.core import tree
    from paddle_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab_size=128, num_layers=2, num_heads=2,
                              embed_dim=128, mlp_dim=256, max_seq_len=128,
                              attn_impl="flash", remat=False)
    params = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, size=(2, 97)))
    loss_c, grads_c = T.loss_and_grads(cfg, params, ids)
    on_card = tree.unflatten(params, [p.to(cuda) for p in tree.leaves(params)])
    counts = (FA.KERNEL.launches, FA.KERNEL_BWD_DQ.launches,
              FA.KERNEL_BWD_DKV.launches)
    loss_g, grads_g = T.loss_and_grads(cfg, on_card, ids.to(cuda))
    torch.cuda.synchronize()
    assert (FA.KERNEL.launches - counts[0], FA.KERNEL_BWD_DQ.launches
            - counts[1], FA.KERNEL_BWD_DKV.launches - counts[2]) == (2, 2, 2)
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    for a, b in zip(tree.leaves(grads_g), tree.leaves(grads_c)):
        scale = max(1e-3, b.abs().max().item())
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * scale
    again = T.loss_and_grads(cfg, on_card, ids.to(cuda))
    assert torch.equal(again[0], loss_g)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(again[1]),
                                                 tree.leaves(grads_g)))
    before = FA.KERNEL.launches
    T.loss_and_grads(dataclasses.replace(cfg, remat=True), on_card,
                     ids.to(cuda))
    assert FA.KERNEL.launches - before == 4


def test_flash_backward_refuses_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError

    lse = torch.zeros(2, 64, 1, device=cuda)
    for dtype in (torch.float64, torch.float16):
        x = torch.zeros(2, 64, 64, dtype=dtype, device=cuda)
        with pytest.raises(EnforceError, match="float32"):
            FA._bwd_kernel(x, x, x, x, lse, x, 64, True, 0.125)
    # the padded kernels are bf16's (f32 reads [B, T, H, D] in place)
    with pytest.raises(EnforceError, match="bfloat16"):
        FA._bwd_kernel(*(torch.zeros(2, 64, 64, device=cuda),) * 4, lse,
                       lse, 64, True, 0.125)
    x = torch.zeros(2, 60, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(EnforceError, match="64-row"):
        FA._bwd_kernel(x, x, x, x, lse, x, 60, True, 0.125)


# -- flash attention in bf16 (rows 2 and 3's bf16 forms) -------------------------
#
# Each bf16 form against its plain twin on the same inputs
# (``chip_smoke.flash_bf16_case``): o, dq, dk, dv by ``bf16_agrees`` with
# ``FLASH_BF16_FLIP`` -- equal on all but 1% of the elements, each within
# one bf16 ulp at the larger magnitude plus 2^-7 of its sum of |terms|:
# the kernel sums S in another f32 order than the twin, so a P or dS may
# round to the neighbouring bf16 value, which moves its term by at most
# 2^-7 of it.  lse within 1e-4 x max(1, |lse|).  The planted faults (an
# accumulator kept in bf16, delta dropped, the diagonal tile's mask off)
# must fail the same criterion on every output they move.


@pytest.mark.parametrize("b,t_q,t_k,h,d,causal", [
    (16, 1024, 1024, 12, 64, True),   # the LM training shape
    (2, 100, 100, 3, 64, True),
    (1, 333, 333, 2, 64, False),
    (2, 130, 130, 2, 128, True),
    (1, 129, 129, 2, 128, False),
    (2, 64, 64, 2, 16, True),
    (1, 70, 70, 2, 32, False),
    (1, 40, 90, 2, 64, True),         # t_q < t_k: absolute-position mask
    (1, 90, 40, 2, 128, True),        # t_q > t_k
])
def test_flash_bf16_forms_match_their_twins(cuda, b, t_q, t_k, h, d,
                                            causal):
    """The bf16 forward, dQ and dK/dV kernels against their twins, each
    launched exactly once a run and no f32 form; a rerun bit-identical;
    every planted fault past the criterion.  At head_dim 64 and 128 the
    Hopper backward on q, k, v, dO as they lie (after the Hopper forward)
    against the same twins, its rerun in the same bits."""
    import chip_smoke as S

    rng = np.random.default_rng(t_q * 3 + t_k + d)
    q, k, v, g = (_bf16(rng, b, t, h, d).to(cuda)
                  for t in (t_q, t_k, t_k, t_q))
    qp, kp, vp = FA._prep(q, k, v)
    dop = FA._prep(g, g, g)[0]
    counts = S.flash_counters()
    before = {n: c.launches for n, c in counts.items()}
    case = S.flash_bf16_case(qp, kp, vp, dop, t_q, t_k, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert {n: c.launches - before[n] for n, c in counts.items()} == {
        "fwd": 0, "dq": 0, "dkv": 0, "fwd_bf16": 2, "fwd_wgmma": 0,
        "dq_bf16": 2, "dkv_bf16": 2, "dq_wgmma": 0,
        "dkv_wgmma": 0}    # the run and its rerun
    assert case["rerun_bit_identical"]
    assert case["lse_err"] <= TOL
    for n, got in case["got"].items():
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        assert S.bf16_agrees(got, case["want"][n], case["mags"][n],
                             coef=S.FLASH_BF16_FLIP), (n, S.bf16_agreement(
                                 got, case["want"][n], case["mags"][n],
                                 coef=S.FLASH_BF16_FLIP))
    assert sorted(case["faults"]) == sorted(
        f for f in S.FLASH_BF16_FAULTS
        if causal or f != "diagonal_mask_off")
    for fault, outs in case["faults"].items():
        for n, bad in outs.items():
            assert not S.bf16_agrees(bad, case["want"][n], case["mags"][n],
                                     coef=S.FLASH_BF16_FLIP), (fault, n)
    if d not in FA.WGMMA_HEAD_DIMS:
        return
    del case
    before = {n: c.launches for n, c in counts.items()}
    hop = S.flash_wgmma_bwd_case(q, k, v, g, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert {n: c.launches - before[n] for n, c in counts.items()
            if c.launches != before[n]} == {
        "fwd_wgmma": 1, "dq_wgmma": 2, "dkv_wgmma": 2}
    assert hop["rerun_bit_identical"]
    for n, got in hop["got"].items():
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.isfinite(got).all()
        assert S.bf16_agrees(got, hop["want"][n], hop["mags"][n],
                             coef=S.FLASH_BF16_FLIP), (n, S.bf16_agreement(
                                 got, hop["want"][n], hop["mags"][n],
                                 coef=S.FLASH_BF16_FLIP))


def test_flash_bf16_function_on_card_matches_the_cpu(cuda):
    """``flash_attention`` on bf16 CUDA tensors (the Function: the bf16
    forward, dQ and dK/dV kernels) against the same Function on the CPU
    (the twins) by the same criterion, and both within 2^-8 relative norm
    of float64 exact attention."""
    import chip_smoke as S

    rng = np.random.default_rng(12)
    b, t, h, d = 2, 200, 3, 64
    q, k, v, g = (_bf16(rng, b, t, h, d) for _ in range(4))

    def grads(device):
        leaves = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        o = FA.flash_attention(*leaves, causal=True)
        return [x.cpu() for x in (o.detach(), *torch.autograd.grad(
            o, leaves, g.to(device)))]

    got, want = grads(cuda), grads("cpu")
    qp, kp, vp = FA._prep(q, k, v)
    dop = FA._prep(g, g, g)[0]
    o, lse = FA._fwd_plain(qp, kp, vp, t, True, d ** -0.5)
    mags = [FA._from_bh(m, b, h, t, d) for m in S.flash_bf16_mags(
        qp, kp, vp, o, lse, dop, t, True, d ** -0.5)]
    wide = [x.double().requires_grad_() for x in (q, k, v)]
    o64 = FA.flash_attention_reference(*wide, causal=True)
    exact = (o64.detach(), *torch.autograd.grad(o64, wide, g.double()))
    for x, w, m, e in zip(got, want, mags, exact):
        assert S.bf16_agrees(x, w, m, coef=S.FLASH_BF16_FLIP)
        assert torch.linalg.norm(x.double() - e) <= 2.0 ** -8 * \
            torch.linalg.norm(e)


def test_flash_bf16_refuses_mixed_and_unaligned_inputs(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError

    x = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(EnforceError, match="one dtype"):
        FA._fwd_kernel(x, x.float(), x, 64, True, 0.125)
    lse = torch.zeros(2, 64, 1, device=cuda)
    with pytest.raises(EnforceError, match="one dtype"):
        FA._bwd_dq_kernel(x, x, x, lse, x.float(), lse, 64, True, 0.125)
    odd = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view(2, 64, 64)
    with pytest.raises(EnforceError, match="16-byte"):
        FA._fwd_kernel(odd, x, x, 64, True, 0.125)
    with pytest.raises(EnforceError, match="head_dim"):
        FA._fwd_kernel(*(torch.zeros(2, 64, 48, dtype=torch.bfloat16,
                                     device=cuda),) * 3, 64, True, 0.125)


def test_lm_bf16_step_on_card_matches_the_cpu(cuda):
    """One bf16 ``loss_and_grads`` of a small flash LM (2 layers of 2 heads
    of 64) on the card and on the CPU from the same f32 weights: exactly
    one launch of the Hopper forward and of each bf16 backward form a
    layer, and no f32 or mma.sync forward; f32
    gradients; each leaf's distance to the float64 gradient within 2x the
    CPU's plus 2^-8; a rerun bit-identical."""
    from chip_smoke import named_leaves, rel_norm
    from paddle_tpu_torch.core import tree
    from paddle_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab_size=128, num_layers=2, num_heads=2,
                              embed_dim=128, mlp_dim=256, max_seq_len=128,
                              attn_impl="flash", remat=False)
    params = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, size=(2, 129)))
    bf = torch.bfloat16
    _, g64 = T.loss_and_grads(cfg, tree.unflatten(params, [
        p.double() for p in tree.leaves(params)]), ids)
    _, g_cpu = T.loss_and_grads(cfg, params, ids, bf)
    on_card = tree.unflatten(params, [p.to(cuda) for p in tree.leaves(params)])
    forms = [k for form in FA.FORMS.values() for k in form]
    forms += [FA.KERNEL_WGMMA, FA.KERNEL_BWD_DQ_WGMMA, FA.KERNEL_BWD_DKV_WGMMA]
    before = [k.launches for k in forms]
    loss, g_card = T.loss_and_grads(cfg, on_card, ids.to(cuda), bf)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(forms, before)] == [
        0, 0, 0, 0, 0, 0, 2, 2, 2]
    assert all(g.dtype == torch.float32 for g in tree.leaves(g_card))
    g64, g_cpu, g_card = map(named_leaves, (g64, g_cpu, g_card))
    for n in g64:
        assert rel_norm(g_card[n], g64[n]) <= 2 * rel_norm(
            g_cpu[n], g64[n]) + 2.0 ** -8, n
    again = T.loss_and_grads(cfg, on_card, ids.to(cuda), bf)
    assert torch.equal(again[0], loss)
    assert all(torch.equal(a, g_card[n].to(cuda))
               for n, a in named_leaves(again[1]).items())


# -- LSTM sequence and embedding gather / scatter-add (the text path) ------------


def _lstm_inputs(rng, b, t, d, device):
    lens = rng.integers(1, t + 1, size=b)
    lens[0] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    x = [_rand(rng, b, t, 4 * d), torch.from_numpy(mask),
         _rand(rng, d, 4 * d) * (1.0 / d ** 0.5), _rand(rng, 3, d) * 0.3,
         _rand(rng, b, d) * 0.5, _rand(rng, b, d) * 0.5]
    return [v.to(device) for v in x]


@pytest.mark.parametrize("b,t,d", [
    (3, 7, 8),          # one unit a block
    (5, 9, 300),        # 3 units a block, the last block short
    (300, 9, 32),       # five 64-row chunks (past the JAX 256-row block)
    (64, 16, 1280),     # the text classifier's width: 10 units a block
    (64, 24, 64),       # the OCR CRNN's BiLSTM backward, one per direction
])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernels_match_plain(cuda, b, t, d, reverse):
    """The forward kernel and both backward forms against the plain twins
    on the same CUDA tensors; remat and stored gates give the same bits,
    and a rerun repeats them (no atomics)."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    rng = np.random.default_rng(b * 31 + t + d)
    xw, mask, w_h, peep, h0, c0 = _lstm_inputs(rng, b, t, d, cuda)
    n_fwd = LK.KERNEL_FWD.launches
    got = LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, reverse, True)
    torch.cuda.synchronize()
    assert LK.KERNEL_FWD.launches == n_fwd + 1
    want = LK._fwd_plain(xw, mask, w_h, peep, h0, c0, reverse, True)
    for x, y in zip(got, want):
        assert ((x - y).abs().max().item()
                <= TOL * max(1.0, y.abs().max().item()))
    hs, cs, gates = got[:3]
    dhs, dh_t, dc_t = (_rand(rng, *s).to(cuda) for s in
                       ((b, t, d), (b, d), (b, d)))
    args = (mask, w_h, peep, h0, c0, hs, cs, dhs, dh_t, dc_t, reverse)
    n_bwd = LK.KERNEL_BWD.launches, LK.KERNEL_BWD_STORED.launches
    stored = LK._bwd_kernel(None, gates, *args, False)
    remat = LK._bwd_kernel(xw, None, *args, True)
    again = LK._bwd_kernel(xw, None, *args, True)
    torch.cuda.synchronize()
    assert (LK.KERNEL_BWD.launches - n_bwd[0],
            LK.KERNEL_BWD_STORED.launches - n_bwd[1]) == (2, 1)
    assert all(torch.equal(x, y) for x, y in zip(stored, remat))
    assert all(torch.equal(x, y) for x, y in zip(remat, again))
    want = LK._bwd_plain(xw, gates, *args, True)
    for x, y in zip(remat, want):
        assert ((x - y).abs().max().item()
                <= TOL * max(1.0, y.abs().max().item()))


def _lstm_forward_and_remat(cuda, xw, mask, w_h, peep, h0, c0, rng):
    """The f32 forward kernel (3xTF32 product) against its twin, a rerun
    and the gates slab in the same bits; then the backward over its hs, cs
    with remat (the forward's product in a block of 32U threads) and over
    the stored slab: the same bits."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    got = LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, False, True)
    bare = LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, False, False)
    again = LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, False, True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.equal(x, y) for i, (x, y) in enumerate(zip(got, bare))
               if i != 2)
    for x, y in zip(got, LK._fwd_plain(xw, mask, w_h, peep, h0, c0, False,
                                       True)):
        assert _close(x, y)
    hs, cs, gates = got[:3]
    b, t, d = hs.shape
    dhs, dh_t, dc_t = (_rand(rng, *s).to(cuda) for s in
                       ((b, t, d), (b, d), (b, d)))
    args = (mask, w_h, peep, h0, c0, hs, cs, dhs, dh_t, dc_t, False)
    remat = LK._bwd_kernel(xw, None, *args, True)
    stored = LK._bwd_kernel(None, gates, *args, False)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(remat, stored))


@pytest.mark.parametrize("b,t,d", [
    (64, 16, 1280),     # the text width: U 10
    (64, 24, 64),       # the OCR CRNN's D 64: U 1, half an n8 tile
    (37, 9, 396),       # U 3 on 132 SMs: odd, the last n8 tile half zero
    (5, 7, 924),        # U 7: the backward's 7 warps take 2 jobs each
])
def test_lstm_f32_forward_on_tensor_cores_matches_plain(cuda, b, t, d):
    rng = np.random.default_rng(b + t + d)
    _lstm_forward_and_remat(cuda, *_lstm_inputs(rng, b, t, d, cuda), rng)


def test_lstm_f32_forward_on_tensor_cores_at_row6(cuda):
    """Row 6's ragged shape (B 64, T 100, E 128, D 512: U 4, the forward's
    8 warps against the backward's 4): the fused-input forward against its
    twin, in the same bits on a rerun and with its slab; then row 5's
    forward over its projection and the backward in both forms."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    _fi_kernel_vs_plain(cuda, "lstm", 64, 100, 128, 512, False)
    rng = np.random.default_rng(6)
    x, mask, (w_x, b, w_h, peep, h0, c0) = _fi_inputs("lstm", rng, 64, 100,
                                                      128, 512, cuda)
    xw = LK._project_xw(x, w_x, b)
    _lstm_forward_and_remat(cuda, xw, mask, w_h, peep, h0, c0, rng)


def test_lstm_function_on_card_matches_the_cpu(cuda):
    """The autograd Function (kernels) against the CPU's plain twins:
    hs, h_T, c_T and every input gradient."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    rng = np.random.default_rng(7)
    cpu = _lstm_inputs(rng, 6, 11, 40, "cpu")
    r = _rand(rng, 6, 11, 40)
    outs = []
    for dev in ("cpu", cuda):
        leaves = [x.to(dev).detach().requires_grad_(i != 1)
                  for i, x in enumerate(cpu)]
        hs, (h_t, c_t) = LK.lstm_seq(*leaves, reverse=False, remat=True)
        loss = (hs * r.to(dev)).sum() + h_t.sum() + 0.5 * c_t.sum()
        grads = torch.autograd.grad(loss, [x for i, x in enumerate(leaves)
                                           if i != 1])
        outs.append([hs, h_t, c_t, *grads])
    for want, got in zip(*outs):
        assert ((got.cpu() - want).abs().max().item()
                <= TOL * max(1.0, want.abs().max().item()))


def _route_counts(mod, dtype):
    """(remat, stored) backward launches of ``mod`` (kernels/lstm or
    kernels/gru) in ``dtype``'s form."""
    if dtype == torch.bfloat16:
        return (mod.KERNEL_BWD_BF16.launches,
                mod.KERNEL_BWD_STORED_BF16.launches)
    return mod.KERNEL_BWD.launches, mod.KERNEL_BWD_STORED.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,b,t,d,length", [
    ("lstm", 64, 128, 1280, 100),    # the text classifier's lstmemory
    ("gru", 64, 32, 512, None)])     # the NMT width's grumemory, ragged
def test_default_route_takes_the_stored_form_where_the_slab_fits(
        cuda, dtype, kind, b, t, d, length):
    """``ops.rnn.lstm_fused`` / ``gru_fused`` with ``remat=None`` on the
    card at the text shape (B 64, T 128, D 1280) and at [64, 32, 512]:
    the slab fits (``stored_slab_fits``), so the backward launches its
    stored-gates form once and the remat form not at all; ``remat=True``
    launches the remat form once; hs, the last state and every input
    gradient are the same bits either way, and on a rerun."""
    from paddle_tpu_torch.core.lod import SequenceBatch
    from paddle_tpu_torch.ops import rnn as R
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    gen = torch.Generator(device=cuda).manual_seed(d + t)
    g = len(kind)      # 4 gates (LSTM), 3 (GRU)
    if length is None:
        lens = torch.randint(1, t + 1, (b,), generator=gen, device=cuda)
        lens[: b // 2], lens[-1] = t, 1
    else:
        lens = torch.full((b,), length, device=cuda)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=cuda)

    xw = rnd(b, t, g * d, scale=0.5).to(dtype)
    w_h = rnd(d, g * d, scale=d ** -0.5).to(dtype)
    peep, h0 = rnd(3 * d, scale=0.1).to(dtype), rnd(b, d, scale=0.5)
    cot = rnd(b, t, d).to(dtype)
    assert R.stored_slab_fits(R.gates_slab_bytes(b, t, g, d, dtype),
                              R.card_memory_open(cuda))
    assert not R.backward_remat(xw, g)

    def run(remat):
        leaves = [v.clone().requires_grad_() for v in (xw, w_h, peep, h0)]
        seq = SequenceBatch(leaves[0], lens)
        if kind == "lstm":
            out, last = R.lstm_fused(
                seq, leaves[1], R.LSTMState(h=leaves[3].to(dtype),
                                            c=leaves[3]),
                peephole=leaves[2], remat=remat)
            last = list(last)
        else:
            out, h_t = R.gru_fused(seq, leaves[1][:, :2 * d],
                                   leaves[1][:, 2 * d:], leaves[3].to(dtype),
                                   remat=remat)
            last, leaves = [h_t], leaves[:2] + leaves[3:]
        loss = ((out.data * cot).float().sum()
                + sum(v.float().sum() for v in last))
        return [out.data, *last, *torch.autograd.grad(loss, leaves)]

    mod = LK if kind == "lstm" else GK
    n = _route_counts(mod, dtype)
    stored = run(None)
    torch.cuda.synchronize()
    moved = tuple(a - c for a, c in zip(_route_counts(mod, dtype), n))
    assert moved == (0, 1)
    n = _route_counts(mod, dtype)
    remat = run(True)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_route_counts(mod, dtype), n)) == (1, 0)
    again = run(None)
    for x, y, z in zip(stored, remat, again):
        assert torch.isfinite(x).all()
        assert torch.equal(x, y) and torch.equal(x, z)


def test_lstm_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import lstm as LK

    x = [v.double() for v in _lstm_inputs(np.random.default_rng(0), 2, 3, 8,
                                          cuda)]
    with pytest.raises(EnforceError, match="float32"):
        LK.lstm_seq(*x)
    x = _lstm_inputs(np.random.default_rng(0), 2, 3, 4096, cuda)
    with pytest.raises(EnforceError, match="units a block"):
        LK.lstm_seq(*x)
    x = _lstm_inputs(np.random.default_rng(0), 2, 3, 10, cuda)
    with pytest.raises(EnforceError, match="multiple of 4"):
        LK.lstm_seq(*x)


def _ids(rng, n, v):
    """Ids with duplicates, out-of-range and negative entries."""
    ids = rng.integers(0, v, size=n)
    ids[:4] = [v + 3, -1, -7, v - 1]
    ids[4:12] = ids[12:20]
    return torch.from_numpy(ids.astype(np.int64))


@pytest.mark.parametrize("n,v,d", [(37, 50, 8), (8192, 30000, 128),
                                   (300, 97, 33)])
def test_embedding_kernels_match_plain(cuda, n, v, d):
    from paddle_tpu_torch.ops.kernels import embedding as EK

    rng = np.random.default_rng(n + v + d)
    table, rows = _rand(rng, v, d).to(cuda), _rand(rng, n, d).to(cuda)
    ids = _ids(rng, n, v).to(cuda)
    counts = EK.KERNEL_GATHER.launches, EK.KERNEL_SCATTER.launches
    got = EK.embedding_gather(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, EK.embedding_gather_reference(table, ids))
    summed = EK.embedding_scatter_add(table, ids, rows)
    again = EK.embedding_scatter_add(table, ids, rows)
    torch.cuda.synchronize()
    assert (EK.KERNEL_GATHER.launches - counts[0],
            EK.KERNEL_SCATTER.launches - counts[1]) == (1, 2)
    assert torch.equal(summed, again)
    want = EK.embedding_scatter_add_reference(table, ids, rows)
    assert (summed - want).abs().max().item() <= 1e-5


def test_fused_lookup_on_card_matches_the_cpu(cuda):
    from paddle_tpu_torch.ops.kernels import embedding as EK

    rng = np.random.default_rng(3)
    table = _rand(rng, 50, 16)
    ids = _ids(rng, 48, 50).reshape(6, 8)
    r = _rand(rng, 6, 8, 16)
    outs = []
    for dev in ("cpu", cuda):
        t = table.to(dev).detach().requires_grad_()
        out = EK.fused_embedding_lookup(t, ids.to(dev), padding_idx=5)
        (g,) = torch.autograd.grad((out * r.to(dev)).sum(), (t,))
        outs.append((out, g))
    assert torch.equal(outs[1][0].cpu(), outs[0][0])
    assert (outs[1][1].cpu() - outs[0][1]).abs().max().item() <= 1e-6


# -- BiLSTM, CTC forward-backward and decode, the CRNN's convs (OCR path) ------


def _bilstm_inputs(rng, b, t, e, d, device):
    """x, mask (ragged lengths, row 0 full) and both directions' weights."""
    lens = rng.integers(1, t + 1, size=b)
    lens[0] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    per_dir = lambda: [_rand(rng, e, 4 * d) * (1.0 / e ** 0.5),  # noqa: E731
                       _rand(rng, 4 * d) * 0.1,
                       _rand(rng, d, 4 * d) * (1.0 / d ** 0.5),
                       _rand(rng, 3, d) * 0.3]
    x = ([_rand(rng, b, t, e), torch.from_numpy(mask)] + per_dir()
         + per_dir() + [_rand(rng, b, d) * 0.5 for _ in range(4)])
    return [v.to(device) for v in x]


def _close(got, want):
    return ((got - want).abs().max().item()
            <= TOL * max(1.0, want.abs().max().item()))


def _close_each(got, want, rtol=1e-5, atol=1e-12):
    """Entry by entry: |got - want| <= rtol |want| + atol max |want|.  A
    softmax gradient's typical entry is far below its largest, so a limit
    on the largest alone would pass a wrong row."""
    lim = rtol * want.abs() + atol * want.abs().max()
    return bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("b,t,e,d,plan", [
    (64, 24, 256, 64, None),            # the OCR CRNN at bench width
    (64, 24, 256, 64, (4, 4, True)),    # ... and forced: every cluster
    (64, 24, 256, 64, (8, 8, True)),    # size, both row tiles, W_x
    (64, 24, 256, 64, (2, 4, True)),    # through L2
    (64, 24, 256, 64, (4, 4, False)),
    (256, 6, 32, 16, (1, 4, True)),
    (64, 24, 256, 32, None),            # rnn_size 32 (the convergence recipe)
    (3, 7, 16, 8, None),                # the CPU tests' shapes: B not a
    (5, 9, 16, 32, None),               # multiple of 4
    (2, 24, 256, 64, None),             # the CRNN's batch-2 witness step
    (3, 5, 16, 4, None),                # one unit a CTA
    (64, 24, 256, 128, None),           # wider than the single-block
    (64, 6, 256, 200, None),            # kernel took (D <= 116 at E 256)
    (4, 5, 4096, 64, None),             # W_x's slice too large: via L2
    (3, 4, 18, 8, None),                # E not a multiple of 4
])
def test_bilstm_kernel_matches_plain(cuda, monkeypatch, b, t, e, d, plan):
    """The bilstm forward kernel against its plain twin on the same CUDA
    tensors, ragged lengths, in the plan the card picks or in a forced
    one (every cluster size 1, 2, 4, 8, both row tiles, W_x's slice
    resident and not); a rerun repeats the bits."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    candidates = list(LK._bi_candidates(b, e, d, LK._card(cuda)[1]))
    if plan is None:
        got_plan = LK._bi_launch(torch.device(cuda), b, t, e, d)[0]
        assert got_plan in candidates
        assert got_plan.resident == (e < 4096)
    else:
        got_plan = next(p for p in candidates if p[:3] == plan)
        monkeypatch.setattr(LK, "_bi_launch", lambda *a: (got_plan, (
            b, t, e, d, plan[0], plan[1], int(plan[2]))))
    rng = np.random.default_rng(b + t + e + d)
    x, mask, *w = _bilstm_inputs(rng, b, t, e, d, cuda)
    fw, bw = w[0:4] + w[8:10], w[4:8] + w[10:12]
    n = LK.KERNEL_BI.launches
    got = LK._bi_fwd_kernel(x, mask, fw, bw)
    again = LK._bi_fwd_kernel(x, mask, fw, bw)
    torch.cuda.synchronize()
    assert LK.KERNEL_BI.launches == n + 2
    want = LK._bi_fwd_plain(x, mask, fw, bw)
    for g_dir, a_dir, w_dir in zip(got, again, want):
        for gv, av, wv in zip(g_dir, a_dir, w_dir):
            assert _close(gv, wv)
            assert torch.equal(gv, av)


@pytest.mark.parametrize("b,t,e,d", [(64, 24, 256, 64), (64, 24, 256, 32),
                                     (5, 9, 16, 8), (3, 7, 16, 32),
                                     (128, 8, 64, 64), (256, 6, 32, 16),
                                     (64, 12, 256, 128)])
def test_bilstm_function_on_card_matches_the_cpu(cuda, b, t, e, d):
    """``bilstm_seq`` (the forward kernel, then two LSTM backward launches)
    against the CPU's plain twins: every output and input gradient; the
    card's gradients repeat bit for bit."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    rng = np.random.default_rng(11 + d)
    cpu = _bilstm_inputs(rng, b, t, e, d, "cpu")
    r = [_rand(rng, b, t, d), _rand(rng, b, t, d)]
    outs = []
    for dev in ("cpu", cuda, cuda):
        leaves = [v.to(dev).detach().requires_grad_(i != 1)
                  for i, v in enumerate(cpu)]
        n = LK.KERNEL_BI.launches, LK.KERNEL_BWD.launches
        hsf, hsb, (htf, ctf), (htb, ctb) = LK.bilstm_seq(*leaves)
        loss = ((hsf * r[0].to(dev)).sum() + (hsb * r[1].to(dev)).sum()
                + htf.sum() + 0.5 * ctf.sum() - htb.sum() + 0.25 * ctb.sum())
        grads = torch.autograd.grad(loss, [v for i, v in enumerate(leaves)
                                           if i != 1])
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (LK.KERNEL_BI.launches - n[0],
                    LK.KERNEL_BWD.launches - n[1]) == (1, 2)
        outs.append([hsf, hsb, htf, ctf, htb, ctb, *grads])
    for want, got, again in zip(*outs):
        assert _close(got.cpu(), want)
        assert torch.equal(got, again)


def _ctc_inputs(rng, b, t, v, l):
    """Logits, labels padded to l (blank = v - 1), ragged input lengths and
    label lengths; with b >= 3, row 1 has a zero-length label and row 2 is
    infeasible (3 distinct labels in 2 frames)."""
    logits = _rand(rng, b, t, v)
    labels = rng.integers(0, v - 1, size=(b, l))
    llen = rng.integers(1, min(l, 5) + 1, size=b)
    ilen = rng.integers(max(2 * min(l, 5) + 1, t // 2), t + 1, size=b)
    ilen[0] = t
    if b >= 3:
        llen[1] = 0
        labels[2, :3] = [0, 1, 2]
        llen[2], ilen[2] = 3, 2
    as_t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return logits, as_t(labels), as_t(ilen), as_t(llen)


@pytest.mark.parametrize("b,t,v,l", [
    (64, 24, 27, 16),   # the CRNN: labels of 5 bucketed to 16, S = 33
    (1, 24, 27, 16), (3, 12, 7, 4), (6, 30, 11, 8), (16, 24, 27, 16),
    (4, 200, 30, 40),   # past the shared-memory budget: the scratch path
    (2, 127, 27, 23),   # a 48,824-byte workspace: just under the budget
    (2, 181, 27, 16),   # 48,904 bytes: over it, under 48 KB (the scratch)
])
@pytest.mark.parametrize("normalize", [False, True])
def test_ctc_kernel_matches_plain(cuda, b, t, v, l, normalize):
    """The forward-backward kernel against its plain twin on the same CUDA
    tensors: the losses (the infeasible row at the sentinel) and the
    [B, T, V] gradient (exactly zero on the infeasible row and past each
    row's input length); a rerun repeats the bits."""
    from paddle_tpu_torch.ops import ctc as ctc_ops
    from paddle_tpu_torch.ops.kernels import ctc as KC

    rng = np.random.default_rng(b * 7 + t + v + l)
    logits, labels, ilen, llen = _ctc_inputs(rng, b, t, v, l)
    x = logits if normalize else torch.log_softmax(logits, -1)
    x = x.to(cuda)
    ext, valid, skip = ctc_ops.ctc_tables(labels.to(cuda), llen.to(cuda),
                                          v - 1)
    args = (ext, skip, valid, ilen.to(cuda, torch.int32),
            llen.to(cuda, torch.int32), normalize)
    n = KC.KERNEL_LOSS.launches
    loss, grad = KC._fwd_bwd_kernel(x, *args)
    loss2, grad2 = KC._fwd_bwd_kernel(x, *args)
    torch.cuda.synchronize()
    assert KC.KERNEL_LOSS.launches == n + 2
    assert torch.equal(loss, loss2) and torch.equal(grad, grad2)
    want_loss, want_grad = KC._fwd_bwd_plain(x, *args)
    finite = want_loss < 1e29
    assert torch.allclose(loss[finite], want_loss[finite], rtol=1e-5,
                          atol=0)
    assert torch.equal(loss[~finite], want_loss[~finite])
    assert _close(grad, want_grad)
    frames = torch.arange(t, device=cuda)[None, :] >= ilen.to(cuda)[:, None]
    assert torch.count_nonzero(grad[frames]) == 0
    if b >= 3:
        assert loss[2].item() == np.float32(1e30)
        assert torch.count_nonzero(grad[2]) == 0


def test_ctc_function_on_card_matches_the_cpu(cuda):
    """``ctc_loss_fused`` through autograd on the card against the CPU
    twin: the losses and the gradient by the log-probs."""
    from paddle_tpu_torch.ops.kernels import ctc as KC

    rng = np.random.default_rng(5)
    logits, labels, ilen, llen = _ctc_inputs(rng, 6, 20, 9, 8)
    outs = []
    for dev in ("cpu", cuda):
        x = torch.log_softmax(logits, -1).to(dev).requires_grad_()
        loss = KC.ctc_loss_fused(x, ilen, labels, llen, blank=8)
        (g,) = torch.autograd.grad(loss[loss < 1e29].sum(), (x,))
        outs.append((loss, g))
    assert torch.allclose(outs[1][0].cpu(), outs[0][0], rtol=1e-5, atol=0)
    assert _close(outs[1][1].cpu(), outs[0][1])


@pytest.mark.parametrize("b,t,v", [(64, 24, 27), (3, 300, 7), (5, 9, 2),
                                   (8, 300, 100), (4, 50, 37)])
@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("len_dtype", [torch.int32, torch.int64])
def test_ctc_decode_kernel_matches_plain(cuda, b, t, v, blank, len_dtype):
    """The decode kernel's (ids, lengths) equal the twin's
    ``compact_decoded(*_decode_plain(...))`` in bits, in one launch a
    call, with ties (first index wins), repeats, ragged and zero lengths
    read as int32 or int64; T = 300 crosses the kernel's 256-frame
    chunks, V 37 and 100 its 32-lane runs."""
    from paddle_tpu_torch.ops import ctc as ctc_ops
    from paddle_tpu_torch.ops.kernels import ctc as KC

    rng = np.random.default_rng(b + t + v)
    x = torch.from_numpy(rng.integers(0, 3, size=(b, t, v)).astype(
        np.float32)).to(cuda)    # small integers: many ties and repeats
    lens = rng.integers(0, t + 1, size=b)
    lens[0] = 0
    ilen = torch.from_numpy(lens).to(cuda, len_dtype)
    blank = 0 if blank == "first" else v - 1
    n = KC.KERNEL_DECODE.launches
    ids, out_len = KC._decode_kernel(x, ilen, blank)
    fused = KC.ctc_greedy_decode_fused(x, ilen, blank)
    torch.cuda.synchronize()
    assert KC.KERNEL_DECODE.launches == n + 2
    best, keep = KC._decode_plain(x, ilen, blank)
    want = ctc_ops.compact_decoded(best, keep.bool())
    for got in ((ids, out_len), fused):
        assert got[0].dtype == got[1].dtype == torch.int32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ref = KC.ctc_greedy_decode_fused_reference(x, ilen, blank)
    assert torch.equal(ids, ref[0]) and torch.equal(out_len, ref[1])


@pytest.mark.parametrize("shape,cout", [((64, 32, 96, 1), 16),
                                        ((64, 16, 48, 16), 32)])
def test_conv_kernel_at_the_crnn_shapes(cuda, shape, cout):
    """The direct conv kernel with the BN statistics epilogue at the CRNN's
    two 3x3 s1 p1 convs (conv1: Cin = 1) against its plain twin; a rerun
    repeats the bits."""
    from paddle_tpu_torch.ops.kernels import conv as CV

    rng = np.random.default_rng(cout)
    x = _rand(rng, *shape).to(cuda)
    w = (_rand(rng, 3, 3, shape[-1], cout) * 0.3).to(cuda)
    n = CV.KERNEL.launches
    got = CV.fwd_raw(x, w, (1, 1), (1, 1), stats=True)
    again = CV.fwd_raw(x, w, (1, 1), (1, 1), stats=True)
    torch.cuda.synchronize()
    assert CV.KERNEL.launches == n + 2
    want = CV.fwd_raw_reference(x, w, (1, 1), (1, 1), stats=True)
    count = got[0].numel() // cout
    assert _close(got[0], want[0])
    for g, wv, a in zip(got[1:], want[1:], again[1:]):
        assert _close(g / count, wv / count)     # the moments they feed
        assert torch.equal(g, a)
    assert torch.equal(got[0], again[0])


def test_crnn_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import ctc as KC
    from paddle_tpu_torch.ops.kernels import lstm as LK

    x = _bilstm_inputs(np.random.default_rng(0), 2, 3, 16, 512, cuda)
    with pytest.raises(EnforceError, match="shared memory"):
        LK.bilstm_seq(*x)
    with pytest.raises(EnforceError, match="float32"):
        LK.bilstm_seq(*(v.double() for v in x))
    logits, labels, ilen, llen = _ctc_inputs(np.random.default_rng(0), 3, 12,
                                             5, 4)
    with pytest.raises(EnforceError, match="float32"):
        KC.ctc_loss_fused(logits.double().to(cuda), ilen, labels, llen, 4)
    with pytest.raises(EnforceError, match="float32"):
        KC.ctc_greedy_decode_fused(logits.double().to(cuda), ilen, 4)


# -- GRU sequence and bidirectional GRU (the NMT path) ------------------------


def _gru_inputs(rng, b, t, d, device):
    """xw, mask (ragged lengths: row 0 full, the last row of length 1),
    w_h, w_hc, h0."""
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    x = [_rand(rng, b, t, 3 * d), torch.from_numpy(mask),
         _rand(rng, d, 2 * d) * (1.0 / d ** 0.5),
         _rand(rng, d, d) * (1.0 / d ** 0.5), _rand(rng, b, d) * 0.5]
    return [v.to(device) for v in x]


def _gru_kernels_vs_plain(cuda, b, t, d, reverse):
    """The forward kernel (with and without the gate slab) and both
    backward forms against the plain twins on the same CUDA tensors;
    remat and stored gates give the same bits, and a rerun repeats them."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    rng = np.random.default_rng(b * 31 + t + d)
    xw, mask, w_h, w_hc, h0 = _gru_inputs(rng, b, t, d, cuda)
    n_fwd = GK.KERNEL_FWD.launches
    got = GK._fwd_kernel(xw, mask, w_h, w_hc, h0, reverse, True)
    bare = GK._fwd_kernel(xw, mask, w_h, w_hc, h0, reverse, False)
    torch.cuda.synchronize()
    assert GK.KERNEL_FWD.launches == n_fwd + 2
    assert bare[1] is None
    assert torch.equal(got[0], bare[0]) and torch.equal(got[2], bare[2])
    want = GK._fwd_plain(xw, mask, w_h, w_hc, h0, reverse, True)
    for x, y in zip(got, want):
        assert _close(x, y)
    hs, urc = got[:2]
    dhs, dh_t = (_rand(rng, *s).to(cuda) for s in ((b, t, d), (b, d)))
    args = (mask, w_h, w_hc, h0, hs, dhs, dh_t, reverse)
    n_bwd = GK.KERNEL_BWD.launches, GK.KERNEL_BWD_STORED.launches
    stored = GK._bwd_kernel(None, urc, *args, False)
    remat = GK._bwd_kernel(xw, None, *args, True)
    again = GK._bwd_kernel(xw, None, *args, True)
    torch.cuda.synchronize()
    assert (GK.KERNEL_BWD.launches - n_bwd[0],
            GK.KERNEL_BWD_STORED.launches - n_bwd[1]) == (2, 1)
    assert all(torch.equal(x, y) for x, y in zip(stored, remat))
    assert all(torch.equal(x, y) for x, y in zip(remat, again))
    for x, y in zip(remat, GK._bwd_plain(xw, urc, *args, True)):
        assert _close(x, y)


@pytest.mark.parametrize("b,t,d", [
    (3, 7, 8),          # one unit a block
    (5, 9, 300),        # 3 units a block, the last block short
    (130, 9, 32),       # three 64-row chunks
    (64, 32, 512),      # the NMT's width: 4 units a block
    (2, 1, 16),         # one step
])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernels_match_plain(cuda, b, t, d, reverse):
    _gru_kernels_vs_plain(cuda, b, t, d, reverse)


def _bigru_inputs(rng, b, t, e, d, device):
    """x, mask (ragged: row 0 full, the last row of length 1) and both
    directions' (w_x, b, w_h, w_hc, h0)."""
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    mask = torch.from_numpy(
        (np.arange(t)[None, :] < lens[:, None]).astype(np.float32))
    per_dir = lambda: [_rand(rng, e, 3 * d) * (1.0 / e ** 0.5),  # noqa: E731
                       _rand(rng, 3 * d) * 0.1,
                       _rand(rng, d, 2 * d) * (1.0 / d ** 0.5),
                       _rand(rng, d, d) * (1.0 / d ** 0.5),
                       _rand(rng, b, d) * 0.5]
    fw, bw = per_dir(), per_dir()
    return (_rand(rng, b, t, e).to(device), mask.to(device),
            [v.to(device) for v in fw], [v.to(device) for v in bw])


def _bigru_kernel_vs_plain(cuda, b, t, e, d):
    from paddle_tpu_torch.ops.kernels import gru as GK

    rng = np.random.default_rng(b + t + e + d)
    x, mask, fw, bw = _bigru_inputs(rng, b, t, e, d, cuda)
    n = GK.KERNEL_BI.launches
    got = GK._bi_fwd_kernel(x, mask, fw, bw)
    again = GK._bi_fwd_kernel(x, mask, fw, bw)
    torch.cuda.synchronize()
    assert GK.KERNEL_BI.launches == n + 2
    want = GK._bi_fwd_plain(x, mask, fw, bw)
    for g_dir, a_dir, w_dir in zip(got, again, want):
        for gv, av, wv in zip(g_dir, a_dir, w_dir):
            assert _close(gv, wv)
            assert torch.equal(gv, av)


@pytest.mark.parametrize("b,t,e,d", [
    (64, 32, 512, 512),  # the NMT encoder at bench width: 8 units a block
    (3, 7, 12, 8),       # the CPU tests' shapes
    (5, 9, 16, 32),
    (130, 5, 8, 40),     # three 64-row chunks
])
def test_bigru_kernel_matches_plain(cuda, b, t, e, d):
    _bigru_kernel_vs_plain(cuda, b, t, e, d)


def test_gru_kernels_at_the_tiling_limit(cuda):
    """D at the largest width the tiling takes on this card (8 units a
    block on every SM for gru_seq, on half of them for bigru_seq), and
    the refusal 4 past it."""
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import gru as GK

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _gru_kernels_vs_plain(cuda, 4, 3, 8 * sms, True)
    _bigru_kernel_vs_plain(cuda, 4, 3, 16, 8 * (sms // 2))
    rng = np.random.default_rng(0)
    xw, mask, w_h, w_hc, h0 = _gru_inputs(rng, 2, 3, 8 * sms + 4, cuda)
    with pytest.raises(EnforceError, match="units a block"):
        GK.gru_seq(xw, mask, w_h, w_hc, h0)
    x, mask, fw, bw = _bigru_inputs(rng, 2, 3, 16, 8 * (sms // 2) + 4, cuda)
    with pytest.raises(EnforceError, match="units a block"):
        GK.bigru_seq(x, mask, *fw[:4], *bw[:4], fw[4], bw[4])


def test_gru_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import gru as GK

    rng = np.random.default_rng(1)
    x = [v.double() for v in _gru_inputs(rng, 2, 3, 8, cuda)]
    with pytest.raises(EnforceError, match="float32"):
        GK.gru_seq(*x)
    with pytest.raises(EnforceError, match="multiple of 4"):
        GK.gru_seq(*_gru_inputs(rng, 2, 3, 10, cuda))
    x, mask, fw, bw = _bigru_inputs(rng, 2, 3, 10, 8, cuda)
    with pytest.raises(EnforceError, match="E=10 must be a multiple of 4"):
        GK.bigru_seq(x, mask, *fw[:4], *bw[:4], fw[4], bw[4])


@pytest.mark.parametrize("remat", [False, True])
def test_gru_function_on_card_matches_the_cpu(cuda, remat):
    """``gru_seq`` (forward and backward kernels) against the CPU's plain
    twins: hs, h_T and every input gradient, both directions; the card's
    gradients repeat bit for bit."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    rng = np.random.default_rng(7)
    cpu = _gru_inputs(rng, 6, 11, 40, "cpu")
    r = _rand(rng, 6, 11, 40)
    for reverse in (False, True):
        outs = []
        for dev in ("cpu", cuda, cuda):
            leaves = [x.to(dev).detach().requires_grad_(i != 1)
                      for i, x in enumerate(cpu)]
            hs, h_t = GK.gru_seq(*leaves, reverse=reverse, remat=remat)
            loss = (hs * r.to(dev)).sum() + 0.5 * h_t.sum()
            grads = torch.autograd.grad(loss, [x for i, x in
                                               enumerate(leaves) if i != 1])
            outs.append([hs, h_t, *grads])
        for want, got, again in zip(*outs):
            assert _close(got.cpu(), want)
            assert torch.equal(got, again)


@pytest.mark.parametrize("b,t,e,d", [(64, 32, 512, 512), (5, 9, 16, 8)])
def test_bigru_function_on_card_matches_the_cpu(cuda, b, t, e, d):
    """``bigru_seq`` (the forward kernel, then two GRU backward launches)
    against the CPU's plain twins: every output and input gradient; the
    card's gradients repeat bit for bit."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    rng = np.random.default_rng(11 + d)
    x, mask, fw, bw = _bigru_inputs(rng, b, t, e, d, "cpu")
    cpu = [x, mask, *fw[:4], *bw[:4], fw[4], bw[4]]
    r = [_rand(rng, b, t, d), _rand(rng, b, t, d)]
    outs = []
    for dev in ("cpu", cuda, cuda):
        leaves = [v.to(dev).detach().requires_grad_(i != 1)
                  for i, v in enumerate(cpu)]
        n = GK.KERNEL_BI.launches, GK.KERNEL_BWD.launches, \
            GK.KERNEL_FWD.launches
        hsf, hsb, htf, htb = GK.bigru_seq(*leaves)
        loss = ((hsf * r[0].to(dev)).sum() + (hsb * r[1].to(dev)).sum()
                + htf.sum() - 0.5 * htb.sum())
        grads = torch.autograd.grad(loss, [v for i, v in enumerate(leaves)
                                           if i != 1])
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (GK.KERNEL_BI.launches - n[0],
                    GK.KERNEL_BWD.launches - n[1],
                    GK.KERNEL_FWD.launches - n[2]) == (1, 2, 0)
        outs.append([hsf, hsb, htf, htb, *grads])
    for want, got, again in zip(*outs):
        assert _close(got.cpu(), want)
        assert torch.equal(got, again)


# -- channel_stats (the batch-norm moments of the small_vgg path) ------------------

# small_vgg's five [R, C] views at batch 128 of 32x32, a ragged R, a C that
# is not a multiple of 4 (the scalar form), a single row, C = 3 and a C
# wider than a block's column chunk
VGG_STATS_VIEWS = [(131072, 64), (32768, 128), (8192, 256), (2048, 512),
                   (128, 512)]
STATS_SHAPES = VGG_STATS_VIEWS + [(1000003 // 7, 48), (777, 45), (1, 96),
                                  (1000, 3), (64, 4100)]


@pytest.mark.parametrize("r,c", STATS_SHAPES)
def test_channel_stats_kernel_matches_plain(cuda, r, c):
    """Sum and sum of squares against the twin within 1e-4 x max(1, |ref|)
    (f32 sums in another order); a rerun gives the same bits."""
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    rng = np.random.default_rng(r + c)
    x = (_rand(rng, r, c) * 2 + 0.5).to(cuda)
    before = CS.KERNEL.launches
    got = CS.channel_stats(x)
    again = CS.channel_stats(x)
    torch.cuda.synchronize()
    assert CS.KERNEL.launches == before + 2
    want = CS.channel_stats_reference(x)
    for a, b, c_ in zip(got, want, again):
        assert a.shape == (c,)
        assert (a - b).abs().max().item() <= TOL * max(1.0, b.abs().max().item())
        assert torch.equal(a, c_)


def _stats_inputs(rng, r, c, dtype):
    return (_rand(rng, r, c) * 2 + 0.5).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_stats_is_one_kernel_a_call_in_a_trace(cuda, dtype):
    """A ``torch.profiler`` trace of 40 calls at small_vgg's widest view
    holds only ``channel_stats_kernel`` records, at most one a call (the
    H100 host's traces drop some of their first records: 7 to 9 of 40
    seen), and the counter counts 40."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    x = _stats_inputs(np.random.default_rng(1), 131072, 64, dtype).to(cuda)
    kernel = CS.KERNELS[dtype]
    CS.channel_stats(x)
    torch.cuda.synchronize()
    before = kernel.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(40):
            CS.channel_stats(x)
        torch.cuda.synchronize()
    assert kernel.launches == before + 40
    names = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}
    form = "__nv_bfloat16, 8>" if dtype == torch.bfloat16 else "float, 4>"
    assert names and all("channel_stats_kernel<" + form in k for k in names)
    assert 20 <= sum(names.values()) <= 40, names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", VGG_STATS_VIEWS)
def test_channel_stats_reruns_bit_identical_with_another_shape_between(
        cuda, r, c, dtype):
    """x, then another shape (which draws the same tickets), then x
    again: the same bits, within 1e-4 x max(1, |ref|) of the twin (bf16:
    of the float64 sums of the same values), and every ticket back at 0
    (a ticket left behind would finish the next call early)."""
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    rng = np.random.default_rng(r * c)
    x = _stats_inputs(rng, r, c, dtype).to(cuda)
    other = _stats_inputs(rng, 4096, 64, dtype).to(cuda)
    got = CS.channel_stats(x)
    between = CS.channel_stats(other)
    again = CS.channel_stats(x)
    torch.cuda.synchronize()
    for xs, outs in ((x, got), (x, again), (other, between)):
        want = CS.channel_stats_reference(xs.double())
        for a, b in zip(outs, want):
            assert a.dtype == torch.float32 and a.shape == (xs.shape[1],)
            assert (a.double() - b).abs().max().item() <= TOL * max(
                1.0, b.abs().max().item())
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    tickets = _kept.KEPT[(cuda.index, stream)]._tensors[1]
    assert not tickets.any()


def test_channel_stats_on_two_streams_is_right_on_both(cuda):
    """Two calls queued together on two streams, each with scratch and
    tickets of its own: both right and equal to the same call on the
    default stream."""
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    rng = np.random.default_rng(2)
    xs = [_stats_inputs(rng, r, c, torch.float32).to(cuda)
          for r, c in ((131072, 64), (32768, 128))]
    want = [CS.channel_stats(x) for x in xs]
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    torch.cuda.synchronize()
    got = []
    for _ in range(5):
        for x, st in zip(xs, streams):
            with torch.cuda.stream(st):
                got.append((CS.channel_stats(x), st))
    torch.cuda.synchronize()
    for i, (outs, st) in enumerate(got):
        assert all(torch.equal(a, b) for a, b in zip(outs, want[i % 2]))
        kept = _kept.KEPT[(cuda.index, st.cuda_stream)]
        assert not kept._tensors[1].any()
    keys = {(cuda.index, st.cuda_stream) for st in streams}
    assert keys <= set(_kept.KEPT)
    assert len({_kept.KEPT[k].tickets_ptr for k in keys}) == 2


def test_channel_stats_f32_takes_the_scalar_form_where_16_bytes_do_not_fit(
        cuda):
    """f32 at C % 4 != 0 and at a view 4 bytes past a 16-byte boundary
    takes the one-channel form: within 1e-4 of the twin, a rerun in the
    same bits."""
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    rng = np.random.default_rng(6)
    odd = _stats_inputs(rng, 5000, 45, torch.float32).to(cuda)
    x = _stats_inputs(rng, 5000, 64, torch.float32).to(cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 4
    for v in (odd, shifted):
        got, again = CS.channel_stats(v), CS.channel_stats(v)
        assert (cuda.index, v.shape[0], v.shape[1], torch.float32,
                CS.SCALAR) in CS._PREPARED
        for a, b, a2 in zip(got, CS.channel_stats_reference(v), again):
            assert (a - b).abs().max().item() <= TOL * max(
                1.0, b.abs().max().item())
            assert torch.equal(a, a2)


def test_channel_stats_function_on_card_matches_the_cpu(cuda):
    """The autograd Function on a 4-D NHWC input: sums and ``dx = g_s +
    2 x g_ss`` against the CPU twin."""
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    rng = np.random.default_rng(3)
    x = _rand(rng, 4, 9, 7, 40)
    gs, gss = _rand(rng, 40), _rand(rng, 40)
    outs = []
    for dev in ("cpu", cuda):
        leaf = x.to(dev).requires_grad_()
        s, ss = CS.channel_stats(leaf)
        (dx,) = torch.autograd.grad((s * gs.to(dev)).sum()
                                    + (ss * gss.to(dev)).sum(), [leaf])
        outs.append([s, ss, dx])
    for want, got in zip(*outs):
        assert (got.cpu() - want).abs().max().item() <= TOL * max(
            1.0, want.abs().max().item())


def test_channel_stats_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    with pytest.raises(EnforceError, match="float32"):
        CS.channel_stats(torch.zeros(8, 4, dtype=torch.float64, device=cuda))
    with pytest.raises(EnforceError, match="float32"):
        CS.channel_stats(torch.zeros(8, 4, device=cuda).half())
    with pytest.raises(EnforceError, match="contiguous"):
        CS.channel_stats(torch.zeros(4, 8, device=cuda).t())
    with pytest.raises(EnforceError, match="several devices"):
        CS.channel_stats_grad(torch.zeros(8, 4, device=cuda),
                              torch.zeros(4), torch.zeros(4, device=cuda))


def test_batch_norm_on_card_takes_the_kernel_and_matches_the_cpu(cuda):
    """``ops/nn.batch_norm`` in training: one ``channel_stats`` launch on
    the card (``use_fused_stats=None``), none in test mode or for a
    float64 input; outputs, new statistics and gradients against the
    CPU."""
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import channel_stats as CS

    rng = np.random.default_rng(4)
    x, r = _rand(rng, 4, 8, 8, 16), _rand(rng, 4, 8, 8, 16)
    ga, be = _rand(rng, 16) * 0.2 + 1, _rand(rng, 16) * 0.2
    rm, rv = _rand(rng, 16) * 0.1, _rand(rng, 16).abs() + 0.5
    outs = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in (x, ga, be)]
        before = CS.KERNEL.launches
        y, nm, nv = nn_ops.batch_norm(*leaves, rm.to(dev), rv.to(dev), True)
        grads = torch.autograd.grad((y * r.to(dev)).sum(), leaves)
        launched = CS.KERNEL.launches - before
        assert launched == (1 if dev != "cpu" else 0)
        outs.append([y, nm, nv, *grads])
    for want, got in zip(*outs):
        assert (got.cpu() - want).abs().max().item() <= TOL * max(
            1.0, want.abs().max().item())
    before = CS.KERNEL.launches
    nn_ops.batch_norm(x.to(cuda), ga.to(cuda), be.to(cuda), rm.to(cuda),
                      rv.to(cuda), False)
    nn_ops.batch_norm(*(t.to(cuda).double() for t in (x, ga, be, rm, rv)),
                      True)
    torch.cuda.synchronize()
    assert CS.KERNEL.launches == before


@pytest.mark.parametrize("shape,w_shape,s,p", [
    ((64, 227, 227, 3), (11, 11, 3, 96), 4, 1),    # AlexNet conv1
    ((64, 27, 27, 96), (5, 5, 96, 256), 1, 2),     # AlexNet conv2
    ((64, 32, 32, 3), (5, 5, 3, 32), 1, 2),        # smallnet conv1
])
def test_direct_conv_at_the_image_zoo_shapes(cuda, shape, w_shape, s, p):
    """The direct conv kernel at the new filter sizes of the bench nets
    (11x11 stride 4 with Cin 3, 5x5) against the plain convolution."""
    from paddle_tpu_torch.ops.kernels import conv as CV

    rng = np.random.default_rng(w_shape[0])
    x = _rand(rng, *shape).to(cuda)
    w = (_rand(rng, *w_shape) * (2.0 / np.prod(w_shape[:3])) ** 0.5).to(cuda)
    before = CV.KERNEL.launches
    got = CV.fwd_raw(x, w, (s, s), (p, p))
    again = CV.fwd_raw(x, w, (s, s), (p, p))
    torch.cuda.synchronize()
    assert CV.KERNEL.launches == before + 2
    want = CV.fwd_raw_reference(x, w, (s, s), (p, p))
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= TOL * max(
        1.0, want.abs().max().item())
    assert torch.equal(got, again)


def test_dropout_on_card_repeats_and_keeps_its_rate(cuda):
    """A dropout mask on the card depends only on (step seed, layer
    name): the same twice, another for another name; the kept share
    within 4 sigma of 1 - rate over 10^6 draws, kept values x / keep."""
    from paddle_tpu_torch.layers.base import Context
    from paddle_tpu_torch.ops import nn as nn_ops

    ctx = Context(True, seed=1234)
    x = torch.ones(1000, 1000, device=cuda)
    a = nn_ops.dropout(x, 0.3, ctx.generator_for("d", cuda), True)
    b = nn_ops.dropout(x, 0.3, ctx.generator_for("d", cuda), True)
    c = nn_ops.dropout(x, 0.3, ctx.generator_for("e", cuda), True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.7) <= 4 * (0.7 * 0.3 / x.numel()) ** 0.5
    assert torch.equal(a[a != 0], (x / 0.7)[a != 0])


# -- the fused SGD / Momentum update and the row-lazy table update -------------

# mixed sizes: 1 and 10 (small_vgg's last bias), a block's 2048 and one
# past it, a conv weight, and a view with an offset
UPDATE_SHAPES = [(1,), (10,), (2048,), (2049,), (3, 3, 64, 64), (513, 7)]


def _bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _fresh(ups):
    """Copies of the updates' p and v (a view at an offset stays one), the
    gradients shared: each in-place run takes its own."""
    def copy(t):
        if t is None:
            return None
        if not t.storage_offset():
            return t.clone()
        buf = torch.empty(t.numel() + 5, device=t.device)
        return buf[5:].view(t.shape).copy_(t)

    return [dataclasses.replace(u, p=copy(u.p), v=copy(u.v)) for u in ups]


def _updates(rng, dev, kind, wd, shapes=UPDATE_SHAPES):
    from paddle_tpu_torch.ops.kernels import update as U

    out = []
    for i, s in enumerate(shapes):
        p, g, v = (_rand(rng, *s).to(dev) for _ in range(3))
        if i == len(shapes) - 1:       # a view at an offset into a buffer
            p = torch.cat([_rand(rng, 5).to(dev), p.reshape(-1)])[5:].view(s)
        k = kind if kind != "mixed" else ("sgd", "momentum", "nesterov")[i % 3]
        out.append(U.TensorUpdate(p, g, None if k == "sgd" else v,
                                  lr=0.1 / (i + 1), mu=0.9 - 0.1 * i,
                                  nesterov=k == "nesterov",
                                  weight_decay=wd))
    return out


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov", "mixed"])
@pytest.mark.parametrize("wd", [0.0, 0.02])
def test_fused_update_kernel_is_bit_equal_to_the_twin(cuda, kind, wd):
    """One launch for the whole list; p' and v' equal the eager twin bit
    for bit (the kernel rounds each product and sum on its own); a rerun
    gives the same bits."""
    from paddle_tpu_torch.ops.kernels import update as U

    ups = _updates(np.random.default_rng(len(kind) + int(wd * 100)), cuda,
                   kind, wd)
    want = [U.reference_update(u) for u in ups]
    # in place: each run takes its own copies of p and v
    first, second = _fresh(ups), _fresh(ups)
    before = U.KERNEL.launches
    got = U.fused_update(first)
    again = U.fused_update(second)
    torch.cuda.synchronize()
    assert U.KERNEL.launches == before + 2
    for u, (want_p, want_v), (p2, v2), (p3, v3) in zip(first, want, got,
                                                        again):
        assert p2 is u.p and v2 is u.v
        assert p2.shape == want_p.shape and _bits(p2, want_p)
        assert _bits(p2, p3)
        assert (v2 is None) == (want_v is None)
        if v2 is not None:
            assert _bits(v2, want_v) and _bits(v2, v3)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
@pytest.mark.parametrize("wd", [0.0, 0.02])
def test_sparse_row_kernel_is_bit_equal_to_the_twin(cuda, kind, wd):
    """Tables of width 64 (the CTR's), 5 and 100 (a lane tail) in one
    launch; all-zero rows, a -0.0 row and a row with one nonzero; the
    untouched rows copied through bit for bit."""
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import update as U

    rng = np.random.default_rng(len(kind) * 3 + int(wd * 100))
    ups = []
    for rows, d in ((1000, 64), (37, 5), (9, 100)):
        g = _rand(rng, rows, d)
        g[rng.random(rows) < 0.4] = 0.0
        g[1] = -0.0
        g[2] = 0.0
        g[2, d - 1] = 0.5
        ups.append(U.TensorUpdate(
            _rand(rng, rows, d).to(cuda), g.to(cuda),
            None if kind == "sgd" else _rand(rng, rows, d).to(cuda), lr=0.05,
            mu=0.9, nesterov=kind == "nesterov", weight_decay=wd))
    want = [EK.reference_row_update(u) for u in ups]
    first, second = _fresh(ups), _fresh(ups)
    before = EK.KERNEL_ROWS.launches
    got = EK.sparse_row_update(first)
    again = EK.sparse_row_update(second)
    torch.cuda.synchronize()
    assert EK.KERNEL_ROWS.launches == before + 2
    for u, (want_p, want_v), (p2, v2), (p3, v3) in zip(ups, want, got,
                                                        again):
        assert _bits(p2, want_p) and _bits(p2, p3)
        untouched = ~(u.g != 0).any(dim=1)
        assert untouched[1] and not untouched[2]
        assert _bits(p2[untouched], u.p[untouched])
        if v2 is not None:
            assert _bits(v2, want_v) and _bits(v2, v3)
            assert _bits(v2[untouched], u.v[untouched])


def test_fused_update_takes_resnet50s_161_tensors_in_one_launch(cuda):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.ops.kernels import update as U

    cost = paddle.models.image.resnet_cost(depth=50, class_num=1000,
                                           height=224, width=224)[0]
    shapes = [s.shape for s in Topology(cost).param_specs()]
    assert len(shapes) == 161
    ups = _updates(np.random.default_rng(50), cuda, "momentum", 0.0, shapes)
    want = [U.reference_update(u) for u in ups]
    before = U.KERNEL.launches
    got = U.fused_update(ups)
    torch.cuda.synchronize()
    assert U.KERNEL.launches == before + 1
    for (want_p, want_v), (p2, v2) in zip(want, got):
        assert _bits(p2, want_p) and _bits(v2, want_v)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
def test_routed_apply_on_card_is_bit_identical_to_the_loop(cuda, kind):
    """``Optimizer.apply`` on the card (a global L2, a spec decay rate, a
    spec learning rate and momentum, a static parameter, a lazy table):
    one dense and one row-lazy launch a step, the loop's bits."""
    import paddle_tpu_torch.optimizer as TO
    from paddle_tpu_torch.core import initializer as TI
    from paddle_tpu_torch.core.parameters import ParamSpec
    from paddle_tpu_torch.layers.attr import ParamAttr
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import update as U

    fields = {"w": {}, "b": {"decay_rate": 5e-3},
              "s": {"learning_rate": 0.25, "momentum": 0.5},
              "frozen": {"is_static": True},
              "emb": {"sparse": True, "decay_rate": 0.25,
                      "attr": ParamAttr(name="emb", sparse_update=True)}}
    shapes = {"w": (64, 32), "b": (10,), "s": (3, 3, 4, 8), "frozen": (5,),
              "emb": (100, 64)}
    specs = {n: ParamSpec(name=n, shape=shapes[n],
                          initializer=TI.constant(0.0), **f)
             for n, f in fields.items()}
    make = {"sgd": lambda **kw: TO.SGD(**kw),
            "momentum": lambda **kw: TO.Momentum(momentum=0.9, **kw),
            "nesterov": lambda **kw: TO.Momentum(momentum=0.9,
                                                 use_nesterov=True, **kw)}
    opt = make[kind](learning_rate=0.1,
                     regularization=TO.L2Regularization(rate=1e-3))
    rng = np.random.default_rng(len(kind))
    p0 = {n: _rand(rng, *s).to(cuda) for n, s in shapes.items()}
    # the routed apply updates in place: it gets its own copies
    given = {n: t.clone() for n, t in p0.items()}
    pa, sa = given, opt.init(given, specs)
    pb, sb = p0, opt.init(p0, specs)
    before = (U.KERNEL.launches, EK.KERNEL_ROWS.launches)
    builds = (U.KERNEL.table_builds, EK.KERNEL_ROWS.table_builds)
    for _ in range(10):
        g = {n: _rand(rng, *s).to(cuda) for n, s in shapes.items()}
        g["emb"][torch.from_numpy(rng.random(100) < 0.5).to(cuda)] = 0.0
        pa, sa = opt.apply(g, pa, sa, specs)
        pb, sb = opt._apply_each(g, pb, sb, specs)
        torch.cuda.synchronize()
        for n in shapes:
            assert _bits(pa[n], pb[n]), n
    assert (U.KERNEL.launches - before[0],
            EK.KERNEL_ROWS.launches - before[1]) == (10, 10)
    # the tables were built at the first step and kept
    assert (U.KERNEL.table_builds - builds[0],
            EK.KERNEL_ROWS.table_builds - builds[1]) == (1, 1)
    for n in shapes:
        assert pa[n] is given[n]
        if isinstance(sb["slots"][n], dict):
            assert _bits(sa["slots"][n]["velocity"],
                         sb["slots"][n]["velocity"]), n


def test_update_routes_float64_to_the_twins_and_refuses_half(cuda):
    """A float64 step on the card (the witness) takes the twins, no
    launch; a float16 parameter on the card raises."""
    import paddle_tpu_torch.optimizer as TO
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import update as U

    opt = TO.Momentum(momentum=0.9, learning_rate=0.1)
    p = {"w": torch.ones(7, device=cuda, dtype=torch.float64)}
    before = U.KERNEL.launches
    got, _ = opt.apply({"w": torch.ones_like(p["w"])}, p, opt.init(p))
    assert U.KERNEL.launches == before
    assert got["w"].dtype == torch.float64
    with pytest.raises(EnforceError, match="float32"):
        U.fused_update([U.TensorUpdate(
            torch.ones(7, device=cuda).half(),
            torch.ones(7, device=cuda).half())])


@pytest.mark.parametrize("rows", [False, True])
def test_kept_table_gives_the_twins_bits_over_ten_steps_and_a_miss(cuda,
                                                                   rows):
    """In place across 10 steps, new gradients each step: the dense or
    row-lazy kernel against the twins applied step by step, in bits; one
    table built for the 10 steps, one more after a parameter tensor is
    replaced (a miss), the twins' bits still."""
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import update as U

    rng = np.random.default_rng(17 + rows)
    kernel, run, twin = ((EK.KERNEL_ROWS, EK.sparse_row_update,
                          EK.reference_row_update) if rows else
                         (U.KERNEL, U.fused_update, U.reference_update))
    shapes = ([(1000, 64), (37, 5), (9, 100)] if rows
              else [(64, 3, 3, 3), (2049,), (10,), (300, 7)])
    ups = _updates(rng, cuda, "mixed" if not rows else "momentum", 0.01,
                   shapes)
    if rows:
        ups = [dataclasses.replace(u, p=u.p.clone()) for u in ups]
    ref = _fresh(ups)

    def step():
        for u, r in zip(ups, ref):
            g = _rand(rng, *u.p.shape).to(cuda)
            if rows:
                g[torch.from_numpy(rng.random(u.p.shape[0]) < 0.4)] = 0.0
            u.g = r.g = g
            r.p, r.v = twin(r)
        run(ups)
        torch.cuda.synchronize()
        for u, r in zip(ups, ref):
            assert _bits(u.p, r.p) and (u.v is None or _bits(u.v, r.v))

    builds = kernel.table_builds
    for _ in range(10):
        step()
    assert kernel.table_builds == builds + 1
    ups[1] = dataclasses.replace(ups[1], p=ups[1].p.clone())
    step()
    step()
    assert kernel.table_builds == builds + 2


def test_kept_table_call_builds_pins_and_allocates_nothing(cuda,
                                                           monkeypatch):
    """A ``fused_update`` call on a kept table builds no numpy table,
    pins no host block and allocates no output; each written tensor's
    version counter moves."""
    from paddle_tpu_torch.ops.kernels import update as U

    ups = _updates(np.random.default_rng(4), cuda, "momentum", 0.0)
    U.fused_update(ups)

    def refuse(*a, **kw):
        raise AssertionError("called on a kept table")

    monkeypatch.setattr(U, "build_table", refuse)
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    monkeypatch.setattr(torch, "empty_like", refuse)
    versions = [(u.p._version, u.v._version) for u in ups]
    U.fused_update(ups)
    torch.cuda.synchronize()
    for u, (pv, vv) in zip(ups, versions):
        assert u.p._version > pv and u.v._version > vv


@pytest.mark.parametrize("n", [0, 1, 8192, 70000])
@pytest.mark.parametrize("v", [1, 37, 30000, 50257, 10 ** 6])
def test_group_ids_kernel_equals_the_twin(cuda, v, n):
    """The grouping passes' counts, offsets and order against
    ``group_ids_reference``, in integers: ids in [-2, V + 2) (those
    outside [0, V) dropped)."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    gen = torch.Generator().manual_seed(v + n)
    ids = torch.randint(-2, v + 2, (n,), generator=gen)
    before = EK.KERNEL_GROUP.launches
    got = EK.group_ids(ids.to(cuda), v)
    torch.cuda.synchronize()
    assert EK.KERNEL_GROUP.launches == before + 1
    for g, w in zip(got, EK.group_ids_reference(ids, v)):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("v", [30000, 50257])
def test_group_ids_kernel_keeps_a_long_run_in_order(cuda, v):
    """8,192 equal ids (one run across 8 grouping chunks), and the text
    row's batch (ids of 64 rows of 128, the last 28 steps padding id 0)."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    gen = torch.Generator().manual_seed(v)
    batch = torch.randint(0, v, (64, 128), generator=gen)
    batch[:, 100:] = 0
    for ids in (torch.full((8192,), 7), batch.reshape(-1)):
        got = EK.group_ids(ids.to(cuda), v)
        for g, w in zip(got, EK.group_ids_reference(ids, v)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("table_dtype,rows_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,v,d", [(0, 5, 8), (1, 3, 8), (8192, 30000, 128),
                                   (5000, 37, 40), (2000, 1, 130)])
def test_scatter_forms_match_their_twins_and_rerun_in_bits(
        cuda, table_dtype, rows_dtype, n, v, d):
    """Each form of the scatter-add and of the table gradient (no table)
    against the plain composition of its order of sums
    (``scatter_add_by_groups``) and the twin: f32 within 1e-5, or on a row
    with a long run (up to 2,048 rows) within the two orders' f32 error
    bound, k 2^-23 (|table| + sum |rows|) for a run of k; bf16 within
    one ulp on at most 1% of the entries; reruns in the same bits; one C
    call a call, the grouping counted."""
    import chip_smoke as S
    from paddle_tpu_torch.ops.kernels import embedding as EK

    gen = torch.Generator(device=cuda).manual_seed(n + v + d)
    table = torch.randn(v, d, generator=gen, device=cuda).to(table_dtype)
    ids = torch.randint(-2, v + 2, (n,), generator=gen, device=cuda)
    if n >= 8192:
        ids[: n // 4] = 0               # a long run, as padding gives
    rows = torch.randn(n, d, generator=gen, device=cuda).to(rows_dtype)
    form = (EK.KERNEL_SCATTER if table_dtype == torch.float32
            else EK.KERNEL_SCATTER_BF16)
    for tab, out_dtype in ((table, table_dtype), (None, rows_dtype)):
        if tab is None and rows_dtype != table_dtype:
            continue
        before = (form.launches, EK.KERNEL_GROUP.launches)
        if tab is None:
            got, again = (EK.table_grad(ids, rows, v) for _ in range(2))
            base = torch.zeros(v, d, dtype=rows_dtype, device=cuda)
        else:
            got, again = (EK.embedding_scatter_add(tab, ids, rows)
                          for _ in range(2))
            base = tab
        torch.cuda.synchronize()
        assert (form.launches - before[0],
                EK.KERNEL_GROUP.launches - before[1]) == (2, 2)
        assert got.dtype == out_dtype and torch.equal(got, again)
        twin = EK.embedding_scatter_add_reference(base, ids, rows)
        plain = EK.scatter_add_by_groups(tab, ids, rows, num_rows=v)
        if out_dtype == torch.float32:
            bound = _sum_bound(base, ids, rows)
            assert bool(((got - plain).abs() <= bound).all())
            assert bool(((got - twin).abs() <= bound).all())
        else:
            assert S.bf16_exact_agreement(got, twin)["ok"]
            assert S.bf16_exact_agreement(got, plain)["ok"]


def _sum_bound(base, ids, rows):
    """Per entry, 1e-5 or the f32 error bound of two summation orders of
    a row's run of k: k 2^-23 (|table| + sum |rows|)."""
    v = base.shape[0]
    keep = (ids >= 0) & (ids < v)
    mag = base.double().abs().index_add(0, ids[keep],
                                        rows[keep].double().abs())
    k = torch.bincount(ids[keep], minlength=v).double()[:, None]
    return torch.clamp(k * 2.0 ** -23 * mag, min=1e-5)


def test_scatter_add_path_sorts_clones_and_zeros_nothing(cuda, monkeypatch):
    """The scatter-add and the table gradient on the card: no
    ``torch.sort``, no clone, no ``torch.zeros``; one ctypes call a
    call."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    table = torch.randn(300, 16, device=cuda)
    ids = torch.randint(-1, 301, (1000,), device=cuda)
    rows = torch.randn(1000, 16, device=cuda)
    want = EK.embedding_scatter_add(table, ids, rows)
    grad = EK.table_grad(ids, rows, 300)

    def refuse(*a, **kw):
        raise AssertionError("not on the scatter-add's path")

    calls = []
    real = EK.KERNEL_SCATTER.launch
    monkeypatch.setattr(EK.KERNEL_SCATTER, "launch",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(EK.KERNEL_GROUP, "launch", refuse)
    for name in ("sort", "zeros", "zeros_like"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "clone", refuse)
    got = EK.embedding_scatter_add(table, ids, rows)
    got_grad = EK.table_grad(ids, rows, 300)
    monkeypatch.undo()
    assert len(calls) == 2
    assert torch.equal(got, want) and torch.equal(got_grad, grad)


# -- the raw-input recurrences (rows 6 and 9) and softmax_xent (row 4) -------------


def _fi_inputs(kind, rng, b, t, e, d, device):
    """x, mask (ragged: row 0 full, the last row of length 1) and the
    weights of ``lstm_seq_fi`` (w_x, b, w_h, peep, h0, c0) or
    ``gru_seq_fi`` (w_x, b, w_h, w_hc, h0)."""
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    mask = torch.from_numpy(
        (np.arange(t)[None, :] < lens[:, None]).astype(np.float32))
    n = 4 if kind == "lstm" else 3
    w = [_rand(rng, e, n * d) * (1.0 / e ** 0.5), _rand(rng, n * d) * 0.1]
    if kind == "lstm":
        w += [_rand(rng, d, 4 * d) * (1.0 / d ** 0.5),
              _rand(rng, 3, d) * 0.3, _rand(rng, b, d) * 0.5,
              _rand(rng, b, d) * 0.5]
    else:
        w += [_rand(rng, d, 2 * d) * (1.0 / d ** 0.5),
              _rand(rng, d, d) * (1.0 / d ** 0.5), _rand(rng, b, d) * 0.5]
    return (_rand(rng, b, t, e).to(device), mask.to(device),
            [v.to(device) for v in w])


def _fi_module(kind):
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    return LK if kind == "lstm" else GK


def _fi_kernel_vs_plain(cuda, kind, b, t, e, d, reverse):
    """The fused-input forward kernel, with and without its gate slab,
    against the plain twin on the same CUDA tensors; the slab leaves the
    other outputs' bits alone, and a rerun repeats them."""
    mod = _fi_module(kind)
    rng = np.random.default_rng(b * 7 + t + e + d)
    x, mask, w = _fi_inputs(kind, rng, b, t, e, d, cuda)
    n = mod.KERNEL_FI.launches
    got = mod._fi_fwd_kernel(x, mask, *w, reverse, True)
    bare = mod._fi_fwd_kernel(x, mask, *w, reverse, False)
    again = mod._fi_fwd_kernel(x, mask, *w, reverse, False)
    torch.cuda.synchronize()
    assert mod.KERNEL_FI.launches == n + 3
    gate = 2 if kind == "lstm" else 1       # the slab's place in the tuple
    assert bare[gate] is None
    for i, (g, a, c) in enumerate(zip(got, bare, again)):
        if i != gate:
            assert torch.equal(g, a) and torch.equal(a, c)
    for g, v in zip(got, mod._fi_fwd_plain(x, mask, *w, reverse, True)):
        assert _close(g, v)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("b,t,e,d", [
    (3, 7, 12, 8),       # the CPU tests' shapes
    (5, 9, 16, 300),     # 3 units a block, the last block short
    (130, 5, 8, 40),     # three 64-row chunks
    (2, 1, 4, 16),       # one step
])
@pytest.mark.parametrize("reverse", [False, True])
def test_fi_kernel_matches_plain(cuda, kind, b, t, e, d, reverse):
    _fi_kernel_vs_plain(cuda, kind, b, t, e, d, reverse)


@pytest.mark.parametrize("kind,b,t,e,d", [
    ("lstm", 64, 100, 128, 512),   # ops.rnn.lstm at the path's width
    ("gru", 64, 32, 512, 512),     # ops.rnn.gru at the path's width
])
def test_fi_kernel_matches_plain_at_the_path_width(cuda, kind, b, t, e, d):
    for reverse in (False, True):
        _fi_kernel_vs_plain(cuda, kind, b, t, e, d, reverse)


def _widest_e(mod, d, card):
    """The largest E (a multiple of 4) the fit predicate takes at D."""
    e = 4
    while mod._fi_refusal(e + 4, d, *card) is None:
        e += 4
    return e


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_fi_kernel_at_the_shared_memory_edge(cuda, kind):
    """At D 512 the widest E the predicate takes runs and matches its
    twin; 4 more is refused by the wrapper before any launch."""
    from paddle_tpu_torch.core.enforce import EnforceError

    mod = _fi_module(kind)
    card = mod._card(cuda)
    e = _widest_e(mod, 512, card)
    assert mod.fi_fits(cuda, e, 512) and not mod.fi_fits(cuda, e + 4, 512)
    _fi_kernel_vs_plain(cuda, kind, 3, 2, e, 512, False)
    rng = np.random.default_rng(0)
    x, mask, w = _fi_inputs(kind, rng, 2, 2, e + 4, 512, cuda)
    n = mod.KERNEL_FI.launches
    fn = mod.lstm_seq_fi if kind == "lstm" else mod.gru_seq_fi
    with pytest.raises(EnforceError, match="shared memory"):
        fn(x, mask, *w)
    assert mod.KERNEL_FI.launches == n


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("remat", [False, True])
def test_fi_function_on_card_matches_the_cpu(cuda, kind, remat):
    """``lstm_seq_fi`` / ``gru_seq_fi`` (the forward kernel, then the row 5
    / row 8 backward kernel) against the CPU's plain twins: every output
    and input gradient, both directions; the card repeats its bits."""
    mod = _fi_module(kind)
    fn = mod.lstm_seq_fi if kind == "lstm" else mod.gru_seq_fi
    rng = np.random.default_rng(5)
    x, mask, w = _fi_inputs(kind, rng, 6, 11, 12, 40, "cpu")
    r = _rand(rng, 6, 11, 40)
    for reverse in (False, True):
        outs = []
        for dev in ("cpu", cuda, cuda):
            leaves = [v.to(dev).detach().requires_grad_() for v in [x, *w]]
            out = fn(leaves[0], mask.to(dev), *leaves[1:], reverse=reverse,
                     remat=remat)
            hs, last = out[0], out[1]
            last = last if kind == "lstm" else (last,)
            loss = (hs * r.to(dev)).sum() + sum(
                (0.5 + i) * s.sum() for i, s in enumerate(last))
            outs.append([hs, *last, *torch.autograd.grad(loss, leaves)])
        for want, got, again in zip(*outs):
            assert _close(got.cpu(), want)
            assert torch.equal(got, again)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_raw_rnn_route_is_the_predicted_one(cuda, kind):
    """``ops/rnn.lstm`` / ``gru`` on the card: where the predicate takes
    the shape, one fused-input forward and one remat backward launch and
    no launch of the sequence forward; one E past the shared-memory edge,
    the projection and the sequence kernels (forward and the backward in
    its stored-gates form: the slab fits) instead; the two routes
    agree."""
    from paddle_tpu_torch.core.lod import SequenceBatch
    from paddle_tpu_torch.ops import rnn as R

    mod = _fi_module(kind)
    e_edge = _widest_e(mod, 64, mod._card(cuda))
    for e, fused in ((e_edge, True), (e_edge + 4, False)):
        rng = np.random.default_rng(e)
        x, mask, w = _fi_inputs(kind, rng, 4, 5, e, 64, cuda)
        recurrent = (w[2],) if kind == "lstm" else (w[2], w[3])
        assert R.fused_input_fits(x, mod, w[0], *recurrent) == fused
        seq = SequenceBatch(x.requires_grad_(),
                            mask.sum(1).long())
        n = (mod.KERNEL_FI.launches, mod.KERNEL_FWD.launches,
             mod.KERNEL_BWD.launches, mod.KERNEL_BWD_STORED.launches)
        if kind == "lstm":
            out, _ = R.lstm(seq, w[0], w[2], w[1])
        else:
            out, _ = R.gru(seq, w[0], w[2], w[3], w[1])
        (dx,) = torch.autograd.grad(out.data.sum(), x)
        torch.cuda.synchronize()
        got = (mod.KERNEL_FI.launches - n[0], mod.KERNEL_FWD.launches - n[1],
               mod.KERNEL_BWD.launches - n[2],
               mod.KERNEL_BWD_STORED.launches - n[3])
        assert got == ((1, 0, 1, 0) if fused else (0, 1, 0, 1))
        assert torch.isfinite(out.data).all() and torch.isfinite(dx).all()


@pytest.mark.parametrize("n,v", [(1, 3), (37, 1003), (5, 50257),
                                 (300, 4099)])
def test_softmax_xent_kernels_match_plain(cuda, n, v):
    """Both kernels against their twins on the same CUDA tensors (the
    gradient under g = 1 and under a random g, entry by entry), a rerun in
    the same bits, and the Function's launches."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    rng = np.random.default_rng(n + v)
    logits = (_rand(rng, n, v) * 3.0).to(cuda)
    targets = torch.from_numpy(rng.integers(0, v, size=n)).to(cuda)
    targets[0] = v - 1
    nll, lse = SX._fwd_kernel(logits, targets)
    again = SX._fwd_kernel(logits, targets)
    want_nll, want_lse = SX._fwd_plain(logits, targets)
    assert _close(nll, want_nll) and _close(lse, want_lse)
    assert torch.equal(nll, again[0]) and torch.equal(lse, again[1])
    for g in (torch.ones(n, device=cuda), _rand(rng, n).to(cuda)):
        d = SX._bwd_kernel(logits, targets, lse, g)
        assert _close_each(d, SX._bwd_plain(logits, targets, lse, g))
        assert torch.equal(d, SX._bwd_kernel(logits, targets, lse, g))
    before = SX.KERNEL_FWD.launches, SX.KERNEL_BWD.launches
    x = logits.clone().requires_grad_()
    (dx,) = torch.autograd.grad(SX.softmax_xent(x, targets).mean(), x)
    torch.cuda.synchronize()
    assert (SX.KERNEL_FWD.launches - before[0],
            SX.KERNEL_BWD.launches - before[1]) == (1, 1)
    y = logits.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        SX.softmax_xent_reference(y, targets).mean(), y)
    assert _close_each(dx, want)


def test_softmax_xent_out_of_range_targets_on_the_card(cuda):
    """Targets past either end of the vocabulary are read nowhere: NaN NLL
    and no onehot term, as the twins give."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    rng = np.random.default_rng(2)
    logits = _rand(rng, 4, 1003).to(cuda)
    targets = torch.tensor([3, 1003, -1, 1002], device=cuda)
    g = _rand(rng, 4).to(cuda)
    nll, lse = SX._fwd_kernel(logits, targets)
    want_nll, want_lse = SX._fwd_plain(logits, targets)
    torch.cuda.synchronize()
    assert torch.isnan(nll[1:3]).all() and torch.isfinite(nll[[0, 3]]).all()
    assert _close(nll[[0, 3]], want_nll[[0, 3]]) and _close(lse, want_lse)
    assert _close_each(SX._bwd_kernel(logits, targets, lse, g),
                       SX._bwd_plain(logits, targets, lse, g))


def test_softmax_xent_refuses_float64_on_the_card(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    with pytest.raises(EnforceError, match="float32"):
        SX.softmax_xent(torch.zeros(2, 5, dtype=torch.float64, device=cuda),
                        torch.zeros(2, dtype=torch.long, device=cuda))


# -- the bf16 forms of the LSTM, the BiLSTM and the gather (rows 5, 7, 17) --


def _bf16_counts():
    from paddle_tpu_torch.ops.kernels import lstm as LK

    return {k: v.launches for k, v in (
        ("fwd", LK.KERNEL_FWD), ("bwd", LK.KERNEL_BWD),
        ("bwd_stored", LK.KERNEL_BWD_STORED),
        ("fwd_bf16", LK.KERNEL_FWD_BF16), ("bwd_bf16", LK.KERNEL_BWD_BF16),
        ("bwd_stored_bf16", LK.KERNEL_BWD_STORED_BF16),
        ("bi", LK.KERNEL_BI), ("bi_bf16", LK.KERNEL_BI_BF16))}


@pytest.mark.parametrize("b,t,d,reverse", [
    (3, 7, 8, False), (70, 5, 40, True), (5, 33, 64, False),
    (2, 1, 136, True), (64, 16, 1280, False), (64, 128, 1280, True)])
def test_lstm_bf16_forms_against_their_forced_steps(cuda, b, t, d, reverse):
    """``lstm_fwd_bf16`` (with and without the gates slab) and
    ``lstm_bwd_bf16`` (remat and stored gates) on ragged bf16 inputs, a
    length-1 row among them, past one 64-row chunk and at the text
    classifier's D 1280: each step against the float64 step from the
    form's own carries (``chip_smoke.lstm_bf16_case``: hs one bf16 ulp plus
    the sum term, unequal on at most 1%; dgates per step 1e-3, dh0 and
    dpeep 1e-5 relative), reruns and the two backward forms in the same
    bits, and the planted faults (gate halves swapped, dgates unrounded in
    dh_{t-1}) outside the criterion."""
    import chip_smoke as S

    gen = torch.Generator(device=cuda).manual_seed(b * 131 + t)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=cuda)
    lens[0] = t
    lens[-1] = 1
    x = S.bf16_lstm_inputs(cuda, gen, b, t, d, lens)
    before = _bf16_counts()
    case = S.lstm_bf16_case(x, reverse)
    after = _bf16_counts()
    assert all(case["bits"].values()), case["bits"]
    assert case["fwd"]["ok"], case["fwd"]
    assert case["bwd"]["ok"], case["bwd"]
    assert not any(f["ok"] for f in case["faults"].values()), case["faults"]
    assert {k: after[k] - before[k] for k in after} == {
        "fwd": 0, "bwd": 0, "bwd_stored": 0, "fwd_bf16": 3, "bwd_bf16": 2,
        "bwd_stored_bf16": 1, "bi": 0, "bi_bf16": 0}


@pytest.mark.parametrize("b,t,e,d", [(3, 5, 16, 8), (17, 9, 40, 24),
                                     (64, 24, 256, 64)])
def test_bilstm_bf16_and_the_backward_over_its_projection(cuda, b, t, e, d):
    """``bilstm_fwd_bf16`` (both directions, ragged rows, past one 16-row
    tile) and ``lstm_bwd_bf16`` with remat over the f32 projection, as the
    BiLSTM's backward runs it (``chip_smoke.bilstm_bf16_case``), at odd
    shapes and the CRNN's: each direction against its forced float64
    steps, reruns in the same bits, the planted faults (the projection
    rounded to bf16, the gate halves swapped, dgates unrounded) outside."""
    import chip_smoke as S

    gen = torch.Generator(device=cuda).manual_seed(e + d)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=cuda)
    lens[0], lens[-1] = t, 1
    mask = (torch.arange(t, device=cuda)[None, :] < lens[:, None]).float()
    bf = torch.bfloat16

    def direction():
        return ((torch.randn(e, 4 * d, generator=gen, device=cuda)
                 / e ** 0.5).to(bf),
                0.1 * torch.randn(4 * d, generator=gen, device=cuda),
                (torch.randn(d, 4 * d, generator=gen, device=cuda)
                 / d ** 0.5).to(bf),
                (0.1 * torch.randn(3, d, generator=gen, device=cuda)).to(bf),
                (0.5 * torch.randn(b, d, generator=gen, device=cuda)).to(bf),
                0.5 * torch.randn(b, d, generator=gen, device=cuda))

    xs = torch.randn(b, t, e, generator=gen, device=cuda).to(bf)
    before = _bf16_counts()
    case = S.bilstm_bf16_case(xs, mask, direction(), direction(), gen)
    after = _bf16_counts()
    assert all(case["bits"].values()), case["bits"]
    assert case["ok"], {k: case[k] for k in ("bilstm", "bwd")}
    assert not any(f["ok"] for f in case["bilstm_faults"].values())
    assert not any(f["ok"] for f in case["bwd_faults"].values())
    assert {k: after[k] - before[k] for k in after} == {
        "fwd": 0, "bwd": 0, "bwd_stored": 0, "fwd_bf16": 0, "bwd_bf16": 4,
        "bwd_stored_bf16": 0, "bi": 0, "bi_bf16": 2}


def test_lstm_bf16_functions_on_card_match_the_cpu(cuda):
    """``lstm_seq`` through its autograd Function on bf16 operands, on the
    card (the bf16 forms only) and on the CPU (the twins): outputs and
    every input gradient in the JAX dtypes, each
    within 2x the CPU's relative distance from the float64 run plus 2^-8
    (a recurrence drifts by its bf16 rounding: the card's and the CPU's
    runs lie about as far from float64)."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    rng = np.random.default_rng(3)
    b, t, e, d = 6, 11, 32, 40
    bf = torch.bfloat16
    lens = torch.tensor([11, 1, 7, 11, 4, 9])
    mask = (torch.arange(t)[None, :] < lens[:, None]).float()

    def leaves(dev, wide):
        """The same draws each call: xw, W_h, peep, h0 rounded to bf16, c0
        f32; in float64 for the witness run."""
        state = rng.bit_generator.state
        vals = [rng.normal(size=s) * k for s, k in (
            ((b, t, 4 * d), 0.5), ((d, 4 * d), d ** -0.5), ((3, d), 0.3),
            ((b, d), 0.5), ((b, d), 0.5))]
        rng.bit_generator.state = state
        vals = [torch.from_numpy(v.astype(np.float32)) for v in vals]
        vals = [v.to(bf) for v in vals[:4]] + vals[4:]
        if wide:
            vals = [v.double() for v in vals]
        return [v.to(dev).requires_grad_() for v in vals]

    def run(dev, wide=False):
        xs = leaves(dev, wide)
        hs, (h_t, c_t) = LK.lstm_seq(xs[0], mask.to(dev), *xs[1:],
                                     remat=True)
        loss = hs.double().sum() + h_t.double().sum() + c_t.double().sum()
        return [hs, h_t, c_t, *torch.autograd.grad(loss, xs)]

    base = run("cpu", wide=True)
    cpu = run("cpu")
    before = _bf16_counts()
    card = run(cuda)
    assert _bf16_counts()["fwd_bf16"] - before["fwd_bf16"] == 1
    assert _bf16_counts()["bwd_bf16"] - before["bwd_bf16"] == 1
    for a, c, w in zip(card, cpu, base):
        assert a.dtype == c.dtype
        ref = w.detach().double()
        dist = float((c.detach().double() - ref).norm() / ref.norm())
        got = float((a.detach().cpu().double() - ref).norm() / ref.norm())
        assert got <= 2 * dist + 2.0 ** -8, (got, dist)


def test_lstm_bf16_wrappers_refuse_what_the_forms_do_not_take(cuda):
    """A bf16 D not a multiple of 8, a mixed f32 xw in the forward, a
    bf16 BiLSTM past D 64, and a bf16 GRU whose D is not a multiple of 8
    raise on the card; nothing falls back to f32."""
    import chip_smoke as S
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = S.bf16_lstm_inputs(cuda, gen, 2, 3, 12, torch.tensor([3, 2]))
    with pytest.raises(EnforceError, match="multiple of 8"):
        LK.lstm_seq(x["xw"], x["mask"], x["w_h"], x["peep"], x["h0"],
                    x["c0"])
    x = S.bf16_lstm_inputs(cuda, gen, 2, 3, 16, torch.tensor([3, 2]))
    with pytest.raises(EnforceError, match="xw must be"):
        LK._fwd_kernel(x["xw"].float(), x["mask"], x["w_h"], x["peep"],
                       x["h0"], x["c0"], False, False)
    bf = torch.bfloat16
    d = 72
    w = [torch.zeros(16, 4 * d, device=cuda, dtype=bf),
         torch.zeros(4 * d, device=cuda),
         torch.zeros(d, 4 * d, device=cuda, dtype=bf),
         torch.zeros(3, d, device=cuda, dtype=bf),
         torch.zeros(2, d, device=cuda, dtype=bf),
         torch.zeros(2, d, device=cuda)]
    with pytest.raises(EnforceError, match="D at most"):
        LK.bilstm_seq(torch.zeros(2, 3, 16, device=cuda, dtype=bf),
                      torch.ones(2, 3, device=cuda), *w[:4], *w[:4],
                      *w[4:], *w[4:])
    with pytest.raises(EnforceError, match="multiple of 8"):
        GK.gru_seq(torch.zeros(2, 3, 36, device=cuda, dtype=bf),
                   torch.ones(2, 3, device=cuda),
                   torch.zeros(12, 24, device=cuda, dtype=bf),
                   torch.zeros(12, 12, device=cuda, dtype=bf),
                   torch.zeros(2, 12, device=cuda, dtype=bf))


@pytest.mark.parametrize("n,v,d", [(1, 3, 8), (8192, 30000, 128),
                                   (1000, 64, 40)])
def test_embedding_gather_bf16_matches_its_twin(cuda, n, v, d):
    """``embedding_gather_bf16``: rows copied in bf16, bit for bit the
    twin's (ids clamped), one launch of the bf16 form and none of f32's;
    the fused lookup's table gradient of a bf16 table through the f32
    scatter-add, equal to its CPU twin's sum in f32 cast once."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    gen = torch.Generator(device=cuda).manual_seed(n)
    ids = torch.randint(-2, v + 2, (n,), generator=gen, device=cuda)
    table = torch.randn(v, d, generator=gen, device=cuda).to(torch.bfloat16)
    before = (EK.KERNEL_GATHER_BF16.launches, EK.KERNEL_GATHER.launches)
    got = EK.embedding_gather(table, ids)
    assert (EK.KERNEL_GATHER_BF16.launches - before[0],
            EK.KERNEL_GATHER.launches - before[1]) == (1, 0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, EK.embedding_gather_reference(table, ids))
    ok = ids.clamp(0, v - 1)
    leaf = table.clone().requires_grad_()
    out = EK.fused_embedding_lookup(leaf, ok)
    ct = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    before = EK.KERNEL_SCATTER.launches
    (g,) = torch.autograd.grad(out, leaf, ct)
    assert EK.KERNEL_SCATTER.launches - before == 1
    cpu_leaf = table.cpu().requires_grad_()
    (want,) = torch.autograd.grad(EK.fused_embedding_lookup(
        cpu_leaf, ok.cpu()), cpu_leaf, ct.cpu())
    assert g.dtype == want.dtype == torch.bfloat16
    # f32 sums of a run in another order: at most one bf16 ulp apart
    import chip_smoke as S
    assert int(S.bf16_ulps(g.cpu(), want).max()) <= 1


# -- the bf16 forms of the GRU and the BiGRU (rows 8 and 10) -----------------


def _gru_bf16_counts():
    import chip_smoke as S

    return {k: v.launches for k, v in S.gru_bf16_counters().items()
            if k.startswith(("gru", "bigru"))}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("b,t,d,reverse", [
    (3, 7, 8, False), (70, 5, 40, True), (5, 33, 64, False),
    (2, 1, 136, True), (9, 6, 1064, False), (64, 32, 512, False),
    (64, 32, 512, True)])
def test_gru_bf16_forms_against_their_forced_steps(cuda, b, t, d, reverse):
    """``gru_fwd_bf16`` (with and without the u/r/c slab) and
    ``gru_bwd_bf16`` (remat and stored gates, xw bf16) on ragged bf16
    inputs, a length-1 row among them, past one 64-row chunk, at U 1, 2, 4
    and 9 (D 1064: three n8 tiles of pairs, two of units) and at the NMT's
    [64, 32], D 512: each step against the float64 step from the form's
    own carries (``chip_smoke.gru_bf16_case``: hs and the slab one bf16 ulp
    plus the sum term, unequal on at most 1%; dxw per step 1e-3, dh0 1e-5;
    rh unequal on at most 1%, two ulps), reruns and the two backward forms
    in the same bits, and the planted faults (r h unrounded, the gate
    halves swapped, the backward's products unrounded, dW_hc's r
    unrounded) outside the criterion."""
    import chip_smoke as S

    gen = torch.Generator(device=cuda).manual_seed(b * 131 + t)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=cuda)
    lens[0] = t
    lens[-1] = 1
    x = S.bf16_gru_inputs(cuda, gen, b, t, d, lens)
    before = _gru_bf16_counts()
    case = S.gru_bf16_case(x, reverse)
    assert _delta(before, _gru_bf16_counts()) == {
        "gru_fwd_bf16": 3, "gru_bwd_remat_bf16": 2, "gru_bwd_stored_bf16": 1}
    assert all(case["bits"].values()), case["bits"]
    assert case["fwd"]["ok"], case["fwd"]
    assert case["bwd"]["ok"], case["bwd"]
    assert not any(f["ok"] for f in case["faults"].values()), case["faults"]


@pytest.mark.parametrize("b,t,e,d", [(3, 5, 16, 8), (17, 9, 40, 24),
                                     (64, 32, 512, 512)])
def test_bigru_bf16_and_the_backward_over_its_projection(cuda, b, t, e, d):
    """``bigru_fwd_bf16`` (both directions, ragged rows) and
    ``gru_bwd_bf16`` with remat over the f32 projection, as the BiGRU's
    backward runs it (``chip_smoke.bigru_bf16_case``), at odd shapes and
    the NMT encoder's x [64, 32, 512], D 512: each direction against its
    forced float64 steps, reruns in the same bits, the planted faults (the
    projection rounded to bf16, the gate halves swapped, r h unrounded;
    the backward's products unrounded, dW_hc's r unrounded) outside."""
    import chip_smoke as S

    gen = torch.Generator(device=cuda).manual_seed(e + d)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=cuda)
    lens[0], lens[-1] = t, 1
    mask = (torch.arange(t, device=cuda)[None, :] < lens[:, None]).float()
    bf = torch.bfloat16

    def direction():
        return ((torch.randn(e, 3 * d, generator=gen, device=cuda)
                 / e ** 0.5).to(bf),
                0.1 * torch.randn(3 * d, generator=gen, device=cuda),
                (torch.randn(d, 2 * d, generator=gen, device=cuda)
                 / d ** 0.5).to(bf),
                (torch.randn(d, d, generator=gen, device=cuda)
                 / d ** 0.5).to(bf),
                (0.5 * torch.randn(b, d, generator=gen, device=cuda)).to(bf))

    xs = torch.randn(b, t, e, generator=gen, device=cuda).to(bf)
    before = _gru_bf16_counts()
    case = S.bigru_bf16_case(xs, mask, direction(), direction(), gen)
    assert _delta(before, _gru_bf16_counts()) == {
        "bigru_fwd_bf16": 2, "gru_bwd_remat_bf16": 4}
    assert all(case["bits"].values()), case["bits"]
    assert case["ok"], {k: case[k] for k in ("bigru", "bwd")}
    assert not any(f["ok"] for f in case["bigru_faults"].values())
    assert not any(f["ok"] for f in case["bwd_faults"].values())


def test_gru_bf16_functions_on_card_match_the_cpu(cuda):
    """``gru_seq`` (remat on and off, both directions) and ``bigru_seq``
    through their autograd Functions on bf16 operands, on the card (the
    bf16 forms only) and on the CPU (the twins): outputs and every input
    gradient in the JAX dtypes, each within 2x the CPU's relative distance
    from the float64 run plus 2^-8 (a recurrence drifts by its bf16
    rounding: the card's and the CPU's runs lie about as far from
    float64)."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    rng = np.random.default_rng(4)
    b, t, e, d = 6, 11, 32, 40
    bf = torch.bfloat16
    lens = torch.tensor([11, 1, 7, 11, 4, 9])
    mask = (torch.arange(t)[None, :] < lens[:, None]).float()
    shapes = {"gru": [((b, t, 3 * d), 0.5), ((d, 2 * d), d ** -0.5),
                      ((d, d), d ** -0.5), ((b, d), 0.5)],
              "bigru": [((b, t, e), 1.0)] + 2 * [
                  ((e, 3 * d), e ** -0.5), ((3 * d,), 0.1),
                  ((d, 2 * d), d ** -0.5), ((d, d), d ** -0.5)]
              + 2 * [((b, d), 0.5)]}
    f32_at = {"gru": (), "bigru": (2, 6)}   # the biases stay f32

    def leaves(kind, dev, wide):
        """The same draws each call, rounded to bf16 (the biases f32); in
        float64 for the witness run."""
        state = rng.bit_generator.state
        vals = [torch.from_numpy((rng.normal(size=s) * k).astype(np.float32))
                for s, k in shapes[kind]]
        rng.bit_generator.state = state
        vals = [v if i in f32_at[kind] else v.to(bf)
                for i, v in enumerate(vals)]
        if wide:
            vals = [v.double() for v in vals]
        return [v.to(dev).requires_grad_() for v in vals]

    def run(kind, dev, wide=False, reverse=False, remat=True):
        xs = leaves(kind, dev, wide)
        if kind == "gru":
            outs = GK.gru_seq(xs[0], mask.to(dev), *xs[1:], reverse=reverse,
                              remat=remat)
        else:
            outs = GK.bigru_seq(xs[0], mask.to(dev), *xs[1:])
        loss = sum(o.double().sum() for o in outs)
        return [*outs, *torch.autograd.grad(loss, xs)]

    cases = [("gru", rev, remat) for rev in (False, True)
             for remat in (False, True)] + [("bigru", False, True)]
    for kind, reverse, remat in cases:
        base = run(kind, "cpu", True, reverse, remat)
        cpu = run(kind, "cpu", False, reverse, remat)
        before = _gru_bf16_counts()
        card = run(kind, cuda, False, reverse, remat)
        want = ({"bigru_fwd_bf16": 1, "gru_bwd_remat_bf16": 2}
                if kind == "bigru" else
                {"gru_fwd_bf16": 1,
                 "gru_bwd_remat_bf16" if remat else "gru_bwd_stored_bf16": 1})
        assert _delta(before, _gru_bf16_counts()) == want
        for a, c, w in zip(card, cpu, base):
            assert a.dtype == c.dtype
            ref = w.detach().double()
            dist = float((c.detach().double() - ref).norm() / ref.norm())
            got = float((a.detach().cpu().double() - ref).norm() / ref.norm())
            assert got <= 2 * dist + 2.0 ** -8, (kind, got, dist)


def test_gru_bf16_wrappers_refuse_what_the_forms_do_not_take(cuda):
    """On the card a bf16 GRU takes its bf16 form or raises: a mixed f32 xw
    in the forward, an f32 slab in the stored backward, a BiGRU with E not
    a multiple of 8 or a bf16 bias, and a D past the tiling all raise;
    nothing falls back to f32 or to the twin."""
    import chip_smoke as S
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import gru as GK

    gen = torch.Generator(device=cuda).manual_seed(1)
    x = S.bf16_gru_inputs(cuda, gen, 2, 3, 16, torch.tensor([3, 2]))
    args = (x["mask"], x["w_h"], x["w_hc"], x["h0"])
    before = _gru_bf16_counts()
    with pytest.raises(EnforceError, match="xw must be"):
        GK._fwd_kernel(x["xw"].float(), *args, False, False)
    hs = torch.zeros(2, 3, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(EnforceError, match="urc must be"):
        GK._bwd_kernel(None, x["xw"].float(), *args, hs, x["dhs"], x["dhT"],
                       False, False)
    bf = torch.bfloat16

    def bigru(e, d, bias_dtype=torch.float32):
        w = [torch.zeros(e, 3 * d, device=cuda, dtype=bf),
             torch.zeros(3 * d, device=cuda, dtype=bias_dtype),
             torch.zeros(d, 2 * d, device=cuda, dtype=bf),
             torch.zeros(d, d, device=cuda, dtype=bf)]
        h0 = torch.zeros(2, d, device=cuda, dtype=bf)
        return GK.bigru_seq(torch.zeros(2, 3, e, device=cuda, dtype=bf),
                            torch.ones(2, 3, device=cuda), *w, *w, h0, h0)

    with pytest.raises(EnforceError, match="multiples of 8"):
        bigru(12, 16)
    with pytest.raises(EnforceError, match="b must be"):
        bigru(16, 16, bf)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    with pytest.raises(EnforceError, match="units"):
        bigru(16, 16 * (sms // 2) + 8)
    assert _gru_bf16_counts() == before



# -- the last bf16 forms: the fused-input forwards (rows 6 and 9), softmax_xent
# (row 4) and the scatter-add (row 18) --------------------------------------


def _last_bf16_counts():
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    return {k: v.launches for k, v in (
        ("lstm_fi", LK.KERNEL_FI), ("lstm_fi_bf16", LK.KERNEL_FI_BF16),
        ("lstm_fwd_bf16", LK.KERNEL_FWD_BF16),
        ("lstm_bwd_bf16", LK.KERNEL_BWD_BF16),
        ("lstm_bwd_stored_bf16", LK.KERNEL_BWD_STORED_BF16),
        ("gru_fi", GK.KERNEL_FI), ("gru_fi_bf16", GK.KERNEL_FI_BF16),
        ("gru_fwd_bf16", GK.KERNEL_FWD_BF16),
        ("gru_bwd_bf16", GK.KERNEL_BWD_BF16),
        ("gru_bwd_stored_bf16", GK.KERNEL_BWD_STORED_BF16),
        ("xent_fwd", SX.KERNEL_FWD), ("xent_bwd", SX.KERNEL_BWD),
        ("xent_fwd_bf16", SX.KERNEL_FWD_BF16),
        ("xent_bwd_bf16", SX.KERNEL_BWD_BF16),
        ("scatter", EK.KERNEL_SCATTER),
        ("scatter_bf16", EK.KERNEL_SCATTER_BF16))}


def _moved(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("b,t,e,d,reverse", [
    (3, 7, 8, 8, False),         # the CPU tests' shapes
    (5, 9, 24, 40, True),        # E, D past one 16-deep step, ragged
    (70, 5, 16, 32, False),      # two 64-row chunks
    (2, 1, 16, 136, True),       # one step, D past one unit a block
    (64, 100, 128, 512, False),  # ops.rnn.lstm's width (RAW_RNN)
    (64, 32, 512, 512, True),    # ops.rnn.gru's width (RAW_RNN)
])
def test_fi_bf16_forms_against_their_forced_steps(cuda, kind, b, t, e, d,
                                                   reverse):
    """``lstm_fi_fwd_bf16`` / ``gru_fi_fwd_bf16`` (with and without the gate
    slab) on ragged bf16 inputs, a length-1 row among them, and the bf16
    remat backward over their f32 projection, as the path pairs them
    (``chip_smoke.fi_bf16_case``): each step against the float64 step from
    the form's own carries (hs one bf16 ulp plus the f32 sum term of E + D
    products, unequal on at most 1%), reruns and the slab form in the same
    bits, and the twin's planted faults (the projection rounded to bf16,
    the gate halves swapped, the GRU's r h unrounded; the backward's)
    outside the criterion.  The launches: three of the bf16 fused-input
    form, two of the bf16 backward, none of the f32 ones."""
    import chip_smoke as S

    x = S.fi_bf16_inputs(cuda, kind, b, t, e, d, seed=b + t + e + d)
    before = _last_bf16_counts()
    case = S.fi_bf16_case(kind, x, reverse)
    moved = _moved(before, _last_bf16_counts())
    assert all(case["bits"].values()), case["bits"]
    assert case["ok"], {k: case[k] for k in ("fwd", "bwd")}
    assert not any(f["ok"] for f in case["faults"].values()), case["faults"]
    assert moved == {f"{kind}_fi_bf16": 3, f"{kind}_bwd_bf16": 2}, moved


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_fi_bf16_functions_on_card_match_the_cpu(cuda, kind):
    """``lstm_seq_fi`` / ``gru_seq_fi`` through the autograd Function on
    bf16 operands, remat on, on the card (one bf16 fused-input forward and
    one bf16 backward) and on the CPU (the twins): every output and input
    gradient in the CPU's dtype, each within 2x the CPU's relative
    distance from the float64 run plus 2^-8."""
    import chip_smoke as S
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    mod = LK if kind == "lstm" else GK
    x = S.fi_bf16_inputs(torch.device("cpu"), kind, 6, 11, 32, 40, seed=3)
    keys = S.fi_args(kind, x)

    def run(dev, wide=False):
        leaves = [v.to(dev).requires_grad_() for v in keys]
        if wide:
            leaves = [v.detach().double().requires_grad_() for v in leaves]
        mask = leaves.pop(1).detach()
        fn = mod.lstm_seq_fi if kind == "lstm" else mod.gru_seq_fi
        out = fn(leaves[0], mask, *leaves[1:], remat=True)
        outs = (out[0], *out[1]) if kind == "lstm" else out
        loss = sum(o.double().sum() for o in outs)
        return [*outs, *torch.autograd.grad(loss, leaves)]

    base = run("cpu", wide=True)
    cpu = run("cpu")
    before = _last_bf16_counts()
    card = run(cuda)
    assert _moved(before, _last_bf16_counts()) == {
        f"{kind}_fi_bf16": 1, f"{kind}_bwd_bf16": 1}
    for a, c, w in zip(card, cpu, base):
        assert a.dtype == c.dtype
        ref = w.detach().double()
        dist = float((c.detach().double() - ref).norm() / ref.norm())
        got = float((a.detach().cpu().double() - ref).norm() / ref.norm())
        assert got <= 2 * dist + 2.0 ** -8, (got, dist)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_raw_rnn_bf16_entries_take_the_bf16_fi_forms(cuda, kind):
    """``ops.rnn.lstm`` / ``gru`` on bf16 x and weights on the card take the
    bf16 fused-input forward and the bf16 remat backward, once each, and
    no f32 fused-input or sequence forward; with the routing off, the
    unfused bf16 route (the bf16 sequence forward, then the backward in
    its stored-gates form: the slab fits)."""
    import chip_smoke as S
    from paddle_tpu_torch.ops import rnn as R

    bf = torch.bfloat16
    x, lens, w, init, cts = S.raw_rnn_inputs(cuda, kind, 5, 9, 24, 40)
    x, w = x.to(bf), {k: v.to(bf) for k, v in w.items()}
    init, cts = [v.to(bf) for v in init], [c.to(bf) for c in cts]
    before = _last_bf16_counts()
    S.raw_rnn_grads(S.raw_rnn_call, kind, x, lens, w, init, cts, False)
    assert _moved(before, _last_bf16_counts()) == {
        f"{kind}_fi_bf16": 1, f"{kind}_bwd_bf16": 1}
    on = R.fused_input_on
    R.fused_input_on = lambda device: False
    try:
        before = _last_bf16_counts()
        S.raw_rnn_grads(S.raw_rnn_call, kind, x, lens, w, init, cts, False)
    finally:
        R.fused_input_on = on
    assert _moved(before, _last_bf16_counts()) == {
        f"{kind}_fwd_bf16": 1, f"{kind}_bwd_stored_bf16": 1}


@pytest.mark.parametrize("n,v,offset", [
    (1, 3, 0), (37, 1003, 0), (37, 1003, 1),   # an odd V, rows 2-byte
    (64, 50257, 0), (64, 50257, 3)])           # the LM's vocabulary
def test_softmax_xent_bf16_matches_its_twin(cuda, n, v, offset):
    """The bf16 forms of row 4 (``chip_smoke.xent_bf16_agreement``): lse
    and the NLL f32 within 1e-5 x max(1, |ref|), dlogits bf16 unequal on
    at most 1% of the entries and within one ulp, reruns in the same
    bits; at odd V (rows start 2-byte aligned: a scalar head, 16-byte
    groups, a scalar tail) and with the logits offset from 16 bytes (the
    gradient then stored element by element).  A gradient rounded twice
    (softmax rounded to bf16 before the product) is outside the
    criterion."""
    import chip_smoke as S
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    gen = torch.Generator(device=cuda).manual_seed(n + v)
    flat = torch.empty(n * v + offset, device=cuda, dtype=torch.bfloat16)
    logits = flat[offset:].view(n, v)
    logits.copy_(2.0 * torch.randn(n, v, generator=gen, device=cuda))
    targets = torch.randint(0, v, (n,), generator=gen, device=cuda)
    targets[0] = v - 1
    g = torch.randn(n, generator=gen, device=cuda)
    before = _last_bf16_counts()
    a = S.xent_bf16_agreement(logits, targets, g)
    assert _moved(before, _last_bf16_counts()) == {"xent_fwd_bf16": 2,
                                                   "xent_bwd_bf16": 2}
    assert a["ok"], a
    if n * v >= 1000:
        _, lse = SX._fwd_kernel(logits, targets)
        got = SX._bwd_kernel(logits, targets, lse, g)
        p = torch.exp(logits.float() - lse[:, None])
        onehot = torch.zeros_like(p).scatter_(1, targets[:, None], 1.0)
        twice = ((p.to(torch.bfloat16).float() - onehot) * g[:, None]).to(
            torch.bfloat16)
        assert not S.bf16_exact_agreement(twice, got)["ok"]


def test_softmax_xent_bf16_through_the_function(cuda):
    """``softmax_xent`` on bf16 logits through the autograd Function: an f32
    NLL, a bf16 gradient, one launch of each bf16 form and none of the f32
    ones; a float16 logit refused."""
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(9, 501, generator=gen, device=cuda).to(
        torch.bfloat16).requires_grad_()
    targets = torch.randint(0, 501, (9,), generator=gen, device=cuda)
    before = _last_bf16_counts()
    nll = SX.softmax_xent(x, targets)
    (dx,) = torch.autograd.grad(nll.mean(), x)
    assert (nll.dtype, dx.dtype) == (torch.float32, torch.bfloat16)
    assert _moved(before, _last_bf16_counts()) == {"xent_fwd_bf16": 1,
                                                   "xent_bwd_bf16": 1}
    with pytest.raises(EnforceError, match="float32 or bfloat16"):
        SX.softmax_xent(x.detach().half(), targets)


@pytest.mark.parametrize("n,v,d", [(1, 3, 8), (1000, 64, 40),
                                   (8192, 30000, 128)])
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_bf16_matches_its_twin(cuda, n, v, d, rows_dtype):
    """The bf16 scatter-add (``chip_smoke.scatter_bf16_agreement``) on a
    bf16 table with f32 or bf16 rows, duplicate ids and ids outside [0,
    V) (dropped): unequal to the twin on at most 1% of the entries, each
    within one ulp, a rerun in the same bits, two launches of the bf16
    form and none of the f32 one.  With f32 rows, rows rounded to the
    table's dtype before the sum are outside the criterion."""
    import chip_smoke as S
    from paddle_tpu_torch.ops.kernels import embedding as EK

    gen = torch.Generator(device=cuda).manual_seed(n + v + d)
    table = torch.randn(v, d, generator=gen, device=cuda).to(torch.bfloat16)
    ids = torch.randint(-2, v + 2, (n,), generator=gen, device=cuda)
    rows = torch.randn(n, d, generator=gen, device=cuda).to(rows_dtype)
    before = _last_bf16_counts()
    a = S.scatter_bf16_agreement(table, ids, rows)
    assert _moved(before, _last_bf16_counts()) == {"scatter_bf16": 2}
    assert a["ok"], a
    if rows_dtype == torch.float32 and n > 1:
        got = EK.embedding_scatter_add(table, ids, rows)
        bad = EK.embedding_scatter_add_reference(table, ids,
                                                 rows.to(torch.bfloat16))
        assert not S.bf16_exact_agreement(bad, got)["ok"]
    from paddle_tpu_torch.core.enforce import EnforceError

    with pytest.raises(EnforceError, match="float32 or bfloat16 rows"):
        EK.embedding_scatter_add(table, ids, rows.half())



# -- the Hopper bf16 flash forward (row 2 bf16 at head_dim 64 and 128) ---------
#
# The bf16 Function's forward reads q, k, v where they lie: head_dim 64
# and 128 launch ``KERNEL_WGMMA`` (wgmma fed by TMA), 16 and 32 the
# mma.sync form on the padded problem.  o against the twin by
# ``bf16_agrees`` with ``FLASH_BF16_FLIP`` (as the forms above), lse within
# TOL on every padded row, a rerun in the same bits.

WGMMA_SHAPES = [
    (16, 1024, 1024, 12, 64, True),   # LM training
    (8, 512, 512, 12, 64, True),      # serving prefill
    (2, 100, 100, 3, 64, True),
    (1, 333, 333, 2, 64, False),
    (2, 130, 130, 2, 128, True),
    (1, 129, 129, 2, 128, False),
    (2, 64, 64, 2, 16, True),         # mma.sync: head_dim 16
    (1, 70, 70, 2, 32, False),        # mma.sync: head_dim 32
    (1, 40, 90, 2, 64, True),         # t_q < t_k: absolute-position mask
    (1, 90, 40, 2, 128, True),        # t_q > t_k
]


@pytest.mark.parametrize("b,t_q,t_k,h,d,causal", WGMMA_SHAPES)
def test_flash_bf16_forward_takes_its_form_by_head_dim(cuda, b, t_q, t_k, h,
                                                       d, causal):
    import chip_smoke as S

    rng = np.random.default_rng(t_q * 7 + t_k + d)
    q, k, v = (_bf16(rng, b, t, h, d).to(cuda) for t in (t_q, t_k, t_k))
    hopper = d in FA.WGMMA_HEAD_DIMS
    before = FA.KERNEL_WGMMA.launches, FA.KERNEL_BF16.launches
    with torch.no_grad():
        o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        again = FA.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (FA.KERNEL_WGMMA.launches - before[0],
            FA.KERNEL_BF16.launches - before[1]) == ((2, 0) if hopper
                                                      else (0, 2))
    assert o.shape == (b, t_q, h, d) and o.is_contiguous() == hopper
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    if hopper:
        lse = FA._fwd_bthd(q, k, v, causal, d ** -0.5)[1]
    else:
        qp, kp, vp = FA._prep(q, k, v)
        lse = FA._fwd_kernel(qp, kp, vp, t_k, causal, d ** -0.5)[1]
    a = S.flash_forward_agreement(q, k, v, o, lse, causal, d ** -0.5)
    assert a["agrees"], a


def test_flash_wgmma_reads_strided_views_as_they_lie(cuda):
    """q, k, v sliced from one [B, T, 3, H, D] projection (strides 3HD,
    D) give the bits their contiguous copies give, with no copy; a view
    TMA cannot read (a t stride off 16 bytes, a base off 16 bytes)
    raises."""
    from paddle_tpu_torch.core.enforce import EnforceError

    rng = np.random.default_rng(5)
    b, t, h, d = 2, 300, 4, 64
    qkv = _bf16(rng, b, t, 3, h, d).to(cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    before = FA.KERNEL_WGMMA.launches
    with torch.no_grad():
        o = FA.flash_attention(q, k, v, causal=True)
        want = FA.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert FA.KERNEL_WGMMA.launches - before == 2
    assert torch.equal(o, want)
    wide = _bf16(rng, b, t, h, d + 4).to(cuda)[..., :d]   # t stride 4(D+4)
    with pytest.raises(EnforceError, match="multiples of 16 bytes"):
        FA.flash_attention(wide, wide, wide, causal=True)
    flat = torch.zeros(b * t * h * d + 1, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view(b, t, h, d)
    with pytest.raises(EnforceError, match="16-byte aligned"):
        FA.flash_attention(odd, odd, odd, causal=True)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_wgmma_backward_matches_the_padded_route(cuda, d):
    """Under autograd the bf16 backward takes its forward's route.  At
    head_dim 64 and 128 the Hopper backward reads what the Hopper forward
    saved as it lies: the gradients are ``_bwd_bthd``'s on the same o and
    lse bit for bit, agree with the twins on the padded problem by
    ``bf16_agrees``, and launch each Hopper backward form once and no
    mma.sync backward.  At 16 and 32 the padded route serves: the
    gradients are the mma.sync kernels' on the padded problem fed the
    same o and lse, bit for bit."""
    import chip_smoke as S

    rng = np.random.default_rng(9 + d)
    b, t, h = 2, 200, 3
    q, k, v, g = (_bf16(rng, b, t, h, d).to(cuda) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = S.flash_counters()
    before = {n: c.launches for n, c in counts.items()}
    o = FA.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(o, leaves, g)
    torch.cuda.synchronize()
    launched = {n: c.launches - before[n] for n, c in counts.items()
                if c.launches != before[n]}
    scale = d ** -0.5
    qp, kp, vp = FA._prep(q, k, v)
    dop = FA._prep(g, g, g)[0]
    if d in FA.WGMMA_HEAD_DIMS:
        assert launched == {"fwd_wgmma": 1, "dq_wgmma": 1, "dkv_wgmma": 1}
        o2, lse = FA._fwd_bthd(q, k, v, True, scale)
        assert torch.equal(o.detach(), o2)
        want = FA._bwd_bthd(q, k, v, o2, lse, g, True, scale)
        for x, w in zip(got, want):
            assert torch.equal(x, w)
        twins, mags = S.flash_wgmma_bwd_want(q, k, v, o2, lse, g, True,
                                             scale)
        for x, n in zip(got, ("dq", "dk", "dv")):
            assert S.bf16_agrees(x, twins[n], mags[n],
                                 coef=S.FLASH_BF16_FLIP), n
        return
    assert launched == {"fwd_bf16": 1, "dq_bf16": 1, "dkv_bf16": 1}
    o2, lse = FA._fwd_kernel(qp, kp, vp, t, True, scale)
    assert torch.equal(o.detach(), FA._from_bh(o2, b, h, t, d))
    dq, dk, dv = FA._bwd_kernel(qp, kp, vp, o2, lse, dop, t, True, scale)
    for x, w in zip(got, (dq, dk, dv)):
        assert torch.equal(x, FA._from_bh(w, b, h, t, d))


def test_flash_wgmma_backward_reads_views_as_they_lie(cuda):
    """q, k, v sliced from one [B, T, 3, H, D] projection and dO sliced
    from a wider tensor (strides TMA takes) give the gradients their
    contiguous copies give, bit for bit; an expanded upstream gradient
    (strides 0, which TMA cannot read) is copied once and gives what its
    contiguous copy gives."""
    rng = np.random.default_rng(6)
    b, t, h, d = 2, 300, 4, 64
    qkv = _bf16(rng, b, t, 3, h, d).to(cuda)
    g_wide = _bf16(rng, b, t, h, d + 8).to(cuda)
    g = g_wide[..., :d]
    assert FA._bthd_ok(g) and not g.is_contiguous()

    def grads(q, k, v, g):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(FA.flash_attention(*leaves, causal=True),
                                   leaves, g)

    q, k, v = qkv.unbind(2)
    got = grads(q, k, v, g)
    want = grads(q.contiguous(), k.contiguous(), v.contiguous(),
                 g.contiguous())
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    ones = torch.ones((), dtype=torch.bfloat16, device=cuda).expand(b, t, h, d)
    assert not FA._bthd_ok(ones)
    got = grads(q, k, v, ones)
    want = grads(q, k, v, ones.contiguous())
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_flash_wgmma_backward_refuses_what_it_does_not_take(cuda):
    """The Hopper backward's wrappers refuse an f32 operand among bf16
    ones (f32 operands all of one dtype take the f32 in-place form), a
    head_dim outside WGMMA_HEAD_DIMS, lse or delta rows of another shape
    or dtype, and an operand whose strides TMA cannot read; nothing is
    launched."""
    from paddle_tpu_torch.core.enforce import EnforceError

    b, t, h, d = 1, 100, 2, 64
    x = torch.zeros(b, t, h, d, dtype=torch.bfloat16, device=cuda)
    rows = torch.zeros(b * h, 128, device=cuda)
    n = FA.KERNEL_BWD_DQ_WGMMA.launches, FA.KERNEL_BWD_DKV_WGMMA.launches
    with pytest.raises(EnforceError, match="one dtype"):
        FA._bwd_dq_bthd(x.float(), x, x, rows, x, rows, True, 0.125)
    y = torch.zeros(b, t, h, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(EnforceError, match="head_dim"):
        FA._bwd_dkv_bthd(y, y, y, rows, y, rows, True, 0.125)
    with pytest.raises(EnforceError, match="lse"):
        FA._bwd_dq_bthd(x, x, x, rows[:, :64], x, rows, True, 0.125)
    with pytest.raises(EnforceError, match="delta"):
        FA._bwd_dkv_bthd(x, x, x, rows, x, rows.double(), True, 0.125)
    wide = torch.zeros(b, t, h, d + 4, dtype=torch.bfloat16,
                       device=cuda)[..., :d]
    with pytest.raises(EnforceError, match="multiples of 16 bytes"):
        FA._bwd_dq_bthd(x, wide, x, rows, x, rows, True, 0.125)
    assert (FA.KERNEL_BWD_DQ_WGMMA.launches,
            FA.KERNEL_BWD_DKV_WGMMA.launches) == n


def test_flash_f32_backward_stays_near_float64(cuda):
    """The f32 backward (3xTF32 on the tensor cores) through the Function
    against float64 autograd of exact attention: relative norm within
    ``chip_smoke.FLASH_BWD_F64_LIMIT`` and within 2x the FMA form's
    distance (``FLASH_BWD_F64_FMA``), at a ragged T and head_dim 128."""
    import chip_smoke as S

    rng = np.random.default_rng(31)
    for b, t, h, d in ((2, 333, 3, 64), (1, 256, 2, 128)):
        q, k, v, g = (_rand(rng, b, t, h, d).to(cuda) for _ in range(4))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(FA.flash_attention(*leaves, causal=True),
                                  leaves, g)
        wide = [x.double().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(
            FA.flash_attention_reference(*wide, causal=True), wide,
            g.double())
        worst = max(S.rel_norm(x, y) for x, y in zip(got, want))
        assert worst <= min(S.FLASH_BWD_F64_LIMIT,
                            S.FLASH_BWD_F64_SLACK * S.FLASH_BWD_F64_FMA), (
            b, t, h, d, worst)


# -- the gather (row 17) and the lookup forward in one launch -----------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v,d,offset", [
    (8192, 30000, 128, 0),   # 16-byte units: f32 a row a warp, bf16 two
    (37, 50, 8, 0),          # short rows: four (f32) or eight a warp
    (300, 97, 33, 0),        # D not whole 16-byte units: the element path
    (300, 97, 64, 1),        # a table off 16 bytes: the element path
])
@pytest.mark.parametrize("padding_idx", [None, 5])
def test_gather_forms_copy_the_twin_bit_for_bit(cuda, dtype, n, v, d,
                                                 offset, padding_idx):
    from paddle_tpu_torch.ops.kernels import embedding as EK

    rng = np.random.default_rng(n + d + offset)
    flat = _rand(rng, v * d + offset).to(cuda).to(dtype)
    table = flat[offset:].view(v, d)
    ids = _ids(rng, n, v)
    ids[20:23] = 5
    ids = ids.to(cuda)
    forms = (EK.KERNEL_GATHER, EK.KERNEL_GATHER_BF16)
    before = [k.launches for k in forms]
    got = EK.embedding_gather(table, ids, padding_idx)
    torch.cuda.synchronize()
    moved = [k.launches - b for k, b in zip(forms, before)]
    assert moved == ([1, 0] if dtype == torch.float32 else [0, 1])
    want = EK.embedding_gather_reference(table, ids, padding_idx)
    assert got.dtype == dtype and torch.equal(got, want)
    if padding_idx is not None:
        assert not got[ids == padding_idx].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_lookup_forward_is_one_gather_launch(cuda, dtype, monkeypatch):
    """The lookup forward on the card: one gather launch of the table's
    dtype, nothing else launched, no ``dedup_ids`` and no host sync; the
    output the CPU Function's bit for bit (padding rows zero); the table
    gradient one scatter-add, equal to ``table_grad`` of the masked
    cotangent bit for bit."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    def no_dedup(*a, **k):
        raise AssertionError("the lookup forward called dedup_ids")

    monkeypatch.setattr(EK, "dedup_ids", no_dedup)
    rng = np.random.default_rng(21)
    v, d = 30000, 128
    table = _rand(rng, v, d).to(dtype)
    ids = torch.from_numpy(rng.integers(0, v, size=(64, 128)))
    ids[:, 100:] = 0                      # the text batch's padding id
    ct = _rand(rng, 64, 128, d).to(dtype)
    kernels = (EK.KERNEL_GATHER, EK.KERNEL_GATHER_BF16, EK.KERNEL_SCATTER,
               EK.KERNEL_SCATTER_BF16, EK.KERNEL_GROUP)
    leaf = table.to(cuda).requires_grad_()
    on_card = ids.to(cuda)
    before = [k.launches for k in kernels]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = EK.fused_embedding_lookup(leaf, on_card, padding_idx=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moved = [k.launches - b for k, b in zip(kernels, before)]
    assert moved == ([1, 0, 0, 0, 0] if dtype == torch.float32
                     else [0, 1, 0, 0, 0])
    cpu = EK.fused_embedding_lookup(table, ids, padding_idx=0)
    assert torch.equal(out.cpu(), cpu)
    assert not out[:, 100:].any()
    (g,) = torch.autograd.grad(out, leaf, ct.to(cuda))
    flat = ids.reshape(-1).to(cuda)
    ctf = ct.to(cuda).float().reshape(-1, d).clone()
    ctf[flat == 0] = 0
    assert torch.equal(g, EK.table_grad(flat, ctf, v).to(dtype))


# -- C8: every launch on the card its tensors lie on ---------------------------


def test_wrappers_launch_on_the_tensors_card_not_the_current_one(cuda):
    """With card 0 current, each entry given tensors on card 1 runs there
    and gives the bits it gives with card 1 current (the parent launched
    some of them on the current card's stream and device).  Skips on one
    card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from paddle_tpu_torch.ops.kernels import channel_stats as CS
    from paddle_tpu_torch.ops.kernels import ctc as KC
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    other = torch.device("cuda", 1)
    rng = np.random.default_rng(8)
    table, ids = _rand(rng, 500, 64), _ids(rng, 300, 500)
    rows = _rand(rng, 300, 64)
    q = _bf16(rng, 2, 130, 2, 64)
    logits, targets = _rand(rng, 37, 1003), torch.from_numpy(
        rng.integers(0, 1003, size=37))
    lp = torch.log_softmax(_rand(rng, 4, 24, 27), -1)
    ilen = torch.full((4,), 24, dtype=torch.int64)
    x = _rand(rng, 2048, 512)
    calls = {
        "gather": lambda t: EK.embedding_gather(t[0], t[1], 5),
        "table_grad": lambda t: EK.table_grad(t[1], t[2], 500),
        "flash_wgmma": lambda t: FA.flash_attention_fwd(t[3], t[3], t[3],
                                                       causal=True)[0],
        "flash_f32": lambda t: FA.flash_attention_fwd(
            t[3].float(), t[3].float(), t[3].float(), causal=True)[0],
        "xent": lambda t: SX.softmax_xent(t[4], t[5]),
        "ctc_decode": lambda t: KC.ctc_greedy_decode_fused(t[6], t[7], 26),
        "channel_stats": lambda t: torch.stack(CS.channel_stats(t[8])),
    }
    args = [table, ids, rows, q, logits, targets, lp, ilen, x]
    on_other = [a.to(other) for a in args]
    for name, call in calls.items():
        with torch.cuda.device(other):
            want = call(on_other)
        torch.cuda.synchronize(other)
        with torch.cuda.device(0):
            got = call(on_other)
        torch.cuda.synchronize(other)
        for a, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert a.device == other and torch.equal(a, w), name


# -- row 2 f32 in place (3xTF32) and row 1 f32 split over the sequence ---------


F32_BTHD_SHAPES = [
    # b, t_q, t_k, h, d, causal
    (2, 64, 64, 2, 16, True),
    (1, 130, 90, 2, 32, True),     # t_q > t_k, ragged
    (2, 40, 200, 3, 64, True),     # t_q < t_k
    (1, 333, 333, 2, 64, False),
    (1, 129, 129, 2, 128, True),
    (1, 100, 150, 2, 128, False),
]


@pytest.mark.parametrize("b,t_q,t_k,h,d,causal", F32_BTHD_SHAPES)
def test_flash_f32_in_place_forward_matches_the_twin(cuda, b, t_q, t_k, h,
                                                     d, causal):
    """The 3xTF32 forward on [B, T, H, D] as it lies, at every head dim of
    HEAD_DIMS: o and the whole lse (the padded rows' too, finite) within
    TOL of the twin on the padded problem; one launch of ``KERNEL``; a
    rerun in the same bits."""
    rng = np.random.default_rng(t_q * 3 + t_k + d)
    q, k, v = (_rand(rng, b, t, h, d).to(cuda) for t in (t_q, t_k, t_k))
    scale = d ** -0.5
    before = FA.KERNEL.launches
    o, lse = FA._fwd_bthd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert FA.KERNEL.launches == before + 1
    assert o.shape == (b, t_q, h, d) and o.is_contiguous()
    qp, kp, vp = FA._prep(q, k, v)
    o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t_k, causal, scale)
    assert torch.isfinite(lse).all()
    assert (o - FA._from_bh(o_ref, b, h, t_q, d)).abs().max().item() <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL
    again = FA._fwd_bthd(q, k, v, causal, scale)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def test_flash_f32_reads_views_and_refuses_what_it_cannot(cuda):
    """q, k, v sliced from one [B, T, 3, H, D] projection give the bits
    their contiguous copies give, with no copy; a view off the 16-byte
    rule (a t stride off 16 bytes, a base off 16 bytes) raises."""
    from paddle_tpu_torch.core.enforce import EnforceError

    rng = np.random.default_rng(15)
    b, t, h, d = 2, 300, 4, 64
    qkv = _rand(rng, b, t, 3, h, d).to(cuda)
    q, k, v = qkv.unbind(2)
    with torch.no_grad():
        o = FA.flash_attention(q, k, v, causal=True)
        want = FA.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True)
    assert torch.equal(o, want)
    wide = _rand(rng, b, t, h, d + 2).to(cuda)[..., :d]   # h stride D + 2
    with pytest.raises(EnforceError, match="multiples of 16 bytes"):
        FA.flash_attention(wide, wide, wide, causal=True)
    flat = torch.zeros(b * t * h * d + 1, device=cuda)
    odd = flat[1:].view(b, t, h, d)
    with pytest.raises(EnforceError, match="16-byte aligned"):
        FA.flash_attention(odd, odd, odd, causal=True)


@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_f32_route_makes_no_padded_copy(cuda, d, monkeypatch):
    """The f32 autograd route, forward and backward, calls neither
    ``_prep`` nor ``_to_bh`` (patched to raise): nothing is padded or
    transposed; dq, dk, dv come back contiguous [B, T, H, D], within TOL
    of the twins (scaled by their largest entry where above 1), with one
    launch of each f32 form."""
    rng = np.random.default_rng(40 + d)
    b, t_q, t_k, h = 2, 150, 200, 3
    q, k, v = (_rand(rng, b, t, h, d).to(cuda) for t in (t_q, t_k, t_k))
    g = _rand(rng, b, t_q, h, d).to(cuda)
    scale = d ** -0.5
    qp, kp, vp = FA._prep(q, k, v)
    op, lse_p = FA._fwd_plain(qp, kp, vp, t_k, True, scale)
    want = FA._bwd_plain(qp, kp, vp, op, lse_p, FA._to_bh(g), t_k, True,
                         scale)

    def refuse(*a, **k):
        raise AssertionError("the f32 route padded or transposed")

    monkeypatch.setattr(FA, "_prep", refuse)
    monkeypatch.setattr(FA, "_to_bh", refuse)
    counts = [x.launches for x in FA.FORMS[torch.float32]]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(FA.flash_attention(*leaves, causal=True),
                              leaves, g)
    torch.cuda.synchronize()
    assert [x.launches - n for x, n in zip(FA.FORMS[torch.float32],
                                           counts)] == [1, 1, 1]
    for x, w, t in zip(got, want, (t_q, t_k, t_k)):
        w = FA._from_bh(w, b, h, t, d)
        assert x.shape == (b, t, h, d) and x.is_contiguous()
        assert ((x - w).abs().max().item()
                <= TOL * max(1.0, w.abs().max().item()))


PAGED_F32_CASES = [(d, ps) for d in (16, 60, 64, 128) for ps in (4, 16, 64)]


@pytest.mark.parametrize("d,ps", PAGED_F32_CASES)
def test_paged_f32_split_kernel_matches_its_twin(cuda, d, ps):
    """The split paged kernel at page sizes 4/16/64 and head_dim 16/60/64/
    128 (60: the 4-byte units), lengths 0, 1, 16, 17 and full, one row's
    table entries past the pool (read as page 0): within TOL of the twin
    (the twin fed the same ids mapped to 0), idle rows exact zeros, one
    launch a call, a rerun in the same bits."""
    rng = np.random.default_rng(d * 7 + ps)
    maxp = -(-300 // ps)
    lens = [0, 1, 16, 17, maxp * ps, 0, 100, maxp * ps]
    q, kp, vp, table, seq = _paged(rng, lens, 3, d, ps, maxp, cuda)
    table[6, -1] = kp.shape[1] + 5       # out of range, past seq_len 100
    table[7, 2] = kp.shape[1] + 7        # out of range, read: page 0
    before = PA.KERNEL.launches
    out = PA.ragged_paged_attention(q, kp, vp, table, seq)
    again = PA.ragged_paged_attention(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    assert PA.KERNEL.launches == before + 2
    mapped = torch.where(table < kp.shape[1], table, 0)
    ref = PA.ragged_paged_attention_reference(q, kp, vp, mapped, seq)
    assert (out - ref).abs().max().item() <= TOL
    idle = seq == 0
    assert torch.equal(out[idle], torch.zeros_like(out[idle]))
    assert torch.equal(out, again)


PAGED_BF16_CASES = [(d, ps) for d in (16, 32, 64, 128) for ps in (4, 16, 64)]


@pytest.mark.parametrize("d,ps", PAGED_BF16_CASES)
def test_paged_bf16_split_kernel_matches_its_twin(cuda, d, ps):
    """The bf16 form split over chunks (two launches a call) at page sizes
    4/16/64 and head_dim 16/32/64/128, lengths 0, 1, 16, 17, 100 and rows
    over two and three chunks (the table's width), the last row's first
    token the largest score of its row (every later page rounds p against
    it), one row's table entries past the pool (read as page 0):
    ``paged_bf16_agreement`` against the twin fed the same ids mapped to
    0 (a rerun in the same bits, idle rows exact zeros), one count a call
    on the bf16 form and none on the f32 one."""
    import chip_smoke as S

    rng = np.random.default_rng(d * 11 + ps)
    maxp = -(-600 // ps)
    lens = [0, 1, 16, 17, maxp * ps, 0, 100, 300, maxp * ps]
    q, kp, vp, table, seq = _paged(rng, lens, 3, d, ps, maxp, cuda)
    row = len(lens) - 1
    for hh in range(3):
        qv = q[row, hh]
        kp[hh, table[row, 0], 0] = qv * (6.0 / (d ** -0.5 * qv @ qv))
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    table[6, -1] = kp.shape[1] + 5       # out of range, past seq_len 100
    table[7, 2] = kp.shape[1] + 7        # out of range, read: page 0
    mapped = torch.where(table < kp.shape[1], table, 0)
    before = PA.KERNEL.launches, PA.KERNEL_BF16.launches
    a = S.paged_bf16_agreement(q, kp, vp, mapped, seq)
    assert (PA.KERNEL.launches, PA.KERNEL_BF16.launches) == (
        before[0], before[1] + 2)
    assert a["agrees"], a
    out = PA.ragged_paged_attention(q, kp, vp, table, seq)
    want = PA.ragged_paged_attention_reference(q, kp, vp, mapped, seq)
    mag = PA.ragged_paged_attention_reference(
        q.float(), kp.float(), vp.float().abs(), mapped, seq)
    assert S.bf16_agrees(out, want, mag, coef=S.FLASH_BF16_FLIP), \
        S.bf16_agreement(out, want, mag, coef=S.FLASH_BF16_FLIP)


def test_paged_bf16_on_two_streams_back_to_back(cuda):
    """The bf16 form on two streams, back to back, each with its own kept
    workspace and tickets: each output equals the call on the default
    stream in bits."""
    rng = np.random.default_rng(23)
    ins = []
    for _ in range(2):
        q, kp, vp, table, seq = _paged(rng, [0, 300, 77, 576], 4, 64, 16,
                                       36, cuda)
        ins.append((*(x.to(torch.bfloat16) for x in (q, kp, vp)), table,
                    seq))
    want = [PA.ragged_paged_attention(*x) for x in ins]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for s, x in zip(streams, ins):
        with torch.cuda.stream(s):
            got.append(PA.ragged_paged_attention(*x))
    torch.cuda.synchronize()
    for x, w in zip(got, want):
        assert torch.equal(x.view(torch.int16), w.view(torch.int16))


def test_paged_bf16_makes_no_host_sync(cuda):
    """The bf16 wrapper keeps the lengths on the card too: a call (after
    the kept workspace exists) runs under ``set_sync_debug_mode("error")``
    and repeats the first call's bits."""
    rng = np.random.default_rng(24)
    q, kp, vp, table, seq = _paged(rng, [5, 300, 0, 576], 4, 64, 16, 36,
                                   cuda)
    x = (*(t.to(torch.bfloat16) for t in (q, kp, vp)), table, seq)
    want = PA.ragged_paged_attention(*x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = PA.ragged_paged_attention(*x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_paged_f32_on_two_streams_back_to_back(cuda):
    """Two launches on two streams, back to back, each with its own kept
    partials and tickets: each output equals the one call on the default
    stream gives."""
    rng = np.random.default_rng(21)
    ins = [_paged(rng, [0, 300, 77, 576], 4, 64, 16, 36, cuda)
           for _ in range(2)]
    want = [PA.ragged_paged_attention(*x) for x in ins]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for s, x in zip(streams, ins):
        with torch.cuda.stream(s):
            got.append(PA.ragged_paged_attention(*x))
    torch.cuda.synchronize()
    for x, w in zip(got, want):
        assert torch.equal(x, w)


def test_paged_f32_makes_no_host_sync(cuda):
    """The wrapper keeps the lengths on the card: a call (after the kept
    partials exist) runs under ``set_sync_debug_mode("error")``."""
    rng = np.random.default_rng(22)
    x = _paged(rng, [5, 300, 0, 576], 4, 64, 16, 36, cuda)
    want = PA.ragged_paged_attention(*x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = PA.ragged_paged_attention(*x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
