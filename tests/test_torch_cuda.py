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

from paddle_tpu_torch.core.dtype import set_f32_policy
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import paged_attention as PA

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU host)")
    set_f32_policy()
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


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError

    q = torch.zeros(1, 64, 2, 64, dtype=torch.float64, device=cuda)
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

    x = torch.zeros(2, 64, 64, dtype=torch.float64, device=cuda)
    lse = torch.zeros(2, 64, 1, device=cuda)
    with pytest.raises(EnforceError, match="float32"):
        FA._bwd_kernel(x, x, x, x, lse, x, 64, True, 0.125)
    x = torch.zeros(2, 60, 64, device=cuda)
    with pytest.raises(EnforceError, match="64-row"):
        FA._bwd_kernel(x, x, x, x, lse, x, 60, True, 0.125)


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
    n_bwd = LK.KERNEL_BWD.launches
    stored = LK._bwd_kernel(None, gates, *args, False)
    remat = LK._bwd_kernel(xw, None, *args, True)
    again = LK._bwd_kernel(xw, None, *args, True)
    torch.cuda.synchronize()
    assert LK.KERNEL_BWD.launches == n_bwd + 3
    assert all(torch.equal(x, y) for x, y in zip(stored, remat))
    assert all(torch.equal(x, y) for x, y in zip(remat, again))
    want = LK._bwd_plain(xw, gates, *args, True)
    for x, y in zip(remat, want):
        assert ((x - y).abs().max().item()
                <= TOL * max(1.0, y.abs().max().item()))


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


@pytest.mark.parametrize("b,t,e,d", [
    (64, 24, 256, 64),  # the OCR CRNN at bench width
    (64, 24, 256, 32),  # rnn_size 32 (the convergence recipe)
    (3, 7, 16, 8),      # the CPU tests' shapes: B not a multiple of 4
    (5, 9, 16, 32),
])
def test_bilstm_kernel_matches_plain(cuda, b, t, e, d):
    """The bilstm forward kernel against its plain twin on the same CUDA
    tensors, ragged lengths; a rerun repeats the bits."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

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
                                     (5, 9, 16, 8), (3, 7, 16, 32)])
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


@pytest.mark.parametrize("b,t,v", [(64, 24, 27), (3, 300, 7), (5, 9, 2)])
@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_decode_kernel_matches_plain(cuda, b, t, v, blank):
    """The decode kernel's (argmax, keep) pair and the compacted ids equal
    the plain twin's in bits, with ties (first index wins), repeats and
    ragged lengths; T = 300 crosses the kernel's 128-frame chunks."""
    from paddle_tpu_torch.ops.kernels import ctc as KC

    rng = np.random.default_rng(b + t + v)
    x = torch.from_numpy(rng.integers(0, 3, size=(b, t, v)).astype(
        np.float32)).to(cuda)    # small integers: many ties and repeats
    ilen = torch.from_numpy(rng.integers(0, t + 1, size=b)).to(cuda)
    blank = 0 if blank == "first" else v - 1
    n = KC.KERNEL_DECODE.launches
    best, keep = KC._decode_kernel(x, ilen, blank)
    ids, lens = KC.ctc_greedy_decode_fused(x, ilen, blank)
    torch.cuda.synchronize()
    assert KC.KERNEL_DECODE.launches == n + 2
    want_best, want_keep = KC._decode_plain(x, ilen, blank)
    assert torch.equal(best, want_best) and torch.equal(keep, want_keep)
    want = KC.ctc_greedy_decode_fused_reference(x, ilen, blank)
    assert torch.equal(ids, want[0]) and torch.equal(lens, want[1])


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

    x = _bilstm_inputs(np.random.default_rng(0), 2, 3, 16, 256, cuda)
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
# is not a multiple of 32 and a single row
STATS_SHAPES = [(131072, 64), (32768, 128), (8192, 256), (2048, 512),
                (128, 512), (1000003 // 7, 48), (777, 45), (1, 96)]


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
