"""The bf16 forms of the port's LSTM sequence Function and BiLSTM
(``paddle_tpu_torch/ops/kernels/lstm.py``, its plain twins on the CPU)
against the JAX package's ``lstm_seq`` and ``bilstm_seq`` (their Pallas
kernels in interpret mode) on the same bf16 inputs.

The JAX kernels round at fixed points with bf16 operands
(``paddle_tpu/ops/pallas/lstm.py``): the products h @ W_h with f32 sums,
the cell in f32, the h carry rounded to bf16 every step (the freeze keeps
the rounded carry), hs and the gates slab in bf16, cs, h_T and c_T in f32
(h_T unrounded); the backward carries dh and dc in f32, takes dgates
rounded to bf16 for dh_{t-1}, and the BiLSTM's in-loop projection stays
f32.  The twins round at the same points.

Compared: every output and input gradient, and its dtype.  A bf16 result
is held per element: unequal on at most 1% of the elements, each within
one bf16 ulp at the larger magnitude (the sums are f32 in another order,
so a value may round to its neighbour) [measured: equal everywhere].  An
f32 result within 1e-6 x max(1, |JAX|) [measured: 2.4e-7 at most, a few
f32 ulps of the transcendental functions]."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import lstm as LK

JL = importlib.import_module("paddle_tpu.ops.pallas.lstm")

BF = jnp.bfloat16
F32_TOL = 1e-6
ULP_SHARE = 0.01


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _torch(x):
    x = jnp.asarray(x)
    out = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return out.to(torch.bfloat16) if x.dtype == BF else out


def assert_matches(got, want, name):
    """``got`` (torch) against ``want`` (JAX) in the same dtype, by the
    criterion of the module docstring."""
    assert str(got.dtype).split(".")[-1] == str(jnp.asarray(want).dtype), (
        name, got.dtype, jnp.asarray(want).dtype)
    a, b = _np(got).astype(np.float64), _np(want).astype(np.float64)
    if got.dtype == torch.bfloat16:
        top = np.maximum(np.abs(a), np.abs(b))
        ulp = np.ldexp(1.0, np.frexp(top)[1] - 8)
        off = np.abs(a - b) > 0
        assert off.mean() <= ULP_SHARE, (name, off.mean())
        assert np.all(np.abs(a - b) <= ulp), (name, np.abs(a - b).max())
    else:
        assert np.all(np.abs(a - b) <= F32_TOL * np.maximum(1.0, np.abs(b))), (
            name, np.abs(a - b).max())


def lstm_inputs(b, t, d, seed):
    """bf16 xw, W_h, peepholes, h0; f32 c0 and mask (JAX's ``lstm_fused``
    hands the kernel c0 in f32); a ragged batch with a length-1 row; a
    cotangent of hs (bf16) and of h_T, c_T (f32)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    f = np.float32
    return dict(
        mask=(np.arange(t)[None, :] < lens[:, None]).astype(f),
        xw=jnp.asarray(rng.normal(size=(b, t, 4 * d)).astype(f), BF),
        w_h=jnp.asarray((rng.normal(size=(d, 4 * d)) / np.sqrt(d)).astype(f),
                        BF),
        peep=jnp.asarray((0.3 * rng.normal(size=(3, d))).astype(f), BF),
        h0=jnp.asarray((0.5 * rng.normal(size=(b, d))).astype(f), BF),
        c0=jnp.asarray((0.5 * rng.normal(size=(b, d))).astype(f)),
        ct=[jnp.asarray(rng.normal(size=(b, t, d)).astype(f), BF),
            jnp.asarray(rng.normal(size=(b, d)).astype(f)),
            jnp.asarray(rng.normal(size=(b, d)).astype(f))])


DIFF = ("xw", "w_h", "peep", "h0", "c0")
NAMES = ("hs", "h_T", "c_T", "dxw", "dw_h", "dpeep", "dh0", "dc0")


def jax_lstm(x, reverse, remat):
    def f(xw, w_h, peep, h0, c0):
        hs, (h_t, c_t) = JL.lstm_seq(xw, jnp.asarray(x["mask"]), w_h, peep,
                                     h0, c0, reverse, True, remat)
        return hs, h_t, c_t

    out, vjp = jax.vjp(f, *(x[k] for k in DIFF))
    return (*out, *vjp(tuple(x["ct"])))


def torch_lstm(x, reverse, remat):
    leaves = [_torch(x[k]).requires_grad_() for k in DIFF]
    hs, (h_t, c_t) = LK.lstm_seq(leaves[0], torch.from_numpy(x["mask"]),
                                 *leaves[1:], reverse=reverse, remat=remat)
    grads = torch.autograd.grad((hs, h_t, c_t), leaves,
                                [_torch(c) for c in x["ct"]])
    return (hs, h_t, c_t, *grads)


@pytest.mark.parametrize("b,t,d,seed", [(3, 7, 8, 0), (5, 9, 32, 1)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_bf16_lstm_seq_matches_jax_kernels(b, t, d, seed, reverse, remat):
    """Every output and gradient of ``lstm_seq`` on bf16 operands, in its
    JAX dtype, against the JAX kernels in interpret mode."""
    x = lstm_inputs(b, t, d, seed)
    for name, got, want in zip(NAMES, torch_lstm(x, reverse, remat),
                               jax_lstm(x, reverse, remat)):
        assert_matches(got, want, name)


def test_bf16_lstm_rounds_where_jax_rounds():
    """The fault this slice repaired: the twin ran the whole cell in the
    operands' dtype (hs unequal to JAX's on most elements, h_T and c_T in
    bf16) and refused an f32 c0.  Now h_T and c_T are f32, h_T unrounded
    and c0 f32 accepted, and the error against the float64 scan is JAX's
    own (within 1.1x; it was 1.9x)."""
    x = lstm_inputs(3, 7, 8, 0)
    hs, h_t, c_t = torch_lstm(x, False, False)[:3]
    assert (hs.dtype, h_t.dtype, c_t.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    assert not torch.equal(h_t, h_t.to(torch.bfloat16).float())
    jhs = jax_lstm(x, False, False)[0]
    ref = LK.lstm_seq_reference(*(_torch(x[k]).double() for k in ("xw",)),
                                torch.from_numpy(x["mask"]).double(),
                                *(_torch(x[k]).double() for k in DIFF[1:]))[0]

    def err(y):
        return float((torch.from_numpy(_np(y)).double() - ref).abs().max())

    assert err(hs) <= 1.1 * err(jhs), (err(hs), err(jhs))


@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_lstm_remat_and_stored_gates_give_the_same_bits(reverse):
    """Remat rounds the recomputed gates through bf16 (JAX ``lstm.py:392``),
    so both backward forms give the same bits, as in f32."""
    x = lstm_inputs(5, 9, 32, 2)
    for a, b in zip(torch_lstm(x, reverse, False), torch_lstm(x, reverse,
                                                              True)):
        assert torch.equal(a, b)


def bilstm_inputs(b, t, e, d, seed):
    """bf16 x, W_x, W_h, peepholes; f32 biases (JAX's ``bilstm_fused``
    casts them so), f32 c0 and bf16 h0; a ragged batch with a length-1
    row; cotangents of hs_f, hs_b (bf16) and the final states (f32)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    f = np.float32

    def bf(*shape, scale=1.0):
        return jnp.asarray((scale * rng.normal(size=shape)).astype(f), BF)

    def direction():
        return [bf(e, 4 * d, scale=e ** -0.5),
                jnp.asarray((0.1 * rng.normal(size=4 * d)).astype(f)),
                bf(d, 4 * d, scale=d ** -0.5), bf(3, d, scale=0.3)]

    return dict(
        mask=(np.arange(t)[None, :] < lens[:, None]).astype(f),
        x=bf(b, t, e), fw=direction(), bw=direction(),
        state=[bf(b, d, scale=0.5), jnp.asarray(
            (0.5 * rng.normal(size=(b, d))).astype(f)),
            bf(b, d, scale=0.5), jnp.asarray(
            (0.5 * rng.normal(size=(b, d))).astype(f))],
        ct=[bf(b, t, d), bf(b, t, d)] + [
            jnp.asarray(rng.normal(size=(b, d)).astype(f))
            for _ in range(4)])


def test_bf16_bilstm_seq_matches_jax_kernel():
    """``bilstm_seq`` on bf16 operands (its twin: the f32 projection,
    unrounded, then the bf16 recurrence per direction) against JAX's fused
    BiLSTM kernel in interpret mode with remat on (its backward over
    ``_project_xw``'s f32 slab): both hs, the four final states and all
    thirteen input gradients."""
    x = bilstm_inputs(3, 7, 16, 8, 3)
    args = [x["x"], *x["fw"], *x["bw"], *x["state"]]

    def f(*a):
        hsf, hsb, (htf, ctf), (htb, ctb) = JL.bilstm_seq(
            a[0], jnp.asarray(x["mask"]), *a[1:], True, True)
        return hsf, hsb, htf, ctf, htb, ctb

    jout, vjp = jax.vjp(f, *args)
    want = (*jout, *vjp(tuple(x["ct"])))
    leaves = [_torch(a).requires_grad_() for a in args]
    hsf, hsb, (htf, ctf), (htb, ctb) = LK.bilstm_seq(
        leaves[0], torch.from_numpy(x["mask"]), *leaves[1:])
    outs = (hsf, hsb, htf, ctf, htb, ctb)
    got = (*outs, *torch.autograd.grad(outs, leaves,
                                       [_torch(c) for c in x["ct"]]))
    assert len(got) == len(want) == 6 + 13
    for i, (g, w) in enumerate(zip(got, want)):
        assert_matches(g, w, f"output {i}")


def test_bf16_bilstm_projection_is_not_rounded():
    """The BiLSTM's in-loop projection x @ W_x + b stays f32 (JAX
    ``lstm.py:833-835``): the twin's slab is f32 and unequal to the same
    slab rounded to bf16, and hs moves when it is rounded (the planted
    fault "xw rounded in the BiLSTM")."""
    x = bilstm_inputs(4, 9, 32, 16, 4)
    xt, mask = _torch(x["x"]), torch.from_numpy(x["mask"])
    fw = [_torch(a) for a in x["fw"]] + [_torch(s) for s in x["state"][:2]]
    bw = [_torch(a) for a in x["bw"]] + [_torch(s) for s in x["state"][2:]]
    xw = LK._project_xw(xt, *fw[:2])
    assert xw.dtype == torch.float32
    assert not torch.equal(xw, xw.to(torch.bfloat16).float())
    good = LK._bi_fwd_plain(xt, mask, fw, bw)
    plain = LK._project_xw
    LK._project_xw = lambda *a: plain(*a).to(torch.bfloat16).float()
    try:
        bad = LK._bi_fwd_plain(xt, mask, fw, bw)
    finally:
        LK._project_xw = plain
    assert not torch.equal(good[0][0], bad[0][0])


def test_bf16_plan_of_the_card_forms():
    """The bf16 forms' plan on an H100 (132 SMs, 232,448 bytes a block):
    U even so the 4U gate columns are whole n8 tiles (D 1280: U 10, 5
    tiles, 128 blocks; D 64: U 2, 32 blocks), W_h's slice at 2 bytes an
    element, and the refusals past the tiling."""
    sms, optin = 132, 232448
    assert LK._bf16_units(1280, sms) == 10 and LK._bf16_units(64, sms) == 2
    assert LK._bf16_ldk(1280) == 1288
    assert LK.bf16_refusal(1280, sms, optin) is None
    assert LK.bf16_refusal(64, sms, optin) is None
    assert "multiple of 8" in LK.bf16_refusal(1284, sms, optin)
    assert "units" in LK.bf16_refusal(2120, sms, optin)
    assert "shared memory" in LK.bf16_refusal(2112, sms, optin)
    # the shared-memory boundary: D 1744 taken, 1752 refused (W_h's slice
    # holds 4U rows since the backward's dh product left the slice)
    assert LK.bf16_refusal(1744, sms, optin) is None
    assert "shared memory" in LK.bf16_refusal(1752, sms, optin)
    assert LK.bi_bf16_refusal(256, 64, sms, optin) is None
    assert "D at most" in LK.bi_bf16_refusal(256, 72, sms, optin)
    assert "shared memory" in LK.bi_bf16_refusal(4096, 64, sms, optin)
    w = torch.randn(64, 256).to(torch.bfloat16)
    pack = LK._pack_rows_bf16(w, 2)
    assert tuple(pack.shape) == (32, 8, 72)
    # block 3, unit 1, gate 2 = column 2 * 64 + 3 * 2 + 1; pads zero
    assert torch.equal(pack[3, 4 * 1 + 2, :64], w[:, 2 * 64 + 7])
    assert not pack[:, :, 64:].any()
