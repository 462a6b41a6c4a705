"""The bf16 forms of the port's GRU sequence Function and BiGRU
(``paddle_tpu_torch/ops/kernels/gru.py``, its plain twins on the CPU)
against the JAX package's ``gru_seq`` and ``bigru_seq`` (their Pallas
kernels in interpret mode) on the same bf16 inputs.

The JAX kernels round at fixed points with bf16 operands
(``paddle_tpu/ops/pallas/gru.py``): u and r from the product h @ W_h with
f32 sums, r * h rounded to bf16 before the candidate product, the cell in
f32, the h carry rounded to bf16 every step (the freeze keeps the rounded
carry), hs and the u/r/c slab in bf16, h_T in f32 (unrounded); the
backward carries dh in f32, reads (or recomputes and rounds) u, r, c in
bf16, rounds dc and [du, dr] to bf16 before their W_hc^T and W_h^T
products, hands back dxw in f32 and builds dW_hc from bf16(bf16(r) h);
the BiGRU's in-loop projection stays f32.  The twins round at the same
points.

Compared: every output and input gradient, and its dtype.  A bf16 result
is held per element: unequal on at most 1% of the elements, each within
one bf16 ulp at the larger magnitude (the sums are f32 in another order,
so a value may round to its neighbour).  An f32 result within 1e-6 x
max(1, |JAX|).  The measured values stand at each test."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.lod import SequenceBatch
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.ops.kernels import gru as GK

JG = importlib.import_module("paddle_tpu.ops.pallas.gru")
JR = importlib.import_module("paddle_tpu.ops.rnn")
JL = importlib.import_module("paddle_tpu.core.lod")

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


def unequal(got, want) -> tuple[float, float]:
    """(share of unequal elements, largest gap in ulps at the larger
    magnitude) of two bf16 results."""
    a, b = _np(got).astype(np.float64), _np(want).astype(np.float64)
    top = np.maximum(np.abs(a), np.abs(b))
    ulp = np.ldexp(1.0, np.frexp(top)[1] - 8)
    gap = np.abs(a - b)
    return float((gap > 0).mean()), float((gap / ulp).max())


def assert_matches(got, want, name):
    """``got`` (torch) against ``want`` (JAX) in the same dtype, by the
    criterion of the module docstring."""
    assert str(got.dtype).split(".")[-1] == str(jnp.asarray(want).dtype), (
        name, got.dtype, jnp.asarray(want).dtype)
    if got.dtype == torch.bfloat16:
        share, ulps = unequal(got, want)
        assert share <= ULP_SHARE and ulps <= 1, (name, share, ulps)
    else:
        a, b = _np(got).astype(np.float64), _np(want).astype(np.float64)
        assert np.all(np.abs(a - b) <= F32_TOL * np.maximum(1.0, np.abs(b))), (
            name, np.abs(a - b).max())


def lengths(rng, b, t):
    """A ragged batch: the first row full, the last of length 1."""
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def gru_inputs(b, t, d, seed):
    """bf16 xw, W_h, W_hc and h0 (JAX's ``gru_fused`` hands the kernel the
    carry in W_h's dtype), an f32 mask with a ragged row of length 1; the
    cotangents of hs (bf16) and h_T (f32)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def bf(*shape, scale=1.0):
        return jnp.asarray((scale * rng.normal(size=shape)).astype(f), BF)

    return dict(mask=lengths(rng, b, t), xw=bf(b, t, 3 * d),
                w_h=bf(d, 2 * d, scale=d ** -0.5),
                w_hc=bf(d, d, scale=d ** -0.5), h0=bf(b, d, scale=0.5),
                ct=[bf(b, t, d), jnp.asarray(rng.normal(size=(b, d)).astype(f))])


DIFF = ("xw", "w_h", "w_hc", "h0")
NAMES = ("hs", "h_T", "dxw", "dw_h", "dw_hc", "dh0")


def jax_gru(x, reverse, remat):
    def f(xw, w_h, w_hc, h0):
        return JG.gru_seq(xw, jnp.asarray(x["mask"]), w_h, w_hc, h0, reverse,
                          True, remat)

    out, vjp = jax.vjp(f, *(x[k] for k in DIFF))
    return (*out, *vjp(tuple(x["ct"])))


def torch_gru(x, reverse, remat):
    leaves = [_torch(x[k]).requires_grad_() for k in DIFF]
    hs, h_t = GK.gru_seq(leaves[0], torch.from_numpy(x["mask"]), *leaves[1:],
                         reverse=reverse, remat=remat)
    grads = torch.autograd.grad((hs, h_t), leaves,
                                [_torch(c) for c in x["ct"]])
    return (hs, h_t, *grads)


@pytest.mark.parametrize("b,t,d,seed", [(3, 7, 8, 0), (5, 9, 16, 1)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_bf16_gru_seq_matches_jax_kernels(b, t, d, seed, reverse, remat):
    """Every output and gradient of ``gru_seq`` on bf16 operands, in its
    JAX dtype, against the JAX kernels in interpret mode [measured: every
    bf16 result equal in bits; the f32 ones (h_T, dxw, dh0) within 6e-8
    x max(1, |JAX|)]."""
    x = gru_inputs(b, t, d, seed)
    for name, got, want in zip(NAMES, torch_gru(x, reverse, remat),
                               jax_gru(x, reverse, remat)):
        assert_matches(got, want, name)


def test_bf16_gru_rounds_where_jax_rounds():
    """The fault this slice repaired (ROADMAP C3): the twins ran the whole
    cell in the operands' dtype, so hs was unequal to JAX's on 48% of its
    elements, h_T came back bf16, and ``bigru_seq`` refused the f32 bias
    JAX's ``bigru_fused`` passes.  Now hs equals JAX's, h_T is f32 and
    unrounded, and the BiGRU takes an f32 bias."""
    x = gru_inputs(3, 7, 8, 0)
    hs, h_t = torch_gru(x, False, False)[:2]
    jhs, jh_t = jax_gru(x, False, False)[:2]
    assert (hs.dtype, h_t.dtype) == (torch.bfloat16, torch.float32)
    assert not torch.equal(h_t, h_t.to(torch.bfloat16).float())
    assert unequal(hs, jhs) == (0.0, 0.0)
    assert_matches(h_t, jh_t, "h_T")
    y = bigru_inputs(3, 7, 16, 8, 4)
    out = GK.bigru_seq(_torch(y["x"]), torch.from_numpy(y["mask"]),
                       *(_torch(a) for a in y["args"]))
    assert [o.dtype for o in out] == [torch.bfloat16] * 2 + [torch.float32] * 2


@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_gru_remat_and_stored_gates_give_the_same_bits(reverse):
    """Remat rounds the recomputed gates through bf16 (JAX ``gru.py:150``),
    so both backward forms give the same bits, as in f32."""
    x = gru_inputs(5, 9, 16, 2)
    for a, b in zip(torch_gru(x, reverse, False), torch_gru(x, reverse, True)):
        assert torch.equal(a, b)


def test_bf16_gru_dw_hc_takes_the_rounded_reset_gate():
    """The backward's rh, dW_hc's operand, is bf16(bf16(r) h_{t-1}) from
    the rounded r of the slab (JAX ``gru.py:373``), not the forward's
    bf16(r h_{t-1}): on these inputs the two differ on some elements and
    the twin's equals the first everywhere."""
    x = gru_inputs(5, 9, 16, 5)
    xw, mask = _torch(x["xw"]), torch.from_numpy(x["mask"])
    w_h, w_hc, h0 = (_torch(x[k]) for k in ("w_h", "w_hc", "h0"))
    hs, urc, _ = GK._fwd_plain(xw, mask, w_h, w_hc, h0, False, True)
    _, _, rh = GK._bwd_plain(None, urc, mask, w_h, w_hc, h0, hs,
                             _torch(x["ct"][0]), _torch(x["ct"][1]), False,
                             False)
    h_prev = GK._shift_prev(hs, h0, False).float()
    r_bf = urc[..., 16:32].float()
    assert torch.equal(rh, (r_bf * h_prev).to(torch.bfloat16))
    xf = xw.float()
    r = torch.sigmoid(xf[..., 16:32] + torch.matmul(h_prev, w_h.float())[
        ..., 16:])
    assert not torch.equal(rh, (r * h_prev).to(torch.bfloat16))


def test_bf16_gru_fused_casts_as_jax():
    """``ops/rnn.gru_fused`` on a bf16 gate input with f32 weights (a
    caller outside the compute-dtype policy): the operands cast as JAX's
    ``gru_fused`` casts them (``cast_for_matmul``: bf16; the carry in
    W_h's dtype), hs and h_T back in the caller's dtype, equal to JAX's."""
    x = gru_inputs(4, 6, 8, 6)
    lens = x["mask"].sum(1).astype(np.int32)
    w_h, w_hc = (np.array(jnp.asarray(x[k]).astype(jnp.float32))
                 for k in ("w_h", "w_hc"))
    init = np.zeros((4, 8), np.float32)
    jhs, jh_t = JR.gru_fused(JL.SequenceBatch(x["xw"], jnp.asarray(lens)),
                             jnp.asarray(w_h), jnp.asarray(w_hc),
                             jnp.asarray(init))
    hs, h_t = rnn_ops.gru_fused(
        SequenceBatch(_torch(x["xw"]), torch.from_numpy(lens)),
        torch.from_numpy(w_h), torch.from_numpy(w_hc),
        torch.from_numpy(init), remat=False)
    assert_matches(hs.data, jhs.data, "hs")
    assert_matches(h_t, jh_t, "h_T")


def bigru_inputs(b, t, e, d, seed):
    """bf16 x, W_x, W_h, W_hc and h0 per direction; f32 biases (JAX's
    ``bigru_fused`` casts them so); a ragged batch with a length-1 row;
    cotangents of hs_f, hs_b (bf16) and the final states (f32)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def bf(*shape, scale=1.0):
        return jnp.asarray((scale * rng.normal(size=shape)).astype(f), BF)

    def direction():
        return [bf(e, 3 * d, scale=e ** -0.5),
                jnp.asarray((0.1 * rng.normal(size=3 * d)).astype(f)),
                bf(d, 2 * d, scale=d ** -0.5), bf(d, d, scale=d ** -0.5)]

    return dict(mask=lengths(rng, b, t), x=bf(b, t, e),
                args=direction() + direction() + [bf(b, d, scale=0.5),
                                                  bf(b, d, scale=0.5)],
                ct=[bf(b, t, d), bf(b, t, d)] + [
                    jnp.asarray(rng.normal(size=(b, d)).astype(f))
                    for _ in range(2)])


@pytest.mark.parametrize("b,t,e,d,seed", [(3, 7, 16, 8, 3),
                                          (5, 9, 16, 16, 7)])
def test_bf16_bigru_seq_matches_jax_kernel(b, t, e, d, seed):
    """``bigru_seq`` on bf16 operands (its twin: the f32 projection,
    unrounded, then the bf16 recurrence per direction) against JAX's fused
    BiGRU kernel in interpret mode with remat on (its backward over
    ``_project_xw``'s f32 slab): both hs, both h_T and all eleven input
    gradients [measured: every bf16 result equal in bits; the f32 ones
    within 3.3e-7 x max(1, |JAX|), at db]."""
    x = bigru_inputs(b, t, e, d, seed)
    args = [x["x"], *x["args"]]

    def f(*a):
        return JG.bigru_seq(a[0], jnp.asarray(x["mask"]), *a[1:], True, True)

    jout, vjp = jax.vjp(f, *args)
    want = (*jout, *vjp(tuple(x["ct"])))
    leaves = [_torch(a).requires_grad_() for a in args]
    outs = GK.bigru_seq(leaves[0], torch.from_numpy(x["mask"]), *leaves[1:])
    got = (*outs, *torch.autograd.grad(outs, leaves,
                                       [_torch(c) for c in x["ct"]]))
    assert len(got) == len(want) == 4 + 11
    for i, (g, w) in enumerate(zip(got, want)):
        assert_matches(g, w, f"output {i}")


def test_bf16_bigru_projection_is_not_rounded():
    """The BiGRU's in-loop projection x @ W_x + b stays f32 (JAX
    ``gru.py:578-580``): the twin's slab is f32 and unequal to the same
    slab rounded to bf16, and hs moves when it is rounded (the planted
    fault "xw rounded in the BiGRU")."""
    x = bigru_inputs(4, 9, 32, 16, 8)
    xt, mask = _torch(x["x"]), torch.from_numpy(x["mask"])
    a = [_torch(v) for v in x["args"]]
    fw, bw = a[:4] + [a[8]], a[4:8] + [a[9]]
    xw = GK._project_xw(xt, *fw[:2])
    assert xw.dtype == torch.float32
    assert not torch.equal(xw, xw.to(torch.bfloat16).float())
    good = GK._bi_fwd_plain(xt, mask, fw, bw)
    plain = GK._project_xw
    GK._project_xw = lambda *v: plain(*v).to(torch.bfloat16).float()
    try:
        bad = GK._bi_fwd_plain(xt, mask, fw, bw)
    finally:
        GK._project_xw = plain
    assert not torch.equal(good[0][0], bad[0][0])


def test_bf16_plan_of_the_card_forms():
    """The bf16 forms' plan on an H100 (132 SMs, 232,448 bytes a block): at
    the NMT's D 512, U 4 (128 blocks; W_h's 8 columns one n8 tile, W_hc's
    4 half of one) and, the BiGRU on 66 SMs a direction, U 8 (64 blocks a
    direction); the packs' layout; the refusals past the tiling."""
    sms, optin = 132, 232448
    assert GK._bf16_units(512, sms) == 4 and GK._bf16_units(512, 66) == 8
    assert GK._ldk(512) == 520 and GK._ldk(1024) == 1032 and GK._ldk(8) == 24
    # forward/backward at D 512: the row slices [8][1032] + [8][520] bf16,
    # then three 64 x 72 bf16 stages
    assert GK._bf16_smem_bytes(512, 4, 3) == 2 * 8 * (1032 + 520) + 27648
    assert GK.bf16_refusal(512, sms, optin) is None
    assert GK.bi_bf16_refusal(512, 512, sms, optin) is None
    assert GK.bf16_refusal(2048, sms, optin) is None
    assert "multiple of 8" in GK.bf16_refusal(516, sms, optin)
    assert "units" in GK.bf16_refusal(2120, sms, optin)
    assert "multiples of 8" in GK.bi_bf16_refusal(500, 512, sms, optin)
    assert "units" in GK.bi_bf16_refusal(512, 1064, sms, optin)
    assert "shared memory" in GK.bi_bf16_refusal(8192, 1024, sms, optin)
    assert "shared memory" in GK.bf16_refusal(2048, sms, 60000)
    w = torch.randn(16, 2 * 24)
    pack = GK._pack_bf16(w, 24, 5, 2)       # D 24, U 5: 5 blocks, 10 rows
    assert tuple(pack.shape) == (5, 16, 24) and pack.dtype == torch.bfloat16
    # block 3, unit 1, gate r (g = 1) = column 1 * 24 + 3 * 5 + 1
    assert torch.equal(pack[3, 2 * 1 + 1, :16],
                       w[:, 24 + 16].to(torch.bfloat16))
    assert not pack[:, 10:].any() and not pack[:, :, 16:].any()
    assert not pack[4, 2 * 4:].any()      # units 24 and past: zero


def test_bf16_lone_gru_step_group_matches_jax():
    """A ``recurrent_group`` whose step is one standard ``gru_step`` on its
    memory (the route that runs the GRU sequence kernel) in bf16, its
    parameters and feed cast as the v2 step casts them: the output equals
    JAX's on all but 1% of its elements, each within one ulp [measured:
    equal], with ragged rows and one of length 1, both directions."""
    import paddle_tpu as jpaddle
    from paddle_tpu.config.topology import Topology as JTopology
    from paddle_tpu.layers.base import reset_name_counters as jax_reset
    from paddle_tpu.trainer.step import _cast_floats as jcast
    from paddle_tpu_torch.config.topology import Topology as TTopology
    from paddle_tpu_torch.core.dtype import cast_floats
    from paddle_tpu_torch.layers.base import reset_name_counters

    d = 16
    rng = np.random.default_rng(9)
    data = rng.normal(size=(4, 7, 3 * d)).astype(np.float32)
    lens = np.array([7, 3, 1, 5])

    def build(root, reverse):
        imp = importlib.import_module
        layer, dt = imp(f"{root}.layers.api"), imp(f"{root}.layers.data_type")
        rg = imp(f"{root}.layers.recurrent_group")
        x = layer.data(name="gx", type=dt.dense_vector_sequence(3 * d))

        def step(xt):
            mem = rg.memory(name="g", size=d)
            return rg.gru_step_layer(input=xt, output_mem=mem, size=d,
                                     name="g")

        return rg.recurrent_group(step=step, input=x, reverse=reverse,
                                  name="gg")

    for reverse in (False, True):
        jax_reset()
        jtopo = JTopology(build("paddle_tpu", reverse))
        reset_name_counters()
        ttopo = TTopology(build("paddle_tpu_torch", reverse))
        jparams = jpaddle.parameters.create(jtopo)
        carried = {n: np.array(jparams[n]) for n in jparams.names()}
        carried = {n: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
                   if "bias" in n else v for n, v in carried.items()}
        jfeed = {"gx": JL.SequenceBatch(jnp.asarray(data),
                                        jnp.asarray(lens.astype(np.int32)))}
        jvals, _ = jtopo.forward(
            jcast({n: jnp.asarray(v) for n, v in carried.items()}, BF), {},
            jcast(jfeed, BF), False, jax.random.key(0))
        tfeed = {"gx": SequenceBatch(torch.from_numpy(data),
                                     torch.from_numpy(lens))}
        tvals, _ = ttopo.forward(
            cast_floats({n: torch.from_numpy(v) for n, v in carried.items()},
                        torch.bfloat16), {},
            cast_floats(tfeed, torch.bfloat16), False)
        name = ttopo.outputs[0].name
        assert_matches(tvals[name].data, jvals[name].data, name)
