"""The bf16 forms of the port's raw-input recurrences
(``paddle_tpu_torch/ops/kernels/{lstm,gru}.py``: ``lstm_seq_fi`` and
``gru_seq_fi``, their plain twins on the CPU) and the entries
``ops/rnn.lstm``, ``gru``, ``lstm_fi`` and ``gru_fi`` on bf16 operands,
against the JAX package's (its Pallas kernels in interpret mode) on the
same numpy inputs.

The JAX fused-input kernels round at fixed points with bf16 operands
(``paddle_tpu/ops/pallas/lstm.py:633-635``, ``gru.py:418-420``): the
in-loop projection ``x_t @ W_x`` is an f32 product plus the f32 bias,
never rounded, and ``h @ W_h`` is added to it as a second f32 sum; the
cell in f32, the h carry rounded to bf16 every step, hs and the gate
slab bf16, the final states f32.  The backward recomputes xw in f32
(``_project_xw``), runs the bf16 remat (or stored-gates) backward over
it, and forms dW_x and dx as bf16 products with f32 sums.

Compared: every output and input gradient, and its dtype.  A bf16 result
is held per element: unequal on at most 1% of the elements, each within
one bf16 ulp at the larger magnitude (f32 sums in another order may
round a value to its neighbour).  An f32 result within 1e-6 x max(1,
|JAX|).  The measured values stand at each test."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.lod import SequenceBatch as TSeq
from paddle_tpu_torch.ops import rnn as TR
from paddle_tpu_torch.ops.kernels import gru as GK
from paddle_tpu_torch.ops.kernels import lstm as LK

JL = importlib.import_module("paddle_tpu.ops.pallas.lstm")
JG = importlib.import_module("paddle_tpu.ops.pallas.gru")
JR = importlib.import_module("paddle_tpu.ops.rnn")
JSeq = importlib.import_module("paddle_tpu.core.lod").SequenceBatch

BF = jnp.bfloat16
F32_TOL = 1e-6
ULP_SHARE = 0.01
H100 = (132, 232448)     # SMs, shared-memory bytes a block may opt in to


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


def inputs(kind, b, t, e, d, seed):
    """bf16 x, W_x, W_h (W_hc), peepholes and h0 (the carry in W_h's
    dtype, as JAX's ``lstm_fi`` / ``gru_fi`` hand it over), the f32 bias
    (``ops/rnn.py:233-245``), c0 and a ragged mask whose first row is full
    and last of length 1; the cotangents of hs (bf16) and the final
    states (f32)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def bf(*shape, scale=1.0):
        return jnp.asarray((scale * rng.normal(size=shape)).astype(f), BF)

    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    n = 4 if kind == "lstm" else 3
    x = dict(mask=(np.arange(t)[None, :] < lens[:, None]).astype(f),
             lens=lens, x=bf(b, t, e), w_x=bf(e, n * d, scale=e ** -0.5),
             b=jnp.asarray((0.2 * rng.normal(size=n * d)).astype(f)))
    if kind == "lstm":
        x["w_h"] = bf(d, 4 * d, scale=d ** -0.5)
        x["peep"] = bf(3, d, scale=0.3)
        x["h0"] = bf(b, d, scale=0.5)
        x["c0"] = jnp.asarray((0.5 * rng.normal(size=(b, d))).astype(f))
        x["ct"] = [bf(b, t, d)] + [
            jnp.asarray(rng.normal(size=(b, d)).astype(f)) for _ in range(2)]
    else:
        x["w_h"] = bf(d, 2 * d, scale=d ** -0.5)
        x["w_hc"] = bf(d, d, scale=d ** -0.5)
        x["h0"] = bf(b, d, scale=0.5)
        x["ct"] = [bf(b, t, d), jnp.asarray(rng.normal(size=(b, d))
                                            .astype(f))]
    return x


DIFF = {"lstm": ("x", "w_x", "b", "w_h", "peep", "h0", "c0"),
        "gru": ("x", "w_x", "b", "w_h", "w_hc", "h0")}


def names(kind):
    outs = ("hs", "h_T", "c_T") if kind == "lstm" else ("hs", "h_T")
    return outs + tuple("d" + k for k in DIFF[kind])


def _flat(kind, out):
    return (out[0], *out[1]) if kind == "lstm" else tuple(out)


def jax_fi(kind, x, reverse, remat):
    """Outputs and the gradients of DIFF of JAX's ``*_seq_fi`` (its Pallas
    kernel in interpret mode)."""
    mod = JL if kind == "lstm" else JG
    m = jnp.asarray(x["mask"])

    def f(*w):
        return _flat(kind, getattr(mod, f"{kind}_seq_fi")(
            w[0], m, *w[1:], reverse, True, remat))

    out, vjp = jax.vjp(f, *(x[k] for k in DIFF[kind]))
    return (*out, *vjp(tuple(x["ct"])))


def torch_fi(kind, x, reverse, remat):
    """Outputs and the gradients of DIFF of the port's ``*_seq_fi``."""
    mod = LK if kind == "lstm" else GK
    leaves = [_torch(x[k]).requires_grad_() for k in DIFF[kind]]
    out = getattr(mod, f"{kind}_seq_fi")(
        leaves[0], torch.from_numpy(x["mask"]), *leaves[1:], reverse=reverse,
        remat=remat)
    outs = _flat(kind, out)
    grads = torch.autograd.grad(outs, leaves, [_torch(c) for c in x["ct"]])
    return (*outs, *grads)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("b,t,e,d", [(3, 7, 8, 8), (5, 4, 16, 16),
                                     (3, 1, 16, 8)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_bf16_fused_input_matches_jax_kernels(kind, b, t, e, d, reverse,
                                              remat):
    """Every output and gradient of ``lstm_seq_fi`` / ``gru_seq_fi`` on bf16
    operands, in its JAX dtype, against the JAX kernels in interpret mode
    [measured: every bf16 result equal in bits; the f32 ones within 2.7e-7
    x max(1, |JAX|)]."""
    x = inputs(kind, b, t, e, d, seed=b * 1000 + t * 100 + e + d)
    for name, got, want in zip(names(kind), torch_fi(kind, x, reverse, remat),
                               jax_fi(kind, x, reverse, remat)):
        assert_matches(got, want, name)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_bf16_fi_twin_projects_in_f32(kind):
    """The fault this slice repaired (ROADMAP C5): the fused-input twins
    formed b + x_t @ W_x in bf16, where JAX keeps it in f32
    (``lstm.py:633-635``, ``gru.py:418-420``), so hs was unequal to JAX's
    kernel on 15-40% of its elements and h_T on 54-100%.  Now the twin's
    forward equals JAX's kernel in bits."""
    x = inputs(kind, 5, 7, 16, 16, seed=21)
    mod = LK if kind == "lstm" else GK
    m = jnp.asarray(x["mask"])
    w = [x[k] for k in DIFF[kind][1:]]
    got = mod._fi_fwd_plain(_torch(x["x"]), torch.from_numpy(x["mask"]),
                            *(_torch(v) for v in w), False, False)
    want = getattr(JL if kind == "lstm" else JG, f"{kind}_seq_fi")(
        x["x"], m, *w, False, True, False)
    hs, h_t = (got[0], got[3]) if kind == "lstm" else (got[0], got[2])
    jhs, jh_t = (want[0], want[1][0]) if kind == "lstm" else want
    assert (hs.dtype, h_t.dtype) == (torch.bfloat16, torch.float32)
    assert unequal(hs, jhs) == (0.0, 0.0)
    np.testing.assert_allclose(_np(h_t), _np(jh_t), atol=F32_TOL, rtol=0)


# -- the entries of ops/rnn ---------------------------------------------------


def _entry_args(kind, x, w, bias):
    """(x, weights..., bias or None) in the order ``lstm_fi`` / ``gru_fi``
    take them."""
    if kind == "lstm":
        return (w["x"], w["w_x"], w["b"] if bias else None, w["w_h"])
    return (w["x"], w["w_x"], w["b"] if bias else None, w["w_h"], w["w_hc"])


def jax_entry(kind, x, reverse, bias, route):
    """Outputs and the gradients of JAX's ``ops/rnn`` entry on bf16
    operands: ``route`` "fi" calls ``lstm_fi`` / ``gru_fi`` (the kernel
    in interpret mode), "entry" calls ``lstm`` / ``gru`` (on the CPU the
    unfused composition)."""
    keys = ["x", "w_x", "w_h"] + (["w_hc"] if kind == "gru" else []) + ["b"]
    lens = jnp.asarray(x["lens"].astype(np.int32))

    def f(*vals):
        w = dict(zip(keys, vals))
        seq = JSeq(w["x"], lens)
        b = w["b"] if bias else None
        if kind == "lstm":
            st = JR.LSTMState(h=x["h0"], c=x["c0"])
            if route == "fi":
                out, last = JR.lstm_fi(seq, w["w_x"], b, w["w_h"], st,
                                       reverse=reverse)
            else:
                out, last = JR.lstm(seq, w["w_x"], w["w_h"], b, reverse,
                                    init=st)
            return out.data, last.h, last.c
        if route == "fi":
            out, last = JR.gru_fi(seq, w["w_x"], b, w["w_h"], w["w_hc"],
                                  x["h0"], reverse=reverse)
        else:
            out, last = JR.gru(seq, w["w_x"], w["w_h"], w["w_hc"], b,
                               reverse, init=x["h0"])
        return out.data, last

    out, vjp = jax.vjp(f, *(x[k] for k in keys))
    cts = tuple(jnp.asarray(c, o.dtype) for c, o in zip(x["ct"], out))
    return keys, (*out, *vjp(cts))


def torch_entry(kind, x, reverse, bias, route):
    """The port's counterpart of :func:`jax_entry`."""
    keys = ["x", "w_x", "w_h"] + (["w_hc"] if kind == "gru" else []) + ["b"]
    leaves = {k: _torch(x[k]).requires_grad_() for k in keys}
    seq = TSeq(leaves["x"], torch.from_numpy(x["lens"]))
    b = leaves["b"] if bias else None
    if kind == "lstm":
        st = TR.LSTMState(h=_torch(x["h0"]), c=_torch(x["c0"]))
        if route == "fi":
            out, last = TR.lstm_fi(seq, leaves["w_x"], b, leaves["w_h"], st,
                                   reverse=reverse)
        else:
            out, last = TR.lstm(seq, leaves["w_x"], leaves["w_h"], b, reverse,
                                init=st)
        outs = (out.data, last.h, last.c)
    else:
        if route == "fi":
            out, last = TR.gru_fi(seq, leaves["w_x"], b, leaves["w_h"],
                                  leaves["w_hc"], _torch(x["h0"]),
                                  reverse=reverse)
        else:
            out, last = TR.gru(seq, leaves["w_x"], leaves["w_h"],
                               leaves["w_hc"], b, reverse,
                               init=_torch(x["h0"]))
        outs = (out.data, last)
    cts = [_torch(c).to(o.dtype) for c, o in zip(x["ct"], outs)]
    grads = torch.autograd.grad(outs, list(leaves.values()), cts,
                                allow_unused=True)
    return (*outs, *grads)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("route", ["fi", "entry"])
@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_entries_match_jax(kind, route, reverse):
    """``ops/rnn.lstm_fi`` / ``gru_fi`` (the fused-input kernels) and
    ``lstm`` / ``gru`` (on the CPU the unfused composition, as JAX's off
    the TPU) on bf16 x and weights against JAX's, with and without a
    bias: every output and gradient in JAX's dtype [measured: every bf16
    result equal in bits; the f32 ones within 3.0e-7 x max(1, |JAX|)]."""
    x = inputs(kind, 4, 6, 8, 8, seed=31 + 2 * reverse)
    for bias in (True, False):
        got = torch_entry(kind, x, reverse, bias, route)
        keys, want = jax_entry(kind, x, reverse, bias, route)
        outs = ("hs", "h_T", "c_T")[:len(got) - len(keys)]
        for name, g, w in zip(outs + tuple("d" + k for k in keys), got,
                              want):
            if g is None:       # the bias of a run without one
                assert name == "db" and not bias
                continue
            assert_matches(g, w, f"{name} bias={bias}")


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_bf16_route_takes_the_fused_input_function(kind, monkeypatch):
    """With the routing on (as on the card) and an H100's tiling,
    ``ops.rnn.lstm`` / ``gru`` on bf16 operands take the fused-input
    Function where the bf16 refusal is None (at RAW_RNN's widths too), as
    JAX routes them; the outputs equal JAX's ``lstm_fi`` / ``gru_fi``."""
    mod = LK if kind == "lstm" else GK
    monkeypatch.setattr(TR, "fused_input_on", lambda device: True)
    monkeypatch.setattr(mod, "_card", lambda device: H100)
    calls = []
    for name in (f"{kind}_seq_fi", f"{kind}_seq"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    x = inputs(kind, 3, 5, 16, 16, seed=41)
    got = torch_entry(kind, x, False, True, "entry")
    assert calls == [f"{kind}_seq_fi"]
    want = jax_entry(kind, x, False, True, "fi")[1]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_matches(g, w, f"{kind} {i}")
    # the path's widths fit the bf16 forms on an H100 (E 128 / 512, D 512)
    for e in (128, 512):
        assert mod.fi_bf16_refusal(e, 512, *H100) is None
        assert mod.fi_fits("cuda", e, 512, torch.bfloat16)
        assert TR.fused_input_fits(
            torch.zeros(1, 1, e, dtype=torch.bfloat16), mod,
            torch.zeros(e, 4 * 512 if kind == "lstm" else 3 * 512),
            *([torch.zeros(512, 4 * 512)] if kind == "lstm" else
              [torch.zeros(512, 2 * 512), torch.zeros(512, 512)]))


@pytest.mark.parametrize("mod,e,d,why", [
    (LK, 12, 16, "multiple"), (GK, 16, 12, "multiple"),
    (LK, 16, 2 * 132 * 16 + 8, "units a block"),
    (GK, 16, 132 * 16 + 8, "units a block"),
])
def test_bf16_fi_refusal_names_the_reason(mod, e, d, why):
    """The bf16 fused-input refusal (beside ``bf16_refusal``): 16-byte
    copies of bf16 need E and D multiples of 8; a block owns at most 16
    units; the fit predicate is the refusal's, so the route and the
    wrapper's check never disagree; float16 has no form."""
    reason = mod.fi_bf16_refusal(e, d, *H100)
    assert reason is not None and why in reason
    assert not mod.fi_fits("cuda", 512, 512, torch.float16)


def test_bf16_fi_smem_plan():
    """The bf16 fused-input blocks' shared memory at the path's widths
    mirrors the kernels' plans: the LSTM's W_x slice [16][136] bf16 beside
    ``PlanFwdBf16`` at U 4, the GRU's four slices at E = D = 512 and the
    staging region; both far inside the opt-in."""
    u = LK._bf16_units(512, 132)
    assert u == 4
    assert LK.fi_bf16_smem_bytes(128, 512, u) == (
        16 * 136 * 2 + LK._bf16_smem_bytes(512, 4, 2))
    assert GK.bi_bf16_smem_bytes(512, 512, 4, 2) == (
        2 * 8 * 2 * (520 + 520) + 2 * 64 * 72 * 2)
