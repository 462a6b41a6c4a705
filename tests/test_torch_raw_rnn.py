"""The raw-input recurrences of the port: ``kernels/lstm.lstm_seq_fi`` and
``kernels/gru.gru_seq_fi`` (their plain twins on the CPU) and the entries
``ops/rnn.lstm``, ``gru``, ``lstm_fi`` and ``gru_fi``, against the JAX
package's on the same numpy inputs.

- The Functions against JAX's ``lstm_seq_fi`` / ``gru_seq_fi`` (their
  Pallas kernels in interpret mode, remat on and off) and
  ``*_seq_fi_reference``, ragged lengths with a length-1 row, both
  directions: outputs and every input gradient for a random cotangent of
  every output.  Tolerance 2e-5 absolute, as rows 5 and 8 (f32 round-off
  of another summation order over up to 7 steps).
- The entries against JAX's on the CPU (the unfused composition, and the
  masked scan for other activations; 2e-5 x max(1, max |ref|), as the
  scan's gradients reach ~15 under tanh gates), and the fused-input route
  taken where the fit predicate says so.
- The fit predicate at the edges where it flips, on an H100's 132 SMs
  and 232,448 bytes of shared memory a block.
- Float64 ``gradcheck`` of both Functions."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.lod import SequenceBatch as TSeq
from paddle_tpu_torch.ops import activations as TA
from paddle_tpu_torch.ops import rnn as TR
from paddle_tpu_torch.ops.kernels import gru as GK
from paddle_tpu_torch.ops.kernels import lstm as LK

JL = importlib.import_module("paddle_tpu.ops.pallas.lstm")
JG = importlib.import_module("paddle_tpu.ops.pallas.gru")
JR = importlib.import_module("paddle_tpu.ops.rnn")
JA = importlib.import_module("paddle_tpu.ops.activations")
JSeq = importlib.import_module("paddle_tpu.core.lod").SequenceBatch

TOL = 2e-5
H100 = (132, 232448)     # SMs, shared-memory bytes a block may opt in to


def lengths(rng, b, t):
    """Ragged lengths in [1, t]: row 0 full, the last row of length 1."""
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 1
    return lens


def inputs(kind, b, t, e, d, seed):
    """numpy inputs of the ``kind`` ("lstm" or "gru") Function, and a
    cotangent of each output."""
    rng = np.random.default_rng(seed)
    f = np.float32
    n = 4 if kind == "lstm" else 3
    lens = lengths(rng, b, t)
    x = dict(x=rng.normal(size=(b, t, e)).astype(f),
             mask=(np.arange(t)[None, :] < lens[:, None]).astype(f),
             lens=lens,
             w_x=(rng.normal(size=(e, n * d)) / np.sqrt(e)).astype(f),
             b=(0.2 * rng.normal(size=n * d)).astype(f),
             h0=(0.5 * rng.normal(size=(b, d))).astype(f))
    if kind == "lstm":
        x["w_h"] = (rng.normal(size=(d, 4 * d)) / np.sqrt(d)).astype(f)
        x["peep"] = (0.3 * rng.normal(size=(3, d))).astype(f)
        x["c0"] = (0.5 * rng.normal(size=(b, d))).astype(f)
        shapes = ((b, t, d), (b, d), (b, d))
    else:
        x["w_h"] = (rng.normal(size=(d, 2 * d)) / np.sqrt(d)).astype(f)
        x["w_hc"] = (rng.normal(size=(d, d)) / np.sqrt(d)).astype(f)
        shapes = ((b, t, d), (b, d))
    x["ct"] = [rng.normal(size=s).astype(f) for s in shapes]
    return x


DIFF = {"lstm": ("x", "w_x", "b", "w_h", "peep", "h0", "c0"),
        "gru": ("x", "w_x", "b", "w_h", "w_hc", "h0")}


def _flat(kind, out):
    """The outputs as a flat tuple: (hs, h_T, c_T) or (hs, h_T)."""
    return (out[0], *out[1]) if kind == "lstm" else tuple(out)


def jax_run(kind, x, reverse, remat=None):
    """Outputs and the gradients of DIFF of JAX's kernel (remat True or
    False, interpret mode) or, with remat None, of its reference."""
    mod = JL if kind == "lstm" else JG
    m = jnp.asarray(x["mask"])

    def f(xx, *w):
        if remat is None:
            out = getattr(mod, f"{kind}_seq_fi_reference")(xx, m, *w,
                                                           reverse)
        else:
            out = getattr(mod, f"{kind}_seq_fi")(xx, m, *w, reverse, True,
                                                 remat)
        return _flat(kind, out)

    out, vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in DIFF[kind]))
    grads = vjp(tuple(jnp.asarray(c) for c in x["ct"]))
    return [np.asarray(v) for v in (*out, *grads)]


def torch_run(kind, x, reverse, remat=None, dtype=torch.float32):
    """Outputs and the gradients of DIFF of the port's Function (remat
    True or False) or, with remat None, of its reference."""
    mod = LK if kind == "lstm" else GK
    leaves = [torch.tensor(x[k], dtype=dtype).requires_grad_()
              for k in DIFF[kind]]
    mask = torch.tensor(x["mask"], dtype=dtype)
    if remat is None:
        out = getattr(mod, f"{kind}_seq_fi_reference")(leaves[0], mask,
                                                       *leaves[1:], reverse)
    else:
        out = getattr(mod, f"{kind}_seq_fi")(leaves[0], mask, *leaves[1:],
                                             reverse=reverse, remat=remat)
    outs = _flat(kind, out)
    grads = torch.autograd.grad(outs, leaves, [torch.tensor(c, dtype=dtype)
                                               for c in x["ct"]])
    return [v.detach().numpy() for v in (*outs, *grads)]


def names(kind):
    outs = ("hs", "h_T", "c_T") if kind == "lstm" else ("hs", "h_T")
    return outs + tuple("d" + k for k in DIFF[kind])


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("b,t,e,d", [(3, 7, 12, 8), (5, 4, 8, 16),
                                     (2, 1, 4, 8)])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_input_function_matches_jax(kind, b, t, e, d, reverse):
    x = inputs(kind, b, t, e, d, seed=b * 1000 + t * 100 + e * 10 + d)
    want_ref = jax_run(kind, x, reverse)
    mine_ref = torch_run(kind, x, reverse)
    for remat in (False, True):
        got = torch_run(kind, x, reverse, remat)
        for want in (jax_run(kind, x, reverse, remat), want_ref, mine_ref):
            for name, g, w in zip(names(kind), got, want):
                assert g.shape == w.shape, name
                np.testing.assert_allclose(g, w, atol=TOL, rtol=0,
                                           err_msg=f"{name} remat={remat}")


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_frozen_rows_keep_their_state(kind):
    """A row past its length keeps its state (the reverse direction holds
    h0 through its padded tail) and its outputs take no gradient."""
    x = inputs(kind, 3, 6, 4, 8, seed=2)
    x["mask"][1] = [1, 1, 0, 0, 0, 0]
    for reverse in (False, True):
        hs, h_t = torch_run(kind, x, reverse, True)[:2]
        if reverse:
            assert np.array_equal(hs[1, 2:], np.repeat(x["h0"][1:2], 4, 0))
            assert np.array_equal(h_t[1], hs[1, 0])
        else:
            assert np.array_equal(hs[1, 2:], np.repeat(hs[1, 1:2], 4, 0))
            assert np.array_equal(h_t[1], hs[1, 1])


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("remat", [False, True])
def test_fused_input_function_float64_gradcheck(kind, remat):
    b, t, e, d = 2, 3, 4, 2
    x = inputs(kind, b, t, e, d, seed=4)
    mask = torch.tensor([[1, 1, 1], [1, 0, 0]], dtype=torch.float64)
    leaves = [torch.tensor(x[k], dtype=torch.float64).requires_grad_()
              for k in DIFF[kind]]
    fn = LK.lstm_seq_fi if kind == "lstm" else GK.gru_seq_fi
    for reverse in (False, True):
        assert torch.autograd.gradcheck(
            lambda xx, *w: _flat(kind, fn(xx, mask, *w, reverse=reverse,
                                          remat=remat)),
            leaves, fast_mode=True)


def test_fused_input_twin_projects_step_by_step():
    """The forward twins compute each step's x_t @ W_x + b inside the
    loop: equal to the sequence twin over the projected input within f32
    round-off, and their stored slab feeds the stored-gates backward."""
    for kind, mod in (("lstm", LK), ("gru", GK)):
        x = inputs(kind, 4, 5, 12, 8, seed=6)
        t = {k: torch.from_numpy(v) for k, v in x.items()
             if k not in ("ct", "lens")}
        w = ([t["w_h"], t["peep"], t["h0"], t["c0"]] if kind == "lstm"
             else [t["w_h"], t["w_hc"], t["h0"]])
        for reverse in (False, True):
            got = mod._fi_fwd_plain(t["x"], t["mask"], t["w_x"], t["b"], *w,
                                    reverse, True)
            xw = LK._project_xw(t["x"], t["w_x"], t["b"])
            want = mod._fwd_plain(xw, t["mask"], *w, reverse, True)
            for g, v in zip(got, want):
                np.testing.assert_allclose(g.numpy(), v.numpy(), atol=1e-6,
                                           rtol=0)


# -- the entries of ops/rnn ---------------------------------------------------

ACTS = [("sigmoid", "tanh"), ("sigmoid", "relu"), ("tanh", "tanh")]


def entry_inputs(kind, b, t, e, d, seed):
    x = inputs(kind, b, t, e, d, seed)
    w = (["w_x", "w_h", "b"] if kind == "lstm"
         else ["w_x", "w_h", "w_hc", "b"])
    return x, w


def jax_entry(kind, x, w, reverse, acts, bias, init):
    ga, sa = (getattr(JA, a) for a in acts)
    lens = jnp.asarray(x["lens"].astype(np.int32))

    def f(xx, *ws):
        kw = dict(zip(w, ws))
        b = kw.pop("b") if bias else None
        kw.pop("b", None)
        if kind == "lstm":
            st = (JR.LSTMState(h=jnp.asarray(x["h0"]), c=jnp.asarray(x["c0"]))
                  if init else None)
            out, last = JR.lstm(JSeq(xx, lens), kw["w_x"], kw["w_h"], b,
                                reverse, ga, sa, st)
            return out.data, last.h, last.c
        st = jnp.asarray(x["h0"]) if init else None
        out, last = JR.gru(JSeq(xx, lens), kw["w_x"], kw["w_h"], kw["w_hc"],
                           b, reverse, ga, sa, st)
        return out.data, last

    args = [jnp.asarray(x["x"])] + [jnp.asarray(x[k]) for k in w]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(tuple(jnp.asarray(c) for c in x["ct"]))
    return [np.asarray(v) for v in (*out, *grads)]


def torch_entry(kind, x, w, reverse, acts, bias, init):
    ga, sa = (getattr(TA, a) for a in acts)
    lens = torch.from_numpy(x["lens"])
    leaves = [torch.from_numpy(x["x"]).requires_grad_()] + [
        torch.from_numpy(x[k]).requires_grad_() for k in w]
    kw = dict(zip(w, leaves[1:]))
    b = kw["b"] if bias else None
    seq = TSeq(leaves[0], lens)
    if kind == "lstm":
        st = (TR.LSTMState(h=torch.from_numpy(x["h0"]),
                           c=torch.from_numpy(x["c0"])) if init else None)
        out, last = TR.lstm(seq, kw["w_x"], kw["w_h"], b, reverse, ga, sa, st)
        outs = (out.data, last.h, last.c)
    else:
        st = torch.from_numpy(x["h0"]) if init else None
        out, last = TR.gru(seq, kw["w_x"], kw["w_h"], kw["w_hc"], b, reverse,
                           ga, sa, st)
        outs = (out.data, last)
    grads = torch.autograd.grad(outs, leaves,
                                [torch.from_numpy(c) for c in x["ct"]],
                                allow_unused=True)
    return [None if v is None else v.detach().numpy()
            for v in (*outs, *grads)]


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("acts", ACTS)
@pytest.mark.parametrize("reverse", [False, True])
def test_entry_matches_jax_on_the_cpu(kind, acts, reverse):
    """``ops/rnn.lstm`` / ``gru`` against the JAX package's on the CPU:
    the projection and the sequence Function for the standard
    activations, the masked scan for others; with and without a bias and
    an initial state."""
    x, w = entry_inputs(kind, 4, 6, 12, 8, seed=len(kind) + 7 * reverse)
    for bias, init in ((True, True), (False, False)):
        got = torch_entry(kind, x, w, reverse, acts, bias, init)
        want = jax_entry(kind, x, w, reverse, acts, bias, init)
        for i, (g, v) in enumerate(zip(got, want)):
            if g is None:       # the bias of a run without one
                assert not bias and not np.any(v)
                continue
            np.testing.assert_allclose(
                g, v, atol=TOL * max(1.0, np.abs(v).max()), rtol=0,
                err_msg=f"output {i}, bias={bias}")


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("reverse", [False, True])
def test_fi_entry_matches_jax(kind, reverse):
    """``ops/rnn.lstm_fi`` / ``gru_fi`` against the JAX package's (its
    fused-input kernel in interpret mode, remat on): outputs and every
    input gradient, with a bias and without one."""
    x = inputs(kind, 3, 5, 8, 8, seed=11 + reverse)
    lens = x["lens"]
    names_w = (["w_x", "w_h", "b"] if kind == "lstm"
               else ["w_x", "w_h", "w_hc", "b"])
    for bias in (True, False):
        def jf(xx, *ws):
            kw = dict(zip(names_w, ws))
            b = kw["b"] if bias else None
            seq = JSeq(xx, jnp.asarray(lens.astype(np.int32)))
            if kind == "lstm":
                st = JR.LSTMState(h=jnp.asarray(x["h0"]),
                                  c=jnp.asarray(x["c0"]))
                out, last = JR.lstm_fi(seq, kw["w_x"], b, kw["w_h"], st,
                                       reverse=reverse)
                return out.data, last.h, last.c
            out, last = JR.gru_fi(seq, kw["w_x"], b, kw["w_h"], kw["w_hc"],
                                  jnp.asarray(x["h0"]), reverse=reverse)
            return out.data, last

        args = [jnp.asarray(x["x"])] + [jnp.asarray(x[k]) for k in names_w]
        out, vjp = jax.vjp(jf, *args)
        want = [np.asarray(v) for v in
                (*out, *vjp(tuple(jnp.asarray(c) for c in x["ct"])))]

        leaves = [torch.from_numpy(x["x"]).requires_grad_()] + [
            torch.from_numpy(x[k]).requires_grad_() for k in names_w]
        kw = dict(zip(names_w, leaves[1:]))
        b = kw["b"] if bias else None
        seq = TSeq(leaves[0], torch.from_numpy(lens))
        if kind == "lstm":
            st = TR.LSTMState(h=torch.from_numpy(x["h0"]),
                              c=torch.from_numpy(x["c0"]))
            out, last = TR.lstm_fi(seq, kw["w_x"], b, kw["w_h"], st,
                                   reverse=reverse)
            outs = (out.data, last.h, last.c)
        else:
            out, last = TR.gru_fi(seq, kw["w_x"], b, kw["w_h"], kw["w_hc"],
                                  torch.from_numpy(x["h0"]), reverse=reverse)
            outs = (out.data, last)
        grads = torch.autograd.grad(outs, leaves,
                                    [torch.from_numpy(c) for c in x["ct"]],
                                    allow_unused=True)
        for i, (g, v) in enumerate(zip((*outs, *grads), want)):
            if g is None:
                assert not bias and not np.any(v)
                continue
            np.testing.assert_allclose(g.detach().numpy(), v, atol=TOL,
                                       rtol=0, err_msg=f"{i} bias={bias}")


# -- the fit predicate and the route ------------------------------------------


@pytest.mark.parametrize("mod,fits,refused,why", [
    # shared memory: (E + D) 4U floats with two staging chunks (LSTM),
    # 3 (E + D) U with three (GRU), at D 512 (U 4)
    (LK, (2832, 512), (2836, 512), "shared memory"),
    (GK, (3752, 512), (3756, 512), "shared memory"),
    # the units a block: 8 GRU units on each of 132 SMs
    (GK, (4, 1056), (4, 1060), "units a block"),
    # 16-byte copies
    (LK, (128, 512), (130, 512), "multiple of 4"),
    (GK, (512, 512), (512, 514), "multiple of 4"),
])
def test_fit_predicate_flips_at_the_edge(mod, fits, refused, why):
    assert mod._fi_refusal(*fits, *H100) is None
    reason = mod._fi_refusal(*refused, *H100)
    assert reason is not None and why in reason


def test_lstm_fit_predicate_counts_the_units():
    """The LSTM tiling covers 16 units a block: at 8 SMs D 128 fits and
    D 132 does not (a card of few SMs, where the units bind first)."""
    assert LK._fi_refusal(4, 128, 8, 10 ** 7) is None
    assert "units a block" in LK._fi_refusal(4, 132, 8, 10 ** 7)


def test_smem_plan_mirrors_the_kernel():
    """``_smem_floats`` is csrc/lstm_seq.cu's ``Plan``: at the text
    classifier's D 1280 (U 10) W_h's slice and three staging chunks fill
    the opt-in exactly."""
    assert 4 * LK._smem_floats(1280, 10, 3) == H100[1]
    assert LK._smem_floats(10, 1, 2) == 10 * 4 + 2 * 64 * 36


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_route_follows_the_predicate(kind, monkeypatch):
    """With the routing on (as on the card) and an H100's tiling, the entry
    takes the fused-input Function exactly where the predicate says: at
    the shared-memory edge it does, one E past it the projection and the
    sequence Function run instead.  CPU tensors take the twins, so the
    two routes' outputs agree."""
    mod = LK if kind == "lstm" else GK
    e_fit = 2832 if kind == "lstm" else 3752
    monkeypatch.setattr(TR, "fused_input_on", lambda device: True)
    monkeypatch.setattr(mod, "_card", lambda device: H100)
    calls = []
    for name in (f"{kind}_seq_fi", f"{kind}_seq"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(3)
    d, n = 512, (4 if kind == "lstm" else 3)
    for e, want in ((e_fit, f"{kind}_seq_fi"), (e_fit + 4, f"{kind}_seq")):
        calls.clear()
        x = TSeq(torch.from_numpy(rng.normal(size=(1, 2, e)).astype(np.float32)),
                 torch.tensor([2]))
        w_x = torch.from_numpy((rng.normal(size=(e, n * d)) / e ** 0.5)
                               .astype(np.float32))
        w_h = torch.from_numpy((rng.normal(size=(d, (4 if kind == "lstm"
                                                     else 2) * d))
                                / d ** 0.5).astype(np.float32))
        if kind == "lstm":
            out, _ = TR.lstm(x, w_x, w_h, None)
        else:
            w_hc = torch.from_numpy((rng.normal(size=(d, d)) / d ** 0.5)
                                    .astype(np.float32))
            out, _ = TR.gru(x, w_x, w_h, w_hc, None)
        assert calls == [want]
        assert out.data.shape == (1, 2, d) and torch.isfinite(out.data).all()
