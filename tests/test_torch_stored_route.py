"""The route rule of the one-direction recurrences' backward
(``paddle_tpu_torch/ops/rnn.py``: ``stored_slab_fits``, ``backward_remat``)
and the layers that take it (``lstmemory``, ``grumemory``) against the
JAX package.

The rule: with ``remat=None`` on the card, ``lstm_fused`` and
``gru_fused`` keep the forward's gates slab for the backward where the
slab (B x T x G.D x the io dtype's bytes) takes at most a quarter of the
memory still open to the process, else they recompute the gates (remat);
CPU tensors keep the stored form; an explicit ``remat`` is honoured.
Here the card is faked (``on_card`` and ``card_memory_open``
monkeypatched) and the CPU twins run the form the rule picks, which the
backward's twin records.

The layers: ``fc`` -> ``lstmemory`` and ``fc`` -> ``grumemory`` (reverse)
in both packages from the same carried parameters and feed, ragged with a
length-1 row; the port in each form against the JAX package (its Pallas
kernels in interpret mode, remat off as it runs off the TPU): outputs and
every parameter gradient within 2e-6 x max(1, the largest entry) (the
tolerance of ``test_torch_recurrent_group.py`` and
``test_torch_text_train.py``; f32 round-off of another summation order),
and the two forms equal in bits."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.core.lod import SequenceBatch as JSeq
from paddle_tpu.layers.base import reset_name_counters as jax_reset
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.core.lod import SequenceBatch as TSeq
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.ops.kernels import gru as GK
from paddle_tpu_torch.ops.kernels import lstm as LK

TOL = 2e-6
MB = 1 << 20


@pytest.fixture(autouse=True)
def _fresh_names():
    reset_name_counters()
    jax_reset()
    yield


# -- the rule as a pure function ----------------------------------------------


@pytest.mark.parametrize("gates,b,t,d,dtype,want", [
    (4, 64, 128, 1280, torch.float32, 160 * MB),    # the text LSTM: 168 MB
    (4, 64, 128, 1280, torch.bfloat16, 80 * MB),
    (3, 64, 32, 512, torch.float32, 12 * MB),       # the NMT-width GRU
    (3, 64, 32, 512, torch.bfloat16, 6 * MB),
    (4, 3, 5, 8, torch.float32, 1920),
    (3, 3, 5, 8, torch.bfloat16, 720)])
def test_slab_bytes_and_the_rule_at_and_across_its_boundary(gates, b, t, d,
                                                            dtype, want):
    """B x T x G.D x the io dtype's bytes; stored at exactly 4 x the slab
    open (the stated share, a quarter), remat one byte below, stored
    above; a card with nothing open takes remat."""
    slab = R.gates_slab_bytes(b, t, gates, d, dtype)
    assert slab == want
    assert R.STORED_SLAB_SHARE == 0.25
    assert R.stored_slab_fits(slab, 4 * slab)
    assert not R.stored_slab_fits(slab, 4 * slab - 1)
    assert R.stored_slab_fits(slab, 80 << 30)
    assert not R.stored_slab_fits(slab, 0)


# -- lstm_fused / gru_fused follow it -----------------------------------------


def _fake_card(monkeypatch, open_bytes):
    """Make ``ops.rnn`` see a card with ``open_bytes`` open (the CPU
    tensors still take the twins)."""
    monkeypatch.setattr(R, "on_card", lambda device: True)
    monkeypatch.setattr(R, "card_memory_open", lambda device: open_bytes)


def _forms(monkeypatch, mod):
    """The backward forms the twin of ``mod`` (kernels/lstm or
    kernels/gru) runs, in order (True: remat)."""
    seen, plain = [], mod._bwd_plain

    def spy(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(mod, "_bwd_plain", spy)
    return seen


def _run_fused(kind, dtype, remat, seed=3):
    """One forward and backward of ``lstm_fused`` / ``gru_fused`` at B 3,
    T 5, D 8 (ragged, a length-1 row) on the CPU; returns the outputs and
    the input gradients."""
    rng = np.random.default_rng(seed)
    b, t, d = 3, 5, 8
    g = {"lstm": 4, "gru": 3}[kind]
    lens = torch.tensor([5, 3, 1])

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32)).to(dtype)

    leaves = [v.requires_grad_() for v in (
        rnd(b, t, g * d, scale=0.5), rnd(d, g * d, scale=d ** -0.5),
        rnd(b, d, scale=0.5))]
    xw = TSeq(leaves[0], lens)
    if kind == "lstm":
        out, last = R.lstm_fused(xw, leaves[1],
                                 R.LSTMState(h=leaves[2], c=leaves[2].float()),
                                 remat=remat)
        last = list(last)
    else:
        out, h_t = R.gru_fused(xw, leaves[1][:, :2 * d], leaves[1][:, 2 * d:],
                               leaves[2], remat=remat)
        last = [h_t]
    loss = out.data.float().sum() + sum(v.float().sum() for v in last)
    return [out.data, *last, *torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_fused_entries_follow_the_rule_on_a_faked_card(monkeypatch, kind,
                                                       dtype):
    """``remat=None`` takes the form the rule gives for the reading: the
    slab of [3, 5, G.8] in ``dtype`` against 4 x its bytes open (stored)
    and one byte less (remat); an explicit ``remat`` wins over either
    reading; the forms give the same bits."""
    mod = LK if kind == "lstm" else GK
    g = {"lstm": 4, "gru": 3}[kind]
    slab = R.gates_slab_bytes(3, 5, g, 8, dtype)
    seen = _forms(monkeypatch, mod)
    outs = {}
    for open_bytes, remat, want in ((4 * slab, None, False),
                                    (4 * slab - 1, None, True),
                                    (4 * slab, True, True),
                                    (4 * slab - 1, False, False)):
        _fake_card(monkeypatch, open_bytes)
        seen.clear()
        outs[(open_bytes, remat)] = _run_fused(kind, dtype, remat)
        assert seen == [want], (open_bytes, remat)
    first = outs[(4 * slab, None)]
    for got in outs.values():
        assert all(torch.equal(x, y) for x, y in zip(first, got))


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_cpu_tensors_keep_the_stored_form(monkeypatch, kind):
    """Without a card the rule is not asked (no reading is taken): CPU
    tensors keep the stored form, as the JAX package keeps it off the TPU;
    ``remat=True`` still takes remat."""
    mod = LK if kind == "lstm" else GK
    seen = _forms(monkeypatch, mod)

    def no_reading(device):
        raise AssertionError("the card's memory was read for CPU tensors")

    monkeypatch.setattr(R, "card_memory_open", no_reading)
    _run_fused(kind, torch.float32, None)
    _run_fused(kind, torch.float32, True)
    assert seen == [False, True]


# -- lstmemory and grumemory against the JAX package, in both forms -----------


class Pkg:
    def __init__(self, root):
        imp = importlib.import_module
        self.layer = imp(f"{root}.layers.api")
        self.act = imp(f"{root}.layers.activation")
        self.dt = imp(f"{root}.layers.data_type")
        self.jax = root == "paddle_tpu"


JP, TP = Pkg("paddle_tpu"), Pkg("paddle_tpu_torch")
B, T, E, D = 3, 6, 5, 8
LENS = [6, 4, 1]
OUTS = ("lm", "gm")


def build(pkg):
    """``fc`` -> ``lstmemory`` (peepholes, gate biases) and ``fc`` ->
    ``grumemory`` (reverse) over one sequence input."""
    L, A = pkg.layer, pkg.act
    x = L.data(name="x", type=pkg.dt.dense_vector_sequence(E))
    f1 = L.fc(input=x, size=4 * D, act=A.LinearActivation(), name="f1")
    f2 = L.fc(input=x, size=3 * D, act=A.LinearActivation(), name="f2")
    return [L.lstmemory(input=f1, name="lm"),
            L.grumemory(input=f2, name="gm", reverse=True)]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's outputs and parameter gradients, with the carried
    parameters (biases nonzero), the feed and the cotangents."""
    jax_reset()
    jtopo = JTopology(build(JP))
    created = jpaddle.parameters.create(jtopo)
    rng = np.random.default_rng(27)
    params = {}
    for n in created.names():
        params[n] = np.asarray(created[n])
        if "bias" in n:
            params[n] = (0.1 * rng.normal(size=params[n].shape)
                         ).astype(np.float32)
    x = rng.normal(size=(B, T, E)).astype(np.float32)
    cts = {o: rng.normal(size=(B, T, D)).astype(np.float32) for o in OUTS}
    feed = {"x": JSeq(jnp.asarray(x), jnp.asarray(np.int32(LENS)))}

    def loss(p):
        vals, _ = jtopo.forward(p, {}, feed, False, jax.random.key(0))
        return sum(jnp.sum(vals[o].data * cts[o]) for o in OUTS), vals

    jp = {n: jnp.asarray(v) for n, v in params.items()}
    (_, vals), grads = jax.value_and_grad(loss, has_aux=True)(jp)
    want = {o: np.asarray(vals[o].data) for o in OUTS}
    want.update({n: np.asarray(g) for n, g in grads.items()})
    return jtopo, params, x, cts, want


def port_step(params, x, cts):
    """The port's outputs and parameter gradients on the same inputs."""
    reset_name_counters()
    ttopo = TTopology(build(TP))
    leaves = {n: torch.tensor(v, requires_grad=True)
              for n, v in params.items()}
    feed = {"x": TSeq(torch.from_numpy(x), torch.tensor(LENS))}
    vals, _ = ttopo.forward(leaves, {}, feed, False)
    loss = sum((vals[o].data * torch.from_numpy(cts[o])).sum() for o in OUTS)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    got = {o: vals[o].data.detach().numpy() for o in OUTS}
    got.update({n: g.numpy() for n, g in zip(leaves, grads)})
    return ttopo, got


@pytest.mark.parametrize("form", ["stored", "remat"])
def test_lstmemory_and_grumemory_match_jax_in_either_form(monkeypatch,
                                                          jax_side, form):
    """Each form on a faked card (the reading picks it): the topology as
    the JAX package's, hs of both layers and every parameter gradient
    within TOL of JAX's; both backward twins ran the form."""
    jtopo, params, x, cts, want = jax_side
    slab = R.gates_slab_bytes(B, T, 4, D, torch.float32)
    _fake_card(monkeypatch, 4 * slab if form == "stored" else 0)
    seen = {m: _forms(monkeypatch, m) for m in (LK, GK)}
    ttopo, got = port_step(params, x, cts)
    assert ttopo.serialize() == jtopo.serialize()
    assert seen == {LK: [form == "remat"], GK: [form == "remat"]}
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=0, err_msg=n,
                                   atol=TOL * max(1.0, np.abs(w).max()))


def test_lstmemory_and_grumemory_forms_give_the_same_bits(monkeypatch,
                                                          jax_side):
    """The stored and the remat form of both layers, and the CPU's own
    route (no card, stored), give the same outputs and gradients, bit for
    bit."""
    _, params, x, cts, _ = jax_side
    runs = []
    for open_bytes in (1 << 40, 0):
        _fake_card(monkeypatch, open_bytes)
        runs.append(port_step(params, x, cts)[1])
    monkeypatch.undo()
    runs.append(port_step(params, x, cts)[1])
    for other in runs[1:]:
        for n, v in runs[0].items():
            assert np.array_equal(v, other[n]), n
