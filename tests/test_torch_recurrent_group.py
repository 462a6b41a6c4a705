"""The port's ``recurrent_group`` / ``memory`` / ``gru_step_layer``,
``mixed`` projections, ``slice``, ``grumemory`` and ``bigru`` layers and
``networks.simple_gru2`` against the JAX package's, each built the same
way in both packages and run on the same numpy feed and carried
parameters: the cases of ``tests/test_recurrent_group.py`` (cumsum,
``memory`` boot, reverse, the sunk tail against the per-step loop, the
logits cross-entropy against the probs one, a static-input tail that must
not sink) and the lone-``gru_step`` group that runs the GRU kernel.

Tolerance 2e-6 absolute relative to the largest entry (f32 round-off of
another summation order; measured 1.2e-7 at worst); configs and
parameter names equal."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.core.lod import SequenceBatch as JSeq
from paddle_tpu.layers.base import reset_name_counters as jax_reset
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.core.lod import SequenceBatch as TSeq
from paddle_tpu_torch.layers import recurrent_group as TRG
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.ops.kernels import gru as GK

JRG = importlib.import_module("paddle_tpu.layers.recurrent_group")
TOL = 2e-6


@pytest.fixture(autouse=True)
def _fresh_names():
    reset_name_counters()
    jax_reset()
    yield


class Pkg:
    """One package's layer modules under common names."""

    def __init__(self, root):
        imp = importlib.import_module
        self.layer = imp(f"{root}.layers.api")
        self.act = imp(f"{root}.layers.activation")
        self.dt = imp(f"{root}.layers.data_type")
        self.mixed = imp(f"{root}.layers.mixed")
        self.rg = imp(f"{root}.layers.recurrent_group")
        self.nets = imp(f"{root}.layers.networks")
        self.attr = imp(f"{root}.layers.attr")
        self.jax = root == "paddle_tpu"


JP, TP = Pkg("paddle_tpu"), Pkg("paddle_tpu_torch")


def seq(pkg, data, lens):
    if pkg.jax:
        return JSeq(jnp.asarray(data), jnp.asarray(np.asarray(lens, np.int32)))
    return TSeq(torch.from_numpy(np.asarray(data)),
                torch.from_numpy(np.asarray(lens, np.int64)))


def dense(pkg, x):
    return jnp.asarray(x) if pkg.jax else torch.from_numpy(np.asarray(x))


def value(v):
    """numpy of a layer value (the data of a sequence)."""
    v = getattr(v, "data", v)
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def both(build, feed_np, seed=0):
    """Build ``build(pkg)`` -> output node(s) in both packages, carry the JAX
    package's initial parameters (biases made nonzero) to the port, run
    both forwards on the feed ``feed_np(pkg)`` and return (jax topology,
    port topology, jax values, port values, carried params)."""
    jax_reset()
    jout = build(JP)
    reset_name_counters()
    tout = build(TP)
    jtopo, ttopo = JTopology(jout), TTopology(tout)
    assert ttopo.serialize() == jtopo.serialize()
    carried = {}
    if jtopo.param_specs():
        jparams = jpaddle.parameters.create(jtopo)
        rng = np.random.default_rng(seed)
        for n in jparams.names():
            carried[n] = np.asarray(jparams[n])
            if "bias" in n:
                carried[n] = (0.1 * rng.normal(size=carried[n].shape)
                              ).astype(np.float32)
    jvals, _ = jtopo.forward({n: jnp.asarray(v) for n, v in carried.items()},
                             {}, feed_np(JP), False, jax.random.key(0))
    tvals, _ = ttopo.forward({n: torch.tensor(v)
                              for n, v in carried.items()},
                             {}, feed_np(TP), False)
    return jtopo, ttopo, jvals, tvals, carried


def close(got, want, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0,
                               err_msg=what)


def accumulator(pkg, d, reverse=False, with_boot=False):
    """``step out = x_t + out_{t-1}``: the masked cumulative sum."""
    x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(d))
    boot = (pkg.layer.data(name="boot", type=pkg.dt.dense_vector(d))
            if with_boot else None)

    def step(xt):
        mem = pkg.rg.memory(name="acc", size=d, boot_layer=boot)
        return pkg.mixed.mixed(size=d, name="acc", input=[
            pkg.mixed.identity_projection(xt),
            pkg.mixed.identity_projection(mem)])

    return pkg.rg.recurrent_group(step=step, input=x, reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_group_cumsum_semantics(reverse):
    d = 4
    data = np.random.RandomState(0).randn(2, 5, d).astype(np.float32)
    _, _, jv, tv, _ = both(lambda p: accumulator(p, d, reverse),
                           lambda p: {"x": seq(p, data, [5, 3])})
    got, want = value(tv["acc"]), value(jv["acc"])
    close(got, want)
    if reverse:
        np.testing.assert_allclose(
            got[0], np.cumsum(data[0][::-1], axis=0)[::-1], rtol=1e-5)
    else:
        np.testing.assert_allclose(got[0], np.cumsum(data[0], axis=0),
                                   rtol=1e-5)
        np.testing.assert_allclose(got[1, :3], np.cumsum(data[1, :3], axis=0),
                                   rtol=1e-5)


def test_memory_boot_layer():
    d = 3
    data = np.ones((1, 2, d), np.float32)
    _, _, jv, tv, _ = both(
        lambda p: accumulator(p, d, with_boot=True),
        lambda p: {"x": seq(p, data, [2]),
                   "boot": dense(p, np.full((1, d), 10.0, np.float32))})
    got = value(tv["acc"])
    close(got, value(jv["acc"]))
    np.testing.assert_allclose(got[0, 0], 11.0)
    np.testing.assert_allclose(got[0, 1], 12.0)


def nmt_decoder(pkg, vocab=11, d=6, sink=True):
    """The NMT decoder pattern (simple_attention + gru_step -> softmax fc)
    over a dense encoder sequence and target sequence, with its cost."""
    L, A, M = pkg.layer, pkg.act, pkg.mixed
    pkg.rg.SINK_SCAN_TAIL = sink
    enc = L.data(name="enc", type=pkg.dt.dense_vector_sequence(2 * d))
    trg = L.data(name="trg", type=pkg.dt.dense_vector_sequence(d))
    proj = M.mixed(size=d, name="proj",
                   input=M.full_matrix_projection(enc, size=d))
    boot = M.mixed(size=d, act=A.TanhActivation(), name="boot",
                   input=M.full_matrix_projection(L.first_seq(input=enc),
                                                  size=d))

    def step(e, p, w):
        mem = pkg.rg.memory(name="dec", size=d, boot_layer=boot)
        ctx = pkg.nets.simple_attention(encoded_sequence=e, encoded_proj=p,
                                        decoder_state=mem, name="att")
        # named parameters: the JAX package's projections keep the
        # name they were bound with, before the group renames its layers
        P = pkg.attr.ParamAttr
        inp = M.mixed(size=3 * d, name="inp", input=[
            M.full_matrix_projection(ctx, size=3 * d,
                                     param_attr=P(name="_inp_ctx.w")),
            M.full_matrix_projection(w, size=3 * d,
                                     param_attr=P(name="_inp_word.w"))])
        g = pkg.rg.gru_step_layer(name="dec", input=inp, output_mem=mem,
                                  size=d)
        return L.fc(input=g, size=vocab, act=A.SoftmaxActivation(),
                    name="prob")

    group = pkg.rg.recurrent_group(
        name="dg", step=step, input=[pkg.rg.StaticInput(enc, is_seq=True),
                                     pkg.rg.StaticInput(proj, is_seq=True),
                                     trg])
    lbl = L.data(name="lbl", type=pkg.dt.integer_value_sequence(vocab))
    return L.classification_cost(input=group, label=lbl)


def decoder_feed(rng=None, b=3, t=5, d=6, vocab=11):
    rng = rng or np.random.default_rng(1)
    enc = rng.normal(size=(b, t + 1, 2 * d)).astype(np.float32)
    trg = rng.normal(size=(b, t, d)).astype(np.float32)
    lbl = rng.integers(0, vocab, size=(b, t))
    return lambda p: {"enc": seq(p, enc, [t + 1, 3, 1][:b]),
                      "trg": seq(p, trg, [t, 4, 2][:b]),
                      "lbl": seq(p, lbl, [t, 4, 2][:b])}


def cost_and_grads(pkg, topo, cost, carried, feed):
    """The train-mode cost and its gradient by parameter name."""
    if pkg.jax:
        def f(p):
            vals, _ = topo.forward(p, {}, feed, True, jax.random.key(0))
            return vals[cost.name]

        c, g = jax.value_and_grad(f)({n: jnp.asarray(v)
                                      for n, v in carried.items()})
        return float(c), {n: np.asarray(v) for n, v in g.items()}
    params = {n: torch.tensor(v).requires_grad_() for n, v in carried.items()}
    vals, _ = topo.forward(params, {}, feed, True)
    c = vals[cost.name]
    g = torch.autograd.grad(c, list(params.values()))
    return c.item(), {n: v.numpy() for n, v in zip(params, g)}


@pytest.mark.parametrize("sink", [True, False])
def test_decoder_group_cost_and_grads_match_jax(sink):
    """The NMT decoder step with and without the sunk tail: the group's
    forward and the cost's gradients against the JAX package's."""
    try:
        feed = decoder_feed()
        jtopo, ttopo, jv, tv, carried = both(
            lambda p: nmt_decoder(p, sink=sink), feed)
        jcost, tcost = jtopo.outputs[0], ttopo.outputs[0]
        close(np.float32(tv[tcost.name].item()), np.float32(jv[jcost.name]))
        close(value(tv["prob"]), value(jv["prob"]), "probs")
        jc, jg = cost_and_grads(JP, jtopo, jcost, carried, feed(JP))
        tc, tg = cost_and_grads(TP, ttopo, tcost, carried, feed(TP))
        np.testing.assert_allclose(tc, jc, rtol=2e-6)
        for n in carried:
            assert np.abs(jg[n]).max() > 0, n
            close(tg[n], jg[n], n)
    finally:
        JRG.SINK_SCAN_TAIL = TRG.SINK_SCAN_TAIL = True


def test_tail_sink_equals_the_per_step_loop():
    """The sunk tail (one product over the stacked steps) against the
    per-step application of the same graph: cost and every gradient."""
    feed = decoder_feed()
    runs = {}
    try:
        for sink in (True, False):
            reset_name_counters()
            cost = nmt_decoder(TP, sink=sink)
            topo = TTopology(cost)
            if not runs:
                jax_reset()
                carried = {n: np.asarray(v) for n, v in
                           jpaddle.parameters.create(JTopology(
                               nmt_decoder(JP))).as_dict().items()}
            runs[sink] = cost_and_grads(TP, topo, cost, carried, feed(TP))
    finally:
        JRG.SINK_SCAN_TAIL = TRG.SINK_SCAN_TAIL = True
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6)
    for n, g in runs[False][1].items():
        np.testing.assert_allclose(runs[True][1][n], g, rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_logits_cross_entropy_equals_the_probs_path():
    """classification_cost on the group's logits (the sunk softmax fc's
    ``__fc_logits__`` through the group) against -log(probs[label]) over
    the valid steps, on the port alone."""
    reset_name_counters()
    cost = nmt_decoder(TP)
    group = cost.parents[0]
    assert cost.parents[-1].name.endswith("#logits")
    topo = TTopology(cost)
    params = tpaddle.parameters.create(topo).as_dict()
    feed = decoder_feed()(TP)
    vals, _ = topo.forward(params, {}, feed, True)
    probs, lbl = value(vals[group.name]), feed["lbl"]
    mask = lbl.mask().numpy()
    picked = np.take_along_axis(probs, lbl.data.numpy()[..., None], -1)[..., 0]
    want = float((-np.log(picked) * mask).sum() / mask.sum())
    np.testing.assert_allclose(vals[cost.name].item(), want, rtol=1e-5)


def static_tail(pkg):
    L, A = pkg.layer, pkg.act
    sq = L.data(name="stx", type=pkg.dt.dense_vector_sequence(4))
    outer = L.fc(input=L.first_seq(input=sq), size=4,
                 act=A.TanhActivation(), name="outer_ctx")

    def step(s_t, ctx_static):
        mem = pkg.rg.memory(name="st_step", size=4)
        h = L.fc(input=[s_t, mem], size=4, act=A.TanhActivation(),
                 name="st_step")
        # the tail reads the recurrence's value and the static input
        return L.fc(input=[h, ctx_static], size=3,
                    act=A.SoftmaxActivation())

    return pkg.rg.recurrent_group(step=step,
                                  input=[sq, pkg.rg.StaticInput(outer)],
                                  name="static_tail_group")


def test_sink_rejects_a_static_input_tail():
    data = np.random.default_rng(0).normal(size=(2, 5, 4)).astype(np.float32)
    _, ttopo, jv, tv, _ = both(static_tail,
                               lambda p: {"stx": seq(p, data, [5, 3])})
    group = ttopo.outputs[0]
    assert "__fc_logits__" not in group.attrs      # the tail did not sink
    got = value(tv[group.name])
    assert got.shape == (2, 5, 3)
    np.testing.assert_allclose(got.sum(-1)[0, 0], 1.0, rtol=1e-5)
    close(got, value(jv[group.name]))


def test_recurrent_group_refuses_several_outputs():
    """A step returning more than one layer is refused while the group is
    built: several outputs come with generation."""
    from paddle_tpu_torch.core.enforce import EnforceError

    M = TP.mixed
    x = TP.layer.data(name="x", type=TP.dt.dense_vector_sequence(3))

    def step(xt):
        mem = TP.rg.memory(name="acc", size=3)
        acc = M.mixed(size=3, name="acc", input=[
            M.identity_projection(xt), M.identity_projection(mem)])
        return [acc, M.mixed(size=3, name="twice", input=[
            M.identity_projection(acc), M.identity_projection(acc)])]

    with pytest.raises(EnforceError, match="one LayerOutput"):
        TP.rg.recurrent_group(step=step, input=x, name="two")


def lone_gru_step(pkg, d=8, reverse=False):
    """A group whose step is one standard gru_step on its memory (the
    ``networks.simple_gru`` form), which runs the GRU sequence kernel."""
    x = pkg.layer.data(name="gx", type=pkg.dt.dense_vector_sequence(3 * d))

    def step(xt):
        mem = pkg.rg.memory(name="g", size=d)
        return pkg.rg.gru_step_layer(input=xt, output_mem=mem, size=d,
                                     name="g")

    return pkg.rg.recurrent_group(step=step, input=x, reverse=reverse,
                                  name="gg")


@pytest.mark.parametrize("reverse", [False, True])
def test_lone_gru_step_group_runs_the_kernel_path(reverse, monkeypatch):
    d = 8
    data = np.random.default_rng(2).normal(size=(3, 6, 3 * d)
                                           ).astype(np.float32)
    feed = lambda p: {"gx": seq(p, data, [6, 2, 1])}  # noqa: E731
    calls = []
    from paddle_tpu_torch.ops import rnn as rnn_ops

    real = rnn_ops.gru_fused
    monkeypatch.setattr(rnn_ops, "gru_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jtopo, ttopo, jv, tv, carried = both(
        lambda p: lone_gru_step(p, d, reverse), feed)
    assert calls == [1]
    name = ttopo.outputs[0].name
    got = value(tv[name])
    close(got, value(jv[name]))
    # the kernel path is the plain scan of the same cell and bias
    w = torch.tensor(carried["_g@gg.w0"])
    want, _ = GK.gru_seq_reference(
        torch.from_numpy(data) + torch.tensor(carried["_g@gg.wbias"]),
        feed(TP)["gx"].mask(), w[:, :2 * d], w[:, 2 * d:],
        torch.zeros(3, d), reverse)
    close(got, want.numpy())


def test_mixed_projections_match_jax():
    """full_matrix_projection and identity_projection (with and without an
    offset), the functional and the ``with`` forms, bias and activation."""
    def build(pkg):
        M, L = pkg.mixed, pkg.layer
        x = L.data(name="mx", type=pkg.dt.dense_vector_sequence(6))
        y = L.data(name="my", type=pkg.dt.dense_vector_sequence(4))
        a = M.mixed(size=4, bias_attr=True, act=pkg.act.TanhActivation(),
                    input=[M.full_matrix_projection(x, size=4),
                           M.identity_projection(y),
                           M.identity_projection(x, offset=2, size=4)])
        with M.mixed(size=4, name="inc") as m:
            m += M.full_matrix_projection(input=a)
        return m

    rng = np.random.default_rng(3)
    xd, yd = (rng.normal(size=(2, 3, n)).astype(np.float32) for n in (6, 4))
    jtopo, ttopo, jv, tv, carried = both(
        build, lambda p: {"mx": seq(p, xd, [3, 2]), "my": seq(p, yd, [3, 2])})
    assert sorted(carried) == ["___mixed_0__.w0", "___mixed_0__.wbias",
                               "_inc.w0"]
    close(value(tv["inc"]), value(jv["inc"]))
    with pytest.raises(NotImplementedError):
        TP.mixed.table_projection(None)


def test_slice_grumemory_and_bigru_match_jax():
    """``layer.slice``, ``layer.grumemory`` (both directions, and a
    non-standard activation on the plain scan) and ``layer.bigru``: names,
    shapes and values."""
    d, e = 4, 6

    def build(pkg):
        L, A = pkg.layer, pkg.act
        x = L.data(name="x", type=pkg.dt.dense_vector_sequence(e))
        bi = L.bigru(input=x, size=d, name="bi")
        sl = L.slice(input=bi, start=d, end=2 * d, name="bi_bw_half")
        fc = L.fc(input=x, size=3 * d, act=A.LinearActivation(), name="t")
        g1 = L.grumemory(input=fc, name="g1")
        g2 = L.grumemory(input=fc, name="g2", reverse=True,
                         act=A.ReluActivation())
        return [bi, sl, g1, g2]

    data = np.random.default_rng(4).normal(size=(3, 5, e)).astype(np.float32)
    jtopo, ttopo, jv, tv, carried = both(
        build, lambda p: {"x": seq(p, data, [5, 3, 1])})
    assert [(s.name, s.shape) for s in ttopo.param_specs()] == [
        ("_bi_fw_transform.w0", (e, 3 * d)), ("_bi_fw_transform.wbias",
                                              (3 * d,)),
        ("_bi_fw.w0", (d, 3 * d)), ("_bi_fw.wbias", (3 * d,)),
        ("_bi_bw_transform.w0", (e, 3 * d)), ("_bi_bw_transform.wbias",
                                              (3 * d,)),
        ("_bi_bw.w0", (d, 3 * d)), ("_bi_bw.wbias", (3 * d,)),
        ("_t.w0", (e, 3 * d)), ("_t.wbias", (3 * d,)),
        ("_g1.w0", (d, 3 * d)), ("_g1.wbias", (3 * d,)),
        ("_g2.w0", (d, 3 * d)), ("_g2.wbias", (3 * d,))]
    for name, width in (("bi", 2 * d), ("bi_bw_half", d), ("g1", d),
                        ("g2", d)):
        got = value(tv[name])
        assert got.shape == (3, 5, width), name
        close(got, value(jv[name]), name)
    assert np.array_equal(value(tv["bi_bw_half"]), value(tv["bi"])[..., d:])


def test_bigru_equals_the_composed_simple_gru2_pair():
    """``layer.bigru`` against the composed fw/bw ``simple_gru2`` pair (a
    mixed transform with bias + ``grumemory``) on the same parameter values,
    forward and every gradient (the JAX package's
    ``test_bigru_layer_node_matches_composed_pair``)."""
    b, t, e, d = 3, 6, 8, 4
    rng = np.random.default_rng(5)
    x = TSeq(torch.from_numpy(rng.normal(size=(b, t, e)).astype(np.float32)),
             torch.tensor([6, 4, 1]))
    ct = torch.from_numpy(rng.normal(size=(b, t, 2 * d)).astype(np.float32))
    L = TP.layer
    inp = L.data(name="x", type=TP.dt.dense_vector_sequence(e))
    node = L.bigru(input=inp, size=d, name="bi")
    topo = TTopology(node)
    params = {n: (0.3 * torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(i)))
              for i, (n, v) in enumerate(
                  tpaddle.parameters.create(topo).as_dict().items())}
    reset_name_counters()
    inp2 = L.data(name="x", type=TP.dt.dense_vector_sequence(e))
    fw = TP.nets.simple_gru2(input=inp2, size=d, name="bi_fw",
                             mixed_bias_attr=True)
    bw = TP.nets.simple_gru2(input=inp2, size=d, name="bi_bw", reverse=True,
                             mixed_bias_attr=True)
    topo2 = TTopology([fw, bw])
    assert sorted(s.name for s in topo2.param_specs()) == sorted(params)

    def run(topology, outs):
        leaves = {n: v.clone().requires_grad_() for n, v in params.items()}
        vals, _ = topology.forward(leaves, {}, {"x": x}, True)
        out = torch.cat([vals[o].data for o in outs], dim=-1)
        g = torch.autograd.grad((out * ct).sum(), list(leaves.values()))
        return out.detach(), dict(zip(leaves, g))

    got, gg = run(topo, ["bi"])
    want, gw = run(topo2, ["bi_fw", "bi_bw"])
    close(got.numpy(), want.numpy())
    for n in params:
        close(gg[n].numpy(), gw[n].numpy(), n)


def test_auto_named_projections_inside_a_group_follow_the_renaming():
    """A group renames the auto-named parameters of its step layers
    (``_inp.w0`` -> ``_inp@g.w0``); the port's projections read the name
    when they run, so such a step evaluates and trains (the JAX package's
    keep the name they were bound with and raise ``KeyError``)."""
    L, M = TP.layer, TP.mixed
    x = L.data(name="ax", type=TP.dt.dense_vector_sequence(4))

    def step(xt):
        mem = TP.rg.memory(name="inp", size=4)
        return M.mixed(size=4, name="inp", act=TP.act.TanhActivation(),
                       input=[M.full_matrix_projection(xt, size=4),
                              M.full_matrix_projection(mem, size=4)])

    group = TP.rg.recurrent_group(step=step, input=x, name="g")
    topo = TTopology(group)
    assert [s.name for s in topo.param_specs()] == ["_inp@g.w0", "_inp@g.w1"]
    params = {n: v.requires_grad_() for n, v in
              tpaddle.parameters.create(topo).as_dict().items()}
    data = np.random.default_rng(6).normal(size=(2, 3, 4)).astype(np.float32)
    vals, _ = topo.forward(params, {}, {"ax": seq(TP, data, [3, 2])}, True)
    grads = torch.autograd.grad(vals["inp"].data.sum(), list(params.values()))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
