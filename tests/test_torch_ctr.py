"""The Wide & Deep CTR slice: the row-lazy optimizer contract
(``ParamAttr(sparse_update=True)`` under SGD and Momentum) and
``models/ctr.wide_and_deep_ctr`` through the port's v2 flow, against the
JAX package at a small size (wide 32, vocab [10, 8], embedding 4, hidden
(16,)), from the same carried parameters and seeded batches.  The JAX
trainer runs as the repo's tests run it (8 virtual CPU devices,
data-parallel over the batch).

Tolerances (f32 round-off of another summation order): the first step's
cost rtol 2e-6 and every gradient leaf atol 2e-6 relative to the leaf's
largest entry; over 5 Momentum steps, per-step costs rtol 2e-6 and
parameters atol 5e-5.  The rows no batch touched are held bit-identical
to the start in both packages, and a lazy table's ``apply`` to the JAX
package's ``apply`` bit for bit (the same elementwise operations in the
same order, op by op on both sides)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.core.initializer as JI
import paddle_tpu.core.parameters as JParams
import paddle_tpu.optimizer as JO
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.core.initializer as TI
import paddle_tpu_torch.core.parameters as TParams
import paddle_tpu_torch.optimizer as TO
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.layers.attr import ParamAttr as JAttr
from paddle_tpu.layers.base import reset_name_counters as jax_reset
from paddle_tpu.models.ctr import wide_and_deep_ctr as jctr
from paddle_tpu.reader.feeder import DataFeeder as JFeeder
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.layers.attr import ParamAttr as TAttr
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.models.ctr import wide_and_deep_ctr as tctr
from paddle_tpu_torch.ops.kernels import update as U
from paddle_tpu_torch.reader.feeder import DataFeeder as TFeeder

WIDE, VOCABS, EMBED, HIDDEN, BATCH = 32, [10, 8], 4, (16,), 16
JD = importlib.import_module("paddle_tpu.layers.data_type")
TD = tpaddle.data_type


@pytest.fixture(autouse=True)
def _fresh_names():
    reset_name_counters()
    jax_reset()
    yield


# -- the row-lazy contract (the port of tests/test_sparse_embedding.py's) -----

ROUTES = ["apply", "_apply_each"]


def _lazy_spec(decay=0.25):
    return TParams.ParamSpec(
        name="emb", shape=(8, 4), initializer=TI.constant(0.0),
        decay_rate=decay, sparse=True,
        attr=TAttr(name="emb", sparse_update=True))


def _grad(rs, rows):
    g = np.zeros((8, 4), np.float32)
    for r in rows:
        g[r] = rs.randn(4)
    return torch.from_numpy(g)


@pytest.mark.parametrize("route", ROUTES)
def test_momentum_untouched_rows_bit_identical(route):
    rs = np.random.RandomState(6)
    spec = {"emb": _lazy_spec()}
    p = torch.from_numpy(rs.randn(8, 4).astype(np.float32))
    opt = TO.Momentum(momentum=0.9, learning_rate=0.1)
    apply = getattr(opt, route)
    p0 = p.numpy().copy()
    state = opt.init({"emb": p}, spec)
    # step 1 touches {1, 3}: their velocity becomes nonzero.  The routed
    # apply updates in place, so each step's values are kept as copies
    p1, state = apply({"emb": _grad(rs, [1, 3])}, {"emb": p}, state, spec)
    p1 = {"emb": p1["emb"].numpy().copy()}
    v1 = state["slots"]["emb"]["velocity"].numpy().copy()
    # step 2 touches {3, 5}: row 1 keeps parameter and velocity
    p2, state2 = apply({"emb": _grad(rs, [3, 5])},
                       {"emb": torch.from_numpy(p1["emb"].copy())}, state,
                       spec)
    p2 = {"emb": p2["emb"].numpy()}
    v2 = state2["slots"]["emb"]["velocity"].numpy()
    np.testing.assert_array_equal(p2["emb"][1], p1["emb"][1])
    np.testing.assert_array_equal(v2[1], v1[1])
    assert np.any(v1[1] != 0)      # row 1 carried real momentum to freeze
    # the touched rows moved (decay and momentum on touch)
    assert np.any(p2["emb"][3] != p1["emb"][3])
    assert np.any(p2["emb"][5] != p1["emb"][5])
    # rows never touched: parameter as it was, velocity zero
    np.testing.assert_array_equal(p2["emb"][0], p0[0])
    assert not v2[0].any()


@pytest.mark.parametrize("route", ROUTES)
def test_sgd_untouched_rows_bit_identical(route):
    rs = np.random.RandomState(7)
    spec = {"emb": _lazy_spec()}
    p = torch.from_numpy(rs.randn(8, 4).astype(np.float32))
    opt = TO.SGD(learning_rate=0.1)
    state = opt.init({"emb": p}, spec)
    # a copy in: the routed apply updates in place
    p1, _ = getattr(opt, route)({"emb": _grad(rs, [2])}, {"emb": p.clone()},
                                state, spec)
    keep = [r for r in range(8) if r != 2]
    np.testing.assert_array_equal(p1["emb"].numpy()[keep], p.numpy()[keep])
    assert np.any(p1["emb"].numpy()[2] != p.numpy()[2])


@pytest.mark.parametrize("route", ROUTES)
def test_dense_param_still_decays_everywhere(route):
    """A dense parameter under the same optimizer still takes the decay
    fold: laziness is opted into per ParamAttr."""
    spec = {"w": TParams.ParamSpec(name="w", shape=(4, 4),
                                   initializer=TI.constant(0.0),
                                   decay_rate=0.5)}
    p = torch.ones(4, 4)
    opt = TO.SGD(learning_rate=0.1)
    state = opt.init({"w": p}, spec)
    p1, _ = getattr(opt, route)({"w": torch.zeros(4, 4)}, {"w": p}, state,
                                spec)
    # a zero gradient, but the decay reaches every entry
    np.testing.assert_allclose(p1["w"].numpy(), 0.95, rtol=1e-6)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("decay", [None, 0.25])
@pytest.mark.parametrize("route", ROUTES)
def test_lazy_momentum_apply_matches_jax(nesterov, decay, route):
    """A lazy [8, 4] table beside a dense [3, 5] parameter, a global L2,
    3 steps touching random rows: bit-identical to the JAX package's
    ``apply``."""
    rs = np.random.RandomState(3 + nesterov)
    reg = 1e-2
    jopt = JO.Momentum(momentum=0.9, learning_rate=0.1,
                       use_nesterov=nesterov,
                       regularization=JO.L2Regularization(rate=reg))
    topt = TO.Momentum(momentum=0.9, learning_rate=0.1,
                       use_nesterov=nesterov,
                       regularization=TO.L2Regularization(rate=reg))
    shapes = {"emb": (8, 4), "w": (3, 5)}

    def specs(mod, init, attr):
        return {"emb": mod.ParamSpec(name="emb", shape=(8, 4),
                                     initializer=init.constant(0.0),
                                     decay_rate=decay, sparse=True,
                                     attr=attr(name="emb",
                                               sparse_update=True)),
                "w": mod.ParamSpec(name="w", shape=(3, 5),
                                   initializer=init.constant(0.0))}

    jspecs, tspecs = specs(JParams, JI, JAttr), specs(TParams, TI, TAttr)
    p0 = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    js, ts = jopt.init(jp, jspecs), topt.init(tp, tspecs)
    for _ in range(3):
        g = {"emb": _grad(rs, rs.choice(8, 3, replace=False)).numpy(),
             "w": rs.randn(3, 5).astype(np.float32)}
        jp, js = jopt.apply({n: jnp.asarray(v) for n, v in g.items()}, jp,
                            js, jspecs)
        tp, ts = getattr(topt, route)(
            {n: torch.from_numpy(v) for n, v in g.items()}, tp, ts, tspecs)
    for n in shapes:
        np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]),
                                      err_msg=n)
        np.testing.assert_array_equal(
            ts["slots"][n]["velocity"].numpy(),
            np.asarray(js["slots"][n]["velocity"]), err_msg=n)


# -- the CTR model -------------------------------------------------------------


def build(pkg_ctr, **kw):
    args = dict(wide_dim=WIDE, categorical_vocab_sizes=VOCABS,
                embedding_size=EMBED, hidden_sizes=HIDDEN)
    args.update(kw)
    return pkg_ctr(**args)


def samples(seed, n, cat0_below=None):
    """(wide ids, cat_0, cat_1, label) with the learnable label of the JAX
    package's test; ``cat0_below`` keeps cat_0's ids under a bound, so the
    table rows at and above it are never touched."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        wide = rs.randint(0, WIDE, 3).tolist()
        c0 = int(rs.randint(0, cat0_below or VOCABS[0]))
        c1 = int(rs.randint(0, VOCABS[1]))
        out.append((wide, c0, c1, int((c0 % 2) ^ (c1 % 2))))
    return out


def carried_params(jtopo):
    params = jpaddle.parameters.create(jtopo)
    return {n: np.asarray(params[n]) for n in params.names()}


def feeders(topos):
    jtopo, ttopo = topos
    jf = JFeeder({n: JD.InputType(dim=l.attrs["dim"],
                                  seq_type=l.attrs["seq_type"],
                                  kind=l.attrs["data_type"])
                  for n, l in jtopo.data_layers().items()})
    tf = TFeeder({n: TD.InputType(dim=l.attrs["dim"],
                                  seq_type=l.attrs["seq_type"],
                                  kind=l.attrs["data_type"])
                  for n, l in ttopo.data_layers().items()}, device="cpu")
    return jf, tf


def test_topology_and_census_equal_the_jax_ones():
    jcost, jpred, jnames = build(jctr)
    tcost, tpred, tnames = build(tctr)
    jtopo, ttopo = JTopology(jcost), TTopology(tcost)
    assert ttopo.serialize() == jtopo.serialize()
    assert ttopo.digest() == jtopo.digest()
    assert tnames == jnames == ["wide_input", "cat_0", "cat_1", "label"]
    assert tpred.name == jpred.name == "ctr_predict"
    tspecs = ttopo.param_specs()
    assert ([(s.name, s.shape) for s in tspecs]
            == [(s.name, s.shape) for s in jtopo.param_specs()])
    tables = [s for s in tspecs if s.name.startswith("emb_")]
    assert [s.shape for s in tables] == [(10, 4), (8, 4)]
    for s in tables:
        assert s.sharding == ("model", None) and s.sparse
        assert TO.lazy_sparse_rows(s) and s.attr.sparse_update
    assert not any(TO.lazy_sparse_rows(s) for s in tspecs if s not in tables)


def test_full_width_census_equals_the_jax_one():
    """``bench.py``'s ``bench_ctr`` shapes (wide 10,000, 8 fields of vocab
    1,000, embedding 64, hidden (256, 128)), built in both packages
    without computing anything: 756,506 parameters, names and shapes
    equal."""
    kw = dict(wide_dim=10_000, categorical_vocab_sizes=[1000] * 8,
              embedding_size=64, hidden_sizes=(256, 128))
    jtopo, ttopo = JTopology(jctr(**kw)[0]), TTopology(tctr(**kw)[0])
    census = [(s.name, s.shape) for s in ttopo.param_specs()]
    assert census == [(s.name, s.shape) for s in jtopo.param_specs()]
    assert sum(int(np.prod(s)) for _, s in census) == 756_506
    assert sum(n.startswith("emb_") for n, _ in census) == 8
    assert ttopo.digest() == jtopo.digest()


def test_pad_vocab_to_raises():
    with pytest.raises(NotImplementedError, match="pad_rows_to"):
        build(tctr, pad_vocab_to=4)


def test_feeder_densifies_as_the_jax_one():
    """The wide input (sparse binary, a repeated id inside a row, an empty
    row) and a sparse-float slot (a repeated index keeps its last value)
    against the JAX feeder."""
    types = {"wide": "sparse_binary_vector", "f": "sparse_float_vector",
             "y": "integer_value"}
    dims = {"wide": 12, "f": 6, "y": 2}
    jf = JFeeder({n: getattr(JD, t)(dims[n]) for n, t in types.items()})
    tf = TFeeder({n: getattr(TD, t)(dims[n]) for n, t in types.items()},
                 device="cpu")
    batch = [([1, 5, 5, 11], [(0, 0.5), (3, -2.0)], 1),
             ([], [], 0),
             ([0], [(2, 1.5), (2, 4.0), (5, 0.25)], 1)]
    got, want = tf(batch), jf(batch)
    for n in ("wide", "f"):
        assert got[n].dtype == torch.float32
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    assert got["wide"].numpy()[0].tolist() == [0, 1, 0, 0, 0, 1, 0, 0,
                                               0, 0, 0, 1]
    assert got["f"].numpy()[2, 2] == 4.0
    np.testing.assert_array_equal(got["y"].numpy(), [1, 0, 1])
    with pytest.raises(Exception, match="only dense"):
        TFeeder({"w": TD.InputType(4, 1, TD.DataKind.SPARSE_BINARY)})


def test_first_step_cost_and_gradients_match_jax():
    jcost, tcost = build(jctr)[0], build(tctr)[0]
    jtopo, ttopo = JTopology(jcost), TTopology(tcost)
    carried = carried_params(jtopo)
    batch = samples(1, BATCH)
    jf, tf = feeders((jtopo, ttopo))
    jfeed, tfeed = jf(batch), tf(batch)

    def jloss(p):
        values, _ = jtopo.forward(p, {}, jfeed, True, jax.random.key(0))
        return values[jcost.name]

    jc, jg = jax.value_and_grad(jloss)(
        {n: jnp.asarray(v) for n, v in carried.items()})
    params = {n: torch.tensor(v).requires_grad_() for n, v in carried.items()}
    values, _ = ttopo.forward(params, {}, tfeed, True)
    tc = values[tcost.name]
    tg = torch.autograd.grad(tc, list(params.values()))
    np.testing.assert_allclose(tc.item(), float(jc), rtol=2e-6)
    for (name, _), g in zip(params.items(), tg):
        want = np.asarray(jg[name])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=2e-6 * scale,
                                   rtol=0, err_msg=name)
    # a table's gradient is zero exactly on the rows no id of the batch hit
    hit = {c0 for _, c0, _, _ in batch}
    g0 = tg[list(params).index("emb_0")].numpy()
    assert {r for r in range(VOCABS[0]) if g0[r].any()} == hit


def test_momentum_trajectory_matches_the_jax_trainer(monkeypatch):
    """5 steps of ``Momentum(momentum=0.9, learning_rate=0.05)`` (the JAX
    package's CTR test optimizer) through both ``trainer.SGD``s, cat_0's
    ids below 7: the port's update is routed (``fused_apply``, the twins
    on the CPU) every step, and rows 7-9 of ``emb_0`` keep parameter and
    velocity bit for bit in both packages."""
    jcost, tcost = build(jctr)[0], build(tctr)[0]
    jtopo = JTopology(jcost)
    carried = carried_params(jtopo)
    jparams = jpaddle.parameters.create(jtopo)
    for n, v in carried.items():
        jparams[n] = v
    jtrainer = jpaddle.trainer.SGD(
        cost=jcost, parameters=jparams,
        update_equation=jpaddle.optimizer.Momentum(momentum=0.9,
                                                   learning_rate=0.05))
    ttrainer = tpaddle.trainer.SGD(
        cost=tcost, parameters=Parameters.from_numpy(carried),
        update_equation=tpaddle.optimizer.Momentum(momentum=0.9,
                                                   learning_rate=0.05),
        device="cpu")
    routed = []
    real = U.fused_apply
    monkeypatch.setattr(U, "fused_apply",
                        lambda *a: routed.append(1) or real(*a))
    train = samples(2, 5 * BATCH, cat0_below=7)
    got = {"jax": [], "torch": []}

    def handler(key):
        def h(e):
            if type(e).__name__ == "EndIteration":
                got[key].append(e.cost)
        return h

    jtrainer.train(reader=jpaddle.reader.batch(lambda: iter(train), BATCH),
                   num_passes=1, event_handler=handler("jax"))
    ttrainer.train(reader=tpaddle.batch(lambda: iter(train), BATCH),
                   num_passes=1, event_handler=handler("torch"))
    assert len(routed) == 5 and len(got["torch"]) == 5
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=2e-6)
    for name in carried:
        np.testing.assert_allclose(ttrainer.parameters[name],
                                   jtrainer.parameters[name], atol=5e-5,
                                   rtol=0, err_msg=name)
        assert not np.array_equal(ttrainer.parameters[name], carried[name])
    for p in (ttrainer.parameters["emb_0"],
              np.asarray(jtrainer.parameters["emb_0"])):
        np.testing.assert_array_equal(p[7:], carried["emb_0"][7:])
    tv = ttrainer._opt_state["slots"]["emb_0"]["velocity"].numpy()
    assert not tv[7:].any() and tv[:7].any()


def test_wide_and_deep_learns():
    """The port's counterpart of the JAX package's test: Adam at lr 0.02,
    6 passes of 256 samples at batch 32, the last cost under 0.6 x the
    first."""
    cost, _, _ = build(tctr)
    parameters = tpaddle.parameters.create(cost)
    trainer = tpaddle.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=tpaddle.optimizer.Adam(learning_rate=0.02),
        device="cpu")
    rs = np.random.RandomState(0)

    def corpus():
        for _ in range(256):
            wide_ids = rs.randint(0, 32, 3).tolist()
            c0, c1 = int(rs.randint(0, 10)), int(rs.randint(0, 8))
            yield wide_ids, c0, c1, int((c0 % 2) ^ (c1 % 2))

    costs = []

    def handler(e):
        if isinstance(e, tpaddle.event.EndIteration):
            costs.append(e.cost)

    feeding = {"wide_input": 0, "cat_0": 1, "cat_1": 2, "label": 3}
    trainer.train(reader=tpaddle.batch(corpus, 32), num_passes=6,
                  event_handler=handler, feeding=feeding)
    assert len(costs) == 48
    assert costs[-1] < costs[0] * 0.6, (costs[0], costs[-1])
