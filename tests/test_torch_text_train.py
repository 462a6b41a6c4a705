"""The text-classification slice as a whole: the port's v2 flow
(``layer.embedding`` -> ``fc`` -> ``lstmemory`` -> ``last_seq`` -> softmax
``fc`` -> ``classification_cost``; ``trainer.SGD`` with Adam) against the
JAX package's, as ``bench.py``'s ``_lstm_classify_cost`` builds it, at a
small width (hidden 32, vocab 50, embedding 16) with ragged sequences,
from the same carried parameters and seeded batches.  The JAX trainer
runs as the repo's tests run it (8 virtual CPU devices, data-parallel
over the batch); its LSTM is the Pallas kernel in interpret mode.

Tolerances (f32 round-off of another summation order; measured on the
CPU in brackets): the first step's cost rtol 2e-6 [0] and every gradient
leaf atol 2e-6 relative to the leaf's largest entry [2.2e-8]; over 5 Adam
steps with bf16 moments, per-step costs rtol 2e-6 [8.7e-8], parameters
atol 5e-5 [7.8e-6], the classification error equal [equal]."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.layers.base import reset_name_counters as jax_reset
from paddle_tpu.reader.feeder import DataFeeder as JFeeder
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu.reader.feeder import padding_stats as jax_padding_stats
from paddle_tpu.trainer import step as JStep
from paddle_tpu_torch.core.lod import to_ragged
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.reader.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.reader.feeder import padding_stats
from paddle_tpu_torch.trainer import step as TStep

HIDDEN, VOCAB, EMBED, BATCH = 32, 50, 16, 8


@pytest.fixture(autouse=True)
def _fresh_names():
    reset_name_counters()
    jax_reset()
    yield


def classifier(pkg, hidden=HIDDEN, vocab=VOCAB, embed=EMBED, variant=None):
    """``bench.py``'s ``_lstm_classify_cost`` in either package.  The
    ``"relu_reverse_first"`` variant runs the LSTM backwards with a ReLU
    output activation (the plain masked scan, not the sequence kernel)
    and pools with ``first_seq``; ``"tagger"`` classifies every step
    against a label sequence (no pooling)."""
    L, A = pkg.layer, pkg.activation
    D = importlib.import_module(pkg.__name__ + ".layers.data_type")
    data = L.data(name="data", type=D.integer_value_sequence(vocab))
    net = L.embedding(input=data, size=embed)
    net = L.fc(input=net, size=hidden * 4, act=A.LinearActivation())
    if variant == "relu_reverse_first":
        net = L.first_seq(input=L.lstmemory(input=net, reverse=True,
                                            act=A.ReluActivation()))
    elif variant == "tagger":
        net = L.lstmemory(input=net)
    else:
        net = L.last_seq(input=L.lstmemory(input=net))
    net = L.fc(input=net, size=2, act=A.SoftmaxActivation())
    label = L.data(name="label", type=D.integer_value_sequence(2)
                   if variant == "tagger" else D.integer_value(2))
    return L.classification_cost(input=net, label=label)


def samples(seed, n, lo=3, hi=14):
    """Ragged id sequences (bucketed to T = 16) and labels."""
    rng = np.random.default_rng(seed)
    return [(list(rng.integers(0, VOCAB, size=int(rng.integers(lo, hi + 1)))),
             int(rng.integers(0, 2))) for _ in range(n)]


def carried_params(jtopo, seed=0):
    """The JAX package's initial parameters as numpy, with the LSTM bias
    (gate biases and peepholes) made nonzero so every term is exercised."""
    params = jpaddle.parameters.create(jtopo)
    out = {n: np.asarray(params[n]) for n in params.names()}
    rng = np.random.default_rng(seed)
    for n in out:
        if n.endswith(".wbias"):
            out[n] = (0.1 * rng.normal(size=out[n].shape)).astype(np.float32)
    return out


def test_topology_equals_the_jax_one():
    jtopo = JTopology(classifier(jpaddle))
    ttopo = TTopology(classifier(tpaddle))
    assert ttopo.serialize() == jtopo.serialize()
    assert ttopo.digest() == jtopo.digest()
    assert [n.name for n in ttopo.nodes] == [n.name for n in jtopo.nodes]
    assert ([(s.name, s.shape) for s in ttopo.param_specs()]
            == [(s.name, s.shape) for s in jtopo.param_specs()])
    assert ttopo.metrics() == jtopo.metrics()


def test_full_width_census_equals_the_jax_one():
    """The bench's configuration (hidden 1280, vocab 30000, embedding 128),
    built in both packages without computing anything: about 11.07 M
    parameters, names and shapes equal."""
    jtopo = JTopology(classifier(jpaddle, 1280, 30000, 128))
    ttopo = TTopology(classifier(tpaddle, 1280, 30000, 128))
    census = [(s.name, s.shape) for s in ttopo.param_specs()]
    assert census == [(s.name, s.shape) for s in jtopo.param_specs()]
    sizes = {n: int(np.prod(shape)) for n, shape in census}
    assert sorted(sizes.values()) == sorted(
        [3_840_000, 655_360, 5_120, 6_553_600, 8_960, 2_560, 2])
    assert sum(sizes.values()) == 11_065_602
    assert ttopo.digest() == jtopo.digest()


def test_feeder_buckets_as_the_jax_one():
    """Integer and dense sequence slots, ragged and uniform: the same
    bucketed T, lengths, data and padding counts as the JAX feeder."""
    JD = importlib.import_module("paddle_tpu.layers.data_type")
    TD = tpaddle.data_type
    types = {"data": TD.integer_value_sequence(VOCAB),
             "vec": TD.dense_vector_sequence(3), "label": TD.integer_value(2)}
    jtypes = {"data": JD.integer_value_sequence(VOCAB),
              "vec": JD.dense_vector_sequence(3), "label": JD.integer_value(2)}
    rng = np.random.default_rng(4)

    def with_vectors(batch):
        return [(ids, rng.normal(size=(len(ids), 3)).astype(np.float32), y)
                for ids, y in batch]

    for batch in (samples(0, 5), [([1] * 100, 0)] * 3):
        batch = with_vectors(batch)
        tfeed, jfeed = TFeeder(types, device="cpu")(batch), JFeeder(jtypes)(
            batch)
        for name in ("data", "vec"):
            got, want = tfeed[name], jfeed[name]
            assert got.max_len == want.max_len
            assert np.array_equal(got.length.numpy(), np.asarray(want.length))
            assert np.array_equal(got.data.numpy(), np.asarray(want.data))
        assert padding_stats(tfeed) == jax_padding_stats(jfeed)
        for seq, (ids, _, _) in zip(to_ragged(tfeed["data"]), batch):
            assert seq.tolist() == ids
    assert tfeed["data"].max_len == 128    # the bench's 100 tokens -> T = 128


@pytest.mark.parametrize("variant", [None, "relu_reverse_first", "tagger"])
def test_first_step_cost_gradients_and_metric_match_jax(variant):
    jcost = classifier(jpaddle, variant=variant)
    tcost = classifier(tpaddle, variant=variant)
    jtopo, ttopo = JTopology(jcost), TTopology(tcost)
    assert ttopo.digest() == jtopo.digest()
    carried = carried_params(jtopo)
    batch = samples(1, BATCH)
    if variant == "tagger":
        rng = np.random.default_rng(9)
        batch = [(ids, rng.integers(0, 2, size=len(ids)).tolist())
                 for ids, _ in batch]
    jfeed = JFeeder({n: importlib.import_module(
        "paddle_tpu.layers.data_type").InputType(
            dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
            kind=l.attrs["data_type"])
        for n, l in jtopo.data_layers().items()})(batch)

    def jloss(p):
        values, _ = jtopo.forward(p, {}, jfeed, True, jax.random.key(0))
        return values[jcost.name]

    jparams = {n: jnp.asarray(v) for n, v in carried.items()}
    jc, jg = jax.value_and_grad(jloss)(jparams)
    jvalues, _ = jtopo.forward(jparams, {}, jfeed, True, jax.random.key(0))
    jmetrics = JStep._compute_metrics(jtopo.metrics(), jvalues)
    params = {n: torch.tensor(v).requires_grad_() for n, v in carried.items()}
    tfeed = TFeeder({n: tpaddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in ttopo.data_layers().items()},
        device="cpu")(batch)
    values, _ = ttopo.forward(params, {}, tfeed, True)
    tc = values[tcost.name]
    tg = torch.autograd.grad(tc, list(params.values()))
    np.testing.assert_allclose(tc.item(), float(jc), rtol=2e-6)
    with torch.no_grad():
        metrics = TStep._finalize_metrics(TStep._metric_parts(
            ttopo.metrics(), values))
    assert metrics == {k: float(v) for k, v in jmetrics.items()}
    for (name, _), g in zip(params.items(), tg):
        want = np.asarray(jg[name])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=2e-6 * scale,
                                   rtol=0, err_msg=name)


def test_adam_trajectory_and_metric_match_the_jax_trainer():
    jcost, tcost = classifier(jpaddle), classifier(tpaddle)
    jtopo = JTopology(jcost)
    carried = carried_params(jtopo)
    jparams = jpaddle.parameters.create(jtopo)
    for n, v in carried.items():
        jparams[n] = v
    jtrainer = jpaddle.trainer.SGD(
        cost=jcost, parameters=jparams,
        update_equation=jpaddle.optimizer.Adam(learning_rate=2e-3,
                                               moment_dtype=jnp.bfloat16))
    ttrainer = tpaddle.trainer.SGD(
        cost=tcost, parameters=Parameters.from_numpy(carried),
        update_equation=tpaddle.optimizer.Adam(learning_rate=2e-3,
                                               moment_dtype=torch.bfloat16),
        device="cpu")
    train = samples(2, 5 * BATCH)
    got = {"jax": [], "torch": []}

    def handler(key):
        def h(e):
            if type(e).__name__ in ("EndIteration", "EndPass"):
                got[key].append((type(e).__name__, getattr(e, "cost", None),
                                 e.metrics.get(
                                     "classification_error_evaluator")))
        return h

    jtrainer.train(reader=jpaddle.reader.batch(lambda: iter(train), BATCH),
                   num_passes=1, event_handler=handler("jax"))
    ttrainer.train(reader=tpaddle.batch(lambda: iter(train), BATCH),
                   num_passes=1, event_handler=handler("torch"))
    assert [e[0] for e in got["torch"]] == ["EndIteration"] * 5 + ["EndPass"]
    assert [e[0] for e in got["jax"]] == [e[0] for e in got["torch"]]
    np.testing.assert_allclose([e[1] for e in got["torch"][:5]],
                               [e[1] for e in got["jax"][:5]], rtol=2e-6)
    assert [e[2] for e in got["torch"]] == pytest.approx(
        [e[2] for e in got["jax"]], abs=1e-7)
    for name in carried:
        np.testing.assert_allclose(ttrainer.parameters[name],
                                   jtrainer.parameters[name], atol=5e-5,
                                   rtol=0, err_msg=name)
        assert not np.array_equal(ttrainer.parameters[name], carried[name])

    test = samples(3, 2 * BATCH)
    jres = jtrainer.test(
        reader=jpaddle.reader.batch(lambda: iter(test), BATCH))
    tres = ttrainer.test(reader=tpaddle.batch(lambda: iter(test), BATCH))
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=2e-6)
    assert tres.metrics == pytest.approx(jres.metrics, abs=1e-7)
    assert set(tres.metrics) == {"classification_error_evaluator"}
