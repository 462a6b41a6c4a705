"""The attention-NMT slice as a whole: the port's ``models.seqtoseq``
training branch (``layer.embedding`` -> ``layer.bigru`` -> ``slice`` /
``first_seq`` / ``mixed`` boot -> ``recurrent_group`` with
``simple_attention`` + ``gru_step_layer`` -> sunk softmax ``fc`` ->
``classification_cost`` on its logits; ``trainer.SGD`` with Adam) against
the JAX package's, at a small width (source vocab 20, target vocab 17,
width 8, as ``tests/test_recurrent_group.py`` builds it) from the same
carried parameters and the same ragged id sequences (bucketed to T = 16).
The JAX trainer runs as the repo's tests run it (8 virtual CPU devices);
its BiGRU is the unfused composition with ``gru_seq`` in interpret mode,
its decoder a ``lax.scan``.

Tolerances (f32 round-off of another summation order; measured on the
CPU in brackets): the first step's cost rtol 2e-6 [8.7e-8] and every
gradient leaf atol 2e-6 relative to the leaf's largest entry [6.0e-8];
over 5 Adam steps with bf16 moments, per-step costs rtol 2e-6 [1.3e-7],
parameters atol 5e-5 [1.4e-6], the classification error equal
[equal]; ``test`` cost rtol 2e-6."""

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
from paddle_tpu.models import seqtoseq as jnmt
from paddle_tpu.reader.feeder import DataFeeder as JFeeder
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.models import seqtoseq as tnmt
from paddle_tpu_torch.reader.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.trainer import step as TStep

SRC, TRG, WIDTH, BATCH = 20, 17, 8, 8
JD = importlib.import_module("paddle_tpu.layers.data_type")
ORDER = ("source_language_word", "target_language_word",
         "target_language_next_word")


@pytest.fixture(autouse=True)
def _fresh_names():
    reset_name_counters()
    jax_reset()
    yield


def nmt(mod, src=SRC, trg=TRG, width=WIDTH):
    return mod.seqtoseq_net(src, trg, word_vector_dim=width,
                            encoder_size=width, decoder_size=width)


def samples(seed, n, lo=1, hi=12):
    """(source, target, next-target) id lists of ragged lengths; the
    target pair shares a length, as a reader of a parallel corpus gives."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ls, lt = (int(rng.integers(lo, hi + 1)) for _ in range(2))
        trg = rng.integers(0, TRG, size=lt + 1)
        out.append((rng.integers(0, SRC, size=ls).tolist(),
                    trg[:-1].tolist(), trg[1:].tolist()))
    return out


def carried_params(jtopo, seed=0):
    """The JAX package's initial parameters as numpy, the zero-initialized
    biases made nonzero so every term is exercised."""
    params = jpaddle.parameters.create(jtopo)
    out = {n: np.asarray(params[n]) for n in params.names()}
    rng = np.random.default_rng(seed)
    for n in out:
        if n.endswith("bias"):
            out[n] = (0.1 * rng.normal(size=out[n].shape)).astype(np.float32)
    return out


def feeders(jtopo, ttopo):
    jtypes = {n: JD.InputType(dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
                              kind=l.attrs["data_type"])
              for n, l in jtopo.data_layers().items()}
    ttypes = {n: tpaddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in ttopo.data_layers().items()}
    return JFeeder(jtypes, ORDER), TFeeder(ttypes, ORDER, device="cpu")


def test_topology_equals_the_jax_one():
    jtopo, ttopo = JTopology(nmt(jnmt)), TTopology(nmt(tnmt))
    assert ttopo.serialize() == jtopo.serialize()
    assert ttopo.digest() == jtopo.digest()
    assert [n.name for n in ttopo.nodes] == [n.name for n in jtopo.nodes]
    assert ttopo.metrics() == jtopo.metrics()
    assert list(ttopo.data_layers()) == list(jtopo.data_layers())


def test_parameter_census_equals_the_jax_one():
    jtopo, ttopo = JTopology(nmt(jnmt)), TTopology(nmt(tnmt))
    census = [(s.name, s.shape) for s in ttopo.param_specs()]
    assert census == [(s.name, s.shape) for s in jtopo.param_specs()]
    assert len(census) == 20
    jspecs = {s.name: s for s in jtopo.param_specs()}
    for s in ttopo.param_specs():
        assert s.sparse == jspecs[s.name].sparse, s.name
        assert s.is_static == jspecs[s.name].is_static, s.name


def test_full_width_census_equals_the_jax_one():
    """``bench_nmt``'s configuration (vocab 30,000 both sides, word, encoder
    and decoder 512), built in both packages without computing anything:
    20 tensors, 53,458,224 parameters."""
    jtopo = JTopology(nmt(jnmt, 30000, 30000, 512))
    reset_name_counters()
    ttopo = TTopology(nmt(tnmt, 30000, 30000, 512))
    census = [(s.name, s.shape) for s in ttopo.param_specs()]
    assert census == [(s.name, s.shape) for s in jtopo.param_specs()]
    sizes = [int(np.prod(shape)) for _, shape in census]
    assert len(sizes) == 20 and sum(sizes) == 53_458_224
    assert ttopo.digest() == jtopo.digest()


def test_generation_is_refused_until_ported():
    with pytest.raises(NotImplementedError, match="A4b"):
        tnmt.seqtoseq_net(SRC, TRG, 8, 8, 8, is_generating=True)


def test_initializer_laws_match_the_jax_ones():
    """Each parameter's initial values follow the JAX package's law: the
    same mean and spread (paddle_default std 1/sqrt(fan_in), xavier's
    uniform bound, the zero biases)."""
    jtopo, ttopo = (JTopology(nmt(jnmt, 300, 300, 64)),
                    TTopology(nmt(tnmt, 300, 300, 64)))
    jp = jpaddle.parameters.create(jtopo)
    tp = tpaddle.parameters.create(ttopo)
    for name in jp.names():
        j, t = np.asarray(jp[name]), np.asarray(tp[name])
        assert j.shape == t.shape, name
        assert abs(j.mean() - t.mean()) < 0.02 + 0.1 * j.std(), name
        np.testing.assert_allclose(t.std(), j.std(), rtol=0.15, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(np.abs(t).max(), np.abs(j).max(),
                                   rtol=0.5, atol=1e-7, err_msg=name)


def test_first_step_cost_gradients_and_metric_match_jax():
    jcost, tcost = nmt(jnmt), nmt(tnmt)
    jtopo, ttopo = JTopology(jcost), TTopology(tcost)
    carried = carried_params(jtopo)
    batch = samples(1, 6)
    batch[0] = ([3], batch[0][1], batch[0][2])     # a length-1 source row
    jfeeder, tfeeder = feeders(jtopo, ttopo)
    jfeed, tfeed = jfeeder(batch), tfeeder(batch)
    assert tfeed["source_language_word"].max_len == 16

    def jloss(p):
        values, _ = jtopo.forward(p, {}, jfeed, True, jax.random.key(0))
        return values[jcost.name]

    jparams = {n: jnp.asarray(v) for n, v in carried.items()}
    jc, jg = jax.value_and_grad(jloss)(jparams)
    jvalues, _ = jtopo.forward(jparams, {}, jfeed, True, jax.random.key(0))
    jmetrics = importlib.import_module(
        "paddle_tpu.trainer.step")._compute_metrics(jtopo.metrics(), jvalues)
    params = {n: torch.tensor(v).requires_grad_() for n, v in carried.items()}
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
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(g.numpy(), want, atol=2e-6 * scale,
                                   rtol=0, err_msg=name)


def test_adam_trajectory_and_test_match_the_jax_trainer():
    jcost, tcost = nmt(jnmt), nmt(tnmt)
    jtopo = JTopology(jcost)
    carried = carried_params(jtopo)
    jparams = jpaddle.parameters.create(jtopo)
    for n, v in carried.items():
        jparams[n] = v
    jtrainer = jpaddle.trainer.SGD(
        cost=jcost, parameters=jparams,
        update_equation=jpaddle.optimizer.Adam(learning_rate=5e-3,
                                               moment_dtype=jnp.bfloat16))
    ttrainer = tpaddle.trainer.SGD(
        cost=tcost, parameters=Parameters.from_numpy(carried),
        update_equation=tpaddle.optimizer.Adam(learning_rate=5e-3,
                                               moment_dtype=torch.bfloat16),
        device="cpu")
    train = samples(2, 5 * BATCH)
    feeding = {n: i for i, n in enumerate(ORDER)}
    got = {"jax": [], "torch": []}

    def handler(key):
        def h(e):
            if type(e).__name__ in ("EndIteration", "EndPass"):
                got[key].append((type(e).__name__, getattr(e, "cost", None),
                                 e.metrics.get(
                                     "classification_error_evaluator")))
        return h

    jtrainer.train(reader=jpaddle.reader.batch(lambda: iter(train), BATCH),
                   num_passes=1, event_handler=handler("jax"),
                   feeding=feeding)
    ttrainer.train(reader=tpaddle.batch(lambda: iter(train), BATCH),
                   num_passes=1, event_handler=handler("torch"),
                   feeding=feeding)
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
        reader=jpaddle.reader.batch(lambda: iter(test), BATCH),
        feeding=feeding)
    tres = ttrainer.test(reader=tpaddle.batch(lambda: iter(test), BATCH),
                         feeding=feeding)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=2e-6)
    assert tres.metrics == pytest.approx(jres.metrics, abs=1e-7)
    assert set(tres.metrics) == {"classification_error_evaluator"}
