"""The slice as a whole: the port's v2 training flow (``models/image``
helpers -> ``Topology`` -> ``trainer.SGD.train`` / ``test``) against the
JAX package's ``paddle_tpu.trainer.SGD`` on a small residual net, from the
same carried parameters and the same seeded batches; and the full
ResNet-50 topology built in both packages without computing anything.

The mini net has the ResNet-50 structure at 16x16 input and narrow widths:
the 7x7 s2 stem, the ceil-mode 3x3 s2 max pool, one strided
``_mid_projection`` (strided 1x1 convs), one ``_bottleneck``, an average
pool, the softmax fc and the cross-entropy cost.  The JAX trainer runs as
the repo's tests run it (8 virtual CPU devices, data-parallel over the
batch); the BN statistics are over the whole batch either way.

Tolerance (f32 summation order through 16 convs, BN and the fc,
compounded over 5 updates; measured margins in brackets): per-step costs
rtol 1e-5 [3e-7]; parameters atol 2e-6 [1.2e-7] and BN running
statistics atol 1e-5 [1.7e-6] after 5 Momentum steps; the test cost rtol
1e-5 [3.5e-7]."""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.models import image as JM
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.models import image as TM

BATCH, CLASSES, SIDE = 8, 10, 16


@pytest.fixture(autouse=True)
def _fresh_port_names():
    reset_name_counters()
    yield


def mini_resnet(paddle, M):
    L, A, P = paddle.layer, paddle.activation, paddle.pooling
    D = importlib.import_module(paddle.__name__ + ".layers.data_type")
    img = L.data(name="image", type=D.dense_vector(3 * SIDE * SIDE,
                                                   channels=3),
                 height=SIDE, width=SIDE)
    t = M._conv_bn("conv1", img, 7, 8, 2, 3, channels=3)
    t = L.img_pool(name="pool1", input=t, pool_size=3, stride=2)
    t = M._mid_projection("res2_1", t, 4, 16, stride=2)
    t = M._bottleneck("res2_2", t, 4, 16)
    t = L.img_pool(name="avgpool", input=t, pool_size=2, stride=1,
                   pool_type=P.AvgPooling())
    predict = L.fc(input=t, size=CLASSES, act=A.SoftmaxActivation(),
                   name="fc_out")
    label = L.data(name="label", type=D.integer_value(CLASSES))
    return L.cross_entropy_cost(input=predict, label=label, name="loss")


def samples(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=3 * SIDE * SIDE).astype(np.float32),
             int(rng.integers(0, CLASSES))) for _ in range(n)]


def reader_of(data):
    return lambda: iter(data)


def test_mini_resnet_trajectory_matches_the_jax_trainer():
    jcost, tcost = mini_resnet(jpaddle, JM), mini_resnet(tpaddle, TM)
    jtopo, ttopo = JTopology(jcost), TTopology(tcost)
    assert ttopo.serialize() == jtopo.serialize()
    jparams = jpaddle.parameters.create(jtopo)
    carried = {n: np.asarray(jparams[n]) for n in jparams.names()}

    def opt(pkg):
        return pkg.optimizer.Momentum(
            momentum=0.9, learning_rate=0.1 / BATCH,
            regularization=pkg.optimizer.L2Regularization(rate=1e-4))

    jtrainer = jpaddle.trainer.SGD(cost=jcost, parameters=jparams,
                                   update_equation=opt(jpaddle))
    ttrainer = tpaddle.trainer.SGD(
        cost=tcost, parameters=tpaddle.parameters.Parameters.from_numpy(
            carried), update_equation=opt(tpaddle), device="cpu")

    train = samples(0, 5 * BATCH)
    got = {"jax": [], "torch": []}
    events = {"jax": [], "torch": []}

    def handler(key):
        def h(e):
            events[key].append(type(e).__name__)
            if type(e).__name__ == "EndIteration":
                got[key].append(e.cost)
        return h

    jtrainer.train(reader=jpaddle.reader.batch(reader_of(train), BATCH),
                   num_passes=1, event_handler=handler("jax"))
    ttrainer.train(reader=tpaddle.batch(reader_of(train), BATCH),
                   num_passes=1, event_handler=handler("torch"))

    assert len(got["torch"]) == 5
    assert all(isinstance(c, float) for c in got["torch"])
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-5)
    assert events["torch"] == [e for e in events["jax"]
                               if e != "EndForwardBackward"]
    assert sorted(ttrainer.parameters.names()) == sorted(carried)
    for name in carried:
        np.testing.assert_allclose(ttrainer.parameters[name],
                                   jtrainer.parameters[name], atol=2e-6,
                                   err_msg=name)
        assert not np.array_equal(ttrainer.parameters[name], carried[name])
    assert sorted(ttrainer.states) == sorted(jtrainer.states)
    for name, v in jtrainer.states.items():
        np.testing.assert_allclose(ttrainer.states[name].numpy(),
                                   np.asarray(v), atol=1e-5, err_msg=name)

    test = samples(1, 2 * BATCH)
    jres = jtrainer.test(reader=jpaddle.reader.batch(reader_of(test), BATCH))
    tres = ttrainer.test(reader=tpaddle.batch(reader_of(test), BATCH))
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=1e-5)


def witness_ratios(start, wide, got):
    """Per leaf ||got - wide|| / ||wide - start||, the denominator floored
    at 1% of the leaf's share of the whole update (as ``chip_smoke.py``
    floors it); and the same ratio over all leaves at once."""
    sq = sum(np.sum((wide[n] - start[n]) ** 2) for n in wide)
    u = np.sqrt(sq / sum(wide[n].size for n in wide))
    ratios = {n: np.linalg.norm(got[n] - wide[n])
              / max(np.linalg.norm(wide[n] - start[n]),
                    1e-2 * u * np.sqrt(wide[n].size)) for n in wide}
    err_sq = sum(np.sum((got[n] - wide[n]) ** 2) for n in wide)
    return ratios, np.sqrt(err_sq / sq)


def test_float64_witness_step_holds_the_f32_step():
    """``SGD.step_f64`` runs one step in float64 on the CPU and leaves the
    trainer as it was; the f32 step from the same start lies within f32
    round-off of it.  Per parameter and BN statistic, ||x32 - x64|| /
    ||x64 - x0|| <= 2e-4 [measured 3.9e-5]; cost rtol 1e-6 [1.0e-7].  The
    denominator is floored at 1% of the leaf's share of the whole update,
    as ``chip_smoke.py`` floors it: conv1's BN shift has an exact update
    of zero (both convs after pool1 are followed by a BN)."""
    tcost = mini_resnet(tpaddle, TM)
    params = tpaddle.parameters.create(tcost)
    p0 = {n: params[n].copy() for n in params.names()}
    trainer = tpaddle.trainer.SGD(
        cost=tcost, parameters=params, device="cpu",
        update_equation=tpaddle.optimizer.Momentum(momentum=0.9,
                                                   learning_rate=0.1))
    s0 = {k: v.numpy().copy() for k, v in trainer.states.items()}
    batch = samples(0, BATCH)
    p64, s64, c64 = trainer.step_f64(batch)
    assert all(v.dtype == np.float64 for v in [*p64.values(),
                                               *s64.values()])
    for n in p0:
        np.testing.assert_array_equal(trainer.parameters[n], p0[n])
    costs = []
    trainer.train(reader=reader_of([batch]), num_passes=1,
                  event_handler=lambda e: costs.append(getattr(e, "cost",
                                                               None)))
    np.testing.assert_allclose([c for c in costs if c is not None], [c64],
                               rtol=1e-6)
    s32 = {k: v.numpy() for k, v in trainer.states.items()}
    for start, wide, got in ((p0, p64, {n: trainer.parameters[n]
                                        for n in p0}), (s0, s64, s32)):
        ratios, _ = witness_ratios(start, wide, got)
        worst = max(ratios, key=ratios.get)
        assert ratios[worst] <= 2e-4, (worst, ratios[worst])


def narrow_resnet50(pool1):
    """ResNet-50's 16 bottleneck blocks at an eighth of the width on a
    64x64 input (res5 at 2x2), pool1 max or average."""
    L, A, P, D = (tpaddle.layer, tpaddle.activation, tpaddle.pooling,
                  importlib.import_module("paddle_tpu_torch.layers.data_type"))
    side = 64
    img = L.data(name="image", type=D.dense_vector(3 * side * side,
                                                   channels=3),
                 height=side, width=side)
    t = TM._conv_bn("conv1", img, 7, 8, 2, 3, channels=3)
    t = L.img_pool(name="pool1", input=t, pool_size=3, stride=2,
                   pool_type=P.MaxPooling() if pool1 == "max"
                   else P.AvgPooling())
    for sname, num, f1, f2, stride in (("res2", 3, 8, 32, 1),
                                       ("res3", 4, 16, 64, 2),
                                       ("res4", 6, 32, 128, 2),
                                       ("res5", 3, 64, 256, 2)):
        t = TM._mid_projection(f"{sname}_1", t, f1, f2, stride=stride)
        for i in range(2, num + 1):
            t = TM._bottleneck(f"{sname}_{i}", t, f1, f2)
    t = L.img_pool(name="avgpool", input=t, pool_size=2, stride=1,
                   pool_type=P.AvgPooling())
    predict = L.fc(input=t, size=CLASSES, act=A.SoftmaxActivation(),
                   name="fc_out")
    label = L.data(name="label", type=D.integer_value(CLASSES))
    return L.cross_entropy_cost(input=predict, label=label, name="loss"), side


@pytest.mark.parametrize("pool1", ["max", "avg"])
def test_full_depth_step_against_the_float64_witness(pool1):
    """Why ``chip_smoke.py`` holds the full ResNet-50 step to its float64
    witness at 0.1 per leaf and no tighter.  At ResNet-50's depth and
    batch 2 (here an eighth of its width), the step with ResNet-50's max
    pool1 moves under a 1e-6 relative nudge of the input, in float64, by
    about as much as the f32 step differs from it (global ratio
    ||p - p64|| / ||p64 - p0||: nudge >= 1e-2 [7.4e-2], f32 <= 2x the
    nudge [6.9e-2]): pool1's argmax routing, amplified through 16 BN
    blocks, makes the step that sensitive.  With an average pool1 the same
    net is well conditioned, and the f32 step lies within round-off of the
    witness: worst leaf <= 2e-3 [5.1e-4]."""
    cost, side = narrow_resnet50(pool1)
    params = tpaddle.parameters.create(cost)
    p0 = {n: params[n].copy() for n in params.names()}
    rng = np.random.default_rng(0)
    batch = [(rng.normal(size=3 * side * side).astype(np.float32),
              int(rng.integers(0, CLASSES))) for _ in range(2)]
    trainer = tpaddle.trainer.SGD(
        cost=cost, parameters=params, device="cpu",
        update_equation=tpaddle.optimizer.Momentum(momentum=0.9,
                                                   learning_rate=0.1 / 64))
    p64, _, _ = trainer.step_f64(batch)
    nudged = [(x * (1 + 1e-6 * rng.normal(size=x.shape)).astype(np.float32),
               y) for x, y in batch]
    p64_nudged, _, _ = trainer.step_f64(nudged)
    trainer.train(reader=reader_of([batch]), num_passes=1,
                  event_handler=lambda e: None)
    ratios, global_ratio = witness_ratios(
        p0, p64, {n: trainer.parameters[n] for n in p0})
    _, nudge_ratio = witness_ratios(p0, p64, p64_nudged)
    if pool1 == "max":
        assert nudge_ratio >= 1e-2, nudge_ratio
        assert global_ratio <= 2 * nudge_ratio, (global_ratio, nudge_ratio)
    else:
        assert max(ratios.values()) <= 2e-3, max(ratios.items(),
                                                 key=lambda kv: kv[1])


def test_resnet50_topology_equals_the_jax_one():
    jcost = JM.resnet_cost(depth=50)[0]
    tcost = tpaddle.models.image.resnet_cost(depth=50)[0]
    jtopo, ttopo = JTopology(jcost), TTopology(tcost)
    jp = [(s.name, s.shape) for s in jtopo.param_specs()]
    tp = [(s.name, s.shape) for s in ttopo.param_specs()]
    js = [(s.name, s.shape) for s in jtopo.state_specs()]
    ts = [(s.name, s.shape) for s in ttopo.state_specs()]
    assert len(tp) == 161 and len(ts) == 106
    assert tp == jp and ts == js
    assert ttopo.serialize() == jtopo.serialize()
    assert ttopo.digest() == jtopo.digest()
    assert [n.name for n in ttopo.nodes] == [n.name for n in jtopo.nodes]
    conv_bn = [n for n in ttopo.nodes if n.layer_type == "conv_bn"]
    one_by_one = [n for n in conv_bn if n.attrs["filter_size"] == [1, 1]]
    assert (len(one_by_one), len(conv_bn) - len(one_by_one)) == (36, 17)


def test_states_and_parameters_carry_by_name():
    tcost = mini_resnet(tpaddle, TM)
    topo = TTopology(tcost)
    jstates = {s.name: np.full(s.shape, 0.5, np.float32)
               for s in topo.state_specs()}
    states = topo.states_from_numpy(jstates)
    assert all(torch.equal(v, torch.full_like(v, 0.5))
               for v in states.values())
    params = tpaddle.parameters.create(tcost)
    arrays = {n: params[n] * 2 for n in params.names()}
    again = tpaddle.parameters.Parameters.from_numpy({**arrays, **jstates})
    trainer = tpaddle.trainer.SGD(
        cost=tcost, parameters=again, device="cpu",
        update_equation=tpaddle.optimizer.SGD(learning_rate=0.1))
    for n in params.names():
        np.testing.assert_array_equal(trainer.parameters[n], arrays[n])
    for n, v in trainer.states.items():   # BN statistics loaded by name
        np.testing.assert_array_equal(v.numpy(), jstates[n])


def test_trainer_refuses_what_it_does_not_take():
    from paddle_tpu_torch.core.enforce import EnforceError

    tcost = mini_resnet(tpaddle, TM)
    params = tpaddle.parameters.create(tcost)
    opt = tpaddle.optimizer.SGD(learning_rate=0.1)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        tpaddle.trainer.SGD(cost=tcost, parameters=params,
                            update_equation=opt, device="cpu",
                            compute_dtype=torch.float16)
    with pytest.raises(TypeError):
        tpaddle.trainer.SGD(cost=tcost, parameters=params,
                            update_equation=opt, device="cpu", zero=2)
    if not torch.cuda.is_available():
        with pytest.raises(EnforceError, match="no CUDA card"):
            tpaddle.trainer.SGD(cost=tcost, parameters=params,
                                update_equation=opt)
