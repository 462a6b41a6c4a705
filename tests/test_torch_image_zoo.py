"""The image model zoo in the port (``models/image``: smallnet, AlexNet,
VGG, GoogLeNet; ``layers/networks.small_vgg``) against the JAX package.

- Every net's ``Topology.serialize()`` is byte-equal to JAX's (so the
  digests agree), with the censuses of ``tests/test_models_image.py``
  (AlexNet 16, GoogLeNet 116, VGG-19 38 parameter tensors) and
  small_vgg's 46 tensors, 7,909,450 parameters and 22 states.
- The port's CIFAR-10 reader gives the JAX package's samples in order.
- smallnet trains 5 Momentum steps through ``trainer.SGD`` beside the JAX
  trainer, and a copy of small_vgg at full width with every drop rate at
  0 (JAX's threefry and PyTorch's generators draw different masks) trains
  5 steps of the book's Momentum at batch 4 beside the JAX train step,
  from the same carried parameters on the same CIFAR samples.  smallnet's
  costs agree within rtol 2e-6 and its parameters within 5e-5 x max(1,
  max |ref|) over the 5 steps; small_vgg's first step at the same
  tolerances (its BN moving statistics within 5e-5), and its 5-step f32
  trajectory against a float64 witness as closely as the JAX package's
  own (see the test).
- The forward of each net at batch 1 (AlexNet at 227x227, the others at
  their published input) is finite with the expected shape."""

import importlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.dataset import cifar as jcifar
from paddle_tpu.models import image as JM
from paddle_tpu.trainer.step import build_train_step as j_train_step
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.dataset import cifar as tcifar
from paddle_tpu_torch.models import image as TM
from paddle_tpu_torch.trainer.step import build_train_step as t_train_step

COST_RTOL, PARAM_TOL = 2e-6, 5e-5


@pytest.fixture(autouse=True)
def _fresh_names():
    from paddle_tpu.layers.base import reset_name_counters as jreset
    from paddle_tpu_torch.layers.base import reset_name_counters as treset

    jreset()
    treset()
    yield


def small_vgg_cost(paddle, drop=True):
    """small_vgg over 32x32x3 CIFAR images with ``classification_cost``;
    ``drop=False`` builds the same net with every drop rate at 0 (the
    groups through ``img_conv_group`` as ``networks.small_vgg`` does)."""
    pkg = paddle.__name__
    L = importlib.import_module(pkg + ".layers.api")
    A = importlib.import_module(pkg + ".layers.activation")
    D = importlib.import_module(pkg + ".layers.data_type")
    P = importlib.import_module(pkg + ".layers.pooling")
    N = importlib.import_module(pkg + ".layers.networks")
    img = L.data(name="image", type=D.dense_vector(3072))
    label = L.data(name="label", type=D.integer_value(10))
    if drop:
        predict = N.small_vgg(img, 3, 10)
    else:
        t = img
        for i, (nf, times) in enumerate(((64, 2), (128, 2), (256, 3),
                                         (512, 3))):
            t = N.img_conv_group(
                input=t, num_channels=3 if i == 0 else None, pool_size=2,
                pool_stride=2, conv_num_filter=[nf] * times,
                conv_filter_size=3, conv_act=A.ReluActivation(),
                conv_with_batchnorm=True, conv_batchnorm_drop_rate=0,
                pool_type=P.MaxPooling())
        t = L.img_pool(input=t, stride=2, pool_size=2,
                       pool_type=P.MaxPooling())
        t = L.fc(input=t, size=512, act=A.LinearActivation())
        t = L.batch_norm(input=t, act=A.ReluActivation())
        predict = L.fc(input=t, size=10, act=A.SoftmaxActivation())
    return L.classification_cost(input=predict, label=label)


ZOO = {
    "smallnet": (lambda M: M.smallnet_cost()[0], None),
    "alexnet": (lambda M: M.alexnet_cost()[0], 16),
    "googlenet": (lambda M: M.googlenet_cost()[0], 116),
    "vgg19": (lambda M: M.vgg_cost(depth=19)[0], 38),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_digest_and_census_match_jax(name):
    build, n_tensors = ZOO[name]
    jt = JTopology(build(JM))
    from paddle_tpu_torch.layers.base import reset_name_counters

    reset_name_counters()
    tt = TTopology(build(TM))
    assert tt.serialize() == jt.serialize()
    assert tt.digest() == jt.digest()
    if n_tensors is not None:
        assert len(tt.param_specs()) == n_tensors


def test_small_vgg_digest_and_census_match_jax():
    jt = JTopology(small_vgg_cost(jpaddle))
    tt = TTopology(small_vgg_cost(tpaddle))
    assert tt.digest() == jt.digest()
    specs = tt.param_specs()
    assert len(specs) == 46
    assert sum(int(np.prod(s.shape)) for s in specs) == 7_909_450
    assert len(tt.state_specs()) == 22
    assert sorted({n.layer_type for n in tt.nodes}) == [
        "batch_norm", "data", "dropout", "exconv", "fc",
        "multi-class-cross-entropy", "pool"]


def test_cifar_reader_gives_the_jax_samples():
    for jr, tr in ((jcifar.train10(), tpaddle.dataset.cifar.train10()),
                   (jcifar.test10(), tcifar.test10())):
        for (jx, jy), (tx, ty) in zip(list(jr())[:40], list(tr())[:40]):
            assert jy == ty and np.array_equal(jx, tx)
    assert len(list(tcifar.test10()())) == tcifar.TEST_SIZE


def reader_of(batches):
    return lambda: iter(batches)


def test_smallnet_trajectory_matches_the_jax_trainer():
    bs = 8
    jcost, tcost = JM.smallnet_cost()[0], TM.smallnet_cost()[0]
    jparams = jpaddle.parameters.create(JTopology(jcost))
    carried = {n: np.asarray(jparams[n]) for n in jparams.names()}

    def opt(pkg):
        return pkg.optimizer.Momentum(momentum=0.9, learning_rate=0.01 / bs)

    jtr = jpaddle.trainer.SGD(cost=jcost, parameters=jparams,
                              update_equation=opt(jpaddle))
    ttr = tpaddle.trainer.SGD(
        cost=tcost, parameters=tpaddle.parameters.Parameters.from_numpy(
            carried), update_equation=opt(tpaddle), device="cpu")
    data = list(tcifar.train10()())[:5 * bs]
    batches = [data[i:i + bs] for i in range(0, len(data), bs)]
    got = {"jax": [], "torch": []}

    def handler(key):
        return lambda e: got[key].append(e.cost) if type(
            e).__name__ == "EndIteration" else None

    jtr.train(reader=reader_of(batches), num_passes=1,
              event_handler=handler("jax"))
    ttr.train(reader=reader_of(batches), num_passes=1,
              event_handler=handler("torch"))
    assert len(got["torch"]) == 5
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=COST_RTOL)
    for n in carried:
        want = np.asarray(jtr.parameters[n])
        np.testing.assert_allclose(
            ttr.parameters[n], want, rtol=0,
            atol=PARAM_TOL * max(1.0, np.abs(want).max()), err_msg=n)


def test_small_vgg_without_dropout_matches_the_jax_step():
    """5 steps at batch 4 of the book's Momentum (0.9, lr 0.1 / 128, L2
    0.0002 x 128) from the same parameters on the same CIFAR samples.

    The trajectory is ill-conditioned at batch 4 (batch norm over a few
    rows, ReLU and max-pool routing amplify round-off): a 1e-6 relative
    nudge of the images moves the float64 cost by ~1e-2 by step 4, and
    the JAX package's f32 costs stray up to ~20% from the float64
    trajectory there.  So the costs are held against the float64 run of
    the same steps (the port's plain path in double precision): at every
    step the port's f32 cost lies within the largest of 2e-6 relative,
    10x the nudge's move and twice the JAX package's own distance from
    it.  The first step is held to JAX itself: its cost within 2e-6
    relative or 10x the nudge's move, its parameters and BN statistics
    within 5e-5 x max(1, max |ref|)."""
    bs, steps = 4, 5
    jcost, tcost = small_vgg_cost(jpaddle, False), small_vgg_cost(
        tpaddle, False)
    jt, tt = JTopology(jcost), TTopology(tcost)
    assert tt.serialize() == jt.serialize()

    def opt(pkg):
        return pkg.optimizer.Momentum(
            momentum=0.9, learning_rate=0.1 / 128,
            regularization=pkg.optimizer.L2Regularization(rate=0.0002 * 128))

    jparams = jpaddle.parameters.create(jt).as_dict()
    carried = {n: np.array(v) for n, v in jparams.items()}
    jopt = opt(jpaddle)
    jstep = j_train_step(jt, jopt)
    specs = {s.name: s for s in jt.param_specs()}
    p, o, s = jparams, jopt.init(jparams, specs), jt.init_states()
    data = list(tcifar.train10()())[:steps * bs]
    batches = [data[i:i + bs] for i in range(0, len(data), bs)]
    jcosts, first = [], None
    for batch in batches:
        feed = {"image": np.stack([x for x, _ in batch]),
                "label": np.array([y for _, y in batch], np.int32)}
        p, o, s, c, _ = jstep(p, o, s, feed, jax.random.key(0))
        jcosts.append(float(c))
        if first is None:
            first = ({n: np.asarray(v) for n, v in p.items()},
                     {n: np.asarray(v) for n, v in s.items()})

    def port(dtype, n_steps, nudge=0.0):
        tstep = t_train_step(tt, opt(tpaddle))
        tp = {n: torch.from_numpy(v).to(dtype) for n, v in carried.items()}
        to = opt(tpaddle).init(tp, {x.name: x for x in tt.param_specs()})
        ts = {k: v.to(dtype) for k, v in tt.init_states().items()}
        costs = []
        for batch in batches[:n_steps]:
            img = np.stack([x for x, _ in batch]).astype(np.float64)
            img *= 1 + nudge * np.random.default_rng(0).standard_normal(
                img.shape)
            feed = {"image": torch.from_numpy(img).to(dtype),
                    "label": torch.tensor([y for _, y in batch])}
            tp, to, ts, c, _ = tstep(tp, to, ts, feed, 0)
            costs.append(float(c))
        return costs, tp, ts

    ttr = tpaddle.trainer.SGD(
        cost=tcost, parameters=tpaddle.parameters.Parameters.from_numpy(
            carried), update_equation=opt(tpaddle), device="cpu")
    tcosts = []
    ttr.train(reader=reader_of(batches[:1]), num_passes=1,
              event_handler=lambda e: tcosts.append(e.cost)
              if isinstance(e, tpaddle.event.EndIteration) else None)
    for n, want in first[0].items():
        np.testing.assert_allclose(
            ttr.parameters[n], want, rtol=0,
            atol=PARAM_TOL * max(1.0, np.abs(want).max()), err_msg=n)
    assert sorted(ttr.states) == sorted(first[1])
    for n, want in first[1].items():
        np.testing.assert_allclose(ttr.states[n].numpy(), want, rtol=0,
                                   atol=PARAM_TOL, err_msg=n)

    c32, _, _ = port(torch.float32, steps)
    c64, _, _ = port(torch.float64, steps)
    c64n, _, _ = port(torch.float64, steps, nudge=1e-6)
    moved = [abs(a - b) for a, b in zip(c64n, c64)]
    assert c32[0] == tcosts[0]
    assert abs(c32[0] - jcosts[0]) <= max(COST_RTOL * abs(jcosts[0]),
                                          10 * moved[0]), (c32, jcosts, c64n)
    for k in range(steps):
        limit = max(COST_RTOL * abs(c64[k]), 10 * moved[k],
                    2 * abs(jcosts[k] - c64[k]))
        assert abs(c32[k] - c64[k]) <= limit, (k, c32, jcosts, c64, c64n)


@pytest.mark.parametrize("name,side,classes", [
    ("smallnet", 32, 10), ("alexnet", 227, 1000), ("googlenet", 224, 1000),
    ("vgg", 224, 1000)])
def test_zoo_forward_runs_in_test_mode(name, side, classes):
    """One test-mode forward at batch 1 of each net on the CPU: the
    probabilities are finite, of the expected shape, and sum to 1."""
    predict, _, _ = getattr(TM, name)()
    topo = TTopology(predict)
    params = tpaddle.parameters.create(topo).as_dict()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 3 * side * side)).astype(np.float32))
    with torch.no_grad():
        vals, _ = topo.forward(params, topo.init_states(), {"image": x},
                               False)
    out = vals[predict.name]
    assert out.shape == (1, classes) and torch.isfinite(out).all()
    torch.testing.assert_close(out.sum(), torch.tensor(1.0))
