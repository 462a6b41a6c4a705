"""The port's v2 layers (``paddle_tpu_torch.layers.api``) against the JAX
package's on the same graph: one builder, called once with each package's
modules, so names and wiring are identical; the JAX parameters are carried
to the port by name (``Parameters.from_numpy``) and both forwards run on
the same numpy feed.  Every layer value and every updated state is
compared.

Tolerance: atol = rtol = 2e-5 for products, pooling and the cost (f32
summation order); 1e-4 for outputs downstream of a train-mode batch norm,
whose normalization divides by a batch standard deviation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.config.topology as JTopo
import paddle_tpu.core.parameters as JParams
import paddle_tpu.layers.activation as JA
import paddle_tpu.layers.api as JL
import paddle_tpu.layers.data_type as JD
import paddle_tpu.layers.pooling as JP
import paddle_tpu_torch.config.topology as TTopo
import paddle_tpu_torch.core.parameters as TParams
import paddle_tpu_torch.layers.activation as TA
import paddle_tpu_torch.layers.api as TL
import paddle_tpu_torch.layers.data_type as TD
import paddle_tpu_torch.layers.pooling as TP
from paddle_tpu.layers.attr import ParamAttr as JParamAttr
from paddle_tpu_torch.layers.attr import ParamAttr as TParamAttr
from paddle_tpu_torch.layers.base import reset_name_counters

JAX = dict(L=JL, A=JA, P=JP, D=JD, attr=JParamAttr, topo=JTopo)
TORCH = dict(L=TL, A=TA, P=TP, D=TD, attr=TParamAttr, topo=TTopo)


@pytest.fixture(autouse=True)
def _fresh_port_names():
    reset_name_counters()
    yield


def run_both(build, feed, is_train=True, states=None):
    """Build the graph in both packages, carry parameters and states, run
    both forwards.  Returns (jax values, port values, jax states, port
    states, the two topologies)."""
    j_out, t_out = build(**JAX), build(**TORCH)
    jt, tt = JTopo.Topology(j_out), TTopo.Topology(t_out)
    assert tt.serialize() == jt.serialize()
    jparams = JParams.create(jt).as_dict()
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tparams = TParams.Parameters.from_numpy(np_params).as_dict()
    jstates = jt.init_states()
    if states:
        jstates.update({k: jnp.asarray(v) for k, v in states.items()})
    tstates = tt.states_from_numpy({k: np.asarray(v)
                                    for k, v in jstates.items()})
    jv, js = jt.forward(jparams, jstates,
                        {k: jnp.asarray(v) for k, v in feed.items()},
                        is_train, jax.random.key(0))
    tv, ts = tt.forward(tparams, tstates,
                        {k: torch.from_numpy(v) for k, v in feed.items()},
                        is_train)
    return jv, tv, js, ts, jt, tt


def assert_values_close(jv, tv, tol=2e-5, names=None):
    for name in names or jv:
        np.testing.assert_allclose(tv[name].detach().numpy(),
                                   np.asarray(jv[name]), rtol=tol, atol=tol,
                                   err_msg=name)


def _image(rng, b, c, h, w):
    return rng.normal(size=(b, c * h * w)).astype(np.float32)


def test_fc_two_inputs_default_tanh_and_softmax():
    def build(L, A, D, **_):
        x = L.data(name="x", type=D.dense_vector(7))
        z = L.data(name="z", type=D.dense_vector(3))
        h = L.fc(input=[x, z], size=5, name="h")          # tanh default
        return L.fc(input=h, size=4, act=A.SoftmaxActivation(), name="p")

    rng = np.random.default_rng(0)
    feed = {"x": rng.normal(size=(6, 7)).astype(np.float32),
            "z": rng.normal(size=(6, 3)).astype(np.float32)}
    jv, tv, *_ = run_both(build, feed)
    assert_values_close(jv, tv)


def test_fc_on_a_4d_input_flattens_nhwc_like_jax():
    """An fc after a conv flattens [B, H, W, C] per example in H, W, C
    order, so carried fc weights mean the same thing."""
    def build(L, A, D, **_):
        img = L.data(name="image", type=D.dense_vector(3 * 5 * 6,
                                                       channels=3),
                     height=5, width=6)
        c = L.img_conv(input=img, filter_size=3, num_filters=4, padding=1,
                       name="c")
        return L.fc(input=c, size=3, act=A.LinearActivation(), name="f")

    feed = {"image": _image(np.random.default_rng(1), 2, 3, 5, 6)}
    jv, tv, *_ = run_both(build, feed)
    assert tuple(tv["c"].shape) == (2, 5, 6, 4)
    assert_values_close(jv, tv)


@pytest.mark.parametrize("k,s,p,groups", [(3, 1, 1, 1), (3, 2, 1, 1),
                                          (1, 2, 0, 1), (5, 1, 2, 1),
                                          (3, 1, 1, 2)])
def test_img_conv_matches_jax(k, s, p, groups):
    def build(L, A, D, **_):
        img = L.data(name="image", type=D.dense_vector(4 * 13 * 14,
                                                       channels=4),
                     height=13, width=14)
        return L.img_conv(input=img, filter_size=k, num_filters=6, stride=s,
                          padding=p, groups=groups, name="c")

    feed = {"image": _image(np.random.default_rng(k + s), 2, 4, 13, 14)}
    jv, tv, *_ = run_both(build, feed)
    assert_values_close(jv, tv)


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("size,k,s,p", [((13, 14), 3, 2, 0),
                                        ((13, 14), 3, 2, 1),
                                        ((112, 112), 3, 2, 0),
                                        ((7, 7), 7, 1, 0),
                                        ((9, 10), 2, 2, 0)])
def test_img_pool_ceil_mode_matches_jax(pool, size, k, s, p):
    """Ceil-mode windows past the edge see the explicit -inf (max) or
    zero pad, and average pooling divides by the real cells only."""
    h, w = size

    def build(L, P, D, **_):
        img = L.data(name="image", type=D.dense_vector(3 * h * w, channels=3),
                     height=h, width=w)
        ptype = P.MaxPooling() if pool == "max" else P.AvgPooling()
        return L.img_pool(input=img, pool_size=k, stride=s, padding=p,
                          pool_type=ptype, name="pool")

    feed = {"image": _image(np.random.default_rng(h + k), 2, 3, h, w)}
    jv, tv, _, _, jt, tt = run_both(build, feed)
    node = tt.nodes[-1]
    assert tuple(tv["pool"].shape) == (2, node.height, node.width, 3)
    assert_values_close(jv, tv)


def test_pool1_shape_is_the_resnet_ceil_shape():
    """3x3 s2 on 112 -> 56 windows: the last one needs an extra -inf pad."""
    img = TL.data(name="image", type=TD.dense_vector(64 * 112 * 112,
                                                     channels=64),
                  height=112, width=112)
    pool = TL.img_pool(input=img, pool_size=3, stride=2, name="pool1")
    assert (pool.height, pool.width) == (56, 56)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("act", ["relu", "linear", "tanh"])
def test_img_conv_bn_and_addto_match_jax(is_train, act):
    def build(L, A, D, **_):
        acts = {"relu": A.ReluActivation(), "linear": A.LinearActivation(),
                "tanh": A.TanhActivation()}
        img = L.data(name="image", type=D.dense_vector(3 * 9 * 10,
                                                       channels=3),
                     height=9, width=10)
        a = L.img_conv_bn(input=img, filter_size=3, num_filters=8, stride=1,
                          padding=1, act=acts[act], name="a")
        b = L.img_conv_bn(input=a, filter_size=1, num_filters=8, stride=1,
                          padding=0, act=A.LinearActivation(), name="b")
        return L.addto(input=[a, b], act=A.ReluActivation(), name="sum")

    rng = np.random.default_rng(7)
    feed = {"image": _image(rng, 3, 3, 9, 10)}
    states = {"_a_bn.w1": rng.normal(size=8).astype(np.float32) * 0.1,
              "_a_bn.w2": np.abs(rng.normal(size=8)).astype(np.float32) + 0.5}
    jv, tv, js, ts, *_ = run_both(build, feed, is_train, states)
    assert_values_close(jv, tv, tol=1e-4)
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
    if not is_train:   # eval leaves the running statistics as they were
        for k in js:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_addto_with_bias_on_flat_inputs_matches_jax():
    def build(L, A, D, **_):
        x = L.data(name="x", type=D.dense_vector(5))
        z = L.data(name="z", type=D.dense_vector(5))
        return L.addto(input=[x, z], act=A.ReluActivation(), bias_attr=True,
                       name="sum")

    rng = np.random.default_rng(2)
    feed = {k: rng.normal(size=(4, 5)).astype(np.float32) for k in "xz"}
    jv, tv, *_ = run_both(build, feed)
    assert_values_close(jv, tv)


def test_cross_entropy_cost_matches_jax():
    def build(L, A, D, **_):
        x = L.data(name="x", type=D.dense_vector(6))
        p = L.fc(input=x, size=5, act=A.SoftmaxActivation(), name="p")
        y = L.data(name="label", type=D.integer_value(5))
        return L.cross_entropy_cost(input=p, label=y, name="loss")

    rng = np.random.default_rng(3)
    feed = {"x": rng.normal(size=(8, 6)).astype(np.float32) * 3,
            "label": rng.integers(0, 5, size=(8,)).astype(np.int32)}
    jv, tv, *_ = run_both(build, feed)
    assert tv["loss"].dim() == 0
    assert_values_close(jv, tv, names=["p", "loss"])


def test_param_specs_carry_decay_momentum_and_lr_like_jax():
    def build(L, A, D, attr, **_):
        x = L.data(name="x", type=D.dense_vector(4))
        return L.fc(input=x, size=3, name="f",
                    param_attr=attr(l2_rate=1e-3, momentum=0.5,
                                    learning_rate=2.0,
                                    gradient_clipping_threshold=1.0))

    js = {s.name: s for s in JTopo.Topology(build(**JAX)).param_specs()}
    ts = {s.name: s for s in TTopo.Topology(build(**TORCH)).param_specs()}
    assert sorted(js) == sorted(ts)
    for name in js:
        for field in ("shape", "is_static", "learning_rate", "decay_rate",
                      "momentum", "gradient_clipping_threshold"):
            assert getattr(ts[name], field) == getattr(js[name], field)


def test_options_not_ported_raise():
    from paddle_tpu_torch.layers.attr import ExtraAttr

    x = TL.data(name="x", type=TD.dense_vector(4))
    with pytest.raises(NotImplementedError, match="error_clipping"):
        TL.fc(input=x, size=3,
              layer_attr=ExtraAttr(error_clipping_threshold=1.0))
    img = TL.data(name="image", type=TD.dense_vector(12, channels=3),
                  height=2, width=2)
    with pytest.raises(NotImplementedError, match="transposed"):
        TL.img_conv(input=img, filter_size=1, num_filters=2, trans=True)
