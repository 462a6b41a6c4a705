"""Batch norm and its moments kernel, and the other layers the image zoo
needs (``img_cmrnorm``, ``concat``), in the port against the JAX package
on the same numpy inputs.

- ``channel_stats_reference`` and its gradient (``channel_stats_grad``,
  the JAX vjp ``dx = g_s + 2 x g_ss``) against JAX's ``channel_stats``
  with ``impl="kernel", interpret=True`` (the Pallas kernel, 512-row
  blocks) and against its reference, at ragged row counts: 2e-5.
- ``layer.batch_norm`` in train and test mode, image and flat forms,
  ``use_global_stats`` True and False: outputs, the gradients of a random
  cotangent by the input, gamma and beta, and the new moving statistics
  at 2e-6 x max(1, max |ref|), with the train-mode moments through
  ``moments`` (``use_fused_stats=None`` on the CPU) and through the
  ``channel_stats`` route (the kernel's twin on the CPU).
- ``img_cmrnorm`` and ``concat`` (image, sequence and flat forms)
  forward and backward: 2e-6 x max(1, max |ref|).
- Parameters and BN moving statistics trained by the JAX trainer move
  into the port's trainer by name; its ``test`` cost then agrees within
  rtol 2e-6.

Parameters and states move from the JAX package by name."""

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
import paddle_tpu_torch.config.topology as TTopo
import paddle_tpu_torch.layers.activation as TA
import paddle_tpu_torch.layers.api as TL
import paddle_tpu_torch.layers.data_type as TD
from paddle_tpu.core.lod import SequenceBatch as JSeq
from paddle_tpu.ops.pallas import tpp
from paddle_tpu_torch.core.lod import SequenceBatch as TSeq
from paddle_tpu_torch.ops import nn as tnn
from paddle_tpu_torch.ops.kernels import channel_stats as CS

JAX = dict(L=JL, A=JA, D=JD)
TORCH = dict(L=TL, A=TA, D=TD)
TOL = 2e-6


@pytest.fixture(autouse=True)
def _fresh_names():
    from paddle_tpu.layers.base import reset_name_counters as jreset
    from paddle_tpu_torch.layers.base import reset_name_counters as treset

    jreset()
    treset()
    yield


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, tol * scale)


# -- channel_stats ------------------------------------------------------------

STATS_SHAPES = [(3, 5, 7, 11), (1, 1, 1, 3), (3, 19, 11, 8), (1029, 5),
                (2, 3, 100, 16)]


@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_channel_stats_twin_and_grad_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32) * 2 + 0.5
    gs = rng.normal(size=shape[-1:]).astype(np.float32)
    gss = rng.normal(size=shape[-1:]).astype(np.float32)

    def jloss(impl, interpret):
        def f(v):
            s, ss = tpp.channel_stats(v, impl, interpret)
            return jnp.sum(s * gs) + jnp.sum(ss * gss)
        return f

    want = {}
    for key, impl, interp in (("kernel", "kernel", True),
                              ("reference", "reference", None)):
        s, ss = tpp.channel_stats(jnp.asarray(x), impl, interp)
        dx = jax.grad(jloss(impl, interp))(jnp.asarray(x))
        want[key] = [np.asarray(s), np.asarray(ss), np.asarray(dx)]
    xt = torch.from_numpy(x).requires_grad_()
    s, ss = CS.channel_stats(xt)
    (dx,) = torch.autograd.grad((s * torch.from_numpy(gs)).sum()
                                + (ss * torch.from_numpy(gss)).sum(), [xt])
    got = [s.detach(), ss.detach(), dx]
    explicit = CS.channel_stats_grad(xt.detach(), torch.from_numpy(gs),
                                     torch.from_numpy(gss))
    for ref in want.values():
        for a, b in zip(got + [explicit], ref + [ref[2]]):
            close(a, b, 2e-5)


@pytest.mark.parametrize("rows", [1, 7, 255, 256, 257, 4096, 131072, 131073,
                                  10 ** 7])
def test_channel_stats_plan_covers_the_rows_exactly(rows):
    """P row blocks of rows_per_block rows cover R exactly, at most
    MAX_BLOCKS of them; the plan is a function of R alone."""
    p, per = CS.plan(rows)
    assert 1 <= p <= CS.MAX_BLOCKS
    assert (p - 1) * per < rows <= p * per
    assert CS.plan(rows) == (p, per)


# -- layer.batch_norm ------------------------------------------------------------


def bn_graph(L, A, D, form, use_global_stats):
    if form == "image":
        x = L.data(name="x", type=D.dense_vector(6 * 5 * 4, channels=6),
                   height=5, width=4)
    else:
        x = L.data(name="x", type=D.dense_vector(6))
    return L.batch_norm(input=x, act=A.ReluActivation(), name="bn",
                        use_global_stats=use_global_stats,
                        moving_average_fraction=0.8)


def run_bn(form, is_train, use_global_stats, fused):
    """(jax [y, dx, dgamma, dbeta, mean, var], port [...])."""
    rng = np.random.default_rng(7)
    b = 5
    x = rng.normal(size=(b, 120 if form == "image" else 6)
                   ).astype(np.float32) * 1.5 + 0.3
    jt = JTopo.Topology(bn_graph(**JAX, form=form,
                                 use_global_stats=use_global_stats))
    tt = TTopo.Topology(bn_graph(**TORCH, form=form,
                                 use_global_stats=use_global_stats))
    assert tt.serialize() == jt.serialize()
    params = {n: np.asarray(v) for n, v in JParams.create(jt).as_dict().items()}
    params["_bn.w0"] = (1 + 0.2 * rng.normal(size=6)).astype(np.float32)
    params["_bn.wbias"] = (0.2 * rng.normal(size=6)).astype(np.float32)
    states = {"_bn.w1": (0.1 * rng.normal(size=6)).astype(np.float32),
              "_bn.w2": (0.5 + rng.random(6)).astype(np.float32)}
    out_shape = (b, 5, 4, 6) if form == "image" else (b, 6)
    cot = rng.normal(size=out_shape).astype(np.float32)

    def jf(xv, g, be):
        p = dict(params, **{"_bn.w0": g, "_bn.wbias": be})
        vals, st = jt.forward(p, {k: jnp.asarray(v) for k, v in states.items()},
                              {"x": xv}, is_train, jax.random.key(0))
        return jnp.sum(vals["bn"] * cot), (vals["bn"], st)

    (_, (jy, jst)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(x), jnp.asarray(params["_bn.w0"]),
        jnp.asarray(params["_bn.wbias"]))
    want = [jy, *jg, jst["_bn.w1"], jst["_bn.w2"]]

    xt = torch.from_numpy(x).requires_grad_()
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    tp["_bn.w0"].requires_grad_()
    tp["_bn.wbias"].requires_grad_()
    orig = tnn._takes_kernel
    if fused:   # route the moments through channel_stats (its CPU twin)
        tnn._takes_kernel = lambda v: True
    try:
        vals, st = tt.forward(tp, tt.states_from_numpy(states), {"x": xt},
                              is_train, seed=0)
    finally:
        tnn._takes_kernel = orig
    grads = torch.autograd.grad((vals["bn"] * torch.from_numpy(cot)).sum(),
                                [xt, tp["_bn.w0"], tp["_bn.wbias"]])
    got = [vals["bn"].detach(), *grads, st["_bn.w1"], st["_bn.w2"]]
    return want, got


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("use_global_stats", [None, True, False])
@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("form", ["image", "flat"])
def test_batch_norm_layer_matches_jax(form, is_train, use_global_stats,
                                      fused):
    want, got = run_bn(form, is_train, use_global_stats, fused)
    for a, b in zip(got, want):
        close(a.detach().numpy(), np.asarray(b))


def test_fused_stats_route_on_the_cpu():
    """``use_fused_stats=True`` takes the channel_stats twin on the CPU,
    None and False take ``moments``; the three agree within f32 round-off,
    and the statistics are the biased variance with ``m * running +
    (1 - m) * batch``."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 3, 3, 5)).astype(np.float32))
    one, zero = torch.ones(5), torch.zeros(5)
    outs = [tnn.batch_norm(x, one, zero, zero, one, True, momentum=0.9,
                           use_fused_stats=f) for f in (None, False, True)]
    flat = x.reshape(-1, 5).double()
    mean, var = flat.mean(0), flat.var(0, unbiased=False)
    for y, nm, nv in outs:
        close(nm.numpy(), (0.1 * mean).numpy())
        close(nv.numpy(), (0.9 + 0.1 * var).numpy())
        close(y.numpy(), ((flat - mean) / torch.sqrt(var + 1e-5)
                          ).reshape(x.shape).numpy(), 1e-5)
    assert torch.equal(outs[0][0], outs[1][0])


def test_img3d_batch_norm_is_refused():
    x = TL.data(name="x", type=TD.dense_vector(8))
    with pytest.raises(NotImplementedError, match="img3D"):
        TL.batch_norm(input=x, img3D=True)


# -- img_cmrnorm and concat ------------------------------------------------------------


def lrn_graph(L, A, D):
    x = L.data(name="x", type=D.dense_vector(7 * 4 * 3, channels=7),
               height=4, width=3)
    return L.img_cmrnorm(input=x, size=5, scale=0.5, power=0.75,
                         name="norm")


def concat_graph(L, A, D, form):
    if form == "image":
        a = L.data(name="a", type=D.dense_vector(2 * 3 * 3, channels=2),
                   height=3, width=3)
        b = L.data(name="b", type=D.dense_vector(3 * 3 * 3, channels=3),
                   height=3, width=3)
        a = L.img_pool(input=a, pool_size=1, stride=1, name="pa")
        b = L.img_pool(input=b, pool_size=1, stride=1, name="pb")
    elif form == "sequence":
        a = L.data(name="a", type=D.dense_vector_sequence(4))
        b = L.data(name="b", type=D.dense_vector_sequence(3))
    else:
        a = L.data(name="a", type=D.dense_vector(4))
        b = L.data(name="b", type=D.dense_vector(3))
    return L.concat(input=[a, b], act=A.TanhActivation(), name="cat")


def forward_and_grads(build, feeds, cot_shape, out_name, seqlens=None):
    """(jax [y, *grads], port [y, *grads]) of one forward and the
    gradient of sum(y * cot) by every feed."""
    rng = np.random.default_rng(3)
    jt, tt = (JTopo.Topology(build(**JAX)), TTopo.Topology(build(**TORCH)))
    assert tt.serialize() == jt.serialize()
    cot = rng.normal(size=cot_shape).astype(np.float32)
    names = list(feeds)

    def wrap_j(n, v):
        return JSeq(v, jnp.asarray(seqlens)) if seqlens is not None else v

    def jf(*xs):
        vals, _ = jt.forward({}, {}, {n: wrap_j(n, x)
                                      for n, x in zip(names, xs)}, True,
                             jax.random.key(0))
        y = vals[out_name]
        y = y.data if isinstance(y, JSeq) else y
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.value_and_grad(jf, argnums=tuple(range(len(names))),
                                     has_aux=True)(
        *(jnp.asarray(feeds[n]) for n in names))
    leaves = [torch.from_numpy(feeds[n]).requires_grad_() for n in names]
    tfeed = {n: (TSeq(v, torch.as_tensor(seqlens)) if seqlens is not None
                 else v) for n, v in zip(names, leaves)}
    vals, _ = tt.forward({}, {}, tfeed, True, seed=0)
    y = vals[out_name]
    y = y.data if isinstance(y, TSeq) else y
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    return [jy, *jg], [y.detach(), *grads]


def test_img_cmrnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 84)).astype(np.float32)
    want, got = forward_and_grads(lrn_graph, {"x": x}, (2, 4, 3, 7), "norm")
    for a, b in zip(got, want):
        close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("form", ["image", "sequence", "flat"])
def test_concat_matches_jax(form):
    rng = np.random.default_rng(1)
    if form == "image":
        feeds = {"a": rng.normal(size=(2, 18)), "b": rng.normal(size=(2, 27))}
        cot, lens = (2, 3, 3, 5), None
    elif form == "sequence":
        feeds = {"a": rng.normal(size=(2, 4, 4)),
                 "b": rng.normal(size=(2, 4, 3))}
        cot, lens = (2, 4, 7), np.array([4, 2])
    else:
        feeds = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(3, 3))}
        cot, lens = (3, 7), None
    feeds = {k: v.astype(np.float32) for k, v in feeds.items()}
    want, got = forward_and_grads(
        lambda **m: concat_graph(**m, form=form), feeds, cot, "cat", lens)
    for a, b in zip(got, want):
        close(a.numpy(), np.asarray(b))


def test_concat_of_projections_is_refused():
    from paddle_tpu_torch.layers.mixed import full_matrix_projection

    x = TL.data(name="x", type=TD.dense_vector(4))
    with pytest.raises(NotImplementedError, match="concat2"):
        TL.concat(input=[full_matrix_projection(input=x, size=3)])


def bn_net(L, A, D):
    img = L.data(name="image", type=D.dense_vector(3 * 8 * 8, channels=3),
                 height=8, width=8)
    t = L.img_conv(input=img, filter_size=3, num_filters=4, padding=1,
                   act=A.LinearActivation(), name="conv")
    t = L.batch_norm(input=t, act=A.ReluActivation(), name="bn")
    t = L.img_pool(input=t, pool_size=2, stride=2, name="pool")
    predict = L.fc(input=t, size=3, act=A.SoftmaxActivation(), name="out")
    label = L.data(name="label", type=D.integer_value(3))
    return L.classification_cost(input=predict, label=label)


def test_trained_bn_states_move_from_jax_by_name():
    """Parameters and BN moving statistics trained by the JAX trainer move
    into the port by name (``Parameters.from_numpy``; ``SGD`` loads the
    states it finds there), and the port's ``test`` (the moving
    statistics) gives the JAX trainer's test cost."""
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as tpaddle

    rng = np.random.default_rng(2)
    data = [(rng.normal(size=192).astype(np.float32), int(rng.integers(3)))
            for _ in range(24)]
    jcost = bn_net(**JAX)
    jtr = jpaddle.trainer.SGD(
        cost=jcost, parameters=jpaddle.parameters.create(
            JTopo.Topology(jcost)),
        update_equation=jpaddle.optimizer.Momentum(momentum=0.9,
                                                   learning_rate=0.05))
    jtr.train(reader=lambda: iter([data[:8], data[8:16]]), num_passes=1,
              event_handler=lambda e: None)
    carried = {n: np.asarray(jtr.parameters[n])
               for n in jtr.parameters.names()}
    carried.update({n: np.asarray(v) for n, v in jtr.states.items()})
    assert not np.allclose(carried["_bn.w1"], 0)   # the states moved
    ttr = tpaddle.trainer.SGD(
        cost=bn_net(**TORCH), device="cpu",
        parameters=tpaddle.parameters.Parameters.from_numpy(carried),
        update_equation=tpaddle.optimizer.Momentum(momentum=0.9,
                                                   learning_rate=0.05))
    for n in ("_bn.w1", "_bn.w2"):
        assert torch.equal(ttr.states[n], torch.tensor(carried[n]))
    jres = jtr.test(reader=lambda: iter([data[16:]]))
    tres = ttr.test(reader=lambda: iter([data[16:]]))
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=2e-6)
