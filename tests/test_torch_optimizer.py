"""The port's ``Optimizer.apply`` (SGD, Momentum) and the tree form
``apply_tree`` (Adam) against the JAX package's on the same parameters,
gradients and specs, over three steps:
global L2 and L1 regularization, per-parameter decay_rate, learning-rate
scale, clipping threshold and ``ParamSpec.momentum``, a static
parameter, nesterov.

Tolerance: rtol = 1e-6, atol = 1e-7 — the same elementwise f32 operations
in the same order on both sides; only fused multiply-adds may round
differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.core.initializer as JI
import paddle_tpu.core.parameters as JParams
import paddle_tpu.optimizer as JO
import paddle_tpu_torch.core.initializer as TI
import paddle_tpu_torch.core.parameters as TParams
import paddle_tpu_torch.optimizer as TO

SPEC_FIELDS = {
    "plain": {},
    "decay": {"decay_rate": 5e-3},
    "lr_scale": {"learning_rate": 0.25},
    "clipped": {"gradient_clipping_threshold": 0.5},
    "own_momentum": {"momentum": 0.5},
    "frozen": {"is_static": True},
    "all": {"decay_rate": 1e-2, "learning_rate": 2.0, "momentum": 0.7,
            "gradient_clipping_threshold": 1.0},
}
SHAPES = {"plain": (3, 4), "decay": (5,), "lr_scale": (2, 2, 3),
          "clipped": (6, 2), "own_momentum": (4,), "frozen": (3,),
          "all": (3, 3, 2, 4)}


def _specs(mod_params, mod_init):
    return {n: mod_params.ParamSpec(name=n, shape=SHAPES[n],
                                    initializer=mod_init.constant(0.0), **f)
            for n, f in SPEC_FIELDS.items()}


def _optimizers(kind, reg, **kw):
    out = []
    for mod in (JO, TO):
        kw["regularization"] = REGS[reg](mod)
        if kind == "sgd":
            out.append(mod.SGD(**kw))
        else:
            out.append(mod.Momentum(momentum=0.9,
                                    use_nesterov=kind == "nesterov", **kw))
    return out


REGS = {
    "none": lambda m: None,
    "l2": lambda m: m.L2Regularization(rate=1e-3),
    "l1": lambda m: m.L1Regularization(rate=1e-4),
}


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
@pytest.mark.parametrize("reg", sorted(REGS))
@pytest.mark.parametrize("global_clip", [0.0, 2.0])
def test_apply_matches_jax_over_three_steps(kind, reg, global_clip):
    rng = np.random.default_rng(len(kind) + len(reg))
    jopt, topt = _optimizers(kind, reg, learning_rate=0.1,
                             gradient_clipping_threshold=global_clip)
    jspecs, tspecs = _specs(JParams, JI), _specs(TParams, TI)
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    js, ts = jopt.init(jp, jspecs), topt.init(tp, tspecs)
    for _ in range(3):
        g = {n: rng.normal(size=s).astype(np.float32) * 2
             for n, s in SHAPES.items()}
        jp, js = jopt.apply({n: jnp.asarray(v) for n, v in g.items()}, jp,
                            js, jspecs)
        tp, ts = topt.apply({n: torch.from_numpy(v) for n, v in g.items()},
                            tp, ts, tspecs)
    assert ts["step"] == int(js["step"]) == 3
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        jslot, tslot = js["slots"][n], ts["slots"][n]
        if isinstance(jslot, dict):
            np.testing.assert_allclose(tslot["velocity"].numpy(),
                                       np.asarray(jslot["velocity"]),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
        else:
            assert tslot == ()
    np.testing.assert_array_equal(tp["frozen"].numpy(), p0["frozen"])


def test_sgd_keeps_a_velocity_only_where_the_spec_asks():
    specs = _specs(TParams, TI)
    p = {n: torch.zeros(s) for n, s in SHAPES.items()}
    slots = TO.SGD(learning_rate=0.1).init(p, specs)["slots"]
    with_v = sorted(n for n, s in slots.items() if s != ())
    assert with_v == ["all", "own_momentum"]
    assert slots["own_momentum"]["mu"] == 0.5


def test_options_not_ported_raise():
    with pytest.raises(NotImplementedError, match="model_average"):
        TO.Momentum(learning_rate=0.1, model_average=object())
    with pytest.raises(NotImplementedError, match="constant"):
        TO.SGD(learning_rate=0.1, learning_rate_schedule="poly")
    spec = TParams.ParamSpec(name="w", shape=(2,), sparsity_ratio=0.5,
                             initializer=TI.constant(0.0))
    with pytest.raises(NotImplementedError, match="pruning"):
        TO.SGD(learning_rate=0.1).init({"w": torch.zeros(2)}, {"w": spec})


# -- the tree form (init_tree / apply_tree) and Adam ------------------------------

TREE_SHAPES = {"embed": (5, 3), "blocks": {"wq": (2, 3, 4), "b_in": (2, 4)},
               "ln_f_g": (3,)}


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("reg", sorted(REGS))
@pytest.mark.parametrize("global_clip", [0.0, 0.5])
def test_adam_apply_tree_matches_jax_over_three_steps(moment_dtype, reg,
                                                      global_clip):
    """Adam over a nested params tree, slots in ``jax.tree.leaves`` order,
    the JAX state carried across by ``opt_state_from_numpy``.  Params and
    f32 moments at rtol 1e-6 as above; bf16 moments equal after the
    round to bf16, save where the f32 values straddle a rounding edge
    (then one bf16 ulp, rtol 1e-2)."""
    rng = np.random.default_rng(len(reg) + int(global_clip * 10))
    kw = dict(learning_rate=1e-2, gradient_clipping_threshold=global_clip)
    jopt, topt = (
        mod.Adam(moment_dtype=getattr(dt_mod, moment_dtype)
                 if moment_dtype else None,
                 regularization=REGS[reg](mod), **kw)
        for mod, dt_mod in ((JO, jnp), (TO, torch)))

    def draw(shapes=TREE_SHAPES):
        return {k: draw(v) if isinstance(v, dict)
                else rng.normal(size=v).astype(np.float32)
                for k, v in shapes.items()}

    p0 = draw()
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    js = jopt.init_tree(jp)
    ts = TO.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert len(ts["slots"]) == len(jax.tree.leaves(jp)) == 4
    for _ in range(3):
        g = draw()
        jp, js = jopt.apply_tree(jax.tree.map(jnp.asarray, g), jp, js)
        tp, ts = topt.apply_tree(jax.tree.map(torch.from_numpy, g), tp, ts)
    assert ts["step"] == int(js["step"]) == 3
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for ts_, js_ in zip(ts["slots"], js["slots"]):
        for k in ("m", "v"):
            want = np.asarray(js_[k]).astype(np.float32)
            got = ts_[k].float().numpy()
            assert str(ts_[k].dtype).endswith(moment_dtype or "float32")
            if moment_dtype:
                np.testing.assert_allclose(got, want, rtol=1e-2, atol=0)
                assert np.mean(got == want) > 0.95
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_apply_tree_updates_the_tensors_passed_in():
    """The donated-buffer reading of the JAX step: params updated in
    place, the state's entries rebound, the same trees returned."""
    p = {"a": torch.ones(3, 2), "b": {"c": torch.full((4,), 2.0)}}
    a, state = p["a"], TO.Adam(learning_rate=0.1).init_tree(p)
    got, got_s = TO.Adam(learning_rate=0.1).apply_tree(
        jax.tree.map(torch.ones_like, p), p, state)
    assert got is p and got_s is state and got["a"] is a
    assert state["step"] == 1
    # Adam's first step is lr * g / |g| (up to epsilon)
    np.testing.assert_allclose(a.numpy(), 0.9, rtol=1e-6)
    np.testing.assert_allclose(p["b"]["c"].numpy(), 1.9, rtol=1e-6)
