"""The port's ``Optimizer.apply`` (SGD, Momentum) against the JAX
package's on the same parameters, gradients and specs, over three steps:
global L2 and L1 regularization, per-parameter decay_rate, learning-rate
scale, clipping threshold and ``ParamSpec.momentum``, a static
parameter, nesterov.

Tolerance: rtol = 1e-6, atol = 1e-7 — the same elementwise f32 operations
in the same order on both sides; only fused multiply-adds may round
differently."""

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
