"""Optimizers — the port of ``paddle_tpu/optimizer/__init__.py``'s
``Optimizer.init``/``apply``, its tree form ``init_tree``/``apply_tree``
and its ``SGD``/``Momentum``/``Adam`` rules
(≅ ``paddle/parameter/FirstOrderOptimizer.h``).

Each optimizer is an (init, apply) pair over the name-keyed parameter
dict, run under ``torch.no_grad`` after the backward pass.  Per-parameter
attributes come from the ``ParamSpec``s, in the reference's order: decay
(L2, L1) folded into the gradient, then clipping, then the method, with
the parameter's learning-rate scale and ``ParamSpec.momentum`` overriding
the optimizer's coefficient.  The tree form takes any nested params (the
transformer's) with global decay and clipping only, its slots a list in
``jax.tree.leaves`` order (:mod:`paddle_tpu_torch.core.tree`).

Not ported yet, and refused rather than ignored: learning-rate schedules
other than constant, model averaging, row-lazy sparse updates and
sparsity pruning."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from paddle_tpu_torch.core import tree
from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.parameters import ParamSpec


@dataclasses.dataclass
class L1Regularization:
    rate: float = 0.0

    @property
    def l1_rate(self):
        return self.rate


@dataclasses.dataclass
class L2Regularization:
    rate: float = 0.0

    @property
    def l2_rate(self):
        return self.rate


class Optimizer:
    """Base: subclasses define slot init and the per-tensor update rule."""

    def __init__(self, learning_rate: float = 0.01, regularization=None,
                 gradient_clipping_threshold: float = 0.0,
                 model_average=None, learning_rate_schedule: str = "constant",
                 learning_rate_decay_a: float = 0.0,
                 learning_rate_decay_b: float = 0.0,
                 learning_rate_warmup_steps: int = 0):
        if model_average is not None:
            raise NotImplementedError("model_average is not ported yet")
        if learning_rate_schedule not in ("constant", "") or \
                learning_rate_warmup_steps:
            raise NotImplementedError(
                f"learning_rate_schedule={learning_rate_schedule!r} with "
                f"warmup {learning_rate_warmup_steps}: only a constant "
                "learning rate is ported yet")
        self.learning_rate = learning_rate
        self.l1_rate = getattr(regularization, "l1_rate", 0.0) if regularization else 0.0
        self.l2_rate = getattr(regularization, "l2_rate", 0.0) if regularization else 0.0
        self.gradient_clipping_threshold = gradient_clipping_threshold

    # -- subclass hooks -------------------------------------------------------
    def slot_init(self, p: torch.Tensor, spec: ParamSpec | None = None) -> Any:
        return ()

    def tensor_update(self, g, p, slots, lr, step, spec=None):
        """Return (delta, new_slots) with delta to be SUBTRACTED from p."""
        raise NotImplementedError

    # -- dict-level API ---------------------------------------------------------
    def init(self, params: dict[str, torch.Tensor],
             specs: dict[str, ParamSpec] | None = None) -> dict:
        specs = specs or {}
        for name, spec in specs.items():
            if spec.sparsity_ratio:
                raise NotImplementedError(
                    f"{name}: sparsity pruning is not ported yet")
            if spec.sparse and getattr(spec.attr, "sparse_update", False):
                raise NotImplementedError(
                    f"{name}: row-lazy sparse updates are not ported yet")
        slots = {k: self.slot_init(v, specs.get(k)) for k, v in params.items()}
        return {"step": 0, "slots": slots}

    @torch.no_grad()
    def apply(self, grads: dict[str, torch.Tensor],
              params: dict[str, torch.Tensor], state: dict,
              specs: dict[str, ParamSpec] | None = None):
        """One optimizer step; returns (new_params, new_state).  Order as
        in the reference: decay/regularize -> clip -> method."""
        specs = specs or {}
        step = state["step"]
        lr = self.learning_rate
        new_params, new_slots = {}, {}
        for name, p in params.items():
            spec = specs.get(name)
            if spec is not None and spec.is_static:
                new_params[name] = p
                new_slots[name] = state["slots"][name]
                continue
            g = at_least_f32(grads[name])
            l2 = (spec.decay_rate if spec is not None
                  and spec.decay_rate is not None else self.l2_rate)
            if l2:
                g = g + l2 * p
            if self.l1_rate:
                g = g + self.l1_rate * torch.sign(p)
            th = None
            if spec is not None and spec.gradient_clipping_threshold:
                th = spec.gradient_clipping_threshold
            elif self.gradient_clipping_threshold:
                th = self.gradient_clipping_threshold
            if th:
                norm = torch.sqrt(torch.sum(g * g) + 1e-12)
                g = g * torch.clamp(th / norm, max=1.0)
            plr = lr * (spec.learning_rate if spec is not None else 1.0)
            delta, slots = self.tensor_update(g, p, state["slots"][name],
                                              plr, step, spec=spec)
            new_params[name] = p - delta
            new_slots[name] = slots
        return new_params, {"step": step + 1, "slots": new_slots}

    # -- tree API (models outside the name-keyed topology: the transformer) --
    def init_tree(self, params) -> dict:
        """Slots for every leaf of ``params``, in ``jax.tree.leaves``
        order."""
        return {"step": 0,
                "slots": [self.slot_init(p) for p in tree.leaves(params)]}

    @torch.no_grad()
    def apply_tree(self, grads, params, state):
        """The update rule over a params tree (no per-parameter specs;
        global L2, L1 and clipping), as the JAX package's ``apply_tree``.
        Its one caller, ``transformer.build_train_step``, donates params
        and state in the JAX package, so here each update is subtracted
        from its parameter in place and ``state``'s entries are rebound;
        returns (params, state), the trees passed in."""
        step = state["step"]
        new_s = []
        for g, p, s in zip(tree.leaves(grads), tree.leaves(params),
                           state["slots"]):
            g = at_least_f32(g)
            if self.l2_rate:
                g = g + self.l2_rate * p
            if self.l1_rate:
                g = g + self.l1_rate * torch.sign(p)
            if self.gradient_clipping_threshold:
                norm = torch.sqrt(torch.sum(g * g) + 1e-12)
                g = g * torch.clamp(
                    self.gradient_clipping_threshold / norm, max=1.0)
            delta, s2 = self.tensor_update(g, p, s, self.learning_rate, step)
            p.sub_(delta)
            new_s.append(s2)
        state["step"], state["slots"] = step + 1, new_s
        return params, state


def opt_state_from_numpy(state, device=None) -> dict:
    """A JAX ``init_tree``/``apply_tree`` state with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's tree state on
    ``device``.  The slot list keeps its order, which is the leaf order of
    both packages; bfloat16 moments stay bfloat16."""
    from paddle_tpu_torch.core.place import resolve_device

    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # ml_dtypes: no numpy -> torch path
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    slots = [tree.unflatten(s, [conv(x) for x in tree.leaves(s)])
             for s in state["slots"]]
    return {"step": int(np.asarray(state["step"])), "slots": slots}


class SGD(Optimizer):
    """Plain SGD.  As the reference's SgdOptimizer, a parameter whose spec
    asks for momentum (``ParamAttr(momentum=...)`` or
    ``default_momentum()``) gets a velocity slot; the others stay
    slot-free."""

    def slot_init(self, p, spec=None):
        if spec is not None and spec.momentum:
            return {"velocity": torch.zeros_like(p), "mu": float(spec.momentum)}
        return ()

    def tensor_update(self, g, p, slots, lr, step, spec=None):
        if isinstance(slots, dict) and "velocity" in slots:
            v = slots["mu"] * slots["velocity"] + g
            return lr * v, {"velocity": v, "mu": slots["mu"]}
        return lr * g, slots


class Momentum(Optimizer):
    """Heavy-ball momentum: v' = m*v + g; p -= lr * v (nesterov:
    p -= lr * (g + m*v')).  ``ParamSpec.momentum`` overrides ``m``."""

    def __init__(self, momentum: float = 0.9, use_nesterov: bool = False, **kw):
        super().__init__(**kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _coeff(self, spec):
        if spec is not None and spec.momentum is not None:
            return spec.momentum
        return self.momentum

    def slot_init(self, p, spec=None):
        return {"velocity": torch.zeros_like(p)}

    def tensor_update(self, g, p, slots, lr, step, spec=None):
        m = self._coeff(spec)
        v = m * slots["velocity"] + g
        delta = lr * (g + m * v) if self.use_nesterov else lr * v
        return delta, {"velocity": v}


class Adam(Optimizer):
    """≅ AdamParameterOptimizer / adam_op, as the JAX package's ``Adam``.

    ``moment_dtype`` (e.g. ``torch.bfloat16``) stores the m/v slots in
    reduced precision while the update math stays f32; the default keeps
    them at the parameter's dtype, at least f32.  The bias corrections
    ``1 - beta ** t`` are computed in f32, as the JAX package does."""

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, moment_dtype=None, **kw):
        super().__init__(**kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.moment_dtype = moment_dtype

    def _slot_dtype(self, dtype):
        return self.moment_dtype or torch.promote_types(dtype, torch.float32)

    def slot_init(self, p, spec=None):
        dt = self._slot_dtype(p.dtype)
        return {"m": torch.zeros_like(p, dtype=dt),
                "v": torch.zeros_like(p, dtype=dt)}

    def tensor_update(self, g, p, slots, lr, step, spec=None):
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(self.beta1, dtype=f32) ** t)
        bc2 = float(1 - torch.tensor(self.beta2, dtype=f32) ** t)
        m = self.beta1 * at_least_f32(slots["m"]) + (1 - self.beta1) * g
        v = (self.beta2 * at_least_f32(slots["v"])
             + (1 - self.beta2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        dt = self._slot_dtype(slots["m"].dtype)
        return (lr * mhat / (torch.sqrt(vhat) + self.epsilon),
                {"m": m.to(dt), "v": v.to(dt)})
