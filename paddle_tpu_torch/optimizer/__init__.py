"""Optimizers — the port of ``paddle_tpu/optimizer/__init__.py``'s
``Optimizer.init``/``apply``, its tree form ``init_tree``/``apply_tree``
and its ``SGD``/``Momentum``/``Adam`` rules
(≅ ``paddle/parameter/FirstOrderOptimizer.h``).

Each optimizer is an (init, apply) pair over the name-keyed parameter
dict, run under ``torch.no_grad`` after the backward pass.  Per-parameter
attributes come from the ``ParamSpec``s, in the reference's order: decay
(L2, L1) folded into the gradient, then clipping, then the method, with
the parameter's learning-rate scale and ``ParamSpec.momentum`` overriding
the optimizer's coefficient.  A table marked
``ParamAttr(sparse_update=True)`` takes SGD's and Momentum's row-lazy
rule (:func:`lazy_sparse_rows`).  ``apply`` of a plain SGD or Momentum
without L1 or clipping runs through the fused update kernels
(``ops/kernels/update.fused_apply``: one launch for the dense tensors,
one for the row-lazy tables), with the bits of the per-tensor loop.  The
tree form takes any nested params (the transformer's) with global decay
and clipping only, its slots a list in ``jax.tree.leaves`` order
(:mod:`paddle_tpu_torch.core.tree`).

Not ported yet, and refused rather than ignored: learning-rate schedules
other than constant, model averaging and sparsity pruning."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from paddle_tpu_torch.core import tree
from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.parameters import ParamSpec
from paddle_tpu_torch.ops.kernels import update as fused


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


def lazy_sparse_rows(spec, p=None) -> bool:
    """True when the parameter opted into the reference's
    ``SparseRowMatrix`` row-lazy contract: ``ParamAttr(sparse_update=True)``
    on a 2-D [rows, D] table.  Rows whose gradient is all zero this step
    keep parameter and optimizer slot bit for bit: no decay fold, no
    momentum advance.  Optimizers that implement the contract set
    ``lazy_sparse = True`` (SGD, Momentum); the others keep the dense
    rule, so decay is never silently dropped."""
    if spec is None or not getattr(spec, "sparse", False):
        return False
    if not getattr(getattr(spec, "attr", None), "sparse_update", False):
        return False
    return p is None or p.dim() == 2


def _row_mask(g):
    """[rows, 1] bool: the rows this batch touched (a nonzero gradient)."""
    return torch.any(g != 0.0, dim=1, keepdim=True)


class Optimizer:
    """Base: subclasses define slot init and the per-tensor update rule."""

    #: subclasses whose ``tensor_update`` implements the row-lazy contract
    #: of :func:`lazy_sparse_rows` (decay folded on touched rows inside the
    #: rule); ``apply`` then skips its dense decay fold for those tables
    lazy_sparse = False

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

    def _lazy_fold(self, g, p, spec):
        """The row-lazy decay fold: touched rows get g + l2 p, untouched
        rows keep their exactly-zero gradient.  Returns (g, touched)."""
        touched = _row_mask(g)
        l2 = spec.decay_rate if spec.decay_rate is not None else self.l2_rate
        if l2:
            g = torch.where(touched, g + l2 * p, g)
        return g, touched

    # -- dict-level API ---------------------------------------------------------
    def init(self, params: dict[str, torch.Tensor],
             specs: dict[str, ParamSpec] | None = None) -> dict:
        specs = specs or {}
        for name, spec in specs.items():
            if spec.sparsity_ratio:
                raise NotImplementedError(
                    f"{name}: sparsity pruning is not ported yet")
        slots = {k: self.slot_init(v, specs.get(k)) for k, v in params.items()}
        return {"step": 0, "slots": slots}

    @torch.no_grad()
    def apply(self, grads: dict[str, torch.Tensor],
              params: dict[str, torch.Tensor], state: dict,
              specs: dict[str, ParamSpec] | None = None):
        """One optimizer step; returns (new_params, new_state).  Order as
        in the reference: decay/regularize -> clip -> method.  The
        configurations ``fused_apply_eligible`` accepts run through the
        update kernels, the others through the per-tensor loop
        (:meth:`_apply_each`); both give the same bits."""
        specs = specs or {}
        if fused.fused_apply_eligible(self, state, specs, list(params)):
            return fused.fused_apply(self, grads, params, state, specs)
        return self._apply_each(grads, params, state, specs)

    @torch.no_grad()
    def _apply_each(self, grads, params, state, specs):
        """``apply`` as a loop over the tensors, each through
        ``tensor_update``."""
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
            # a row-lazy table folds its decay on touched rows only, in
            # tensor_update
            lazy = self.lazy_sparse and lazy_sparse_rows(spec, p)
            l2 = (spec.decay_rate if spec is not None
                  and spec.decay_rate is not None else self.l2_rate)
            if l2 and not lazy:
                g = g + l2 * p
            if self.l1_rate and not lazy:
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

    lazy_sparse = True

    def slot_init(self, p, spec=None):
        if spec is not None and spec.momentum:
            return {"velocity": torch.zeros_like(p), "mu": float(spec.momentum)}
        return ()

    def tensor_update(self, g, p, slots, lr, step, spec=None):
        lazy = lazy_sparse_rows(spec, p)
        if lazy:
            g, touched = self._lazy_fold(g, p, spec)
        if isinstance(slots, dict) and "velocity" in slots:
            m = slots["mu"]
            v = m * slots["velocity"] + g
            delta = lr * v
            if lazy:
                v = torch.where(touched, v, slots["velocity"])
                delta = torch.where(touched, delta, 0.0)
            return delta, {"velocity": v, "mu": m}
        delta = lr * g
        if lazy:
            delta = torch.where(touched, delta, 0.0)
        return delta, slots


class Momentum(Optimizer):
    """Heavy-ball momentum: v' = m*v + g; p -= lr * v (nesterov:
    p -= lr * (g + m*v')).  ``ParamSpec.momentum`` overrides ``m``."""

    lazy_sparse = True

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
        if lazy_sparse_rows(spec, p):
            # the SparseRowMatrix rule: decay and the momentum advance on
            # the rows this batch touched only; the rest bit-identical
            g, touched = self._lazy_fold(g, p, spec)
            v = m * slots["velocity"] + g
            delta = lr * (g + m * v) if self.use_nesterov else lr * v
            return (torch.where(touched, delta, 0.0),
                    {"velocity": torch.where(touched, v,
                                             slots["velocity"])})
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
