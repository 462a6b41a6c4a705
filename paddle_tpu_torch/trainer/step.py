"""Train, eval and inference steps — the port of
``paddle_tpu/trainer/step.py``'s ``build_train_step`` (the replicated
path: no mesh, no ZeRO), ``build_eval_step`` and ``build_forward``.

One train step: forward over the topology in train mode, backward by
autograd, the optimizer update, and the metrics its cost layers attach
(``_metric_parts``).  PyTorch runs eagerly, so a step is a plain
function; nothing is traced or compiled.  Persistent states (the BN
running statistics) stay f32."""

from __future__ import annotations

import functools

import torch

from paddle_tpu_torch.config.topology import Topology
from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.layers.base import is_sequence, raw


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: only float32 is ported yet "
            "(bf16 compute with f32 master weights is queued)")


def _metric_parts(metric_specs, values) -> dict[str, tuple]:
    """Per-metric (numerator, denominator) tensors, as the JAX package
    splits them.  Classification error: argmax of the prediction against
    the label, over the valid steps of a sequence prediction."""
    out = {}
    for kind, pred_name, label_name, _ in metric_specs:
        if kind != "classification_error":
            continue
        pred, label = values[pred_name], values[label_name]
        ids = torch.argmax(raw(pred), dim=-1)
        if is_sequence(pred):
            mask = pred.mask()
            err = (ids != raw(label)).float() * mask
            out["classification_error_evaluator"] = (err.sum(), mask.sum())
        else:
            err = (ids != raw(label).reshape(ids.shape)).float()
            out["classification_error_evaluator"] = (
                err.sum(), torch.tensor(float(err.numel())))
    return out


def _finalize_metrics(parts: dict[str, tuple]) -> dict[str, float]:
    """{name: numerator / max(denominator, 1)}, divided in f32 as the JAX
    package divides, handed out as floats."""
    return {k: float(num.float() / torch.clamp(den.float().to(num.device),
                                               min=1.0))
            for k, (num, den) in parts.items()}


def _total_cost(values, out_names):
    return functools.reduce(
        lambda a, b: a + b,
        [at_least_f32(values[n]).sum() for n in out_names])


def build_train_step(topology: Topology, optimizer, compute_dtype=None):
    """Returns fn: (params, opt_state, states, feed, seed)
    -> (params, opt_state, states, cost, metrics), every tensor detached,
    the metrics {name: float} from the same forward.  ``seed`` is the
    step's seed (``core/rng.next_seed()``), from which dropout draws."""
    _check_compute_dtype(compute_dtype)
    specs = {s.name: s for s in topology.param_specs()}
    trainable = {n for n, s in specs.items() if not s.is_static}
    out_names = [o.name for o in topology.outputs]
    metric_specs = topology.metrics()

    def step(params, opt_state, states, feed, seed):
        train_p = {k: v.detach().requires_grad_()
                   for k, v in params.items() if k in trainable}
        static_p = {k: v for k, v in params.items() if k not in trainable}
        values, new_states = topology.forward({**static_p, **train_p},
                                              states, feed, True, seed)
        cost = _total_cost(values, out_names)
        with torch.no_grad():
            parts = _metric_parts(metric_specs, values)
        grads = torch.autograd.grad(cost, list(train_p.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p))
                 for (k, p), g in zip(train_p.items(), grads)}
        new_train, new_opt = optimizer.apply(
            grads, {k: v.detach() for k, v in train_p.items()}, opt_state,
            specs)
        new_states = {k: v.detach() for k, v in new_states.items()}
        return ({**static_p, **new_train}, new_opt, new_states,
                cost.detach(), _finalize_metrics(parts))

    return step


def build_eval_step(topology: Topology):
    """Returns fn: (params, states, feed) -> (values of every layer, cost,
    metrics), the forward in test mode without autograd."""
    out_names = [o.name for o in topology.outputs]
    metric_specs = topology.metrics()

    @torch.no_grad()
    def step(params, states, feed):
        values, _ = topology.forward(params, states, feed, False)
        return (values, _total_cost(values, out_names),
                _finalize_metrics(_metric_parts(metric_specs, values)))

    return step


def build_forward(topology: Topology, output_names: list[str]):
    """Returns fn: (params, states, feed) -> [the values of the named
    layers], the forward in test mode without autograd."""

    @torch.no_grad()
    def fwd(params, states, feed):
        values, _ = topology.forward(params, states, feed, False)
        return [values[n] for n in output_names]

    return fwd
