"""Train and eval steps — the port of ``paddle_tpu/trainer/step.py``'s
``build_train_step`` (the replicated path: no mesh, no ZeRO) and
``build_eval_step``.

One train step: forward over the topology in train mode, backward by
autograd, the optimizer update.  PyTorch runs eagerly, so a step is a
plain function; nothing is traced or compiled.  Persistent states (the
BN running statistics) stay f32."""

from __future__ import annotations

import functools

import torch

from paddle_tpu_torch.config.topology import Topology
from paddle_tpu_torch.core.dtype import at_least_f32


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: only float32 is ported yet "
            "(bf16 compute with f32 master weights is queued)")


def _total_cost(values, out_names):
    return functools.reduce(
        lambda a, b: a + b,
        [at_least_f32(values[n]).sum() for n in out_names])


def build_train_step(topology: Topology, optimizer, compute_dtype=None):
    """Returns fn: (params, opt_state, states, feed)
    -> (params, opt_state, states, cost), every tensor detached."""
    _check_compute_dtype(compute_dtype)
    specs = {s.name: s for s in topology.param_specs()}
    trainable = {n for n, s in specs.items() if not s.is_static}
    out_names = [o.name for o in topology.outputs]

    def step(params, opt_state, states, feed):
        train_p = {k: v.detach().requires_grad_()
                   for k, v in params.items() if k in trainable}
        static_p = {k: v for k, v in params.items() if k not in trainable}
        values, new_states = topology.forward({**static_p, **train_p},
                                              states, feed, True)
        cost = _total_cost(values, out_names)
        grads = torch.autograd.grad(cost, list(train_p.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p))
                 for (k, p), g in zip(train_p.items(), grads)}
        new_train, new_opt = optimizer.apply(
            grads, {k: v.detach() for k, v in train_p.items()}, opt_state,
            specs)
        new_states = {k: v.detach() for k, v in new_states.items()}
        return {**static_p, **new_train}, new_opt, new_states, cost.detach()

    return step


def build_eval_step(topology: Topology):
    """Returns fn: (params, states, feed) -> (values of every layer, cost),
    the forward in test mode without autograd."""
    out_names = [o.name for o in topology.outputs]

    @torch.no_grad()
    def step(params, states, feed):
        values, _ = topology.forward(params, states, feed, False)
        return values, _total_cost(values, out_names)

    return step
