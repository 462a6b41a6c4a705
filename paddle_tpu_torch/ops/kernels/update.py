"""The fused SGD / Momentum update (the port of
``paddle_tpu/ops/pallas/tpp/update.py``'s ``fused_momentum_update``,
``fused_sgd_update``, ``fused_apply_eligible`` and the plan of
``fused_shard_apply``).

- :func:`fused_momentum_update_reference`,
  :func:`fused_sgd_update_reference` — the plain twins, the eager rule of
  ``Optimizer.apply`` op for op;
- :func:`fused_update` — ``csrc/update.cu``: a whole list of
  :class:`TensorUpdate` in one launch on the card (a per-step table of
  pointers and scalars, copied to the card in one copy), the twins on the
  CPU;
- :func:`fused_apply` — ``Optimizer.apply`` through the kernels, for the
  configurations :func:`fused_apply_eligible` accepts: static parameters
  pass through, row-lazy tables (``optimizer.lazy_sparse_rows``) go to
  ``embedding.sparse_row_update``, every other tensor to
  :func:`fused_update`.

The JAX kernel updates p and v in place (its step donates them); here the
outputs are fresh tensors, because callers keep the parameters they pass
in.  The arithmetic rounds each product and sum on its own, so the kernel
equals the eager loop bit for bit."""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = Kernel("update", "fused_update_f32", [_P, _I, _L, _P])

#: elements a block of the dense form, rows a block of the row-lazy form
CHUNK, ROWS_PER_BLOCK = 2048, 8
HAS_V, NESTEROV, HAS_WD = 1, 2, 4
#: one entry of the kernel's table (``struct Entry`` in csrc/update.cu)
ENTRY = np.dtype([("p", "<u8"), ("g", "<u8"), ("v", "<u8"),
                  ("p_out", "<u8"), ("v_out", "<u8"), ("n", "<i8"),
                  ("first", "<i8"), ("lr", "<f4"), ("mu", "<f4"),
                  ("wd", "<f4"), ("flags", "<i4"), ("width", "<i4"),
                  ("pad", "<i4")])
assert ENTRY.itemsize == 80


@dataclasses.dataclass
class TensorUpdate:
    """One tensor's step: ``v`` None is plain SGD; ``lr``, ``mu`` and
    ``weight_decay`` are Python floats, used as float32 as the eager
    update uses them."""

    p: torch.Tensor
    g: torch.Tensor
    v: torch.Tensor | None = None
    lr: float = 0.01
    mu: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0


def fused_momentum_update_reference(p, g, v, lr, mu, nesterov=False,
                                    weight_decay=0.0):
    """Plain twin of ``Momentum.tensor_update`` with the ``apply``-level
    decay fold: v' = mu v + g; p' = p - lr v' (nesterov: p - lr (g +
    mu v')).  Returns (p', v')."""
    g32 = at_least_f32(g)
    if weight_decay:
        g32 = g32 + weight_decay * p
    v_new = mu * v + g32
    delta = lr * (g32 + mu * v_new) if nesterov else lr * v_new
    return (p - delta).to(p.dtype), v_new.to(v.dtype)


def fused_sgd_update_reference(p, g, lr, weight_decay=0.0):
    """Plain twin of slot-free ``SGD.tensor_update``: p' = p - lr g."""
    g32 = at_least_f32(g)
    if weight_decay:
        g32 = g32 + weight_decay * p
    return (p - lr * g32).to(p.dtype)


def reference_update(u: TensorUpdate):
    """(p', v' or None) of one update by the plain twins."""
    if u.v is None:
        return fused_sgd_update_reference(u.p, u.g, u.lr,
                                          u.weight_decay), None
    return fused_momentum_update_reference(u.p, u.g, u.v, u.lr, u.mu,
                                           u.nesterov, u.weight_decay)


def build_table(updates: list[TensorUpdate], rows: bool):
    """The kernel's table for ``updates`` (float32, one device) and fresh
    outputs.  ``rows`` picks the row-lazy form (a work unit is a row of a
    2-D table, 8 a block; else an element, 2048 a block).  Returns
    (table, blocks, outputs [(p', v' or None)], the contiguous inputs the
    table points into).  A tensor with no elements gets no entry.  The
    table's columns are gathered as lists and written at once: a field
    at a time per entry costs numpy far more."""
    dev = updates[0].p.device
    out, inputs = [], []
    cols = {k: [] for k in ENTRY.names if k != "pad"}
    blocks = 0
    for u in updates:
        ts = [u.p, u.g] + ([u.v] if u.v is not None else [])
        # checked with plain tests: a message formatted for each of the
        # step's ~500 operands would cost more than the rest of the table
        if any(t.device != dev or t.dtype != torch.float32
               or t.shape != u.p.shape for t in ts):
            raise EnforceError(
                "the update kernels take float32 parameters, gradients "
                "and slots of one shape on one device, got "
                f"{[(t.dtype, tuple(t.shape), str(t.device)) for t in ts]}")
        if rows and u.p.dim() != 2:
            raise EnforceError("the row-lazy update takes [V, D] tables, "
                               f"got {tuple(u.p.shape)}")
        p, g = u.p.contiguous(), u.g.contiguous()
        v = None if u.v is None else u.v.contiguous()
        po = torch.empty_like(p)
        vo = None if v is None else torch.empty_like(v)
        out.append((po, vo))
        inputs += [p, g, v]
        if p.numel() == 0:
            continue
        n = p.shape[0] if rows else p.numel()
        for k, x in (("p", p), ("g", g), ("v", v), ("p_out", po),
                     ("v_out", vo)):
            cols[k].append(0 if x is None else x.data_ptr())
        cols["n"].append(n)
        cols["first"].append(blocks)
        cols["lr"].append(u.lr)
        cols["mu"].append(u.mu)
        cols["wd"].append(u.weight_decay)
        cols["flags"].append((HAS_V if v is not None else 0)
                             | (NESTEROV if v is not None and u.nesterov
                                else 0)
                             | (HAS_WD if u.weight_decay else 0))
        cols["width"].append(p.shape[1] if rows else 0)
        blocks += -(-n // (ROWS_PER_BLOCK if rows else CHUNK))
    table = np.zeros(len(cols["n"]), ENTRY)
    for k, vals in cols.items():
        table[k] = vals
    return table, blocks, out, inputs


def launch_table(kernel: Kernel, updates: list[TensorUpdate],
                 rows: bool) -> list[tuple]:
    """One launch of ``kernel`` over ``updates`` (float32 on one card):
    the table built on the host, one copy to the card, fresh outputs.
    Returns [(p', v' or None)] in order."""
    # the contiguous inputs stay referenced until the launch is queued
    table, blocks, out, inputs = build_table(updates, rows)
    if len(table):
        dev = updates[0].p.device
        # a fresh pinned block from PyTorch's caching host allocator, which
        # does not hand it out again before this copy has read it
        host = torch.from_numpy(table.view(np.uint8)).pin_memory()
        dev_table = host.to(dev, non_blocking=True)
        kernel.launch(dev_table.data_ptr(), len(table), blocks,
                      torch.cuda.current_stream(dev).cuda_stream)
    del inputs
    return out


def fused_update(updates: list[TensorUpdate]) -> list[tuple]:
    """The SGD / Momentum step of every tensor of ``updates``: [(p', v' or
    None)], fresh tensors.  CPU tensors take the plain twins; CUDA tensors
    (float32) take one launch of the kernel for the whole list, or
    raise."""
    if not updates:
        return []
    if updates[0].p.device.type == "cpu":
        return [reference_update(u) for u in updates]
    return launch_table(KERNEL, updates, rows=False)


# -- Optimizer.apply through the kernels --------------------------------------


def fused_apply_eligible(optimizer, state, specs, names) -> bool:
    """True when :func:`fused_apply` reproduces the optimizer's per-tensor
    loop exactly: plain ``SGD`` or ``Momentum``, no L1, no clipping (global
    or per parameter), no sparsity pruning, dict slots, no model
    average."""
    from paddle_tpu_torch import optimizer as opt_mod

    if type(optimizer) not in (opt_mod.SGD, opt_mod.Momentum):
        return False
    if optimizer.l1_rate or optimizer.gradient_clipping_threshold:
        return False
    if "avg" in state or not isinstance(state.get("slots"), dict):
        return False
    for n in names:
        spec = specs.get(n)
        if spec is None:
            continue
        if spec.gradient_clipping_threshold or spec.sparsity_ratio:
            return False
    return True


def fused_apply(optimizer, grads, params, state, specs):
    """``optimizer.apply`` for an eligible configuration
    (:func:`fused_apply_eligible`), as ``fused_shard_apply`` plans it
    without the shard map: static parameters pass through; each other
    tensor takes ``lr * spec.learning_rate``, the spec's ``decay_rate``
    or else the optimizer's L2, and the momentum of ``Momentum._coeff``
    or of an SGD velocity slot.  Row-lazy tables go to one launch of
    ``sparse_row_update``, every other tensor on the card to one launch of
    :func:`fused_update`; CPU and float64 tensors take the twins (the
    routers' rule, ``ops/nn._takes_kernel``).  Returns (new_params,
    new_state)."""
    from paddle_tpu_torch import optimizer as opt_mod
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import embedding as emb

    is_momentum = type(optimizer) is opt_mod.Momentum
    lr = optimizer.learning_rate
    slots = state["slots"]
    plan = {}                      # name -> (TensorUpdate, lazy)
    for n, p in params.items():
        spec = specs.get(n)
        if spec is not None and spec.is_static:
            continue
        wd = (spec.decay_rate if spec is not None
              and spec.decay_rate is not None else optimizer.l2_rate) or 0.0
        plr = lr * (spec.learning_rate if spec is not None else 1.0)
        lazy = optimizer.lazy_sparse and opt_mod.lazy_sparse_rows(spec, p)
        s = slots[n]
        if is_momentum:
            u = TensorUpdate(p, grads[n], s["velocity"], plr,
                             optimizer._coeff(spec), optimizer.use_nesterov,
                             wd)
        elif isinstance(s, dict) and "velocity" in s:
            u = TensorUpdate(p, grads[n], s["velocity"], plr, s["mu"],
                             weight_decay=wd)
        else:
            u = TensorUpdate(p, grads[n], lr=plr, weight_decay=wd)
        plan[n] = (u, lazy)

    done = {}
    for lazy, run, twin in ((False, fused_update, reference_update),
                            (True, emb.sparse_row_update,
                             emb.reference_row_update)):
        group = [n for n, (_, lz) in plan.items() if lz == lazy]
        mine = [n for n in group if nn_ops._takes_kernel(plan[n][0].p)]
        done.update(zip(mine, run([plan[n][0] for n in mine])))
        done.update((n, twin(plan[n][0])) for n in group if n not in done)

    new_params, new_slots = {}, {}
    for n, p in params.items():
        if n not in plan:
            new_params[n], new_slots[n] = p, slots[n]
            continue
        p2, v2 = done[n]
        new_params[n] = p2
        new_slots[n] = (slots[n] if v2 is None
                        else dict(slots[n], velocity=v2))
    return new_params, {"step": state["step"] + 1, "slots": new_slots}
