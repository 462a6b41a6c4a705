"""The fused SGD / Momentum update (the port of
``paddle_tpu/ops/pallas/tpp/update.py``'s ``fused_momentum_update``,
``fused_sgd_update``, ``fused_apply_eligible`` and the plan of
``fused_shard_apply``).

- :func:`fused_momentum_update_reference`,
  :func:`fused_sgd_update_reference` — the plain twins, the eager rule of
  ``Optimizer.apply`` op for op, pure (they return fresh tensors);
- :func:`fused_update` — ``csrc/update.cu``: a whole list of
  :class:`TensorUpdate` in one launch on the card, the twins on the CPU;
- :func:`fused_apply` — ``Optimizer.apply`` through the kernels, for the
  configurations :func:`fused_apply_eligible` accepts: static parameters
  pass through, row-lazy tables (``optimizer.lazy_sparse_rows``) go to
  ``embedding.sparse_row_update``, every other tensor to
  :func:`fused_update`.

In place, as the JAX kernels are (its step donates p and v): the updates
write p' and v' over p and v on both devices (the twins' results are
copied in on the CPU) and return the tensors they were given.  A caller
that keeps its inputs clones them first.  On the card nothing is
allocated a step: the kernel's table of entries (the p and v pointers,
sizes, scalars and flags) is built on the host once, copied to the card
and kept there (:class:`TableKernel`), keyed on what it holds; only the
gradients' pointers are new each step, and they travel in the launch's
own parameter block.  Each launch bumps autograd's version counter of
every tensor it writes, so a graph that saved one raises instead of
reading the new bits.  The arithmetic rounds each product and sum on its
own, so the kernel equals the eager loop bit for bit."""

from __future__ import annotations

import ctypes
import dataclasses
import operator

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

#: elements a block of the dense form, rows a block of the row-lazy form
CHUNK, ROWS_PER_BLOCK = 2048, 8
HAS_V, NESTEROV, HAS_WD = 1, 2, 4
#: one entry of the kernel's table (``struct Entry`` in csrc/update.cu)
ENTRY = np.dtype([("p", "<u8"), ("v", "<u8"), ("n", "<i8"),
                  ("first", "<i8"), ("lr", "<f4"), ("mu", "<f4"),
                  ("wd", "<f4"), ("flags", "<i4"), ("width", "<i4"),
                  ("pad", "<i4")])
assert ENTRY.itemsize == 56

_ptr = torch.Tensor.data_ptr
_shape = operator.attrgetter("shape")
_dtype = operator.attrgetter("dtype")
_device = operator.attrgetter("device")


@dataclasses.dataclass
class Table:
    """The kernel's table of one list of tensors: ``entries`` (ENTRY
    records, one a tensor with elements), ``first`` (int64 [count + 1]:
    each entry's first block, then the sum of all blocks), ``index`` (the
    tensors that have an entry), the device, every tensor's shape, and
    once launched the entries on the card and the key they were kept
    under."""

    entries: np.ndarray
    first: np.ndarray
    index: list
    device: torch.device
    shapes: tuple
    key: tuple | None = None
    on_card: torch.Tensor | None = None

    @property
    def count(self) -> int:
        return len(self.entries)


class TableKernel(Kernel):
    """A kernel over a :class:`Table` kept on the card: beside its launch
    count, ``table_builds`` counts the tables it built and copied to the
    card.  The last ``KEEP`` tables are kept, most recent first."""

    KEEP = 4

    def __init__(self, source: str, symbol: str):
        super().__init__(source, symbol, [_P, _I, _P, _P, _P])
        self.table_builds = 0
        self.tables: list[Table] = []

    def kept(self, key) -> Table | None:
        for i, t in enumerate(self.tables):
            if t.key == key:
                if i:
                    self.tables.insert(0, self.tables.pop(i))
                return t
        return None

    def keep(self, table: Table) -> None:
        self.tables.insert(0, table)
        del self.tables[self.KEEP:]
        self.table_builds += 1


KERNEL = TableKernel("update", "fused_update_f32")


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
    """(p', v' or None) of one update by the plain twins (fresh
    tensors)."""
    if u.v is None:
        return fused_sgd_update_reference(u.p, u.g, u.lr,
                                          u.weight_decay), None
    return fused_momentum_update_reference(u.p, u.g, u.v, u.lr, u.mu,
                                           u.nesterov, u.weight_decay)


def twin_in_place(twin, u: TensorUpdate) -> tuple:
    """``twin(u)``'s (p', v') written over ``u.p`` and ``u.v``: the
    kernels' in-place contract on the twins.  Returns (u.p, u.v)."""
    p2, v2 = twin(u)
    u.p.copy_(p2)
    if u.v is not None:
        u.v.copy_(v2)
    return u.p, u.v


def columns(updates: list[TensorUpdate]) -> tuple:
    """(ps, gs, vs, scalars) of ``updates``: the tensors by column and each
    update's (lr, mu, nesterov, weight_decay)."""
    return ([u.p for u in updates], [u.g for u in updates],
            [u.v for u in updates],
            tuple([(u.lr, u.mu, u.nesterov, u.weight_decay)
                   for u in updates]))


def _refuse(ps, gs, vs, rows: bool) -> None:
    """Raises on the first operand the kernels do not take: float32 p, g
    and v of one shape on one device, p and v contiguous (written in
    place), [V, D] tables in the row-lazy form."""
    dev = ps[0].device
    for p, g, v in zip(ps, gs, vs):
        ts = [p, g] + ([v] if v is not None else [])
        if any(t.device != dev or t.dtype != torch.float32
               or t.shape != p.shape for t in ts):
            raise EnforceError(
                "the update kernels take float32 parameters, gradients "
                "and slots of one shape on one device, got "
                f"{[(t.dtype, tuple(t.shape), str(t.device)) for t in ts]}")
        if not p.is_contiguous() or not (v is None or v.is_contiguous()):
            raise EnforceError("the update kernels write p and v in place: "
                               "they must be contiguous")
        if rows and p.dim() != 2:
            raise EnforceError("the row-lazy update takes [V, D] tables, "
                               f"got {tuple(p.shape)}")


def build_table(ps, gs, vs, scalars, rows: bool) -> Table:
    """The kernel's table for the tensors ``ps`` (gradients ``gs``, slots
    ``vs``, ``scalars`` as :func:`columns` gives them), after checking
    every operand.  ``rows`` picks the row-lazy form (a work unit is a row
    of a 2-D table, 8 a block; else an element, 2048 a block).  A tensor
    with no elements gets no entry.  The columns are gathered as lists and
    written at once: a field at a time per entry costs numpy far more."""
    _refuse(ps, gs, vs, rows)
    cols = {k: [] for k in ENTRY.names if k != "pad"}
    index, blocks = [], 0
    for i, (p, v, (lr, mu, nesterov, wd)) in enumerate(zip(ps, vs,
                                                           scalars)):
        if p.numel() == 0:
            continue
        index.append(i)
        n = p.shape[0] if rows else p.numel()
        cols["p"].append(p.data_ptr())
        cols["v"].append(0 if v is None else v.data_ptr())
        cols["n"].append(n)
        cols["first"].append(blocks)
        cols["lr"].append(lr)
        cols["mu"].append(mu)
        cols["wd"].append(wd)
        cols["flags"].append((HAS_V if v is not None else 0)
                             | (NESTEROV if v is not None and nesterov
                                else 0)
                             | (HAS_WD if wd else 0))
        cols["width"].append(p.shape[1] if rows else 0)
        blocks += -(-n // (ROWS_PER_BLOCK if rows else CHUNK))
    entries = np.zeros(len(index), ENTRY)
    for k, vals in cols.items():
        entries[k] = vals
    first = np.array(cols["first"] + [blocks], np.int64)
    return Table(entries, first, index, ps[0].device,
                 tuple(map(_shape, ps)))


def table_key(ps, vs, scalars) -> tuple:
    """What a kept table holds that a step may change: the scalars, the p
    and v pointers and the shapes.  Equal keys, equal tables."""
    return (scalars, tuple(map(_ptr, ps)),
            tuple([0 if v is None else v.data_ptr() for v in vs]),
            tuple(map(_shape, ps)))


def _checked_grads(table: Table, ps, gs, vs, rows: bool) -> list:
    """The step's gradients, checked against the kept table: float32, on
    its device, of its tensors' shapes (else raises as a build would); a
    gradient that is not contiguous is made so."""
    if (tuple(map(_shape, gs)) != table.shapes
            or set(map(_dtype, gs)) != {torch.float32}
            or set(map(_device, gs)) != {table.device}):
        _refuse(ps, gs, vs, rows)
    if not all(map(torch.Tensor.is_contiguous, gs)):
        gs = [g.contiguous() for g in gs]
    return gs


def _to_card(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` copied to ``device`` (a CPU device keeps a copy)."""
    if device.type != "cuda":
        return host.clone()
    # a fresh pinned block from PyTorch's caching host allocator, which
    # does not hand it out again before this copy has read it
    return host.pin_memory().to(device, non_blocking=True)


def run_table(kernel: TableKernel, rows: bool, ps, gs, vs, scalars) -> None:
    """One launch of ``kernel`` over the tensors (float32 on one card),
    in place: the kept table when its key holds, else a new one built,
    copied to the card and kept; the gradients' pointers by value."""
    key = table_key(ps, vs, scalars)
    table = kernel.kept(key)
    if table is None:
        table = build_table(ps, gs, vs, scalars, rows)
        table.key = key
        if table.count:
            table.on_card = _to_card(
                torch.from_numpy(table.entries.view(np.uint8)), table.device)
        kernel.keep(table)
    gs = _checked_grads(table, ps, gs, vs, rows)
    if not table.count:
        return
    if len(table.index) != len(gs):
        gs = [gs[i] for i in table.index]
    grads = np.fromiter(map(_ptr, gs), np.uint64, table.count)
    kernel.launch_on(
        table.device.index, table.on_card.data_ptr(), table.count,
        table.first.ctypes.data, grads.ctypes.data)
    # autograd's version counter of each tensor the kernel wrote
    torch.autograd.graph.increment_version(
        ps + [v for v in vs if v is not None])


def launch_table(kernel: TableKernel, updates: list[TensorUpdate],
                 rows: bool) -> list[tuple]:
    """:func:`run_table` over ``updates``; returns [(p, v or None)], the
    tensors given, updated."""
    ps, gs, vs, scalars = columns(updates)
    run_table(kernel, rows, ps, gs, vs, scalars)
    return list(zip(ps, vs))


def fused_update(updates: list[TensorUpdate]) -> list[tuple]:
    """The SGD / Momentum step of every tensor of ``updates``, in place:
    [(p, v or None)], the tensors given.  CPU tensors take the plain
    twins (their results copied in); CUDA tensors (float32, p and v
    contiguous) take one launch of the kernel for the whole list, or
    raise."""
    if not updates:
        return []
    if updates[0].p.device.type == "cpu":
        return [twin_in_place(reference_update, u) for u in updates]
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


@dataclasses.dataclass
class Plan:
    """What :func:`fused_apply` does to each tensor, kept on the optimizer
    until ``key`` (its configuration, the names and the specs) changes:
    ``groups`` holds the dense and the row-lazy group, each (rows, names,
    whether each has a velocity slot, scalars as :func:`columns` gives
    them)."""

    key: tuple
    groups: tuple


def _plan_key(optimizer, params, specs) -> tuple:
    names = tuple(params)
    return (optimizer.learning_rate, getattr(optimizer, "momentum", None),
            getattr(optimizer, "use_nesterov", False), optimizer.l2_rate,
            optimizer.lazy_sparse, names,
            tuple([specs.get(n) for n in names]))


def plan(optimizer, params, state, specs) -> Plan:
    """The kept :class:`Plan` of ``optimizer`` when its key holds, else a
    new one, kept: as ``fused_shard_apply`` plans it without the shard
    map, static parameters pass through; each other tensor takes ``lr *
    spec.learning_rate``, the spec's ``decay_rate`` or else the
    optimizer's L2, and the momentum of ``Momentum._coeff`` or of an SGD
    velocity slot."""
    from paddle_tpu_torch import optimizer as opt_mod

    key = _plan_key(optimizer, params, specs)
    kept = optimizer.__dict__.get("_fused_plan")
    if kept is not None and kept.key == key:
        return kept
    is_momentum = type(optimizer) is opt_mod.Momentum
    lr = optimizer.learning_rate
    slots = state["slots"]
    groups = {False: ([], [], []), True: ([], [], [])}
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
            scal = (plr, optimizer._coeff(spec), optimizer.use_nesterov, wd)
            has_v = True
        elif isinstance(s, dict) and "velocity" in s:
            scal, has_v = (plr, s["mu"], False, wd), True
        else:
            scal, has_v = (plr, 0.0, False, wd), False
        names, vel, scalars = groups[bool(lazy)]
        names.append(n)
        vel.append(has_v)
        scalars.append(scal)
    out = Plan(key, tuple((rows, tuple(names), tuple(vel), tuple(scalars))
                          for rows, (names, vel, scalars) in groups.items()
                          if names))
    optimizer._fused_plan = out
    return out


def fused_apply(optimizer, grads, params, state, specs):
    """``optimizer.apply`` for an eligible configuration
    (:func:`fused_apply_eligible`), in place, through the kept
    :func:`plan`: the dense tensors on the card take one launch of
    :func:`fused_update`'s kernel, the row-lazy tables one of
    ``sparse_row_update``'s; CPU and float64 tensors take the twins (the
    routers' rule, ``ops/nn._takes_kernel``, read on a group's first
    tensor), their results copied in.  Returns (params, state): the
    parameters given and their slots, updated, the step advanced."""
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import embedding as emb

    slots = state["slots"]
    for rows, names, vel, scalars in plan(optimizer, params, state,
                                          specs).groups:
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        vs = [slots[n]["velocity"] if hv else None
              for n, hv in zip(names, vel)]
        if nn_ops._takes_kernel(ps[0]):
            run_table(emb.KERNEL_ROWS if rows else KERNEL, rows, ps, gs, vs,
                      scalars)
            continue
        twin = emb.reference_row_update if rows else reference_update
        for p, g, v, (lr, mu, nesterov, wd) in zip(ps, gs, vs, scalars):
            twin_in_place(twin, TensorUpdate(p, g, v, lr, mu, nesterov, wd))
    return dict(params), {"step": state["step"] + 1, "slots": slots}
