"""Embedding gather / unique-ids dedup / scatter-add and the fused lookup
(the port of ``paddle_tpu/ops/pallas/tpp/embedding.py``'s
``embedding_gather``, ``embedding_scatter_add``, ``dedup_ids`` and
``fused_embedding_lookup``).

- :func:`dedup_ids` — sorted unique ids with the inverse map
  (``torch.unique``; a sort, as the JAX package's is jnp on both sides;
  the lookup no longer calls it);
- :func:`embedding_gather` — ``csrc/embedding.cu``: ``table[clamp(ids)]``
  in the table's dtype, rows of ``padding_idx`` zero when one is given
  (an f32 and a bf16 form, counted apart);
- :func:`embedding_scatter_add` — ``csrc/embedding.cu``: a fresh table,
  ``table`` plus the rows scattered to their ids, duplicates summed in a
  fixed order, ids outside ``[0, V)`` dropped; the sum in f32 from the
  table read as f32, rounded to the table's dtype once (an f32 and a bf16
  form, counted apart; the bf16 one takes f32 or bf16 rows).  One C call
  runs the passes: the ids grouped by a stable counting sort of their
  positions (:func:`group_ids`, twin :func:`group_ids_reference`), then
  each output row written once, an untouched one copied, a touched one
  its table row plus its run's rows summed in position order;
- :func:`fused_embedding_lookup` — the autograd composition: the forward
  is one gather by the flat ids with the padding rows zeroed in the same
  launch (no dedup: on the card a repeated row comes from L2, and the
  sort would stop the host mid-forward; the result is the same copy as
  JAX's dedup, gather and re-expand); the backward
  scatter-adds the cotangents, upcast to f32, into a zero f32 table (the
  JAX package's ``segment_sum`` + ``embedding_scatter_add`` in one
  launch) and casts it to the table's dtype once;
- :func:`sparse_row_update` — ``csrc/update.cu``: the row-lazy SGD /
  Momentum step of a list of ``[V, D]`` tables in one launch, in place
  from a table kept on the card (``update.TableKernel``; rows whose
  gradient is all zero keep parameter and slot bit for bit).

CPU tensors take the plain twins; CUDA tensors launch the kernels or
raise."""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel
from paddle_tpu_torch.ops.kernels.update import (
    TableKernel, TensorUpdate, launch_table, twin_in_place)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# table, ids, out | N, V, D, has_pad, pad, stream
_GATHER_ARGS = [_P, _P, _P, _I, _I, _I, _I, _L, _P]
KERNEL_GATHER = Kernel("embedding", "embedding_gather_f32", _GATHER_ARGS)
KERNEL_GATHER_BF16 = Kernel("embedding", "embedding_gather_bf16",
                            _GATHER_ARGS)
#: {table dtype: the gather kernel's form}
GATHER_FORMS = {torch.float32: KERNEL_GATHER,
                torch.bfloat16: KERNEL_GATHER_BF16}
KERNEL_SCATTER = Kernel("embedding", "embedding_scatter_add_f32",
                        [_P, _P, _P, _P, _P, _L, _I, _I, _I, _P])
KERNEL_SCATTER_BF16 = Kernel("embedding", "embedding_scatter_add_bf16",
                             [_P, _P, _P, _P, _I, _P, _L, _I, _I, _I, _P])
#: the grouping passes; a scatter-add call runs them too, and counts them
KERNEL_GROUP = Kernel("embedding", "embedding_group_ids",
                      [_P, _P, _L, _I, _I, _P])
KERNEL_ROWS = TableKernel("update", "sparse_row_update_f32")


def dedup_ids(ids):
    """(uids, inv): the sorted unique ids of the flat id list and, for
    each position, the index of its id in ``uids`` (``flat == uids[inv]``).
    Unlike the JAX package's fixed-capacity form, ``uids`` holds only the
    ids present (no ``-1`` padding)."""
    return torch.unique(ids.reshape(-1), sorted=True, return_inverse=True)


def _refuse(msg: str) -> None:
    enforce(False, msg)


def _check(table, ids, rows, num_rows=None):
    """What the scatter-add kernels take: a [V, D] table, flat int64 ids
    and [N, D] rows; an f32 table with f32 rows, or a bf16 table with f32
    or bf16 rows.  ``table`` None is a table gradient of ``num_rows`` rows
    in the rows' dtype.  Messages are formatted only on a refusal: the
    checks run on every call."""
    if table is None:
        shape, dtype, device = ((num_rows, rows.shape[1]), rows.dtype,
                                rows.device)
    else:
        shape, dtype, device = tuple(table.shape), table.dtype, table.device
    if len(shape) != 2:
        _refuse(f"table must be [V, D], got {shape}")
    if ids.dim() != 1:
        _refuse(f"ids must be flat [N], got {tuple(ids.shape)}")
    if tuple(rows.shape) != (ids.shape[0], shape[1]):
        _refuse(f"rows must be [N, D] = [{ids.shape[0]}, {shape[1]}], got "
                f"{tuple(rows.shape)}")
    if device.type == "cpu":
        return
    tensors = [t for t in (table, rows) if t is not None]
    if dtype == torch.bfloat16:
        if rows.dtype not in (torch.float32, torch.bfloat16):
            _refuse(f"the bf16 scatter-add takes float32 or bfloat16 rows, "
                    f"got {rows.dtype}")
    elif any(t.dtype != torch.float32 for t in tensors):
        _refuse("the scatter-add kernels take float32 tables and rows, or "
                "a bfloat16 table with float32 or bfloat16 rows")
    if ids.dtype != torch.int64:
        _refuse("the embedding kernels take int64 ids")
    if not all(t.is_contiguous() for t in tensors + [ids]):
        _refuse("the embedding kernels need contiguous operands")
    if any(t.device != device for t in tensors + [ids]):
        _refuse("embedding operands on several devices")


# -- gather -------------------------------------------------------------------


def embedding_gather_reference(table, ids, padding_idx=None):
    """Plain twin: ``table[clamp(ids, 0, V - 1)]`` for a flat id list,
    rows whose id is ``padding_idx`` zero."""
    ids = ids.long()
    out = table[ids.clamp(0, table.shape[0] - 1)]
    if padding_idx is not None:
        out[ids == padding_idx] = 0
    return out


def _gather_refusal(table, ids) -> str | None:
    """Why the gather kernels cannot take ``table`` and ``ids``, or None:
    they take a contiguous f32 or bf16 [V, D] table and contiguous flat
    int64 ids on its card."""
    if table.dim() != 2 or ids.dim() != 1:
        return (f"gather: table must be [V, D] and ids flat [N], got "
                f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if table.dtype not in GATHER_FORMS or ids.dtype != torch.int64:
        return (f"gather: the kernels take a float32 or bfloat16 table and "
                f"int64 ids, got {table.dtype} and {ids.dtype}")
    if ids.device != table.device:
        return f"gather: ids on {ids.device}, table on {table.device}"
    if not (table.is_contiguous() and ids.is_contiguous()):
        return "gather: the kernels need a contiguous table and ids"
    if ids.shape[0] * table.shape[1] >= 2 ** 31:
        return "gather: N x D must stay below 2^31 elements"
    return None


def embedding_gather(table, ids, padding_idx=None):
    """``out[i] = table[clamp(ids[i], 0, V - 1)]`` for a flat id list
    [N] -> [N, D] in the table's dtype, and zeros where ``ids[i] ==
    padding_idx`` when it is given; one launch of the gather kernel of
    that dtype (f32 or bf16) on the card."""
    if table.device.type == "cpu":
        if table.dim() != 2 or ids.dim() != 1:
            _refuse(_gather_refusal(table, ids))
        return embedding_gather_reference(table, ids, padding_idx)
    # the checks in one test on the common case, formatted only on refusal
    if not (ids.dtype == torch.int64 and table.dtype in GATHER_FORMS
            and table.dim() == 2 and ids.dim() == 1
            and ids.device == table.device and table.is_contiguous()
            and ids.is_contiguous()
            and ids.shape[0] * table.shape[1] < 2 ** 31):
        _refuse(_gather_refusal(table, ids))
    n, (v, d) = ids.shape[0], table.shape
    out = torch.empty(n, d, dtype=table.dtype, device=table.device)
    if n:
        GATHER_FORMS[table.dtype].launch_on(
            table.device.index, table.data_ptr(), ids.data_ptr(),
            out.data_ptr(), n, v, d, int(padding_idx is not None),
            0 if padding_idx is None else int(padding_idx))
    return out


# -- scatter-add -----------------------------------------------------------------


def embedding_scatter_add_reference(table, ids, rows):
    """Plain twin: ``table`` with each row of ``rows`` added at its id;
    duplicates sum, ids outside ``[0, V)`` contribute nothing.  As the JAX
    kernel (``tpp/embedding.py:176-189``): an f32 accumulator (float64
    stays) started from the table, the rows added in f32, the result
    rounded to the table's dtype once."""
    ids = ids.long()
    keep = (ids >= 0) & (ids < table.shape[0])
    acc = at_least_f32(table)
    return acc.index_add(0, ids[keep], rows[keep].to(acc.dtype)).to(
        table.dtype)


#: positions a grouping block sorts, entries of ``order`` a segment warp
#: sums (``kChunk``, ``kSeg`` in csrc/embedding.cu)
GROUP_CHUNK, SEGMENT = 1024, 16


@functools.lru_cache(maxsize=64)
def scratch_layout(n: int, v: int, d: int) -> dict:
    """The scratch block of the scatter-add's passes (``struct Layout`` in
    csrc/embedding.cu): {section: (byte offset, elements)} and ``total``
    bytes.  The counters (counts, done, arrive) come first, so one memset
    clears them; ``d`` 0 is the grouping alone."""
    def up16(b):
        return -(-b // 16) * 16

    chunks = -(-n // GROUP_CHUNK) if n > 0 else 1
    segs = -(-n // SEGMENT)
    out, off = {}, 0
    for name, size, count in (("counts", 4, v), ("done", 4, 1),
                              ("arrive", 4, segs), ("offsets", 4, v + 1),
                              ("order", 4, n),
                              ("keys", 8, chunks * GROUP_CHUNK),
                              ("partial", 4, segs * 2 * d)):
        out[name] = (off, count)
        off += up16(size * count)
    out["total"] = off
    return out


def group_ids_reference(ids, num_rows: int):
    """Plain twin of the grouping passes: (counts [V], offsets [V + 1],
    order [offsets[V]]), int32: each id's count among the ids in ``[0,
    V)``, their exclusive sum, and the positions of those ids sorted by id,
    equal ids in increasing position (a stable argsort)."""
    ids = ids.reshape(-1).long()
    keep = (ids >= 0) & (ids < num_rows)
    counts = torch.bincount(ids[keep], minlength=num_rows)
    offsets = torch.zeros(num_rows + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(counts, 0)
    pos = torch.nonzero(keep).reshape(-1)
    order = pos[torch.argsort(ids[keep], stable=True)]
    return (counts.to(torch.int32), offsets.to(torch.int32),
            order.to(torch.int32))


def scatter_add_by_groups(table, ids, rows, num_rows: int | None = None):
    """The scatter-add composed as the kernel computes it, on any device:
    :func:`group_ids_reference`, then each run's rows summed in f32 in
    position order, added to its table row (zeros without a table) read as
    f32, rounded once to the table's (or the rows') dtype.  The plain
    statement of the kernels' order of sums, for the tests."""
    v = table.shape[0] if table is not None else num_rows
    counts, offsets, order = group_ids_reference(ids.cpu(), v)
    dtype = table.dtype if table is not None else rows.dtype
    out = (torch.zeros(v, rows.shape[1], dtype=torch.float32)
           if table is None else at_least_f32(table.cpu()).clone())
    r32 = at_least_f32(rows.cpu())
    for row in torch.nonzero(counts).reshape(-1).tolist():
        run = order[int(offsets[row]):int(offsets[row + 1])].long()
        acc = r32[run[0]].clone()
        for j in run[1:]:
            acc += r32[j]
        out[row] += acc
    return out.to(dtype).to(rows.device)


def group_ids(ids, num_rows: int):
    """The grouping passes of the scatter-add on their own (the card's
    ``embedding_group_ids``; the twin on the CPU): (counts, offsets,
    order) as :func:`group_ids_reference` gives them."""
    enforce(ids.dim() == 1, f"ids must be flat [N], got {tuple(ids.shape)}")
    if ids.device.type == "cpu":
        return group_ids_reference(ids, num_rows)
    enforce(ids.dtype == torch.int64 and ids.is_contiguous(),
            "the grouping takes contiguous int64 ids")
    n, v = ids.shape[0], num_rows
    lay = scratch_layout(n, v, 0)
    scratch = torch.empty(lay["total"], dtype=torch.uint8, device=ids.device)
    KERNEL_GROUP.launch_on(
        ids.device.index, ids.data_ptr(), scratch.data_ptr(), lay["total"], n,
        v)

    def section(name, count):
        off = lay[name][0]
        return scratch[off:off + 4 * count].view(torch.int32)

    offsets = section("offsets", v + 1)
    return (section("counts", v), offsets,
            section("order", n)[:int(offsets[v])])


def _scatter_add(table, ids, rows, num_rows: int):
    """The scatter-add kernel of the output's dtype: a fresh [V, D] table,
    every row written once (``table`` None: a zero table), in one C call
    (the grouping passes, then the output pass).  Returns the output."""
    n, d, v = ids.shape[0], rows.shape[1], num_rows
    dtype = rows.dtype if table is None else table.dtype
    out = torch.empty(v, d, dtype=dtype, device=rows.device)
    lay = scratch_layout(n, v, d)
    scratch = torch.empty(lay["total"], dtype=torch.uint8, device=rows.device)
    index = rows.device.index
    tab = 0 if table is None else table.data_ptr()
    if dtype == torch.bfloat16:
        KERNEL_SCATTER_BF16.launch_on(
            index, out.data_ptr(), tab, ids.data_ptr(), rows.data_ptr(),
            int(rows.dtype == torch.bfloat16), scratch.data_ptr(),
            lay["total"], n, v, d)
    else:
        KERNEL_SCATTER.launch_on(
            index, out.data_ptr(), tab, ids.data_ptr(), rows.data_ptr(),
            scratch.data_ptr(), lay["total"], n, v, d)
    # every scatter-add call runs the grouping passes once
    KERNEL_GROUP.launches += 1
    return out


def table_grad(ids, rows, num_rows: int):
    """The table gradient of a lookup: a zero [V, D] table plus each row
    of ``rows`` at its id (the JAX package's ``segment_sum`` then
    ``embedding_scatter_add`` into zeros), in the rows' dtype; on the card
    one scatter-add call with no table (zeros are written where no id
    lands)."""
    if rows.device.type == "cpu":
        zeros = torch.zeros(num_rows, rows.shape[1], dtype=rows.dtype)
        return embedding_scatter_add_reference(zeros, ids, rows)
    _check(None, ids, rows, num_rows)
    return _scatter_add(None, ids, rows, num_rows)


def embedding_scatter_add(table, ids, rows):
    """``table + scatter_add(ids -> rows)``, a fresh table: duplicate ids
    sum exactly and in a fixed order (reruns are bit-identical), ids
    outside ``[0, V)`` (e.g. the ``-1`` pad convention) contribute
    nothing.  The sum is f32 (the table read as f32, the rows added as f32)
    rounded to the table's dtype once; on the card an f32 table with f32
    rows takes the f32 form, a bf16 table with f32 or bf16 rows the bf16
    form."""
    _check(table, ids, rows)
    if table.device.type == "cpu":
        return embedding_scatter_add_reference(table, ids, rows)
    return _scatter_add(table, ids, rows, table.shape[0])


# -- the fused lookup --------------------------------------------------------------


class _FusedLookup(torch.autograd.Function):
    """JAX: ``fused_embedding_lookup``'s ``custom_vjp``.  Saves the ids
    only; the backward builds the table gradient from them."""

    @staticmethod
    def forward(ctx, table, ids, padding_idx):
        # one gather by the flat ids, the padding rows zeroed in it: the
        # same copy as JAX's dedup, gather and re-expand (its dedup pays on
        # a TPU, where each unique row read once from HBM saves; here a
        # repeated row comes from L2, and torch.unique would stop the host)
        flat = ids.reshape(-1).long()
        out = embedding_gather(table, flat, padding_idx)
        ctx.save_for_backward(flat)
        ctx.cfg = (table.shape[0], table.dtype, padding_idx)
        return out.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, ct):
        # JAX ``tpp/embedding.py:380-394``: the cotangent upcast to f32 (a
        # bf16 table's too), summed per row in f32, the [V, D] result cast
        # to the table's dtype once; on the card the f32 scatter-add kernel
        (flat,) = ctx.saved_tensors
        v, dtype, padding_idx = ctx.cfg
        ctf = at_least_f32(ct.reshape(flat.shape[0], -1)).contiguous()
        if padding_idx is not None:
            ctf = torch.where((flat == padding_idx)[:, None],
                              torch.zeros((), dtype=ctf.dtype,
                                          device=ctf.device), ctf)
        return table_grad(flat, ctf, v).to(dtype), None, None


def fused_embedding_lookup(table, ids, padding_idx=None):
    """Embedding lookup: ``table[clamp(ids)]`` [..., D] with
    ``padding_idx`` rows zero; the forward is one gather launch on the
    card, the backward scatter-adds each table row once (rows of ids
    outside ``[0, V)`` and of ``padding_idx`` get no gradient)."""
    return _FusedLookup.apply(table, ids, padding_idx)


# -- the row-lazy optimizer update --------------------------------------------


def sparse_row_update_reference(p, g, v=None, *, lr=0.01, mu=0.0,
                                nesterov=False, weight_decay=0.0):
    """Plain twin of the row-lazy SGD / Momentum rule (the reference's
    ``SparseRowMatrix`` update): a row whose gradient is all zero keeps its
    parameter and slot bit for bit, no decay and no momentum advance; a
    touched row follows ``update.fused_momentum_update_reference`` (decay
    folded on touch).  Returns (p', v'), v' None for plain SGD."""
    p32, g32 = at_least_f32(p), at_least_f32(g)
    touched = torch.any(g32 != 0.0, dim=1, keepdim=True)
    if weight_decay:
        g32 = torch.where(touched, g32 + weight_decay * p32, g32)
    if v is None:
        return torch.where(touched, (p32 - lr * g32).to(p.dtype), p), None
    v32 = at_least_f32(v)
    vn = mu * v32 + g32
    delta = lr * (g32 + mu * vn) if nesterov else lr * vn
    pn = torch.where(touched, (p32 - delta).to(p.dtype), p)
    return pn, torch.where(touched, vn, v32).to(v.dtype)


def reference_row_update(u: TensorUpdate):
    """(p', v' or None) of one row-lazy update by the plain twin."""
    return sparse_row_update_reference(u.p, u.g, u.v, lr=u.lr, mu=u.mu,
                                       nesterov=u.nesterov,
                                       weight_decay=u.weight_decay)


def sparse_row_update(updates: list[TensorUpdate]) -> list[tuple]:
    """The row-lazy step of every ``[V, D]`` table of ``updates``, in
    place: [(p, v or None)], the tensors given.  CPU tensors take the
    plain twin (its results copied in); CUDA tensors (float32, p and v
    contiguous) take one launch of the kernel for the whole list (one warp
    a row; an untouched row is neither read nor written), or raise."""
    if not updates:
        return []
    if updates[0].p.device.type == "cpu":
        return [twin_in_place(reference_row_update, u) for u in updates]
    return launch_table(KERNEL_ROWS, updates, rows=True)
