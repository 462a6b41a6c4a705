"""Embedding gather / unique-ids dedup / scatter-add and the fused lookup
(the port of ``paddle_tpu/ops/pallas/tpp/embedding.py``'s
``embedding_gather``, ``embedding_scatter_add``, ``dedup_ids`` and
``fused_embedding_lookup``).

- :func:`dedup_ids` — sorted unique ids with the inverse map
  (``torch.unique``; a sort, as the JAX package's is jnp on both sides);
- :func:`embedding_gather` — ``csrc/embedding.cu``: ``table[clamp(ids)]``
  in the table's dtype (an f32 and a bf16 form, counted apart);
- :func:`embedding_scatter_add` — ``csrc/embedding.cu``: ``table`` plus
  the rows scattered to their ids, duplicates summed in a fixed order
  (a stable sort by id, then one warp per run), ids outside ``[0, V)``
  dropped; the sum in f32 from the table read as f32, rounded to the
  table's dtype once (an f32 and a bf16 form, counted apart; the bf16
  one takes f32 or bf16 rows);
- :func:`fused_embedding_lookup` — the autograd composition: the forward
  dedups, gathers each unique row once and re-expands; the backward
  scatter-adds the cotangents, upcast to f32, into a zero f32 table (the
  JAX package's ``segment_sum`` + ``embedding_scatter_add`` in one
  launch) and casts it to the table's dtype once;
- :func:`sparse_row_update` — ``csrc/update.cu``: the row-lazy SGD /
  Momentum step of a list of ``[V, D]`` tables in one launch (rows whose
  gradient is all zero keep parameter and slot bit for bit).

CPU tensors take the plain twins; CUDA tensors launch the kernels or
raise."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel
from paddle_tpu_torch.ops.kernels.update import TensorUpdate, launch_table

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_GATHER = Kernel("embedding", "embedding_gather_f32",
                       [_P, _P, _P, _I, _I, _I, _P])
KERNEL_GATHER_BF16 = Kernel("embedding", "embedding_gather_bf16",
                            [_P, _P, _P, _I, _I, _I, _P])
#: {table dtype: the gather kernel's form}
GATHER_FORMS = {torch.float32: KERNEL_GATHER,
                torch.bfloat16: KERNEL_GATHER_BF16}
KERNEL_SCATTER = Kernel("embedding", "embedding_scatter_add_f32",
                        [_P, _P, _P, _P, _I, _I, _I, _P])
KERNEL_SCATTER_BF16 = Kernel("embedding", "embedding_scatter_add_bf16",
                             [_P, _P, _P, _P, _I, _I, _I, _I, _P])
KERNEL_ROWS = Kernel("update", "sparse_row_update_f32",
                     [_P, _I, ctypes.c_longlong, _P])


def dedup_ids(ids):
    """(uids, inv): the sorted unique ids of the flat id list and, for
    each position, the index of its id in ``uids`` (``flat == uids[inv]``).
    Unlike the JAX package's fixed-capacity form, ``uids`` holds only the
    ids present (no ``-1`` padding)."""
    return torch.unique(ids.reshape(-1), sorted=True, return_inverse=True)


def _check(table, ids, rows=None):
    """What the kernels take: a [V, D] table and flat int64 ids; the
    gather (no ``rows``) an f32 or a bf16 table (bf16: D % 8 == 0 and
    16-byte aligned, for its 16-byte copies); the scatter-add an f32
    table with f32 rows, or a bf16 table with f32 or bf16 rows."""
    enforce(table.dim() == 2, f"table must be [V, D], got {tuple(table.shape)}")
    enforce(ids.dim() == 1, f"ids must be flat [N], got {tuple(ids.shape)}")
    if rows is not None:
        enforce(tuple(rows.shape) == (ids.shape[0], table.shape[1]),
                f"rows must be [N, D] = [{ids.shape[0]}, {table.shape[1]}], "
                f"got {tuple(rows.shape)}")
    if table.device.type == "cpu":
        return
    tensors = [table] + ([rows] if rows is not None else [])
    if rows is None and table.dtype == torch.bfloat16:
        enforce(table.shape[1] % 8 == 0 and table.data_ptr() % 16 == 0,
                "the bf16 gather copies 16 bytes at a time: D must be a "
                "multiple of 8 and the table 16-byte aligned")
    elif rows is not None and table.dtype == torch.bfloat16:
        enforce(rows.dtype in (torch.float32, torch.bfloat16),
                f"the bf16 scatter-add takes float32 or bfloat16 rows, got "
                f"{rows.dtype}")
    else:
        enforce(all(t.dtype == torch.float32 for t in tensors),
                "the embedding kernels take float32 tables and rows (the "
                "gather a bfloat16 table too, the scatter-add a bfloat16 "
                "table with float32 or bfloat16 rows)")
    enforce(ids.dtype == torch.int64, "the embedding kernels take int64 ids")
    enforce(all(t.is_contiguous() for t in tensors + [ids]),
            "the embedding kernels need contiguous operands")
    enforce(len({t.device for t in tensors + [ids]}) == 1,
            "embedding operands on several devices")


# -- gather -------------------------------------------------------------------


def embedding_gather_reference(table, ids):
    """Plain twin: ``table[clamp(ids, 0, V - 1)]`` for a flat id list."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def embedding_gather(table, ids):
    """``out[i] = table[clamp(ids[i], 0, V - 1)]`` for a flat id list
    [N] -> [N, D] in the table's dtype; one launch of the gather kernel of
    that dtype (f32 or bf16) on the card."""
    _check(table, ids)
    if table.device.type == "cpu":
        return embedding_gather_reference(table, ids)
    n, (v, d) = ids.shape[0], table.shape
    out = torch.empty(n, d, dtype=table.dtype, device=table.device)
    if n:
        GATHER_FORMS[table.dtype].launch(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, v, d,
            torch.cuda.current_stream().cuda_stream)
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


def _scatter_add_into(out, ids, rows):
    """The kernel on ``out`` in place: sort the ids (stable), then one warp
    per run of equal ids sums its rows in order and adds them once."""
    n, (v, d) = ids.shape[0], out.shape
    if n == 0:
        return out
    sorted_ids, perm = torch.sort(ids, stable=True)
    stream = torch.cuda.current_stream().cuda_stream
    if out.dtype == torch.bfloat16:
        KERNEL_SCATTER_BF16.launch(out.data_ptr(), sorted_ids.data_ptr(),
                                   perm.data_ptr(), rows.data_ptr(),
                                   int(rows.dtype == torch.bfloat16), n, v,
                                   d, stream)
    else:
        KERNEL_SCATTER.launch(out.data_ptr(), sorted_ids.data_ptr(),
                              perm.data_ptr(), rows.data_ptr(), n, v, d,
                              stream)
    return out


def table_grad(ids, rows, num_rows: int):
    """The table gradient of a lookup: a zero [V, D] table plus each row
    of ``rows`` at its id (the JAX package's ``segment_sum`` then
    ``embedding_scatter_add`` into zeros; one scatter-add launch on the
    card)."""
    zeros = torch.zeros(num_rows, rows.shape[1], dtype=rows.dtype,
                        device=rows.device)
    if rows.device.type == "cpu":
        return embedding_scatter_add_reference(zeros, ids, rows)
    _check(zeros, ids, rows)
    return _scatter_add_into(zeros, ids, rows)


def embedding_scatter_add(table, ids, rows):
    """``table + scatter_add(ids -> rows)``: duplicate ids sum exactly and
    in a fixed order (reruns are bit-identical), ids outside ``[0, V)``
    (e.g. the ``-1`` pad convention) contribute nothing.  The sum is f32
    (the table read as f32, the rows added as f32) rounded to the table's
    dtype once; on the card an f32 table with f32 rows takes the f32
    form, a bf16 table with f32 or bf16 rows the bf16 form."""
    _check(table, ids, rows)
    if table.device.type == "cpu":
        return embedding_scatter_add_reference(table, ids, rows)
    return _scatter_add_into(table.clone(), ids, rows)


# -- the fused lookup --------------------------------------------------------------


class _FusedLookup(torch.autograd.Function):
    """JAX: ``fused_embedding_lookup``'s ``custom_vjp``.  Saves the ids
    only; the backward builds the table gradient from them."""

    @staticmethod
    def forward(ctx, table, ids, padding_idx):
        flat = ids.reshape(-1).long()
        uids, inv = dedup_ids(flat)
        out = embedding_gather(table, uids)[inv]
        if padding_idx is not None:
            out = torch.where((flat == padding_idx)[:, None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
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
    """Dedup-once embedding lookup: ``table[clamp(ids)]`` [..., D] with
    ``padding_idx`` rows zero; the forward gathers each unique row once,
    the backward scatter-adds each table row once (rows of ids outside
    ``[0, V)`` and of ``padding_idx`` get no gradient)."""
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
    """The row-lazy step of every ``[V, D]`` table of ``updates``: [(p',
    v' or None)], fresh tensors.  CPU tensors take the plain twin; CUDA
    tensors (float32) take one launch of the kernel for the whole list
    (one warp a row; untouched rows copied through), or raise."""
    if not updates:
        return []
    if updates[0].p.device.type == "cpu":
        return [reference_row_update(u) for u in updates]
    return launch_table(KERNEL_ROWS, updates, rows=True)
