"""Ragged paged attention — the serving decode kernel over a paged KV cache
(the port of ``paddle_tpu/ops/pallas/paged_attention.py``).

Cache layout, unchanged from the JAX package:

- pools ``k_pages``/``v_pages`` of shape [L, H, P, page_size, D] (one
  layer is [H, P, page_size, D]);
- ``page_table[b, i]`` = pool page holding positions
  ``[i*page_size, (i+1)*page_size)`` of sequence ``b``.  Page 0 is the
  null/scratch page: never allocated to a sequence, it absorbs the writes
  of idle batch rows and backs unused table entries;
- ``seq_lens[b]`` = tokens resident INCLUDING the one being decoded, so
  the length mask alone is the causal mask.

The writes update the pools IN PLACE (the JAX functions returned new
arrays; here the engine's pools are mutated and also returned, so call
sites read the same either way).

:func:`ragged_paged_attention` launches ``csrc/paged_attention.cu`` for
CUDA tensors and takes :func:`ragged_paged_attention_reference` for CPU
tensors.  Two dtypes, each with its own kernel form and launch count:
float32 (``KERNEL``) and bfloat16 (``KERNEL_BF16``: bf16 q and pools, f32
scores and sums, p rounded to bf16 before p.V, a bf16 output).  A bf16
CUDA tensor launches the bf16 kernel or raises; nothing casts it to f32.
The twin runs the Pallas kernel's page loop (an online softmax page by
page, p rounded to the pools' dtype against the running max), so the
card and the twin round at the same points.

Both kernels split each (b, h) over chunks of whole pages, one block a
chunk.  The f32 kernel combines them in the same launch
(``csrc/paged_attention.cu``, ``split``); the bf16 kernel takes two
launches in one C call (``split16``): the scores and each page's max
first, so that a chunk rounds p against the running max of each of its
pages as the Pallas grid does, then p.V and the same combine.  Their plan
is host code (:func:`pages_per_chunk`, :func:`splits`,
:func:`workspace_floats`, :func:`live_chunks`, each by the dtype's chunk,
:func:`chunk_tokens`): the grid follows the table's width, never the
lengths, so a call makes no host sync.  The workspace (the bf16 scores
and page maxes, the chunks' partials) and the combine's tickets are kept
per (device, stream) (``_kept``) and grown when a larger call comes."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels import NEG_INF
from paddle_tpu_torch.ops.kernels._build import Kernel
from paddle_tpu_torch.ops.kernels._kept import keep

_P = ctypes.c_void_p
_I = ctypes.c_int
# q, k_pages, v_pages, page_table, seq_lens, out, workspace, tickets | B,
# H, P, page_size, D, max_pages, pages a chunk, scale, stream
_SPLIT_ARGS = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P]
KERNEL = Kernel("paged_attention", "paged_attention_f32", _SPLIT_ARGS)
#: one call, two launches (the scores, then p.V and the combine)
KERNEL_BF16 = Kernel("paged_attention", "paged_attention_bf16", _SPLIT_ARGS)
#: {dtype: kernel form}
FORMS = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}
#: the largest page the bf16 kernel takes: the largest power of two for
#: which the second launch's shared memory (a chunk's p and its pages'
#: running max and weight, beside ``split16``'s ``kStaticBytes``) fits the
#: 48 KB a launch takes without opting in; the C entry checks the same sum
MAX_PAGE_SIZE_BF16 = 8192
#: the f32 kernel's chunk: the whole pages this many tokens hold (at
#: serving's page of 16, 8 pages: 5 chunks over its 36-page rows, 1,920
#: blocks of which ~940 live, ~7 a streaming multiprocessor of the H100's
#: 132, each with 4 row loads a thread in flight; 4 pages ran 6% slower
#: alone, 2 pages 25%, 16 pages 34%: ``chip_ab.py --paged-chunks``)
CHUNK_TOKENS = 128
#: the bf16 kernel's chunk: 8 pages of 16 too (5 chunks a 36-page row);
#: 16 pages (the f32 chunk's bytes) ran 7% slower alone, 4 pages 32%, 32
#: pages 40% (``chip_ab.py --paged-chunks``)
CHUNK_TOKENS_BF16 = 128


# -- cache layout helpers ------------------------------------------------------


def init_kv_pages(num_layers: int, num_heads: int, num_pages: int,
                  page_size: int, head_dim: int, dtype=torch.float32,
                  device=None):
    """(k_pages, v_pages) pools of shape [L, H, P, page_size, D], zeroed.
    Page 0 of every pool is the null page; allocators hand out ids from 1."""
    shape = (num_layers, num_heads, num_pages, page_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def write_decode_kv(k_pages, v_pages, k, v, page_table, positions):
    """Write one new token's K/V per batch row into one layer's pools, in
    place.  k/v [B, H, D]; pools [H, P, page_size, D]; page_table
    [B, max_pages]; positions [B] absolute token index.  Idle rows (all-zero
    table rows) land in the null page."""
    ps = k_pages.shape[2]
    positions = positions.long()
    pages = torch.gather(page_table.long(), 1,
                         (positions // ps)[:, None])[:, 0]
    offs = positions % ps
    k_pages[:, pages, offs] = k.transpose(0, 1)
    v_pages[:, pages, offs] = v.transpose(0, 1)
    return k_pages, v_pages


def write_prefill_kv(k_pages, v_pages, ks, vs, page_table, seq_lens):
    """Scatter a prefilled prompt batch into the stacked pools, in place.
    ks/vs [L, B, T, H, D] (padded prompts); pools [L, H, P, page_size, D];
    page_table [B, max_pages]; seq_lens [B].  Positions at or past
    ``seq_lens`` are redirected to the null page."""
    _, b, t, _, _ = ks.shape
    ps = k_pages.shape[3]
    pos = torch.arange(t, device=ks.device)
    valid = pos[None, :] < seq_lens.long()[:, None]  # [B, T]
    page_slot = torch.where(valid, pos[None, :] // ps, 0)
    pages = torch.where(valid,
                        torch.gather(page_table.long(), 1, page_slot), 0)
    offs = (pos % ps)[None, :].expand(b, t)
    k_pages[:, :, pages, offs] = ks.permute(0, 3, 1, 2, 4)
    v_pages[:, :, pages, offs] = vs.permute(0, 3, 1, 2, 4)
    return k_pages, v_pages


# -- the kernels' plan -----------------------------------------------------------


def chunk_tokens(dtype=torch.float32) -> int:
    """The tokens a chunk of the kernel of ``dtype`` holds at most:
    :data:`CHUNK_TOKENS` (f32) or :data:`CHUNK_TOKENS_BF16`."""
    return CHUNK_TOKENS_BF16 if dtype == torch.bfloat16 else CHUNK_TOKENS


def pages_per_chunk(page_size: int, dtype=torch.float32) -> int:
    """Pages a block of the kernel of ``dtype`` takes: the most whole
    pages that :func:`chunk_tokens` tokens hold, one where a page holds
    more."""
    return max(1, chunk_tokens(dtype) // page_size)


def splits(max_pages: int, page_size: int, dtype=torch.float32) -> int:
    """Chunks a (b, h) row is split into: the grid's second dimension,
    from the table's width alone (at least 1)."""
    return max(1, -(-max_pages // pages_per_chunk(page_size, dtype)))


def workspace_floats(b: int, h: int, max_pages: int, page_size: int,
                     d: int, dtype=torch.float32) -> int:
    """Floats of the workspace: the chunks' partials, (m, l, acc[D]) for
    every chunk of every (b, h); the bf16 kernel's also every (b, h)'s
    scores (a token of the table's row each) and page maxes before
    them."""
    n = b * h * splits(max_pages, page_size, dtype) * (d + 2)
    if dtype == torch.bfloat16:
        n += b * h * max_pages * (page_size + 1)
    return n


def live_chunks(seq_len: int, max_pages: int, page_size: int,
                dtype=torch.float32) -> int:
    """Chunks of a row of this length that read tokens (the others exit at
    once), the length clamped to the table's row as the kernel does; a
    row with one writes its output itself, a row with none writes
    zeros."""
    n = min(max(seq_len, 0), max_pages * page_size)
    return -(-n // (pages_per_chunk(page_size, dtype) * page_size))


# -- the plain version ---------------------------------------------------------


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     seq_lens, scale=None):
    """Plain PyTorch twin of the kernel: the Pallas ``_decode_kernel``'s
    page loop.  q [B, H, D]; pools [H, P, page_size, D]; returns [B, H, D]
    in q's dtype.

    Page by page, skipping pages at or past ``seq_lens``: s = (q.k) scale
    in f32 (or the inputs' dtype where it is wider), masked past the
    length; m' = max(m, max s), p = exp(s - m'), l = l exp(m - m') + sum p
    with p unrounded, acc = acc exp(m - m') + p.v with p rounded to the
    pools' dtype (a no-op for f32); out = acc / max(l, 1e-30).  Rows with
    ``seq_lens == 0`` never accumulate and produce exact zeros."""
    h, _, ps, d = k_pages.shape
    b, maxp = page_table.shape
    scale = scale if scale is not None else d ** -0.5
    wide = at_least_f32(q).dtype
    table = page_table.long()
    lens = seq_lens.long()
    qf = q.to(wide)
    m = qf.new_full((b, h, 1), NEG_INF)
    l = qf.new_zeros((b, h, 1))
    acc = qf.new_zeros((b, h, d))
    pages = min(maxp, -(-int(lens.max()) // ps)) if b else 0
    for i in range(pages):
        live = (i * ps < lens)[:, None, None]
        # [H, B, ps, D] -> [B, H, ps, D]
        k = k_pages[:, table[:, i]].transpose(0, 1).to(wide)
        v = v_pages[:, table[:, i]].transpose(0, 1)
        s = torch.einsum("bhd,bhkd->bhk", qf, k) * scale
        pos = i * ps + torch.arange(ps, device=q.device)
        s = torch.where(pos[None, None, :] < lens[:, None, None], s,
                        s.new_tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = torch.where(live, l * corr + p.sum(dim=-1, keepdim=True), l)
        pv = torch.einsum("bhk,bhkd->bhd", p.to(v.dtype).to(wide),
                          v.to(wide))
        acc = torch.where(live, acc * corr + pv, acc)
        m = torch.where(live, m_new, m)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


# -- the kernel ----------------------------------------------------------------


def _check(q, k_pages, v_pages, page_table, seq_lens):
    enforce(q.dim() == 3, f"q must be [B, H, D], got {tuple(q.shape)}")
    enforce(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
            f"pools must be one layer's [H, P, page_size, D], got "
            f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, h, d = q.shape
    enforce(k_pages.shape[0] == h and k_pages.shape[3] == d,
            f"q {tuple(q.shape)} does not match pools "
            f"{tuple(k_pages.shape)}")
    enforce(page_table.dim() == 2 and page_table.shape[0] == b,
            f"page_table must be [B={b}, max_pages], got "
            f"{tuple(page_table.shape)}")
    enforce(tuple(seq_lens.shape) == (b,),
            f"seq_lens must be [B={b}], got {tuple(seq_lens.shape)}")
    enforce(page_table.dtype == torch.int32 and seq_lens.dtype == torch.int32,
            "page_table and seq_lens must be int32")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, seq_lens)}
    enforce(len(devs) == 1, f"inputs on several devices: {devs}")


def _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens):
    """What the CUDA kernels take: q and the pools float32 or bfloat16, all
    of one dtype, head_dim <= 128, contiguous inputs; bf16 also head_dim a
    multiple of 8, q and the pools 16-byte aligned (16-byte loads of 8
    bf16) and page_size <= ``MAX_PAGE_SIZE_BF16``.  Returns the kernel
    form of that dtype (``FORMS``)."""
    dt = q.dtype
    enforce(dt in FORMS and k_pages.dtype == dt and v_pages.dtype == dt,
            f"the paged-attention kernels take float32 or bfloat16 q and "
            f"pools of one dtype, got {q.dtype} / {k_pages.dtype} / "
            f"{v_pages.dtype}")
    d, ps = q.shape[-1], k_pages.shape[2]
    enforce(d <= 128, f"head_dim {d} > 128")
    enforce(all(t.is_contiguous() for t in
                (q, k_pages, v_pages, page_table, seq_lens)),
            "the paged-attention kernel needs contiguous inputs")
    if dt == torch.bfloat16:
        enforce(d % 8 == 0, f"the bf16 paged-attention kernel needs "
                f"head_dim a multiple of 8, got {d}")
        enforce(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
                "the bf16 paged-attention kernel needs 16-byte aligned q "
                "and pools")
        enforce(ps <= MAX_PAGE_SIZE_BF16, f"page_size {ps} > "
                f"{MAX_PAGE_SIZE_BF16} for the bf16 paged-attention kernel")
    return FORMS[dt]


def ragged_paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                           scale=None):
    """Decode-step attention of q [B, H, D] over one layer's paged KV cache.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    their dtype (``_check_kernel_args``) or raise."""
    _check(q, k_pages, v_pages, page_table, seq_lens)
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, seq_lens, scale=scale)
    enforce(q.device.type == "cuda", f"no kernel for device {q.device}")
    kernel = _check_kernel_args(q, k_pages, v_pages, page_table, seq_lens)
    b, h, _ = q.shape
    _, p, ps, _ = k_pages.shape
    maxp = page_table.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    dt = q.dtype
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    kept = keep(q.device, stream, workspace_floats(b, h, maxp, ps, d, dt),
                b * h)
    kernel.launch_on(q.device.index, q.data_ptr(), k_pages.data_ptr(),
                     v_pages.data_ptr(), page_table.data_ptr(),
                     seq_lens.data_ptr(), out.data_ptr(), kept.part_ptr,
                     kept.tickets_ptr, b, h, p, ps, d, maxp,
                     pages_per_chunk(ps, dt), float(scale))
    return out
