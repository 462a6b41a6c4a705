"""Paged KV-cache state: the refcounted page allocator (host) and the
device page pools + page tables it manages (the port of
``paddle_tpu/serving/kv_cache.py``; layout in
``ops/kernels/paged_attention.py``).

The cache is a fixed pool of ``num_pages`` pages of ``page_size`` token
slots each, shared by every resident sequence.  A sequence maps a list of
pages named by its row of the page table; on retirement its pages return
to the free list and are reused verbatim (no zeroing — ``seq_lens``
masking means stale contents are never read).  Page 0 is the null page:
never allocated, it absorbs idle-row writes and backs unused table
entries.  The prefix cache and its copy-on-write paths are a later
slice."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels.paged_attention import init_kv_pages


class OutOfPages(RuntimeError):
    """Raised by :meth:`PageAllocator.alloc` when the pool can't cover a
    request — admission control catches this and leaves it queued."""


class PageAllocator:
    """Refcounted free-list allocator over page ids ``1..num_pages-1``
    (0 = null).

    LIFO reuse (retired pages are handed out first).  ``alloc`` hands out
    pages at refcount 1; ``retain`` adds a reference; ``free`` drops one
    and only the LAST reference returns the page to the free list — a
    refcount can never go negative, the attempt is a hard error."""

    def __init__(self, num_pages: int):
        enforce(num_pages >= 2, "need at least 2 pages (page 0 is null)")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._refs: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Physical pages allocated: ``free_pages + live_pages`` is always
        ``num_pages - 1``."""
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages off the free list at refcount 1; raises
        :class:`OutOfPages` without side effects if fewer are free."""
        if n > len(self._free):
            raise OutOfPages(
                f"requested {n} pages, {len(self._free)} free "
                f"(pool {self.num_pages})")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, pages) -> None:
        """Add one reference per page."""
        for p in pages:
            enforce(p != 0, "page 0 (null) is never allocated or retained")
            enforce(p in self._refs, f"retain of unallocated page {p}")
            self._refs[p] += 1

    def free(self, pages) -> None:
        """Drop one reference per page; the last reference returns the
        page to the free list.  Over-freeing and freeing the null page are
        hard errors (they would alias live sequences)."""
        for p in pages:
            enforce(p != 0, "page 0 (null) is never allocated or freed")
            refs = self._refs.get(p, 0)
            enforce(refs > 0, f"double free of page {p}")
            if refs == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = refs - 1


class PagedKVCache:
    """Device page pools for every layer + the host-side page table.

    ``k``/``v``: [L, H, P, page_size, D] tensors on ``device``, updated
    in place by the serving steps; ``page_table``: host int32
    [max_slots, max_pages_per_seq], row ``s`` owned by batch slot ``s``."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_pages: int, page_size: int, max_slots: int,
                 max_pages_per_seq: int, dtype=torch.float32, device=None):
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.k, self.v = init_kv_pages(
            num_layers, num_heads, num_pages, page_size, head_dim,
            dtype=dtype, device=device)
        self.allocator = PageAllocator(num_pages)
        self.page_table = np.zeros((max_slots, max_pages_per_seq), np.int32)
        self._slot_pages: dict[int, list[int]] = {}

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def assign(self, slot: int, tokens: int) -> list[int]:
        """Allocate pages covering ``tokens`` positions to ``slot`` and
        write its table row.  Raises :class:`OutOfPages` (no partial
        state) when the pool can't cover it."""
        enforce(slot not in self._slot_pages, f"slot {slot} already assigned")
        n = self.pages_needed(tokens)
        enforce(n <= self.max_pages_per_seq,
                f"{tokens} tokens need {n} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}")
        pages = self.allocator.alloc(n)
        self._slot_pages[slot] = pages
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(pages)] = pages
        return pages

    def release(self, slot: int) -> None:
        """Retire a sequence: drop its page references, zero its row."""
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self.allocator.free(pages)
        self.page_table[slot, :] = 0
