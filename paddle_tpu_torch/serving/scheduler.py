"""Continuous-batching scheduler — the serving engine's control plane (the
port of ``paddle_tpu/serving/scheduler.py``; host-side numpy, unchanged
but for imports and the prefix-cache / chunked-prefill paths, which are
a later slice).

Every step: retire finished sequences (their pages return to the free
list), admit queued requests into free batch slots (prefill), then run
one decode step for every live sequence.  Sequences join and leave the
decode batch per step.

Admission control is FIFO with head-of-line blocking: a request is
admitted only when (a) a batch slot is free, (b) the page pool can cover
its whole reservation (prompt + max_new_tokens — reserved up front so a
live sequence can never run out of pages mid-decode), and (c) the
concurrent-token budget holds.  Given a seed and an arrival order, the
whole trace (admissions, batch compositions, sampled tokens) is
deterministic; wall-clock enters only the telemetry."""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.serving.kv_cache import OutOfPages, PagedKVCache


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine + scheduler knobs (model shape comes from TransformerConfig).
    The paged-attention implementation follows the tensors' device (the
    kernel on the card, its plain twin on the CPU), so the JAX config's
    ``attn_impl`` field has no counterpart here."""

    max_slots: int = 8           # decode batch size = max concurrent seqs
    page_size: int = 16
    num_pages: int = 256         # pool size incl. the null page
    max_prompt_len: int = 64     # prefill pad length
    max_new_tokens: int = 64     # per-request cap (requests may ask less)
    prefill_batch: int = 4       # admissions per step
    # 0 = no budget; else cap on the summed reservations (prompt +
    # max_new_tokens) of resident sequences
    max_concurrent_tokens: int = 0
    eos_id: int | None = None
    seed: int = 0
    # naive baseline: admit only into an idle engine and never join
    # mid-flight (what a batch `Inference` loop would do)
    static_batching: bool = False
    # later slice: the engine refuses both until the prefix cache and
    # chunked prefill are ported
    prefix_cache: bool = False
    prefill_chunk_tokens: int = 0

    @property
    def max_pages_per_seq(self) -> int:
        return -(-(self.max_prompt_len + self.max_new_tokens)
                 // self.page_size)


@dataclasses.dataclass
class Request:
    """One generation request (ids are assigned by the engine, monotonic
    in submission order — they seed per-request sampling)."""

    id: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    arrival: float = 0.0


@dataclasses.dataclass
class RequestResult:
    id: int
    prompt: list[int]
    tokens: list[int]            # generated tokens (incl. eos if hit)
    finish_reason: str           # "length" | "eos"
    metrics: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Active:
    """A resident sequence: one batch slot + its page reservation."""

    request: Request
    slot: int
    reserved_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    finished: str | None = None  # finish reason once known
    t_admit: float = 0.0
    t_first: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.request.prompt)

    @property
    def next_position(self) -> int:
        """Absolute index of the token the next decode step feeds (the
        last sampled token, not yet in the cache)."""
        return self.prompt_len + len(self.generated) - 1


class Scheduler:
    def __init__(self, serving: ServingConfig, cache: PagedKVCache):
        enforce(cache.page_table.shape[0] >= serving.max_slots,
                "cache has fewer slot rows than max_slots")
        self.serving = serving
        self.cache = cache
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[_Active | None] = [None] * serving.max_slots
        self.rejected_admissions = 0  # out-of-pages/budget head blocks

    # -- state views ----------------------------------------------------------
    @property
    def active(self) -> list[_Active]:
        return [a for a in self.slots if a is not None]

    @property
    def live(self) -> list[_Active]:
        return [a for a in self.slots if a is not None and not a.finished]

    def _reserved(self) -> int:
        return sum(a.reserved_tokens for a in self.active)

    # -- queue + admission ----------------------------------------------------
    def enqueue(self, req: Request) -> None:
        enforce(len(req.prompt) >= 1, "empty prompt")
        enforce(len(req.prompt) <= self.serving.max_prompt_len,
                f"prompt of {len(req.prompt)} tokens exceeds "
                f"max_prompt_len {self.serving.max_prompt_len}")
        enforce(req.max_new_tokens >= 1, "max_new_tokens must be >= 1")
        enforce(req.max_new_tokens <= self.serving.max_new_tokens,
                f"max_new_tokens {req.max_new_tokens} exceeds the "
                f"engine cap {self.serving.max_new_tokens}")
        # a reservation that can NEVER be satisfied would park at the
        # head of the FIFO and starve everything behind it: reject it now
        reserve = len(req.prompt) + req.max_new_tokens
        need = self.cache.pages_needed(reserve)
        pool = self.cache.allocator.num_pages - 1  # page 0 is null
        enforce(need <= self.cache.max_pages_per_seq,
                f"request {req.id}: {reserve}-token reservation needs "
                f"{need} pages > max_pages_per_seq "
                f"{self.cache.max_pages_per_seq} — it could never be "
                f"admitted and would block FIFO admission forever")
        enforce(need <= pool,
                f"request {req.id}: {reserve}-token reservation needs "
                f"{need} pages but the whole pool holds {pool} — it "
                f"could never be admitted and would block FIFO "
                f"admission forever")
        budget = self.serving.max_concurrent_tokens
        enforce(not budget or reserve <= budget,
                f"request {req.id}: {reserve}-token reservation exceeds "
                f"max_concurrent_tokens {budget} — it could never be "
                f"admitted and would block FIFO admission forever")
        self.queue.append(req)

    def admit(self, now: float = 0.0) -> list[_Active]:
        """Admit up to ``prefill_batch`` queued requests into free slots
        (FIFO, head-of-line blocking).  Allocates pages and table rows;
        the engine prefills the returned batch."""
        s = self.serving
        if s.static_batching and self.active:
            return []
        admitted: list[_Active] = []
        budget = s.max_concurrent_tokens or None
        while self.queue and len(admitted) < s.prefill_batch:
            free = [i for i, a in enumerate(self.slots) if a is None]
            if not free:
                break
            req = self.queue[0]
            reserve = len(req.prompt) + req.max_new_tokens
            if budget is not None and self._reserved() + reserve > budget:
                self.rejected_admissions += 1
                break
            slot = free[0]
            try:
                self.cache.assign(slot, reserve)
            except OutOfPages:
                self.rejected_admissions += 1
                break
            self.queue.popleft()
            a = _Active(request=req, slot=slot, reserved_tokens=reserve,
                        t_admit=now)
            self.slots[slot] = a
            admitted.append(a)
        return admitted

    # -- token append + retirement --------------------------------------------
    def append_token(self, a: _Active, token: int) -> None:
        """Record a sampled token; flips ``finished`` on eos/length."""
        a.generated.append(token)
        if self.serving.eos_id is not None and token == self.serving.eos_id:
            a.finished = "eos"
        elif len(a.generated) >= a.request.max_new_tokens:
            a.finished = "length"

    def retire_finished(self) -> list[_Active]:
        """Free the pages + slots of finished sequences; returns them.
        Under ``static_batching`` retirement waits for the whole batch."""
        if self.serving.static_batching and self.live:
            return []
        done = [a for a in self.slots if a is not None and a.finished]
        for a in done:
            self.cache.release(a.slot)
            self.slots[a.slot] = None
        return done

    # -- batch assembly -------------------------------------------------------
    def decode_batch(self) -> dict | None:
        """Fixed-shape arrays for one decode step over all live sequences,
        or None when there are none.  Idle/finished slots ride along
        masked (seq_len 0, null-page table row)."""
        live = [a for a in self.live if a.generated]
        if not live:
            return None
        n = self.serving.max_slots
        ids = np.zeros((n,), np.int32)
        positions = np.zeros((n,), np.int32)
        seq_lens = np.zeros((n,), np.int32)
        rids = np.zeros((n,), np.int32)
        gens = np.zeros((n,), np.int32)
        temps = np.zeros((n,), np.float32)
        for a in live:
            i = a.slot
            ids[i] = a.generated[-1]
            positions[i] = a.next_position
            seq_lens[i] = a.next_position + 1
            rids[i] = a.request.id
            gens[i] = len(a.generated)
            temps[i] = a.request.temperature
        # idle rows must write the null page: zero every row not decoding
        table = np.zeros_like(self.cache.page_table)
        for a in live:
            table[a.slot] = self.cache.page_table[a.slot]
        return {
            "ids": ids, "positions": positions, "seq_lens": seq_lens,
            "page_table": table,
            "rids": rids, "gens": gens, "temps": temps, "live": live,
        }

    def prefill_batch(self, admitted: list[_Active]) -> dict:
        """Fixed-shape arrays for one prefill pass over newly admitted
        sequences (padded to ``prefill_batch`` rows x ``max_prompt_len``;
        slack rows are masked with len 0 and the null-page table row)."""
        s = self.serving
        nb, t = s.prefill_batch, s.max_prompt_len
        ids = np.zeros((nb, t), np.int32)
        lens = np.zeros((nb,), np.int32)
        table = np.zeros((nb, self.cache.max_pages_per_seq), np.int32)
        rids = np.zeros((nb,), np.int32)
        temps = np.zeros((nb,), np.float32)
        for j, a in enumerate(admitted):
            ids[j, :a.prompt_len] = a.request.prompt
            lens[j] = a.prompt_len
            table[j] = self.cache.page_table[a.slot]
            rids[j] = a.request.id
            temps[j] = a.request.temperature
        return {"ids": ids, "seq_lens": lens, "page_table": table,
                "rids": rids, "temps": temps}
