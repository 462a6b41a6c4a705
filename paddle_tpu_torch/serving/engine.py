"""ServingEngine — the online inference front-end (the port of
``paddle_tpu/serving/engine.py``).

Drives the continuous-batching :class:`~.scheduler.Scheduler` over the
paged KV cache on the card and exposes a thread-safe
``submit()/results()`` API::

    eng = ServingEngine(cfg, params, ServingConfig(max_slots=8))
    eng.start()                       # background step loop; or skip and
    rid = eng.submit([5, 17, 3], max_new_tokens=32, temperature=0.7)
    res = eng.results(n=1)[0]         # blocks until a request completes
    eng.stop()

Synchronous callers skip the thread: ``eng.generate(prompts)`` or
``submit(...)`` + ``run_until_idle()``.

The engine runs where ``device`` says: ``None`` is the card (and raises
without one), ``"cpu"`` runs the kernels' plain twins.  Prefill attention
follows ``cfg.attn_impl``: a "flash" config runs the flash kernel on the
card, with no quiet downgrade; the mesh strategies ("ring", "ulysses",
"blockwise") are exact attention at serving shapes and run as "exact".
The KV pools take ``cfg.dtype``: a bf16 config with bf16 params serves
in bf16 (the flash and paged kernels' bf16 forms; greedy rows take the
argmax of the bf16 logits, sampled rows upcast them first).

Telemetry rides the shared :class:`MetricsRegistry` under the JAX
engine's names: histograms ``serve_queue_wait_ms`` / ``serve_prefill_ms``
/ ``serve_decode_step_ms`` / ``serve_ttft_ms`` / ``serve_tpot_ms``,
counters ``serve_requests`` / ``serve_tokens`` / ``serve_loop_crashes``
and the per-request cost split, gauges ``serve_active_slots`` /
``serve_free_pages``, one ``kind="serve"`` record per completed request
and a ``kind="serve_summary"`` record from :meth:`emit_summary`."""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch import metrics as metrics_mod
from paddle_tpu_torch.core import logger as log
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.serving import sampling
from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.serving.scheduler import (
    Request,
    RequestResult,
    Scheduler,
    ServingConfig,
)
from paddle_tpu_torch.telemetry import safe_inc

_LAT_HISTS = ("serve_queue_wait_ms", "serve_prefill_ms",
              "serve_decode_step_ms", "serve_ttft_ms", "serve_tpot_ms")


def drain_results(completed: "queue.Queue", loop_error_now, what: str,
                  n: int | None = None, timeout: float | None = None):
    """Pop up to ``n`` completed results (all currently available if
    None), blocking up to ``timeout`` for the first.  Blocking waits run
    in short slices re-checking ``loop_error_now``, so a dying loop
    thread fails blocked callers with its exception (labeled ``what``)
    instead of parking them forever — already-queued results are always
    handed out first."""
    def pop(block: bool, deadline: float | None, raise_on_crash: bool):
        while True:
            try:
                return completed.get(block=False)
            except queue.Empty:
                pass
            err = loop_error_now()
            if err is not None and raise_on_crash:
                raise RuntimeError(
                    f"{what} crashed; pending requests will never "
                    "complete") from err
            if not block:
                return None
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                return None
            try:
                return completed.get(
                    timeout=0.05 if remaining is None
                    else min(0.05, remaining))
            except queue.Empty:
                continue

    out: list = []
    deadline = None if timeout is None else time.monotonic() + timeout
    if n is None:
        r = pop(block=timeout is not None, deadline=deadline,
                raise_on_crash=True)
        while r is not None:
            out.append(r)
            r = pop(block=False, deadline=None, raise_on_crash=False)
        return out
    while len(out) < n:
        r = pop(block=True, deadline=deadline, raise_on_crash=not out)
        if r is None:
            break
        out.append(r)
    return out


class ServingEngine:
    def __init__(self, cfg, params, serving: ServingConfig | None = None,
                 registry=None, device=None):
        """``cfg``: TransformerConfig; ``params``: the matching params
        (e.g. from ``serving.export.load_servable``), moved to ``device``
        if they are elsewhere; ``serving``: engine knobs; ``device``:
        ``None`` = the card."""
        self.cfg = cfg
        self.serving = serving or ServingConfig()
        s = self.serving
        enforce(not s.prefix_cache and not s.prefill_chunk_tokens,
                "prefix_cache and prefill_chunk_tokens are not ported yet "
                "(see ROADMAP.md)")
        enforce(s.max_prompt_len <= cfg.max_seq_len
                and s.max_prompt_len + s.max_new_tokens <= cfg.max_seq_len,
                "max_prompt_len + max_new_tokens exceeds cfg.max_seq_len")
        # liveness: the largest admissible request must fit an EMPTY
        # engine, or a queue head could block forever (admission is FIFO)
        enforce(s.num_pages - 1 >= s.max_pages_per_seq,
                f"num_pages {s.num_pages} (1 reserved for the null page) "
                f"cannot hold one max-size request "
                f"({s.max_pages_per_seq} pages)")
        enforce(not s.max_concurrent_tokens or s.max_concurrent_tokens
                >= s.max_prompt_len + s.max_new_tokens,
                "max_concurrent_tokens is below one max-size request's "
                "reservation — nothing could ever be admitted")
        self.device = resolve_device(device)
        # a training config may name a mesh strategy (ring, ulysses,
        # blockwise): at serving shapes they compute exact attention
        if cfg.attn_impl != "flash":
            self.cfg = dataclasses.replace(cfg, attn_impl="exact")
        self.params = _to_device(params, self.device)
        self.registry = registry or metrics_mod.get_registry()
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_heads, cfg.head_dim, s.num_pages,
            s.page_size, s.max_slots, s.max_pages_per_seq, dtype=cfg.dtype,
            device=self.device)
        self.scheduler = Scheduler(s, self.cache)
        self._lock = threading.Lock()
        self._incoming: collections.deque[Request] = collections.deque()
        self._completed: queue.Queue[RequestResult] = queue.Queue()
        self._next_id = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._loop_error: BaseException | None = None
        self._stopped = False  # a stop()ed loop marks the engine dead

    # -- public API -----------------------------------------------------------
    def check_request(self, prompt,
                      max_new_tokens: int | None = None
                      ) -> tuple[list[int], int]:
        """Validate one request against the engine's caps and return the
        normalized ``(prompt, max_new_tokens)``."""
        s = self.serving
        prompt = [int(t) for t in prompt]
        n = s.max_new_tokens if max_new_tokens is None else max_new_tokens
        enforce(1 <= n <= s.max_new_tokens,
                f"max_new_tokens must be in [1, {s.max_new_tokens}], "
                f"got {n}")
        enforce(1 <= len(prompt) <= s.max_prompt_len,
                f"prompt length must be in [1, {s.max_prompt_len}], "
                f"got {len(prompt)}")
        v = self.cfg.vocab_size
        bad = [t for t in prompt if not 0 <= t < v]
        enforce(not bad, f"prompt ids {bad[:8]} outside [0, {v})")
        return prompt, n

    def submit(self, prompt, max_new_tokens: int | None = None,
               temperature: float = 0.0,
               request_id: int | None = None) -> int:
        """Queue one request (thread-safe); returns its request id.
        Validation errors raise here, not in the loop.  ``request_id``
        pins the id (sampling is keyed by it); a dead engine refuses."""
        prompt, n = self.check_request(prompt, max_new_tokens)
        err = self._loop_error_now()
        if err is not None:
            raise RuntimeError(
                "serving loop crashed; submit refused (restart the "
                "engine to forgive the crash)") from err
        with self._lock:
            if self._stopped:
                raise RuntimeError(
                    "engine is stopped; submit would enqueue into a dead "
                    "engine (call start() to serve again)")
            if request_id is None:
                rid = self._next_id
            else:
                rid = int(request_id)
                enforce(rid >= 0, f"request_id must be >= 0, got {rid}")
            self._next_id = max(self._next_id, rid + 1)
            self._incoming.append(Request(
                id=rid, prompt=prompt, max_new_tokens=n,
                temperature=float(temperature), arrival=time.perf_counter()))
        return rid

    def _loop_error_now(self) -> BaseException | None:
        with self._lock:
            return self._loop_error

    def results(self, n: int | None = None,
                timeout: float | None = None) -> list[RequestResult]:
        """Pop up to ``n`` completed results (all currently available if
        None), blocking up to ``timeout`` for the first; a dead
        background loop re-raises its exception to waiting callers."""
        return drain_results(self._completed, self._loop_error_now,
                             "serving loop", n=n, timeout=timeout)

    def generate(self, prompts, max_new_tokens: int | None = None,
                 temperature: float = 0.0) -> list[RequestResult]:
        """Synchronous convenience: submit every prompt, run the loop to
        idle, return results ordered by submission."""
        ids = [self.submit(p, max_new_tokens, temperature) for p in prompts]
        self.run_until_idle()
        got: dict[int, RequestResult] = {}
        mine = set(ids)
        for r in self.results():
            if r.id in mine:
                got[r.id] = r
            else:  # a concurrent submit()-er's result: leave it queued
                self._completed.put(r)
        return [got[i] for i in ids]

    def start(self) -> None:
        """Run the step loop on a background thread."""
        enforce(self._thread is None, "engine already started")
        with self._lock:
            self._loop_error = None  # a restart forgives the prior crash
            self._stopped = False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serving-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
            # a stopped background engine is dead until start(); engines
            # only ever driven synchronously keep accepting
            with self._lock:
                self._stopped = True
        self.emit_summary()

    def run_until_idle(self) -> None:
        """Drive the loop on the calling thread until no work remains."""
        while self.step():
            pass

    # -- the step loop --------------------------------------------------------
    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                if not self.step():
                    time.sleep(1e-3)
        except BaseException as e:
            # a dead loop must not strand waiters: record the cause —
            # results() re-raises it to every pending caller — and count it
            with self._lock:
                self._loop_error = e
            safe_inc("serve_loop_crashes",
                     "serving background loops that died",
                     registry=self.registry)
            log.error("serving loop crashed (%s: %s); failing pending "
                      "requests", type(e).__name__, e)

    def _dev(self, batch: dict, *names):
        return [torch.from_numpy(batch[n]).to(self.device) for n in names]

    def step(self) -> bool:
        """One scheduler iteration: drain submissions, retire, admit +
        prefill, decode.  Returns False when fully idle."""
        sched, reg = self.scheduler, self.registry
        now = time.perf_counter()
        worked = False

        with self._lock:
            while self._incoming:
                sched.enqueue(self._incoming.popleft())
                worked = True

        for a in sched.retire_finished():
            self._finish(a)
            worked = True

        admitted = sched.admit(now=now)
        if admitted:
            t0 = time.perf_counter()
            batch = sched.prefill_batch(admitted)
            toks = self._prefill(batch)
            t1 = time.perf_counter()
            reg.histogram("serve_prefill_ms",
                          "prefill pass wall ms (per admitted batch)"
                          ).observe((t1 - t0) * 1e3)
            # the first generated token of each request is sampled here
            reg.counter("serve_tokens", "tokens generated").inc(
                len(admitted))
            for j, a in enumerate(admitted):
                reg.histogram(
                    "serve_queue_wait_ms",
                    "request wait between arrival and admission").observe(
                        (a.t_admit - a.request.arrival) * 1e3)
                a.t_first = t1
                reg.histogram(
                    "serve_ttft_ms", "time to first token").observe(
                        (t1 - a.request.arrival) * 1e3)
                sched.append_token(a, int(toks[j]))
            worked = True

        batch = sched.decode_batch()
        if batch is not None:
            live = batch.pop("live")
            t0 = time.perf_counter()
            toks = self._decode(batch)
            reg.histogram(
                "serve_decode_step_ms",
                "one continuous-batching decode step, wall ms").observe(
                    (time.perf_counter() - t0) * 1e3)
            reg.counter("serve_tokens", "tokens generated").inc(len(live))
            for a in live:
                sched.append_token(a, int(toks[a.slot]))
            worked = True

        reg.gauge("serve_active_slots",
                  "sequences resident in the decode batch").set(
                      len(sched.active))
        reg.gauge("serve_free_pages", "KV-cache pages on the free list").set(
            self.cache.allocator.free_pages)
        return worked

    def _prefill(self, batch: dict) -> np.ndarray:
        """Prompt pass + K/V scatter + first-token sampling; the returned
        host array ends the pass (it waits for the device)."""
        ids, lens, table = self._dev(batch, "ids", "seq_lens", "page_table")
        logits, ks, vs = T.forward_prefill(self.cfg, self.params, ids, lens)
        pa.write_prefill_kv(self.cache.k, self.cache.v, ks, vs, table, lens)
        return sampling.sample_tokens(
            logits, batch["temps"], self.serving.seed, batch["rids"],
            np.zeros_like(batch["rids"]))

    def _decode(self, batch: dict) -> np.ndarray:
        ids, positions, lens, table = self._dev(
            batch, "ids", "positions", "seq_lens", "page_table")
        logits, _, _ = T.forward_decode(
            self.cfg, self.params, ids, positions, lens, table,
            self.cache.k, self.cache.v)
        return sampling.sample_tokens(
            logits, batch["temps"], self.serving.seed, batch["rids"],
            batch["gens"])

    def _finish(self, a) -> None:
        now = time.perf_counter()
        n = len(a.generated)
        ttft_ms = (a.t_first - a.request.arrival) * 1e3
        tpot_ms = ((now - a.t_first) / max(n - 1, 1)) * 1e3
        total_ms = (now - a.request.arrival) * 1e3
        reg = self.registry
        reg.histogram("serve_tpot_ms",
                      "mean per-token decode latency").observe(tpot_ms)
        reg.counter("serve_requests", "completed requests").inc(
            1.0, reason=a.finished)
        # per-request cost attribution from the request's own timestamps:
        # occupancy figures (a batched prefill charges its wall to every
        # member), as in the JAX engine
        queue_s = max(0.0, a.t_admit - a.request.arrival)
        prefill_s = max(0.0, a.t_first - a.t_admit)
        decode_s = max(0.0, now - a.t_first)
        pages = self.cache.pages_needed(a.prompt_len + n)
        kv_page_s = pages * max(0.0, now - a.t_admit)
        reg.counter("serve_queue_s",
                    "summed request queue-seconds").inc(queue_s)
        reg.counter("serve_prefill_compute_s",
                    "summed prefill-phase occupancy seconds").inc(prefill_s)
        reg.counter("serve_decode_compute_s",
                    "summed decode-phase occupancy seconds").inc(decode_s)
        reg.counter("serve_kv_page_s",
                    "summed KV-page occupancy-seconds").inc(kv_page_s)
        rec = {
            "request": a.request.id, "prompt_tokens": a.prompt_len,
            "new_tokens": n, "finish": a.finished,
            "queue_wait_ms": round((a.t_admit - a.request.arrival) * 1e3, 3),
            "ttft_ms": round(ttft_ms, 3), "tpot_ms": round(tpot_ms, 3),
            "total_ms": round(total_ms, 3),
            "queue_s": round(queue_s, 6),
            "prefill_s": round(prefill_s, 6),
            "decode_s": round(decode_s, 6),
            "kv_page_s": round(kv_page_s, 6),
            "cost_per_token_s": round((prefill_s + decode_s) / n, 9)
                                if n else None,
        }
        if reg.active:
            reg.emit(rec, kind="serve")
        self._completed.put(RequestResult(
            id=a.request.id, prompt=list(a.request.prompt),
            tokens=list(a.generated), finish_reason=a.finished,
            metrics=rec))

    def emit_summary(self) -> None:
        """One ``serve_summary`` record with the latency histograms'
        count/p50/p99/max — the SLO rollup operators read."""
        if not self.registry.active:
            return
        summary: dict = {}
        for name in _LAT_HISTS:
            h = self.registry.get(name)
            s = h.summary() if h is not None else None
            if s and s.get("count"):
                summary[name] = {k: s[k] for k in
                                 ("count", "p50", "p99", "max")}
        self.registry.emit(
            {"summary": summary,
             "rejected_admissions": self.scheduler.rejected_admissions},
            kind="serve_summary")


def _to_device(params: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in params.items()}
