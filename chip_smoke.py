#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card — the quickest proof that the port builds, is right and serves.

Run from the root of a checkout, on a machine with one card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. The card (``nvidia-smi`` name and power limit, torch's name and
   device count).  Every kernel is built from ``paddle_tpu_torch/ops/
   kernels/csrc`` (one ``nvcc`` per source, all at once; timed).
2. Each kernel against its plain PyTorch twin on the card, at the shapes
   the serving path gives it: flash prefill [8, 512, 12, 64] causal (and
   an odd T=333), paged decode B=32, H=12, D=64, page_size=16, 36 pages
   per row, ragged lengths including 0, 1, 16, 17 and 576.  Max abs error
   <= 1e-4 (f32 round-off of another summation order; TF32 off).  Times
   are CUDA-event means over many launches with the 50 MB L2 flushed
   before each launch (the serving caller finds the K/V pool cold), beside
   the plain twin, one PyTorch library call (``scaled_dot_product_
   attention``, used only here as a yardstick) and the bound: the larger
   of bytes moved / 3.35 TB/s and flops / 67 TFLOP/s (H100 SXM f32 FMA,
   the tensor cores would need TF32).
3. The serving engine end to end at the GPT-2-small width of the repo's
   LM config (vocab 50257, 12 layers, 12 heads, 768 wide, MLP 3072, f32,
   random weights from a seeded generator): 64 greedy requests with
   prompts of 16-512 tokens plus 8 at temperature 0.8, 64 new tokens
   each, 32 slots.  Kernel launch counts are zeroed just before and read
   just after: flash must run once per layer per prefill pass and paged
   attention once per layer per decode step.  Two greedy requests must
   equal the argmax of one full-context forward pass on the card.
4. ``{"kernels": [...]}`` and then, as the last line, ``{"ok": true,
   "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean CUDA-event time of ``fn`` with L2 flushed before each launch."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device=device)

    def __call__(self, fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_flash(dev, timer) -> dict:
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, d = 8, 12, 64
    scale = d ** -0.5
    err, row = 0.0, None
    for t in (512, 333):
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev)
                   for _ in range(3))
        o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
        qp, kp, vp = FA._prep(q, k, v)
        o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t, True, scale)
        torch.cuda.synchronize()
        err = max(err,
                  (o - FA._from_bh(o_ref, b, h, t, d)).abs().max().item(),
                  (lse - lse_ref[:, :t]).abs().max().item())
        if t != 512:
            continue
        ms = timer(lambda: FA._fwd_kernel(qp, kp, vp, t, True, scale))
        plain_ms = timer(lambda: FA._fwd_plain(qp, kp, vp, t, True, scale))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
        pairs = b * h * t * (t + 1) // 2       # causal (query, key) pairs
        flops = 4.0 * pairs * d                # q.k and p.v, 2 flops/FMA
        nbytes = 4.0 * (4 * b * t * h * d + b * h * t)  # q, k, v, o, lse
        bound_ms, by = bound(nbytes, flops)
        row = {"name": "flash_attention_fwd", "route": "cuda",
               "source": "paddle_tpu_torch/ops/kernels/csrc/"
                         "flash_attention.cu",
               "replaces": "paddle_tpu/ops/pallas/flash_attention.py:307",
               "shape": [b, t, h, d], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": by,
               "library_ms": library_ms}
    row["max_abs_err"] = err
    if not err <= TOL:
        raise AssertionError(f"flash kernel vs plain: max abs err {err}")
    return row


def check_paged(dev, timer) -> dict:
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    b, h, d, ps, maxp = 32, 12, 64, 16, 36
    rng = np.random.default_rng(2)
    lens = np.concatenate([[0, 1, 16, 17, maxp * ps],
                           rng.integers(1, maxp * ps + 1, size=b - 5)])
    num_pages = 1 + b * maxp
    table = np.zeros((b, maxp), np.int32)
    ids = rng.permutation(np.arange(1, num_pages))
    nxt = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // ps)
        table[i, :need] = ids[nxt:nxt + need]
        nxt += need
    gen = torch.Generator(device=dev).manual_seed(2)
    kp, vp = (torch.randn(h, num_pages, ps, d, generator=gen, device=dev)
              for _ in range(2))
    q = torch.randn(b, h, d, generator=gen, device=dev)
    pt = torch.from_numpy(table).to(dev)
    sl = torch.from_numpy(lens.astype(np.int32)).to(dev)
    out = PA.ragged_paged_attention(q, kp, vp, pt, sl)
    ref = PA.ragged_paged_attention_reference(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"paged kernel vs plain: max abs err {err}")
    idle = sl == 0
    if not torch.equal(out[idle], torch.zeros_like(out[idle])):
        raise AssertionError("paged kernel: idle rows are not exactly 0")
    ms = timer(lambda: PA.ragged_paged_attention(q, kp, vp, pt, sl))
    plain_ms = timer(
        lambda: PA.ragged_paged_attention_reference(q, kp, vp, pt, sl))
    # the library yardstick: SDPA over the gathered dense K/V
    kd = kp[:, pt.long()].transpose(0, 1).reshape(b, h, maxp * ps, d)
    vd = vp[:, pt.long()].transpose(0, 1).reshape(b, h, maxp * ps, d)
    mask = (torch.arange(maxp * ps, device=dev)[None, :]
            < sl[:, None])[:, None, None, :]
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask))
    resident = float(lens.sum())
    nbytes = 4.0 * (2 * resident * h * d + 2 * b * h * d + b * maxp + b)
    bound_ms, by = bound(nbytes, 4.0 * resident * h * d)
    return {"name": "ragged_paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:274",
            "shape": [b, h, d, ps, maxp], "resident_tokens": int(resident),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}


def fine_buckets() -> tuple:
    """1%-geometric bucket edges from 0.01 ms to ~100 s, so histogram
    percentiles are exact to ~1%."""
    return tuple(0.01 * 1.01 ** i for i in range(1620))


def serve_end_to_end(dev) -> tuple[dict, int, int]:
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.telemetry import MetricsRegistry

    cfg = T.TransformerConfig(
        vocab_size=50257, num_layers=12, num_heads=12, embed_dim=768,
        mlp_dim=3072, max_seq_len=2048, dtype=torch.float32, remat=False,
        attn_impl="flash")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = T.count_params(params)
    scfg = ServingConfig(max_slots=32, page_size=16, max_prompt_len=512,
                         max_new_tokens=64, prefill_batch=8,
                         num_pages=32 * 36 + 1, seed=0)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n))
               for n in rng.integers(16, 513, size=72)]
    temps = [0.0] * 64 + [0.8] * 8

    # warm-up on its own engine: cuBLAS handles, allocator, the kernels'
    # first loads — set-up cost, kept out of the measured run
    ServingEngine(cfg, params, scfg, registry=MetricsRegistry("warmup"),
                  device=dev).generate(prompts[:2], max_new_tokens=2)
    setup_s = time.perf_counter() - t0

    reg = MetricsRegistry("chip_smoke")
    for name in ("serve_prefill_ms", "serve_decode_step_ms"):
        reg.histogram(name, buckets=fine_buckets())
    eng = ServingEngine(cfg, params, scfg, registry=reg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    FA.KERNEL.launches = 0
    PA.KERNEL.launches = 0
    t0 = time.perf_counter()
    ids = [eng.submit(p, temperature=tt) for p, tt in zip(prompts, temps)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_n, paged_n = FA.KERNEL.launches, PA.KERNEL.launches
    got = {r.id: r for r in eng.results()}

    if sorted(got) != sorted(ids):
        raise AssertionError(f"served {len(got)} of {len(ids)} requests")
    for r in got.values():
        if len(r.tokens) != scfg.max_new_tokens or r.finish_reason != "length":
            raise AssertionError(f"request {r.id}: {len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
    prefills = reg.get("serve_prefill_ms").summary()["count"]
    steps = reg.get("serve_decode_step_ms").summary()["count"]
    if flash_n != cfg.num_layers * prefills or flash_n == 0:
        raise AssertionError(f"flash launches {flash_n} != "
                             f"{cfg.num_layers} x {prefills} prefill passes")
    if paged_n != cfg.num_layers * steps or paged_n == 0:
        raise AssertionError(f"paged launches {paged_n} != "
                             f"{cfg.num_layers} x {steps} decode steps")
    for rid in ids[:2]:   # greedy requests: tokens = full-context argmax
        r = got[rid]
        full = torch.tensor([r.prompt + r.tokens], device=dev)
        logits = T.forward(cfg, params, full)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        want = logits[0, len(r.prompt) - 1:-1].argmax(-1).tolist()
        if r.tokens != want:
            raise AssertionError(f"request {rid}: engine tokens differ from "
                                 "the full-context argmax")
    ttft = np.array([got[i].metrics["ttft_ms"] for i in ids])
    new_tokens = sum(len(r.tokens) for r in got.values())
    return ({"phase": "serve", "params": n_params, "requests": len(ids),
             "new_tokens": new_tokens,
             "prompt_tokens": sum(len(p) for p in prompts),
             "wall_s": wall, "tokens_per_s": new_tokens / wall,
             "ttft_ms_p50": float(np.percentile(ttft, 50)),
             "ttft_ms_p99": float(np.percentile(ttft, 99)),
             "decode_step_ms_p50":
                 reg.get("serve_decode_step_ms").percentile(50),
             "prefill_ms_p50": reg.get("serve_prefill_ms").percentile(50),
             "prefill_passes": prefills, "decode_steps": steps,
             "flash_launches": flash_n, "paged_launches": paged_n,
             "max_memory_allocated_bytes":
                 torch.cuda.max_memory_allocated(dev),
             "setup_s": setup_s}, flash_n, paged_n)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA card; nothing to run")
        return 2
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build

    dev = resolve_device(None)    # cuda:0, TF32 off for matmul and cuDNN
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {smi} | torch: {kind} x{count} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(json.dumps({"phase": "build", "sources": sorted(built),
                      "seconds": time.perf_counter() - t0}), flush=True)

    timer = Timer(dev)
    rows = [check_flash(dev, timer), check_paged(dev, timer)]
    for row in rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    del timer

    serve, flash_n, paged_n = serve_end_to_end(dev)
    print(json.dumps(serve), flush=True)
    rows[0]["launches"], rows[1]["launches"] = flash_n, paged_n
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
