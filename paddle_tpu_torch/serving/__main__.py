"""``python -m paddle_tpu_torch.serving`` — a stdin request loop over the
serving engine (the port of ``python -m paddle_tpu.serving``).

One request per line: whitespace-separated token ids, e.g.::

    echo "5 17 3" | python -m paddle_tpu_torch.serving --random --max_new_tokens 8

Each completed request prints ``<id>: <generated ids>``.  ``--servable
DIR`` serves an artifact exported by ``paddle_tpu.serving.export``;
``--random`` serves seeded random weights.  ``--device`` picks the card
(``cuda``, the default) or ``cpu``.  ``--metrics_jsonl PATH`` streams the
per-request records + the final serve_summary.  The fleet
(``--replicas``) and the live status server are later slices."""

from __future__ import annotations

import argparse
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving",
        description="paddle_tpu_torch online serving CLI loop")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--servable", help="exported servable directory")
    src.add_argument("--random", action="store_true",
                     help="serve seeded random weights (smoke testing)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--embed", type=int, default=64)
    p.add_argument("--max_new_tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--page_size", type=int, default=16)
    p.add_argument("--num_pages", type=int, default=64)
    p.add_argument("--max_prompt_len", type=int, default=32)
    p.add_argument("--prefix_cache", action="store_true",
                   help="not ported yet: the engine refuses it")
    p.add_argument("--prefill_chunk_tokens", type=int, default=0,
                   help="not ported yet: the engine refuses a value > 0")
    p.add_argument("--metrics_jsonl", default=None)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from paddle_tpu_torch import metrics
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serving.engine import ServingEngine
    from paddle_tpu_torch.serving.export import load_servable
    from paddle_tpu_torch.serving.scheduler import ServingConfig

    device = resolve_device(args.device)
    if args.metrics_jsonl:
        metrics.configure(jsonl=args.metrics_jsonl)

    if args.servable:
        cfg, params = load_servable(args.servable, device=device)
    else:
        cfg = T.TransformerConfig(
            vocab_size=args.vocab, num_layers=args.layers,
            num_heads=args.heads, embed_dim=args.embed,
            mlp_dim=args.embed * 4, max_seq_len=256, remat=False)
        params = T.init_params(
            cfg, torch.Generator().manual_seed(args.seed), device=device)

    scfg = ServingConfig(
        max_slots=args.slots, page_size=args.page_size,
        num_pages=args.num_pages, max_prompt_len=args.max_prompt_len,
        max_new_tokens=args.max_new_tokens, seed=args.seed,
        prefix_cache=args.prefix_cache,
        prefill_chunk_tokens=args.prefill_chunk_tokens)
    eng = ServingEngine(cfg, params, scfg, device=device)

    # synchronous per-line loop: submit, drain, print — deterministic
    # output order for scripted callers
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            prompt = [int(t) for t in line.split()]
            eng.submit(prompt, max_new_tokens=args.max_new_tokens,
                       temperature=args.temperature)
        except Exception as e:  # bad ids / too long / out of vocab:
            # report and keep serving the rest of the stream
            print(f"error: rejected {line!r}: {e}", file=sys.stderr)
            continue
        eng.run_until_idle()
        for res in eng.results():
            print(f"{res.id}: {' '.join(str(t) for t in res.tokens)}",
                  flush=True)
    eng.emit_summary()
    metrics.get_registry().flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
