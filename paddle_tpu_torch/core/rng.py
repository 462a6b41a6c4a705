"""RNG plumbing — the port of ``paddle_tpu/core/rng.py``.

The JAX package splits a process-global key once per train step.  Here
the global stream is a base seed and a step counter: step ``k`` draws
with the integer seed ``step_seed(base, k)``, and every layer that needs
random bits makes its own ``torch.Generator`` on its tensor's device from
that seed and its name (``layers/base.Context.generator_for``).  No
generator is shared across devices or kept at module level, so a rerun
from the same seed draws the same masks.  The bits differ from JAX's
threefry (and between the CPU and CUDA generators)."""

from __future__ import annotations

import time

DEFAULT_SEED = 1   # the JAX package's ``seed`` flag default

_MASK64 = (1 << 64) - 1
_base: int | None = None
_step = 0


def mix(x: int) -> int:
    """splitmix64's finaliser: a bijective 64-bit scramble."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``data`` (the counterpart
    of ``jax.random.fold_in``); fits ``torch.Generator.manual_seed``."""
    return mix(mix(seed) ^ (data & _MASK64)) >> 1


def seed(s: int | None = None) -> None:
    """Restart the stream at base seed ``s`` (default ``DEFAULT_SEED``;
    0 draws one from the clock, like the reference's seed=0)."""
    global _base, _step
    if s is None:
        s = DEFAULT_SEED
    if s == 0:
        s = time.time_ns() & 0x7FFFFFFF
    _base, _step = int(s), 0


def peek_seed() -> int:
    """The seed :func:`next_seed` will return, without consuming it."""
    if _base is None:
        seed()
    return fold_in(_base, _step)


def next_seed() -> int:
    """The seed of the next train step; advances the stream."""
    global _step
    out = peek_seed()
    _step += 1
    return out


def get_state() -> tuple[int, int]:
    """(base seed, step counter) of the stream."""
    if _base is None:
        seed()
    return _base, _step
