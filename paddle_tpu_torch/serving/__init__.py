"""paddle_tpu_torch.serving — the online inference engine on the card (the
port of ``paddle_tpu.serving``'s engine path).

- ``kv_cache``  — PageAllocator (free list, null page 0) + PagedKVCache
  (device page pools + host page tables);
- ``scheduler`` — continuous-batching request scheduler, deterministic
  given seed + arrival order;
- ``engine``    — ServingEngine: thread-safe submit()/results() over a
  background step loop or synchronous ``run_until_idle``;
- ``sampling``  — greedy + temperature sampling, per-request seeded;
- ``export``    — ``load_servable`` for artifacts the JAX package
  exported;
- ``__main__``  — ``python -m paddle_tpu_torch.serving`` stdin CLI loop.

Kernels: ``ops/kernels/paged_attention.py`` (decode) and
``ops/kernels/flash_attention.py`` (prefill)."""

from paddle_tpu_torch.serving.engine import ServingEngine  # noqa: F401
from paddle_tpu_torch.serving.export import load_servable  # noqa: F401
from paddle_tpu_torch.serving.kv_cache import (  # noqa: F401
    PageAllocator,
    PagedKVCache,
)
from paddle_tpu_torch.serving.sampling import sample_tokens  # noqa: F401
from paddle_tpu_torch.serving.scheduler import (  # noqa: F401
    Request,
    RequestResult,
    Scheduler,
    ServingConfig,
)
