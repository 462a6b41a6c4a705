"""Device selection — the port's counterpart of ``paddle_tpu/core/place.py``.

The port runs on the card.  ``resolve_device(None)`` is ``cuda:0`` and
raises when CUDA is absent: a silent fall back to the CPU would hand a
caller CPU timings under a GPU entry point.  The CPU is used only when
asked for by name (``device="cpu"``), as the tests do."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import set_policy
from paddle_tpu_torch.core.enforce import EnforceError


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; a string or ``torch.device`` passes through.
    A CUDA device without a visible card raises :class:`EnforceError`."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise EnforceError(
                f"device {dev} requested but torch sees no CUDA card; pass "
                "device='cpu' to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_policy()
    elif dev.type != "cpu":
        raise EnforceError(f"unsupported device {dev}: the port runs on "
                           "'cuda' (default) or 'cpu'")
    return dev
