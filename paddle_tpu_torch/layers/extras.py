"""Structured-prediction layers of the port (``paddle_tpu/layers/extras.py``:
``ctc`` / ``ctc_layer`` so far; ``warp_ctc``, ``crf``, ``crf_decoding``
and the rest of that module are not ported yet).

``ctc_layer`` (reference layers.py:5189, CTCLayer) takes post-softmax
probabilities with ``size = num_classes + 1``; the blank is the LAST
index."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import logger
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.layers.base import LayerOutput, gen_name, is_sequence, raw
from paddle_tpu_torch.ops.kernels.ctc import ctc_loss_fused


def ctc(input: LayerOutput, label: LayerOutput, size: int | None = None,
        name: str | None = None, norm_by_times: bool = False) -> LayerOutput:
    """CTC cost (≅ ctc_layer): the batch mean of the per-sequence negative
    log-likelihood of ``label`` under ``input``'s probabilities, through
    the fused forward-backward (``kernels/ctc.ctc_loss_fused``) on
    log(clip(probs, 1e-12)); ``norm_by_times`` divides each row's loss by
    its input length first."""
    name = name or gen_name("ctc_layer")
    size = size or (label.size + 1)  # reference: label classes + blank
    if input.size != size:
        logger.warning(
            "ctc layer %s: input size %d != num_classes+1 (%d); the blank "
            "index follows `size`, matching the reference's CTCLayer",
            name, input.size, size)
    blank = size - 1

    def fwd(ctx, params, states, probs, lbl):
        enforce(is_sequence(probs) and is_sequence(lbl),
                "ctc expects sequence probs and labels")
        loss = ctc_loss_fused(torch.log(torch.clamp(probs.data, min=1e-12)),
                              probs.length, raw(lbl), lbl.length,
                              blank=blank)
        if norm_by_times:
            loss = loss / torch.clamp(probs.length.to(loss.dtype), min=1.0)
        return torch.mean(loss)

    return LayerOutput(name=name, layer_type="ctc", size=size,
                       parents=(input, label), fn=fwd,
                       attrs={"blank": blank, "norm_by_times": norm_by_times})


ctc_layer = ctc
