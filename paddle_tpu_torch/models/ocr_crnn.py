"""OCR CRNN — the port of ``paddle_tpu/models/ocr_crnn.py``: a conv
feature extractor, its columns read as a sequence, a bidirectional LSTM
and CTC (the reference's scene-text recognition recipe).

Images are fixed [H, W]; the column sequence has the static length W'
of the pooled feature map, every row valid, which is what the CTC cost
consumes.  On the card the path runs the direct-conv kernel with its BN
epilogue (``layer.img_conv_bn``), the fused BiLSTM kernel
(``layer.bilstm``), the fused CTC forward-backward (``extras.ctc``) and,
for decoding, the fused greedy decode (:func:`ctc_decode`)."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.lod import SequenceBatch
from paddle_tpu_torch.layers import activation as act
from paddle_tpu_torch.layers import api as layer
from paddle_tpu_torch.layers import data_type, extras
from paddle_tpu_torch.layers.base import LayerOutput, gen_name, raw


def _columns_to_sequence(conv: LayerOutput, width: int) -> LayerOutput:
    """[B, H, W, C] feature map -> width-major sequence [B, W, H*C]."""
    name = gen_name("cols_to_seq")
    h, c = conv.height, conv.depth

    def fwd(ctx, params, states, x):
        v = raw(x)  # NHWC from the conv stack
        cols = v.permute(0, 2, 1, 3).reshape(v.shape[0], width, h * c)
        lengths = torch.full((v.shape[0],), width, dtype=torch.int64,
                             device=v.device)
        return SequenceBatch(data=cols, length=lengths)

    return LayerOutput(name=name, layer_type="seq_reshape",
                       size=h * c, parents=(conv,), fn=fwd)


def crnn_ctc_cost(image_height: int = 32, image_width: int = 96,
                  num_channels: int = 1, num_classes: int = 26,
                  rnn_size: int = 64):
    """Returns (cost, probs, feed_order).  ``num_classes`` excludes the
    blank (blank = the last index, the reference ctc_layer's convention)."""
    img = layer.data(
        name="image",
        type=data_type.dense_vector(num_channels * image_height * image_width),
        height=image_height, width=image_width,
    )
    # the conv stack on the fused conv + BN + ReLU node; BN replaces the
    # conv bias (the standard CRNN extractor form)
    conv1 = layer.img_conv_bn(name="crnn_conv1", input=img, filter_size=3,
                              num_filters=16, num_channels=num_channels,
                              padding=1, act=act.ReluActivation())
    pool1 = layer.img_pool(input=conv1, pool_size=2, stride=2)
    conv2 = layer.img_conv_bn(name="crnn_conv2", input=pool1, filter_size=3,
                              num_filters=32, padding=1,
                              act=act.ReluActivation())
    pool2 = layer.img_pool(input=conv2, pool_size=2, stride=2)
    seq_w = pool2.width  # pool layers use ceil-mode output sizes

    seq = _columns_to_sequence(pool2, seq_w)
    feat = layer.bilstm(input=seq, size=rnn_size, name="crnn_bilstm")
    probs = layer.fc(input=feat, size=num_classes + 1,
                     act=act.SoftmaxActivation())
    label = layer.data(
        name="label",
        type=data_type.integer_value_sequence(num_classes),
    )
    cost = extras.ctc(input=probs, label=label, size=num_classes + 1)
    return cost, probs, ["image", "label"]


def ctc_decode(log_probs, lengths, blank: int):
    """Serving/eval greedy decode for the CRNN head: the fused decode
    kernel (argmax, the blank/repeat collapse and the front-compaction of
    the kept frames, one launch) on the card, its twin on the CPU.
    Returns (ids [B, W'] padded with -1, lengths)."""
    from paddle_tpu_torch.ops.kernels.ctc import ctc_greedy_decode_fused

    return ctc_greedy_decode_fused(log_probs, lengths, blank=blank)


def synthetic_ocr_reader(n_samples: int = 512, image_height: int = 32,
                         image_width: int = 96, num_classes: int = 26,
                         max_label_len: int = 6, seed: int = 0):
    """Bar-code-like synthetic OCR task: each 'character' paints a distinct
    vertical stripe pattern, so a CRNN genuinely learns alignment (the
    JAX package's reader, sample for sample)."""
    rng = np.random.default_rng(seed)
    # glyphs are dataset constants, independent of the sample seed, so
    # train and test readers share the same alphabet
    protos = np.random.default_rng(7777).random(
        (num_classes, image_height, 12)) > 0.5

    def reader():
        for _ in range(n_samples):
            n = int(rng.integers(2, max_label_len + 1))
            labels = rng.integers(0, num_classes, size=n)
            img = np.zeros((image_height, image_width), np.float32)
            x = 2
            for c in labels:
                img[:, x:x + 12] = protos[c].astype(np.float32)
                x += 14
            img += rng.normal(0, 0.1, img.shape).astype(np.float32)
            yield img.reshape(-1), [int(c) for c in labels]

    return reader
