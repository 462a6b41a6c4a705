"""Composite network helpers — the port of ``paddle_tpu/layers/networks.py``
(≅ ``trainer_config_helpers/networks.py``): ``img_conv_group`` and
``small_vgg`` (the CIFAR-10 VGG with batch norm and dropout), and
``simple_gru2`` and ``simple_attention``, the pieces of the attention
NMT."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializer as I
from paddle_tpu_torch.layers import activation as act_mod
from paddle_tpu_torch.layers import api as layer
from paddle_tpu_torch.layers import pooling as pool_mod
from paddle_tpu_torch.layers.attr import ExtraAttr
from paddle_tpu_torch.layers.base import LayerOutput, gen_name
from paddle_tpu_torch.ops.math import matmul


def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0,
                   pool_stride=1, pool_type=None, **kw):
    """≅ networks.img_conv_group (the VGG building block): a conv per
    entry of ``conv_num_filter``, each followed, with
    ``conv_with_batchnorm``, by a batch norm carrying ``conv_act`` (the
    conv itself then linear) and a dropout where its rate is nonzero;
    then one pool (max by default)."""
    tmp = input
    n = len(conv_num_filter)
    if not isinstance(conv_padding, list):
        conv_padding = [conv_padding] * n
    if not isinstance(conv_batchnorm_drop_rate, list):
        conv_batchnorm_drop_rate = [conv_batchnorm_drop_rate] * n
    for i, nf in enumerate(conv_num_filter):
        tmp = layer.img_conv(
            input=tmp, filter_size=conv_filter_size, num_filters=nf,
            num_channels=num_channels if i == 0 else None,
            padding=conv_padding[i],
            act=act_mod.LinearActivation() if conv_with_batchnorm
            else conv_act)
        if conv_with_batchnorm:
            tmp = layer.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layer.dropout(input=tmp,
                                    dropout_rate=conv_batchnorm_drop_rate[i])
    return layer.img_pool(input=tmp, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type or pool_mod.MaxPooling())


def small_vgg(input_image, num_channels, num_classes):
    """≅ networks.small_vgg (the PaddlePaddle book's ``vgg_bn_drop`` for
    CIFAR-10): four conv groups with batch norm (64x2, 128x2, 256x3,
    512x3; dropout 0.3 or 0.4 after every conv but a group's last), a
    max pool, dropout 0.5, fc 512 with ``drop_rate`` 0.5, a batch norm
    and the softmax fc."""
    def group(ipt, num_filter, times, dropouts, channels=None):
        return img_conv_group(
            input=ipt, num_channels=channels, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * times, conv_filter_size=3,
            conv_act=act_mod.ReluActivation(), conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type=pool_mod.MaxPooling())

    tmp = group(input_image, 64, 2, [0.3, 0], num_channels)
    tmp = group(tmp, 128, 2, [0.4, 0])
    tmp = group(tmp, 256, 3, [0.4, 0.4, 0])
    tmp = group(tmp, 512, 3, [0.4, 0.4, 0])
    tmp = layer.img_pool(input=tmp, stride=2, pool_size=2,
                         pool_type=pool_mod.MaxPooling())
    tmp = layer.dropout(input=tmp, dropout_rate=0.5)
    tmp = layer.fc(input=tmp, size=512, act=act_mod.LinearActivation(),
                   layer_attr=ExtraAttr(drop_rate=0.5))
    tmp = layer.batch_norm(input=tmp, act=act_mod.ReluActivation())
    return layer.fc(input=tmp, size=num_classes,
                    act=act_mod.SoftmaxActivation())


def simple_gru2(input, size, name=None, reverse=False, mixed_param_attr=None,
                mixed_bias_attr=None, mixed_layer_attr=None,
                gru_param_attr=None, gru_bias_attr=None, act=None,
                gate_act=None, gru_cell_attr=None, **kw):
    """≅ networks.simple_gru2: a mixed W_x transform of size 3*size, then
    one ``grumemory`` (parameters ``_<name>_transform.w0`` and
    ``_<name>.w0`` / ``.wbias``)."""
    from paddle_tpu_torch.layers.mixed import full_matrix_projection, mixed

    name = name or gen_name("simple_gru2")
    with mixed(name=f"{name}_transform", size=size * 3,
               bias_attr=mixed_bias_attr, layer_attr=mixed_layer_attr) as m:
        m += full_matrix_projection(input=input, param_attr=mixed_param_attr)
    return layer.grumemory(input=m, reverse=reverse, name=name,
                           bias_attr=gru_bias_attr, param_attr=gru_param_attr,
                           act=act, gate_act=gate_act,
                           layer_attr=gru_cell_attr)


def _attention_weights(scores, mask):
    """softmax over the valid encoder steps of each row: scores and mask
    [B, T]; padded steps get no weight."""
    scores = torch.where(mask > 0, scores, torch.full_like(scores, -1e9))
    attn = torch.exp(scores - scores.amax(dim=1, keepdim=True)) * mask
    return attn / torch.clamp(attn.sum(dim=1, keepdim=True), min=1e-9)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     weight_act=None, name=None):
    """Bahdanau additive attention context (≅ networks.simple_attention):

        e_j = v . f(W s + U h_j);  a = softmax_j(e) over the valid steps;
        context = sum_j a_j h_j

    with U h_j precomputed outside the loop as ``encoded_proj``.  One node
    (a small product, the masked softmax, the weighted sum), with the
    reference's parameters: W (``<name>_transform.w``) and v
    (``<name>_softmax.w``).  Inside a recurrent_group step,
    ``encoded_sequence`` and ``encoded_proj`` enter as StaticInput and
    ``decoder_state`` is a memory."""
    from paddle_tpu_torch.layers.api import _wspec

    name = name or gen_name("simple_attention")
    proj_size = encoded_proj.size
    w_spec = _wspec(transform_param_attr, f"{name}_transform", "w",
                    (decoder_state.size, proj_size), I.paddle_default())
    v_spec = _wspec(softmax_param_attr, f"{name}_softmax", "w",
                    (proj_size, 1), I.paddle_default())
    wact = act_mod.get(weight_act) if weight_act else act_mod.TanhActivation()

    def fwd(ctx, params, states, enc_seq, enc_proj, dec_state):
        # enc_seq [B, T, D] and enc_proj [B, T, P] sequences; dec_state
        # [B, S] (the memory's value)
        comb = wact(matmul(dec_state, params[w_spec.name])[:, None, :]
                    + enc_proj.data)
        scores = matmul(comb, params[v_spec.name])[..., 0]       # [B, T]
        attn = _attention_weights(scores, enc_seq.mask(scores.dtype))
        return torch.einsum("bt,btd->bd", attn, enc_seq.data)

    return LayerOutput(name=name, layer_type="simple_attention",
                       size=encoded_sequence.size,
                       parents=(encoded_sequence, encoded_proj,
                                decoder_state),
                       param_specs=(w_spec, v_spec), fn=fwd,
                       attrs={"proj_size": proj_size})
