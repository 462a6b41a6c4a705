"""Composite network helpers — the port of ``paddle_tpu/layers/networks.py``
(≅ ``trainer_config_helpers/networks.py``): ``simple_gru2`` and
``simple_attention``, the pieces of the attention NMT."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import initializer as I
from paddle_tpu_torch.layers import activation as act_mod
from paddle_tpu_torch.layers import api as layer
from paddle_tpu_torch.layers.base import LayerOutput, gen_name
from paddle_tpu_torch.ops.math import matmul


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
