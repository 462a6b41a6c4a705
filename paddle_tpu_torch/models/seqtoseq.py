"""Attention seq2seq NMT — the port of ``paddle_tpu/models/seqtoseq.py``'s
training branch (the reference's ``demo/seqToseq/seqToseq_net.py``).

Encoder: the source embedding, then one ``layer.bigru`` node (both
directions in one kernel launch on the card).  Decoder: a
``recurrent_group`` whose step is a GRU step conditioned on a Bahdanau
attention context over the encoder, booted from the backward encoder's
first step; the 30,000-way softmax fc is sunk out of the step loop and
``classification_cost`` reads its logits.  Parameter names are the JAX
package's, so weights move between the packages by name.  Generation
(``is_generating=True``: beam search) is not ported yet (ROADMAP A4b)."""

from __future__ import annotations

from paddle_tpu_torch.layers import activation as act_mod
from paddle_tpu_torch.layers import api as layer
from paddle_tpu_torch.layers import data_type, networks
from paddle_tpu_torch.layers.attr import ParamAttr
from paddle_tpu_torch.layers.mixed import full_matrix_projection, mixed
from paddle_tpu_torch.layers.recurrent_group import (StaticInput,
                                                     gru_step_layer, memory,
                                                     recurrent_group)


def seqtoseq_net(source_dict_dim: int, target_dict_dim: int,
                 word_vector_dim: int = 64, encoder_size: int = 64,
                 decoder_size: int = 64, is_generating: bool = False,
                 beam_size: int = 3, max_length: int = 50):
    """The training cost layer over three ``integer_value_sequence`` slots:
    ``source_language_word``, ``target_language_word`` and
    ``target_language_next_word``."""
    if is_generating:
        raise NotImplementedError("seqtoseq_net(is_generating=True): beam-"
                                  "search generation is not ported yet "
                                  "(ROADMAP A4b)")
    src_word_id = layer.data(
        name="source_language_word",
        type=data_type.integer_value_sequence(source_dict_dim))
    src_embedding = layer.embedding(
        input=src_word_id, size=word_vector_dim,
        param_attr=ParamAttr(name="_source_language_embedding"))
    encoded_vector = layer.bigru(input=src_embedding, size=encoder_size,
                                 name="src_gru")
    src_backward = layer.slice(input=encoded_vector, start=encoder_size,
                               end=2 * encoder_size, name="src_gru_bw")
    encoded_proj = mixed(
        size=decoder_size, name="encoded_proj",
        input=full_matrix_projection(
            encoded_vector, size=decoder_size,
            param_attr=ParamAttr(name="_encoded_proj.w")))
    backward_first = layer.first_seq(input=src_backward)
    decoder_boot = mixed(
        size=decoder_size, act=act_mod.TanhActivation(), name="decoder_boot",
        input=full_matrix_projection(
            backward_first, size=decoder_size,
            param_attr=ParamAttr(name="_decoder_boot.w")))

    def gru_decoder_with_attention(enc_vec, enc_proj, current_word):
        decoder_mem = memory(name="gru_decoder", size=decoder_size,
                             boot_layer=decoder_boot)
        context = networks.simple_attention(
            encoded_sequence=enc_vec, encoded_proj=enc_proj,
            decoder_state=decoder_mem, name="attention")
        decoder_inputs = mixed(
            size=decoder_size * 3, name="decoder_inputs",
            input=[full_matrix_projection(
                       context, size=decoder_size * 3,
                       param_attr=ParamAttr(name="_decoder_inputs_ctx.w")),
                   full_matrix_projection(
                       current_word, size=decoder_size * 3,
                       param_attr=ParamAttr(name="_decoder_inputs_word.w"))])
        gru_step = gru_step_layer(
            name="gru_decoder", input=decoder_inputs, output_mem=decoder_mem,
            size=decoder_size, param_attr=ParamAttr(name="_gru_decoder.w"),
            bias_attr=ParamAttr(name="_gru_decoder.bias", initial_std=0.0,
                                initial_mean=0.0))
        return layer.fc(input=gru_step, size=target_dict_dim,
                        act=act_mod.SoftmaxActivation(),
                        param_attr=ParamAttr(name="_decoder_prob.w"),
                        bias_attr=ParamAttr(name="_decoder_prob.bias",
                                            initial_std=0.0,
                                            initial_mean=0.0),
                        name="decoder_prob")

    trg_embedding = layer.embedding(
        input=layer.data(
            name="target_language_word",
            type=data_type.integer_value_sequence(target_dict_dim)),
        size=word_vector_dim,
        param_attr=ParamAttr(name="_target_language_embedding"))
    decoder = recurrent_group(
        name="decoder_group", step=gru_decoder_with_attention,
        input=[StaticInput(input=encoded_vector, is_seq=True),
               StaticInput(input=encoded_proj, is_seq=True), trg_embedding])
    lbl = layer.data(name="target_language_next_word",
                     type=data_type.integer_value_sequence(target_dict_dim))
    return layer.classification_cost(input=decoder, label=lbl)
