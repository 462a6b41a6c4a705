"""Wide & Deep CTR — the port of ``paddle_tpu/models/ctr.py``: a
sparse-binary wide input through one linear fc, one embedding table per
categorical field through an MLP, a 2-way softmax over both.

The tables carry ``sharding=("model", None)`` as in the JAX package (one
card has no mesh, so nothing reads it) and ``sparse_update=True``: under
SGD or Momentum a row a batch does not touch keeps parameter and momentum
bit for bit (``optimizer.lazy_sparse_rows``; on the card one launch of
``ops/kernels/embedding.sparse_row_update`` a step for all the tables)."""

from __future__ import annotations

from paddle_tpu_torch.layers import activation as act_mod
from paddle_tpu_torch.layers import api as layer
from paddle_tpu_torch.layers import data_type
from paddle_tpu_torch.layers.attr import ParamAttr


def wide_and_deep_ctr(wide_dim: int, categorical_vocab_sizes: list[int],
                      embedding_size: int = 16,
                      hidden_sizes: tuple[int, ...] = (64, 32),
                      pad_vocab_to: int | None = None,
                      sparse_update: bool = True):
    """Returns (cost, predict, input_names).

    Inputs: one sparse-binary wide vector, one integer id per categorical
    field, and an integer label in {0, 1}.  ``sparse_update`` marks the
    tables for the row-lazy optimizer rule.  ``pad_vocab_to`` (rows padded
    for a row-sharded table) raises, as ``layer.embedding(pad_rows_to=)``
    does: the port has no mesh yet."""
    wide_in = layer.data(name="wide_input",
                         type=data_type.sparse_binary_vector(wide_dim))
    cat_ins = [
        layer.data(name=f"cat_{i}", type=data_type.integer_value(v))
        for i, v in enumerate(categorical_vocab_sizes)
    ]
    embs = [
        layer.embedding(
            input=c, size=embedding_size, pad_rows_to=pad_vocab_to,
            param_attr=ParamAttr(name=f"emb_{i}",
                                 sharding=("model", None),
                                 sparse_update=sparse_update))
        for i, c in enumerate(cat_ins)
    ]
    deep = layer.concat(input=embs) if len(embs) > 1 else embs[0]
    for j, h in enumerate(hidden_sizes):
        deep = layer.fc(input=deep, size=h, act=act_mod.ReluActivation(),
                        name=f"deep_fc{j}")
    wide_proj = layer.fc(input=wide_in, size=8,
                         act=act_mod.LinearActivation(), name="wide_proj")
    top = layer.concat(input=[wide_proj, deep])
    predict = layer.fc(input=top, size=2, act=act_mod.SoftmaxActivation(),
                       name="ctr_predict")
    label = layer.data(name="label", type=data_type.integer_value(2))
    cost = layer.classification_cost(input=predict, label=label)
    input_names = ["wide_input"] + [c.name for c in cat_ins] + ["label"]
    return cost, predict, input_names
