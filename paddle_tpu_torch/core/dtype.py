"""Dtype policy — float32 at full precision, bfloat16 with f32 sums.

The JAX package requests ``Precision.HIGHEST`` for f32 operands, so an
f32 product is a true f32 product (README "Mixed precision as policy"),
and feeds bf16 operands to the MXU with an f32 accumulator
(``preferred_element_type=jnp.float32``).  On the card the same policy
means TF32 off for matmuls AND for cuDNN (PyTorch leaves cuDNN
convolutions in TF32 by default, which keeps about three decimal
digits), and bf16 GEMMs that reduce their split-K partials in f32 (cuBLAS
may otherwise reduce them in bf16).  :func:`set_policy` sets all of it;
:func:`ensure_policy` and :func:`ensure_policy_for` set it once, where the
card is first used: every kernel launch, and the topology's forward (which
the train step, ``test`` and ``paddle.infer`` run).

A train step built with ``compute_dtype=torch.bfloat16`` runs forward and
backward in bf16 on f32 master parameters (:func:`cast_floats`,
:func:`cast_like`, the counterparts of ``paddle_tpu/trainer/step.py``'s
``_cast_floats`` and ``_cast_like``)."""

from __future__ import annotations

import dataclasses
import functools

import torch

_BY_NAME = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}

_applied = False


def set_policy() -> None:
    """Full-precision, reproducible numerics on the card: TF32 off in both
    the cuBLAS and the cuDNN paths, bf16 GEMMs reduced in f32, and cuDNN
    restricted to deterministic algorithms (set explicitly, not left to
    defaults).  The port's own kernels are deterministic; with cuDNN's
    conv backward deterministic too, a training run on the card repeats
    bit for bit, as the JAX package's do."""
    global _applied
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _applied = True


def ensure_policy() -> None:
    """:func:`set_policy`, once per process: a caller's later change of a
    flag (a planted fault, a timing of cuDNN's non-deterministic
    algorithms) stands."""
    if not _applied:
        set_policy()


def ensure_policy_for(tensors) -> None:
    """:func:`ensure_policy` when any of ``tensors`` lies on the card."""
    if not _applied and any(isinstance(t, torch.Tensor) and t.is_cuda
                            for t in tensors):
        set_policy()


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` upcast to float32, or as it is when it is wider: the f32
    accumulations of the port never narrow a float64 input, so the same
    code runs a double-precision witness step on the CPU."""
    return x if x.dtype == torch.float64 else x.float()


def matmul_dtype(*dtypes) -> torch.dtype:
    """The dtype :func:`cast_for_matmul` resolves operands of these dtypes
    to, without casting anything."""
    narrow = {d for d in (torch.float16, torch.bfloat16) if d in dtypes}
    return (narrow.pop() if len(narrow) == 1
            else functools.reduce(torch.promote_types, dtypes))


def cast_for_matmul(*tensors):
    """The operands of a product in one dtype, by the JAX package's rule
    (``paddle_tpu/core/dtype.py`` ``cast_for_matmul``, flag off): a mix
    that holds one narrow float (bf16 or f16) resolves to it, so f32 BN
    statistics meeting bf16 weights do not demote the product to f32;
    otherwise (no narrow float, or both) plain promotion."""
    first = tensors[0].dtype
    if all(t.dtype == first for t in tensors):   # the common case, cheaply
        return tensors if len(tensors) > 1 else tensors[0]
    common = matmul_dtype(*(t.dtype for t in tensors))
    out = tuple(t if t.dtype == common else t.to(common) for t in tensors)
    return out if len(out) > 1 else out[0]


def cast_floats(tree, dtype):
    """Every floating tensor of a nest of dicts, lists, tuples and
    dataclasses (a ``SequenceBatch``) cast to ``dtype``; integer tensors
    (label ids, lengths) and anything else as they are.  Inside autograd
    the cast of a leaf is an edge of the graph: its gradient reaches the
    leaf in the leaf's dtype."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: cast_floats(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree)})
    return tree


def cast_like(tree: dict, ref: dict) -> dict:
    """{k: tree[k] in ref[k]'s dtype}: new states back to the old ones'."""
    return {k: v.to(ref[k].dtype) for k, v in tree.items()}


def from_name(name: str) -> torch.dtype:
    """A dtype name as the JAX package stores it ("float32") -> torch."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(_BY_NAME)}") from None
