"""Mixed layer and projections — the port of ``paddle_tpu/layers/mixed.py``
(≅ ``MixedLayer`` over ``FullMatrixProjection`` and
``IdentityProjection``; ``trainer_config_helpers/layers.py`` ``mixed_layer``).

A projection is a function of one input value; the mixed node sums its
projections, adds the bias and applies the activation (default linear).
Parameters are named by the owning layer when it is finalized
(``_<layer>.w<slot>``), so parameter and config names match the JAX
package's.  Both the functional form ``mixed(input=[...])`` and the
incremental ``with mixed(size=...) as m: m += proj`` form work.  The other
projections and operators of the JAX module are not ported yet: calling
one raises ``NotImplementedError``."""

from __future__ import annotations

import dataclasses
from typing import Callable

from paddle_tpu_torch.core import initializer as I
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.lod import SequenceBatch
from paddle_tpu_torch.core.parameters import ParamSpec
from paddle_tpu_torch.layers import activation as act_mod
from paddle_tpu_torch.layers.attr import ParamAttr
from paddle_tpu_torch.layers.base import LayerOutput, gen_name, raw
from paddle_tpu_torch.ops.math import matmul


def _like(v, data):
    return SequenceBatch(data=data, length=v.length) if isinstance(
        v, SequenceBatch) else data


@dataclasses.dataclass
class Projection:
    """One summand inside a mixed layer (≅ a ProjectionConfig).  The
    parameter, if any, is unnamed until the owning layer binds it;
    ``make_fn(spec)`` builds the runtime closure ``fn(params, value)``,
    which reads the spec's name when it runs (a recurrent_group renames
    the auto-named parameters of its step layers)."""

    inputs: tuple[LayerOutput, ...]
    size: int  # output size (0 = adopt the mixed layer's)
    proj_type: str
    param_shape: tuple | None = None
    param_attr: ParamAttr | None = None
    make_fn: Callable = None
    spec: ParamSpec | None = None

    def bind(self, pname: str) -> tuple[ParamSpec | None, Callable]:
        from paddle_tpu_torch.layers.api import _wspec

        spec = None
        if self.param_shape is not None:
            base, _, suffix = pname.rpartition(".")
            spec = _wspec(self.param_attr, base[1:], suffix, self.param_shape,
                          I.paddle_default())
        self.spec = spec
        return spec, self.make_fn(spec)


def full_matrix_projection(input: LayerOutput, size: int = 0,
                           param_attr: ParamAttr | None = None) -> Projection:
    """out = in @ W (≅ FullMatrixProjection), per step of a sequence."""

    def make_fn(spec):
        def fn(params, v):
            x = raw(v)
            y = matmul(x.reshape(-1, input.size), params[spec.name])
            return _like(v, y.reshape(x.shape[:-1] + (-1,)))

        return fn

    return Projection(inputs=(input,), size=size, proj_type="fc",
                      param_shape=None if size == 0 else (input.size, size),
                      param_attr=param_attr, make_fn=make_fn)


def identity_projection(input: LayerOutput, offset: int | None = None,
                        size: int | None = None) -> Projection:
    """Pass-through, optionally the feature slice [offset, offset + size)
    (≅ IdentityProjection / IdentityOffsetProjection)."""
    if offset is None:
        return Projection(inputs=(input,), size=input.size,
                          proj_type="identity",
                          make_fn=lambda spec: lambda params, v: v)
    out_size = size or (input.size - offset)

    def make_fn(spec):
        return lambda params, v: _like(v, raw(v)[..., offset:offset
                                                 + out_size])

    return Projection(inputs=(input,), size=out_size,
                      proj_type="identity_offset", make_fn=make_fn)


def _not_ported(name: str) -> Callable:
    def unported(*args, **kwargs):
        raise NotImplementedError(f"mixed.{name} is not ported yet")

    unported.__name__ = name
    return unported


trans_full_matrix_projection = _not_ported("trans_full_matrix_projection")
slice_projection = _not_ported("slice_projection")
scaling_projection = _not_ported("scaling_projection")
dotmul_projection = _not_ported("dotmul_projection")
table_projection = _not_ported("table_projection")
context_projection = _not_ported("context_projection")
conv_projection = _not_ported("conv_projection")
dotmul_operator = _not_ported("dotmul_operator")
conv_operator = _not_ported("conv_operator")


class MixedLayerOutput(LayerOutput):
    """LayerOutput that also supports the incremental ``with``/``+=`` form."""

    def __iadd__(self, other: Projection):
        enforce(isinstance(other, Projection), "mixed += expects a Projection")
        enforce(not self._finalized, "mixed layer already finalized")
        self._projections.append(other)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            _finalize_mixed(self)
        return False


def mixed(size: int | None = None, input=None, name: str | None = None,
          act=None, bias_attr=None, layer_attr=None) -> MixedLayerOutput:
    """≅ mixed_layer: the sum of its projections, plus the bias (only when
    ``bias_attr`` is True or a ParamAttr), through the activation (default
    linear)."""
    from paddle_tpu_torch.layers.api import _check_layer_attr

    _check_layer_attr(layer_attr)
    name = name or gen_name("mixed")
    node = MixedLayerOutput(name=name, layer_type="mixed", size=size or 0)
    node._projections = []
    node._finalized = False
    node._act = act_mod.get(act) if act else act_mod.LinearActivation()
    node._bias_attr = bias_attr
    if input is not None:
        for p in (input if isinstance(input, (list, tuple)) else [input]):
            enforce(isinstance(p, Projection),
                    "mixed input must be projections (full_matrix_projection"
                    ", identity_projection)")
            node._projections.append(p)
        _finalize_mixed(node)
    return node


mixed_layer = mixed


def _finalize_mixed(node: MixedLayerOutput) -> None:
    """Bind the projections' parameters to the layer (one input slot each),
    then set the node's size, parents, parameters and forward."""
    projs = node._projections
    enforce(len(projs) > 0, f"mixed layer {node.name!r} has no inputs")
    size = node.size or next((p.size for p in projs if p.size), 0)
    enforce(size, f"mixed layer {node.name!r}: size is not set")
    for p in projs:
        if p.size == 0:  # an fc with its size elided adopts the layer's
            p.size = size
            p.param_shape = (p.inputs[0].size, size)
        enforce(p.size == size, f"mixed layer {node.name!r}: projection "
                f"size {p.size} != {size}")
    fns, specs = [], []
    for idx, p in enumerate(projs):
        spec, fn = p.bind(f"_{node.name}.w{idx}")
        if spec is not None:
            specs.append(spec)
        fns.append(fn)
    use_bias = node._bias_attr is True or isinstance(node._bias_attr,
                                                     ParamAttr)
    bspec = None
    if use_bias:
        from paddle_tpu_torch.layers.api import _wspec

        battr = node._bias_attr if isinstance(node._bias_attr,
                                              ParamAttr) else None
        bspec = _wspec(battr, node.name, "wbias", (size,), I.constant(0.0))
        specs.append(bspec)
    act = node._act

    def fwd(ctx, params, states, *slot_values):
        total, template = None, None
        for fn, v in zip(fns, slot_values):
            out = fn(params, v)
            if template is None and isinstance(out, SequenceBatch):
                template = out
            total = raw(out) if total is None else total + raw(out)
        if bspec is not None:
            total = total + params[bspec.name]
        total = act(total)
        return _like(template, total) if template is not None else total

    node.size = size
    node.parents = tuple(p.inputs[0] for p in projs)
    node.param_specs = tuple(specs)
    node.fn = fwd
    node.attrs = {"active_type": act.name}
    node._finalized = True
