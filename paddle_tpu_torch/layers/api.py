"""The ``paddle.layer`` surface of the port — the v2 layer constructors of
the image and text paths, ported from ``paddle_tpu/layers/api.py`` with
the same names, ``attrs``, parameter and state names, so a parameter dict
moves between the packages by name and ``Topology.serialize()`` agrees
byte for byte.

Each constructor returns a :class:`LayerOutput` node whose forward is a
function of torch tensors and :class:`SequenceBatch` values.  Images are
NHWC inside; v2 data layers feed flat CHW rows, which image layers
reshape on entry (:func:`_to_nhwc`).  Per-step layers (fc) act on every
step of a sequence as one [B*T, D] product."""

from __future__ import annotations

import math as _pymath
from typing import Sequence

import torch
import torch.nn.functional as F

from paddle_tpu_torch.config import parse_state
from paddle_tpu_torch.core import initializer as I
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.lod import SequenceBatch
from paddle_tpu_torch.core.parameters import ParamSpec
from paddle_tpu_torch.layers import activation as act_mod
from paddle_tpu_torch.layers import pooling as pool_mod
from paddle_tpu_torch.layers.attr import ExtraAttr, ParamAttr, param_attr_or_default
from paddle_tpu_torch.layers.base import (Context, LayerOutput, StateSpec,
                                          gen_name, is_sequence, map_data,
                                          raw)
from paddle_tpu_torch.layers.data_type import InputType
from paddle_tpu_torch.ops import loss as loss_ops
from paddle_tpu_torch.ops import math as math_ops
from paddle_tpu_torch.ops import nn as nn_ops
from paddle_tpu_torch.ops import rnn as rnn_ops
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.ops.embedding import lookup as emb_lookup


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _pname(attr: ParamAttr | None, layer_name: str, suffix: str) -> str:
    if attr is not None and attr.name:
        return attr.name
    return f"_{layer_name}.{suffix}"


def _wspec(attr, layer_name, suffix, shape, default_init, **kw) -> ParamSpec:
    a = param_attr_or_default(attr)
    gd = parse_state.G_DEFAULTS
    fields = dict(
        name=_pname(a, layer_name, suffix),
        shape=tuple(shape),
        initializer=a.make_initializer(default_init),
        is_static=a.is_static,
        learning_rate=1.0 if a.learning_rate is None else a.learning_rate,
        decay_rate=a.l2_rate if a.l2_rate is not None else gd["decay_rate"],
        momentum=a.momentum if a.momentum is not None else gd["momentum"],
        attr=a,
        gradient_clipping_threshold=a.gradient_clipping_threshold,
        sparse=a.sparse_update,
        sparsity_ratio=a.sparsity_ratio,
    )
    fields.update(kw)
    return ParamSpec(**fields)


def _check_layer_attr(layer_attr: ExtraAttr | None) -> None:
    """Layer-level knobs the port does not run yet raise, never pass
    silently."""
    if layer_attr is not None and layer_attr.error_clipping_threshold:
        raise NotImplementedError("ExtraAttr(error_clipping_threshold=...) "
                                  "is not ported yet")


def _maybe_dropout(node: LayerOutput,
                   layer_attr: ExtraAttr | None) -> LayerOutput:
    """Fold ``ExtraAttr(drop_rate=)`` into the node itself, as the
    reference stores it (``LayerConfig.drop_rate`` on the same layer, no
    extra layer): in training the node's output goes through
    ``ops/nn.dropout`` with the generator of the node's name, and
    ``attrs["drop_rate"]`` records the rate."""
    _check_layer_attr(layer_attr)
    if layer_attr is None or not layer_attr.drop_rate:
        return node
    rate = layer_attr.drop_rate
    inner = node.fn

    def fwd(ctx, params, states, *xs):
        result = inner(ctx, params, states, *xs)
        if not ctx.is_train:
            return result

        def drop(v):
            gen = ctx.generator_for(node.name, raw(v).device)
            return map_data(lambda d: nn_ops.dropout(d, rate, gen, True), v)

        if (isinstance(result, tuple) and len(result) == 2
                and isinstance(result[1], dict)):
            return drop(result[0]), result[1]
        return drop(result)

    node.fn = fwd
    node.attrs["drop_rate"] = rate
    return node


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def data(name: str, type: InputType, height: int = 0, width: int = 0) -> LayerOutput:
    """≅ v2 paddle.layer.data / data_layer."""
    h, w, c = height or type.height, width or type.width, type.channels
    if not (h and w) and c:
        side = int(_pymath.sqrt(type.dim // c))
        if side * side * c == type.dim:
            h = w = side
    return LayerOutput(
        name=name,
        layer_type="data",
        size=type.dim,
        height=h,
        width=w,
        depth=c or 1,
        attrs={"data_type": type.kind, "seq_type": type.seq_type,
               "dim": type.dim},
    )


data_layer = data


# ---------------------------------------------------------------------------
# fully connected
# ---------------------------------------------------------------------------


def fc(input, size: int, act=None,
       param_attr: ParamAttr | Sequence[ParamAttr] | None = None,
       bias_attr=None, layer_attr: ExtraAttr | None = None,
       name: str | None = None) -> LayerOutput:
    """≅ fc_layer: multi-input weighted sum + bias + act.  A 4-D (NHWC)
    input is flattened per example in H, W, C order, as the JAX package
    does, so carried weights mean the same; sequence inputs are handled
    per step (one [B*T, D] product).  A softmax fc exposes its pre-softmax
    logits (``__fc_logits__``) for ``classification_cost``'s fused
    cross-entropy, unless it drops out (``ExtraAttr(drop_rate=)``)."""
    inputs = _as_list(input)
    name = name or gen_name("fc_layer")
    pattrs = (param_attr if isinstance(param_attr, (list, tuple))
              else [param_attr] * len(inputs))
    specs = [_wspec(pa, name, f"w{i}", (inp.size, size), I.xavier())
             for i, (inp, pa) in enumerate(zip(inputs, pattrs))]
    use_bias = bias_attr is not False
    if use_bias:
        bspec = _wspec(bias_attr if isinstance(bias_attr, ParamAttr) else None,
                       name, "wbias", (size,), I.constant(0.0))
        specs.append(bspec)
    # the reference fc_layer's default act is Tanh
    activation = act_mod.get(act) if act is not None else act_mod.TanhActivation()

    def apply(params, parents, apply_act):
        def compute(flats):
            y = None
            for i, x in enumerate(flats):
                x2 = x.reshape(x.shape[0], -1) if x.dim() > 2 else x
                t = math_ops.matmul(x2, params[specs[i].name])
                y = t if y is None else y + t
            if use_bias:
                y = y + params[bspec.name]
            return activation(y) if apply_act else y

        if any(is_sequence(p) for p in parents):
            ref = next(p for p in parents if is_sequence(p))
            b, t = ref.data.shape[:2]
            y = compute([raw(p).reshape(b * t, -1) for p in parents])
            return SequenceBatch(data=y.reshape(b, t, size),
                                 length=ref.length)
        return compute([raw(p) for p in parents])

    def fwd(ctx: Context, params, states, *parents):
        return apply(params, parents, True)

    node = _maybe_dropout(LayerOutput(
        name=name, layer_type="fc", size=size, parents=tuple(inputs),
        param_specs=tuple(specs), fn=fwd,
        attrs={"size": size, "active_type": activation.name,
               "bias_spec": bspec.name if use_bias else None},
    ), layer_attr)
    if activation.name == "softmax" and not node.attrs.get("drop_rate"):
        node.attrs["__fc_logits__"] = (
            lambda ctx, params, states, *parents: apply(params, parents,
                                                        False))
    return node


fc_layer = fc


def embedding(input: LayerOutput, size: int,
              param_attr: ParamAttr | None = None, name: str | None = None,
              padding_idx: int | None = None,
              pad_rows_to: int | None = None) -> LayerOutput:
    """≅ embedding_layer (a mixed layer holding one TableProjection, which
    is its proto shape too): ``ops/embedding.lookup`` of the integer ids,
    per step of a sequence.  The table is a ``sparse=True`` parameter,
    as in the JAX package; ``pad_rows_to`` (row-sharding over a mesh) is
    not ported."""
    if pad_rows_to:
        raise NotImplementedError("embedding(pad_rows_to=...) (a row-"
                                  "sharded table) is not ported yet")
    name = name or gen_name("embedding")
    vocab = input.size
    spec = _wspec(param_attr, name, "w0", (vocab, size),
                  I.paddle_default(0.0, None), sparse=True)

    def fwd(ctx, params, states, ids):
        table = params[spec.name]
        return map_data(lambda d: emb_lookup(table, d, padding_idx), ids)

    return LayerOutput(
        name=name, layer_type="mixed", size=size, parents=(input,),
        param_specs=(spec,), fn=fwd,
        attrs={"size": size, "vocab": vocab, "active_type": ""},
    )


embedding_layer = embedding


# ---------------------------------------------------------------------------
# image layers (NHWC internally; accepts flat [B, C*H*W] v2 input)
# ---------------------------------------------------------------------------


def _to_nhwc(x: torch.Tensor, channels: int, height: int, width: int) -> torch.Tensor:
    """v2 data layers feed flat CHW rows; image layers reshape on entry."""
    if x.dim() == 4:
        return x
    b = x.shape[0]
    return x.reshape(b, channels, height, width).permute(0, 2, 3, 1)


def _image_size(input: LayerOutput, channels: int) -> tuple[int, int]:
    h_in, w_in = input.height, input.width
    if not (h_in and w_in):
        side = int(_pymath.sqrt(input.size // channels))
        h_in = w_in = side
    return h_in, w_in


def img_conv(input: LayerOutput, filter_size, num_filters: int,
             num_channels: int | None = None, stride=1, padding=0,
             groups: int = 1, act=None, param_attr: ParamAttr | None = None,
             bias_attr=None, shared_biases: bool = True,
             layer_attr: ExtraAttr | None = None, name: str | None = None,
             trans: bool = False, dilation=1, filter_size_y=None,
             stride_y=None, padding_y=None) -> LayerOutput:
    """≅ img_conv_layer over ExpandConvLayer: ``ops/nn.conv2d`` on NHWC
    (the direct-conv kernel on the card for its shape class).  ``*_y``
    kwargs follow the reference: None means "same as x"."""
    if trans:
        raise NotImplementedError("img_conv(trans=True) (transposed conv) "
                                  "is not ported yet")
    name = name or gen_name("conv")
    kh, kw = nn_ops.pair(filter_size)
    sh, sw = nn_ops.pair(stride)
    ph, pw = nn_ops.pair(padding)
    if filter_size_y is not None:
        kh = filter_size_y
    if stride_y is not None:
        sh = stride_y
    if padding_y is not None:
        ph = padding_y
    c_in = num_channels or input.depth
    h_in, w_in = _image_size(input, c_in)
    h_out = nn_ops.conv_out(h_in, kh, sh, ph)
    w_out = nn_ops.conv_out(w_in, kw, sw, pw)
    wspec = _wspec(param_attr, name, "w0",
                   (kh, kw, c_in // groups, num_filters), I.msra())
    specs = [wspec]
    use_bias = bias_attr is not False
    if use_bias:
        bspec = _wspec(bias_attr if isinstance(bias_attr, ParamAttr) else None,
                       name, "wbias", (num_filters,), I.constant(0.0))
        specs.append(bspec)
    # the reference img_conv_layer's default act is ReLU
    activation = act_mod.get(act) if act is not None else act_mod.ReluActivation()

    def fwd(ctx, params, states, x):
        x = _to_nhwc(raw(x), c_in, h_in, w_in)
        y = nn_ops.conv2d(x, params[wspec.name], (sh, sw), (ph, pw),
                          dilation=dilation, groups=groups)
        if use_bias:
            y = y + params[bspec.name]
        return activation(y)

    return _maybe_dropout(LayerOutput(
        name=name, layer_type="exconv", size=num_filters * h_out * w_out,
        parents=(input,), param_specs=tuple(specs), fn=fwd, height=h_out,
        width=w_out, depth=num_filters,
        attrs={"filter_size": [kh, kw], "stride": [sh, sw],
               "padding": [ph, pw], "num_filters": num_filters,
               "groups": groups, "trans": trans, "channels": c_in,
               "active_type": activation.name},
    ), layer_attr)


img_conv_layer = img_conv


def img_pool(input: LayerOutput, pool_size, num_channels: int | None = None,
             pool_type=None, stride=1, padding=0,
             layer_attr: ExtraAttr | None = None, name: str | None = None,
             ceil_mode: bool = True) -> LayerOutput:
    """≅ img_pool_layer; the reference default is ceil mode.  Ceil mode is
    an explicit extra right/bottom pad (-inf for max, zeros for average),
    and average pooling divides by the count of real cells in each window
    — not ``F.max_pool2d(ceil_mode=True)``, whose edge windows differ."""
    name = name or gen_name("pool")
    kh, kw = nn_ops.pair(pool_size)
    sh, sw = nn_ops.pair(stride)
    ph, pw = nn_ops.pair(padding)
    ptype = pool_mod.get(pool_type)
    enforce(ptype in ("max", "average"),
            f"img_pool: pool_type {ptype!r} is not ported yet")
    c = num_channels or input.depth
    h_in, w_in = _image_size(input, c)

    def osz(sz, k, s, p):
        if ceil_mode:
            return int(_pymath.ceil((sz + 2 * p - k) / s)) + 1
        return (sz + 2 * p - k) // s + 1

    h_out, w_out = osz(h_in, kh, sh, ph), osz(w_in, kw, sw, pw)
    # extra right/bottom padding for ceil mode
    eh = max((h_out - 1) * sh + kh - 2 * ph - h_in, 0)
    ew = max((w_out - 1) * sw + kw - 2 * pw - w_in, 0)
    pads = (0, 0, pw, pw + ew, ph, ph + eh)  # F.pad order: C, W, H

    def fwd(ctx, params, states, x):
        x = _to_nhwc(raw(x), c, h_in, w_in)
        if ptype == "max":
            xp = F.pad(x, pads, value=float("-inf"))
            return nn_ops.max_pool2d(xp, (kh, kw), (sh, sw), 0)
        summed = nn_ops.avg_pool2d(F.pad(x, pads), (kh, kw), (sh, sw),
                                   0) * (kh * kw)
        ones = torch.ones_like(x[..., :1])
        counts = nn_ops.avg_pool2d(F.pad(ones, pads), (kh, kw), (sh, sw),
                                   0) * (kh * kw)
        return summed / torch.clamp(counts, min=1.0)

    return _maybe_dropout(LayerOutput(
        name=name, layer_type="pool", size=c * h_out * w_out,
        parents=(input,), fn=fwd, height=h_out, width=w_out, depth=c,
        attrs={"pool_type": ptype, "pool_size": [kh, kw],
               "stride": [sh, sw], "padding": [ph, pw], "channels": c,
               "ceil_mode": ceil_mode},
    ), layer_attr)


img_pool_layer = img_pool


def batch_norm(input: LayerOutput, act=None, num_channels: int | None = None,
               bias_attr=None, param_attr: ParamAttr | None = None,
               use_global_stats: bool | None = None,
               moving_average_fraction: float = 0.9, epsilon: float = 1e-5,
               layer_attr: ExtraAttr | None = None, img3D: bool = False,
               mean_var_names=None, batch_norm_type: str | None = None,
               name: str | None = None) -> LayerOutput:
    """≅ batch_norm_layer over BatchNormalizationLayer: ``ops/nn.batch_norm``
    (the train-mode moments from the ``channel_stats`` kernel on the
    card).  An image input is normalized over N, H and W per channel; a
    flat [B, C] input (or a sequence's steps) over its rows.  The moving
    statistics are states named ``_<name>.w1`` / ``.w2`` (or
    ``mean_var_names``); ``use_global_stats`` forces them (True) or the
    batch's (False) whatever the mode.  The default act is ReLU, as the
    reference's.  ``batch_norm_type`` (the reference's choice of backend)
    changes nothing."""
    if img3D:
        raise NotImplementedError("batch_norm(img3D=True) is not ported yet")
    name = name or gen_name("batch_norm")
    c = num_channels or (input.depth if input.depth > 1 else input.size)
    is_image = bool(input.height and input.width)
    gamma = _wspec(param_attr, name, "w0", (c,), I.constant(1.0))
    beta = _wspec(bias_attr if isinstance(bias_attr, ParamAttr) else None,
                  name, "wbias", (c,), I.constant(0.0))
    stat_names = (tuple(mean_var_names) if mean_var_names
                  else (f"_{name}.w1", f"_{name}.w2"))
    mean_s = StateSpec(stat_names[0], (c,), 0.0)
    var_s = StateSpec(stat_names[1], (c,), 1.0)
    activation = act_mod.get(act) if act is not None else act_mod.ReluActivation()

    def fwd(ctx, params, states, x):
        xr = raw(x)
        if is_image:
            xr = _to_nhwc(xr, c, input.height, input.width)
        training = (ctx.is_train if use_global_stats is None
                    else (not use_global_stats))
        y, nm, nv = nn_ops.batch_norm(
            xr, params[gamma.name], params[beta.name], states[mean_s.name],
            states[var_s.name], is_train=training,
            momentum=moving_average_fraction, eps=epsilon)
        y = activation(y)
        if is_sequence(x) and not is_image:
            y = SequenceBatch(data=y, length=x.length)
        return y, {mean_s.name: nm, var_s.name: nv}

    return _maybe_dropout(LayerOutput(
        name=name, layer_type="batch_norm", size=input.size,
        parents=(input,), param_specs=(gamma, beta),
        state_specs=(mean_s, var_s), fn=fwd, height=input.height,
        width=input.width, depth=input.depth,
        attrs={"channels": c, "epsilon": epsilon,
               "active_type": activation.name,
               "use_global_stats": use_global_stats,
               "moving_average_fraction": moving_average_fraction,
               "img3D": img3D,
               "stat_param_names": (mean_s.name, var_s.name)},
    ), layer_attr)


batch_norm_layer = batch_norm


def img_conv_bn(input: LayerOutput, filter_size, num_filters: int,
                num_channels: int | None = None, stride=1, padding=0,
                act=None, param_attr: ParamAttr | None = None,
                bn_param_attr: ParamAttr | None = None, bn_bias_attr=None,
                epsilon: float = 1e-5, moving_average_fraction: float = 0.9,
                use_global_stats: bool | None = None,
                layer_attr: ExtraAttr | None = None,
                name: str | None = None) -> LayerOutput:
    """Fused conv (no bias) + batch-norm + activation as ONE layer node,
    lowering to ``ops/nn.conv2d_bn_relu`` (the conv kernels with the BN
    epilogue).  Parameters live under ``<name>_conv`` and ``<name>_bn``,
    the moving statistics under ``_<name>_bn.w1`` / ``.w2``."""
    name = name or gen_name("conv_bn")
    kh, kw = nn_ops.pair(filter_size)
    sh, sw = nn_ops.pair(stride)
    ph, pw = nn_ops.pair(padding)
    c_in = num_channels or input.depth
    h_in, w_in = _image_size(input, c_in)
    h_out = nn_ops.conv_out(h_in, kh, sh, ph)
    w_out = nn_ops.conv_out(w_in, kw, sw, pw)
    wspec = _wspec(param_attr, name + "_conv", "w0",
                   (kh, kw, c_in, num_filters), I.msra())
    gamma = _wspec(bn_param_attr, name + "_bn", "w0", (num_filters,),
                   I.constant(1.0))
    beta = _wspec(bn_bias_attr if isinstance(bn_bias_attr, ParamAttr) else None,
                  name + "_bn", "wbias", (num_filters,), I.constant(0.0))
    mean_s = StateSpec(f"_{name}_bn.w1", (num_filters,), 0.0)
    var_s = StateSpec(f"_{name}_bn.w2", (num_filters,), 1.0)
    activation = act_mod.get(act) if act is not None else act_mod.ReluActivation()

    def fwd(ctx, params, states, x):
        xr = _to_nhwc(raw(x), c_in, h_in, w_in)
        training = (ctx.is_train if use_global_stats is None
                    else (not use_global_stats))
        y, nm, nv = nn_ops.conv2d_bn_relu(
            xr, params[wspec.name], params[gamma.name], params[beta.name],
            states[mean_s.name], states[var_s.name], is_train=training,
            momentum=moving_average_fraction, eps=epsilon,
            stride=(sh, sw), padding=(ph, pw),
            act="relu" if activation.name == "relu" else "")
        if activation.name not in ("relu", ""):
            y = activation(y)
        return y, {mean_s.name: nm, var_s.name: nv}

    return _maybe_dropout(LayerOutput(
        name=name, layer_type="conv_bn", size=num_filters * h_out * w_out,
        parents=(input,), param_specs=(wspec, gamma, beta),
        state_specs=(mean_s, var_s), fn=fwd, height=h_out, width=w_out,
        depth=num_filters,
        attrs={"filter_size": [kh, kw], "stride": [sh, sw],
               "padding": [ph, pw], "num_filters": num_filters,
               "channels": c_in, "epsilon": epsilon,
               "moving_average_fraction": moving_average_fraction,
               "active_type": activation.name,
               "stat_param_names": (mean_s.name, var_s.name)},
    ), layer_attr)


def img_cmrnorm(input: LayerOutput, size: int = 5, scale: float = 0.0128,
                power: float = 0.75, num_channels: int | None = None,
                name: str | None = None) -> LayerOutput:
    """≅ img_cmrnorm_layer (CMRProjectionNormLayer): local response
    normalization across channels, ``ops/nn.cross_map_normal`` with the
    reference's ``scale / size`` (config_parser divides alpha by the
    window)."""
    name = name or gen_name("crmnorm")
    c = num_channels or input.depth
    eff_scale = scale / size

    def fwd(ctx, params, states, x):
        xr = _to_nhwc(raw(x), c, input.height, input.width)
        return nn_ops.cross_map_normal(xr, size, eff_scale, power)

    return LayerOutput(
        name=name, layer_type="norm", size=input.size, parents=(input,),
        fn=fwd, height=input.height, width=input.width, depth=input.depth,
        attrs={"size": size, "scale": scale, "power": power},
    )


img_cmrnorm_layer = img_cmrnorm


# ---------------------------------------------------------------------------
# element-wise
# ---------------------------------------------------------------------------


def addto(input, act=None, bias_attr=None, name: str | None = None,
          layer_attr: ExtraAttr | None = None) -> LayerOutput:
    """≅ addto_layer (AddtoLayer): elementwise sum of equal-shaped inputs."""
    inputs = _as_list(input)
    name = name or gen_name("addto")
    activation = act_mod.get(act)
    use_bias = isinstance(bias_attr, ParamAttr) or bias_attr is True
    specs = ()
    if use_bias:
        bspec = _wspec(bias_attr if isinstance(bias_attr, ParamAttr) else None,
                       name, "wbias", (inputs[0].size,), I.constant(0.0))
        specs = (bspec,)

    def fwd(ctx, params, states, *parents):
        y = raw(parents[0])
        for p in parents[1:]:
            y = y + raw(p)
        if use_bias:
            y = y + params[bspec.name]
        return activation(y)

    return _maybe_dropout(LayerOutput(
        name=name, layer_type="addto", size=inputs[0].size,
        parents=tuple(inputs), param_specs=specs, fn=fwd,
        height=inputs[0].height, width=inputs[0].width, depth=inputs[0].depth,
        attrs={"active_type": activation.name},
    ), layer_attr)


addto_layer = addto


def concat(input, act=None, name: str | None = None,
           layer_attr: ExtraAttr | None = None,
           bias_attr=None) -> LayerOutput:
    """≅ concat_layer (ConcatenateLayer): the inputs side by side along
    the feature axis.  Images of one height and width concatenate their
    channels (NHWC); sequences their step features; anything else its
    flattened rows.  The projection form (the reference's
    ConcatenateLayer2, 'concat2') is not ported yet."""
    from paddle_tpu_torch.layers import mixed as mixed_mod

    inputs = _as_list(input)
    if inputs and isinstance(inputs[0], mixed_mod.Projection):
        raise NotImplementedError("concat of projections ('concat2') is not "
                                  "ported yet")
    if bias_attr not in (None, False):
        raise NotImplementedError("concat(bias_attr=...) belongs to the "
                                  "projection form ('concat2'), not ported "
                                  "yet")
    name = name or gen_name("concat")
    activation = act_mod.get(act)
    total = sum(i.size for i in inputs)
    same_image = all(i.height == inputs[0].height
                     and i.width == inputs[0].width and i.height
                     for i in inputs)

    def fwd(ctx, params, states, *parents):
        vals = [raw(p) for p in parents]
        if same_image and all(v.dim() == 4 for v in vals):
            return activation(torch.cat(vals, dim=-1))
        if is_sequence(parents[0]):
            return SequenceBatch(data=activation(torch.cat(vals, dim=-1)),
                                 length=parents[0].length)
        return activation(torch.cat([v.reshape(v.shape[0], -1)
                                     for v in vals], dim=-1))

    return _maybe_dropout(LayerOutput(
        name=name, layer_type="concat", size=total, parents=tuple(inputs),
        fn=fwd, height=inputs[0].height if same_image else 0,
        width=inputs[0].width if same_image else 0,
        depth=sum(i.depth for i in inputs) if same_image else 1,
        attrs={"active_type": activation.name},
    ), layer_attr)


concat_layer = concat


def dropout(input: LayerOutput, dropout_rate: float,
            name: str | None = None) -> LayerOutput:
    """≅ dropout_layer: ``ops/nn.dropout`` in training, with the generator
    of this layer's name (``Context.generator_for``); the identity in
    test mode and at rate 0."""
    name = name or gen_name("dropout")

    def fwd(ctx, params, states, x):
        if not ctx.is_train or dropout_rate <= 0:
            return x
        gen = ctx.generator_for(name, raw(x).device)
        return map_data(lambda d: nn_ops.dropout(d, dropout_rate, gen, True),
                        x)

    return LayerOutput(
        name=name, layer_type="dropout", size=input.size, parents=(input,),
        fn=fwd, height=input.height, width=input.width, depth=input.depth,
        attrs={"dropout_rate": dropout_rate},
    )


dropout_layer = dropout


# ---------------------------------------------------------------------------
# cost layers
# ---------------------------------------------------------------------------


def cross_entropy_cost(input: LayerOutput, label: LayerOutput,
                       name: str | None = None,
                       coeff: float = 1.0) -> LayerOutput:
    """≅ cross_entropy (CostLayer MultiClassCrossEntropy): the batch mean
    of -log(p[label] + 1e-10) over post-softmax ``input``."""
    name = name or gen_name("cross_entropy")

    def fwd(ctx, params, states, probs, lbl):
        ce = loss_ops.cross_entropy(raw(probs), raw(lbl).reshape(-1))
        return coeff * torch.mean(ce)

    return LayerOutput(name=name, layer_type="multi-class-cross-entropy",
                       size=1, parents=(input, label), fn=fwd)


cross_entropy = cross_entropy_cost


def _mean_ce(probs_value, label_value, ce_fn):
    """The mean cross-entropy over the instances: the rows of a dense
    batch, or the valid steps of a sequence batch (padding excluded)."""
    p, y = raw(probs_value), raw(label_value)
    ce = ce_fn(p.reshape(-1, p.shape[-1]), y.reshape(-1))
    seqs = [v for v in (probs_value, label_value) if is_sequence(v)]
    if not seqs:
        return torch.mean(ce)
    m = seqs[0].mask(ce.dtype).reshape(-1)
    return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1e-9)


def classification_cost(input: LayerOutput, label: LayerOutput, weight=None,
                        name: str | None = None, evaluator=None,
                        coeff: float = 1.0) -> LayerOutput:
    """≅ classification_cost: the mean cross-entropy of post-softmax
    ``input`` against integer labels, with the classification-error
    metric attached (``attrs["metric"]``).

    When ``input`` is a softmax fc, the cost is computed from its logits
    (lse(logits) - logits[y]), as the JAX package does: ONE hidden node
    ``<name>#logits`` computes the logits, the probs node is rewired to
    softmax(logits), and the runtime metric reads the logits (argmax-equal
    to the probs) while the serialized metric keeps the reference's
    probs-layer name.  Instance weights (``weight=``) are not ported."""
    if weight is not None:
        raise NotImplementedError("classification_cost(weight=...) is not "
                                  "ported yet")
    name = name or gen_name("cost")
    parents = [input, label]
    logits_fn = input.attrs.get("__fc_logits__")
    if logits_fn is not None:
        logits_node = input.attrs.get("__logits_node__")
        if logits_node is None:
            logits_node = LayerOutput(
                name=name + "#logits", layer_type="fc", size=input.size,
                parents=input.parents, param_specs=input.param_specs,
                state_specs=input.state_specs, fn=logits_fn,
                attrs={"__hidden__": True})
            softmax_act = act_mod.SoftmaxActivation()

            def probs_fn(ctx, params, states, lg):
                return map_data(softmax_act, lg)

            input.attrs["__logits_node__"] = logits_node
            input.parents = (logits_node,)
            input.state_specs = ()
            input.fn = probs_fn
        parents = parents + [logits_node]

        def fwd(ctx, params, states, probs, lbl, logits):
            return coeff * _mean_ce(logits, lbl,
                                    loss_ops.cross_entropy_from_logits)
    else:
        def fwd(ctx, params, states, probs, lbl):
            return coeff * _mean_ce(probs, lbl, loss_ops.cross_entropy)

    node = LayerOutput(name=name, layer_type="multi-class-cross-entropy",
                       size=1, parents=tuple(parents), fn=fwd,
                       attrs={"coeff": coeff})
    node.attrs["metric"] = ("classification_error", [input.name, label.name])
    if logits_fn is not None:
        node.attrs["__emit_parents__"] = 2   # the config shows input, label
        node.attrs["metric_runtime"] = (
            "classification_error", [logits_node.name, label.name])
    node.attrs["v1_cost"] = True
    return node


# ---------------------------------------------------------------------------
# sequence layers
# ---------------------------------------------------------------------------


def _check_non_nested(stride: int, what: str) -> None:
    if stride and stride > 0:
        raise NotImplementedError(f"{what}(stride={stride}) (windowed "
                                  "pooling) is not ported yet")


def last_seq(input: LayerOutput, name: str | None = None,
             agg_level: str = "non-seq", stride: int = -1,
             **kw) -> LayerOutput:
    """≅ last_seq (SequenceLastInstanceLayer): the last valid step of each
    sequence."""
    _check_non_nested(stride, "last_seq")
    name = name or gen_name("last_seq")
    return LayerOutput(name=name, layer_type="seqlastins", size=input.size,
                       parents=(input,),
                       fn=lambda ctx, params, states, x: seq_ops.seq_last(x),
                       attrs={"trans_type": agg_level, "stride": stride})


def first_seq(input: LayerOutput, name: str | None = None,
              agg_level: str = "non-seq", stride: int = -1,
              **kw) -> LayerOutput:
    """≅ first_seq (proto type 'seqlastins' with select_first)."""
    _check_non_nested(stride, "first_seq")
    name = name or gen_name("first_seq")
    return LayerOutput(name=name, layer_type="seqlastins", size=input.size,
                       parents=(input,),
                       fn=lambda ctx, params, states, x: seq_ops.seq_first(x),
                       attrs={"trans_type": agg_level, "stride": stride,
                              "select_first": True})


def lstmemory(input: LayerOutput, reverse: bool = False, act=None,
              gate_act=None, state_act=None, bias_attr=None,
              param_attr: ParamAttr | None = None, name: str | None = None,
              **kw) -> LayerOutput:
    """≅ lstmemory (LstmLayer): input of size 4*D already projected (a
    preceding fc/mixed of size 4*D); output size D.  The bias is ONE [7D]
    parameter: the first 4D are gate biases added to the input, the last
    3D the peepholes [W_ci, W_cf, W_co].  Standard activations run the
    LSTM sequence kernel (``ops/rnn.lstm_fused``), others the plain
    masked scan."""
    name = name or gen_name("lstmemory")
    d = input.size // 4
    wspec = _wspec(param_attr, name, "w0", (d, 4 * d), I.paddle_default())
    specs = [wspec]
    use_bias = bias_attr is not False
    if use_bias:
        bspec = _wspec(bias_attr if isinstance(bias_attr, ParamAttr) else None,
                       name, "wbias", (7 * d,), I.constant(0.0))
        specs.append(bspec)
    oa = act_mod.get(act) if act else act_mod.TanhActivation()
    ga = act_mod.get(gate_act) if gate_act else act_mod.SigmoidActivation()
    sa = act_mod.get(state_act) if state_act else act_mod.TanhActivation()

    def fwd(ctx, params, states, x):
        b, t = x.batch_size, x.max_len
        xw = x.data.reshape(b, t, 4 * d)
        peep = None
        if use_bias:
            full = params[bspec.name]
            xw = xw + full[:4 * d]
            peep = full[4 * d:]
        zeros = torch.zeros(b, d, dtype=xw.dtype, device=xw.device)
        init = rnn_ops.LSTMState(h=zeros, c=zeros)
        if (ga.name, sa.name, oa.name) == ("sigmoid", "tanh", "tanh"):
            out, _ = rnn_ops.lstm_fused(SequenceBatch(xw, x.length),
                                        params[wspec.name], init,
                                        peephole=peep, reverse=reverse)
            return out

        def step(state, xt):
            return rnn_ops.lstm_cell(xt, state, params[wspec.name], ga, sa,
                                     out_act=oa, peephole=peep)

        _, ys = rnn_ops._masked_scan(step, SequenceBatch(xw, x.length), init,
                                     reverse=reverse)
        return SequenceBatch(data=ys.h, length=x.length)

    return LayerOutput(name=name, layer_type="lstmemory", size=d,
                       parents=(input,), param_specs=tuple(specs), fn=fwd,
                       attrs={"reverse": reverse, "reversed_field": True,
                              "active_type": oa.name,
                              "active_gate_type": ga.name,
                              "active_state_type": sa.name})


def _bidir_specs(input, name, suffix, d, gates, inner_bias, param_attr,
                 bias_attr, inner_param_attr, inner_bias_attr):
    """One direction's parameters of ``bilstm`` / ``bigru``: the input
    projection ``_<name>_<suffix>_transform.w0`` [E, gates*D] and its
    ``.wbias``, the recurrent weight ``_<name>_<suffix>.w0`` [D, gates*D]
    and its ``.wbias`` of ``inner_bias`` entries (a bias is left out when
    its attr is False).  Returns (specs, proj_w, proj_b, w, wb)."""
    proj_w = _wspec(param_attr, f"{name}_{suffix}_transform", "w0",
                    (input.size, gates * d), I.xavier())
    specs = [proj_w]
    proj_b = wb = None
    if bias_attr is not False:
        proj_b = _wspec(bias_attr if isinstance(bias_attr, ParamAttr)
                        else None, f"{name}_{suffix}_transform", "wbias",
                        (gates * d,), I.constant(0.0))
        specs.append(proj_b)
    w = _wspec(inner_param_attr, f"{name}_{suffix}", "w0", (d, gates * d),
               I.paddle_default())
    specs.append(w)
    if inner_bias_attr is not False:
        wb = _wspec(inner_bias_attr if isinstance(inner_bias_attr, ParamAttr)
                    else None, f"{name}_{suffix}", "wbias", (inner_bias,),
                    I.constant(0.0))
        specs.append(wb)
    return specs, proj_w, proj_b, w, wb


def bilstm(input: LayerOutput, size: int, name: str | None = None,
           param_attr: ParamAttr | None = None, bias_attr=None,
           inner_param_attr: ParamAttr | None = None,
           inner_bias_attr=None) -> LayerOutput:
    """Bidirectional LSTM, input projections included, as ONE layer node
    lowering to ``ops/rnn.bilstm_fused`` (one kernel launch for both
    directions on the card, the unfused composition on the CPU).

    Parameter names mirror the composed ``networks.bidirectional_lstm``
    form: ``<name>_fw_transform.w0`` / ``.wbias`` (the 4*size input
    projection) and ``<name>_fw.w0`` / ``.wbias`` (the recurrent weight and
    the reference's 7*size gate-bias + peephole bundle), the same for
    ``_bw``.  The output is the [fw, bw] feature concat (size 2*size)."""
    name = name or gen_name("bilstm")
    d = size
    fw_specs, fw_pw, fw_pb, fw_w, fw_wb = _bidir_specs(
        input, name, "fw", d, 4, 7 * d, param_attr, bias_attr,
        inner_param_attr, inner_bias_attr)
    bw_specs, bw_pw, bw_pb, bw_w, bw_wb = _bidir_specs(
        input, name, "bw", d, 4, 7 * d, param_attr, bias_attr,
        inner_param_attr, inner_bias_attr)

    def fwd(ctx, params, states, x):
        def bundle(proj_w, proj_b, w, wb):
            bias = params[proj_b.name] if proj_b is not None else None
            peep = None
            if wb is not None:
                full = params[wb.name]
                gate_b = full[:4 * d]
                bias = gate_b if bias is None else bias + gate_b
                peep = full[4 * d:]
            return (params[proj_w.name], bias, params[w.name], peep)

        return rnn_ops.bilstm_fused(x, bundle(fw_pw, fw_pb, fw_w, fw_wb),
                                    bundle(bw_pw, bw_pb, bw_w, bw_wb))

    return LayerOutput(name=name, layer_type="bilstm", size=2 * d,
                       parents=(input,),
                       param_specs=tuple(fw_specs + bw_specs), fn=fwd,
                       attrs={"reversed_field": True})


def slice(input: LayerOutput, start: int, end: int,
          name: str | None = None) -> LayerOutput:
    """≅ slice: feature columns [start, end) of every step."""
    name = name or gen_name("slice")

    def fwd(ctx, params, states, x):
        return map_data(lambda d: d[..., start:end], x)

    return LayerOutput(name=name, layer_type="slice", size=end - start,
                       parents=(input,), fn=fwd,
                       attrs={"start": start, "end": end})


def grumemory(input: LayerOutput, reverse: bool = False, act=None,
              gate_act=None, bias_attr=None,
              param_attr: ParamAttr | None = None, name: str | None = None,
              **kw) -> LayerOutput:
    """≅ grumemory (GruLayer): input of size 3*D already projected (a
    preceding fc/mixed of size 3*D); output size D.  One recurrent weight
    [D, 3D] as the reference's GruLayer parameter: [:, :2D] the update and
    reset gates, [:, 2D:] the candidate; the [3D] bias is added to the
    input.  Standard activations run the GRU sequence kernel
    (``ops/rnn.gru_fused``), others the plain masked scan."""
    name = name or gen_name("gru")
    d = input.size // 3
    wspec = _wspec(param_attr, name, "w0", (d, 3 * d), I.paddle_default())
    specs = [wspec]
    use_bias = bias_attr is not False
    if use_bias:
        bspec = _wspec(bias_attr if isinstance(bias_attr, ParamAttr) else None,
                       name, "wbias", (3 * d,), I.constant(0.0))
        specs.append(bspec)
    ga = act_mod.get(gate_act) if gate_act else act_mod.SigmoidActivation()
    sa = act_mod.get(act) if act else act_mod.TanhActivation()

    def fwd(ctx, params, states, x):
        b, t = x.batch_size, x.max_len
        xw = x.data.reshape(b, t, 3 * d)
        if use_bias:
            xw = xw + params[bspec.name]
        init = torch.zeros(b, d, dtype=xw.dtype, device=xw.device)
        w = params[wspec.name]
        if (ga.name, sa.name) == ("sigmoid", "tanh"):
            out, _ = rnn_ops.gru_fused(SequenceBatch(xw, x.length),
                                       w[:, :2 * d], w[:, 2 * d:], init,
                                       reverse=reverse)
            return out

        def step(h, xt):
            return rnn_ops.gru_cell(xt, h, w[:, :2 * d], w[:, 2 * d:], ga, sa)

        _, ys = rnn_ops._masked_scan(step, SequenceBatch(xw, x.length), init,
                                     reverse=reverse)
        return SequenceBatch(data=ys, length=x.length)

    return LayerOutput(name=name, layer_type="gated_recurrent", size=d,
                       parents=(input,), param_specs=tuple(specs), fn=fwd,
                       attrs={"reverse": reverse, "reversed_field": True,
                              "active_type": sa.name,
                              "active_gate_type": ga.name})


def bigru(input: LayerOutput, size: int, name: str | None = None,
          param_attr: ParamAttr | None = None, bias_attr=None,
          inner_param_attr: ParamAttr | None = None,
          inner_bias_attr=None) -> LayerOutput:
    """Bidirectional GRU, input projections included, as ONE layer node
    lowering to ``ops/rnn.bigru_fused`` (one kernel launch for both
    directions on the card, the unfused composition on the CPU).

    Parameter names mirror the composed ``networks.simple_gru2`` form:
    ``<name>_fw_transform.w0`` / ``.wbias`` (the 3*size input projection)
    and ``<name>_fw.w0`` / ``.wbias`` (the grumemory-convention [D, 3D]
    recurrent weight, [:, :2D] gates and [:, 2D:] candidate, and the
    3*size gate bias), the same for ``_bw``.  The output is the [fw, bw]
    feature concat (size 2*size)."""
    name = name or gen_name("bigru")
    d = size
    fw_specs, fw_pw, fw_pb, fw_w, fw_wb = _bidir_specs(
        input, name, "fw", d, 3, 3 * d, param_attr, bias_attr,
        inner_param_attr, inner_bias_attr)
    bw_specs, bw_pw, bw_pb, bw_w, bw_wb = _bidir_specs(
        input, name, "bw", d, 3, 3 * d, param_attr, bias_attr,
        inner_param_attr, inner_bias_attr)

    def fwd(ctx, params, states, x):
        def bundle(proj_w, proj_b, w, wb):
            bias = params[proj_b.name] if proj_b is not None else None
            if wb is not None:
                gate_b = params[wb.name]
                bias = gate_b if bias is None else bias + gate_b
            full = params[w.name]
            return (params[proj_w.name], bias, full[:, :2 * d],
                    full[:, 2 * d:])

        return rnn_ops.bigru_fused(x, bundle(fw_pw, fw_pb, fw_w, fw_wb),
                                   bundle(bw_pw, bw_pb, bw_w, bw_wb))

    return LayerOutput(name=name, layer_type="bigru", size=2 * d,
                       parents=(input,),
                       param_specs=tuple(fw_specs + bw_specs), fn=fwd,
                       attrs={"reversed_field": True})
