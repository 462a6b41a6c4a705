"""The ``paddle.layer`` surface of the port — the v2 layer constructors of
the image path, ported from ``paddle_tpu/layers/api.py`` with the same
names, ``attrs``, parameter and state names, so a parameter dict moves
between the packages by name and ``Topology.serialize()`` agrees byte for
byte.

Each constructor returns a :class:`LayerOutput` node whose forward is a
function of torch tensors.  Images are NHWC inside; v2 data layers feed
flat CHW rows, which image layers reshape on entry (:func:`_to_nhwc`)."""

from __future__ import annotations

import math as _pymath
from typing import Sequence

import torch
import torch.nn.functional as F

from paddle_tpu_torch.config import parse_state
from paddle_tpu_torch.core import initializer as I
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.parameters import ParamSpec
from paddle_tpu_torch.layers import activation as act_mod
from paddle_tpu_torch.layers import pooling as pool_mod
from paddle_tpu_torch.layers.attr import ExtraAttr, ParamAttr, param_attr_or_default
from paddle_tpu_torch.layers.base import Context, LayerOutput, StateSpec, gen_name, raw
from paddle_tpu_torch.layers.data_type import InputType
from paddle_tpu_torch.ops import loss as loss_ops
from paddle_tpu_torch.ops import math as math_ops
from paddle_tpu_torch.ops import nn as nn_ops


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
    if layer_attr is None:
        return
    if layer_attr.drop_rate:
        raise NotImplementedError("ExtraAttr(drop_rate=...) (dropout) is "
                                  "not ported yet")
    if layer_attr.error_clipping_threshold:
        raise NotImplementedError("ExtraAttr(error_clipping_threshold=...) "
                                  "is not ported yet")


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
    does, so carried weights mean the same."""
    _check_layer_attr(layer_attr)
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

    def fwd(ctx: Context, params, states, *parents):
        y = None
        for i, p in enumerate(parents):
            x = raw(p)
            x2 = x.reshape(x.shape[0], -1) if x.dim() > 2 else x
            t = math_ops.matmul(x2, params[specs[i].name])
            y = t if y is None else y + t
        if use_bias:
            y = y + params[bspec.name]
        return activation(y)

    return LayerOutput(
        name=name, layer_type="fc", size=size, parents=tuple(inputs),
        param_specs=tuple(specs), fn=fwd,
        attrs={"size": size, "active_type": activation.name,
               "bias_spec": bspec.name if use_bias else None},
    )


fc_layer = fc


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
    _check_layer_attr(layer_attr)
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

    return LayerOutput(
        name=name, layer_type="exconv", size=num_filters * h_out * w_out,
        parents=(input,), param_specs=tuple(specs), fn=fwd, height=h_out,
        width=w_out, depth=num_filters,
        attrs={"filter_size": [kh, kw], "stride": [sh, sw],
               "padding": [ph, pw], "num_filters": num_filters,
               "groups": groups, "trans": trans, "channels": c_in,
               "active_type": activation.name},
    )


img_conv_layer = img_conv


def img_pool(input: LayerOutput, pool_size, num_channels: int | None = None,
             pool_type=None, stride=1, padding=0,
             layer_attr: ExtraAttr | None = None, name: str | None = None,
             ceil_mode: bool = True) -> LayerOutput:
    """≅ img_pool_layer; the reference default is ceil mode.  Ceil mode is
    an explicit extra right/bottom pad (-inf for max, zeros for average),
    and average pooling divides by the count of real cells in each window
    — not ``F.max_pool2d(ceil_mode=True)``, whose edge windows differ."""
    _check_layer_attr(layer_attr)
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

    return LayerOutput(
        name=name, layer_type="pool", size=c * h_out * w_out,
        parents=(input,), fn=fwd, height=h_out, width=w_out, depth=c,
        attrs={"pool_type": ptype, "pool_size": [kh, kw],
               "stride": [sh, sw], "padding": [ph, pw], "channels": c,
               "ceil_mode": ceil_mode},
    )


img_pool_layer = img_pool


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
    _check_layer_attr(layer_attr)
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

    return LayerOutput(
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
    )


# ---------------------------------------------------------------------------
# element-wise
# ---------------------------------------------------------------------------


def addto(input, act=None, bias_attr=None, name: str | None = None,
          layer_attr: ExtraAttr | None = None) -> LayerOutput:
    """≅ addto_layer (AddtoLayer): elementwise sum of equal-shaped inputs."""
    _check_layer_attr(layer_attr)
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

    return LayerOutput(
        name=name, layer_type="addto", size=inputs[0].size,
        parents=tuple(inputs), param_specs=specs, fn=fwd,
        height=inputs[0].height, width=inputs[0].width, depth=inputs[0].depth,
        attrs={"active_type": activation.name},
    )


addto_layer = addto


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
