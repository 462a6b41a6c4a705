"""Direct convolution and the fused conv + batch-norm + activation (the
port of ``paddle_tpu/ops/pallas/tpp/conv.py``'s ``conv2d_direct`` and
``conv2d_bn_act``).

The forward of every convolution is one kernel launch with a fused
epilogue (:func:`fwd_raw`): 1x1 convolutions without padding go to the
BRGEMM kernel (``brgemm.conv1x1``), every other shape to the implicit-GEMM
direct kernel ``csrc/conv2d_direct.cu``.  The epilogue is none, the
per-channel sum/sum-of-squares of the raw conv output (training-mode BN
statistics from the same pass), or affine + ReLU (inference-mode BN folded
into the store).  CPU tensors take the plain twins (:func:`fwd_raw_reference`,
``brgemm.brgemm_reference``); CUDA tensors launch the kernels or raise: the
f32 forms on f32 operands, the bf16 forms (f32 accumulators, stats and
epilogue, y in bf16) on bf16 ones: the Hopper tile (``KERNEL_WGMMA``,
``brgemm.KERNEL_WGMMA``) where Cin and Cout are multiples of 8 and the
operands aligned, the mma.sync tile (``KERNEL_BF16``,
``brgemm.KERNEL_BF16``) otherwise.  Mixed operands resolve by
``core/dtype.cast_for_matmul`` and y takes x's dtype, as in the JAX
package.

Backward never re-derives conv math in a kernel: ``torch.autograd.Function``
wrappers take the exact adjoints of the reference composition, as the
JAX package's ``custom_vjp`` entries do.

- :class:`_Direct` saves x, w; backward is the transposed convolution.
- :class:`_CbrTrain` saves x, w, gamma, beta and the raw conv output.  Its
  forward normalizes with the kernel's statistics; its backward is the
  vjp of the plain train-mode BN(+ReLU) at the saved conv output (autograd
  over :func:`bn_act_train`), then the conv grads.  The conv is not re-run.
- :class:`_CbrEval` runs affine + ReLU in the epilogue; its rare backward
  (the trainer never differentiates inference) recomputes the raw conv.

The conv grads are ``aten.convolution_backward`` (cuDNN on the card, with
TF32 off by ``core/dtype.set_policy``) on NCHW views of the NHWC
tensors: the JAX package leaves exactly this transpose to XLA."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.dtype import at_least_f32, cast_for_matmul
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops import nn as nn_ops
from paddle_tpu_torch.ops.kernels import brgemm as kbr
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int


class ConvParams(ctypes.Structure):
    """The launch's parameter block: ``struct ConvParams`` of
    ``csrc/conv2d_direct.cu``, field for field."""
    _fields_ = ([(f, _P) for f in ("x", "wt", "y", "ws", "scale", "shift",
                                   "partial", "sum", "sumsq")]
                + [(f, _I) for f in ("n", "h", "w", "cin", "kh", "kw",
                                     "cout", "oh", "ow", "sh", "sw", "ph",
                                     "pw", "block_m", "block_n", "vec",
                                     "splits", "relu")])


KERNEL = Kernel("conv2d_direct", "conv2d_direct_f32", kbr.ENTRY_ARGS)
KERNEL_BF16 = Kernel("conv2d_direct", "conv2d_direct_bf16", kbr.ENTRY_ARGS)
KERNEL_WGMMA = Kernel("conv2d_direct", "conv2d_direct_wgmma",
                      kbr.ENTRY_ARGS)
CONV = kbr.Entries(KERNEL, KERNEL_BF16, KERNEL_WGMMA, ConvParams)


# -- forward: one launch with a fused epilogue ---------------------------------


def fwd_raw_reference(x, w, strides, pads, scale=None, shift=None, act=None,
                      stats=False):
    """Plain twin of the fused forward: the plain conv accumulated in f32
    (bf16 operands upcast: their products are exact there), then the
    epilogue, y rounded once to x's dtype (and the per-channel sum/sumsq
    of the raw f32 conv output)."""
    acc = nn_ops.conv2d_xla(at_least_f32(x), at_least_f32(w), strides, pads)
    y = kbr.epilogue(acc, scale, shift, act).to(x.dtype)
    if not stats:
        return y
    dims = (0, 1, 2)
    return y, acc.sum(dim=dims), (acc * acc).sum(dim=dims)


def direct_plan(x, w, m, sms):
    """The shared tile's plan for the direct conv of x [N, H, W, Cin] by w
    [KH, KW, Cin, Cout] with M output pixels on a card of ``sms`` SMs: the
    reduction is KH * KW * Cin long and its contiguous run Cin (one tap's
    channels); the form is x's dtype's."""
    kh, kw, cin, cout = w.shape
    return kbr.plan(m, cout, kh * kw * cin, cin,
                    (x.data_ptr(), w.data_ptr()), sms, kbr.FORMS[x.dtype])


def _direct_kernel(x, w, strides, pads, scale, shift, act, stats):
    kbr.check_operands("direct conv", x, w, scale, shift)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    (sh, sw), (ph, pw) = strides, pads
    oh, ow = nn_ops.conv_out(h, kh, sh, ph), nn_ops.conv_out(wd, kw, sw, pw)
    enforce(min(n, oh, ow, cin, cout) > 0, "the direct conv kernel takes "
            "non-empty shapes, got x %s w %s", tuple(x.shape), tuple(w.shape))
    dev = x.device
    p = direct_plan(x, w, n * oh * ow, kbr.sm_count(dev))
    return kbr.launch_gemm(CONV, dev, x.dtype, (n, oh, ow, cout), p, stats,
                           scale, shift, act, x.data_ptr(), w.data_ptr(),
                           (n, h, wd, cin, kh, kw, cout, oh, ow, sh, sw, ph,
                            pw))


def fwd_raw(x, w, strides, pads, scale=None, shift=None, act=None,
            stats=False):
    """The fused conv forward, no autograd: y [N, OH, OW, Cout] in x's
    dtype (and (sum, sumsq) of the raw f32 conv output when ``stats``).
    1x1 convs without padding take the BRGEMM kernel, the rest the direct
    kernel; CPU tensors take the plain twins."""
    kbr.check_epilogue(scale, shift, act)
    enforce(x.dim() == 4 and w.dim() == 4 and w.shape[2] == x.shape[3],
            "conv needs x [N, H, W, Cin] and w [KH, KW, Cin, Cout], got "
            "%s and %s", tuple(x.shape), tuple(w.shape))
    out_dtype = x.dtype
    x, w = cast_for_matmul(x, w)
    if tuple(w.shape[:2]) == (1, 1) and tuple(pads) == (0, 0):
        out = kbr.conv1x1(x.contiguous(), w.contiguous(), strides, scale,
                          shift, act, stats)
    elif x.device.type == "cpu":
        out = fwd_raw_reference(x, w, strides, pads, scale, shift, act,
                                stats)
    else:
        out = _direct_kernel(x.contiguous(), w.contiguous(), strides, pads,
                             scale, shift, act, stats)
    y = out[0] if stats else out
    if y.dtype != out_dtype:    # a no-op .to still costs a dispatch a call
        y = y.to(out_dtype)
    return (y, *out[1:]) if stats else y


# -- backward helpers ------------------------------------------------------------


def conv_input_grads(x, w, dy, strides, pads, needed=(True, True)):
    """(dx [N, H, W, Cin], dw [KH, KW, Cin, Cout]) of the convolution at
    (x, w) for the output cotangent dy: the exact adjoint, no forward
    recompute, in the operands' common dtype (``cast_for_matmul``; dy cast
    to it), dx in x's dtype and dw in w's, as the JAX package's
    ``_conv_input_grads``.  A grad not ``needed`` (e.g. dx of the data
    input) is None and not computed."""
    xc, wc = cast_for_matmul(x, w)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.to(xc.dtype).permute(0, 3, 1, 2), xc.permute(0, 3, 1, 2),
        wc.permute(3, 2, 0, 1), None, list(strides), list(pads), [1, 1],
        False, [0, 0], 1, [bool(needed[0]), bool(needed[1]), False])
    return (dx.permute(0, 2, 3, 1).contiguous().to(x.dtype)
            if needed[0] else None,
            dw.permute(2, 3, 1, 0).contiguous().to(w.dtype)
            if needed[1] else None)


def bn_apply(y_conv, mean, var, gamma, beta, eps, act):
    """The normalize in the activation's dtype: inv and shift from the f32
    moments, cast to y_conv's dtype (``tpp/conv.py`` ``_bn_apply``)."""
    inv = torch.rsqrt(var + eps) * gamma
    shift = beta - mean * inv
    y = y_conv * inv.to(y_conv.dtype) + shift.to(y_conv.dtype)
    return torch.relu(y) if act == "relu" else y


def bn_act_train(y_conv, gamma, beta, eps, act):
    """Plain train-mode BN(+act) on a conv output, the exact math of
    ``ops/nn.batch_norm``: the vjp target of :class:`_CbrTrain`."""
    mean, var = nn_ops.moments(y_conv)
    return bn_apply(y_conv, mean, var, gamma, beta, eps, act)


# -- autograd -------------------------------------------------------------------


class _Direct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, strides, pads):
        ctx.save_for_backward(x, w)
        ctx.cfg = (strides, pads)
        return fwd_raw(x, w, strides, pads)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = conv_input_grads(x, w, dy, *ctx.cfg,
                                  ctx.needs_input_grad[:2])
        return dx, dw, None, None


class _CbrTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, strides, pads, eps, act):
        y_conv, s, ss = fwd_raw(x, w, strides, pads, stats=True)
        count = y_conv.numel() // y_conv.shape[-1]
        mean = s / count
        var = torch.clamp(ss / count - mean * mean, min=0.0)
        y = bn_apply(y_conv, mean, var, gamma, beta, eps, act)
        ctx.save_for_backward(x, w, gamma, beta, y_conv)
        ctx.cfg = (strides, pads, eps, act)
        # the batch moments only feed the running statistics
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, gamma, beta, y_conv = ctx.saved_tensors
        strides, pads, eps, act = ctx.cfg
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (y_conv, gamma, beta)]
            y = bn_act_train(*leaves, eps, act)
            dyc, dga, dbe = torch.autograd.grad(y, leaves, dy)
        dx, dw = conv_input_grads(x, w, dyc, strides, pads,
                                  ctx.needs_input_grad[:2])
        return dx, dw, dga, dbe, None, None, None, None


class _CbrEval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, inv, shift, strides, pads, act):
        ctx.save_for_backward(x, w, inv, shift)
        ctx.cfg = (strides, pads, act)
        return fwd_raw(x, w, strides, pads, inv, shift, act)

    @staticmethod
    def backward(ctx, dy):
        x, w, inv, shift = ctx.saved_tensors
        strides, pads, act = ctx.cfg
        y_conv = fwd_raw(x, w, strides, pads)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (y_conv, inv, shift)]
            y = kbr.epilogue(*leaves, act)
            dyc, dinv, dshift = torch.autograd.grad(y, leaves, dy)
        dx, dw = conv_input_grads(x, w, dyc, strides, pads,
                                  ctx.needs_input_grad[:2])
        return dx, dw, dinv, dshift, None, None, None


# -- entry points ------------------------------------------------------------------


def conv2d_direct(x, w, stride=1, padding=0):
    """Direct (im2col-free) 2-D convolution, NHWC / HWIO, groups=1,
    dilation=1.  Differentiable: backward is the transposed conv."""
    return _Direct.apply(x, w, nn_ops.pair(stride), nn_ops.pair(padding))


def conv2d_bn_act_reference(x, w, scale, bias, running_mean, running_var,
                            is_train, momentum=0.9, eps=1e-5, stride=1,
                            padding=0, act="relu"):
    """The unfused composition (plain conv -> ``ops/nn.batch_norm`` ->
    act): the oracle of :func:`conv2d_bn_act`.  Returns (y,
    new_running_mean, new_running_var)."""
    y = nn_ops.conv2d_xla(x, w, nn_ops.pair(stride), nn_ops.pair(padding))
    y, nm, nv = nn_ops.batch_norm(y, scale, bias, running_mean, running_var,
                                  is_train, momentum=momentum, eps=eps,
                                  use_fused_stats=False)
    return (torch.relu(y) if act == "relu" else y), nm, nv


def conv2d_bn_act(x, w, scale, bias, running_mean, running_var, is_train,
                  momentum=0.9, eps=1e-5, stride=1, padding=0, act="relu"):
    """Fused conv + batch-norm + activation, NHWC.  Training takes the BN
    statistics from the conv epilogue (one pass over the conv output);
    inference folds the affine + ReLU into it (one pass, one write).
    Returns ``(y, new_running_mean, new_running_var)`` like
    ``ops/nn.batch_norm``."""
    if act not in ("relu", None, ""):
        raise ValueError(f"conv2d_bn_act fuses act None or 'relu', "
                         f"got {act!r}")
    act = act or None
    strides, pads = nn_ops.pair(stride), nn_ops.pair(padding)
    if is_train:
        y, mean, var = _CbrTrain.apply(x, w, scale, bias, strides, pads, eps,
                                       act)
        new_mean = momentum * running_mean + (1 - momentum) * mean
        new_var = momentum * running_var + (1 - momentum) * var
        return y, new_mean, new_var
    inv = torch.rsqrt(running_var + eps) * scale
    shift = bias - running_mean * inv
    y = _CbrEval.apply(x, w, inv, shift, strides, pads, act)
    return y, running_mean, running_var
