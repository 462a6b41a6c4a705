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
``brgemm.brgemm_reference``); CUDA tensors launch the kernels or raise.

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
TF32 off by ``core/dtype.set_f32_policy``) on NCHW views of the NHWC
tensors: the JAX package leaves exactly this transpose to XLA."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops import nn as nn_ops
from paddle_tpu_torch.ops.kernels import brgemm as kbr
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("conv2d_direct", "conv2d_direct_f32",
                [_P, _P, _P] + [_I] * 13 + [_P, _P, _I, _P, _P, _P, _P])


# -- forward: one launch with a fused epilogue ---------------------------------


def fwd_raw_reference(x, w, strides, pads, scale=None, shift=None, act=None,
                      stats=False):
    """Plain twin of the fused forward: the plain conv, then the epilogue
    (and the per-channel sum/sumsq of the raw conv output)."""
    acc = nn_ops.conv2d_xla(x, w, strides, pads)
    y = kbr.epilogue(acc, scale, shift, act)
    if not stats:
        return y
    dims = (0, 1, 2)
    return y, acc.sum(dim=dims), (acc * acc).sum(dim=dims)


def _direct_kernel(x, w, strides, pads, scale, shift, act, stats):
    enforce(x.device.type == "cuda", f"no kernel for device {x.device}")
    tensors = [x, w] + ([scale, shift] if scale is not None else [])
    enforce(all(t.dtype == torch.float32 for t in tensors),
            "the direct conv kernel takes float32 operands")
    enforce(all(t.is_contiguous() for t in tensors),
            "the direct conv kernel needs contiguous operands")
    enforce(len({t.device for t in tensors}) == 1,
            f"operands on several devices: {[t.device for t in tensors]}")
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    (sh, sw), (ph, pw) = strides, pads
    oh, ow = nn_ops.conv_out(h, kh, sh, ph), nn_ops.conv_out(wd, kw, sw, pw)
    enforce(min(n, oh, ow, cin, cout) > 0, "the direct conv kernel takes "
            f"non-empty shapes, got x {tuple(x.shape)} w {tuple(w.shape)}")
    out = kbr.launch_gemm(KERNEL, x.device, n * oh * ow, cout, stats, scale,
                          shift, act, x.data_ptr(), w.data_ptr(), n, h, wd,
                          cin, kh, kw, cout, oh, ow, sh, sw, ph, pw)
    if stats:
        return out[0].reshape(n, oh, ow, cout), out[1], out[2]
    return out.reshape(n, oh, ow, cout)


def fwd_raw(x, w, strides, pads, scale=None, shift=None, act=None,
            stats=False):
    """The fused conv forward, no autograd: y [N, OH, OW, Cout] (and
    (sum, sumsq) of the raw conv output when ``stats``).  1x1 convs
    without padding take the BRGEMM kernel, the rest the direct kernel;
    CPU tensors take the plain twins."""
    kbr.check_epilogue(scale, shift, act)
    enforce(x.dim() == 4 and w.dim() == 4 and w.shape[2] == x.shape[3],
            f"conv needs x [N, H, W, Cin] and w [KH, KW, Cin, Cout], got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if tuple(w.shape[:2]) == (1, 1) and tuple(pads) == (0, 0):
        return kbr.conv1x1(x.contiguous(), w.contiguous(), strides, scale,
                           shift, act, stats)
    if x.device.type == "cpu":
        return fwd_raw_reference(x, w, strides, pads, scale, shift, act,
                                 stats)
    return _direct_kernel(x.contiguous(), w.contiguous(), strides, pads,
                          scale, shift, act, stats)


# -- backward helpers ------------------------------------------------------------


def conv_input_grads(x, w, dy, strides, pads, needed=(True, True)):
    """(dx [N, H, W, Cin], dw [KH, KW, Cin, Cout]) of the convolution at
    (x, w) for the output cotangent dy: the exact adjoint, no forward
    recompute.  A grad not ``needed`` (e.g. dx of the data input) is None
    and not computed."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
        None, list(strides), list(pads), [1, 1], False, [0, 0], 1,
        [bool(needed[0]), bool(needed[1]), False])
    return (dx.permute(0, 2, 3, 1).contiguous() if needed[0] else None,
            dw.permute(2, 3, 1, 0).contiguous() if needed[1] else None)


def bn_apply(y_conv, mean, var, gamma, beta, eps, act):
    inv = torch.rsqrt(var + eps) * gamma
    shift = beta - mean * inv
    y = y_conv * inv + shift
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
