"""NN primitives of the port (the port's side of ``paddle_tpu/ops/nn.py``):
the transformer block's LN and GELU, and the image path's convolution,
pooling, batch norm, local response normalization and dropout.

Layout as in the JAX package: NHWC activations, HWIO conv weights.
PyTorch's own conv and pool functions take NCHW, so they run on permuted
views; a permuted view of a contiguous NHWC tensor is channels_last, and
results are permuted back to NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtype import at_least_f32


def pair(v):
    """An int or an (h, w) sequence as an (h, w) tuple."""
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def conv_out(size: int, k: int, s: int, p: int) -> int:
    """Output extent of a convolution or pooling window along one axis."""
    return (size + 2 * p - k) // s + 1


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Single-pass LN, the same form as ``paddle_tpu.ops.nn.layer_norm``:
    one f32 upcast (none for a wider input), var = E[x^2] - E[x]^2 clamped
    at 0 (f32 rounding can leave it slightly negative for a constant row
    with a large mean).  ``F.layer_norm`` computes the variance in two
    passes and rounds differently, so it is not used."""
    xf = at_least_f32(x)
    mean = xf.mean(dim=-1, keepdim=True)
    msq = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(msq - mean * mean, min=0.0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation.  PyTorch's
    default (erf) differs by about 1e-3, enough to flip greedy tokens."""
    return F.gelu(x, approximate="tanh")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _takes_kernel(x) -> bool:
    """Whether a router sends ``x`` to a kernel: a tensor on the card,
    unless it is float64 (the double-precision witness step, which runs
    the plain twins on any device; the kernels take float32 and refuse
    the rest)."""
    return x.device.type == "cuda" and x.dtype != torch.float64


def conv2d(x, w, stride=1, padding=0, dilation=1, groups: int = 1):
    """2-D convolution, x [N, H, W, Cin], w [KH, KW, Cin // groups, Cout].

    CUDA tensors of the direct kernel's shape class (groups=1,
    dilation=1, numeric padding; the routing rule of the JAX package's
    ``conv2d``) launch the hand-written kernel through
    ``ops/kernels/conv.conv2d_direct``; everything else (and a float64
    witness) takes the plain :func:`conv2d_xla`."""
    if (_takes_kernel(x) and groups == 1
            and pair(dilation) == (1, 1) and not isinstance(padding, str)
            and x.dim() == 4):
        from paddle_tpu_torch.ops.kernels import conv as kconv

        return kconv.conv2d_direct(x, w, stride=stride, padding=padding)
    return conv2d_xla(x, w, stride=stride, padding=padding,
                      dilation=dilation, groups=groups)


def conv2d_xla(x, w, stride=1, padding=0, dilation=1, groups: int = 1):
    """The plain convolution (``F.conv2d`` on NCHW views), named after the
    JAX package's XLA lowering it stands for: the reference numerics the
    kernel paths are held against."""
    pad = padding if isinstance(padding, str) else pair(padding)
    y = F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), None, pair(stride), pad,
                 pair(dilation), groups)
    return _nhwc(y)


def max_pool2d(x, ksize, stride=None, padding=0):
    """Max pooling over NHWC windows; padded cells are -inf."""
    kh, kw = pair(ksize)
    sh, sw = pair(stride if stride is not None else ksize)
    ph, pw = pair(padding)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph), value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), (kh, kw), (sh, sw)))


def avg_pool2d(x, ksize, stride=None, padding=0, exclude_pad: bool = True):
    """Average pooling; ``exclude_pad`` divides border windows by their
    count of real cells (the reference's CudnnPool EXCLUDE_PADDING)."""
    kh, kw = pair(ksize)
    sh, sw = pair(stride if stride is not None else ksize)
    ph, pw = pair(padding)

    def window_mean(v):  # zero padding counted in the divisor
        if ph or pw:
            v = F.pad(v, (0, 0, pw, pw, ph, ph))
        return _nhwc(F.avg_pool2d(_nchw(v), (kh, kw), (sh, sw)))

    mean = window_mean(x)
    if exclude_pad and (ph or pw):
        return mean / window_mean(torch.ones_like(x[..., :1]))
    return mean


def batch_norm(x, scale, bias, running_mean, running_var, is_train: bool,
               momentum: float = 0.9, eps: float = 1e-5,
               use_fused_stats: bool | None = None):
    """Batch normalization over all but the last (channel) axis; returns
    (y, new_running_mean, new_running_var).

    The JAX package's convention, not ``F.batch_norm``'s: single-pass
    E[x] and E[x^2] in f32, the variance clamped at 0 and BIASED (divided
    by the count), and ``new = momentum * running + (1 - momentum) *
    batch``.

    ``use_fused_stats`` picks how the train-mode moments are taken: True
    through ``ops/kernels/channel_stats`` (one read for both sums; the
    kernel on the card, its twin on the CPU), False through
    :func:`moments`, and None (the default) through the kernel exactly
    when ``x`` lies on the card in float32 (a float64 witness takes
    :func:`moments` there too)."""
    if is_train:
        if use_fused_stats is None:
            use_fused_stats = _takes_kernel(x)
        if use_fused_stats:
            from paddle_tpu_torch.ops.kernels import channel_stats as kcs

            s, ss = kcs.channel_stats(x)
            count = x.numel() // x.shape[-1]
            mean = s / count
            var = torch.clamp(ss / count - mean * mean, min=0.0)
        else:
            mean, var = moments(x)
        new_mean = momentum * running_mean + (1 - momentum) * mean
        new_var = momentum * running_var + (1 - momentum) * var
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps) * scale
    shift = bias - mean * inv
    return x * inv + shift, new_mean, new_var


def moments(x):
    """(mean, biased variance) over all but the last axis: single-pass,
    f32, the variance clamped at 0 (E[x^2] - E[x]^2 can round negative)."""
    dims = tuple(range(x.dim() - 1))
    xf = at_least_f32(x)
    mean = xf.mean(dim=dims)
    var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
    return mean, var


def cross_map_normal(x, size: int = 5, scale: float = 1e-4,
                     pow_: float = 0.75):
    """Local response normalization across channels, NHWC (the JAX
    package's ``cross_map_normal``, ≅ CMRProjectionNormLayer):
    ``x / (1 + scale * sum of x^2 over a window of size channels)^pow``,
    the window from c - size // 2 to c + (size - 1 - size // 2)."""
    half = size // 2
    padded = F.pad(x * x, (half, size - 1 - half))
    c = x.shape[-1]
    window = sum(padded[..., i:i + c] for i in range(size))
    return x / torch.pow(1.0 + scale * window, pow_)


def dropout(x, rate: float, generator: torch.Generator | None,
            is_train: bool):
    """Inverted dropout (≅ dropout_layer): in training each entry is kept
    with probability ``keep = 1 - rate`` and scaled by ``1 / keep``.  The
    keep mask is ``torch.rand(shape) < keep`` drawn in float32 from
    ``generator`` on ``x``'s device whatever ``x``'s dtype, so a float64
    witness of a step sees the masks the f32 step drew.  Identity in test
    mode and at rate 0."""
    if not is_train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def conv2d_bn_relu(x, w, scale, bias, running_mean, running_var,
                   is_train: bool, momentum: float = 0.9, eps: float = 1e-5,
                   stride=1, padding=0, act: str = "relu"):
    """Fused conv + batch-norm + activation (the ResNet block entry point,
    ``act`` "relu" or "" for linear).  Returns ``(y, new_running_mean,
    new_running_var)``.

    Lowers to ``ops/kernels/conv.conv2d_bn_act``: training takes the BN
    statistics from the conv kernel's epilogue, inference folds the whole
    affine + ReLU into it.  CPU tensors run the kernels' plain twins
    inside the same autograd functions."""
    from paddle_tpu_torch.ops.kernels import conv as kconv

    return kconv.conv2d_bn_act(
        x, w, scale, bias, running_mean, running_var, is_train,
        momentum=momentum, eps=eps, stride=stride, padding=padding,
        act=act or None)
