"""Transformer LM — the port of ``paddle_tpu/models/transformer.py``:
init, full-context ``forward``, the serving pair ``forward_prefill`` /
``forward_decode`` over the paged KV cache, and single-device training
(``forward_with_aux``, ``loss_fn``, ``build_train_step``).

Params are the JAX package's pytree as a dict of tensors, with block
weights stacked on a leading layer dim ([L, ...]) and the same names as
its ``init_params``; :func:`params_from_numpy` reads the JAX package's
flat export names (``"embed"``, ``"blocks/wq"``, ...).  The JAX
``lax.scan`` over layers is a Python loop over ``l``.  The tied LM head
``x @ embed.T`` and the block projections are plain products that XLA
did outside any Pallas kernel; here they are ``torch.matmul``.

Attention (``cfg.attn_impl``): "flash" runs the flash kernels
(``ops/kernels/flash_attention.py``: the forward, and in training the dQ
and dK/dV kernels of its autograd backward), "exact" the plain masked
softmax.  ``build_train_step(..., compute_dtype=torch.bfloat16)`` trains
in bf16 on f32 master weights, as the JAX step does; the flash kernels
then run their bf16 forms.  Training-only strategies (blockwise, ring,
ulysses), MoE FFNs, ``remat="dots"``, meshes, ZeRO and a float16
``compute_dtype`` are later slices and raise here."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core import tree
from paddle_tpu_torch.core.dtype import at_least_f32, cast_floats
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.nn import gelu, layer_norm as _ln


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields as the JAX package's config (so an exported servable's
    config loads as is); ``dtype`` is a torch dtype."""

    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 8
    embed_dim: int = 512
    mlp_dim: int = 2048
    max_seq_len: int = 2048
    dtype: object = torch.float32
    remat: object = True
    attn_impl: str = "exact"
    attn_block_size: int = 1024
    scan_unroll: object = "auto"
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_dispatch: str = "sort"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


_BLOCK_KEYS = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo", "ln2_g", "ln2_b",
               "w_in", "b_in", "w_out", "b_out")


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.moe_experts:
        raise NotImplementedError(
            "the port serves the dense-FFN transformer; MoE is a later "
            "slice")


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> dict:
    """Stacked-layer params (block weights have leading dim num_layers),
    the JAX ``init_params`` scales, drawn from ``generator``, on
    ``device`` (``None``: ``cuda:0``, raising without a card).  Numbers
    differ from the JAX package's (threefry vs PyTorch's generator); move
    JAX weights across with :func:`params_from_numpy` instead."""
    _dense_only(cfg)
    device = resolve_device(device)
    e, h, m, v_sz = (cfg.embed_dim, cfg.num_heads * cfg.head_dim,
                     cfg.mlp_dim, cfg.vocab_size)
    s = cfg.num_layers
    dt = cfg.dtype

    def norm(*shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.to(device=device, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    return {
        "embed": norm(v_sz, e) * (e ** -0.5),
        "pos_embed": norm(cfg.max_seq_len, e) * 0.02,
        "blocks": {
            "ln1_g": ones(s, e),
            "ln1_b": zeros(s, e),
            "wq": norm(s, e, h) * (e ** -0.5),
            "wk": norm(s, e, h) * (e ** -0.5),
            "wv": norm(s, e, h) * (e ** -0.5),
            "wo": norm(s, h, e) * (h ** -0.5) / (2 * s) ** 0.5,
            "ln2_g": ones(s, e),
            "ln2_b": zeros(s, e),
            "w_in": norm(s, e, m) * (e ** -0.5),
            "b_in": zeros(s, m),
            "w_out": norm(s, m, e) * (m ** -0.5) / (2 * s) ** 0.5,
            "b_out": zeros(s, e),
        },
        "ln_f_g": ones(e),
        "ln_f_b": zeros(e),
    }


def _from_numpy(value) -> torch.Tensor:
    """A writable tensor copy of a numpy array.  JAX's bfloat16 arrays
    reach numpy as ``ml_dtypes.bfloat16`` (dtype name ``"bfloat16"``),
    which ``torch.from_numpy`` refuses: their bits are carried as int16
    and viewed as ``torch.bfloat16``, bit for bit."""
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(flat: dict, device=None, dtype=None) -> dict:
    """The JAX package's flat param names (``"embed"``, ``"blocks/wq"``,
    ... as ``serving/export.py`` writes them) with numpy values (float32,
    or JAX's bfloat16 bit for bit) -> the port's nested params on
    ``device`` (``None``: ``cuda:0``, raising without a card).  Float
    arrays are cast to ``dtype`` when given."""
    device = resolve_device(device)
    out: dict = {}
    for key, value in flat.items():
        t = _from_numpy(value)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        node, parts = out, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(device)
    return out


def count_params(params: dict) -> int:
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())


def _layers(params: dict) -> list[dict]:
    """Per-layer views of the stacked block weights.  ``unbind`` has one
    backward (a stack) for all layers, where indexing layer by layer would
    scatter each layer's gradient into its own full-size zero tensor."""
    per_key = {k: params["blocks"][k].unbind(0) for k in _BLOCK_KEYS}
    return [{k: per_key[k][l] for k in _BLOCK_KEYS}
            for l in range(len(per_key["wq"]))]


def _attention(cfg: TransformerConfig, q, k, v):
    """Causal self-attention over [B, T, H, D]."""
    if cfg.attn_impl == "flash":
        return fa.flash_attention(q, k, v, causal=True)
    if cfg.attn_impl == "exact":
        t = q.shape[1]
        return attn_ops.dot_product_attention(
            q, k, v, mask=attn_ops.causal_mask(t, t, device=q.device))
    raise NotImplementedError(
        f"attn_impl={cfg.attn_impl!r}: the port has 'flash' and 'exact'; "
        "the training strategies are a later slice")


def _block_kv(cfg: TransformerConfig, x, layer):
    """One pre-LN decoder block; x [B, T, E] -> (x', (k, v))."""
    b, t, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    h = _ln(x, layer["ln1_g"], layer["ln1_b"])
    q = (h @ layer["wq"]).reshape(b, t, nh, hd)
    k = (h @ layer["wk"]).reshape(b, t, nh, hd)
    v = (h @ layer["wv"]).reshape(b, t, nh, hd)
    a = _attention(cfg, q, k, v)
    x = x + a.reshape(b, t, nh * hd) @ layer["wo"]
    h = _ln(x, layer["ln2_g"], layer["ln2_b"])
    h = gelu(h @ layer["w_in"] + layer["b_in"])
    return x + h @ layer["w_out"] + layer["b_out"], (k, v)


def _block(cfg: TransformerConfig, x, layer):
    return _block_kv(cfg, x, layer)[0]


def _trunk(cfg: TransformerConfig, params: dict, ids: torch.Tensor,
           remat: bool) -> torch.Tensor:
    """ids [B, T] -> logits [B, T, V]; ``remat`` checkpoints each block
    (the JAX ``jax.checkpoint(block)``).  The token gather is
    ``F.embedding``, whose backward sums each row's gradients in a fixed
    order on the CPU and the card; the backward of ``embed[ids]``
    (``index_put_`` with accumulate) is nondeterministic on the CPU."""
    t = ids.shape[1]
    x = (torch.nn.functional.embedding(ids.long(), params["embed"])
         + params["pos_embed"][:t][None])
    for layer in _layers(params):
        block = functools.partial(_block, cfg, layer=layer)
        x = (checkpoint(block, x, use_reentrant=False) if remat
             else block(x))
    x = _ln(x, params["ln_f_g"], params["ln_f_b"])
    return x @ params["embed"].T


@torch.no_grad()
def forward(cfg: TransformerConfig, params: dict,
            ids: torch.Tensor) -> torch.Tensor:
    """ids [B, T] -> logits [B, T, V] (full context), for inference."""
    _dense_only(cfg)
    return _trunk(cfg, params, ids, remat=False)


# -- training --------------------------------------------------------------


def _check_train(cfg: TransformerConfig) -> None:
    if cfg.moe_experts:
        raise NotImplementedError(
            "the port trains the dense-FFN transformer; MoE FFNs (with "
            "parallel/moe.py) are a later slice")
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (the dots-saveable policy) is a later slice; "
            "use remat=True or False")
    if not isinstance(cfg.remat, bool):
        raise ValueError(f"remat must be True, False or 'dots', got "
                         f"{cfg.remat!r}")


def forward_with_aux(cfg: TransformerConfig, params: dict,
                     ids: torch.Tensor, mesh=None):
    """(logits [B, T, V], aux) with autograd; aux is the mean MoE
    load-balancing loss, 0 for the dense FFNs the port has."""
    _check_train(cfg)
    if mesh is not None:
        raise NotImplementedError("meshes (data/tensor/sequence parallel) "
                                  "are a later slice")
    logits = _trunk(cfg, params, ids, remat=cfg.remat)
    return logits, logits.new_zeros((), dtype=torch.float32)


def loss_fn(cfg: TransformerConfig, params: dict, ids: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """Next-token mean cross-entropy (targets = ids shifted left), as
    logsumexp(logits) - logits[target] over f32 (or wider) logits, the
    mean over [B, T].  ``softmax_xent``'s kernel stays off this path, as
    in the JAX package."""
    logits, _ = forward_with_aux(cfg, params, ids[:, :-1], mesh=mesh)
    targets = ids[:, 1:].long()
    lse = torch.logsumexp(at_least_f32(logits), dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(lse - at_least_f32(tgt))


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype}: the port trains in float32 or "
            "bfloat16 (f32 master weights)")


def loss_and_grads(cfg: TransformerConfig, params: dict, ids: torch.Tensor,
                   compute_dtype=None):
    """(loss, grads): the loss of :func:`loss_fn` (detached) and its
    gradient in every param leaf, as a tree shaped like ``params``.

    With ``compute_dtype`` the forward and backward run on a cast of the
    params taken inside autograd (``core/dtype.cast_floats``, the JAX
    step's ``_cast_floats`` inside its loss function), so each gradient
    reaches its leaf in the leaf's own dtype: f32 masters get f32
    gradients."""
    _check_compute_dtype(compute_dtype)
    live = [p.detach().requires_grad_() for p in tree.leaves(params)]
    p = tree.unflatten(params, live)
    if compute_dtype is not None:
        p = cast_floats(p, compute_dtype)
    loss = loss_fn(cfg, p, ids)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree.unflatten(params, grads)


def build_train_step(cfg: TransformerConfig, optimizer, mesh=None,
                     compute_dtype=None, zero1=False, zero=None):
    """(params, opt_state, ids) -> (params, opt_state, loss), ids [B, T+1].

    The JAX package's no-mesh, ``zero=0`` step: the loss and its gradients
    (:func:`loss_and_grads`), then ``optimizer.apply_tree``.  The JAX step
    donates its params and optimizer state (``donate_argnums=(0, 1)``):
    the buffers passed in are dead after the call.  The port's faithful
    reading is an update in place: the params passed in are updated and
    returned, and ``opt_state``'s entries are rebound.  PyTorch runs
    eagerly, so nothing is traced or compiled.

    ``compute_dtype=torch.bfloat16`` is the JAX step's mixed precision:
    the params (and the optimizer state) stay as they are, the forward
    and backward run on a bf16 cast of them (:func:`loss_and_grads`), and
    the update applies the gradients the cast hands back in the params'
    dtype.  ``mesh``, ZeRO and any other ``compute_dtype`` are later
    slices and raise."""
    if mesh is not None or zero1 or zero:
        raise NotImplementedError(
            "mesh and ZeRO train steps are a later slice; the port trains "
            "on one device")
    _check_compute_dtype(compute_dtype)
    _check_train(cfg)

    def step(params, opt_state, ids):
        with torch.profiler.record_function("train_step/forward_backward"):
            loss, grads = loss_and_grads(cfg, params, ids, compute_dtype)
        with torch.profiler.record_function("train_step/optimizer"):
            optimizer.apply_tree(grads, params, opt_state)
        return params, opt_state, loss

    return step


# -- incremental inference (the serving path) ---------------------------------


@torch.no_grad()
def forward_prefill(cfg: TransformerConfig, params: dict, ids: torch.Tensor,
                    seq_lens: torch.Tensor):
    """Prompt pass: ids [B, T] right-padded, seq_lens [B] valid lengths.

    Returns (last-token logits [B, V], k [L, B, T, H, Dh], v likewise);
    the caller scatters the K/V stacks into the paged cache
    (``paged_attention.write_prefill_kv``).  Causal masking means padded
    positions are never attended by valid queries; rows with
    ``seq_lens == 0`` give logits the caller discards."""
    _dense_only(cfg)
    b, t = ids.shape
    x = params["embed"][ids.long()] + params["pos_embed"][:t][None]
    ks, vs = [], []
    for layer in _layers(params):
        x, (k, v) = _block_kv(cfg, x, layer)
        ks.append(k)
        vs.append(v)
    x = _ln(x, params["ln_f_g"], params["ln_f_b"])
    last = torch.clamp(seq_lens.long() - 1, min=0)
    x_last = x[torch.arange(b, device=x.device), last]
    return x_last @ params["embed"].T, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def forward_decode(cfg: TransformerConfig, params: dict, ids: torch.Tensor,
                   positions: torch.Tensor, seq_lens: torch.Tensor,
                   page_table: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor):
    """One incremental decode step over the paged KV cache.

    ids [B] current tokens, positions [B] their absolute indices,
    seq_lens [B] = positions + 1 on live rows and 0 on idle rows (int32),
    page_table [B, max_pages] int32, k_cache/v_cache [L, H, P, page_size,
    Dh].  Each block writes the new token's K/V into its pages (in
    place), then runs ragged paged attention over the whole resident
    context.  Returns (logits [B, V], k_cache, v_cache)."""
    _dense_only(cfg)
    b = ids.shape[0]
    nh, hd = cfg.num_heads, cfg.head_dim
    x = params["embed"][ids.long()] + params["pos_embed"][positions.long()]
    for l, layer in enumerate(_layers(params)):
        kc, vc = k_cache[l], v_cache[l]
        h = _ln(x, layer["ln1_g"], layer["ln1_b"])
        q = (h @ layer["wq"]).reshape(b, nh, hd)
        k = (h @ layer["wk"]).reshape(b, nh, hd)
        v = (h @ layer["wv"]).reshape(b, nh, hd)
        pa.write_decode_kv(kc, vc, k, v, page_table, positions)
        a = pa.ragged_paged_attention(q, kc, vc, page_table, seq_lens)
        x = x + a.reshape(b, nh * hd) @ layer["wo"]
        h = _ln(x, layer["ln2_g"], layer["ln2_b"])
        h = gelu(h @ layer["w_in"] + layer["b_in"])
        x = x + h @ layer["w_out"] + layer["b_out"]
    x = _ln(x, params["ln_f_g"], params["ln_f_b"])
    return x @ params["embed"].T, k_cache, v_cache
