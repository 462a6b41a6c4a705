"""Transformer LM — the port of ``paddle_tpu/models/transformer.py`` for
inference: init, full-context ``forward``, and the serving pair
``forward_prefill`` / ``forward_decode`` over the paged KV cache.

Params are the JAX package's pytree as a dict of tensors, with block
weights stacked on a leading layer dim ([L, ...]) and the same names as
its ``init_params``; :func:`params_from_numpy` reads the JAX package's
flat export names (``"embed"``, ``"blocks/wq"``, ...).  The JAX
``lax.scan`` over layers is a Python loop over ``l``.  The tied LM head
``x @ embed.T`` and the block projections are plain products that XLA
did outside any Pallas kernel; here they are ``torch.matmul``.

Attention (``cfg.attn_impl``): "flash" runs the flash kernel
(``ops/kernels/flash_attention.py``), "exact" the plain masked softmax.
Training-only strategies (blockwise, ring, ulysses) and MoE FFNs are
later slices and raise here."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    the JAX ``init_params`` scales, drawn from ``generator``.  Numbers
    differ from the JAX package's (threefry vs PyTorch's generator); move
    JAX weights across with :func:`params_from_numpy` instead."""
    _dense_only(cfg)
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


def params_from_numpy(flat: dict, device=None, dtype=None) -> dict:
    """The JAX package's flat param names (``"embed"``, ``"blocks/wq"``,
    ... as ``serving/export.py`` writes them) with numpy values -> the
    port's nested params on ``device``.  Float arrays are cast to
    ``dtype`` when given."""
    out: dict = {}
    for key, value in flat.items():
        t = torch.from_numpy(np.array(value))  # a writable copy
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


def _layer(params: dict, l: int) -> dict:
    return {k: params["blocks"][k][l] for k in _BLOCK_KEYS}


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


@torch.no_grad()
def forward(cfg: TransformerConfig, params: dict,
            ids: torch.Tensor) -> torch.Tensor:
    """ids [B, T] -> logits [B, T, V] (full context)."""
    _dense_only(cfg)
    t = ids.shape[1]
    x = params["embed"][ids.long()] + params["pos_embed"][:t][None]
    for l in range(cfg.num_layers):
        x, _ = _block_kv(cfg, x, _layer(params, l))
    x = _ln(x, params["ln_f_g"], params["ln_f_b"])
    return x @ params["embed"].T


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
    for l in range(cfg.num_layers):
        x, (k, v) = _block_kv(cfg, x, _layer(params, l))
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
    for l in range(cfg.num_layers):
        layer = _layer(params, l)
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
