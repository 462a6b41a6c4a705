"""Token sampling for the decode loop — greedy + temperature (the port of
``paddle_tpu/serving/sampling.py``).

The contract is the JAX package's: a serving trace is reproducible given
(seed, arrival order).  Request ``r``'s ``n``-th sampled token draws from
a generator seeded by ``(seed, r, n)`` alone, whatever batch slot or step
it lands in.  The bits differ from JAX's threefry (and between the CPU
and CUDA generators); greedy rows are an argmax and agree exactly."""

from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser: a bijective 64-bit scramble."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_seed(seed: int, request_id: int, token_index: int) -> int:
    """The generator seed of request ``request_id``'s ``token_index``-th
    token (the counterpart of JAX's ``fold_in(fold_in(key, r), n)``)."""
    return _mix(_mix(_mix(seed) ^ request_id) ^ token_index) >> 1


def sample_tokens(logits: torch.Tensor, temperatures, seed: int,
                  request_ids, token_indices) -> np.ndarray:
    """logits [B, V]; temperatures, request_ids, token_indices [B] host
    arrays -> tokens [B] int32 (numpy).

    Rows with ``temperature <= 0`` are greedy (argmax); others draw from
    softmax(logits / temperature) by the Gumbel-max trick, with noise
    from that row's own generator."""
    temps = np.asarray(temperatures, np.float32)
    tokens = torch.argmax(logits, dim=-1)
    hot = np.flatnonzero(temps > 0)
    if hot.size:
        v = logits.shape[-1]
        gen = torch.Generator(device=logits.device)
        noise = torch.empty((hot.size, v), dtype=torch.float32,
                            device=logits.device)
        for j, row in enumerate(hot):
            gen.manual_seed(request_seed(int(seed), int(request_ids[row]),
                                         int(token_indices[row])))
            noise[j].uniform_(generator=gen)
        gumbel = -torch.log(-torch.log(noise.clamp_(min=1e-20, max=1.0
                                                    - 1e-7)))
        rows = torch.as_tensor(hot, device=logits.device)
        scaled = logits[rows].float() / torch.as_tensor(
            temps[hot], device=logits.device)[:, None]
        tokens[rows] = torch.argmax(scaled + gumbel, dim=-1)
    return tokens.to(torch.int32).cpu().numpy()
