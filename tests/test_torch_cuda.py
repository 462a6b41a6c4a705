"""The port's CUDA kernels against their plain twins, on the card.

Run on a machine with an NVIDIA card (sm_90a) and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test skips: the decision is made inside the
``cuda`` fixture, never at import, so every pytest-xdist worker collects
the same tests.  Tolerance: 1e-4 absolute, the f32 round-off of a
different summation order (FMA chains in the kernel vs cuBLAS in the
twin) at these magnitudes; TF32 is off on both sides."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.dtype import set_f32_policy
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import paged_attention as PA

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the GPU host)")
    set_f32_policy()
    return torch.device("cuda", 0)


def _rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("b,t,h,d,causal", [
    (2, 64, 2, 64, True),
    (2, 100, 3, 64, True),
    (1, 333, 2, 64, False),
    (2, 130, 2, 16, True),
    (1, 70, 2, 32, False),
    (1, 129, 2, 128, True),
])
def test_flash_kernel_matches_plain(cuda, b, t, h, d, causal):
    rng = np.random.default_rng(t * d)
    q, k, v = (_rand(rng, b, t, h, d).to(cuda) for _ in range(3))
    before = FA.KERNEL.launches
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.KERNEL.launches == before + 1
    qp, kp, vp = FA._prep(q, k, v)
    o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t, causal, d ** -0.5)
    o_ref = FA._from_bh(o_ref, b, h, t, d)
    assert o.shape == (b, t, h, d) and lse.shape == (b * h, t, 1)
    assert (o - o_ref).abs().max().item() <= TOL
    assert (lse - lse_ref[:, :t]).abs().max().item() <= TOL
    ref = FA.flash_attention_reference(q, k, v, causal=causal)
    assert (o - ref).abs().max().item() <= TOL


def _paged(rng, lens, h, d, ps, maxp, device):
    b = len(lens)
    pool = 1 + sum(-(-n // ps) for n in lens) + 3
    table = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, pool))  # scattered page ids
    nxt = 0
    for i, n in enumerate(lens):
        for j in range(-(-n // ps)):
            table[i, j] = perm[nxt]
            nxt += 1
    kp = _rand(rng, h, pool, ps, d).to(device)
    vp = _rand(rng, h, pool, ps, d).to(device)
    q = _rand(rng, b, h, d).to(device)
    return (q, kp, vp, torch.from_numpy(table).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


@pytest.mark.parametrize("d,ps", [(64, 16), (16, 8), (128, 16), (32, 4)])
def test_paged_kernel_matches_plain(cuda, d, ps):
    rng = np.random.default_rng(d + ps)
    lens = [0, 1, 16, 17, 5, 0, 33, 64]
    maxp = -(-64 // ps)
    q, kp, vp, table, seq = _paged(rng, lens, 3, d, ps, maxp, cuda)
    before = PA.KERNEL.launches
    out = PA.ragged_paged_attention(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    assert PA.KERNEL.launches == before + 1
    ref = PA.ragged_paged_attention_reference(q, kp, vp, table, seq)
    assert (out - ref).abs().max().item() <= TOL
    idle = torch.tensor(lens, device=cuda) == 0
    assert torch.equal(out[idle], torch.zeros_like(out[idle]))
    assert torch.isfinite(out).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.core.enforce import EnforceError

    q = torch.zeros(1, 64, 2, 64, dtype=torch.float64, device=cuda)
    with pytest.raises(EnforceError, match="float32"):
        FA.flash_attention_fwd(q, q, q, causal=True)
    q = torch.zeros(1, 64, 2, 48, device=cuda)
    with pytest.raises(EnforceError, match="head_dim"):
        FA.flash_attention_fwd(q, q, q, causal=True)
    pool = torch.zeros(2, 4, 8, 16, device=cuda)
    table = torch.zeros(3, 2, dtype=torch.int64, device=cuda)
    lens = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(EnforceError, match="int32"):
        PA.ragged_paged_attention(torch.zeros(3, 2, 16, device=cuda), pool,
                                  pool, table, lens)


def test_engine_on_card_greedy_equals_full_context_argmax(cuda):
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    cfg = T.TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                              embed_dim=64, mlp_dim=128, max_seq_len=128,
                              attn_impl="flash")
    params = T.init_params(cfg, torch.Generator().manual_seed(1), cuda)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 64, size=n)) for n in (3, 40, 70, 9)]
    eng = ServingEngine(cfg, params, ServingConfig(
        max_slots=2, page_size=16, num_pages=32, max_prompt_len=80,
        max_new_tokens=8, prefill_batch=2, seed=0), device=cuda)
    fa0, pa0 = FA.KERNEL.launches, PA.KERNEL.launches
    results = eng.generate(prompts, max_new_tokens=6)
    assert FA.KERNEL.launches > fa0 and PA.KERNEL.launches > pa0
    for prompt, res in zip(prompts, results):
        full = torch.tensor([prompt + res.tokens], device=cuda)
        logits = T.forward(cfg, params, full)
        want = logits[0, len(prompt) - 1:-1].argmax(-1).tolist()
        assert res.tokens == want
