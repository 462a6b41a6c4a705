"""The bf16 paged decode split over the sequence (``csrc/paged_attention.cu``,
``split16``) on the CPU: a plain PyTorch model of its two passes against
the bf16 twin and against the JAX package's Pallas kernel in interpret
mode, a control that rounds p against each chunk's own max, and the bf16
plan functions.

The criterion is the card's (``chip_smoke.paged_bf16_agreement``): equal
to the twin's bf16 output on all but 1% of the elements, each within one
bf16 ulp plus 2^-7 of sum_j p_j |v_j| / l (a rounded p may flip to its
neighbour where an f32 sum in another order moves it).  The model rounds
p = exp(s - m_i) to bf16 against each page's running max m_i, as the
Pallas grid does, so it meets it; the control, which rounds against its
chunk's own max, must miss it on more than 1% of the elements."""

import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke as S
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import paged_attention as PA

BF16 = ml_dtypes.bfloat16
NEG = -1e30


def make_paged(rng, lens, h, d, ps, maxp, top_row=None):
    """bf16 q and pools and a table of scattered page ids for ``lens``;
    row ``top_row``'s first token gets the largest score of its row in
    every head (its key along q, scaled to a score 2.5 over the row's
    largest other score)."""
    b = len(lens)
    need = [-(-int(n) // ps) for n in lens]
    pool = 1 + sum(need) + 2
    ids = rng.permutation(np.arange(1, pool))
    table = np.zeros((b, maxp), np.int32)
    nxt = 0
    for i, n in enumerate(need):
        table[i, :n] = ids[nxt:nxt + n]
        nxt += n
    kp = rng.normal(size=(h, pool, ps, d)).astype(np.float32)
    vp = rng.normal(size=(h, pool, ps, d)).astype(np.float32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    q, kp, vp = (np.asarray(x.astype(BF16), np.float32) for x in (q, kp, vp))
    if top_row is not None:
        n = int(lens[top_row])
        toks = np.arange(n)
        keys = kp[:, table[top_row, toks // ps], toks % ps]   # [h, n, d]
        s = np.einsum("hd,hnd->hn", q[top_row], keys) * d ** -0.5
        for hh in range(h):
            want = s[hh, 1:].max() + 2.5
            qv = q[top_row, hh]
            kp[hh, table[top_row, 0], 0] = qv * want / (d ** -0.5 * qv @ qv)
        kp = np.asarray(kp.astype(BF16), np.float32)
    return (torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
            torch.from_numpy(vp).bfloat16(), torch.from_numpy(table),
            torch.tensor(lens, dtype=torch.int32))


def two_pass_model(q, k_pages, v_pages, page_table, seq_lens,
                   chunk_max=False):
    """A torch model of the bf16 kernel's two launches.  Pass 1: each
    row's scores s = (q.k) scale in f32 and each page's max over its
    tokens below seq_len.  Pass 2, a chunk of ``pages_per_chunk(ps,
    bf16)`` pages at a time: the max of the pages before the chunk, each
    of its pages' running max m_i (a max scan from it), the chunk's last
    m_c, each page's weight exp(m_i - m_c); p = exp(s - m_i), l = sum p
    exp(m_i - m_c), acc = sum bf16(p) exp(m_i - m_c) v.  The live chunks'
    (m_c, l, acc) combined in chunk order as the f32 form does (one live
    chunk: its own acc / max(l, 1e-30)), out rounded to bf16 once; idle
    rows 0; page ids out of range read page 0.  ``chunk_max``: the
    control, p rounded against the chunk's own max (every m_i and m_c the
    max of the chunk's pages alone)."""
    h, n_pages, ps, d = k_pages.shape
    b, maxp = page_table.shape
    scale = d ** -0.5
    chunk = PA.pages_per_chunk(ps, torch.bfloat16) * ps
    out = torch.zeros(b, h, d)
    for bi in range(b):
        n = min(max(int(seq_lens[bi]), 0), maxp * ps)
        if n == 0:
            continue
        toks = torch.arange(n)
        pages = page_table[bi, toks // ps].long()
        pages = torch.where((pages >= 0) & (pages < n_pages), pages, 0)
        k, v = (x[:, pages, toks % ps].float() for x in (k_pages, v_pages))
        # pass 1
        s = torch.einsum("hd,hnd->hn", q[bi].float(), k) * scale
        npg = -(-n // ps)
        page_max = torch.stack([s[:, j * ps:(j + 1) * ps].amax(-1)
                                for j in range(npg)], -1)
        # pass 2
        parts = []
        for t0 in range(0, n, chunk):
            t1 = min(n, t0 + chunk)
            p0, p1 = t0 // ps, -(-t1 // ps)
            if chunk_max:
                run = page_max[:, p0:p1].amax(-1, keepdim=True).expand(
                    h, p1 - p0)
            else:
                before = (page_max[:, :p0].amax(-1) if p0
                          else torch.full((h,), NEG))
                run = torch.maximum(torch.cummax(page_max[:, p0:p1], -1)
                                    .values, before[:, None])
            m_c = run[:, -1]
            w_pg = torch.exp(run - m_c[:, None])
            j = toks[t0:t1] // ps - p0
            p = torch.exp(s[:, t0:t1] - run[:, j])
            w = w_pg[:, j]
            l = (p * w).sum(-1)
            acc = torch.einsum("hn,hnd->hd", p.bfloat16().float() * w,
                               v[:, t0:t1])
            parts.append((m_c, l, acc))
        if len(parts) == 1:
            _, l, acc = parts[0]
        else:
            top = torch.stack([m for m, _, _ in parts]).amax(0)
            l, acc = torch.zeros(h), torch.zeros(h, d)
            for m_c, l_c, acc_c in parts:
                w = torch.exp(m_c - top)
                l, acc = l + l_c * w, acc + acc_c * w[:, None]
        out[bi] = acc / l.clamp(min=1e-30)[:, None]
    return out.bfloat16()


def agreement(got, want, q, kp, vp, pt, sl):
    """``chip_smoke.bf16_agreement`` of ``got`` against ``want`` with the
    card's magnitude (the twin in f32 on |V|) and FLASH_BF16_FLIP."""
    mag = PA.ragged_paged_attention_reference(q.float(), kp.float(),
                                              vp.float().abs(), pt, sl)
    return S.bf16_agreement(got, want, mag, coef=S.FLASH_BF16_FLIP)


def agrees(a) -> bool:
    return (a["share_off"] <= S.BF16_ULP_SHARE
            and a["max_share_of_bound"] <= 1.0)


CASES = [
    # lens (0, 1, a page edge, past it, two and three chunks), heads,
    # head_dim, page_size, max_pages; the last row's first page holds its
    # largest score
    ([0, 1, 16, 17, 300, 600], 2, 64, 16, 40),
    ([0, 1, 8, 9, 260, 513], 2, 32, 8, 70),
    ([0, 1, 4, 5, 257, 300], 2, 16, 4, 80),
]


@pytest.mark.parametrize("lens,h,d,ps,maxp", CASES)
def test_two_pass_model_meets_the_bf16_criterion_against_the_twin(
        lens, h, d, ps, maxp):
    q, kp, vp, pt, sl = make_paged(np.random.default_rng(d + ps), lens, h,
                                   d, ps, maxp, top_row=len(lens) - 1)
    got = two_pass_model(q, kp, vp, pt, sl)
    want = PA.ragged_paged_attention_reference(q, kp, vp, pt, sl)
    a = agreement(got, want, q, kp, vp, pt, sl)
    assert agrees(a), a
    idle = sl == 0
    assert not got[idle].float().any()


@pytest.mark.parametrize("lens,h,d,ps,maxp", CASES)
def test_two_pass_model_meets_it_against_the_pallas_kernel(lens, h, d, ps,
                                                           maxp):
    q, kp, vp, pt, sl = make_paged(np.random.default_rng(d + ps), lens, h,
                                   d, ps, maxp, top_row=len(lens) - 1)
    got = two_pass_model(q, kp, vp, pt, sl)
    args = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
            for x in (q, kp, vp)]
    jax_out = np.asarray(JPA.ragged_paged_attention(
        *args, pt.numpy(), sl.numpy(), impl="kernel", interpret=True))
    want = torch.from_numpy(jax_out.astype(np.float32)).bfloat16()
    a = agreement(got, want, q, kp, vp, pt, sl)
    assert agrees(a), a


def test_the_first_page_holds_the_largest_score():
    """The built row's largest score lies on its first page in every head,
    so every later chunk rounds against a running max it did not see."""
    lens, h, d, ps, maxp = CASES[0]
    q, kp, vp, pt, sl = make_paged(np.random.default_rng(d + ps), lens, h,
                                   d, ps, maxp, top_row=len(lens) - 1)
    row, n = len(lens) - 1, lens[-1]
    toks = torch.arange(n)
    k = kp[:, pt[row, toks // ps].long(), toks % ps].float()
    s = torch.einsum("hd,hnd->hn", q[row].float(), k)
    assert (s.argmax(-1) == 0).all()
    assert n > 2 * PA.pages_per_chunk(ps, torch.bfloat16) * ps


@pytest.mark.parametrize("lens,h,d,ps,maxp", CASES)
def test_rounding_against_the_chunks_own_max_misses_it(lens, h, d, ps,
                                                       maxp):
    """The control: p rounded against the chunk's own max (the f32 form's
    split, another function) is unequal to the twin on more than 1% of
    the elements."""
    q, kp, vp, pt, sl = make_paged(np.random.default_rng(d + ps), lens, h,
                                   d, ps, maxp, top_row=len(lens) - 1)
    got = two_pass_model(q, kp, vp, pt, sl, chunk_max=True)
    want = PA.ragged_paged_attention_reference(q, kp, vp, pt, sl)
    a = agreement(got, want, q, kp, vp, pt, sl)
    assert a["share_off"] > S.BF16_ULP_SHARE, a


def test_out_of_range_page_ids_read_page_zero():
    """A table entry past the pool reads page 0 in the model, as the
    kernel does: the twin fed the same ids mapped to 0 agrees."""
    lens, h, d, ps, maxp = [0, 40, 300], 2, 32, 8, 40
    q, kp, vp, pt, sl = make_paged(np.random.default_rng(3), lens, h, d,
                                   ps, maxp)
    pt[2, 3] = kp.shape[1] + 5
    got = two_pass_model(q, kp, vp, pt, sl)
    mapped = torch.where(pt < kp.shape[1], pt, 0)
    want = PA.ragged_paged_attention_reference(q, kp, vp, mapped, sl)
    assert agrees(agreement(got, want, q, kp, vp, mapped, sl))


@pytest.mark.parametrize("ps,maxp,ppc,splits", [
    (16, 36, 8, 5),    # serving: 128-token chunks, 5 a row
    (4, 10, 32, 1),
    (64, 9, 2, 5),
    (200, 3, 1, 3),    # a page longer than a chunk: a page a chunk
    (16, 0, 8, 1),     # an empty table still has one chunk a row
])
def test_bf16_chunk_plan(ps, maxp, ppc, splits):
    """The bf16 plan: pages a chunk (the whole pages ``CHUNK_TOKENS_BF16``
    tokens hold, at least one), chunks a row, and the workspace: every
    (b, h)'s scores (a token of the table's row each) and page maxes, then
    (m, l, acc[D]) for every chunk of every (b, h); the f32 plan beside it
    unchanged."""
    bf = torch.bfloat16
    assert PA.CHUNK_TOKENS_BF16 == 128 == PA.chunk_tokens(bf)
    assert PA.pages_per_chunk(ps, bf) == ppc
    assert PA.splits(maxp, ps, bf) == splits
    assert PA.workspace_floats(32, 12, maxp, ps, 64, bf) == 32 * 12 * (
        maxp * ps + maxp + splits * 66)
    assert PA.workspace_floats(32, 12, maxp, ps, 64) == 32 * 12 * PA.splits(
        maxp, ps) * 66


@pytest.mark.parametrize("seq_len,live", [
    (0, 0), (-3, 0), (1, 1), (16, 1), (128, 1), (129, 2), (256, 2),
    (257, 3), (576, 5), (1000, 5),
])
def test_bf16_live_chunks(seq_len, live):
    """The bf16 chunks of a row that read tokens at serving's page of 16
    and 36-page rows (lengths past the row clamped to it)."""
    assert PA.live_chunks(seq_len, 36, 16, torch.bfloat16) == live


def _pv_smem_bytes(page_size):
    """Shared memory of a block of the bf16 kernel's second launch, as its
    C entry sums it: a chunk's p (one page where a page holds more than
    the chunk's tokens) and each page's running max and weight, beside
    ``split16``'s ``kStaticBytes``, read from the source."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    ns = src[src.index("namespace split16 {"):]
    threads = int(re.search(r"constexpr int kThreads = (\d+);", ns)[1])
    static = re.search(r"constexpr int kStaticBytes = ([^;]+);", ns)[1]
    static = eval(static, {"__builtins__": {}}, {"kThreads": threads})
    pages = PA.pages_per_chunk(page_size, torch.bfloat16)
    return 4 * (pages * page_size + 2 * pages) + static


def test_bf16_page_size_limit_is_the_largest_that_fits():
    """MAX_PAGE_SIZE_BF16 is the largest power of two whose second launch
    fits the 48 KB a launch takes without opting in."""
    limit = 48 * 1024
    assert _pv_smem_bytes(PA.MAX_PAGE_SIZE_BF16) <= limit
    assert _pv_smem_bytes(2 * PA.MAX_PAGE_SIZE_BF16) > limit
    assert _pv_smem_bytes(16) == 4 * (128 + 16) + 128 * 8 * 4 + 64
