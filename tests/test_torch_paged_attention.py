"""``paddle_tpu_torch.ops.kernels.paged_attention`` against the JAX
package: the plain twin vs ``ragged_paged_attention_reference`` and vs
the Pallas kernel in interpret mode, on ragged lengths including 0; the
pool writes bit-equal to JAX's.  Tolerance 2e-5 (atol and rtol): f32
round-off of einsum orders at unit-scale inputs, the JAX package's own
kernel-vs-reference tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu_torch.ops.kernels import paged_attention as PA

TOL = dict(rtol=2e-5, atol=2e-5)


def make_paged(rng, lens, h, d, ps, maxp):
    """Random pools + a page table with scattered page ids for ``lens``."""
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
    return q, kp, vp, table, np.asarray(lens, np.int32)


CASES = [
    # lens, heads, head_dim, page_size, max_pages
    ([1, 7, 20, 0], 2, 16, 8, 4),
    ([0, 0, 3], 1, 32, 4, 2),
    ([16, 17, 32, 0, 5], 3, 64, 16, 3),
]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("lens,h,d,ps,maxp", CASES)
def test_plain_matches_jax_reference(lens, h, d, ps, maxp, rng_np):
    q, kp, vp, pt, sl = make_paged(rng_np, lens, h, d, ps, maxp)
    want = np.asarray(JPA.ragged_paged_attention_reference(q, kp, vp, pt, sl))
    got = PA.ragged_paged_attention_reference(*_torch(q, kp, vp, pt, sl))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    idle = sl == 0
    assert np.array_equal(got.numpy()[idle], np.zeros_like(want[idle]))


@pytest.mark.parametrize("lens,h,d,ps,maxp", CASES[:2])
def test_plain_matches_jax_pallas_kernel_interpreted(lens, h, d, ps, maxp,
                                                     rng_np):
    q, kp, vp, pt, sl = make_paged(rng_np, lens, h, d, ps, maxp)
    want = np.asarray(JPA.ragged_paged_attention(
        q, kp, vp, pt, sl, impl="kernel", interpret=True))
    got = PA.ragged_paged_attention_reference(*_torch(q, kp, vp, pt, sl))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrapper_takes_the_plain_twin_for_cpu_tensors(rng_np):
    q, kp, vp, pt, sl = _torch(*make_paged(rng_np, [3, 0, 9], 2, 16, 4, 3))
    before = PA.KERNEL.launches
    out = PA.ragged_paged_attention(q, kp, vp, pt, sl)
    assert torch.equal(out,
                       PA.ragged_paged_attention_reference(q, kp, vp, pt, sl))
    assert PA.KERNEL.launches == before  # no kernel ran


def test_wrapper_checks_shapes_and_index_dtypes(rng_np):
    from paddle_tpu_torch.core.enforce import EnforceError

    q, kp, vp, pt, sl = _torch(*make_paged(rng_np, [3, 5], 2, 16, 4, 2))
    with pytest.raises(EnforceError, match="int32"):
        PA.ragged_paged_attention(q, kp, vp, pt.long(), sl)
    with pytest.raises(EnforceError, match="seq_lens"):
        PA.ragged_paged_attention(q, kp, vp, pt, sl[:1])
    with pytest.raises(EnforceError, match="does not match"):
        PA.ragged_paged_attention(q[:, :1], kp, vp, pt, sl)


def test_write_decode_kv_bit_equal_to_jax(rng_np):
    h, pool, ps, d = 2, 8, 4, 16
    kc = rng_np.normal(size=(h, pool, ps, d)).astype(np.float32)
    vc = rng_np.normal(size=(h, pool, ps, d)).astype(np.float32)
    table = np.array([[1, 2], [3, 0], [0, 0]], np.int32)  # row 2 idle
    k = rng_np.normal(size=(3, h, d)).astype(np.float32)
    v = rng_np.normal(size=(3, h, d)).astype(np.float32)
    pos = np.array([5, 2, 0], np.int32)
    jk, jv = JPA.write_decode_kv(jnp.asarray(kc), jnp.asarray(vc), k, v,
                                 table, pos)
    tk, tv = _torch(kc.copy(), vc.copy())
    out = PA.write_decode_kv(tk, tv, *_torch(k, v, table, pos))
    assert out[0] is tk  # in place
    # pages 1.. are bit-equal; page 0 is the null page (idle-row scratch)
    assert np.array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    assert np.array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])


def test_write_prefill_kv_bit_equal_to_jax(rng_np):
    layers, h, pool, ps, d = 2, 2, 12, 4, 8
    b, t = 3, 9
    kc = np.zeros((layers, h, pool, ps, d), np.float32)
    vc = np.zeros_like(kc)
    table = np.array([[3, 4, 5], [1, 2, 0], [0, 0, 0]], np.int32)
    lens = np.array([9, 6, 0], np.int32)
    ks = rng_np.normal(size=(layers, b, t, h, d)).astype(np.float32)
    vs = rng_np.normal(size=(layers, b, t, h, d)).astype(np.float32)
    jk, jv = JPA.write_prefill_kv(jnp.asarray(kc), jnp.asarray(vc), ks, vs,
                                  table, lens)
    tk, tv = _torch(kc.copy(), vc.copy())
    PA.write_prefill_kv(tk, tv, *_torch(ks, vs, table, lens))
    assert np.array_equal(tk.numpy()[:, :, 1:], np.asarray(jk)[:, :, 1:])
    assert np.array_equal(tv.numpy()[:, :, 1:], np.asarray(jv)[:, :, 1:])
    # and what was written reads back through attention
    q = rng_np.normal(size=(b, h, d)).astype(np.float32)
    want = np.asarray(JPA.ragged_paged_attention_reference(
        q, np.asarray(jk)[1], np.asarray(jv)[1], table, lens))
    got = PA.ragged_paged_attention(*_torch(q), tk[1], tv[1],
                                    *_torch(table, lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_init_kv_pages_layout():
    k, v = PA.init_kv_pages(2, 3, 5, 4, 16, device="cpu")
    jk, _ = JPA.init_kv_pages(2, 3, 5, 4, 16)
    assert tuple(k.shape) == tuple(jk.shape) == tuple(v.shape)
    assert k.dtype == torch.float32 and not k.any()


# -- the f32 kernel's plan and its split over the sequence ---------------------


@pytest.mark.parametrize("ps,maxp,ppc,splits", [
    (16, 36, 8, 5),    # serving: 128-token chunks, 5 a row
    (4, 10, 32, 1),
    (64, 5, 2, 3),
    (200, 3, 1, 3),    # a page longer than a chunk: a page a chunk
    (16, 0, 8, 1),     # an empty table still has one chunk a row
])
def test_f32_chunk_plan(ps, maxp, ppc, splits):
    """Pages a chunk (the whole pages ``CHUNK_TOKENS`` tokens hold, at
    least one), chunks a row (from the table's width alone) and the
    partials' size: (m, l, acc[D]) for every chunk of every (b, h)."""
    assert PA.CHUNK_TOKENS == 128
    assert PA.pages_per_chunk(ps) == ppc
    assert PA.splits(maxp, ps) == splits
    assert PA.workspace_floats(32, 12, maxp, ps, 64) == 32 * 12 * splits * 66


@pytest.mark.parametrize("seq_len,live", [
    (0, 0), (-3, 0), (1, 1), (16, 1), (128, 1), (129, 2), (256, 2),
    (257, 3),
    (576, 5),    # full
    (1000, 5),   # past the table's row: clamped to it, as the kernel does
])
def test_f32_live_chunks(seq_len, live):
    """The chunks of a row that read tokens, at serving's page of 16 and
    36-page rows: none for an idle row (which writes zeros), one below a
    chunk's 128 tokens and at its edge, a chunk more past it."""
    assert PA.live_chunks(seq_len, 36, 16) == live


def _split_model(q, k_pages, v_pages, page_table, seq_lens, window=64):
    """A torch model of the f32 kernel (``csrc/paged_attention.cu``,
    ``split``): each (b, h) row over chunks of ``pages_per_chunk`` pages;
    inside a chunk windows of ``window`` tokens, each a max, p = exp(s -
    m) and the running (m, l, acc) rescaled; the live chunks' (m, l, acc)
    combined in chunk order, out = acc / max(l, 1e-30); a row with one
    live chunk that chunk's acc / max(l, 1e-30); idle rows 0; page ids
    out of range read page 0."""
    h, n_pages, ps, d = k_pages.shape
    b, maxp = page_table.shape
    scale = d ** -0.5
    chunk = PA.pages_per_chunk(ps) * ps
    out = torch.zeros(b, h, d)
    for bi in range(b):
        n = min(max(int(seq_lens[bi]), 0), maxp * ps)
        toks = torch.arange(n)
        pages = page_table[bi, toks // ps].long()
        pages = torch.where((pages >= 0) & (pages < n_pages), pages, 0)
        k, v = (x[:, pages, toks % ps] for x in (k_pages, v_pages))
        parts = []
        for t0 in range(0, n, chunk):
            m, l = torch.full((h,), -1e30), torch.zeros(h)
            acc = torch.zeros(h, d)
            t1 = min(n, t0 + chunk)
            for w0 in range(t0, t1, window):
                w = slice(w0, min(t1, w0 + window))
                s = torch.einsum("hd,hnd->hn", q[bi], k[:, w]) * scale
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + torch.einsum("hn,hnd->hd", p,
                                                         v[:, w])
                m = m_new
            parts.append((m, l, acc))
        if len(parts) == 1:
            m, l, acc = parts[0]
        elif parts:
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            l, acc = torch.zeros(h), torch.zeros(h, d)
            for m_c, l_c, acc_c in parts:
                w = torch.exp(m_c - mx)
                l, acc = l + l_c * w, acc + acc_c * w[:, None]
        else:
            continue
        out[bi] = acc / l.clamp(min=1e-30)[:, None]
    return out


SPLIT_CASES = [
    # lens (0, 1, a page edge, past it, full), heads, head_dim, page_size,
    # max_pages
    ([0, 1, 16, 17, 128, 129, 200, 320], 2, 64, 16, 20),
    ([0, 1, 16, 17, 160], 2, 60, 4, 40),    # 4-byte units on the card
    ([0, 1, 16, 17, 129, 256], 2, 16, 64, 4),
]


@pytest.mark.parametrize("lens,h,d,ps,maxp", SPLIT_CASES)
def test_f32_split_and_combine_model_matches_the_twin_and_jax(
        lens, h, d, ps, maxp, rng_np):
    """The split over chunks and the combine in chunk order compute the
    function the twin and the Pallas ``_decode_kernel`` (interpret mode)
    compute, within 2e-5; idle rows exact zeros."""
    q, kp, vp, pt, sl = make_paged(rng_np, lens, h, d, ps, maxp)
    got = _split_model(*_torch(q, kp, vp, pt, sl))
    want = PA.ragged_paged_attention_reference(*_torch(q, kp, vp, pt, sl))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jax_out = np.asarray(JPA.ragged_paged_attention(
        q, kp, vp, pt, sl, impl="kernel", interpret=True))
    np.testing.assert_allclose(got.numpy(), jax_out, **TOL)
    idle = sl == 0
    assert not got.numpy()[idle].any()
