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
