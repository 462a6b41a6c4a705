"""``paddle_tpu_torch.ops.kernels.brgemm`` (the BRGEMM kernel's plain twin
and its 1x1-conv row map) against the JAX package's ``tpp.brgemm``, run as
``tests/test_tpp.py`` runs it on the CPU: the Pallas kernel in interpret
mode and its jnp reference.

Tolerance: atol = rtol = 2e-5 on y and on the column sums, 2e-3 atol on
the sums of squares (they reach ~1e2 at these shapes) — the f32
summation-order bound ``tests/test_tpp.py`` holds the Pallas kernel to.
The kernel itself is held against the twin on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import tpp
from paddle_tpu_torch.ops.kernels import brgemm as BR

SHAPES = [(1, 8, 4, 8), (3, 17, 9, 21), (2, 30, 12, 7), (1, 130, 5, 129)]
MODES = ["none", "relu", "affine", "affine_relu", "stats",
         "affine_relu_stats"]


def _inputs(rng, g, m, k, n, mode):
    a = rng.normal(size=(g, m, k)).astype(np.float32)
    b = rng.normal(size=(g, k, n)).astype(np.float32)
    kw = {}
    if "affine" in mode:
        kw["scale"] = rng.normal(size=(n,)).astype(np.float32)
        kw["shift"] = rng.normal(size=(n,)).astype(np.float32)
    if "relu" in mode:
        kw["act"] = "relu"
    return a, b, kw, "stats" in mode


def _check(got, want, stats):
    got = got if stats else (got,)
    want = want if stats else (want,)
    tols = [(2e-5, 2e-5), (2e-5, 2e-4), (2e-5, 2e-3)]
    for x, y, (rtol, atol) in zip(got, want, tols):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", MODES)
def test_brgemm_twin_matches_jax_kernel_and_reference(shape, mode):
    rng = np.random.default_rng(sum(shape))
    a, b, kw, stats = _inputs(rng, *shape, mode)
    got = BR.brgemm(torch.from_numpy(a), torch.from_numpy(b), stats=stats,
                    **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                           else v) for k, v in kw.items()})
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ker = tpp.brgemm(jnp.asarray(a), jnp.asarray(b), stats=stats,
                     impl="kernel", interpret=True, **jkw)
    ref = tpp.brgemm_reference(jnp.asarray(a), jnp.asarray(b), stats=stats,
                               **jkw)
    _check(got, ker, stats)
    _check(got, ref, stats)
    if "relu" in mode:
        y = got[0] if stats else got
        assert float(y.min()) >= 0.0


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("stats", [False, True])
def test_conv1x1_row_map_equals_brgemm_on_strided_rows(stride, stats):
    """The 1x1-conv entry reads pixel rows at a stride; its twin equals
    the JAX package's route (slice x[:, ::s, ::s], then brgemm)."""
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 13, 14, 5)).astype(np.float32)
    w = rng.normal(size=(1, 1, 5, 9)).astype(np.float32)
    got = BR.conv1x1(torch.from_numpy(x), torch.from_numpy(w),
                     (stride, stride), stats=stats)
    xs = jnp.asarray(x)[:, ::stride, ::stride]
    n, oh, ow, _ = xs.shape
    want = tpp.brgemm(xs.reshape(1, n * oh * ow, 5),
                      jnp.asarray(w).reshape(1, 5, 9), stats=stats,
                      impl="kernel", interpret=True)
    if stats:
        assert got[0].shape == (n, oh, ow, 9)
        _check((got[0].reshape(-1, 9), got[1], got[2]), want, True)
    else:
        assert got.shape == (n, oh, ow, 9)
        _check(got.reshape(-1, 9), want, False)


def test_epilogue_arguments_are_checked():
    a, b = torch.zeros(1, 2, 3), torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="act"):
        BR.brgemm(a, b, act="tanh")
    with pytest.raises(ValueError, match="scale and shift"):
        BR.brgemm(a, b, scale=torch.ones(4))


def test_an_edited_shared_header_rebuilds_the_libraries(tmp_path, monkeypatch):
    """Both conv kernels include ``csrc/gemm_f32.cuh``: a library is keyed
    by its source AND the shared headers, so an edited header is never
    served from a stale build."""
    from paddle_tpu_torch.ops.kernels import _build

    (tmp_path / "k.cu").write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k")
    (tmp_path / "g.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before
    assert _build.library_path("k") == _build.library_path("k")
