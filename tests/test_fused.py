"""Fused bidiagonalization half-step: the operators' ``fused_halfstep``
(product + axpy + sum of squares, plain XLA) against a dense float64
oracle, and end-to-end solver equivalence with the generic path.

The fused path keeps u/v unnormalized in the carry (norms as scalars); see
the fused branch in solver._build."""

import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.ops.structured import dia_operator, dia_shared_operator


def _check_halfstep(A, rng, forward, c1=0.37, c2=1.21, rtol=2e-5,
                    ssq_rtol=1e-4):
    D = np.asarray(A.todense(), np.float64)
    if not forward:
        D = D.T
    y = rng.standard_normal(D.shape[0]).astype(np.float32)
    v = rng.standard_normal(D.shape[1]).astype(np.float32)
    out, ssq = A.fused_halfstep(forward=forward, y=jnp.asarray(y),
                                win=jnp.asarray(v), c1=c1, c2=c2)
    ref = D @ (v.astype(np.float64) * c1) - c2 * y
    np.testing.assert_allclose(np.asarray(out), ref, rtol=rtol, atol=2e-5)
    np.testing.assert_allclose(float(ssq), float((ref ** 2).sum()),
                               rtol=ssq_rtol)


@pytest.mark.parametrize(
    "shape", [(2100, 1900), (1024, 1024), (300, 400), (400, 300)]
)
def test_fused_halfstep_kernel(rng, shape):
    m, n = shape
    offs = (-5, -1, 0, 2, 7)
    data = rng.standard_normal((len(offs), m)).astype(np.float32)
    _check_halfstep(dia_operator(m, n, offs, data), rng, forward=True,
                    rtol=0, ssq_rtol=1e-5)


def test_fused_solver_matches_generic(rng):
    m = n = 600
    offs = (-3, -1, 0, 2, 5)
    data = rng.standard_normal((len(offs), m)).astype(np.float32)
    data[2] += 6.0  # diagonally dominant -> converges
    A = dia_operator(m, n, offs, data)
    xt = rng.standard_normal(n).astype(np.float32)
    b = np.asarray(A.matvec(jnp.asarray(xt)))
    ref = lt.lsqr(A, b, 0.0, atol=1e-6, btol=1e-6, itnlim=200)
    res = lt.lsqr(A, b, 0.0, atol=1e-6, btol=1e-6, itnlim=200,
                  fused=True, loop="bounded", loop_segment=16)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 1
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(ref.x), atol=5e-4
    )


def test_fused_damped_and_rect(rng):
    m, n = 500, 700
    offs = (-2, 0, 1, 4)
    data = rng.standard_normal((len(offs), m)).astype(np.float32)
    A = dia_operator(m, n, offs, data)
    b = rng.standard_normal(m).astype(np.float32)
    ref = lt.lsqr(A, b, 0.3, atol=1e-5, btol=1e-5, itnlim=120)
    res = lt.lsqr(A, b, 0.3, atol=1e-5, btol=1e-5, itnlim=120,
                  fused=True, loop="bounded", loop_segment=32)
    assert int(res.istop) == int(ref.istop) == 3
    np.testing.assert_allclose(
        float(res.rnorm), float(ref.rnorm), rtol=1e-3
    )


def test_fused_zero_rhs(rng):
    A = dia_operator(100, 100, (0,), np.ones((1, 100), np.float32))
    res = lt.lsqr(A, np.zeros(100, np.float32), 0.0, fused=True,
                  loop="bounded")
    assert int(res.istop) == 0 and int(res.itn) == 0


def test_fused_requires_capable_operator(rng):
    A = lt.coo_operator(10, 10, [1.0], [0], [0])
    with pytest.raises(ValueError, match="fused_halfstep"):
        lt.lsqr(A, np.ones(10), 0.0, fused=True)


@pytest.mark.parametrize("ssq_out", ["vmem", "smem"])
@pytest.mark.parametrize("shape", [(1500, 1500), (2100, 1800)])
def test_fused_halfstep_v2_kernel(rng, shape, ssq_out):
    """Both directions of the packed operator's half-step; ``ssq_out``
    keeps the old norm-layout cases' ids and picks the direction."""
    m, n = shape
    offs = (-3, 0, 5)
    data = rng.standard_normal((len(offs), m)).astype(np.float32)
    _check_halfstep(dia_operator(m, n, offs, data), rng,
                    forward=ssq_out == "vmem")


@pytest.mark.parametrize("shape", [(1500, 1500), (2100, 1800)])
def test_fused_halfstep_v3_kernel(rng, shape):
    """The shared-stripe operator's half-step, both directions."""
    m, n = shape
    offs = (-3, 0, 5)
    data = rng.standard_normal((len(offs), m)).astype(np.float32)
    A = dia_shared_operator(m, n, offs, data)
    _check_halfstep(A, rng, forward=True)
    _check_halfstep(A, rng, forward=False)
