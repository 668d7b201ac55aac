"""Differentiable solves (lsqr_tpu.implicit): implicit-function-theorem
gradients through lsqr w.r.t. b, damp and operator array leaves, checked
against the dense closed form and finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.implicit import lsqr_grad, normal_cg


@pytest.fixture
def problem(rng):
    m, n = 30, 18
    Ad = jnp.asarray(rng.standard_normal((m, n)))
    b = jnp.asarray(rng.standard_normal(m))
    tgt = jnp.asarray(rng.standard_normal(n))
    return m, n, Ad, b, tgt


def _closed_form(Ad, b, lam):
    n = Ad.shape[1]
    return jnp.linalg.solve(Ad.T @ Ad + lam * lam * jnp.eye(n), Ad.T @ b)


def test_normal_cg_solves(rng):
    m, n = 40, 25
    Ad = jnp.asarray(rng.standard_normal((m, n)))
    A = lt.as_operator(Ad)
    g = jnp.asarray(rng.standard_normal(n))
    damp = jnp.asarray(0.4)
    s = normal_cg(A, damp, g, tol=1e-12)
    N = Ad.T @ Ad + damp * damp * jnp.eye(n)
    np.testing.assert_allclose(np.asarray(N @ s), np.asarray(g), atol=1e-8)


def test_grad_b_matches_closed_form(problem):
    m, n, Ad, b, tgt = problem
    damp = 0.3

    def loss_solver(b_):
        return jnp.sum((lsqr_grad(Ad, b_, damp, atol=1e-14, btol=1e-14)
                        - tgt) ** 2)

    def loss_exact(b_):
        return jnp.sum((_closed_form(Ad, b_, damp) - tgt) ** 2)

    g1 = jax.grad(loss_solver)(b)
    g2 = jax.grad(loss_exact)(b)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-10)


def test_grad_operator_entries(problem):
    m, n, Ad, b, tgt = problem
    damp = 0.3
    g1 = jax.grad(lambda M: jnp.sum(
        (lsqr_grad(M, b, damp, atol=1e-14, btol=1e-14) - tgt) ** 2))(Ad)
    g2 = jax.grad(lambda M: jnp.sum(
        (_closed_form(M, b, damp) - tgt) ** 2))(Ad)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-9)


def test_grad_damp(problem):
    m, n, Ad, b, tgt = problem
    d0 = jnp.asarray(0.3)
    g1 = jax.grad(lambda d: jnp.sum(
        (lsqr_grad(Ad, b, d, atol=1e-14, btol=1e-14) - tgt) ** 2))(d0)
    g2 = jax.grad(lambda d: jnp.sum(
        (_closed_form(Ad, b, d) - tgt) ** 2))(d0)
    np.testing.assert_allclose(float(g1), float(g2), rtol=1e-9)


def test_grad_coo_vals_finite_difference(rng, problem):
    """Gradients flow to sparse COO values; spot-check by central
    differences."""
    m, n, _, b, tgt = problem
    damp = 0.3
    nnz = 120
    rr = rng.integers(0, m, nnz)
    cc = rng.integers(0, n, nnz)
    vv = jnp.asarray(rng.standard_normal(nnz))

    def loss(v):
        A = lt.coo_operator(m, n, v, rr, cc)
        return jnp.sum((lsqr_grad(A, b, damp, atol=1e-14, btol=1e-14)
                        - tgt) ** 2)

    gv = jax.grad(loss)(vv)
    for i in (0, 7, 42):
        e = 1e-6
        fd = (loss(vv.at[i].add(e)) - loss(vv.at[i].add(-e))) / (2 * e)
        assert abs(float(gv[i]) - float(fd)) < 1e-5


def test_grad_dia_stripes(rng):
    """Gradients flow to DIA stripes (the structured fast path's arrays)."""
    from lsqr_tpu.ops.structured import DIAOperator, dia_operator

    m = n = 60
    offsets = (-1, 0, 1)
    data0 = rng.standard_normal((3, m))
    data0[1] += 4.0
    base = dia_operator(m, n, offsets, data0)
    b = jnp.asarray(rng.standard_normal(m))
    tgt = jnp.asarray(rng.standard_normal(n))

    def _shift(row, k):
        # transpose stripe: tdata[j, c] = A[c - k, c] = data[j, c - k]
        if k >= 0:
            return jnp.pad(row[: n - k], (k, 0))
        return jnp.pad(row[-k:], (0, -k))

    def loss(data):
        # rebuild the operator from (traced) stripes; the transpose stripes
        # must track data, so rebuild them with the same packing rule
        import dataclasses

        tdata = jnp.stack([_shift(data[j], offsets[j]) for j in range(3)])
        A = dataclasses.replace(base, data=data, tdata=tdata)
        x = lsqr_grad(A, b, 0.2, atol=1e-14, btol=1e-14)
        return jnp.sum((x - tgt) ** 2)

    g = jax.grad(loss)(jnp.asarray(data0))
    # central-difference spot checks
    for (j, i) in ((0, 5), (1, 30), (2, 50)):
        e = 1e-6
        dp = jnp.asarray(data0).at[j, i].add(e)
        dm = jnp.asarray(data0).at[j, i].add(-e)
        fd = (loss(dp) - loss(dm)) / (2 * e)
        assert abs(float(g[j, i]) - float(fd)) < 1e-4, (j, i)
