"""Operator algebra (ops/compose.py): vstack/hstack/scale/diagonal
composites and general-form Tikhonov — the generalization of the
reference's built-in damp (L = I special case, lsqr.f90:264-273)."""

import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.diagnostics import acheck


def _rand_dense_op(rng, m, n):
    M = rng.standard_normal((m, n))
    return lt.as_operator(jnp.asarray(M)), M


def test_vstack_matches_dense(rng):
    A, Ad = _rand_dense_op(rng, 30, 20)
    B, Bd = _rand_dense_op(rng, 10, 20)
    S = lt.vstack_operators([A, B])
    assert S.shape == (40, 20)
    dense = np.vstack([Ad, Bd])
    x = rng.standard_normal(20)
    y = rng.standard_normal(40)
    np.testing.assert_allclose(np.asarray(S.matvec(x)), dense @ x, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(S.rmatvec(y)), dense.T @ y, rtol=1e-12
    )
    assert acheck(S).inform == 0


def test_hstack_matches_dense(rng):
    A, Ad = _rand_dense_op(rng, 25, 15)
    B, Bd = _rand_dense_op(rng, 25, 7)
    S = lt.hstack_operators([A, B])
    assert S.shape == (25, 22)
    dense = np.hstack([Ad, Bd])
    x = rng.standard_normal(22)
    y = rng.standard_normal(25)
    np.testing.assert_allclose(np.asarray(S.matvec(x)), dense @ x, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(S.rmatvec(y)), dense.T @ y, rtol=1e-12
    )
    assert acheck(S).inform == 0


def test_stack_validation(rng):
    A, _ = _rand_dense_op(rng, 5, 4)
    B, _ = _rand_dense_op(rng, 5, 3)
    with pytest.raises(ValueError, match="share n"):
        lt.vstack_operators([A, B])
    C, _ = _rand_dense_op(rng, 4, 4)
    with pytest.raises(ValueError, match="share m"):
        lt.hstack_operators([A, C])


def test_scaled_and_diagonal(rng):
    A, Ad = _rand_dense_op(rng, 12, 9)
    S = lt.scale_operator(A, 2.5)
    x = rng.standard_normal(9)
    np.testing.assert_allclose(
        np.asarray(S.matvec(x)), 2.5 * (Ad @ x), rtol=1e-12
    )
    d = rng.standard_normal(9)
    D = lt.diagonal_operator(d)
    np.testing.assert_allclose(np.asarray(D.matvec(x)), d * x, rtol=1e-12)
    assert acheck(D).inform == 0


def test_tikhonov_identity_matches_damp(rng):
    """With L = I, tikhonov(lam) must agree with the built-in damp=lam
    (the reference's special case)."""
    m, n = 40, 25
    A, _ = _rand_dense_op(rng, m, n)
    b = rng.standard_normal(m)
    lam = 0.3
    ref = lt.lsqr(A, b, lam, atol=1e-12, btol=1e-12)
    L = lt.diagonal_operator(jnp.ones(n))
    res = lt.tikhonov(A, b, L, lam, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(ref.x), rtol=1e-8, atol=1e-10
    )


def test_tikhonov_general_form_oracle(rng):
    """General L (first differences): compare against the dense
    normal-equations solution (A'A + lam^2 L'L) x = A'b."""
    m, n = 50, 30
    A, Ad = _rand_dense_op(rng, m, n)
    b = rng.standard_normal(m)
    lam = 0.7
    Ld = np.zeros((n - 1, n))
    Ld[np.arange(n - 1), np.arange(n - 1)] = -1.0
    Ld[np.arange(n - 1), np.arange(1, n)] = 1.0
    L = lt.as_operator(jnp.asarray(Ld))
    x_oracle = np.linalg.solve(
        Ad.T @ Ad + lam * lam * (Ld.T @ Ld), Ad.T @ b
    )
    for solver in ("lsqr", "lsmr", "cgls"):
        res = lt.tikhonov(A, b, L, lam, solver=solver,
                          atol=1e-12, btol=1e-12)
        np.testing.assert_allclose(
            np.asarray(res.x), x_oracle, rtol=1e-6, atol=1e-7
        )


def test_stacked_structured_blocks(rng):
    """Stacks compose with the structured fast-path operators: a DIA block
    over a diagonal regularizer solves like the dense equivalent."""
    from lsqr_tpu.ops.structured import dia_operator

    m = n = 200
    data = rng.standard_normal((3, m))
    data[1] += 4.0
    A = dia_operator(m, n, (-1, 0, 1), data)
    L = lt.diagonal_operator(jnp.full((n,), 0.5, A.dtype))
    S = lt.vstack_operators([A, L])
    dense = np.vstack([np.asarray(A.todense()), 0.5 * np.eye(n)])
    b = rng.standard_normal(m + n)
    ref = np.linalg.lstsq(dense, b, rcond=None)[0]
    res = lt.lsqr(S, b, atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(np.asarray(res.x), ref, rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# SumOperator / HYB (bounded-width ELL + COO spill)
# ---------------------------------------------------------------------------

def _powerlaw_coo(rng, m=300, n=200):
    """A power-law row-length distribution: most rows have ~3 entries, a
    few have ~n/2 — the documented ELL padding-blowup case."""
    rows, cols, vals = [], [], []
    for i in range(m):
        k = 3 if i % 50 else n // 2
        c = rng.choice(n, k, replace=False)
        rows.extend([i] * k)
        cols.extend(c.tolist())
        vals.extend(rng.standard_normal(k).tolist())
    rows = np.array(rows)
    cols = np.array(cols)
    vals = np.array(vals)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    return rows, cols, vals, dense


def test_sum_operator_products_and_acheck(rng):
    from lsqr_tpu.ops.compose import add_operators

    m, n = 40, 30
    A1 = rng.standard_normal((m, n))
    A2 = rng.standard_normal((m, n))
    op = add_operators([A1, A2])
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(np.asarray(op.matvec(x)), (A1 + A2) @ x,
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)), (A1 + A2).T @ y,
                               rtol=1e-12)
    assert int(lt.acheck(op).inform) == 0
    with pytest.raises(ValueError, match="share"):
        add_operators([A1, rng.standard_normal((m, n + 1))])


def test_hyb_operator_matches_dense_and_solves(rng):
    from lsqr_tpu.ops.compose import SumOperator
    from lsqr_tpu.ops.structured import hyb_operator

    rows, cols, vals, dense = _powerlaw_coo(rng)
    m, n = dense.shape
    A = hyb_operator(m, n, vals, rows, cols)
    assert isinstance(A, SumOperator)  # heavy rows spilled to COO
    # the ELL part's padded width is bounded, not max-row-length
    ell = A.ops[0]
    assert ell.vals.shape[1] < n // 2
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(np.asarray(A.matvec(x)), dense @ x, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(A.rmatvec(y)), dense.T @ y,
                               rtol=1e-10)
    b = rng.standard_normal(m)
    res = lt.lsqr(A, b, 0.1, atol=1e-10, btol=1e-10)
    import scipy.sparse
    import scipy.sparse.linalg

    ref = scipy.sparse.linalg.lsqr(
        scipy.sparse.csr_matrix(dense), b, damp=0.1, atol=1e-10, btol=1e-10
    )
    np.testing.assert_allclose(np.asarray(res.x), ref[0], atol=1e-7)


def test_hyb_flat_rows_degenerates_to_pure_ell(rng):
    from lsqr_tpu.ops.structured import ELLOperator, hyb_operator

    m, n, k = 100, 80, 4
    rows = np.repeat(np.arange(m), k)
    cols = rng.integers(0, n, m * k)
    vals = rng.standard_normal(m * k)
    A = hyb_operator(m, n, vals, rows, cols)
    assert isinstance(A, ELLOperator)  # no spill for a flat distribution


def test_auto_operator_routes_powerlaw_to_hyb(rng):
    from lsqr_tpu.ops.compose import SumOperator

    rows, cols, vals, dense = _powerlaw_coo(rng)
    m, n = dense.shape
    A = lt.auto_operator(m, n, vals, rows, cols)
    assert isinstance(A, SumOperator)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(A.matvec(x)), dense @ x, rtol=1e-10)


def test_hyb_rejects_complex(rng):
    # combining HYB with complex would silently drop imaginary parts in the
    # ELL part's native packing (ADVICE.md round 3) — must hard-error
    from lsqr_tpu.ops.structured import hyb_operator

    rows, cols, vals, dense = _powerlaw_coo(rng)
    m, n = dense.shape
    with pytest.raises(ValueError, match="real-only"):
        hyb_operator(m, n, vals.astype(np.complex128) * (1 + 1j), rows, cols)


def test_hyb_width_includes_w1_boundary():
    # cost(w) is convex piecewise-linear; with many EMPTY rows and a few
    # moderately-heavy ones its minimum sits at the w=1 boundary, below the
    # smallest distinct row length (ADVICE.md round 3): 10 rows of 5 entries
    # in 1000 rows -> cost(1) = 1000 + 8*40 = 1320 < cost(5) = 5000
    from lsqr_tpu.ops.compose import SumOperator
    from lsqr_tpu.ops.structured import hyb_operator

    m, n = 1000, 64
    rows = np.repeat(np.arange(10) * 100, 5)
    cols = np.tile(np.arange(5), 10)
    vals = np.arange(50, dtype=np.float64) + 1.0
    A = hyb_operator(m, n, vals, rows, cols)
    assert isinstance(A, SumOperator)
    assert A.ops[0].vals.shape[1] == 1  # ELL width at the boundary
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    x = np.linspace(-1.0, 1.0, n)
    np.testing.assert_allclose(np.asarray(A.matvec(x)), dense @ x, rtol=1e-12)
    y = np.linspace(1.0, 2.0, m)
    np.testing.assert_allclose(np.asarray(A.rmatvec(y)), dense.T @ y,
                               rtol=1e-12)
