"""Batched multi-RHS solves and preconditioning/scaling helpers."""

import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.batch import lsqr_batch
from lsqr_tpu.ops.precondition import (
    column_norms,
    column_scaled,
    right_preconditioned,
)
from lsqr_tpu.ops.structured import dia_operator, ell_operator


def _problem(rng, m=80, n=50, nnz=400):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    return lt.coo_operator(m, n, vals, rows, cols)


def test_batch_matches_loop(rng):
    A = _problem(rng)
    B = rng.standard_normal((5, A.m))
    res = lsqr_batch(A, B, 0.1, atol=1e-10, btol=1e-10, itnlim=200)
    assert res.x.shape == (5, A.n)
    assert res.istop.shape == (5,)
    for i in range(5):
        ref = lt.lsqr(A, B[i], 0.1, atol=1e-10, btol=1e-10, itnlim=200)
        assert int(res.istop[i]) == int(ref.istop)
        assert int(res.itn[i]) == int(ref.itn)
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(ref.x), atol=1e-10
        )


def test_batch_per_problem_damp(rng):
    A = _problem(rng)
    b = rng.standard_normal(A.m)
    B = np.tile(b, (3, 1))  # same rhs so solution norms are comparable
    damps = np.array([0.0, 0.1, 1.0])
    res = lsqr_batch(A, B, damps, atol=1e-10, btol=1e-10, itnlim=200)
    # damped problems report istop 3, undamped 1/2
    assert int(res.istop[0]) in (1, 2)
    assert int(res.istop[1]) == 3
    assert int(res.istop[2]) == 3
    # stronger damping shrinks the solution
    norms = np.linalg.norm(np.asarray(res.x), axis=1)
    assert norms[2] < norms[1] <= norms[0] + 1e-9


def test_batch_validates_shape(rng):
    A = _problem(rng)
    with pytest.raises(ValueError):
        lsqr_batch(A, np.zeros((4, A.m + 1)))


def test_column_norms_per_format(rng):
    m, n = 60, 40
    nnz = 300
    # unique coordinates: column_norms requires deduplicated triplets
    lin = rng.choice(m * n, size=nnz, replace=False)
    rows, cols = lin // n, lin % n
    vals = rng.standard_normal(nnz)
    coo = lt.coo_operator(m, n, vals, rows, cols)
    dense = np.asarray(coo.todense())
    expect = np.linalg.norm(dense, axis=0)
    np.testing.assert_allclose(np.asarray(column_norms(coo)), expect, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(column_norms(lt.DenseOperator(a=jnp.asarray(dense)))),
        expect,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(column_norms(ell_operator(m, n, vals, rows, cols))),
        expect,
        atol=1e-12,
    )
    offs = [-2, 0, 3]
    data = rng.standard_normal((3, m))
    dia = dia_operator(m, n, offs, data)
    np.testing.assert_allclose(
        np.asarray(column_norms(dia)),
        np.linalg.norm(np.asarray(dia.todense()), axis=0),
        atol=1e-12,
    )


def test_column_scaling_improves_conditioning(rng):
    # badly column-scaled system
    m, n = 100, 30
    base = rng.standard_normal((m, n))
    scales = 10.0 ** rng.uniform(-6, 6, n)
    A = lt.DenseOperator(a=jnp.asarray(base * scales))
    b = rng.standard_normal(m)

    raw = lt.lsqr(A, b, 0.0, atol=1e-12, btol=1e-12, itnlim=2000)
    scaled_op, scale = column_scaled(A)
    pre = lt.lsqr(scaled_op, b, 0.0, atol=1e-12, btol=1e-12, itnlim=2000)
    x = np.asarray(scale) * np.asarray(pre.x)

    xref, *_ = np.linalg.lstsq(np.asarray(A.a), b, rcond=None)
    # scaled solve converges far faster and at least as accurately
    assert int(pre.itn) < int(raw.itn) / 2
    np.testing.assert_allclose(x, xref, atol=1e-6)


def test_right_preconditioning_recovers_solution(rng):
    m, n = 90, 40
    dense = rng.standard_normal((m, n))
    A = lt.DenseOperator(a=jnp.asarray(dense))
    b = rng.standard_normal(m)
    # use diag preconditioner M^-1 = diag(1/colnorm) as the M_inv operator
    scale = 1.0 / np.linalg.norm(dense, axis=0)
    M_inv = lt.DenseOperator(a=jnp.asarray(np.diag(scale)))
    B = right_preconditioned(A, M_inv)
    res = lt.lsqr(B, b, 0.0, atol=1e-12, btol=1e-12, itnlim=1000)
    x = np.asarray(M_inv.matvec(res.x))
    xref, *_ = np.linalg.lstsq(dense, b, rcond=None)
    np.testing.assert_allclose(x, xref, atol=1e-7)


def test_batch_bounded_matches_while_loop(rng):
    """The batched bounded runner (vmapped masked-fori segments) matches
    the vmapped while_loop solve and per-problem sequential solves."""
    from lsqr_tpu.ops.structured import dia_operator

    m = n = 96
    offsets = (-2, 0, 3)
    data = rng.standard_normal((len(offsets), m))
    A = dia_operator(m, n, offsets, data)
    B = rng.standard_normal((4, m))
    damp = np.array([0.0, 0.05, 0.2, 1.0])

    res_w = lsqr_batch(A, B, damp, atol=1e-10, btol=1e-10, itnlim=300,
                       wantse=True)
    res_b = lsqr_batch(A, B, damp, atol=1e-10, btol=1e-10, itnlim=300,
                       wantse=True, loop="bounded", loop_segment=32)
    np.testing.assert_array_equal(np.asarray(res_b.itn), np.asarray(res_w.itn))
    np.testing.assert_array_equal(np.asarray(res_b.istop),
                                  np.asarray(res_w.istop))
    # masked-fori and while_loop run the identical iteration body
    np.testing.assert_allclose(np.asarray(res_b.x), np.asarray(res_w.x),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(res_b.se), np.asarray(res_w.se),
                               rtol=1e-12, atol=1e-14)
    # and both match per-problem sequential solves
    for i in range(B.shape[0]):
        ref = lt.lsqr(A, B[i], float(damp[i]), atol=1e-10, btol=1e-10,
                      itnlim=300)
        np.testing.assert_allclose(np.asarray(res_b.x[i]), np.asarray(ref.x),
                                   atol=1e-9)


def test_batch_accepts_bounded_preferring_operator(rng):
    """An explicit ``loop="bounded"`` runs the bounded batched runner on an
    f32 DIA operator and matches the default while-loop batch (no operator
    steers the loop form any more: ``loop`` is the caller's choice)."""
    from lsqr_tpu.ops.structured import dia_operator

    m = n = 64
    data = rng.standard_normal((1, m)).astype(np.float32) + 3.0
    A = dia_operator(m, n, (0,), data)
    assert not hasattr(A, "prefers_bounded_loop")
    B = rng.standard_normal((3, m)).astype(np.float32)
    res = lsqr_batch(A, B, 0.01, atol=1e-6, btol=1e-6, itnlim=200,
                     loop="bounded", loop_segment=8)
    ref = lsqr_batch(A, B, 0.01, atol=1e-6, btol=1e-6, itnlim=200)
    np.testing.assert_array_equal(np.asarray(res.itn), np.asarray(ref.itn))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-5, atol=1e-6)


def test_preconditioning_composes_with_siblings(rng):
    """Column scaling is solver-agnostic (operator-level composition):
    LSMR and CGLS converge faster on the scaled operator and recover the
    same least-squares solution."""
    m, n = 120, 50
    dense = rng.standard_normal((m, n)) * np.logspace(0, 3, n)  # skewed cols
    A = lt.DenseOperator(a=jnp.asarray(dense))
    b = rng.standard_normal(m)
    xref, *_ = np.linalg.lstsq(dense, b, rcond=None)
    scaled_op, scale = column_scaled(A)

    for solver in (lt.lsmr, lt.cgls):
        raw = solver(A, b, atol=1e-12, btol=1e-12, itnlim=3000)
        pre = solver(scaled_op, b, atol=1e-12, btol=1e-12, itnlim=3000)
        x = np.asarray(scale) * np.asarray(pre.x)
        assert int(pre.itn) < int(raw.itn) / 2, solver.__name__
        np.testing.assert_allclose(x, xref, atol=1e-5,
                                   err_msg=solver.__name__)


def test_lsmr_batch_matches_sequential(rng):
    import jax.numpy as jnp

    from lsqr_tpu import lsmr, lsmr_batch

    m, n = 120, 80
    A = jnp.asarray(rng.standard_normal((m, n)))
    B = rng.standard_normal((4, m))
    damps = np.array([0.0, 0.05, 0.2, 0.0])
    res = lsmr_batch(A, B, damps, atol=1e-10, btol=1e-10)
    assert res.x.shape == (4, n)
    for i in range(4):
        ref = lsmr(A, B[i], float(damps[i]), atol=1e-10, btol=1e-10)
        assert int(res.istop[i]) == int(ref.istop)
        assert int(res.itn[i]) == int(ref.itn)
        np.testing.assert_allclose(np.asarray(res.x[i]),
                                   np.asarray(ref.x), atol=1e-9)


def test_cgls_batch_matches_sequential(rng):
    import jax.numpy as jnp

    from lsqr_tpu import cgls, cgls_batch

    m, n = 120, 80
    A = jnp.asarray(rng.standard_normal((m, n)))
    B = rng.standard_normal((3, m))
    res = cgls_batch(A, B, 0.1, atol=1e-9, btol=1e-9)
    assert res.x.shape == (3, n)
    for i in range(3):
        ref = cgls(A, B[i], 0.1, atol=1e-9, btol=1e-9)
        assert int(res.istop[i]) == int(ref.istop)
        np.testing.assert_allclose(np.asarray(res.x[i]),
                                   np.asarray(ref.x), atol=1e-8)


def test_lsmr_batch_bounded(rng):
    import jax.numpy as jnp

    from lsqr_tpu import lsmr_batch

    m = n = 100
    A = jnp.asarray(rng.standard_normal((m, n)) + 4 * np.eye(n))
    B = rng.standard_normal((3, m))
    ref = lsmr_batch(A, B, 0.01, atol=1e-9, btol=1e-9)
    res = lsmr_batch(A, B, 0.01, atol=1e-9, btol=1e-9,
                     loop="bounded", loop_segment=7)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    np.testing.assert_array_equal(np.asarray(res.itn), np.asarray(ref.itn))


def test_column_norms_shared_dia(rng):
    """column_norms has an analytic rule for the shared-stripe layout
    (round 5: the f32 auto default) matching the packed one."""
    from lsqr_tpu.ops.precondition import column_norms
    from lsqr_tpu.ops.structured import dia_operator, dia_shared_operator

    for m, n, offs in [(200, 200, (-4, -1, 0, 2, 5)),
                       (150, 202, (-7, 0, 6)), (202, 150, (-3, 0, 60))]:
        data = rng.standard_normal((len(offs), m))
        Ap = dia_operator(m, n, offs, data)
        As = dia_shared_operator(m, n, offs, data)
        np.testing.assert_allclose(np.asarray(column_norms(As)),
                                   np.asarray(column_norms(Ap)), rtol=1e-6)
