"""Operator-layer tests: every format must agree exactly with the COO
reference implementation (which itself is validated against dense), and all
must satisfy the adjoint dot-product test (acheck) — the same consistency
property the reference enforces on user aprods
(/root/reference/src/lsqr.f90:908-994)."""

import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.models.synthetic import block_banded_coo
from lsqr_tpu.ops.structured import (
    block_ell_operator,
    dia_operator,
    ell_operator,
)


def _coo_triplets(rng, m, n, nnz):
    # unique coordinates so COO/dense comparisons are exact
    lin = rng.choice(m * n, size=min(nnz, m * n), replace=False)
    rows, cols = lin // n, lin % n
    vals = rng.standard_normal(len(lin))
    return vals, rows, cols


@pytest.mark.parametrize("shape", [(40, 30), (30, 30), (23, 57)])
def test_coo_matches_dense(rng, shape):
    m, n = shape
    vals, rows, cols = _coo_triplets(rng, m, n, 4 * m)
    A = lt.coo_operator(m, n, vals, rows, cols)
    dense = np.asarray(A.todense())
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(np.asarray(A.matvec(x)), dense @ x, atol=1e-12)
    np.testing.assert_allclose(np.asarray(A.rmatvec(y)), dense.T @ y, atol=1e-12)
    assert int(lt.acheck(A).inform) == 0


@pytest.mark.parametrize("shape", [(64, 48), (48, 64), (50, 50)])
def test_dia_matches_coo(rng, shape):
    m, n = shape
    offsets = [-7, -3, -1, 0, 1, 2, 5, 11]
    data = rng.standard_normal((len(offsets), m))
    A = dia_operator(m, n, offsets, data)
    dense = np.asarray(A.todense())
    # reference dense built independently
    ref = np.zeros((m, n))
    for j, k in enumerate(offsets):
        for i in range(m):
            if 0 <= i + k < n:
                ref[i, i + k] = data[j, i]
    np.testing.assert_allclose(dense, ref, atol=1e-14)
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(np.asarray(A.matvec(x)), ref @ x, atol=1e-11)
    np.testing.assert_allclose(np.asarray(A.rmatvec(y)), ref.T @ y, atol=1e-11)
    assert int(lt.acheck(A).inform) == 0


@pytest.mark.parametrize("shape", [(40, 30), (30, 41)])
def test_ell_matches_coo(rng, shape):
    m, n = shape
    vals, rows, cols = _coo_triplets(rng, m, n, 5 * m)
    coo = lt.coo_operator(m, n, vals, rows, cols)
    ell = ell_operator(m, n, vals, rows, cols)
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(
        np.asarray(ell.matvec(x)), np.asarray(coo.matvec(x)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ell.rmatvec(y)), np.asarray(coo.rmatvec(y)), atol=1e-12
    )
    assert int(lt.acheck(ell).inform) == 0


@pytest.mark.parametrize("block", [(8, 8), (16, 8)])
def test_block_ell_matches_coo(rng, block):
    m, n = 64, 48
    vals, rows, cols = block_banded_coo(m, n, block=8, band_blocks=1, seed=3, dtype=np.float64)
    coo = lt.coo_operator(m, n, vals, rows, cols)
    bell = block_ell_operator(m, n, vals, rows, cols, block=block)
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(
        np.asarray(bell.matvec(x)), np.asarray(coo.matvec(x)), atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(bell.rmatvec(y)), np.asarray(coo.rmatvec(y)), atol=1e-11
    )
    assert int(lt.acheck(bell).inform) == 0


def test_solver_agrees_across_formats(rng):
    """Full solve must give the same answer whichever storage format holds
    the same matrix."""
    m, n = 96, 64
    vals, rows, cols = block_banded_coo(m, n, block=8, band_blocks=1, seed=5, dtype=np.float64)
    b = rng.standard_normal(m)
    results = {}
    for name, op in {
        "coo": lt.coo_operator(m, n, vals, rows, cols),
        "ell": ell_operator(m, n, vals, rows, cols),
        "bell": block_ell_operator(m, n, vals, rows, cols, block=(8, 8)),
        "dense": lt.DenseOperator(a=jnp.asarray(
            np.asarray(lt.coo_operator(m, n, vals, rows, cols).todense())
        )),
    }.items():
        results[name] = lt.lsqr(op, b, 0.1, atol=1e-10, btol=1e-10, itnlim=300)
    x0 = np.asarray(results["coo"].x)
    for name, res in results.items():
        assert int(res.istop) == int(results["coo"].istop), name
        np.testing.assert_allclose(np.asarray(res.x), x0, atol=1e-8, err_msg=name)


def test_transpose_operator(rng):
    m, n = 30, 20
    vals, rows, cols = _coo_triplets(rng, m, n, 100)
    A = lt.coo_operator(m, n, vals, rows, cols)
    At = A.T
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(
        np.asarray(At.matvec(y)), np.asarray(A.rmatvec(y)), atol=1e-14
    )
    np.testing.assert_allclose(
        np.asarray(At.rmatvec(x)), np.asarray(A.matvec(x)), atol=1e-14
    )
    assert At.shape == (n, m)


def test_callback_operator(rng):
    """Bring-your-own aprod (the reference's abstract-class path,
    lsqr.f90:16-30)."""
    dense = rng.standard_normal((25, 10))
    a = jnp.asarray(dense)
    op = lt.CallbackOperator(
        m=25, n=10, _matvec=lambda x: a @ x, _rmatvec=lambda y: a.T @ y
    )
    assert int(lt.acheck(op, eps=2.2e-16).inform) == 0
    b = rng.standard_normal(25)
    res = lt.lsqr(op, jnp.asarray(b), 0.0, atol=1e-10, btol=1e-10, itnlim=100)
    xref, *_ = np.linalg.lstsq(dense, b, rcond=None)
    np.testing.assert_allclose(np.asarray(res.x), xref, atol=1e-8)


def test_dia_bf16_storage(rng):
    """bf16 stripe STORAGE: products accumulate/return f32; values agree
    with the f32 operator to bf16 rounding; solver dtype stays f32."""
    import jax.numpy as jnp

    m, n = 300, 260
    offs = (-2, 0, 1, 4)
    stripes = rng.standard_normal((len(offs), m)).astype(np.float32)
    A32 = lt.dia_operator(m, n, offs, stripes)
    A16 = lt.dia_operator(m, n, offs, stripes, storage_dtype="bfloat16")
    assert A16.data.dtype == jnp.bfloat16
    assert A16.dtype == jnp.float32      # downstream sees f32
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    mv16 = A16.matvec(jnp.asarray(x))
    rmv16 = A16.rmatvec(jnp.asarray(y))
    assert mv16.dtype == jnp.float32 and rmv16.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(mv16), np.asarray(A32.matvec(jnp.asarray(x))),
        rtol=2e-2, atol=2e-2,
    )
    np.testing.assert_allclose(
        np.asarray(rmv16), np.asarray(A32.rmatvec(jnp.asarray(y))),
        rtol=2e-2, atol=2e-2,
    )
    # adjoint consistency holds EXACTLY for the rounded matrix (both
    # products read the same bf16 values)
    assert int(lt.acheck(A16).inform) == 0
    # end-to-end: solve against the densified ROUNDED matrix
    dense16 = np.asarray(A16.todense(), np.float64)
    xt = rng.standard_normal(n)
    b = (dense16 @ xt).astype(np.float32)
    res = lt.lsqr(A16, b, atol=1e-5, btol=1e-5, itnlim=800)
    r = b - dense16 @ np.asarray(res.x, np.float64)
    assert np.linalg.norm(r) <= 1e-3 * np.linalg.norm(b)


def test_dia_bf16_storage_pallas_interpret(rng):
    """bf16 stripe storage with a f32 vector gives f32 output within bf16
    rounding of the f32 product, on both DIA layouts."""
    import jax.numpy as jnp

    m = n = 2048
    offs = (-1, 0, 3)
    stripes = rng.standard_normal((len(offs), m)).astype(np.float32)
    A32 = lt.dia_operator(m, n, offs, stripes)
    x = rng.standard_normal(n).astype(np.float32)
    for make in (lt.dia_operator, lt.dia_shared_operator):
        out = make(m, n, offs, stripes,
                   storage_dtype="bfloat16").matvec(jnp.asarray(x))
        assert out.dtype == jnp.float32
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(A32.matvec(jnp.asarray(x))),
            rtol=2e-2, atol=2e-2,
        )
