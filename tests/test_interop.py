"""scipy interop and auto-format selection tests."""

import numpy as np
import pytest
import scipy.sparse

import lsqr_tpu as lt
from lsqr_tpu.ops.interop import auto_operator, csr_operator, from_scipy
from lsqr_tpu.ops.structured import BlockELLOperator, DIAOperator, ELLOperator


def _check_matches(op, S, rng, atol=1e-10):
    x = rng.standard_normal(S.shape[1])
    y = rng.standard_normal(S.shape[0])
    np.testing.assert_allclose(np.asarray(op.matvec(x)), S @ x, atol=atol)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)), S.T @ y, atol=atol)


def test_from_scipy_formats(rng):
    S = scipy.sparse.random(120, 80, density=0.05, random_state=7)
    for fmt in (None, "ell", "coo"):
        op = from_scipy(S, format=fmt)
        _check_matches(op, S, rng)


def test_from_scipy_dia(rng):
    m = n = 200
    S = scipy.sparse.diags(
        [rng.standard_normal(m - 2), rng.standard_normal(m),
         rng.standard_normal(m - 3)],
        offsets=[-2, 0, 3],
        shape=(m, n),
    ).tocsr()
    op = from_scipy(S, format="dia")
    assert isinstance(op, DIAOperator)
    _check_matches(op, S, rng)
    # auto-detect should also choose DIA for a banded pattern
    op2 = from_scipy(S)
    assert isinstance(op2, DIAOperator)
    _check_matches(op2, S, rng)


def test_from_scipy_rectangular_dia(rng):
    S = scipy.sparse.diags(
        [np.ones(100), 2 * np.ones(100)], offsets=[0, 40], shape=(100, 140)
    ).tocsr()
    op = from_scipy(S, format="dia")
    _check_matches(op, S, rng)


def test_auto_operator_fallback_ell(rng):
    # uniform random pattern: not banded, not blocky -> the HYB fallback
    # (bounded-width ELL, possibly with a COO spill remainder when the
    # cost-balanced width beats padding every row to the max length)
    from lsqr_tpu.ops.compose import SumOperator
    from lsqr_tpu.ops.coo import COOOperator

    m, n, nnz = 3000, 2000, 4000
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    op = auto_operator(m, n, vals, rows, cols)
    if isinstance(op, SumOperator):
        assert isinstance(op.ops[0], ELLOperator)
        assert isinstance(op.ops[1], COOOperator)
        # width selection follows the byte cost model (SPILL_COST=1.5:
        # a spilled COO entry stores 1.5x a streamed ELL slot): the
        # chosen split must not cost more than pure max-width ELL
        w = op.ops[0].vals.shape[1]
        spilled = op.ops[1].nnz
        counts = np.bincount(rows, minlength=m)
        wmax = int(counts.max())
        assert m * w + 1.5 * spilled <= m * wmax + 1e-9
    else:
        assert isinstance(op, ELLOperator)
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    _check_matches(op, S, rng)


def test_auto_operator_blocky_gate(rng):
    # a genuinely blocky small-n pattern keeps its BlockELL route, while
    # an unstructured pattern in the same (m, n) regime fails BlockELL's
    # fill check and lands on HYB, with correct products
    from lsqr_tpu.ops.interop import _block_fill_ratio
    from lsqr_tpu.ops.structured import BlockELLOperator

    m, n, per = 16384, 2048, 4915  # ~30%-dense (128,128) diagonal blocks
    rows, cols = [], []
    for bi in range(m // 128):
        rows.append(bi * 128 + rng.integers(0, 128, per))
        cols.append((bi % (n // 128)) * 128 + rng.integers(0, 128, per))
    r2 = np.concatenate(rows)
    c2 = np.concatenate(cols)
    assert _block_fill_ratio(r2, c2, m, n) <= 4.0
    vals = rng.standard_normal(len(r2)).astype(np.float32)
    assert isinstance(auto_operator(m, n, vals, r2, c2), BlockELLOperator)

    r3 = rng.integers(0, m, 40000)
    c3 = rng.integers(0, n, 40000)
    assert _block_fill_ratio(r3, c3, m, n) > 4.0
    v3 = rng.standard_normal(40000).astype(np.float32)
    op = auto_operator(m, n, v3, r3, c3)
    assert not isinstance(op, BlockELLOperator)
    S = scipy.sparse.coo_matrix((v3, (r3, c3)), shape=(m, n)).tocsr()
    _check_matches(op, S, rng, atol=1e-4)


def test_csr_operator(rng):
    S = scipy.sparse.random(90, 70, density=0.08, random_state=3).tocsr()
    op = csr_operator(90, 70, S.indptr, S.indices, S.data)
    _check_matches(op, S, rng)


def test_solve_via_scipy_matrix(rng):
    S = scipy.sparse.random(150, 60, density=0.1, random_state=11).tocsr()
    b = rng.standard_normal(150)
    op = from_scipy(S)
    res = lt.lsqr(op, b, 0.0, atol=1e-10, btol=1e-10, itnlim=400)
    ref = scipy.sparse.linalg.lsqr(S, b, atol=1e-10, btol=1e-10, iter_lim=400)
    np.testing.assert_allclose(np.asarray(res.x), ref[0], atol=1e-6)


def test_lsqr_scipy_drop_in(rng):
    """The scipy-compatible wrapper returns scipy's exact 10-tuple shape
    with matching values (including calc_var) on a damped LS problem."""
    import scipy.sparse
    import scipy.sparse.linalg

    from lsqr_tpu.ops.interop import lsqr_scipy

    m, n, nnz = 400, 150, 3000
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n))
    b = rng.standard_normal(m)

    ours = lsqr_scipy(S, b, damp=0.1, atol=1e-9, btol=1e-9, calc_var=True)
    ref = scipy.sparse.linalg.lsqr(S, b, damp=0.1, atol=1e-9, btol=1e-9,
                                   calc_var=True)
    assert len(ours) == 10
    x, istop, itn, r1, r2, anorm, acond, arnorm, xnorm, var = ours
    assert istop == ref[1] and itn == ref[2]
    np.testing.assert_allclose(x, ref[0], atol=1e-8)
    np.testing.assert_allclose(r1, ref[3], rtol=1e-8)
    np.testing.assert_allclose(r2, ref[4], rtol=1e-8)
    np.testing.assert_allclose(anorm, ref[5], rtol=1e-6)
    np.testing.assert_allclose(acond, ref[6], rtol=1e-3)
    np.testing.assert_allclose(arnorm, ref[7], rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(xnorm, ref[8], rtol=1e-8)
    # cross-implementation accumulation noise in the (w/rho)^2 sum
    np.testing.assert_allclose(var, ref[9], rtol=1e-3, atol=1e-12)


def test_lsqr_scipy_undamped_var(rng):
    import scipy.sparse
    import scipy.sparse.linalg

    from lsqr_tpu.ops.interop import lsqr_scipy

    m, n, nnz = 300, 80, 2000
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n))
    b = rng.standard_normal(m)
    ours = lsqr_scipy(S, b, atol=1e-10, btol=1e-10, calc_var=True)
    ref = scipy.sparse.linalg.lsqr(S, b, atol=1e-10, btol=1e-10,
                                   calc_var=True)
    assert ours[1] == ref[1] and ours[2] == ref[2]
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-8)
    np.testing.assert_allclose(ours[9], ref[9], rtol=1e-3, atol=1e-12)


def test_auto_operator_compact_dia(rng):
    """Banded routing by dtype (round 5): f64 keeps the packed DIA form
    (x64 conformance), f32 defaults to the shared-stripe form (the GPU
    pair kernel's layout, half the operator memory), and compact=True forces shared
    for f64 too (see test_dia_shared.py)."""
    from lsqr_tpu.ops.interop import auto_operator
    from lsqr_tpu.ops.structured import DIAOperator, DIASharedOperator

    m = n = 200
    rows = np.concatenate([np.arange(m), np.arange(1, m)])
    cols = np.concatenate([np.arange(m), np.arange(1, m) - 1])
    vals = rng.standard_normal(len(rows))
    packed = auto_operator(m, n, vals, rows, cols)
    compact = auto_operator(m, n, vals, rows, cols, compact=True)
    shared32 = auto_operator(m, n, vals.astype(np.float32), rows, cols)
    assert isinstance(packed, DIAOperator)
    assert isinstance(compact, DIASharedOperator)
    assert isinstance(shared32, DIASharedOperator)
    np.testing.assert_array_equal(np.asarray(packed.todense()),
                                  np.asarray(compact.todense()))
    np.testing.assert_allclose(np.asarray(packed.todense()),
                               np.asarray(shared32.todense()), atol=1e-7)


def test_lsmr_scipy_drop_in(rng):
    """lsmr_scipy returns scipy.sparse.linalg.lsmr's exact 8-tuple shape
    with matching values on a live scipy run."""
    import scipy.sparse
    import scipy.sparse.linalg

    from lsqr_tpu.ops.interop import lsmr_scipy

    m, n = 120, 60
    dense = rng.standard_normal((m, n))
    S = scipy.sparse.csr_matrix(dense)
    b = rng.standard_normal(m)
    ours = lsmr_scipy(S, b, damp=0.1, atol=1e-9, btol=1e-9)
    ref = scipy.sparse.linalg.lsmr(S, b, damp=0.1, atol=1e-9, btol=1e-9)
    assert len(ours) == len(ref) == 8
    assert ours[1] == ref[1] and ours[2] == ref[2]  # istop, itn exact
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-8)
    # the norm/condition ESTIMATES accumulate in different reduction
    # orders (jnp vs numpy) — compare at estimate precision; x/istop/itn
    # above are the strict part of the contract
    for i in (3, 4, 5, 7):  # normr, normar, norma, normx
        np.testing.assert_allclose(ours[i], ref[i], rtol=1e-3)
    # conda (maxrbar/minrbar ratio) is the most rounding-sensitive
    # estimate: observed ~0.3% drift from reduction order
    np.testing.assert_allclose(ours[6], ref[6], rtol=1e-2)


def test_from_matrix_market_sparse_and_dense(tmp_path, rng):
    import jax.numpy as jnp
    import scipy.io
    import scipy.sparse
    import scipy.sparse.linalg

    from lsqr_tpu import from_matrix_market, lsqr

    m, n, nnz = 40, 25, 150
    r = rng.integers(0, m, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    S = scipy.sparse.coo_matrix((v, (r, c)), shape=(m, n))
    S.sum_duplicates()
    p = tmp_path / "test.mtx"
    scipy.io.mmwrite(str(p), S)
    A = from_matrix_market(p)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(A.matvec(jnp.asarray(x))), S @ x,
                               rtol=1e-10)
    b = rng.standard_normal(m)
    res = lsqr(A, jnp.asarray(b), atol=1e-10, btol=1e-10)
    ref = scipy.sparse.linalg.lsqr(S.tocsr(), b, atol=1e-10, btol=1e-10)
    np.testing.assert_allclose(np.asarray(res.x), ref[0], atol=1e-7)

    # dense array .mtx -> DenseOperator
    D = rng.standard_normal((6, 4))
    pd = tmp_path / "dense.mtx"
    scipy.io.mmwrite(str(pd), D)
    Ad = from_matrix_market(pd)
    np.testing.assert_allclose(
        np.asarray(Ad.matvec(jnp.ones(4))), D @ np.ones(4), rtol=1e-12
    )

    # complex .mtx loads as a complex operator (the core solver family
    # supports complex; the reference is real-only, lsqr_kinds.F90:16-24)
    pc = tmp_path / "cplx.mtx"
    Dc = (D + 2j * rng.standard_normal((6, 4))).astype(np.complex128)
    scipy.io.mmwrite(str(pc), Dc)
    Ac = from_matrix_market(pc)
    y = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    np.testing.assert_allclose(
        np.asarray(Ac.rmatvec(jnp.asarray(y))), Dc.conj().T @ y, rtol=1e-10
    )


# ---------------------------------------------------------------------------
# jax.experimental.sparse (BCOO/BCSR) bridge
# ---------------------------------------------------------------------------

def _random_bcoo(rng, m=60, n=40, nnz=300):
    from jax.experimental import sparse as jsparse
    import jax.numpy as jnp

    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    mat = jsparse.BCOO(
        (jnp.asarray(vals), jnp.asarray(np.stack([rows, cols], 1))),
        shape=(m, n),
    )
    return mat, dense


def test_from_bcoo_matches_dense(rng):
    mat, dense = _random_bcoo(rng)
    A = lt.from_bcoo(mat)
    x = rng.standard_normal(dense.shape[1])
    y = rng.standard_normal(dense.shape[0])
    np.testing.assert_allclose(np.asarray(A.matvec(x)), dense @ x, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(A.rmatvec(y)), dense.T @ y, rtol=1e-10)


def test_from_bcoo_solve_matches_scipy(rng):
    mat, dense = _random_bcoo(rng, m=80, n=30, nnz=400)
    A = lt.from_bcoo(mat)
    b = rng.standard_normal(80)
    res = lt.lsqr(A, b, 0.1, atol=1e-10, btol=1e-10)
    ref = scipy.sparse.linalg.lsqr(
        scipy.sparse.csr_matrix(dense), b, damp=0.1, atol=1e-10, btol=1e-10
    )
    # the packed format's reduction order differs from scipy CSR's, so the
    # stopping test can trip one iteration apart
    assert abs(int(res.itn) - ref[2]) <= 1
    np.testing.assert_allclose(np.asarray(res.x), ref[0], atol=1e-8)


def test_from_bcoo_bcsr_and_formats(rng):
    from jax.experimental import sparse as jsparse

    mat, dense = _random_bcoo(rng)
    bcsr = jsparse.BCSR.from_bcoo(mat.sort_indices())
    A = lt.from_bcoo(bcsr, format="coo")
    x = rng.standard_normal(dense.shape[1])
    np.testing.assert_allclose(np.asarray(A.matvec(x)), dense @ x, rtol=1e-10)
    for fmt in ("ell", "block"):
        Af = lt.from_bcoo(mat, format=fmt)
        np.testing.assert_allclose(
            np.asarray(Af.matvec(x)), dense @ x, rtol=1e-10
        )


def test_from_bcoo_duplicates_summed(rng):
    from jax.experimental import sparse as jsparse
    import jax.numpy as jnp

    # duplicate coordinates must accumulate, matching COO semantics
    # (reference scatter-accumulate, lsqr.f90:168-172)
    idx = np.array([[0, 0], [0, 0], [1, 2], [2, 1]])
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    mat = jsparse.BCOO((jnp.asarray(vals), jnp.asarray(idx)), shape=(3, 3))
    dense = np.zeros((3, 3))
    np.add.at(dense, (idx[:, 0], idx[:, 1]), vals)
    A = lt.from_bcoo(mat)
    x = np.arange(1.0, 4.0)
    np.testing.assert_allclose(np.asarray(A.matvec(x)), dense @ x, rtol=1e-12)


def test_from_bcoo_rejects_batched(rng):
    from jax.experimental import sparse as jsparse
    import jax.numpy as jnp

    dense = jnp.asarray(rng.standard_normal((2, 4, 5)))
    batched = jsparse.BCOO.fromdense(dense, n_batch=1)
    with pytest.raises(ValueError, match="unbatched"):
        lt.from_bcoo(batched)


def test_hyb_power_law_columns_take_coo(rng):
    """HYB caps the row padding only; a power-law COLUMN distribution would
    pad the transpose ELL to the heaviest column, so it takes COO, with
    correct products."""
    from lsqr_tpu.ops.coo import COOOperator
    from lsqr_tpu.ops.structured import hyb_operator

    m, n, per_row = 4096, 1024, 8
    cols = np.minimum(rng.zipf(1.1, m * per_row) - 1, n - 1)
    rows = np.repeat(np.arange(m), per_row)
    vals = rng.standard_normal(m * per_row).astype(np.float32)
    op = hyb_operator(m, n, vals, rows, cols)
    assert isinstance(op, COOOperator)
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    _check_matches(op, S, rng, atol=1e-4)
