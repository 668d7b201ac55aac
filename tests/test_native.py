"""Native C++ runtime tests (lsqr_tpu/native/sparse_pack.cpp): every packer
must agree with its numpy fallback / scipy, both code paths must work, and
the guards must hold."""

import numpy as np
import pytest
import scipy.sparse

from lsqr_tpu import native


@pytest.fixture
def triplets(rng):
    m, n, nnz = 300, 200, 2500
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz)
    return m, n, rows, cols, vals


def test_native_library_builds():
    assert native.available(), "C++ toolchain present but library failed to build"


def test_ell_pack_matches_numpy(triplets):
    m, n, rows, cols, vals = triplets
    ev, ec = native.ell_pack(rows, cols, vals, m)
    fv, fc = native._ell_pack_np(rows, cols, vals, m)
    assert ev.shape == fv.shape
    # per-row multisets must agree (slot order is an implementation detail)
    for r in range(m):
        a = sorted(zip(ec[r].tolist(), ev[r].tolist()))
        b = sorted(zip(fc[r].tolist(), fv[r].tolist()))
        assert a == b, f"row {r}"


def test_csr_matches_scipy(triplets):
    m, n, rows, cols, vals = triplets
    rows, cols, vals = native.coo_dedup(rows, cols, vals)
    indptr, ccols, cvals = native.csr_from_coo(rows, cols, vals, m)
    S = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    np.testing.assert_array_equal(indptr, S.indptr)
    D = scipy.sparse.csr_matrix((cvals, ccols, indptr), shape=(m, n)).toarray()
    np.testing.assert_allclose(D, S.toarray())


def test_dedup_sums_duplicates():
    rows = np.array([3, 1, 3, 1], np.int32)
    cols = np.array([2, 0, 2, 0], np.int32)
    vals = np.array([1.0, 2.0, 4.0, 8.0])
    r, c, v = native.coo_dedup(rows, cols, vals)
    assert r.tolist() == [1, 3]
    assert c.tolist() == [0, 2]
    assert v.tolist() == [10.0, 5.0]


def test_dedup_f32(rng):
    rows = rng.integers(0, 50, 400).astype(np.int32)
    cols = rng.integers(0, 50, 400).astype(np.int32)
    vals = rng.standard_normal(400).astype(np.float32)
    r, c, v = native.coo_dedup(rows, cols, vals)
    dense_ref = np.zeros((50, 50), np.float64)
    np.add.at(dense_ref, (rows, cols), vals.astype(np.float64))
    dense = np.zeros((50, 50), np.float64)
    dense[r, c] = v
    np.testing.assert_allclose(dense, dense_ref, atol=1e-5)


def test_block_pack_matches_numpy(triplets):
    m, n, rows, cols, vals = triplets
    bh = bw = 16
    mb = -(-m // bh)
    stride = 1024
    b1, c1 = native.block_pack(rows, cols, vals, mb, bh, bw, stride)
    b2, c2 = native._block_pack_np(rows, cols, vals, mb, bh, bw, stride)

    def dens(blocks, bcols):
        d = np.zeros((mb * bh, stride * bw))
        for r in range(mb):
            for k in range(blocks.shape[1]):
                c = int(bcols[r, k])
                d[r * bh : (r + 1) * bh, c * bw : (c + 1) * bw] += blocks[r, k]
        return d

    np.testing.assert_allclose(dens(b1, c1), dens(b2, c2))


def test_block_pack_rejects_nonblocky(rng):
    """Uniform random sparsity densifies blocked storage; the guard must
    refuse rather than allocate a huge array."""
    nnz = 50_000
    rows = rng.integers(0, 100_000, nnz).astype(np.int32)
    cols = rng.integers(0, 100_000, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz)
    with pytest.raises(ValueError, match="not * blocky|blocky"):
        native.block_pack(rows, cols, vals, -(-100_000 // 128), 128, 128, 1024)


def test_operators_use_native(rng):
    """ELL/BlockELL builders must produce identical operators through the
    native path (guarded by test_native_library_builds)."""
    import jax.numpy as jnp

    import lsqr_tpu as lt
    from lsqr_tpu.models.synthetic import block_banded_coo
    from lsqr_tpu.ops.structured import block_ell_operator, ell_operator

    m = n = 64
    vals, rows, cols = block_banded_coo(m, n, block=8, band_blocks=1,
                                        dtype=np.float64)
    coo = lt.coo_operator(m, n, vals, rows, cols)
    x = rng.standard_normal(n)
    for op in (
        ell_operator(m, n, vals, rows, cols),
        block_ell_operator(m, n, vals, rows, cols, block=(8, 8)),
    ):
        np.testing.assert_allclose(
            np.asarray(op.matvec(jnp.asarray(x))),
            np.asarray(coo.matvec(jnp.asarray(x))),
            atol=1e-12,
        )

