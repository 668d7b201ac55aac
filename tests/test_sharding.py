"""Distributed-layer tests on 8 virtual CPU devices (conftest sets
--xla_force_host_platform_device_count=8) — the multi-chip strategy from
SURVEY.md §4: N-way row partitioning validated without several cards, plus
sharded-vs-unsharded equivalence checks.

The reference has no distributed tests (serial Fortran); these cover the
new capability."""

import jax
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.parallel.sharding import lsqr_sharded, make_mesh, shard_coo


def _random_coo(rng, m, n, nnz, dtype=np.float64):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    return lt.coo_operator(m, n, vals, rows, cols)


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("shape", [(200, 120), (120, 120), (97, 211)])
def test_sharded_matches_unsharded(rng, ndev, shape):
    m, n = shape
    A = _random_coo(rng, m, n, 5 * m)
    b = rng.standard_normal(m)
    damp = 0.05

    ref = lt.lsqr(A, b, damp, atol=1e-10, btol=1e-10, itnlim=400)
    mesh = make_mesh(ndev)
    res = lsqr_sharded(A, b, damp, mesh=mesh, atol=1e-10, btol=1e-10, itnlim=400)

    assert int(res.istop) == int(ref.istop)
    # equal up to reduction-order rounding; near the tight tolerance the
    # stopping iteration can shift by one, so allow a small multiple of the
    # solve tolerance amplified by the conditioning
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-7)
    assert abs(int(res.itn) - int(ref.itn)) <= 3
    np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm), rtol=1e-6)
    # anorm is a running per-iteration estimate; a +-1 shift in the stopping
    # iteration moves it slightly
    np.testing.assert_allclose(float(res.anorm), float(ref.anorm), rtol=1e-2)


def test_shard_coo_partition_roundtrip(rng):
    """The row partition preserves every nonzero exactly once."""
    m, n, nnz = 100, 60, 500
    A = _random_coo(rng, m, n, nnz)
    sh = shard_coo(A, 8)
    dense = np.zeros((sh.m_pad, n))
    rpd = sh.rows_per_dev
    for d in range(8):
        np.add.at(
            dense,
            (np.asarray(sh.rows[d]) + d * rpd, np.asarray(sh.cols[d])),
            np.asarray(sh.vals[d]),
        )
    np.testing.assert_allclose(dense[:m], np.asarray(A.todense()), rtol=1e-15)
    assert not dense[m:].any()


def test_sharded_wantse_and_damped(rng):
    m, n = 160, 80
    A = _random_coo(rng, m, n, 800)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.2, wantse=True, atol=1e-9, btol=1e-9, itnlim=300)
    res = lsqr_sharded(A, b, 0.2, mesh=make_mesh(8), wantse=True,
                       atol=1e-9, btol=1e-9, itnlim=300)
    assert int(res.istop) == 3
    # se accumulates over iterations; a small shift in the stopping
    # iteration perturbs it slightly
    np.testing.assert_allclose(np.asarray(res.se), np.asarray(ref.se), rtol=1e-2)


def test_sharded_rejects_bad_b(rng):
    A = _random_coo(rng, 64, 32, 200)
    with pytest.raises(ValueError):
        lsqr_sharded(A, np.zeros(63), mesh=make_mesh(4))


def test_sharded_dia_matches_unsharded(rng):
    from lsqr_tpu.ops.structured import dia_operator
    from lsqr_tpu.parallel.sharding import lsqr_sharded_dia

    m = n = 260  # 260 % 8 = 4 -> genuinely ragged, exercises row padding
    offsets = (-4, -1, 0, 2, 5)
    data = rng.standard_normal((len(offsets), m))
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.05, atol=1e-10, btol=1e-10, itnlim=400)
    res = lsqr_sharded_dia(A, b, 0.05, mesh=make_mesh(8),
                           atol=1e-10, btol=1e-10, itnlim=400)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 3
    # per-shard masked transpose stripes change the reduction grouping
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-5)


@pytest.mark.parametrize("m,n", [(260, 260), (202, 150), (150, 202)])
def test_sharded_dia_ragged_fixed_itn_tight(rng, m, n):
    """Ragged row counts (m % 8 != 0) at MATCHED iteration counts: with a
    fixed itnlim and zero tolerances both solvers run the identical number
    of iterations, so x must agree to near machine precision — no hiding
    room for shard-window or reduction bugs (ADVICE.md high finding: the
    pre-fix clamped dynamic_slice corrupted the last shard at these sizes).
    """
    from lsqr_tpu.ops.structured import dia_operator
    from lsqr_tpu.parallel.sharding import lsqr_sharded_dia

    offsets = (-7, -1, 0, 1, 6)
    data = rng.standard_normal((len(offsets), m))
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.05, atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    res = lsqr_sharded_dia(A, b, 0.05, mesh=make_mesh(8),
                           atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    assert int(res.itn) == int(ref.itn)
    # reduction-order rounding amplified over 25 iterations: observed max
    # ~6e-9 relative on the under-determined case; 1e-7 still catches any
    # real window/reduction bug (the pre-fix clamp bug gave O(1) errors)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm), rtol=1e-11)
    np.testing.assert_allclose(float(res.xnorm), float(ref.xnorm), rtol=1e-9)


def test_sharded_coo_fixed_itn_tight(rng):
    """COO row sharding at matched iteration counts: x and se to ~1e-9
    (VERDICT.md round-1 item 8 — tightened from the 1e-2/1e-5 band)."""
    m, n = 197, 120  # ragged: 197 % 8 = 5
    A = _random_coo(rng, m, n, 6 * m)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.1, wantse=True, atol=0.0, btol=0.0, conlim=0.0,
                  itnlim=30)
    res = lsqr_sharded(A, b, 0.1, mesh=make_mesh(8), wantse=True,
                       atol=0.0, btol=0.0, conlim=0.0, itnlim=30)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.se), np.asarray(ref.se),
                               rtol=1e-7, atol=1e-11)


def test_sharded_dia_rectangular(rng):
    from lsqr_tpu.ops.structured import dia_operator
    from lsqr_tpu.parallel.sharding import lsqr_sharded_dia

    m, n = 200, 300
    offsets = (-3, 0, 7, 60)
    data = rng.standard_normal((len(offsets), m))
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.1, atol=1e-9, btol=1e-9, itnlim=300)
    res = lsqr_sharded_dia(A, b, 0.1, mesh=make_mesh(4),
                           atol=1e-9, btol=1e-9, itnlim=300)
    assert int(res.istop) == int(ref.istop)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-7)


# ---------------------------------------------------------------------------
# 2-D (rows x cols) sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_sharded_2d_matches_unsharded(rng, mesh_shape):
    """Full 2-D block partition (incl. pure column sharding at (1, 8)) at
    matched iteration counts: VERDICT.md round-1 item 5 — the (1000, 2000)
    reference shape scaled down, with n-vectors genuinely sharded."""
    from lsqr_tpu.parallel.sharding import lsqr_sharded_2d, make_mesh_2d

    m, n = 150, 260  # ragged in both dimensions for most mesh shapes
    A = _random_coo(rng, m, n, 6 * m)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.1, atol=0.0, btol=0.0, conlim=0.0, itnlim=25,
                  wantse=True)
    res = lsqr_sharded_2d(A, b, 0.1, mesh=make_mesh_2d(mesh_shape),
                          atol=0.0, btol=0.0, conlim=0.0, itnlim=25,
                          wantse=True)
    assert int(res.itn) == int(ref.itn)
    assert res.x.shape == (n,)
    # the 2-D partition regroups BOTH segment sums; per-product equivalence
    # is machine-exact (verified <=2e-15 for all mesh shapes), and the
    # remaining drift here is reduction-order rounding amplified over the
    # 25 fixed iterations (observed max ~4e-6 relative on tiny elements)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.se), np.asarray(ref.se),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm), rtol=1e-8)


def test_sharded_2d_converged_solve(rng):
    from lsqr_tpu.parallel.sharding import lsqr_sharded_2d, make_mesh_2d

    m, n = 200, 120
    A = _random_coo(rng, m, n, 5 * m)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.05, atol=1e-10, btol=1e-10, itnlim=400)
    res = lsqr_sharded_2d(A, b, 0.05, mesh=make_mesh_2d((2, 4)),
                          atol=1e-10, btol=1e-10, itnlim=400)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 3
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), atol=1e-7)


def test_sharded_2d_rejects_bad_input(rng):
    from lsqr_tpu.parallel.sharding import lsqr_sharded_2d, make_mesh_2d

    A = _random_coo(rng, 64, 32, 200)
    with pytest.raises(ValueError):
        lsqr_sharded_2d(A, np.zeros(63), mesh=make_mesh_2d((2, 2)))
    with pytest.raises(ValueError):
        lsqr_sharded_2d(A, np.zeros(64))  # no mesh or mesh_shape


def test_lsmr_sharded_matches_unsharded(rng):
    """Distributed LSMR: fixed-itnlim iterate equivalence vs one device."""
    from lsqr_tpu.lsmr import lsmr
    from lsqr_tpu.parallel.sharding import lsmr_sharded, make_mesh

    m, n, nnz = 200, 120, 1400
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    b = rng.standard_normal(m)
    A = lt.coo_operator(m, n, vals, rows, cols)

    ref = lsmr(A, b, 0.1, atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    mesh = make_mesh(8)
    res = lsmr_sharded(A, b, 0.1, mesh=mesh, atol=0.0, btol=0.0,
                       conlim=0.0, itnlim=25)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(res.normr), float(ref.normr), rtol=1e-9)
    np.testing.assert_allclose(float(res.normar), float(ref.normar), rtol=1e-6)


def test_craig_sharded_matches_unsharded(rng):
    """Distributed CRAIG on a consistent under-determined system."""
    from lsqr_tpu.craig import craig
    from lsqr_tpu.parallel.sharding import craig_sharded, make_mesh

    m, n = 60, 150
    dense = rng.standard_normal((m, n))
    r, c = np.nonzero(dense)
    vals = dense[r, c]
    A = lt.coo_operator(m, n, vals, r, c)
    b = dense @ rng.standard_normal(n)

    ref = craig(A, b, atol=0.0, btol=0.0, itnlim=30)
    mesh = make_mesh(8)
    res = craig_sharded(A, b, mesh=mesh, atol=0.0, btol=0.0, itnlim=30)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(res.xnorm), float(ref.xnorm), rtol=1e-9)


def test_cgls_sharded_matches_unsharded(rng):
    """Distributed CGLS (damped least squares) over the row partition."""
    from lsqr_tpu.cgls import cgls
    from lsqr_tpu.parallel.sharding import cgls_sharded, make_mesh

    m, n = 150, 60  # over-determined, m % 8 != 0 exercises row padding
    dense = rng.standard_normal((m, n))
    r, c = np.nonzero(dense)
    vals = dense[r, c]
    A = lt.coo_operator(m, n, vals, r, c)
    b = rng.standard_normal(m)

    ref = cgls(A, b, 0.1, atol=0.0, btol=0.0, itnlim=25)
    mesh = make_mesh(8)
    res = cgls_sharded(A, b, 0.1, mesh=mesh, atol=0.0, btol=0.0, itnlim=25)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm), rtol=1e-9)
    np.testing.assert_allclose(float(res.arnorm), float(ref.arnorm),
                               rtol=1e-6)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_sibling_sharded_2d_matches_unsharded(rng, mesh_shape):
    """LSMR/CRAIG/CGLS over the 2-D block partition (incl. pure column
    sharding) at matched iteration counts."""
    from lsqr_tpu.cgls import cgls
    from lsqr_tpu.craig import craig
    from lsqr_tpu.lsmr import lsmr
    from lsqr_tpu.parallel.sharding import (
        cgls_sharded_2d,
        craig_sharded_2d,
        lsmr_sharded_2d,
        make_mesh_2d,
    )

    m, n = 90, 140  # under-determined, ragged in both mesh dims
    dense = rng.standard_normal((m, n))
    r, c = np.nonzero(dense)
    A = lt.coo_operator(m, n, dense[r, c], r, c)
    b = dense @ rng.standard_normal(n)  # consistent (CRAIG needs it)
    mesh = make_mesh_2d(mesh_shape)

    ref = lsmr(A, b, 0.01, itnlim=20, atol=0.0, btol=0.0, conlim=0.0)
    res = lsmr_sharded_2d(A, b, 0.01, mesh=mesh, itnlim=20,
                          atol=0.0, btol=0.0, conlim=0.0)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)

    ref = craig(A, b, itnlim=20, atol=0.0, btol=0.0)
    res = craig_sharded_2d(A, b, mesh=mesh, itnlim=20, atol=0.0, btol=0.0)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)

    ref = cgls(A, b, 0.05, itnlim=20, atol=0.0, btol=0.0)
    res = cgls_sharded_2d(A, b, 0.05, mesh=mesh, itnlim=20,
                          atol=0.0, btol=0.0)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)


def test_sibling_sharded_dia_matches_unsharded(rng):
    """LSMR/CRAIG/CGLS over the banded row partition at matched iteration
    counts, ragged row count (m % 8 != 0)."""
    from lsqr_tpu.cgls import cgls
    from lsqr_tpu.craig import craig
    from lsqr_tpu.lsmr import lsmr
    from lsqr_tpu.ops.structured import dia_operator
    from lsqr_tpu.parallel.sharding import (
        cgls_sharded_dia,
        craig_sharded_dia,
        lsmr_sharded_dia,
        make_mesh,
    )

    m = n = 260  # 260 % 8 = 4 -> ragged shards
    offsets = (-4, -1, 0, 2, 5)
    data = rng.standard_normal((len(offsets), m))
    data[2] += 5.0
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m)
    mesh = make_mesh(8)

    ref = lsmr(A, b, 0.02, itnlim=25, atol=0.0, btol=0.0, conlim=0.0)
    res = lsmr_sharded_dia(A, b, 0.02, mesh=mesh, itnlim=25,
                           atol=0.0, btol=0.0, conlim=0.0)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)

    bc = np.asarray(A.todense()) @ rng.standard_normal(n)  # consistent
    ref = craig(A, bc, itnlim=25, atol=0.0, btol=0.0)
    res = craig_sharded_dia(A, bc, mesh=mesh, itnlim=25, atol=0.0, btol=0.0)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)

    ref = cgls(A, b, 0.05, itnlim=25, atol=0.0, btol=0.0)
    res = cgls_sharded_dia(A, b, 0.05, mesh=mesh, itnlim=25,
                           atol=0.0, btol=0.0)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)


def test_sharded_dia_pair_matches(rng):
    """pair=True runs both products from one local stripe stream + one
    psum (the sharded dia_pair analogue); matched-itn comparison."""
    from lsqr_tpu.ops.structured import dia_operator
    from lsqr_tpu.parallel.sharding import lsqr_sharded_dia

    m, n = 260, 210
    offsets = (-4, -1, 0, 2, 5)
    data = rng.standard_normal((len(offsets), m))
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.05, atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    res = lsqr_sharded_dia(A, b, 0.05, mesh=make_mesh(8),
                           atol=0.0, btol=0.0, conlim=0.0, itnlim=25,
                           pair=True)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm), rtol=1e-9)


def test_sibling_sharded_dia_pair(rng):
    from lsqr_tpu.ops.structured import dia_operator
    from lsqr_tpu.parallel.sharding import (
        cgls_sharded_dia, craig_sharded_dia, lsmr_sharded_dia,
    )
    from lsqr_tpu import cgls, craig, lsmr

    m = n = 264
    offsets = (-2, 0, 3)
    data = rng.standard_normal((3, m))
    data[1] += 5.0
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m)

    ref = lsmr(A, b, 0.05, atol=1e-9, btol=1e-9)
    res = lsmr_sharded_dia(A, b, 0.05, mesh=make_mesh(8), atol=1e-9,
                           btol=1e-9, pair=True)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-6)

    xt = rng.standard_normal(n)
    bc = np.asarray(A.matvec(xt))
    refc = craig(A, bc, atol=1e-9, btol=1e-9)
    resc = craig_sharded_dia(A, bc, mesh=make_mesh(8), atol=1e-9, btol=1e-9,
                             pair=True)
    assert int(resc.istop) == int(refc.istop)
    np.testing.assert_allclose(np.asarray(resc.x), np.asarray(refc.x),
                               atol=1e-6)

    refg = cgls(A, b, 0.05, atol=1e-8, btol=1e-8)
    resg = cgls_sharded_dia(A, b, 0.05, mesh=make_mesh(8), atol=1e-8,
                            btol=1e-8, pair=True)
    assert int(resg.istop) == int(refg.istop)
    np.testing.assert_allclose(np.asarray(resg.x), np.asarray(refg.x),
                               atol=1e-6)


def test_traced_2d_solve_gathers_only_at_finalize(rng, monkeypatch):
    """record_trace on a column-sharded solve must fetch x[0] with a SCALAR
    psum from the owning shard, not all_gather the whole x every iteration
    (round-3 verdict, weak #4). The only all_gather in the traced program is
    the one final x gather."""
    from lsqr_tpu.parallel.sharding import lsqr_sharded_2d, make_mesh_2d

    calls = []
    real_ag = jax.lax.all_gather

    def counting_all_gather(*args, **kwargs):
        calls.append(1)
        return real_ag(*args, **kwargs)

    monkeypatch.setattr(jax.lax, "all_gather", counting_all_gather)

    # dominant diagonal: reduction-order rounding must not be amplified by
    # conditioning, so the per-iteration trace comparison below stays tight
    m, n = 96, 64
    rows = np.concatenate([rng.integers(0, m, 4 * m), np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, 4 * m), np.arange(n)])
    vals = np.concatenate(
        [rng.standard_normal(4 * m), np.full(n, 8.0)]
    )
    A = lt.coo_operator(m, n, vals, rows, cols)
    b = rng.standard_normal(m)
    ref = lt.lsqr(A, b, 0.05, atol=1e-10, btol=1e-10, itnlim=30,
                  record_trace=True)
    res = lsqr_sharded_2d(A, b, 0.05, mesh=make_mesh_2d((2, 4)),
                          atol=1e-10, btol=1e-10, itnlim=30,
                          record_trace=True)
    # the body is traced once: a per-iteration all_gather would show up as a
    # second call beyond the single finalize gather of x
    assert sum(calls) == 1
    itn = int(res.itn)
    assert itn == int(ref.itn)
    # trace rows (incl. the x[0] column the psum fetches) match unsharded
    np.testing.assert_allclose(
        np.asarray(res.trace)[1 : itn + 1],
        np.asarray(ref.trace)[1 : itn + 1],
        rtol=1e-6, atol=1e-9,
    )


def _zdia_problem(rng, m, n, offsets):
    from lsqr_tpu.ops.zdia import zdia_operator

    data = (rng.standard_normal((len(offsets), m))
            + 1j * rng.standard_normal((len(offsets), m)))
    A = zdia_operator(m, n, offsets, data)      # complex128 under x64
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    return A, b


def test_sharded_zdia_matches_unsharded(rng):
    """Plane-split complex banded row shards (round-5 item 5): the
    sharded solve must match its unsharded ZDIA oracle at matched itn."""
    from lsqr_tpu.parallel.sharding import lsqr_sharded_zdia

    m = n = 260  # ragged (260 % 8 = 4): exercises row padding
    A, b = _zdia_problem(rng, m, n, (-4, -1, 0, 2, 5))
    ref = lt.lsqr(A, b, 0.05, atol=1e-10, btol=1e-10, itnlim=400)
    res = lsqr_sharded_zdia(A, b, 0.05, mesh=make_mesh(8),
                            atol=1e-10, btol=1e-10, itnlim=400)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 3
    # reduction-order rounding accumulated over ~400 complex iterations
    # (observed max ~3e-5); the rectangular fixed-itn test below is the
    # tight (1e-7) correctness check at matched trajectories
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-4)


@pytest.mark.parametrize("m,n", [(202, 150), (150, 202)])
def test_sharded_zdia_rectangular_fixed_itn(rng, m, n):
    """Rectangular complex banded shards at matched iteration counts:
    zero tolerances + fixed itnlim leave no hiding room for window or
    conjugation bugs in the plane-split adjoint."""
    from lsqr_tpu.parallel.sharding import lsqr_sharded_zdia

    A, b = _zdia_problem(rng, m, n, (-7, -1, 0, 1, 6))
    ref = lt.lsqr(A, b, 0.05, atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    res = lsqr_sharded_zdia(A, b, 0.05, mesh=make_mesh(8),
                            atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm),
                               rtol=1e-11)


def test_sharded_zdia_pair_matches(rng):
    """pair=True streams both complex products from one local plane pass
    + one psum (the sharded zdia_pair analogue); matched-itn check."""
    from lsqr_tpu.parallel.sharding import lsqr_sharded_zdia

    m, n = 260, 210
    A, b = _zdia_problem(rng, m, n, (-4, -1, 0, 2, 5))
    ref = lt.lsqr(A, b, 0.05, atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    res = lsqr_sharded_zdia(A, b, 0.05, mesh=make_mesh(8),
                            atol=0.0, btol=0.0, conlim=0.0, itnlim=25,
                            pair=True)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm),
                               rtol=1e-9)


def test_sharded_dia_accepts_shared_operator(rng):
    """The DIA row shards accept the shared-stripe layout (round 5: the
    f32 auto default) — each shard repacks its row slice via the lazy
    ``data`` property; result matches the packed-operator shards."""
    from lsqr_tpu.ops.structured import dia_operator, dia_shared_operator
    from lsqr_tpu.parallel.sharding import lsqr_sharded_dia

    m = n = 260
    offsets = (-4, -1, 0, 2, 5)
    data = rng.standard_normal((len(offsets), m))
    Ap = dia_operator(m, n, offsets, data)
    As = dia_shared_operator(m, n, offsets, data)
    b = rng.standard_normal(m)
    kw = dict(atol=0.0, btol=0.0, conlim=0.0, itnlim=25)
    rp = lsqr_sharded_dia(Ap, b, 0.05, mesh=make_mesh(8), **kw)
    rs = lsqr_sharded_dia(As, b, 0.05, mesh=make_mesh(8), **kw)
    assert int(rp.itn) == int(rs.itn)
    np.testing.assert_array_equal(np.asarray(rp.x), np.asarray(rs.x))
