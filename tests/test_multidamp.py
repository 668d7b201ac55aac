"""lsqr_multidamp: k damped solves from one shared bidiagonalization.

The claim under test (multidamp.py docstring): because the Golub-Kahan
bidiagonalization is damp-independent (/root/reference/src/lsqr.f90:681-699;
damp enters only at :703), every damp's iterates are IDENTICAL to a
standalone lsqr run with that damp — so the multi-damp result must match
per-damp sequential solves essentially bitwise, including istop/itn and all
norm estimates, with converged damps frozen while stragglers continue.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lsqr_tpu import LSQROptions, lsqr, lsqr_multidamp
from lsqr_tpu.ops.linop import DenseOperator
from lsqr_tpu.ops.structured import dia_operator


def _dense_problem(rng, m=60, n=40):
    A = jnp.asarray(rng.standard_normal((m, n)))
    b = jnp.asarray(rng.standard_normal((m,)))
    return DenseOperator(A), b


DAMPS = [0.0, 1e-6, 1e-3, 0.5, 2.0]


def test_matches_sequential_solves(rng):
    A, b = _dense_problem(rng)
    res = lsqr_multidamp(A, b, DAMPS, atol=1e-12, btol=1e-12)
    assert res.x.shape == (len(DAMPS), A.n)
    for j, damp in enumerate(DAMPS):
        single = lsqr(A, b, damp, atol=1e-12, btol=1e-12)
        assert int(res.istop[j]) == int(single.istop), f"damp={damp}"
        assert int(res.itn[j]) == int(single.itn), f"damp={damp}"
        np.testing.assert_allclose(res.x[j], single.x, rtol=1e-12, atol=1e-14)
        for field in ("anorm", "acond", "rnorm", "arnorm", "xnorm",
                      "dxmax", "bnorm"):
            np.testing.assert_allclose(
                np.asarray(getattr(res, field))[j],
                np.asarray(getattr(single, field)),
                rtol=1e-10, err_msg=f"{field} damp={damp}",
            )


def test_wantse_matches(rng):
    A, b = _dense_problem(rng, m=50, n=30)
    damps = [0.0, 1e-2]
    res = lsqr_multidamp(A, b, damps, wantse=True, atol=1e-12, btol=1e-12)
    assert res.se.shape == (2, A.n)
    for j, damp in enumerate(damps):
        single = lsqr(A, b, damp, wantse=True, atol=1e-12, btol=1e-12)
        np.testing.assert_allclose(res.se[j], single.se, rtol=1e-10)


def test_bounded_loop_matches_while(rng):
    A, b = _dense_problem(rng)
    res_w = lsqr_multidamp(A, b, DAMPS, atol=1e-10, btol=1e-10)
    res_b = lsqr_multidamp(
        A, b, DAMPS, atol=1e-10, btol=1e-10,
        options=LSQROptions(loop="bounded", loop_segment=7),
    )
    np.testing.assert_array_equal(np.asarray(res_w.istop), np.asarray(res_b.istop))
    np.testing.assert_array_equal(np.asarray(res_w.itn), np.asarray(res_b.itn))
    np.testing.assert_allclose(res_w.x, res_b.x, rtol=1e-13)


def test_dia_pair_path_matches(rng):
    """The pair (single-stripe-pass) kernel path, interpret mode on CPU."""
    m = n = 96
    offsets = (-2, 0, 3)
    data = jnp.asarray(rng.standard_normal((len(offsets), n)), jnp.float32)
    A = dia_operator(m, n, offsets, data)
    b = jnp.asarray(rng.standard_normal((m,)), jnp.float32)
    damps = [0.0, 1e-2, 1.0]
    res = lsqr_multidamp(A, b, damps, atol=1e-5, btol=1e-5)
    for j, damp in enumerate(damps):
        single = lsqr(A, b, damp, atol=1e-5, btol=1e-5)
        assert int(res.istop[j]) == int(single.istop)
        assert int(res.itn[j]) == int(single.itn)
        np.testing.assert_allclose(res.x[j], single.x, rtol=2e-5, atol=2e-6)


def test_oracle_damped_normal_equations(rng):
    """Each damped solution solves (A'A + damp^2 I) x = A'b."""
    A, b = _dense_problem(rng, m=80, n=30)
    damps = jnp.asarray([1e-2, 0.1, 1.0])
    res = lsqr_multidamp(A, b, damps, atol=1e-13, btol=1e-13)
    Ad = np.asarray(A.a)
    bd = np.asarray(b)
    for j, damp in enumerate(np.asarray(damps)):
        x_exact = np.linalg.solve(
            Ad.T @ Ad + damp**2 * np.eye(A.n), Ad.T @ bd
        )
        np.testing.assert_allclose(res.x[j], x_exact, rtol=1e-8, atol=1e-10)


def test_zero_rhs_all_damps():
    A = DenseOperator(jnp.eye(4))
    res = lsqr_multidamp(A, jnp.zeros((4,)), [0.0, 1.0])
    assert np.all(np.asarray(res.istop) == 0)  # x = 0 exact
    np.testing.assert_array_equal(np.asarray(res.x), 0.0)


def test_validation_errors(rng):
    A, b = _dense_problem(rng)
    with pytest.raises(ValueError, match="non-empty"):
        lsqr_multidamp(A, b, jnp.zeros((0,)))
    with pytest.raises(ValueError, match="record_trace"):
        lsqr_multidamp(A, b, [0.0], record_trace=True)
    with pytest.raises(ValueError, match="length m"):
        lsqr_multidamp(A, b[:-1], [0.0])


def test_scalar_damps_promoted(rng):
    A, b = _dense_problem(rng)
    res = lsqr_multidamp(A, b, 0.5, atol=1e-10, btol=1e-10)
    assert res.x.shape == (1, A.n)
    single = lsqr(A, b, 0.5, atol=1e-10, btol=1e-10)
    np.testing.assert_allclose(res.x[0], single.x, rtol=1e-12)


# ---------------------------------------------------------------------------
# lsmr_multidamp
# ---------------------------------------------------------------------------

def test_lsmr_multidamp_matches_sequential(rng):
    from lsqr_tpu import lsmr, lsmr_multidamp

    A, b = _dense_problem(rng)
    res = lsmr_multidamp(A, b, DAMPS, atol=1e-12, btol=1e-12)
    assert res.x.shape == (len(DAMPS), A.n)
    for j, damp in enumerate(DAMPS):
        single = lsmr(A, b, damp, atol=1e-12, btol=1e-12)
        assert int(res.istop[j]) == int(single.istop), f"damp={damp}"
        assert int(res.itn[j]) == int(single.itn), f"damp={damp}"
        np.testing.assert_allclose(res.x[j], single.x, rtol=1e-12, atol=1e-14)
        for field in ("normr", "normar", "norma", "conda", "normx"):
            np.testing.assert_allclose(
                np.asarray(getattr(res, field))[j],
                np.asarray(getattr(single, field)),
                rtol=1e-10, err_msg=f"{field} damp={damp}",
            )


def test_lsmr_multidamp_vs_scipy(rng):
    import scipy.sparse.linalg

    from lsqr_tpu import lsmr_multidamp

    A, b = _dense_problem(rng, m=70, n=50)
    damps = [0.0, 1e-3, 0.3]
    res = lsmr_multidamp(A, b, damps, atol=1e-10, btol=1e-10)
    for j, damp in enumerate(damps):
        ref = scipy.sparse.linalg.lsmr(
            np.asarray(A.a), np.asarray(b), damp=damp, atol=1e-10, btol=1e-10
        )
        assert int(res.istop[j]) == ref[1]
        assert int(res.itn[j]) == ref[2]
        np.testing.assert_allclose(res.x[j], ref[0], rtol=1e-8, atol=1e-10)


def test_lsmr_multidamp_bounded_matches(rng):
    from lsqr_tpu import lsmr_multidamp

    A, b = _dense_problem(rng)
    res_w = lsmr_multidamp(A, b, DAMPS, atol=1e-9, btol=1e-9)
    res_b = lsmr_multidamp(A, b, DAMPS, atol=1e-9, btol=1e-9,
                           loop="bounded", loop_segment=5)
    np.testing.assert_array_equal(np.asarray(res_w.istop), np.asarray(res_b.istop))
    np.testing.assert_array_equal(np.asarray(res_w.itn), np.asarray(res_b.itn))
    np.testing.assert_allclose(res_w.x, res_b.x, rtol=1e-13)


def test_lsmr_multidamp_dia_pair(rng):
    from lsqr_tpu import lsmr, lsmr_multidamp

    m = n = 96
    offsets = (-2, 0, 3)
    data = jnp.asarray(rng.standard_normal((len(offsets), n)), jnp.float32)
    A = dia_operator(m, n, offsets, data)
    b = jnp.asarray(rng.standard_normal((m,)), jnp.float32)
    damps = [0.0, 0.5]
    res = lsmr_multidamp(A, b, damps, atol=1e-5, btol=1e-5)
    for j, damp in enumerate(damps):
        single = lsmr(A, b, damp, atol=1e-5, btol=1e-5)
        assert int(res.istop[j]) == int(single.istop)
        assert int(res.itn[j]) == int(single.itn)
        np.testing.assert_allclose(res.x[j], single.x, rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# distributed multi-damp
# ---------------------------------------------------------------------------

def test_multidamp_sharded_coo_matches_unsharded(rng):
    from lsqr_tpu.ops.coo import coo_operator
    from lsqr_tpu.parallel import lsqr_multidamp_sharded, make_mesh

    m, n, nnz = 260, 150, 1500  # 260 % 8 = 4 -> ragged shards
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    A = coo_operator(m, n, vals, rows, cols)
    b = jnp.asarray(rng.standard_normal(m))
    damps = [0.0, 1e-3, 0.7]
    mesh = make_mesh(8)
    # matched iteration counts (itnlim-bound, tolerances off): the sharded
    # segment-sum reduction order shifts stopping-test rounding by an
    # iteration otherwise (same methodology as test_sharding.py)
    kw = dict(atol=1e-30, btol=1e-30, itnlim=60)
    res_s = lsqr_multidamp_sharded(A, b, damps, mesh=mesh, **kw)
    from lsqr_tpu import lsqr_multidamp
    res_u = lsqr_multidamp(A, b, damps, **kw)
    np.testing.assert_array_equal(np.asarray(res_s.itn), np.asarray(res_u.itn))
    # the sharded segment-sum reduces in a different order; 60 undamped
    # iterations accumulate ~1e-6 relative divergence between the runs
    np.testing.assert_allclose(res_s.x, res_u.x, rtol=1e-5, atol=1e-8)


def test_multidamp_sharded_dia_matches_unsharded(rng):
    from lsqr_tpu.parallel import lsqr_multidamp_sharded, make_mesh

    m = n = 260  # ragged: 260 % 8 = 4
    offsets = (-1, 0, 2)
    data = rng.standard_normal((len(offsets), m))
    data[1] += 4.0  # diagonal dominance bounds the conditioning, so the
    A = dia_operator(m, n, offsets, jnp.asarray(data))
    b = jnp.asarray(rng.standard_normal(m))  # comparison is rounding-tight
    damps = [0.0, 0.3]
    mesh = make_mesh(8)
    kw = dict(atol=1e-10, btol=1e-10, wantse=True)
    res_s = lsqr_multidamp_sharded(A, b, damps, mesh=mesh, **kw)
    from lsqr_tpu import lsqr_multidamp
    res_u = lsqr_multidamp(A, b, damps, **kw)
    np.testing.assert_array_equal(np.asarray(res_s.istop), np.asarray(res_u.istop))
    np.testing.assert_array_equal(np.asarray(res_s.itn), np.asarray(res_u.itn))
    np.testing.assert_allclose(res_s.x, res_u.x, rtol=1e-7, atol=1e-11)
    # se scales with the FINAL rnorm, which is rounding-noise here (the
    # system is nearly consistent: rnorm ~ 1e-9 undamped); exact se parity
    # vs the single-damp solver is pinned by test_wantse_matches
    np.testing.assert_allclose(res_s.se, res_u.se, rtol=1e-2, atol=1e-10)


def test_multidamp_sharded_dia_pair_mode(rng):
    from lsqr_tpu.parallel import lsqr_multidamp_sharded, make_mesh

    m = n = 256
    offsets = (-1, 0, 2)
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    data[1] += 4.0  # bounded conditioning (see the test above)
    A = dia_operator(m, n, offsets, jnp.asarray(data))
    b = jnp.asarray(rng.standard_normal(m), jnp.float32)
    damps = [0.0, 0.3]
    mesh = make_mesh(4)
    res_p = lsqr_multidamp_sharded(A, b, damps, mesh=mesh, pair=True,
                                   atol=1e-5, btol=1e-5)
    res_n = lsqr_multidamp_sharded(A, b, damps, mesh=mesh,
                                   atol=1e-5, btol=1e-5)
    np.testing.assert_array_equal(np.asarray(res_p.istop), np.asarray(res_n.istop))
    # f32 + different product rounding between the two modes
    np.testing.assert_allclose(res_p.x, res_n.x, rtol=5e-3, atol=5e-5)
