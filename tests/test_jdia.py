"""JDIA (jittered-diagonal) operator tests — the general-sparsity fast
path. Correctness oracle: COOOperator / dense, and a numpy loop over the
packed arrays for the XLA gather product.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.ops.jdia import JITTER, jdia_operator


def _jittered_band_coo(rng, m, n, nnz_per_row=6, spread=20, outliers=0.01):
    """A 'general' matrix with locality: entries near a few ragged
    diagonals plus a fraction of arbitrary outliers — the post-reordering
    shape of most real sparse systems."""
    rows = np.repeat(np.arange(m), nnz_per_row)
    centers = rng.choice([-37, -5, 0, 11, 52], size=rows.size)
    cols = rows + centers + rng.integers(-spread, spread + 1, rows.size)
    n_out = int(outliers * rows.size)
    if n_out:
        idx = rng.choice(rows.size, n_out, replace=False)
        cols[idx] = rng.integers(0, n, n_out)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    # dedup
    key = rows.astype(np.int64) * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    vals = rng.standard_normal(rows.size)
    return vals, rows, cols


@pytest.mark.parametrize("shape", [(600, 600), (900, 500), (500, 900)])
def test_jdia_products_match_coo(rng, shape):
    m, n = shape
    vals, rows, cols = _jittered_band_coo(rng, m, n)
    A = jdia_operator(m, n, vals, rows, cols, tm=1024)
    ref = lt.coo_operator(m, n, vals, rows, cols)
    assert A.fit_fraction > 0.9, A.fit_fraction
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(A.matvec(jnp.asarray(x))),
        np.asarray(ref.matvec(jnp.asarray(x, jnp.float32))),
        rtol=2e-5, atol=2e-5,
    )
    np.testing.assert_allclose(
        np.asarray(A.rmatvec(jnp.asarray(y))),
        np.asarray(ref.rmatvec(jnp.asarray(y, jnp.float32))),
        rtol=2e-5, atol=2e-5,
    )


def test_jdia_todense_matches_coo(rng):
    m, n = 400, 300
    vals, rows, cols = _jittered_band_coo(rng, m, n, outliers=0.05)
    A = jdia_operator(m, n, vals, rows, cols, tm=1024)
    ref = lt.coo_operator(m, n, vals, rows, cols)
    np.testing.assert_allclose(
        np.asarray(A.todense()), np.asarray(ref.todense()),
        rtol=2e-6, atol=2e-6,
    )


def test_jdia_kernel_interpret_matches_xla(rng):
    """The XLA gather product of the packed arrays against a numpy loop
    over the same packing (slot window start + per-row jitter)."""
    from lsqr_tpu.ops.jdia import JITTER, _jdia_matvec_xla, jdia_pack

    m = n = 2048
    vals, rows, cols = _jittered_band_coo(rng, m, n, outliers=0.0)
    p = jdia_pack(m, n, vals, rows, cols, tm=1024)
    # oracle and product consume the same packed arrays, so the (small)
    # remainder is irrelevant to this comparison
    assert p["rem_vals"].size < 0.05 * vals.size
    x = rng.standard_normal(n).astype(np.float32)
    nt = p["data"].shape[1] // p["tm"]
    length = max((nt - 1) * p["tm"] + p["win"], p["p_lo"] + n)
    xp = np.zeros(length, np.float32)
    xp[p["p_lo"]:p["p_lo"] + n] = x
    got = _jdia_matvec_xla(
        jnp.asarray(p["data"]), jnp.asarray(p["eoff"]),
        jnp.asarray(p["base"]), jnp.asarray(xp), m, p["tm"]
    )
    data, eoff, base = p["data"], p["eoff"], p["base"]
    i = np.arange(m)
    ref = np.zeros(m)
    for s_ in range(data.shape[0]):
        c = i + base[s_, i // p["tm"]] + JITTER - p["p_lo"] + eoff[s_, :m]
        ok = (c >= 0) & (c < n)
        ref[ok] += data[s_, :m][ok].astype(np.float64) * x[c[ok]]
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-5, atol=2e-5)


def test_jdia_random_pattern_goes_to_remainder(rng):
    """Uniformly random sparsity has no jitter-bounded structure: the pack
    degrades gracefully (low fit fraction, everything still correct via the
    remainder path)."""
    m = n = 512
    nnz = 3000
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    key = rows.astype(np.int64) * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    vals = rng.standard_normal(rows.size)
    A = jdia_operator(m, n, vals, rows, cols, tm=1024)
    ref = lt.coo_operator(m, n, vals, rows, cols)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(A.matvec(jnp.asarray(x))),
        np.asarray(ref.matvec(jnp.asarray(x, jnp.float32))),
        rtol=2e-5, atol=2e-5,
    )


def test_jdia_f64_products_exact(rng):
    """x64 conformance: an f64 JDIA packing (inferred from f64 vals) takes
    the XLA product path and reproduces the COO products bit-exactly —
    same entries, same f64 adds along each row."""
    m, n = 500, 400
    vals, rows, cols = _jittered_band_coo(rng, m, n)
    assert vals.dtype == np.float64
    A = jdia_operator(m, n, vals, rows, cols, tm=1024)
    assert A.dtype == jnp.float64
    ref = lt.coo_operator(m, n, vals, rows, cols)
    x = rng.standard_normal(n)
    y = rng.standard_normal(m)
    np.testing.assert_allclose(np.asarray(A.matvec(jnp.asarray(x))),
                               np.asarray(ref.matvec(jnp.asarray(x))),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(np.asarray(A.rmatvec(jnp.asarray(y))),
                               np.asarray(ref.rmatvec(jnp.asarray(y))),
                               rtol=1e-14, atol=1e-14)


def test_jdia_adjoint_and_solve(rng):
    m, n = 800, 600
    vals, rows, cols = _jittered_band_coo(rng, m, n)
    # pin f32 on both sides (jdia_operator infers f64 from f64 vals)
    A = jdia_operator(m, n, vals, rows, cols, tm=1024,
                      dtype=np.float32)
    chk = lt.acheck(A)
    assert int(chk.inform) == 0, float(chk.error)
    b = rng.standard_normal(m).astype(np.float32)
    ref_op = lt.coo_operator(m, n, vals.astype(np.float32), rows, cols)
    res = lt.lsqr(A, b, 0.1, atol=1e-5, btol=1e-5, itnlim=400)
    ref = lt.lsqr(ref_op, b, 0.1, atol=1e-5, btol=1e-5, itnlim=400)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-3, atol=1e-4)
