"""f32 conformance mode — the fast-precision story.

The reference runs its suite only in real64 (wp selection,
/root/reference/src/lsqr_kinds.F90:16-24) and documents that iteration
counts are precision-sensitive (lsqr.f90:429-430). The fast mode is
f32; this module characterizes the 18-problem Paige–Saunders suite at f32
every problem terminates cleanly (istop 1/3 —
never 4/5), with solution accuracy degrading gracefully with conditioning.

Also covered: the mixed-precision mode (f32 vectors + f64 scalar
recurrence, ``LSQROptions(scalar_dtype='float64')``). Measured finding,
worth keeping as a pinned fact: the mixed mode reproduces the pure-f32
iterates EXACTLY on this suite — f32 LSQR accuracy is bound by the f32
vectors (the bidiagonalization products), not by scalar accumulation, so
the expensive part of the precision budget is exactly where the device
spends it.
"""

import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.models.paige_saunders import lstp, suite_configs
from lsqr_tpu.ops.blas import nrm2

EPS32 = float(np.finfo(np.float32).eps)

# (m, n, npower) -> (istop, itn, rel.err) measured at f32 on CPU with
# atol = btol = eps32**0.9, conlim = 1000*acond, itnlim = 4(m+n+50).
F32_MEASURED = {
    (2000, 1000, 2): (3, 69, 6.960e-03),
    (2000, 1000, 3): (3, 111, 1.997e-02),
    (2000, 1000, 4): (3, 97, 5.572e-02),
    (2000, 1000, 5): (3, 112, 8.056e-02),
    (2000, 1000, 6): (3, 86, 1.336e-01),
    (2000, 1000, 7): (3, 97, 1.661e-01),
    (1000, 1000, 2): (1, 92, 1.277e-04),
    (1000, 1000, 3): (1, 138, 7.912e-03),
    (1000, 1000, 4): (1, 201, 2.759e-02),
    (1000, 1000, 5): (1, 163, 5.917e-02),
    (1000, 1000, 6): (1, 166, 8.388e-02),
    (1000, 1000, 7): (1, 159, 1.116e-01),
    (1000, 2000, 2): (1, 93, 7.496e-04),
    (1000, 2000, 3): (1, 139, 8.402e-03),
    (1000, 2000, 4): (1, 175, 2.359e-02),
    (1000, 2000, 5): (1, 159, 5.852e-02),
    (1000, 2000, 6): (1, 164, 8.310e-02),
    (1000, 2000, 7): (1, 162, 1.103e-01),
}

CONFIGS = list(suite_configs())


def _rel_err(x, x_true):
    x64 = np.asarray(x, np.float64)
    t64 = np.asarray(x_true, np.float64)
    return float(np.linalg.norm(x64 - t64) / (1.0 + np.linalg.norm(t64)))


@pytest.mark.parametrize(
    "m,n,nduplc,npower,damp",
    CONFIGS,
    ids=[f"P_{m}x{n}_p{p}_f32" for m, n, _, p, _ in CONFIGS],
)
def test_f32_conformance(m, n, nduplc, npower, damp):
    prob = lstp(m, n, nduplc, npower, damp, dtype=np.float32)
    res = lt.lsqr(
        prob.A,
        prob.b,
        damp,
        atol=EPS32**0.9,
        btol=EPS32**0.9,
        conlim=1000.0 * float(prob.acond),
        itnlim=4 * (m + n + 50),
    )
    istop_p, itn_p, err_p = F32_MEASURED[(m, n, npower)]
    # clean termination: converged by a tolerance test, never conlim/itnlim
    assert int(res.istop) == istop_p, (
        f"istop={int(res.istop)}, pinned={istop_p}"
    )
    # f32 iteration counts are rounding-sensitive; allow a modest band
    assert abs(int(res.itn) - itn_p) <= max(5, itn_p // 10), (
        f"itn={int(res.itn)}, pinned={itn_p}"
    )
    err = _rel_err(res.x, prob.x_true)
    assert err <= 2.0 * err_p, f"rel err {err:.3e}, pinned {err_p:.3e}"


def test_mixed_scalar_mode_matches_f32():
    """f64 scalar recurrence with f32 vectors reproduces the pure-f32
    solve on a representative problem (same iteration count and istop; x
    agrees to f32 rounding, measured max ~5e-7 relative) — the measured
    fact that f32 accuracy is vector-bound, not scalar-bound."""
    m, n, npower, damp = 1000, 1000, 3, 1e-9
    prob = lstp(m, n, 40, npower, damp, dtype=np.float32)
    kw = dict(atol=EPS32**0.9, btol=EPS32**0.9,
              conlim=1000.0 * float(prob.acond), itnlim=4 * (m + n + 50))
    res32 = lt.lsqr(prob.A, prob.b, damp, **kw)
    resmx = lt.lsqr(prob.A, prob.b, damp, scalar_dtype="float64", **kw)
    assert int(resmx.itn) == int(res32.itn)
    assert int(resmx.istop) == int(res32.istop)
    scale = float(np.abs(np.asarray(res32.x)).max())
    np.testing.assert_allclose(np.asarray(resmx.x), np.asarray(res32.x),
                               atol=3e-5 * scale)
    # scalar outputs come back in the wider dtype
    assert np.asarray(resmx.rnorm).dtype == np.float64
    assert np.asarray(resmx.x).dtype == np.float32


def test_mixed_mode_rejects_fused():
    from lsqr_tpu.ops.structured import dia_operator

    A = dia_operator(64, 64, (0,), np.ones((1, 64), np.float32))
    with pytest.raises(ValueError, match="scalar_dtype"):
        lt.lsqr(A, np.ones(64, np.float32), 0.0, fused=True,
                scalar_dtype="float64")


def test_mixed_mode_wantse_and_trace():
    """se / trace shapes and dtypes stay in the vector dtype."""
    m, n = 120, 80
    rng = np.random.default_rng(3)
    prob_vals = rng.standard_normal(600).astype(np.float32)
    rows = rng.integers(0, m, 600)
    cols = rng.integers(0, n, 600)
    A = lt.coo_operator(m, n, prob_vals, rows, cols)
    b = rng.standard_normal(m).astype(np.float32)
    res = lt.lsqr(A, b, 0.1, scalar_dtype="float64", wantse=True,
                  record_trace=True, itnlim=50)
    assert res.se.dtype == np.float32
    assert res.trace.dtype == np.float32
    assert res.se.shape == (n,)
