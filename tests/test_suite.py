"""The 18-problem Paige–Saunders conformance suite — the port of the
reference stress suite (/root/reference/test/lsqrtest_module.f90:55-272)
with expectations derived from the golden listing test/LSQR.LIS
(tabulated in /root/repo/BASELINE.md).

Per problem (driver: lsqrtest_module.f90:119-272):
  * acheck before the solve (abort if inconsistent, :183-188)
  * solve with atol = btol = eps**0.99, conlim = 1000*acond,
    itnlim = 4*(m+n+50), wantse=False (:195-206)
  * xcheck after the solve (:216-218)
  * pass criterion ||x - x_true|| / (1 + ||x_true||) <= 1e-3 (:236-241),
    with the two documented expected failures (over-determined npower 6, 7
    — too ill-conditioned, lsqrtest_module.f90:110-115).

Expected istop = 3; iteration counts pinned to this implementation's own
float64 runs (counts are rounding-sensitive, lsqr.f90:429-430; see
models/paige_saunders.check_suite_problem for the pin and the GPU band).
"""

import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.models.paige_saunders import (check_suite_problem, lstp,
                                            suite_configs)
from lsqr_tpu.ops.blas import nrm2

CONFIGS = list(suite_configs())


@pytest.mark.parametrize(
    "m,n,nduplc,npower,damp",
    CONFIGS,
    ids=[f"P_{m}x{n}_p{p}" for m, n, _, p, _ in CONFIGS],
)
def test_paige_saunders_problem(m, n, nduplc, npower, damp):
    out = check_suite_problem(m, n, nduplc, npower, damp)
    assert out["failures"] == [], out


@pytest.mark.parametrize("m,n", [(2000, 1000), (1000, 2000)])
def test_suite_gpu_criteria_hold_the_cpu_solve(m, n):
    """The GPU's count band ([80% of the CPU pin, pin + 3], anorm to 15%)
    admits the deterministic CPU solve, and every property of the solution
    is held as on the CPU."""
    out = check_suite_problem(m, n, 40, 2, 1e-8, platform="gpu")
    assert out["failures"] == [], out
    assert out["summary"]["istop"] == 3


def test_lstp_exact_acond_and_rnorm():
    """lstp publishes exact acond/rnorm (lsqrtest_module.f90:467-468,
    499-503); verify the generator against a dense SVD oracle."""
    m, n, nduplc, npower, damp = 80, 60, 10, 3, 1e-3
    prob = lstp(m, n, nduplc, npower, damp)
    a = np.asarray(prob.A.todense())
    s = np.linalg.svd(a, compute_uv=False)
    # singular values of A should be exactly the d_i (up to ordering)
    d = np.sort(np.asarray(prob.A.d))
    np.testing.assert_allclose(np.sort(s), d, rtol=1e-10)
    expected_acond = np.sqrt((d.max() ** 2 + damp**2) / (d.min() ** 2 + damp**2))
    np.testing.assert_allclose(float(prob.acond), expected_acond, rtol=1e-12)
    # b - A x_true has the published residual norm
    r = np.asarray(prob.b) - a @ np.asarray(prob.x_true)
    np.testing.assert_allclose(np.linalg.norm(r), float(prob.rnorm), rtol=1e-9)


def test_lstp_underdetermined_projection():
    """For m < n the true solution is projected onto the row space
    (lsqrtest_module.f90:474-481): A x_true must reproduce itself through
    the projector."""
    prob = lstp(30, 50, 5, 2, 0.0)
    a = np.asarray(prob.A.todense())
    xt = np.asarray(prob.x_true)
    # x_true lies in the row space of A: x = A^+ A x
    xproj = np.linalg.pinv(a) @ (a @ xt)
    np.testing.assert_allclose(xproj, xt, atol=1e-10)
