"""Paige–Saunders least-squares test-problem family.

Re-design of the reference's matrix-free test generator
(/root/reference/test/lsqrtest_module.f90): the implicit operator

    A = HY · D · HZ

where HY/HZ are Householder reflections and D is the m x n diagonal of
singular values with analytically known condition number. The matrix is
never materialized; mat-vec products are two rank-1 reflections + one
diagonal scale — elementwise work that XLA fuses into a handful of kernels.

Reference anchors:
  * hprod (Householder apply y = (I - 2 hz hz')x): lsqrtest_module.f90:385-403
  * aprod1/aprod2 (A x and A' y): lsqrtest_module.f90:319-377
  * lstp (problem construction incl. b = r + A x_true with known residual
    norm and exact acond): lsqrtest_module.f90:422-505
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import default_dtype
from ..ops.blas import nrm2
from ..ops.linop import LinearOperator

__all__ = ["PaigeSaundersOperator", "lstp", "LSTPProblem", "hprod", "suite_configs"]


def hprod(h: jax.Array, x: jax.Array) -> jax.Array:
    """Householder apply y = (I - 2 h h') x (lsqrtest_module.f90:385-403)."""
    return x - (2.0 * jnp.vdot(h, x)) * h


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PaigeSaundersOperator(LinearOperator):
    """Implicit A = HY * D * HZ (m x n).

    Fields hy (m,), hz (n,) are unit Householder vectors; d (min(m,n),) holds
    the singular values.
    """

    hy: jax.Array
    hz: jax.Array
    d: jax.Array

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.hy.shape[0]

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.hz.shape[0]

    @property
    def dtype(self):
        return self.d.dtype

    def matvec(self, x: jax.Array) -> jax.Array:
        # aprod1 (lsqrtest_module.f90:319-343): w = HZ x; w_d = D w
        # (truncate/zero-pad to m); y = HY w_d.
        m, n = self.m, self.n
        minmn = min(m, n)
        w = hprod(self.hz, x)
        wm = jnp.zeros((m,), self.dtype).at[:minmn].set(self.d * w[:minmn])
        return hprod(self.hy, wm)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        # aprod2 (lsqrtest_module.f90:353-377), transposed pipeline.
        m, n = self.m, self.n
        minmn = min(m, n)
        w = hprod(self.hy, y)
        wn = jnp.zeros((n,), self.dtype).at[:minmn].set(self.d * w[:minmn])
        return hprod(self.hz, wn)


class LSTPProblem(NamedTuple):
    A: PaigeSaundersOperator
    b: jax.Array        #: right-hand side b = r + A x_true
    x_true: jax.Array   #: true solution (projected for under-determined m<n)
    acond: jax.Array    #: exact condition number of Abar
    rnorm: jax.Array    #: exact residual norm ||r||


def lstp(
    m: int,
    n: int,
    nduplc: int,
    npower: int,
    damp: float,
    x_true=None,
    *,
    dtype=None,
) -> LSTPProblem:
    """Generate problem P(m, n, nduplc, npower, damp)
    (lstp, lsqrtest_module.f90:422-505).

    Singular values come in ``nduplc``-sized duplicated steps,
    d_i = (ceil((i+1)/nduplc) * nduplc / min(m,n))**npower (0-based i;
    reference loop at :460-465); the exact condition number is
    sqrt((d_max^2 + damp^2) / (d_min^2 + damp^2)) (:467-468).

    If ``x_true`` is None, uses the suite's default x_true[j] = 0.1*(j+1)
    (lsqrtest_module.f90:151-154, 1-based j).
    """
    dtype = dtype or default_dtype()
    minmn = min(m, n)
    damp = jnp.asarray(damp, dtype)
    dampsq = damp * damp

    # Householder vectors (lsqrtest_module.f90:443-455). The reference
    # normalizes then negates; the sign cancels in (I - 2 h h') so only the
    # normalization matters.
    fourpi = 4.0 * jnp.pi
    i_m = jnp.arange(1, m + 1, dtype=dtype)
    i_n = jnp.arange(1, n + 1, dtype=dtype)
    hy = jnp.sin(i_m * (fourpi / m))
    hz = jnp.cos(i_n * (fourpi / n))
    hy = -hy / nrm2(hy)
    hz = -hz / nrm2(hz)

    # Singular values in duplicated steps (:460-465).
    i0 = jnp.arange(minmn)
    j = i0 // nduplc + 1
    t = (j * nduplc).astype(dtype) / minmn
    d = t ** npower

    acond = jnp.sqrt((d[minmn - 1] ** 2 + dampsq) / (d[0] ** 2 + dampsq))

    A = PaigeSaundersOperator(hy=hy, hz=hz, d=d)

    # True solution: must have the form x = Z (w; 0) (:474-481). For m >= n
    # this leaves x unchanged; for m < n it projects out the trailing
    # null-space components.
    if x_true is None:
        x_true = 0.1 * jnp.arange(1, n + 1, dtype=dtype)
    else:
        x_true = jnp.asarray(x_true, dtype)
    w = hprod(hz, x_true)
    if m < n:
        w = w.at[m:].set(0.0)
    x_true = hprod(hz, w)

    # Residual construction (:484-497): solve D r1bar = dampsq x1bar,
    # r2bar = 1 (rows beyond minmn, present only if m > n), r = HY rbar.
    r = jnp.zeros((m,), dtype)
    r = r.at[:minmn].set(dampsq * w[:minmn] / d)
    if m > minmn:
        r = r.at[minmn:].set(1.0)
    r = hprod(hy, r)

    rnorm = nrm2(r)
    b = r + A.matvec(x_true)    # b = r + A x (:499-503)
    return LSTPProblem(A=A, b=b, x_true=x_true, acond=acond, rnorm=rnorm)


def suite_configs():
    """The 18 reference suite configurations (lsqrtest_module.f90:55-94):
    (m, n) in {(2000,1000), (1000,1000), (1000,2000)} x ndamp in 2..7 with
    nduplc=40, npower=ndamp, damp=10**(-ndamp-6).

    Yields (m, n, nduplc, npower, damp) tuples in reference order.
    """
    nbar, nduplc = 1000, 40
    for m, n in ((2 * nbar, nbar), (nbar, nbar), (nbar, 2 * nbar)):
        for ndamp in range(2, 8):
            yield (m, n, nduplc, ndamp, 10.0 ** (-ndamp - 6))


# Expectations for the 18 suite problems, from the reference's golden listing
# test/LSQR.LIS (tabulated in BASELINE.md) and from this implementation's
# own float64 runs. tests/test_suite.py and chip_smoke.py hold every solve
# to them through :func:`check_suite_problem`.
# (m, n, npower) -> (LIS itn, LIS rel.err, expected_pass) — BASELINE.md
# table, sources test/LSQR.LIS. LIS itn counts (g77/Xeon era) are kept as
# DOCUMENTATION; the pinned regression values are MEASURED_ITN below.
LIS_EXPECTATIONS = {
    (2000, 1000, 2): (72, 9.37e-14, True),
    (2000, 1000, 3): (105, 4.06e-11, True),
    (2000, 1000, 4): (154, 2.69e-08, True),
    (2000, 1000, 5): (224, 4.22e-05, True),
    (2000, 1000, 6): (209, 7.58e-03, False),   # documented expected failure
    (2000, 1000, 7): (198, 2.21e-02, False),   # documented expected failure
    (1000, 1000, 2): (102, 1.04e-14, True),
    (1000, 1000, 3): (174, 1.08e-13, True),
    (1000, 1000, 4): (232, 4.53e-12, True),
    (1000, 1000, 5): (318, 3.91e-11, True),
    (1000, 1000, 6): (498, 3.61e-09, True),
    (1000, 1000, 7): (753, 6.54e-08, True),
    (1000, 2000, 2): (102, 4.73e-15, True),
    (1000, 2000, 3): (151, 4.33e-13, True),
    (1000, 2000, 4): (235, 1.05e-11, True),
    (1000, 2000, 5): (330, 1.04e-10, True),
    (1000, 2000, 6): (512, 2.25e-09, True),
    (1000, 2000, 7): (758, 2.67e-08, True),
}

# Iteration counts MEASURED by this implementation (x64, deterministic):
# pinned to +-3 so a recurrence regression that shifts convergence shows up
# immediately (the old +-25%-of-LIS band could
# hide a 20% slowdown). Counts are rounding-sensitive (lsqr.f90:429-430);
# ours run from 10% below to 13% above the 2005 g77 listing.
MEASURED_ITN = {
    (2000, 1000, 2): 67,
    (2000, 1000, 3): 103,
    (2000, 1000, 4): 151,
    (2000, 1000, 5): 203,
    (2000, 1000, 6): 202,
    (2000, 1000, 7): 187,
    (1000, 1000, 2): 98,
    (1000, 1000, 3): 158,
    (1000, 1000, 4): 209,
    (1000, 1000, 5): 318,
    (1000, 1000, 6): 488,
    (1000, 1000, 7): 706,
    (1000, 2000, 2): 96,
    (1000, 2000, 3): 170,
    (1000, 2000, 4): 214,
    (1000, 2000, 5): 325,
    (1000, 2000, 6): 483,
    (1000, 2000, 7): 701,
}

# Exit-block norm estimates recorded in the golden listing: (anorm, acond,
# bnorm, xnorm, rnorm, arnorm) per problem, from the 'Exit LSQR' blocks
# (the reference's test/LSQR.LIS:52-58 and the 17 analogous blocks).
# bnorm/xnorm/rnorm are properties of the converged solve and match to the
# listing's 6 printed digits; anorm/acond are RUNNING estimates accumulated
# to the (slightly different) stopping iteration, so they carry an itn-
# dependent band; arnorm is noise-level at convergence (order-of-magnitude
# check only).
LIS_EXIT_NORMS = {
    (2000, 1000, 2): (4.94062e0, 3.22385e3, 1.25076e3, 1.82711e3, 3.16228e1, 2.35170e-15),
    (2000, 1000, 3): (5.68664e0, 8.96364e4, 1.12476e3, 1.82711e3, 3.16228e1, 5.26981e-14),
    (2000, 1000, 4): (6.58996e0, 2.57947e6, 1.03680e3, 1.82711e3, 3.16228e1, 8.19002e-15),
    (2000, 1000, 5): (7.77584e0, 7.59737e7, 9.71549e2, 1.82711e3, 3.16228e1, 1.37365e-14),
    (2000, 1000, 6): (7.40911e0, 2.83762e7, 9.21079e2, 1.82706e3, 3.16228e1, 1.51381e-14),
    (2000, 1000, 7): (7.09548e0, 1.99869e7, 8.80846e2, 1.82666e3, 3.16228e1, 3.45841e-14),
    (1000, 1000, 2): (5.83666e0, 5.36980e3, 1.25036e3, 1.82711e3, 1.82711e-5, 3.29871e-20),
    (1000, 1000, 3): (7.22692e0, 1.61087e5, 1.12431e3, 1.82711e3, 1.82711e-6, 1.66113e-23),
    (1000, 1000, 4): (8.05840e0, 3.16065e6, 1.03632e3, 1.82711e3, 1.82711e-7, 2.11090e-22),
    (1000, 1000, 5): (9.23868e0, 9.03112e7, 9.71035e2, 1.82711e3, 1.82711e-8, 4.94552e-23),
    (1000, 1000, 6): (1.12949e1, 2.75822e9, 9.20536e2, 1.82711e3, 1.82711e-9, 2.63909e-24),
    (1000, 1000, 7): (1.38114e1, 8.43030e10, 8.80278e2, 1.82711e3, 1.82711e-10, 2.82782e-25),
    (1000, 2000, 2): (5.83659e0, 5.36973e3, 1.24934e3, 1.82711e3, 1.82711e-5, 6.00127e-21),
    (1000, 2000, 3): (6.75962e0, 1.07441e5, 1.12336e3, 1.82711e3, 1.82711e-6, 2.99870e-21),
    (1000, 2000, 4): (8.13520e0, 3.19077e6, 1.03550e3, 1.82711e3, 1.82711e-7, 3.65295e-22),
    (1000, 2000, 5): (9.42730e0, 9.21551e7, 9.70353e2, 1.82711e3, 1.82711e-8, 2.79529e-23),
    (1000, 2000, 6): (1.15326e1, 2.81628e9, 9.19970e2, 1.82711e3, 1.82711e-9, 1.41815e-25),
    (1000, 2000, 7): (1.38884e1, 8.47732e10, 8.79805e2, 1.82711e3, 1.82711e-10, 4.41016e-25),
}



def check_suite_problem(m, n, nduplc, npower, damp, platform=None):
    """Solve one suite problem as the reference driver does
    (lsqrtest_module.f90:119-272) and hold it to the suite's criteria.

    ``platform`` (default: JAX's backend) selects how the iteration count
    and the running ``anorm`` estimate are held; every property of the
    solution is held the same everywhere. Returns ``{"summary": {...},
    "failures": [...]}``; an empty failure list means the problem passed
    every check."""
    import numpy as np

    from ..diagnostics import acheck, xcheck
    from ..solver import lsqr

    # The count is rounding-sensitive: the CPU pin itself sits up to 13%
    # from the listing (P(1000,2000,3): 170 against 151). On the CPU it is
    # deterministic and pinned to MEASURED_ITN +-3. On a GPU it moves from
    # one process to the next, because XLA's autotuner picks kernels by
    # timing in each process (with --xla_gpu_autotune_level=0 the counts
    # repeat across processes), and runs below the CPU pin on the
    # ill-conditioned problems (on an H100 from 18% below, P(1000,2000,3)
    # at 140, to 3% above). There it is held to [80% of the
    # pin, pin + 3], so a slowdown of more than 3 iterations still fails,
    # and the anorm estimate, which grows with the count, to 15% of the
    # listing (10.5% seen).
    exact_itn = (platform or jax.default_backend()) == "cpu"
    eps = np.finfo(np.float64).eps
    prob = lstp(m, n, nduplc, npower, damp)
    failures = []

    # acheck gate (lsqrtest_module.f90:183-188)
    chk = acheck(prob.A)
    if int(chk.inform) != 0:
        return {"summary": {}, "failures": [
            f"aprod inconsistent: {float(chk.error)}"]}

    res = lsqr(
        prob.A, prob.b, damp,
        atol=eps**0.99, btol=eps**0.99,
        conlim=1000.0 * float(prob.acond), itnlim=4 * (m + n + 50),
    )
    lis_itn, lis_err, expect_pass = LIS_EXPECTATIONS[(m, n, npower)]
    if int(res.istop) != 3:
        failures.append(f"istop={int(res.istop)} (LIS: 3)")

    # exit-block norm parity vs the golden listing (LSQR.LIS:52-58 et al.)
    anorm_l, acond_l, bnorm_l, xnorm_l, rnorm_l, arnorm_l = (
        LIS_EXIT_NORMS[(m, n, npower)]
    )
    for name, got, want in (("bnorm", res.bnorm, bnorm_l),
                            ("xnorm", res.xnorm, xnorm_l),
                            ("rnorm", res.rnorm, rnorm_l)):
        if not abs(float(got) - want) <= 1e-4 * abs(want):
            failures.append(f"{name}={float(got):.6e}, LIS={want:.6e}")
    # anorm/acond are running estimates accumulated to the stopping
    # iteration, which differs a few % from the 2005 listing; measured
    # deviations are <=6% (anorm) and <=48% (acond) — band accordingly.
    anorm_band = 0.10 if exact_itn else 0.15
    if not abs(float(res.anorm) - anorm_l) <= anorm_band * anorm_l:
        failures.append(f"anorm={float(res.anorm):.6e}, LIS={anorm_l:.6e}")
    if not acond_l / 2 <= float(res.acond) <= 2 * acond_l:
        failures.append(f"acond={float(res.acond):.3e}, LIS={acond_l:.3e}")
    # arnorm is noise-level at convergence: same order of magnitude or
    # better (measured worst case 99x above the listing's)
    if not float(res.arnorm) <= 1e3 * arnorm_l:
        failures.append(f"arnorm={float(res.arnorm):.3e}, LIS={arnorm_l:.3e}")

    # xcheck classification (lsqrtest_module.f90:216-218)
    xc = xcheck(prob.A, b=prob.b, x=res.x, damp=damp, anorm=res.anorm)
    if int(xc.inform) not in (1, 2, 3):
        failures.append(f"xcheck inform {int(xc.inform)}")

    # solution accuracy (etol = 1e-3, :236-241)
    enorm = float(nrm2(res.x - prob.x_true) / (1.0 + nrm2(prob.x_true)))
    if expect_pass:
        if not enorm <= 1e-3:
            failures.append(f"rel err {enorm:.3e} (LIS: {lis_err:.2e})")
        # stay within an order of magnitude of the recorded accuracy
        if not enorm <= max(lis_err * 30, 1e-12):
            failures.append(
                f"rel err {enorm:.3e} much worse than LIS {lis_err:.2e}")
    elif not enorm <= 0.2:
        # documented 'appears to have failed' problems: the same ballpark
        # misfit, not success (lsqrtest_module.f90:110-115)
        failures.append(f"rel err {enorm:.3e} beyond 0.2")

    # iteration-count regression pin (see above)
    itn = int(res.itn)
    measured = MEASURED_ITN[(m, n, npower)]
    lo = measured - 3 if exact_itn else int(0.8 * measured)
    if not lo <= itn <= measured + 3:
        failures.append(f"itn={itn}, pinned={measured} in [{lo}, "
                        f"{measured + 3}] (LIS: {lis_itn})")
    return {
        "summary": {"istop": int(res.istop), "itn": itn, "rel_err": enorm,
                    "anorm": float(res.anorm),
                    "xcheck_inform": int(xc.inform)},
        "failures": failures,
    }
