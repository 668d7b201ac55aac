"""Regularization-path utilities on top of :func:`lsqr_tpu.lsqr_multidamp`.

The reference solves one damp value per LSQR call (damped problem statement,
/root/reference/src/lsqr.f90:264-273) and leaves choosing ``damp`` entirely
to the user. These helpers answer the two standard questions on the
device's terms — the whole damp grid costs ONE bidiagonalization sweep (2 operator
products per iteration TOTAL, shared by every grid point):

* :func:`reg_sweep` — solve a damp grid, return the path quantities
  (per-damp true residual norm ``||b - A x||``, solution norm, x).
* :func:`discrepancy_damp` — Morozov's discrepancy principle: the largest
  damp whose residual does not exceed ``tau * noise_norm``.
* :func:`lcurve_corner` — Hansen's L-curve corner: the grid point of
  maximum curvature of (log residual, log solution norm).

The true (unaugmented) residual norm is recovered from the solver's own
exit estimates without extra products: LSQR's rnorm is the AUGMENTED
residual ``||[b - Ax; -damp x]||`` (lsqr.f90:545-549), so

    ||b - A x||^2 = rnorm^2 - damp^2 * xnorm^2

(clamped at 0 for roundoff). ``reg_sweep(exact_residual=True)`` instead
spends one extra matvec per damp for the directly-computed norm.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .config import LSQROptions
from .multidamp import lsqr_multidamp
from .ops.linop import as_operator
from .solver import LSQRResult

__all__ = [
    "RegPath", "reg_sweep", "discrepancy_damp", "lcurve_corner", "gcv_damp",
]


class RegPath(NamedTuple):
    """A solved regularization path over a damp grid."""

    damps: jax.Array           #: (k,) the grid
    x: jax.Array               #: (k, n) solutions
    residual_norm: jax.Array   #: (k,) ||b - A x_j|| (true, unaugmented)
    solution_norm: jax.Array   #: (k,) ||x_j||
    result: LSQRResult         #: full multi-damp result (istop/itn/estimates)


def reg_sweep(
    A,
    b,
    damps=None,
    *,
    num: int = 16,
    damp_min: Optional[float] = None,
    damp_max: Optional[float] = None,
    exact_residual: bool = False,
    options: Optional[LSQROptions] = None,
    **option_overrides,
) -> RegPath:
    """Solve ``min ||[A; damp I] x - [b; 0]||`` over a damp grid.

    Args:
      damps: explicit grid (1-D, ascending or not). If None, a log-spaced
        grid of ``num`` points on [damp_min, damp_max]; the default range
        is anchored at the data scale, ``[1e-6, 1] * ||A'b|| / ||b||``
        (alpha_1 of the bidiagonalization — the scale above which damping
        dominates the spectrum).
      exact_residual: recompute ``||b - A x_j||`` with one matvec per damp
        instead of using the exit-estimate identity (see module docstring).

    Returns a :class:`RegPath`.
    """
    A = as_operator(A)
    b = jnp.asarray(b)
    if damps is None:
        if damp_max is None or damp_min is None:
            bn = jnp.linalg.norm(b)
            scale = float(
                jnp.linalg.norm(A.rmatvec(b / jnp.where(bn > 0, bn, 1.0)))
            )
            scale = scale if scale > 0 else 1.0
            damp_max = damp_max if damp_max is not None else scale
            damp_min = damp_min if damp_min is not None else 1e-6 * scale
        damps = jnp.logspace(
            jnp.log10(jnp.asarray(damp_min)), jnp.log10(jnp.asarray(damp_max)), num
        )
    damps = jnp.atleast_1d(jnp.asarray(damps))
    res = lsqr_multidamp(A, b, damps, options=options, **option_overrides)
    # damps/norms stay REAL also for complex solutions
    damps = damps.astype(jnp.zeros((), res.x.dtype).real.dtype)
    if exact_residual:
        from .ops.blas import abs2

        resid = b[None, :] - jax.vmap(A.matvec)(res.x)
        residual_norm = jnp.sqrt(jnp.sum(abs2(resid), axis=-1))
        solution_norm = jnp.sqrt(jnp.sum(abs2(res.x), axis=-1))
    else:
        # ||b - Ax||^2 = rnorm_aug^2 - damp^2 ||x||^2  (lsqr.f90:545-549)
        residual_norm = jnp.sqrt(
            jnp.maximum(
                jnp.square(res.rnorm) - jnp.square(damps * res.xnorm), 0.0
            )
        )
        solution_norm = res.xnorm
    return RegPath(
        damps=damps,
        x=res.x,
        residual_norm=residual_norm,
        solution_norm=solution_norm,
        result=res,
    )


def discrepancy_damp(
    A,
    b,
    noise_norm: float,
    *,
    tau: float = 1.0,
    damps=None,
    num: int = 16,
    options: Optional[LSQROptions] = None,
    **option_overrides,
) -> tuple[jax.Array, jax.Array, RegPath]:
    """Morozov's discrepancy principle on a damp grid.

    Picks the LARGEST grid damp whose residual satisfies
    ``||b - A x|| <= tau * noise_norm`` (the most-regularized solution
    consistent with the noise); if no grid point satisfies it, the damp
    with the smallest residual is returned.

    Returns ``(damp, x, path)``.
    """
    path = reg_sweep(
        A, b, damps, num=num, options=options, **option_overrides
    )
    target = jnp.asarray(tau * noise_norm, path.residual_norm.dtype)
    ok = path.residual_norm <= target
    order = jnp.argsort(path.damps)
    ok_sorted = ok[order]
    # index of the largest acceptable damp in the sorted grid
    idx_sorted = jnp.where(
        jnp.any(ok_sorted),
        (ok_sorted * jnp.arange(ok_sorted.shape[0])).max(),
        jnp.argmin(path.residual_norm[order]),
    )
    idx = order[idx_sorted]
    return path.damps[idx], path.x[idx], path


def lcurve_corner(path: RegPath) -> tuple[jax.Array, jax.Array, jax.Array]:
    """The L-curve corner of a solved path: the grid point maximizing the
    curvature of ``(log ||b - Ax||, log ||x||)`` (Hansen 1992), estimated
    with centered finite differences along the (sorted-by-damp) grid.

    Returns ``(damp, x, curvature)`` where curvature is the (k,) signed
    curvature per grid point (endpoints get -inf). Grids should have
    k >= 3 points; ill-defined otherwise.
    """
    if path.damps.shape[0] < 3:
        raise ValueError("lcurve_corner needs a grid of at least 3 damps")
    order = jnp.argsort(path.damps)
    eps = jnp.finfo(path.residual_norm.dtype).tiny
    lr = jnp.log(path.residual_norm[order] + eps)
    lx = jnp.log(path.solution_norm[order] + eps)
    t = jnp.log(path.damps[order] + eps)  # parameterize by log-damp
    dt = jnp.gradient(t)
    dr = jnp.gradient(lr) / dt
    dx = jnp.gradient(lx) / dt
    ddr = jnp.gradient(dr) / dt
    ddx = jnp.gradient(dx) / dt
    denom = (dr**2 + dx**2) ** 1.5
    kappa = (dr * ddx - ddr * dx) / jnp.where(denom > 0, denom, 1.0)
    kappa = kappa.at[0].set(-jnp.inf).at[-1].set(-jnp.inf)
    i_sorted = jnp.argmax(kappa)
    idx = order[i_sorted]
    curv = jnp.full_like(kappa, -jnp.inf).at[order].set(kappa)
    return path.damps[idx], path.x[idx], curv


def gcv_damp(
    A,
    b,
    *,
    damps=None,
    num: int = 16,
    probes: int = 1,
    key=None,
    options: Optional[LSQROptions] = None,
    **option_overrides,
) -> tuple[jax.Array, jax.Array, RegPath, jax.Array]:
    """Generalized cross-validation (Golub-Heath-Wahba 1979) on a damp grid.

    Minimizes  GCV(damp) = m * ||b - A x_damp||^2 / trace(I - H_damp)^2
    where H_damp = A (A'A + damp^2 I)^-1 A' is the influence matrix. The
    trace is estimated stochastically (Hutchinson): for a Rademacher probe
    w,  trace(H) ~ w' A y_w  with  y_w = (A'A + damp^2 I)^-1 A' w — i.e.
    y_w is exactly the damped LSQR solution with right-hand side w. So the
    whole GCV curve costs (1 + probes) multi-damp sweeps, each of which is
    ONE shared bidiagonalization (no noise-level knowledge needed, unlike
    :func:`discrepancy_damp`).

    Returns ``(damp, x, path, gcv_values)`` — gcv_values aligned with
    ``path.damps``.
    """
    A = as_operator(A)
    b = jnp.asarray(b)
    path = reg_sweep(
        A, b, damps, num=num, options=options, **option_overrides
    )
    damps_arr = path.damps
    m = int(getattr(A, "global_m", A.m))
    if key is None:
        key = jax.random.PRNGKey(0)
    trace_h = jnp.zeros((damps_arr.shape[0],), path.residual_norm.dtype)
    for p in range(probes):
        key, sub = jax.random.split(key)
        w = jax.random.rademacher(sub, (A.m,), dtype=b.dtype)
        probe = lsqr_multidamp(
            A, w, damps_arr, options=options, **option_overrides
        )
        # w' A y_w per damp; A applied to the (k, n) solutions via vmap so
        # structured operators keep their fast product path
        ay = jax.vmap(A.matvec)(probe.x)
        trace_h = trace_h + ay @ w / probes
    denom = jnp.maximum(m - trace_h, jnp.finfo(trace_h.dtype).tiny)
    gcv = m * jnp.square(path.residual_norm) / jnp.square(denom)
    idx = jnp.argmin(gcv)
    return path.damps[idx], path.x[idx], path, gcv
