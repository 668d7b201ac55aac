"""Hybrid LSQR — Golub–Kahan projection + Tikhonov on the projected problem.

Plain LSQR applied to a noisy ill-posed problem SEMICONVERGES: the iterates
approach the true solution and then diverge as the Krylov subspace starts
resolving noise-dominated singular directions (the reference can only
mitigate this with a fixed ``damp`` chosen in advance, lsqr.f90:264-273).
The hybrid approach (Chung, Nagy & O'Leary 2008 "HyBR"; O'Leary & Simmons
1981) regularizes the PROJECTED problem instead:

1. run the Golub–Kahan bidiagonalization of (A, b) — the same recurrence as
   LSQR's (lsqr.f90:681-699) — storing the right Lanczos basis V_k and the
   bidiagonal coefficients (alpha, beta);
2. at each k, solve the (k+1) x k Tikhonov problem
       min || B_k y - beta_1 e_1 ||^2 + lam^2 ||y||^2
   with ``lam`` chosen per-iteration by GCV on the projected problem (an
   O(k^3) SVD of a tiny bidiagonal matrix — host-side, free next to the
   O(nnz) products);
3. x_k = V_k y_k; stop when the GCV value stabilizes/increases
   (semiconvergence detected on the projected problem, not by eye).

Device/host split: the expensive part (the products + the (k, n) basis
buffer) is one jitted ``lax.fori_loop`` with optional full
reorthogonalization of v against the stored basis (two extra GEMVs per
iteration — this is what keeps the projected problem faithful in
f32); the tiny dense B_k analysis runs in numpy on the host.

``golub_kahan`` is also exposed on its own: the stored-basis factorization
is independently useful (subspace recycling, out-of-core reconstruction,
model reduction).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ops.blas import nrm2
from .ops.linop import as_operator

#: float32 products feeding a solver run at full precision, not TF32
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["GKBasis", "golub_kahan", "HybridResult", "hybrid_lsqr",
           "projected_tikhonov", "gcv_lambda"]


class GKBasis(NamedTuple):
    """A k-step Golub–Kahan bidiagonalization of (A, b):
    ``A V_k' = U_{k+1} B_k`` with ``B_k`` lower-bidiagonal
    (diag ``alpha``, subdiag ``beta[1:]``), ``beta[0] = ||b||``.

    V is stored ROW-major: V[i] is the i-th right Lanczos vector (n,)."""

    V: jax.Array        #: (k, n) right Lanczos basis
    alpha: jax.Array    #: (k,) B_k diagonal
    beta: jax.Array     #: (k+1,) beta[0] = ||b||, beta[1:] = subdiagonal
    k: int              #: steps taken (static)

    def bidiagonal(self) -> np.ndarray:
        """Materialize B_k as a dense (k+1, k) numpy array."""
        k = self.k
        B = np.zeros((k + 1, k))
        a = np.asarray(self.alpha)
        bsub = np.asarray(self.beta[1:])
        B[np.arange(k), np.arange(k)] = a
        B[np.arange(1, k + 1), np.arange(k)] = bsub
        return B


@partial(jax.jit, static_argnames=("k", "reorth", "safe_norms"))
def _gk_impl(A, b, *, k: int, reorth: bool, safe_norms: bool):
    n = A.local_n if hasattr(A, "local_n") else A.n
    dtype = b.dtype
    # complex extension: the Lanczos vectors are complex, the bidiagonal
    # coefficients alpha/beta are REAL (they are norms; rmatvec is the
    # conjugate-transpose product — see solver._build), so the projected
    # (k+1, k) problem and all of the GCV analysis stay real
    rdtype = jnp.zeros((), dtype).real.dtype
    zero = jnp.zeros((), rdtype)
    one = jnp.ones((), rdtype)
    axis_m = getattr(A, "axis_name_m", None)
    axis_n = getattr(A, "axis_name_n", None)

    def norm_m(vec):
        return nrm2(vec, safe=safe_norms, axis_name=axis_m)

    def norm_n(vec):
        return nrm2(vec, safe=safe_norms, axis_name=axis_n)

    beta0 = norm_m(b)
    safe_b0 = jnp.where(beta0 > zero, beta0, one)
    u0 = jnp.where(beta0 > zero, b / safe_b0, b)
    v0u = A.rmatvec(u0)
    alpha0 = norm_n(v0u)
    safe_a0 = jnp.where(alpha0 > zero, alpha0, one)
    v0 = jnp.where(alpha0 > zero, v0u / safe_a0, v0u)

    V = jnp.zeros((k, n), dtype).at[0].set(v0)
    alphas = jnp.zeros((k,), rdtype).at[0].set(alpha0)
    betas = jnp.zeros((k + 1,), rdtype).at[0].set(beta0)

    def body(i, carry):
        u, v, V, alphas, betas = carry
        alpha_i = alphas[i - 1]
        u_new = A.matvec(v) - alpha_i * u
        beta_new = norm_m(u_new)
        bpos = beta_new > zero
        safe_beta = jnp.where(bpos, beta_new, one)
        u_new = jnp.where(bpos, u_new / safe_beta, u_new)
        v_cand = A.rmatvec(u_new) - beta_new * v
        if reorth:
            # full one-sided reorthogonalization against the stored basis:
            # rows > i-1 are still zero so they contribute nothing. Two
            # GEMVs on the (k, n) buffer — negligible next to
            # the operator products for k << nnz/n. The projection
            # coefficients are <v_i, v_cand> = conj(V) @ v_cand (conj is
            # the identity for real bases).
            coeff = jnp.matmul(jnp.conj(V), v_cand, precision=_HIGHEST)
            if axis_n is not None:
                coeff = jax.lax.psum(coeff, axis_n)
            v_cand = v_cand - jnp.matmul(V.T, coeff, precision=_HIGHEST)
        alpha_new = norm_n(v_cand)
        apos = alpha_new > zero
        safe_alpha = jnp.where(apos, alpha_new, one)
        v_new = jnp.where(apos, v_cand / safe_alpha, v_cand)
        V = V.at[i].set(v_new)
        alphas = alphas.at[i].set(alpha_new)
        betas = betas.at[i].set(beta_new)
        return u_new, v_new, V, alphas, betas

    u, v, V, alphas, betas = jax.lax.fori_loop(
        1, k, body, (u0, v0, V, alphas, betas)
    )
    # the trailing beta_{k+1} (closes B_k's last column)
    u_last = A.matvec(v) - alphas[k - 1] * u
    betas = betas.at[k].set(norm_m(u_last))
    return V, alphas, betas


def golub_kahan(A, b, k: int, *, reorth: bool = True,
                safe_norms: bool = True) -> GKBasis:
    """k steps of Golub–Kahan bidiagonalization of (A, b) with the right
    Lanczos basis stored (optionally fully reorthogonalized).

    Memory: the (k, n) basis buffer. Cost per step: the same two operator
    products as an LSQR iteration, plus two (k, n) GEMVs when ``reorth``.
    """
    A = as_operator(A)
    b = jnp.asarray(b)
    if not jnp.issubdtype(b.dtype, jnp.inexact):  # ints -> default float
        from .config import default_dtype

        b = b.astype(default_dtype())
    if k < 1:
        raise ValueError("k must be >= 1")
    kmax = int(min(getattr(A, "global_m", A.m), getattr(A, "global_n", A.n)))
    if k > kmax:
        raise ValueError(f"k = {k} exceeds min(m, n) = {kmax}")
    V, alphas, betas = _gk_impl(A, b, k=k, reorth=reorth,
                                safe_norms=safe_norms)
    return GKBasis(V=V, alpha=alphas, beta=betas, k=k)


# ---------------------------------------------------------------------------
# Projected-problem analysis (host-side numpy: B_k is (k+1, k), tiny)
# ---------------------------------------------------------------------------


def projected_tikhonov(B: np.ndarray, beta0: float, lam: float) -> np.ndarray:
    """Solve ``min ||B y - beta0 e1||^2 + lam^2 ||y||^2`` for the tiny
    projected bidiagonal system (dense SVD; exact)."""
    P, s, Qt = np.linalg.svd(B, full_matrices=False)
    rhs = P.T[:, 0] * beta0          # P' (beta0 e1)
    f = s / (s**2 + lam**2)          # Tikhonov filter factors
    return Qt.T @ (f * rhs)


def gcv_lambda(B: np.ndarray, beta0: float, *,
               grid: Optional[np.ndarray] = None,
               weight: float = 1.0) -> tuple[float, float]:
    """GCV-minimizing lambda for the projected problem (Golub-Heath-Wahba;
    the weighted variant of Chung-Nagy-O'Leary 2008 via ``weight`` = omega).

    GCV(lam) = k * ||B y - beta0 e1||^2_aug / (m_p - weight * sum(f_i))^2
    evaluated exactly through the SVD of B. Returns (lam, gcv_min).
    """
    P, s, _ = np.linalg.svd(B, full_matrices=False)
    m_p = B.shape[0]
    bt = P[0, :] * beta0                         # P' (beta0 e1), length k
    # residual component outside span(P)
    r_perp2 = beta0**2 - float(bt @ bt)
    if grid is None:
        smax, smin = float(s.max()), float(max(s.min(), 1e-300))
        grid = np.logspace(np.log10(smin) - 2, np.log10(smax) + 1, 200)
    best = (float(grid[0]), np.inf)
    for lam in grid:
        f = s**2 / (s**2 + lam**2)               # hat-matrix eigenvalues
        resid2 = float(np.sum(((1 - f) * bt) ** 2)) + max(r_perp2, 0.0)
        denom = m_p - weight * float(np.sum(f))
        g = m_p * resid2 / denom**2
        if g < best[1]:
            best = (float(lam), g)
    return best


class HybridResult(NamedTuple):
    """Hybrid-LSQR outputs."""

    x: jax.Array          #: (n,) regularized solution V_k' y
    lam: float            #: lambda chosen at the selected iteration
    k: int                #: selected iteration (projected-GCV stopping)
    k_run: int            #: bidiagonalization steps actually taken
    gcv: np.ndarray       #: (k_run,) per-iteration GCV minima
    lambdas: np.ndarray   #: (k_run,) per-iteration GCV-chosen lambdas
    basis: GKBasis        #: the factorization (reusable for other rhs/lams)


def hybrid_lsqr(
    A,
    b,
    k: int = 50,
    *,
    lam: Optional[float] = None,
    weight: float = 1.0,
    reorth: bool = True,
    stop_window: int = 4,
    stop_tol: float = 1e-4,
    safe_norms: bool = True,
) -> HybridResult:
    """Hybrid regularization: LSQR's bidiagonalization + per-iteration
    Tikhonov on the projected problem with GCV-chosen lambda.

    Args:
      k: maximum bidiagonalization steps (the (k, n) basis is stored).
      lam: fix lambda instead of choosing it by GCV per iteration.
      weight: GCV weight omega (1.0 = plain GCV; < 1 is the W-GCV of
        Chung-Nagy-O'Leary, smoother for severely ill-posed problems).
      reorth: full reorthogonalization of the v-basis (keeps the projected
        problem faithful; strongly recommended — it is what makes this
        reliable in f32).
      stop_window: stop early once the per-iteration GCV minimum has not
        improved *significantly* for this many consecutive steps
        (semiconvergence detection); the basis is still returned up to the
        stop point.
      stop_tol: an improvement counts as significant only if it exceeds
        ``stop_tol * GCV(1)`` — the flat-GCV criterion of HyBR, measured
        against the initial GCV scale (the per-step decrement decays toward
        zero but rarely reaches exactly zero, so a relative-to-current-best
        test would never fire).

    Returns a :class:`HybridResult`; ``result.basis`` can be reused (e.g.
    re-solve with a different lambda via :func:`projected_tikhonov`
    without touching A again).
    """
    A = as_operator(A)
    basis = golub_kahan(A, b, k, reorth=reorth, safe_norms=safe_norms)
    beta0 = float(basis.beta[0])
    alphas = np.asarray(basis.alpha)
    betas = np.asarray(basis.beta)

    gcv_hist = np.full((k,), np.inf)
    lam_hist = np.zeros((k,))
    best_k, best_gcv, best_lam = 1, np.inf, 0.0
    since_improve = 0
    for kk in range(1, k + 1):
        B = np.zeros((kk + 1, kk))
        B[np.arange(kk), np.arange(kk)] = alphas[:kk]
        B[np.arange(1, kk + 1), np.arange(kk)] = betas[1:kk + 1]
        if lam is None:
            lam_k, g = gcv_lambda(B, beta0, weight=weight)
        else:
            lam_k = float(lam)
            y = projected_tikhonov(B, beta0, lam_k)
            r = B @ y
            r[0] -= beta0
            # the same GCV objective, evaluated at the fixed lambda
            P, s, _ = np.linalg.svd(B, full_matrices=False)
            f = s**2 / (s**2 + lam_k**2)
            g = (kk + 1) * float(r @ r) / (
                (kk + 1) - weight * float(np.sum(f))) ** 2
        gcv_hist[kk - 1] = g
        lam_hist[kk - 1] = lam_k
        significant = g < best_gcv - stop_tol * gcv_hist[0]
        if g < best_gcv:
            best_k, best_gcv, best_lam = kk, g, lam_k
        if significant:
            since_improve = 0
        else:
            since_improve += 1
            if since_improve >= stop_window:
                break
    k_run = kk

    Bb = np.zeros((best_k + 1, best_k))
    Bb[np.arange(best_k), np.arange(best_k)] = alphas[:best_k]
    Bb[np.arange(1, best_k + 1), np.arange(best_k)] = betas[1:best_k + 1]
    y = projected_tikhonov(Bb, beta0, best_lam)
    x = jnp.matmul(jnp.asarray(y, basis.V.dtype), basis.V[:best_k],
                   precision=_HIGHEST)
    return HybridResult(
        x=x, lam=best_lam, k=best_k, k_run=k_run,
        gcv=gcv_hist[:k_run], lambdas=lam_hist[:k_run], basis=basis,
    )
