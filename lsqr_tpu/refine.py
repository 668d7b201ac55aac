"""Mixed-precision iterative refinement: f32 device solves, f64 accuracy.

The reference runs in compile-time-selected precision and notes that
accuracy/iterations are precision-bound (lsqr.f90:429-430); its
warm-start recipe — solve ``A dx = b - A x0``, ``x = x0 + dx``
(lsqr.f90:303-320) — is one refinement step with the residual computed in
WORKING precision, so it cannot beat that precision. On the GPU the fast
working precision is float32 (f64 runs natively at about half the
streaming rate); this module
turns the correction trick into a precision ladder:

**Augmented-system refinement** (Bjorck 1967 for least squares). Keep
BOTH the solution ``x`` and the residual ``r`` as float64 host state and
refine the pair. The damped LS optimum satisfies

    r + A x = b          (definition of the residual)
    A' r    = damp^2 x   (normal-equation optimality)

so each cycle evaluates the two defect vectors in float64 on the host

    f = b - r - A x,      g = damp^2 x - A' r

and solves the correction system ``dr + A dx = f``, ``A' dr - damp^2 dx
= g`` in float32 on the device. Eliminating ``dr = f - A dx`` gives

    (A'A + damp^2 I) dx = A' f - g.

- damp > 0: that is exactly the stacked problem
  ``min || [A; damp I] dx - [f; -g/damp] ||`` — ONE inner solve.
- damp = 0: split by linearity. ``w = argmin || A' w + g ||`` (compatible
  since g is in range(A')), then ``dx = argmin || A dx - (f + w) ||`` —
  TWO inner solves, both with right-hand sides that SHRINK as the outer
  iteration converges.

Because every inner right-hand side shrinks, the f32 rounding noise each
cycle is an ABSOLUTE error proportional to shrinking quantities — the
iterate converges to the LS solution OF THE STORED (f32) MATRIX to
near-f64 accuracy, for compatible AND incompatible problems. (The naive
scheme that refines x alone floors at eps_f32 * ||r_LS|| / sigma_min on
incompatible problems — the augmented form is what removes that term.)

**Conditioning.** The per-cycle contraction factor is the relative
accuracy of the f32 inner solves, roughly eps_f32 * cond(A): beyond
cond ~ 1e5 the plain scheme stops contracting. ``precondition='auto'``
(default) detects that and switches the inner solves to the LSRN
preconditioner: sketched in f64 on the host and, when the (m, rank)
product fits, FOLDED to ``B = fl32(A N)`` so even the composed product's
eps32 * cond noise disappears — measured ~1e-13 at cond 1e4, ~1e-11 at
1e6 and ~3e-10 at 1e8 (docs/precision.md), all at f32 device speed.
Passing f64 ``host_matvec``/``host_rmatvec`` closures over unrounded
data makes the refinement converge to the F64 problem's solution (the
device still only stores f32) — the full x64-emulation replacement.

Cost per cycle: 1-2 ordinary f32 device solves (all fast paths apply:
DIA/JDIA Pallas kernels, bounded loop, sharding) + two host f64 SpMVs
from :func:`lsqr_tpu.ops.host.host_products` (scipy CSR of the stored
matrix, built once) or user-supplied host closures.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from .ops.linop import as_operator

__all__ = ["RefineResult", "lsqr_refined"]


class RefineResult(NamedTuple):
    """Outputs of :func:`lsqr_refined`."""

    x: np.ndarray          #: (n,) float64 refined solution
    r: np.ndarray          #: (m,) float64 refined residual estimate b - A x
    results: tuple         #: inner solver result(s) per cycle
    cycles: int            #: refinement cycles actually run
    dx_norms: np.ndarray   #: ||dx|| per cycle (f64)
    rnorms: np.ndarray     #: true f64 damped residual norm per cycle + final
    converged: bool        #: hit ||dx|| <= tol * ||x||
    stagnated: bool        #: stopped because ||dx|| stopped contracting
    preconditioned: bool   #: inner solves used the LSRN preconditioner


def _inner_fn(solver):
    if callable(solver):
        # custom inner solver: any (A, b, damp, **kwargs) -> result with a
        # .x field (e.g. a sharded solver, or a partial with extra options)
        return solver
    if solver == "lsqr":
        from .solver import lsqr as inner
    elif solver == "lsmr":
        from .lsmr import lsmr as inner
    elif solver == "cgls":
        from .cgls import cgls as inner
    else:
        raise ValueError(f"unknown inner solver {solver!r}")
    return inner


def lsqr_refined(
    A,
    b,
    damp: float = 0.0,
    *,
    cycles: int = 10,
    tol: float = 1e-12,
    solver: str = "lsqr",
    x0=None,
    host_matvec=None,
    host_rmatvec=None,
    precondition="auto",
    gamma: float = 4.0,
    seed: int = 0,
    dense_limit: int = 1 << 25,
    m: Optional[int] = None,
    n: Optional[int] = None,
    **inner_kwargs,
) -> RefineResult:
    """Solve ``min ||[A; damp I] x - [b; 0]||`` to ~f64 accuracy using f32
    device solves + f64 host residuals (augmented-system iterative
    refinement; see the module docstring for the algebra).

    Args:
      A: operator / dense array / (matvec, rmatvec) tuple, stored in the
        device working precision (typically f32). The refined answer is
        the LS solution of this STORED matrix.
      b: (m,) right-hand side; promoted exactly to f64.
      damp: damping parameter (lsqr.f90:440-450 semantics).
      cycles: max refinement cycles.
      tol: stop when ``||dx|| <= tol * ||x||``.
      solver: inner solver — "lsqr", "lsmr" or "cgls".
      x0: optional f64 warm start (cycle 1 then reproduces the core's
        warm-start recipe exactly, including the damped stacked form).
      host_matvec / host_rmatvec: optional f64 host closures for ``A @ x``
        and ``A' @ y``; default built by
        :func:`lsqr_tpu.ops.host.host_products` (requires an operator with
        explicit storage, or ``A.m * A.n <= dense_limit``).
      precondition: 'auto' (switch inner solves to LSRN when the outer
        contraction stalls; applies when m >= n, or for any shape when
        damp > 0 — the stacked [A; damp I] is tall), 'lsrn' (precondition
        from cycle 1), or None/False (never).
      gamma / seed: LSRN sketch parameters (see
        :func:`lsqr_tpu.randomized.lsrn_preconditioner`).
      inner_kwargs: forwarded to the inner solver (atol/btol default 0 =
        machine precision — refinement wants each correction solved as
        far as f32 allows).

    Returns:
      A :class:`RefineResult`; ``result.x`` is float64.
    """
    A = as_operator(A, m=m, n=n)
    damp = float(damp)
    # Complex problems refine the same way (the augmented optimality system
    # over C reads r + A x = b, A^H r = damp^2 x — host state complex128,
    # inner solves complex64); the scalar contraction/stopping logic is
    # identical because every monitored quantity is a norm.
    _adt0 = getattr(A, "dtype", None)
    is_complex = jnp.issubdtype(jnp.asarray(b).dtype, jnp.complexfloating) or (
        _adt0 is not None and jnp.issubdtype(jnp.dtype(_adt0), jnp.complexfloating)
    )
    hdtype = np.complex128 if is_complex else np.float64
    b64 = np.asarray(b, hdtype)
    if b64.ndim != 1 or b64.shape[0] != A.m:
        raise ValueError(f"b must have shape ({A.m},); got {b64.shape}")
    inner = _inner_fn(solver)
    inner_kwargs.setdefault("atol", 0.0)
    inner_kwargs.setdefault("btol", 0.0)

    # user-provided closures define the TRUTH matrix the refinement
    # converges to (it may be the f64 original the f32 device operator was
    # rounded from — then the answer is the f64 problem's solution); when
    # absent, the truth IS the stored matrix, exported once
    user_host = host_matvec is not None or host_rmatvec is not None
    if host_matvec is None or host_rmatvec is None:
        from .ops.host import host_products

        hmv, hrmv = host_products(A, dtype=hdtype, dense_limit=dense_limit)
        host_matvec = host_matvec or hmv
        host_rmatvec = host_rmatvec or hrmv

    _adt = getattr(A, "dtype", None)
    # CallbackOperator has dtype=None (np.dtype(None) would silently mean
    # f64): default to the f32 device working precision
    wdtype = np.dtype(_adt) if _adt is not None else np.dtype(np.float32)
    if is_complex and not np.issubdtype(wdtype, np.complexfloating):
        # complex b over a real stored matrix: the device solves carry
        # complex vectors in the matching complex working precision
        wdtype = np.result_type(wdtype, np.complex64)
    if damp != 0.0:
        from .ops.compose import diagonal_operator, vstack_operators

        S = vstack_operators(
            [A, diagonal_operator(jnp.full((A.n,), damp, wdtype))]
        )
    else:
        S = A

    # --- preconditioner state -------------------------------------------
    # B = S @ N with cond(B) <~ 3 (LSRN); N64 maps inner solutions back.
    want_pre = precondition in ("lsrn", True)
    auto_pre = precondition == "auto" and (A.m >= A.n or damp != 0.0)
    B = N64 = None

    def build_preconditioner():
        # LSRN sketch + SVD, but in f64 ON THE HOST and from the TRUTH
        # source: an f32 device sketch (randomized.lsrn_preconditioner)
        # carries eps_f32-level noise that buries exactly the small
        # singular directions refinement exists to recover (and its rcond
        # truncation would cut them outright for cond(A) > ~1e5)
        nonlocal B, N64
        from .ops.linop import DenseOperator
        from .ops.precondition import ComposedOperator
        from .randomized import svd_truncated_preconditioner

        s_rows = int(np.ceil(gamma * A.n))
        rng = np.random.default_rng(seed)
        M = S.m
        # cap each Gaussian chunk at ~200 MB of f64 (m can be 1e7+)
        chunk_rows = max(1, min(256, 25_000_000 // max(M, 1)))
        sk = np.empty((s_rows, A.n), hdtype)

        def _gauss(shape):
            g = rng.standard_normal(shape)
            if is_complex:  # complex Gaussian (unitary-invariant sketch)
                g = (g + 1j * rng.standard_normal(shape)) / np.sqrt(2.0)
            return g

        def s_rmv(y):
            if damp == 0.0:
                return host_rmatvec(y)
            return host_rmatvec(y[: A.m]) + damp * y[A.m:]

        def s_mv(x):
            ax = host_matvec(x)
            if damp == 0.0:
                return ax
            return np.concatenate([ax, damp * x])

        Sh = None
        if not user_host:
            try:
                from .ops.host import to_scipy

                Sh = to_scipy(S, dtype=hdtype, dense_limit=dense_limit)
            except NotImplementedError:
                Sh = None
        if Sh is not None:
            # rows of G @ S via the NON-conjugate transpose (also for
            # complex: the sketch is the literal product G S)
            ShT = Sh.T.tocsr()
            for lo in range(0, s_rows, chunk_rows):
                hi = min(lo + chunk_rows, s_rows)
                G = _gauss((hi - lo, M))
                sk[lo:hi] = (ShT @ G.T).T
        else:
            # truth via the host closures: row i of G S = conj(S^H conj(g_i))
            # (s_rmv is the ADJOINT product; the conj pair makes it the
            # plain transpose — both conj are identities for real)
            for i in range(s_rows):
                sk[i] = np.conj(s_rmv(np.conj(_gauss(M))))
        N64, r = svd_truncated_preconditioner(sk)
        if M * r <= (1 << 28):
            # FOLD the preconditioner: B = fl32(S N) computed in f64 on the
            # host. Composing S @ N on the device costs eps32 * ||S|| * ||N||
            # = eps32 * cond(S) of product noise (the intermediate N dy has
            # the full dynamic range), which stalls the contraction beyond
            # cond ~1e7; the folded product rounds ONCE at ||S N|| ~ 1 scale,
            # so the inner solve stays eps32-accurate at ANY cond(S). Only
            # when the (M, r) dense folded matrix would be too large does the
            # composed form remain.
            if Sh is not None:
                Bh = Sh @ N64
            else:
                Bh = np.empty((M, r), hdtype)
                for j in range(r):
                    Bh[:, j] = s_mv(N64[:, j])
            B = DenseOperator(jnp.asarray(Bh, wdtype))
        else:
            B = ComposedOperator(outer=S,
                                 inner=DenseOperator(jnp.asarray(N64, wdtype)))

    if want_pre:
        if A.m < A.n and damp == 0.0:
            raise ValueError(
                "precondition='lsrn' requires m >= n or damp > 0 (the "
                "undamped under-determined LSRN form preconditions from "
                "the left, which refinement does not use); pass "
                "precondition=None"
            )
        build_preconditioner()

    def solve_correction(f, g):
        """One f32 correction solve: returns (dx float64, inner results)."""
        res_list = []
        if damp != 0.0:
            rhs = np.concatenate([f, -g / damp])
        elif float(np.linalg.norm(g)) > 0.0:
            # w = argmin ||A' w + g||  (compatible: g in range(A')); with
            # the preconditioner, the SAME w solves min ||B' w + N'g||
            # (N' = conj-transpose for complex; conj is a no-op for real)
            gw = -(N64.conj().T @ g) if B is not None else -g
            op_t = (B if B is not None else S).T
            # the w-solve is a structural sub-problem (under-determined,
            # compatible). A callable solver handles it (it may carry
            # mesh/sharding context the stock solvers lack); of the stock
            # solvers, CGLS is swapped for LSQR here — its unguarded
            # recurrence diverges past convergence on this shape (istop 6)
            if callable(solver):
                _aux = inner
            elif solver == "cgls":
                from .solver import lsqr as _aux
            else:
                _aux = inner
            res_w = _aux(op_t, jnp.asarray(gw.astype(wdtype)), 0.0,
                         **inner_kwargs)
            res_list.append(res_w)
            rhs = f + np.asarray(res_w.x, hdtype)
        else:
            rhs = f
        op = B if B is not None else S
        res = inner(op, jnp.asarray(rhs.astype(wdtype)), 0.0, **inner_kwargs)
        res_list.append(res)
        dy = np.asarray(res.x, hdtype)
        dx = N64 @ dy if B is not None else dy
        return dx, res_list

    if damp == 0.0 and A.m < A.n:
        # Under-determined min-norm: the augmented (x, r) system is
        # degenerate — EVERY x with A x = b is a fixed point, so a null(A)
        # component picked up by the f32 cycle-1 solve would never be
        # corrected. Refine z with x = A' z instead (CRAIG's change of
        # variables): x stays in range(A') EXACTLY, so the limit is the
        # minimum-norm solution. Per cycle: f = b - A x (f64);
        # v = argmin ||A v - f|| (min-norm), dz = argmin ||A' dz - v||
        # (so A A' dz = A v = f for compatible f); z += dz, x = A' z.
        z = np.zeros((A.m,), hdtype)
        x = np.zeros((A.n,), hdtype)
        if x0 is not None:
            # project the warm start through one z-estimate: z0 = argmin
            # ||A' z - x0|| maps x0's range(A') part, dropping null(A)
            res0 = inner(A.T, jnp.asarray(np.asarray(x0, wdtype)), 0.0,
                         **inner_kwargs)
            z = np.asarray(res0.x, hdtype)
            x = host_rmatvec(z)
        results, dx_norms, rnorms = [], [], []
        converged = stagnated = False
        prev_dx = np.inf
        ncycles = 0
        best = None  # (rnorm, x) — same divergence guard as the main branch
        for _ in range(cycles):
            f = b64 - host_matvec(x)
            rnorms.append(float(np.linalg.norm(f)))
            if best is None or rnorms[-1] < best[0]:
                best = (rnorms[-1], x)
            res_v = inner(A, jnp.asarray(f.astype(wdtype)), 0.0,
                          **inner_kwargs)
            res_z = inner(A.T, res_v.x, 0.0, **inner_kwargs)
            results.extend([res_v, res_z])
            z = z + np.asarray(res_z.x, hdtype)
            x_new = host_rmatvec(z)
            ndx = float(np.linalg.norm(x_new - x))
            x = x_new
            ncycles += 1
            dx_norms.append(ndx)
            if ndx <= tol * max(float(np.linalg.norm(x)),
                                np.finfo(np.float64).tiny):
                converged = True
                break
            if ndx >= 0.25 * prev_dx:
                stagnated = True
                break
            prev_dx = ndx
        f = b64 - host_matvec(x)
        final = float(np.linalg.norm(f))
        if best is not None and best[0] < final:
            _, x = best
            f = b64 - host_matvec(x)
            final = float(np.linalg.norm(f))
        rnorms.append(final)
        return RefineResult(
            x=x, r=f, results=tuple(results), cycles=ncycles,
            dx_norms=np.asarray(dx_norms), rnorms=np.asarray(rnorms),
            converged=converged, stagnated=stagnated, preconditioned=False,
        )

    # --- outer iteration -------------------------------------------------
    x = (np.zeros((A.n,), hdtype) if x0 is None
         else np.asarray(x0, hdtype).copy())
    # r starts at 0 (NOT b - A x): then cycle 1 has f = b - A x0,
    # g = damp^2 x0, i.e. exactly the core's warm-start right-hand side
    r = np.zeros((A.m,), hdtype)
    results, dx_norms, rnorms = [], [], []
    converged = stagnated = False
    prev_dx = np.inf
    ncycles = 0

    def true_rnorm(ax):
        return float(np.hypot(np.linalg.norm(b64 - ax),
                              damp * np.linalg.norm(x)))

    best = None  # (rnorm, x, r) — guard against divergence past the
    # attainable accuracy (e.g. cond(A) beyond the f32 inner-solve range):
    # return the iterate with the smallest TRUE damped residual norm
    for _ in range(cycles):
        ax = host_matvec(x)
        rnorms.append(true_rnorm(ax))
        if best is None or rnorms[-1] < best[0]:
            best = (rnorms[-1], x, r)
        f = b64 - r - ax
        g = damp * damp * x - host_rmatvec(r)
        dx, res_list = solve_correction(f, g)
        results.extend(res_list)
        x = x + dx
        r = r + (f - host_matvec(dx))
        ncycles += 1
        ndx = float(np.linalg.norm(dx))
        dx_norms.append(ndx)
        if ndx <= tol * max(float(np.linalg.norm(x)), np.finfo(np.float64).tiny):
            converged = True
            break
        if ndx >= 0.25 * prev_dx:
            # the correction stopped contracting: either switch the inner
            # solves to the LSRN preconditioner (contraction ~eps_f32
            # instead of ~eps_f32 * cond(A)) or accept the attainable
            # accuracy of the working-precision ladder
            if auto_pre and B is None:
                build_preconditioner()
                prev_dx = np.inf
                continue
            stagnated = True
            break
        prev_dx = ndx

    final = true_rnorm(host_matvec(x))
    if best is not None and best[0] < final:
        _, x, r = best
        final = best[0]
    rnorms.append(final)
    return RefineResult(
        x=x,
        r=r,
        results=tuple(results),
        cycles=ncycles,
        dx_norms=np.asarray(dx_norms),
        rnorms=np.asarray(rnorms),
        converged=converged,
        stagnated=stagnated,
        preconditioned=B is not None,
    )
