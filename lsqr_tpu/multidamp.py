"""Multi-damp LSQR — the whole regularization path from ONE bidiagonalization.

The Golub–Kahan bidiagonalization (the two operator products + the
alpha/beta recurrence, /root/reference/src/lsqr.f90:681-699) depends only on
``(A, b)`` — the damping parameter enters the algorithm solely through the
damp-elimination rotation and everything downstream of it
(lsqr.f90:703-771). Solving the damped problem

    min || [A; damp_j I] x - [b; 0] ||        for j = 1..k

therefore shares ALL of the expensive work: one SpMV + one SpMV-T per
iteration serve every damp value simultaneously, while each damp carries its
own O(n) rotation/update state (x_j, w_j and ~15 scalars). Per-iteration
cost for a banded operator with nd diagonals:

    k separate solves:   k * (2*nd*m  +  ~17m)   words of HBM traffic
    lsqr_multidamp:          2*nd*m  +  ~(6k+11)m

— for nd = 11, k = 8 damps that is ~5x less traffic than eight separate
solves (and with the pair kernel, nd*m + (6k+11)m). This is the
answer to regularization sweeps (L-curves, discrepancy-principle searches,
cross-validation over the Tikhonov weight): the reference can only re-run
LSQR per damp (test driver loop, /root/reference/test/lsqrtest_module.f90:65-90
re-enters LSQR for each of its 6 damp values per shape).

Exactness: because the bidiagonalization sequence is damp-independent, each
damp's iterates here are IDENTICAL (same floating-point operation order on
the shared quantities) to a standalone :func:`lsqr_tpu.lsqr` run with that
damp — converged damps freeze their state (masked updates) while the
bidiagonalization advances for the stragglers, exactly as if each solve had
continued alone. Verified bitwise in ``tests/test_multidamp.py``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .config import LSQROptions
from .ops.blas import d2norm, nrm2
from .ops.linop import LinearOperator, as_operator
from .solver import LSQRResult

__all__ = ["lsqr_multidamp", "lsmr_multidamp"]


def _row_nrm2(mat, *, safe: bool, axis_name=None):
    """Row-wise Euclidean norms of a (k, n) array — the vectorized form of
    :func:`lsqr_tpu.ops.blas.nrm2` (same per-row overflow-safe scaling;
    complex rows return the real norm in the matching real dtype)."""
    from .ops.blas import abs2

    if safe:
        amax = jnp.max(jnp.abs(mat), axis=-1)
        if axis_name is not None:
            amax = jax.lax.pmax(amax, axis_name)
        scale = jnp.where(amax > 0, amax, jnp.ones_like(amax))
        ssq = jnp.sum(abs2(mat / scale[:, None]), axis=-1)
        if axis_name is not None:
            ssq = jax.lax.psum(ssq, axis_name)
        return jnp.where(amax > 0, scale * jnp.sqrt(ssq), jnp.zeros_like(amax))
    ssq = jnp.sum(abs2(mat), axis=-1)
    if axis_name is not None:
        ssq = jax.lax.psum(ssq, axis_name)
    return jnp.sqrt(ssq)


class _MDCarry(NamedTuple):
    # shared bidiagonalization state
    itn: jax.Array      #: scalar int32 — bidiagonalization step count
    u: jax.Array        #: (m,)
    v: jax.Array        #: (n,)
    alpha: jax.Array    #: scalar
    beta: jax.Array     #: scalar
    # per-damp state, leading axis k
    istop: jax.Array    #: (k,) int32
    nstop: jax.Array    #: (k,) int32
    itn_d: jax.Array    #: (k,) int32 — iteration each damp stopped at
    x: jax.Array        #: (k, n)
    w: jax.Array        #: (k, n)
    se: jax.Array       #: (k, n) or (k, 1)
    rhobar: jax.Array   #: (k,)
    phibar: jax.Array
    psi: jax.Array
    res2: jax.Array
    anorm: jax.Array
    dnorm: jax.Array
    dxmax: jax.Array
    maxdx: jax.Array    #: (k,) int32
    xnorm: jax.Array
    xnorm1: jax.Array
    cs2: jax.Array
    sn2: jax.Array
    z: jax.Array
    acond: jax.Array
    rnorm: jax.Array
    arnorm: jax.Array


def _build_multidamp(
    A: LinearOperator,
    b: jax.Array,
    damps: jax.Array,
    atol: jax.Array,
    btol: jax.Array,
    conlim: jax.Array,
    *,
    itnlim: int,
    wantse: bool,
    nconv: int,
    safe_norms: bool,
    pair: bool = False,
    scalar_dtype=None,
):
    """(carry0, cond_fun, body_fun, finalize) for the k-damp solve.

    The bidiagonalization block is the same computation as the single-damp
    solver's (solver.py ``_build``, reference lsqr.f90:681-699); everything
    per-damp is the single-damp recurrence vectorized over a leading (k,)
    axis with converged damps frozen by masked selects.
    """
    m, n = A.shape
    dtype = b.dtype
    # complex extension: vectors may be complex, every scalar of the shared
    # bidiagonalization and the per-damp recurrences is REAL (see
    # solver._build)
    rdtype = jnp.zeros((), dtype).real.dtype
    is_complex = rdtype != dtype
    sdtype = jnp.dtype(scalar_dtype) if scalar_dtype is not None else rdtype
    mixed = sdtype != rdtype
    if pair and mixed:
        raise ValueError(
            "pair kernels compute in f32 and cannot carry a wider "
            "scalar_dtype; set pair=False for the mixed-precision mode"
        )
    if is_complex and pair:
        raise ValueError(
            "fused pair kernels are real-f32 only; set pair=False for "
            "complex operators"
        )
    k = damps.shape[0]

    def sc(s):
        return s.astype(sdtype) if mixed else s

    def vc(s):
        # real scalars stay REAL even for complex vectors (f32 * c64
        # promotes to c64 without a cast)
        return s.astype(rdtype) if mixed else s

    def _abs2(vec):  # |.|^2 elementwise, real-dtyped (== square for real)
        return jnp.real(vec * jnp.conj(vec)) if is_complex else jnp.square(vec)

    zero = jnp.zeros((), sdtype)
    one = jnp.ones((), sdtype)
    zeros_k = jnp.zeros((k,), sdtype)
    ones_k = jnp.ones((k,), sdtype)
    damps = sc(damps)
    atol = sc(atol)
    btol = sc(btol)
    conlim = sc(conlim)
    axis_m = getattr(A, "axis_name_m", None)
    axis_n = getattr(A, "axis_name_n", None)

    def norm_m(vec):
        return sc(nrm2(vec, safe=safe_norms, axis_name=axis_m))

    def norm_n(vec):
        return sc(nrm2(vec, safe=safe_norms, axis_name=axis_n))

    def sum_n_rows(mat):  # (k, n) -> (k,) sum over the n axis
        s = jnp.sum(mat, axis=-1)
        return sc(jax.lax.psum(s, axis_n) if axis_n is not None else s)

    damped = damps > zero  # (k,)
    ctol = jnp.where(conlim > zero, one / jnp.where(conlim > zero, conlim, one), zero)

    # ------------------------------------------------------------------
    # Setup (lsqr.f90:619-646) — shared across all damps.
    # ------------------------------------------------------------------
    u0 = b
    beta0 = norm_m(u0)
    safe_beta0 = jnp.where(beta0 > zero, beta0, one)
    u0_norm = jnp.where(beta0 > zero, u0 / vc(safe_beta0), u0)
    v0u = jnp.where(
        beta0 > zero,
        A.rmatvec(u0_norm),
        jnp.zeros((A.local_n if hasattr(A, "local_n") else n,), dtype),
    )
    alpha0 = jnp.where(beta0 > zero, norm_n(v0u), zero)
    safe_alpha0 = jnp.where(alpha0 > zero, alpha0, one)
    v0_norm = jnp.where(alpha0 > zero, v0u / vc(safe_alpha0), v0u)
    if pair:
        # unnormalized carry (norms held in alpha/beta) — see solver.py
        u0c, v0c = u0, v0u
    else:
        u0c, v0c = u0_norm, v0_norm
    w0 = jnp.broadcast_to(v0_norm, (k,) + v0_norm.shape)
    arnorm0 = alpha0 * beta0
    bnorm = beta0
    n_local = v0c.shape[0]

    carry0 = _MDCarry(
        itn=jnp.zeros((), jnp.int32),
        u=u0c,
        v=v0c,
        alpha=alpha0,
        beta=beta0,
        istop=jnp.zeros((k,), jnp.int32),
        nstop=jnp.zeros((k,), jnp.int32),
        itn_d=jnp.zeros((k,), jnp.int32),
        x=jnp.zeros((k, n_local), dtype),
        w=w0,
        se=jnp.zeros((k, n_local if wantse else 1), rdtype),
        rhobar=jnp.full((k,), alpha0, sdtype),
        phibar=jnp.full((k,), beta0, sdtype),
        psi=zeros_k,
        res2=zeros_k,
        anorm=zeros_k,
        dnorm=zeros_k,
        dxmax=zeros_k,
        maxdx=jnp.zeros((k,), jnp.int32),
        xnorm=zeros_k,
        xnorm1=zeros_k,
        cs2=-ones_k,
        sn2=zeros_k,
        z=zeros_k,
        acond=zeros_k,
        rnorm=jnp.full((k,), beta0, sdtype),
        arnorm=jnp.full((k,), arnorm0, sdtype),
    )

    def cond_fun(c: _MDCarry):
        return jnp.logical_and(jnp.any(c.istop == 0), arnorm0 != zero)

    def body_fun(c: _MDCarry) -> _MDCarry:
        itn = c.itn + 1
        active = c.istop == 0  # (k,)

        # --- shared bidiagonalization step (lsqr.f90:681-699) -----------
        if pair:
            inv_alpha_prev = jnp.where(
                c.alpha > zero, one / jnp.where(c.alpha > zero, c.alpha, one), zero
            )
            inv_beta_prev = jnp.where(
                c.beta > zero, one / jnp.where(c.beta > zero, c.beta, one), zero
            )
            u, z_adj = A.fused_pair(
                y=c.u, win=c.v,
                c1=inv_alpha_prev, c2=c.alpha * inv_beta_prev,
            )
            ssq_u = jnp.sum(jnp.square(u))
            if axis_m is not None:
                ssq_u = jax.lax.psum(ssq_u, axis_m)
            beta = jnp.sqrt(ssq_u).astype(dtype)
            beta_pos = beta > zero
            inv_beta = jnp.where(beta_pos, one / jnp.where(beta_pos, beta, one), zero)
            v_cand = z_adj * vc(inv_beta) - vc(beta * inv_alpha_prev) * c.v
            ssq_v = jnp.sum(jnp.square(v_cand))
            if axis_n is not None:
                ssq_v = jax.lax.psum(ssq_v, axis_n)
            alpha_cand = jnp.sqrt(ssq_v).astype(dtype)
            v = jnp.where(beta_pos, v_cand, c.v)
            alpha = jnp.where(beta_pos, alpha_cand, c.alpha)
            inv_alpha_new = jnp.where(
                alpha > zero, one / jnp.where(alpha > zero, alpha, one), one
            )
            v_for_w = v * inv_alpha_new
        else:
            u = A.matvec(c.v) - vc(c.alpha) * c.u
            beta = norm_m(u)
            beta_pos = beta > zero
            safe_beta = jnp.where(beta_pos, beta, one)
            u = jnp.where(beta_pos, u / vc(safe_beta), u)
            v_cand = A.rmatvec(u) - vc(beta) * c.v
            alpha_cand = norm_n(v_cand)
            alpha_pos = alpha_cand > zero
            safe_alpha = jnp.where(alpha_pos, alpha_cand, one)
            v_cand = jnp.where(alpha_pos, v_cand / vc(safe_alpha), v_cand)
            v = jnp.where(beta_pos, v_cand, c.v)
            alpha = jnp.where(beta_pos, alpha_cand, c.alpha)
            v_for_w = v

        # per-damp anorm accumulation (lsqr.f90:687-689); c.alpha/beta are
        # shared scalars, damps broadcasts to (k,)
        temp = d2norm(c.alpha, beta)
        temp = d2norm(temp, damps)
        anorm = d2norm(c.anorm, temp)

        # --- per-damp rotations (lsqr.f90:703-721), vectorized over k ----
        rhbar1_d = d2norm(c.rhobar, damps)
        safe_rhbar1 = jnp.where(rhbar1_d > zero, rhbar1_d, ones_k)
        cs1 = c.rhobar / safe_rhbar1
        sn1 = damps / safe_rhbar1
        psi = jnp.where(damped, sn1 * c.phibar, c.psi)
        phibar = jnp.where(damped, cs1 * c.phibar, c.phibar)
        rhbar1 = jnp.where(damped, rhbar1_d, c.rhobar)

        rho = d2norm(rhbar1, beta)
        safe_rho = jnp.where(rho > zero, rho, ones_k)
        cs = rhbar1 / safe_rho
        sn = beta / safe_rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi

        # --- per-damp x/w/se update (lsqr.f90:724-745) -------------------
        t1 = (phi / safe_rho)[:, None]
        t2 = (-theta / safe_rho)[:, None]
        t3 = (one / safe_rho)[:, None]
        t = c.w
        x = vc(t1) * t + c.x
        w = vc(t2) * t + v_for_w[None, :]
        dk2 = _abs2(vc(t3) * t)
        dknorm = jnp.sqrt(sum_n_rows(dk2))
        se = c.se + dk2 if wantse else c.se

        # --- cancellation monitor (lsqr.f90:747-757) ---------------------
        dnorm = d2norm(c.dnorm, dknorm)
        dxk = jnp.abs(phi * dknorm)
        new_max = c.dxmax < dxk
        dxmax = jnp.where(new_max, dxk, c.dxmax)
        maxdx = jnp.where(new_max, itn, c.maxdx)

        # --- right rotation: xnorm estimator (lsqr.f90:759-771) ----------
        delta = c.sn2 * rho
        gambar = -c.cs2 * rho
        rhs = phi - delta * c.z
        safe_gambar = jnp.where(gambar != zero, gambar, ones_k)
        zbar = rhs / safe_gambar
        xnorm = d2norm(c.xnorm1, zbar)
        gamma = d2norm(gambar, theta)
        safe_gamma = jnp.where(gamma > zero, gamma, ones_k)
        cs2 = gambar / safe_gamma
        sn2 = theta / safe_gamma
        zz = rhs / safe_gamma
        xnorm1 = d2norm(c.xnorm1, zz)

        # --- norm/condition estimates (lsqr.f90:773-790) -----------------
        acond = anorm * dnorm
        res2 = d2norm(c.res2, psi)
        rnorm = d2norm(res2, phibar)
        arnorm = alpha * jnp.abs(tau)

        safe_bnorm = jnp.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        test2 = jnp.where(
            rnorm > zero, arnorm / jnp.where(rnorm > zero, anorm * rnorm, ones_k), zeros_k
        )
        safe_acond = jnp.where(acond > zero, acond, ones_k)
        test3 = one / safe_acond
        t1_rel = test1 / (one + anorm * xnorm / safe_bnorm)
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        # --- stopping tests (lsqr.f90:798-810), per damp -----------------
        istop = jnp.zeros((k,), jnp.int32)
        istop = jnp.where(itn >= itnlim, 5, istop)
        istop = jnp.where(one + test3 <= one, 4, istop)
        istop = jnp.where(one + test2 <= one, 2, istop)
        istop = jnp.where(one + t1_rel <= one, 1, istop)
        istop = jnp.where(test3 <= ctol, 4, istop)
        istop = jnp.where(test2 <= atol, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)

        # --- nconv consecutive-hit logic (lsqr.f90:843-850) --------------
        nstop = jnp.where(istop == 0, 0, c.nstop + 1)
        istop = jnp.where(
            (istop != 0) & (nstop < nconv) & (itn < itnlim), 0, istop
        )

        # --- freeze converged damps --------------------------------------
        am = active[:, None]

        def sel(new, old):
            return jnp.where(active, new, old)

        return _MDCarry(
            itn=itn,
            u=u, v=v, alpha=alpha, beta=beta,
            istop=sel(istop, c.istop),
            nstop=sel(nstop, c.nstop),
            itn_d=jnp.where(active, itn, c.itn_d),
            x=jnp.where(am, x, c.x),
            w=jnp.where(am, w, c.w),
            se=jnp.where(am, se, c.se),
            rhobar=sel(rhobar, c.rhobar),
            phibar=sel(phibar, c.phibar),
            psi=sel(psi, c.psi),
            res2=sel(res2, c.res2),
            anorm=sel(anorm, c.anorm),
            dnorm=sel(dnorm, c.dnorm),
            dxmax=sel(dxmax, c.dxmax),
            maxdx=sel(maxdx, c.maxdx),
            xnorm=sel(xnorm, c.xnorm),
            xnorm1=sel(xnorm1, c.xnorm1),
            cs2=sel(cs2, c.cs2),
            sn2=sel(sn2, c.sn2),
            z=sel(zz, c.z),
            acond=sel(acond, c.acond),
            rnorm=sel(rnorm, c.rnorm),
            arnorm=sel(arnorm, c.arnorm),
        )

    def finalize(final: _MDCarry) -> LSQRResult:
        se_out = None
        if wantse:
            gm = int(getattr(A, "global_m", m))
            gn = int(getattr(A, "global_n", n))
            t_static = float(gm - gn) if gm > gn else 1.0
            t = jnp.where(
                damped,
                jnp.full((k,), float(gm), sdtype),
                jnp.full((k,), t_static, sdtype),
            )
            t = final.rnorm / jnp.sqrt(t)
            se_out = vc(t)[:, None] * jnp.sqrt(final.se)

        istop = jnp.where(damped & (final.istop == 2), 3, final.istop)

        return LSQRResult(
            x=final.x,
            istop=istop,
            itn=final.itn_d,
            anorm=final.anorm,
            acond=final.acond,
            rnorm=final.rnorm,
            arnorm=final.arnorm,
            xnorm=final.xnorm,
            bnorm=jnp.full((k,), bnorm, sdtype),
            se=se_out,
            dxmax=final.dxmax,
            maxdx=final.maxdx,
            trace=None,
        )

    return carry0, cond_fun, body_fun, finalize


def _md_impl(A, b, damps, atol, btol, conlim, **static_opts):
    carry0, cond_fun, body_fun, finalize = _build_multidamp(
        A, b, damps, atol, btol, conlim, **static_opts
    )
    final = jax.lax.while_loop(cond_fun, body_fun, carry0)
    return finalize(final)


_md_jit = jax.jit(
    _md_impl,
    static_argnames=(
        "itnlim", "wantse", "nconv", "safe_norms", "pair", "scalar_dtype",
    ),
)


def _md_masked_body(cond_fun, body_fun):
    def mb(_, c):
        act = cond_fun(c)
        new = body_fun(c)
        return jax.tree.map(lambda a, b: jnp.where(act, a, b), new, c)

    return mb


@partial(
    jax.jit,
    static_argnames=(
        "seg_len", "itnlim", "wantse", "nconv", "safe_norms", "pair",
        "scalar_dtype",
    ),
)
def _md_segment(A, b, damps, atol, btol, conlim, carry, *, seg_len, **static_opts):
    carry0, cond_fun, body_fun, _ = _build_multidamp(
        A, b, damps, atol, btol, conlim, **static_opts
    )
    carry = carry if carry is not None else carry0
    return jax.lax.fori_loop(
        0, seg_len, _md_masked_body(cond_fun, body_fun), carry, unroll=False
    )


@partial(
    jax.jit,
    static_argnames=("itnlim", "wantse", "nconv", "safe_norms", "pair", "scalar_dtype"),
)
def _md_finalize(A, b, damps, atol, btol, conlim, carry, **static_opts):
    _, _, _, finalize = _build_multidamp(
        A, b, damps, atol, btol, conlim, **static_opts
    )
    return finalize(carry)


def _md_bounded(A, b, damps, atol, btol, conlim, *, seg_len, itnlim, **static_opts):
    carry = None
    kwargs = dict(itnlim=itnlim, **static_opts)
    while True:
        prev_itn = int(carry.itn) if carry is not None else -1
        carry = _md_segment(
            A, b, damps, atol, btol, conlim, carry,
            seg_len=min(seg_len, itnlim) if itnlim > 0 else seg_len,
            **kwargs,
        )
        if bool((carry.istop != 0).all()) or int(carry.itn) >= itnlim:
            break
        if int(carry.itn) == prev_itn:  # degenerate setup (arnorm0 == 0)
            break
    return _md_finalize(A, b, damps, atol, btol, conlim, carry, **kwargs)


def lsqr_multidamp(
    A,
    b,
    damps,
    *,
    options: Optional[LSQROptions] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
    **option_overrides,
) -> LSQRResult:
    """Solve ``min ||[A; damp_j I] x - [b; 0]||`` for a whole vector of damp
    values from ONE shared bidiagonalization.

    The two operator products per iteration (the entire HBM-heavy cost,
    lsqr.f90:681-694) are computed once and shared by all ``k = len(damps)``
    problems; each damp carries only its own O(n) update. Every damp's
    result is exactly what a standalone :func:`lsqr_tpu.lsqr` call with that
    damp returns (identical floating-point sequence — the bidiagonalization
    is damp-independent and converged damps freeze while stragglers run).

    Args:
      A: LinearOperator / dense array / (matvec, rmatvec) tuple.
      b: right-hand side, shape (m,).
      damps: array-like of k non-negative damping values. They may be in
        any order; each gets its own stopping decision and istop.
      options / option_overrides: :class:`LSQROptions`. ``record_trace``,
        ``debug_log`` are not supported here;
        ``pair`` (the one-stripe-pass product-pair kernel) and
        ``scalar_dtype`` mixed precision are.

    Returns:
      An :class:`LSQRResult` whose fields carry a leading (k,) axis:
      ``x`` is (k, n), ``istop``/``itn``/all norm estimates are (k,),
      ``se`` is (k, n) when ``wantse``. ``trace`` is None.
    """
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)
    if opts.record_trace or opts.debug_log:
        raise ValueError("record_trace/debug_log are not supported by "
                         "lsqr_multidamp; run lsqr per damp for logging")

    A = as_operator(A, m=m, n=n)
    b = jnp.asarray(b)
    dtype = opts.dtype or jnp.result_type(b.dtype, getattr(A, "dtype", None) or b.dtype)
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from .config import default_dtype

        dtype = default_dtype()
    b = b.astype(dtype)
    # damps are always real, also for complex problems
    damps = jnp.atleast_1d(jnp.asarray(damps, jnp.zeros((), dtype).real.dtype))
    if damps.ndim != 1 or damps.shape[0] == 0:
        raise ValueError("damps must be a non-empty 1-D array of damping values")
    if b.ndim != 1 or (getattr(A, "axis_name_m", None) is None and b.shape[0] != A.m):
        raise ValueError(
            f"b must be a vector of length m = {A.m}; got shape {b.shape}"
        )

    itnlim = opts.resolve_itnlim(A.n)
    pair = opts.pair
    if pair is None:
        pair = opts.fused is not False and bool(getattr(A, "prefers_pair", False))
    if pair and not hasattr(A, "fused_pair"):
        raise ValueError(
            f"{type(A).__name__} does not implement fused_pair; set pair=False"
        )
    scalar_dtype = opts.scalar_dtype
    if scalar_dtype is not None:
        scalar_dtype = str(jnp.dtype(scalar_dtype))
        if scalar_dtype == "float64" and not jax.config.jax_enable_x64:
            raise ValueError("scalar_dtype='float64' requires x64 mode")

    kwargs = dict(
        itnlim=itnlim,
        wantse=opts.wantse,
        nconv=opts.nconv,
        safe_norms=opts.safe_norms,
        pair=pair,
        scalar_dtype=scalar_dtype,
    )
    args = (
        A,
        b,
        damps,
        jnp.asarray(opts.atol, dtype),
        jnp.asarray(opts.btol, dtype),
        jnp.asarray(opts.conlim, dtype),
    )
    loop = opts.loop
    if loop == "bounded":
        return _md_bounded(*args, seg_len=opts.loop_segment, **kwargs)
    return _md_jit(*args, **kwargs)


# ======================================================================
# LSMR multi-damp — same shared-bidiagonalization trick for the sibling
# solver (Fong & Saunders 2011): damp enters LSMR only through the Phat
# rotation (lsmr.py body_fun), so the k-damp sweep shares the two operator
# products per iteration exactly like lsqr_multidamp.
# ======================================================================

from .lsmr import LSMRResult, _sym_ortho  # noqa: E402


class _MDLSMRCarry(NamedTuple):
    itn: jax.Array     #: scalar int32
    u: jax.Array       #: (m,)
    v: jax.Array       #: (n,)
    alpha: jax.Array   #: scalar
    beta: jax.Array    #: scalar
    istop: jax.Array   #: (k,) int32
    itn_d: jax.Array   #: (k,) int32
    h: jax.Array       #: (k, n)
    hbar: jax.Array    #: (k, n)
    x: jax.Array       #: (k, n)
    alphabar: jax.Array  # per-damp scalars, (k,)
    rho: jax.Array
    rhobar: jax.Array
    cbar: jax.Array
    sbar: jax.Array
    zeta: jax.Array
    zetabar: jax.Array
    betadd: jax.Array
    betad: jax.Array
    rhodold: jax.Array
    tautildeold: jax.Array
    thetatilde: jax.Array
    d: jax.Array
    norma2: jax.Array
    maxrbar: jax.Array
    minrbar: jax.Array
    normr: jax.Array
    normar: jax.Array
    norma: jax.Array
    conda: jax.Array
    normx: jax.Array


def _build_lsmr_multidamp(
    A: LinearOperator,
    b: jax.Array,
    damps: jax.Array,
    atol: jax.Array,
    btol: jax.Array,
    conlim: jax.Array,
    *,
    itnlim: int,
    safe_norms: bool,
    pair: bool = False,
):
    m, n = A.shape
    dtype = b.dtype
    # complex extension: real scalar recurrence over complex vectors (see
    # solver._build / _build_multidamp)
    rdtype = jnp.zeros((), dtype).real.dtype
    if rdtype != dtype and pair:
        raise ValueError(
            "fused pair kernels are real-f32 only; set pair=False for "
            "complex operators"
        )
    k = damps.shape[0]
    zero = jnp.zeros((), rdtype)
    one = jnp.ones((), rdtype)
    ones_k = jnp.ones((k,), rdtype)
    zeros_k = jnp.zeros((k,), rdtype)
    axis_m = getattr(A, "axis_name_m", None)
    axis_n = getattr(A, "axis_name_n", None)

    def norm_m(vec):
        return nrm2(vec, safe=safe_norms, axis_name=axis_m)

    def norm_n(vec):
        return nrm2(vec, safe=safe_norms, axis_name=axis_n)

    ctol = jnp.where(conlim > zero, one / jnp.where(conlim > zero, conlim, one), zero)

    normb = norm_m(b)
    beta0 = normb
    safe_beta0 = jnp.where(beta0 > zero, beta0, one)
    u0 = jnp.where(beta0 > zero, b / safe_beta0, b)
    n_local = A.local_n if hasattr(A, "local_n") else n
    v0u = jnp.where(beta0 > zero, A.rmatvec(u0), jnp.zeros((n_local,), dtype))
    alpha0 = jnp.where(beta0 > zero, norm_n(v0u), zero)
    safe_alpha0 = jnp.where(alpha0 > zero, alpha0, one)
    v0 = jnp.where(alpha0 > zero, v0u / safe_alpha0, v0u)
    normar0 = alpha0 * beta0

    carry0 = _MDLSMRCarry(
        itn=jnp.zeros((), jnp.int32),
        u=u0, v=v0, alpha=alpha0, beta=beta0,
        istop=jnp.zeros((k,), jnp.int32),
        itn_d=jnp.zeros((k,), jnp.int32),
        h=jnp.broadcast_to(v0, (k,) + v0.shape),
        hbar=jnp.zeros((k, n_local), dtype),
        x=jnp.zeros((k, n_local), dtype),
        alphabar=jnp.full((k,), alpha0, rdtype),
        rho=ones_k,
        rhobar=ones_k,
        cbar=ones_k,
        sbar=zeros_k,
        zeta=zeros_k,
        zetabar=jnp.full((k,), alpha0 * beta0, rdtype),
        betadd=jnp.full((k,), beta0, rdtype),
        betad=zeros_k,
        rhodold=ones_k,
        tautildeold=zeros_k,
        thetatilde=zeros_k,
        d=zeros_k,
        norma2=jnp.full((k,), alpha0 * alpha0, rdtype),
        maxrbar=zeros_k,
        minrbar=jnp.full(
            (k,), min(1e100, float(jnp.finfo(rdtype).max) / 2), rdtype
        ),
        normr=jnp.full((k,), beta0, rdtype),
        normar=jnp.full((k,), normar0, rdtype),
        norma=jnp.full((k,), jnp.sqrt(alpha0 * alpha0), rdtype),
        conda=ones_k,
        normx=zeros_k,
    )

    def cond_fun(c: _MDLSMRCarry):
        return jnp.logical_and(jnp.any(c.istop == 0), normar0 != zero)

    def body_fun(c: _MDLSMRCarry) -> _MDLSMRCarry:
        itn = c.itn + 1
        active = c.istop == 0

        # --- shared bidiagonalization step (identical to lsmr.py) --------
        if pair:
            u, z_adj = A.fused_pair(y=c.u, win=c.v, c1=one, c2=c.alpha)
        else:
            u = A.matvec(c.v) - c.alpha * c.u
        beta = norm_m(u)
        beta_pos = beta > zero
        safe_beta = jnp.where(beta_pos, beta, one)
        u = jnp.where(beta_pos, u / safe_beta, u)
        if pair:
            v_cand = jnp.where(beta_pos, z_adj / safe_beta, z_adj) - beta * c.v
        else:
            v_cand = A.rmatvec(u) - beta * c.v
        alpha_cand = norm_n(v_cand)
        alpha_pos = alpha_cand > zero
        safe_alpha = jnp.where(alpha_pos, alpha_cand, one)
        v_cand = jnp.where(alpha_pos, v_cand / safe_alpha, v_cand)
        v = jnp.where(beta_pos, v_cand, c.v)
        alpha = jnp.where(beta_pos, alpha_cand, c.alpha)

        # --- per-damp rotations (all (k,); _sym_ortho is branchless) -----
        chat, shat, alphahat = _sym_ortho(c.alphabar, damps, ones_k, zeros_k)

        rhoold = c.rho
        cgiv, sgiv, rho = _sym_ortho(alphahat, jnp.full((k,), beta, rdtype),
                                     ones_k, zeros_k)
        thetanew = sgiv * alpha
        alphabar = cgiv * alpha

        rhobarold = c.rhobar
        zetaold = c.zeta
        thetabar = c.sbar * rho
        rhotemp = c.cbar * rho
        cbar, sbar, rhobar = _sym_ortho(c.cbar * rho, thetanew, ones_k, zeros_k)
        zeta = cbar * c.zetabar
        zetabar = -sbar * c.zetabar

        # --- per-damp h, hbar, x (k, n) ----------------------------------
        hbar = c.h - (thetabar * rho / (rhoold * rhobarold))[:, None] * c.hbar
        x = c.x + (zeta / (rho * rhobar))[:, None] * hbar
        h = v[None, :] - (thetanew / rho)[:, None] * c.h

        # --- ||r|| estimate ----------------------------------------------
        betaacute = chat * c.betadd
        betacheck = -shat * c.betadd
        betahat = cgiv * betaacute
        betadd = -sgiv * betaacute
        thetatildeold = c.thetatilde
        ctildeold, stildeold, rhotildeold = _sym_ortho(
            c.rhodold, thetabar, ones_k, zeros_k
        )
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * c.betad + ctildeold * betahat
        tautildeold = (zetaold - thetatildeold * c.tautildeold) / rhotildeold
        taud = (zeta - thetatilde * tautildeold) / rhodold
        d = c.d + betacheck * betacheck
        normr = jnp.sqrt(d + jnp.square(betad - taud) + betadd * betadd)

        # --- ||A||, cond(A) estimates --------------------------------------
        norma2 = c.norma2 + beta * beta
        norma = jnp.sqrt(norma2)
        norma2 = norma2 + alpha * alpha
        maxrbar = jnp.maximum(c.maxrbar, rhobarold)
        minrbar = jnp.where(
            itn > 1, jnp.minimum(c.minrbar, rhobarold), c.minrbar
        )
        conda = jnp.maximum(maxrbar, rhotemp) / jnp.minimum(minrbar, rhotemp)

        # --- convergence tests ---------------------------------------------
        normar = jnp.abs(zetabar)
        normx = _row_nrm2(x, safe=safe_norms, axis_name=axis_n)
        safe_normb = jnp.where(normb > zero, normb, one)
        test1 = normr / safe_normb
        denom2 = norma * normr
        test2 = jnp.where(
            denom2 > zero, normar / jnp.where(denom2 > zero, denom2, ones_k),
            jnp.full((k,), jnp.inf, dtype),
        )
        test3 = one / conda
        t1 = test1 / (one + norma * normx / safe_normb)
        rtol = btol + atol * norma * normx / safe_normb

        istop = jnp.zeros((k,), jnp.int32)
        istop = jnp.where(itn >= itnlim, 7, istop)
        istop = jnp.where(one + test3 <= one, 6, istop)
        istop = jnp.where(one + test2 <= one, 5, istop)
        istop = jnp.where(one + t1 <= one, 4, istop)
        istop = jnp.where(test3 <= ctol, 3, istop)
        istop = jnp.where(test2 <= atol, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)

        am = active[:, None]

        def sel(new, old):
            return jnp.where(active, new, old)

        return _MDLSMRCarry(
            itn=itn, u=u, v=v, alpha=alpha, beta=beta,
            istop=sel(istop, c.istop),
            itn_d=jnp.where(active, itn, c.itn_d),
            h=jnp.where(am, h, c.h),
            hbar=jnp.where(am, hbar, c.hbar),
            x=jnp.where(am, x, c.x),
            alphabar=sel(alphabar, c.alphabar),
            rho=sel(rho, c.rho),
            rhobar=sel(rhobar, c.rhobar),
            cbar=sel(cbar, c.cbar),
            sbar=sel(sbar, c.sbar),
            zeta=sel(zeta, c.zeta),
            zetabar=sel(zetabar, c.zetabar),
            betadd=sel(betadd, c.betadd),
            betad=sel(betad, c.betad),
            rhodold=sel(rhodold, c.rhodold),
            tautildeold=sel(tautildeold, c.tautildeold),
            thetatilde=sel(thetatilde, c.thetatilde),
            d=sel(d, c.d),
            norma2=sel(norma2, c.norma2),
            maxrbar=sel(maxrbar, c.maxrbar),
            minrbar=sel(minrbar, c.minrbar),
            normr=sel(normr, c.normr),
            normar=sel(normar, c.normar),
            norma=sel(norma, c.norma),
            conda=sel(conda, c.conda),
            normx=sel(normx, c.normx),
        )

    def finalize(final: _MDLSMRCarry) -> LSMRResult:
        return LSMRResult(
            x=final.x,
            istop=final.istop,
            itn=final.itn_d,
            normr=final.normr,
            normar=final.normar,
            norma=final.norma,
            conda=final.conda,
            normx=final.normx,
            trace=None,
        )

    return carry0, cond_fun, body_fun, finalize


def _mdl_impl(A, b, damps, atol, btol, conlim, **static_opts):
    carry0, cond_fun, body_fun, finalize = _build_lsmr_multidamp(
        A, b, damps, atol, btol, conlim, **static_opts
    )
    final = jax.lax.while_loop(cond_fun, body_fun, carry0)
    return finalize(final)


_mdl_jit = jax.jit(
    _mdl_impl, static_argnames=("itnlim", "safe_norms", "pair")
)


@partial(jax.jit, static_argnames=("seg_len", "itnlim", "safe_norms", "pair"))
def _mdl_segment(A, b, damps, atol, btol, conlim, carry, *, seg_len, **static_opts):
    carry0, cond_fun, body_fun, _ = _build_lsmr_multidamp(
        A, b, damps, atol, btol, conlim, **static_opts
    )
    carry = carry if carry is not None else carry0
    return jax.lax.fori_loop(
        0, seg_len, _md_masked_body(cond_fun, body_fun), carry, unroll=False
    )


@partial(jax.jit, static_argnames=("itnlim", "safe_norms", "pair"))
def _mdl_finalize(A, b, damps, atol, btol, conlim, carry, **static_opts):
    _, _, _, finalize = _build_lsmr_multidamp(
        A, b, damps, atol, btol, conlim, **static_opts
    )
    return finalize(carry)


def _mdl_bounded(A, b, damps, atol, btol, conlim, *, seg_len, itnlim, **static_opts):
    carry = None
    kwargs = dict(itnlim=itnlim, **static_opts)
    while True:
        prev_itn = int(carry.itn) if carry is not None else -1
        carry = _mdl_segment(
            A, b, damps, atol, btol, conlim, carry,
            seg_len=min(seg_len, itnlim) if itnlim > 0 else seg_len,
            **kwargs,
        )
        if bool((carry.istop != 0).all()) or int(carry.itn) >= itnlim:
            break
        if int(carry.itn) == prev_itn:
            break
    return _mdl_finalize(A, b, damps, atol, btol, conlim, carry, **kwargs)


def lsmr_multidamp(
    A,
    b,
    damps,
    *,
    atol: float = 1e-6,
    btol: float = 1e-6,
    conlim: float = 1e8,
    itnlim: Optional[int] = None,
    safe_norms: bool = True,
    loop: str = "while",
    loop_segment: int = 64,
    pair: Optional[bool] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
) -> LSMRResult:
    """LSMR over a vector of damp values from ONE shared bidiagonalization.

    The LSMR analogue of :func:`lsqr_multidamp` (same argument conventions
    and defaults as :func:`lsqr_tpu.lsmr`): damp enters LSMR only through
    the Phat plane rotation, so the two operator products per iteration are
    shared by all k damps. Each damp's result equals a standalone
    :func:`lsqr_tpu.lsmr` run with that damp.

    Returns an :class:`LSMRResult` with a leading (k,) axis on every field
    (``x`` is (k, n)); ``trace`` is None.
    """
    A = as_operator(A, m=m, n=n)
    b = jnp.asarray(b)
    dtype = b.dtype
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from .config import default_dtype

        dtype = default_dtype()
        b = b.astype(dtype)
    # damps/tolerances are always real, also for complex problems
    damps = jnp.atleast_1d(
        jnp.asarray(damps, jnp.zeros((), dtype).real.dtype)
    )
    if damps.ndim != 1 or damps.shape[0] == 0:
        raise ValueError("damps must be a non-empty 1-D array of damping values")
    if b.ndim != 1 or (getattr(A, "axis_name_m", None) is None and b.shape[0] != A.m):
        raise ValueError(
            f"b must be a vector of length m = {A.m}; got shape {b.shape}"
        )
    if itnlim is None:
        gm = int(getattr(A, "global_m", A.m))
        gn = int(getattr(A, "global_n", A.n))
        itnlim = min(gm, gn)
    if pair is None:
        pair = bool(getattr(A, "prefers_pair", False))
    if pair and not hasattr(A, "fused_pair"):
        raise ValueError(
            f"{type(A).__name__} does not implement fused_pair; set pair=False"
        )
    kwargs = dict(itnlim=int(itnlim), safe_norms=safe_norms, pair=pair)
    args = (
        A,
        b,
        damps,
        jnp.asarray(atol, dtype),
        jnp.asarray(btol, dtype),
        jnp.asarray(conlim, dtype),
    )
    if loop == "bounded":
        return _mdl_bounded(*args, seg_len=loop_segment, **kwargs)
    return _mdl_jit(*args, **kwargs)
