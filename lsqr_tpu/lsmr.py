"""LSMR — the MINRES-flavored sibling of LSQR, as one jitted while_loop.

LSMR (Fong & Saunders, SIAM J. Sci. Comput. 2011) runs the same Golub–Kahan
bidiagonalization as LSQR (/root/reference/src/lsqr.f90:681-699) but applies
a second QR factorization so that the iterates minimize ``||A' r||`` — which
then decreases monotonically, making LSMR safer to stop early on
ill-conditioned least-squares problems. The reference library points to LSMR
as the companion algorithm (same authors' site); this module provides it on
the identical substrate: the same ``LinearOperator`` layer (COO /
DIA / ELL / JDIA, and the Triton pair kernel), the same safe-norm
primitives, the same bounded-loop form, and the same
``axis_name`` hooks so row-sharded operators work unchanged.

Semantics (istop taxonomy 0-7, defaults, result fields) follow the public
LSMR interface that `scipy.sparse.linalg.lsmr` also implements, so results
cross-check 1:1 against scipy in the test suite (tests/test_lsmr.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .ops.blas import nrm2
from .ops.linop import LinearOperator, as_operator

__all__ = ["LSMRResult", "lsmr", "LSMR_ISTOP_MESSAGES"]

LSMR_ISTOP_MESSAGES = {
    0: "The exact solution is x = 0",
    1: "Ax - b is small enough, given atol, btol",
    2: "The least-squares solution is good enough, given atol",
    3: "The estimate of cond(Abar) has exceeded conlim",
    4: "Ax - b is small enough for this machine",
    5: "The least-squares solution is good enough for this machine",
    6: "Cond(Abar) seems to be too large for this machine",
    7: "The iteration limit has been reached",
}

#: columns of the optional iteration trace buffer
LSMR_TRACE_COLUMNS = ("itn", "x0", "normr", "normar", "test1", "test2",
                      "norma", "conda")


class LSMRResult(NamedTuple):
    """LSMR outputs (the same tuple scipy.sparse.linalg.lsmr returns,
    plus the optional on-device trace)."""

    x: jax.Array        #: computed solution (n,)
    istop: jax.Array    #: termination reason 0-7
    itn: jax.Array      #: iterations performed
    normr: jax.Array    #: estimate of ||rbar|| = ||[b;0] - [A; damp I] x||
    normar: jax.Array   #: estimate of ||Abar' rbar||
    norma: jax.Array    #: Frobenius-norm estimate of Abar
    conda: jax.Array    #: condition estimate of Abar
    normx: jax.Array    #: norm(x)
    trace: Optional[jax.Array]  #: (itnlim+1, 8) iteration log or None

    @property
    def istop_message(self) -> str:
        return LSMR_ISTOP_MESSAGES[int(self.istop)]


class _Carry(NamedTuple):
    itn: jax.Array
    istop: jax.Array
    u: jax.Array
    v: jax.Array
    h: jax.Array
    hbar: jax.Array
    x: jax.Array
    alpha: jax.Array
    beta: jax.Array
    alphabar: jax.Array
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
    trace: jax.Array


def _sym_ortho(a, b, one, zero):
    """Stable Givens rotation (c, s, r) with the exact sign conventions of
    the published LSMR reference implementation (branchless form)."""
    absa = jnp.abs(a)
    absb = jnp.abs(b)
    sign_a = jnp.where(a >= zero, one, -one)
    sign_b = jnp.where(b >= zero, one, -one)

    # generic branches, each computed with division-safe operands
    safe_b = jnp.where(b != zero, b, one)
    tau_ab = a / safe_b               # |b| > |a| branch
    s_b = sign_b / jnp.sqrt(one + tau_ab * tau_ab)
    c_b = s_b * tau_ab
    r_b = safe_b / s_b

    safe_a = jnp.where(a != zero, a, one)
    tau_ba = b / safe_a               # |a| >= |b| branch
    c_a = sign_a / jnp.sqrt(one + tau_ba * tau_ba)
    s_a = c_a * tau_ba
    r_a = safe_a / c_a

    b_zero = b == zero
    a_zero = a == zero
    b_dom = absb > absa

    c = jnp.where(b_zero, sign_a, jnp.where(a_zero, zero, jnp.where(b_dom, c_b, c_a)))
    s = jnp.where(b_zero, zero, jnp.where(a_zero, sign_b, jnp.where(b_dom, s_b, s_a)))
    r = jnp.where(b_zero, absa, jnp.where(a_zero, absb, jnp.where(b_dom, r_b, r_a)))
    return c, s, r


def _build(
    A: LinearOperator,
    b: jax.Array,
    damp: jax.Array,
    atol: jax.Array,
    btol: jax.Array,
    conlim: jax.Array,
    *,
    itnlim: int,
    record_trace: bool,
    safe_norms: bool,
    pair: bool = False,
):
    """Construct (carry0, cond_fun, body_fun, finalize) — the same shape of
    pieces as solver._build, so the while and bounded loop forms share one
    iteration definition."""
    m, n = A.shape
    dtype = b.dtype
    # complex extension: vectors may be complex, every scalar of the
    # Fong–Saunders recurrence is REAL (see solver._build; rmatvec is the
    # conjugate-transpose product, so the bidiagonalization scalars are the
    # real norms either way)
    rdtype = jnp.zeros((), dtype).real.dtype
    is_complex = rdtype != dtype
    if is_complex and pair and not getattr(A, "supports_complex_pair", False):
        # ZDIAOperator's plane-split pair kernel handles complex; the
        # real-f32 kernels do not
        raise ValueError(
            "fused pair kernels are real-f32 only; set pair=False for "
            "complex operators"
        )
    zero = jnp.zeros((), rdtype)
    one = jnp.ones((), rdtype)
    axis_m = getattr(A, "axis_name_m", None)
    axis_n = getattr(A, "axis_name_n", None)

    def norm_m(vec):
        return nrm2(vec, safe=safe_norms, axis_name=axis_m)

    def norm_n(vec):
        return nrm2(vec, safe=safe_norms, axis_name=axis_n)

    ctol = jnp.where(conlim > zero, one / jnp.where(conlim > zero, conlim, one), zero)

    # ------------------------------------------------------------------
    # Setup: beta u = b; alpha v = A'u.
    # ------------------------------------------------------------------
    normb = norm_m(b)
    beta0 = normb
    safe_beta0 = jnp.where(beta0 > zero, beta0, one)
    u0 = jnp.where(beta0 > zero, b / safe_beta0, b)
    n_local = A.local_n if hasattr(A, "local_n") else n
    v0u = jnp.where(
        beta0 > zero, A.rmatvec(u0), jnp.zeros((n_local,), dtype)
    )
    alpha0 = jnp.where(beta0 > zero, norm_n(v0u), zero)
    safe_alpha0 = jnp.where(alpha0 > zero, alpha0, one)
    v0 = jnp.where(alpha0 > zero, v0u / safe_alpha0, v0u)

    normar0 = alpha0 * beta0

    trace_rows = itnlim + 1 if record_trace else 1
    trace0 = jnp.zeros((trace_rows, len(LSMR_TRACE_COLUMNS)), rdtype)
    if record_trace:
        row0 = jnp.stack(
            [zero, zero, beta0, normar0, one,
             jnp.where(normar0 > zero, alpha0 / safe_beta0, zero),
             zero, zero]
        ).astype(rdtype)
        trace0 = trace0.at[0].set(row0)

    carry0 = _Carry(
        itn=jnp.zeros((), jnp.int32),
        istop=jnp.zeros((), jnp.int32),
        u=u0,
        v=v0,
        h=v0,
        hbar=jnp.zeros((n_local,), dtype),
        x=jnp.zeros((n_local,), dtype),
        alpha=alpha0,
        beta=beta0,
        alphabar=alpha0,
        rho=one,
        rhobar=one,
        cbar=one,
        sbar=zero,
        zeta=zero,
        zetabar=alpha0 * beta0,
        betadd=beta0,
        betad=zero,
        rhodold=one,
        tautildeold=zero,
        thetatilde=zero,
        d=zero,
        norma2=alpha0 * alpha0,
        maxrbar=zero,
        minrbar=jnp.asarray(
            min(1e100, float(jnp.finfo(rdtype).max) / 2), rdtype
        ),
        normr=beta0,
        normar=normar0,
        norma=jnp.sqrt(alpha0 * alpha0),
        conda=one,
        normx=zero,
        trace=trace0,
    )

    def cond_fun(c: _Carry):
        return jnp.logical_and(c.istop == 0, normar0 != zero)

    def body_fun(c: _Carry) -> _Carry:
        itn = c.itn + 1

        # --- bidiagonalization step (identical to LSQR's) ---------------
        if pair:
            # ONE stripe pass for both products (the operator's fused_pair):
            # u_raw = A v - alpha u and the raw adjoint z = A'u_raw; the
            # 1/beta normalization commutes with A'.
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

        # --- plane rotation Phat: eliminate damp -------------------------
        chat, shat, alphahat = _sym_ortho(c.alphabar, damp, one, zero)

        # --- plane rotation P: eliminate beta ----------------------------
        rhoold = c.rho
        cgiv, sgiv, rho = _sym_ortho(alphahat, beta, one, zero)
        thetanew = sgiv * alpha
        alphabar = cgiv * alpha

        # --- plane rotation Pbar: eliminate thetanew ---------------------
        rhobarold = c.rhobar
        zetaold = c.zeta
        thetabar = c.sbar * rho
        rhotemp = c.cbar * rho
        cbar, sbar, rhobar = _sym_ortho(c.cbar * rho, thetanew, one, zero)
        zeta = cbar * c.zetabar
        zetabar = -sbar * c.zetabar

        # --- update h, hbar, x ------------------------------------------
        hbar = c.h - (thetabar * rho / (rhoold * rhobarold)) * c.hbar
        x = c.x + (zeta / (rho * rhobar)) * hbar
        h = v - (thetanew / rho) * c.h

        # --- estimate ||r|| ----------------------------------------------
        betaacute = chat * c.betadd
        betacheck = -shat * c.betadd
        betahat = cgiv * betaacute
        betadd = -sgiv * betaacute
        thetatildeold = c.thetatilde
        ctildeold, stildeold, rhotildeold = _sym_ortho(
            c.rhodold, thetabar, one, zero
        )
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * c.betad + ctildeold * betahat
        tautildeold = (zetaold - thetatildeold * c.tautildeold) / rhotildeold
        taud = (zeta - thetatilde * tautildeold) / rhodold
        d = c.d + betacheck * betacheck
        normr = jnp.sqrt(d + jnp.square(betad - taud) + betadd * betadd)

        # --- estimate ||A|| and cond(A) ----------------------------------
        norma2 = c.norma2 + beta * beta
        norma = jnp.sqrt(norma2)
        norma2 = norma2 + alpha * alpha
        maxrbar = jnp.maximum(c.maxrbar, rhobarold)
        minrbar = jnp.where(
            itn > 1, jnp.minimum(c.minrbar, rhobarold), c.minrbar
        )
        conda = jnp.maximum(maxrbar, rhotemp) / jnp.minimum(minrbar, rhotemp)

        # --- convergence tests -------------------------------------------
        normar = jnp.abs(zetabar)
        normx = norm_n(x)
        safe_normb = jnp.where(normb > zero, normb, one)
        test1 = normr / safe_normb
        denom2 = norma * normr
        test2 = jnp.where(
            denom2 > zero, normar / jnp.where(denom2 > zero, denom2, one),
            jnp.full((), jnp.inf, rdtype),
        )
        test3 = one / conda
        t1 = test1 / (one + norma * normx / safe_normb)
        rtol = btol + atol * norma * normx / safe_normb

        # priority order identical to the published implementation: later
        # assignments win
        istop = jnp.zeros((), jnp.int32)
        istop = jnp.where(itn >= itnlim, 7, istop)
        istop = jnp.where(one + test3 <= one, 6, istop)
        istop = jnp.where(one + test2 <= one, 5, istop)
        istop = jnp.where(one + t1 <= one, 4, istop)
        istop = jnp.where(test3 <= ctol, 3, istop)
        istop = jnp.where(test2 <= atol, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)

        trace = c.trace
        if record_trace:
            # scalar psum from the owning shard, not a full all_gather
            # (see solver.py's trace block)
            if axis_n is None:
                x0_val = x[0]
            else:
                own = jax.lax.axis_index(axis_n) == 0
                x0_val = jax.lax.psum(
                    jnp.where(own, x[0], jnp.zeros_like(x[0])), axis_n
                )
            if is_complex:
                x0_val = jnp.real(x0_val)
            row = jnp.stack(
                [itn.astype(rdtype), x0_val, normr, normar, test1,
                 jnp.where(jnp.isinf(test2), zero, test2), norma, conda]
            ).astype(rdtype)
            trace = trace.at[itn].set(row)

        return _Carry(
            itn=itn, istop=istop, u=u, v=v, h=h, hbar=hbar, x=x,
            alpha=alpha, beta=beta, alphabar=alphabar, rho=rho,
            rhobar=rhobar, cbar=cbar, sbar=sbar, zeta=zeta, zetabar=zetabar,
            betadd=betadd, betad=betad, rhodold=rhodold,
            tautildeold=tautildeold, thetatilde=thetatilde, d=d,
            norma2=norma2, maxrbar=maxrbar, minrbar=minrbar,
            normr=normr, normar=normar, norma=norma, conda=conda,
            normx=normx, trace=trace,
        )

    def finalize(final: _Carry) -> LSMRResult:
        return LSMRResult(
            x=final.x,
            istop=final.istop,
            itn=final.itn,
            normr=final.normr,
            normar=final.normar,
            norma=final.norma,
            conda=final.conda,
            normx=final.normx,
            trace=final.trace if record_trace else None,
        )

    return carry0, cond_fun, body_fun, finalize


def _lsmr_impl(A, b, damp, atol, btol, conlim, **static_opts) -> LSMRResult:
    carry0, cond_fun, body_fun, finalize = _build(
        A, b, damp, atol, btol, conlim, **static_opts
    )
    final = jax.lax.while_loop(cond_fun, body_fun, carry0)
    return finalize(final)


_lsmr_jit = jax.jit(
    _lsmr_impl, static_argnames=("itnlim", "record_trace", "safe_norms", "pair")
)


@partial(
    jax.jit,
    static_argnames=("seg_len", "itnlim", "record_trace", "safe_norms", "pair"),
)
def _segment_fori(A, b, damp, atol, btol, conlim, carry, *, seg_len, **static_opts):
    from .solver import _masked_body

    carry0, cond_fun, body_fun, _ = _build(
        A, b, damp, atol, btol, conlim, **static_opts
    )
    carry = carry if carry is not None else carry0
    return jax.lax.fori_loop(
        0, seg_len, _masked_body(cond_fun, body_fun), carry, unroll=False
    )


@partial(jax.jit, static_argnames=("itnlim", "record_trace", "safe_norms", "pair"))
def _finalize_only(A, b, damp, atol, btol, conlim, carry, **static_opts):
    _, _, _, finalize = _build(A, b, damp, atol, btol, conlim, **static_opts)
    return finalize(carry)


def _lsmr_bounded(A, b, damp, atol, btol, conlim, *, seg_len, itnlim, **static_opts):
    """Host-stepped fixed-segment form — the loop shape that composes with
    Pallas-product operators (see solver._lsqr_bounded)."""
    carry = None
    kwargs = dict(itnlim=itnlim, **static_opts)
    while True:
        prev_itn = int(carry.itn) if carry is not None else -1
        carry = _segment_fori(
            A, b, damp, atol, btol, conlim, carry,
            seg_len=min(seg_len, itnlim) if itnlim > 0 else seg_len,
            **kwargs,
        )
        if int(carry.istop) != 0 or int(carry.itn) >= itnlim:
            break
        if int(carry.itn) == prev_itn:
            break
    return _finalize_only(A, b, damp, atol, btol, conlim, carry, **kwargs)


def lsmr(
    A,
    b,
    damp: float = 0.0,
    *,
    atol: float = 1e-6,
    btol: float = 1e-6,
    conlim: float = 1e8,
    itnlim: Optional[int] = None,
    x0=None,
    record_trace: bool = False,
    safe_norms: bool = True,
    loop: str = "while",
    loop_segment: int = 64,
    m: Optional[int] = None,
    n: Optional[int] = None,
    pair: Optional[bool] = None,
    _jit: bool = True,
) -> LSMRResult:
    """Solve ``A x = b``, ``min ||A x - b||`` or its damped form with LSMR.

    Same operator/argument conventions as :func:`lsqr_tpu.lsqr`; defaults
    (atol/btol 1e-6, conlim 1e8, itnlim min(m, n)) follow the published LSMR
    interface so results cross-check directly against
    ``scipy.sparse.linalg.lsmr``. Unlike LSQR, ``||A' r||`` decreases
    monotonically, so early stopping is well-behaved on ill-conditioned
    problems.

    ``x0`` warm-starts via the residual-correction recipe
    (lsqr.f90:303-320) and therefore requires ``damp == 0``.
    """
    A = as_operator(A, m=m, n=n)
    b = jnp.asarray(b)
    dtype = b.dtype
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from .config import default_dtype

        dtype = default_dtype()
        b = b.astype(dtype)
    # tolerances/damp are always real, also for complex problems
    rdt = jnp.zeros((), dtype).real.dtype
    if b.ndim != 1 or (getattr(A, "axis_name_m", None) is None and b.shape[0] != A.m):
        raise ValueError(
            f"b must be a vector of length m = {A.m}; got shape {b.shape}"
        )

    # zero tolerances mean machine precision (the reference's semantics,
    # lsqr.f90:509-512), as in lsqr/cgls
    eps = float(jnp.finfo(rdt).eps)
    atol = eps if atol == 0 else atol
    btol = eps if btol == 0 else btol

    if x0 is not None:
        x0 = jnp.asarray(x0, dtype)
        if isinstance(damp, (int, float)) and damp != 0.0:
            # damped warm start via the stacked undamped form (see
            # lsqr_tpu.solver lsqr(): min ||[A; damp I] dx - [r0; -damp x0]||)
            from .ops.compose import diagonal_operator, vstack_operators

            damp_arr = jnp.asarray(damp, dtype)
            stacked = vstack_operators(
                [A, diagonal_operator(jnp.full((A.n,), damp_arr, dtype))]
            )
            rhs = jnp.concatenate([b - A.matvec(x0), -damp_arr * x0])
            res = lsmr(
                stacked, rhs, 0.0, atol=atol, btol=btol, conlim=conlim,
                itnlim=itnlim, record_trace=record_trace,
                safe_norms=safe_norms, loop=loop, loop_segment=loop_segment,
                _jit=_jit,
            )
            xw = x0 + res.x
            return res._replace(x=xw, normx=nrm2(xw, safe=safe_norms))
        r0 = b - A.matvec(x0)
        res = lsmr(
            A, r0, damp, atol=atol, btol=btol, conlim=conlim, itnlim=itnlim,
            record_trace=record_trace, safe_norms=safe_norms, loop=loop,
            loop_segment=loop_segment, pair=pair, _jit=_jit,
        )
        xw = x0 + res.x
        return res._replace(x=xw, normx=nrm2(xw, safe=safe_norms))

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
    kwargs = dict(
        itnlim=int(itnlim), record_trace=record_trace, safe_norms=safe_norms,
        pair=pair,
    )
    args = (
        A,
        b,
        jnp.asarray(damp, rdt),
        jnp.asarray(atol, rdt),
        jnp.asarray(btol, rdt),
        jnp.asarray(conlim, rdt),
    )
    if loop == "bounded":
        return _lsmr_bounded(*args, seg_len=loop_segment, **kwargs)
    fn = _lsmr_jit if _jit else _lsmr_impl
    return fn(*args, **kwargs)
