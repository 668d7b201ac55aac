"""CGLS — conjugate-gradient least squares, as one jitted loop.

CGLS (Hestenes & Stiefel 1952; the stabilized formulation of Björck 1996,
§7.4) is the classic alternative to LSQR that the reference's own paper
compares against (Paige & Saunders, ACM TOMS 1982, §1 and §9 — the paper
/root/reference/src/lsqr.f90:264-301 implements): CG applied to the normal
equations ``(A'A + damp² I) x = A'b`` WITHOUT forming ``A'A``. In exact
arithmetic its iterates coincide with LSQR's; in floating point LSQR is
slightly more stable on ill-conditioned problems while CGLS does one
fewer vector operation per iteration — both are offered so users can
match whichever their existing workflow used.

Per iteration: one ``matvec``, one ``rmatvec``, two norms and three
axpy's — the same two O(nnz) hot products as LSQR's bidiagonalization
(lsqr.f90:681-699), so every operator/sharding path (DIA/JDIA/ELL/COO
Pallas kernels, row-sharded meshes via ``axis_name`` hooks) is reused
unchanged.

Estimates: ``rnorm`` (damped: ``sqrt(||r||² + damp²||x||²)``) is computed
directly from the maintained residual each iteration (the classic CGLS
recurrence collapses under f32 cancellation — measured on-chip); ``arnorm =
||A'r - damp² x||`` is the optimality residual (sqrt(gamma));
``anorm`` is a monotone lower-bound estimate ``max_k ||A p_k|| / ||p_k||``
(a Rayleigh-quotient bound, analogous in role to LSQR's Frobenius
accumulation lsqr.f90:689).

Built on the same substrate as the other solvers: the
``LinearOperator`` layer, safe norms, while/bounded loop forms, and the
``axis_name`` hooks so row-sharded operators work unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .ops.blas import nrm2
from .ops.linop import LinearOperator, as_operator

__all__ = ["CGLSResult", "cgls", "CGLS_ISTOP_MESSAGES"]

CGLS_ISTOP_MESSAGES = {
    0: "The exact solution is x = 0",
    1: "A x = b is solved to the requested tolerance",
    2: "min ||A x - b|| is solved to the requested tolerance (A'r small)",
    4: "The search direction broke down (delta == 0): x is optimal to "
       "working precision",
    5: "The iteration limit has been reached",
    6: "The recurrence diverged past the working-precision noise floor; "
       "x is the best iterate seen (smallest optimality residual)",
}


class CGLSResult(NamedTuple):
    x: jax.Array        #: computed solution (n,)
    istop: jax.Array    #: termination reason (see CGLS_ISTOP_MESSAGES)
    itn: jax.Array      #: iterations performed
    rnorm: jax.Array    #: ||b - A x|| (damped: sqrt(||r||² + damp² ||x||²))
    arnorm: jax.Array   #: ||A'r - damp² x|| — the optimality residual
    anorm: jax.Array    #: lower-bound estimate of ||A|| (max ||A p||/||p||)
    xnorm: jax.Array    #: norm(x)

    @property
    def istop_message(self) -> str:
        return CGLS_ISTOP_MESSAGES[int(self.istop)]


class _Carry(NamedTuple):
    itn: jax.Array
    istop: jax.Array
    x: jax.Array
    r: jax.Array        # m-space residual b - A x
    p: jax.Array        # n-space search direction
    gamma: jax.Array    # ||A'r - damp² x||²
    anorm: jax.Array
    rnorm: jax.Array    # sqrt(||r||² + damp² ||x||²), computed directly
    ar: jax.Array       # A'r, maintained by recurrence (pair mode only;
    #                     a (1,) placeholder otherwise)
    gmin: jax.Array     # smallest gamma seen (noise-floor divergence guard)
    xbest: jax.Array    # iterate at gmin
    rbest: jax.Array    # rnorm at gmin


def _build(
    A: LinearOperator,
    b: jax.Array,
    damp: jax.Array,
    atol: jax.Array,
    btol: jax.Array,
    *,
    itnlim: int,
    safe_norms: bool,
    pair: bool = False,
):
    """(carry0, cond_fun, body_fun, finalize) — the same pieces as
    solver._build so the while and bounded loop forms share one iteration
    definition."""
    m, n = A.shape
    dtype = b.dtype
    # complex extension: vectors may be complex, every scalar of the CG
    # recurrence is REAL (alpha/beta/gamma/delta are all built from norms;
    # rmatvec is the conjugate-transpose product — see solver._build)
    rdtype = jnp.zeros((), dtype).real.dtype
    if rdtype != dtype and pair and not getattr(
        A, "supports_complex_pair", False
    ):
        # ZDIAOperator's plane-split pair kernel handles complex
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

    # ---- setup: r_0 = b; s_0 = A'r_0; p_0 = s_0 --------------------------
    bnorm = norm_m(b)
    n_local = A.local_n if hasattr(A, "local_n") else n
    s0 = jnp.where(bnorm > zero, A.rmatvec(b), jnp.zeros((n_local,), dtype))
    gnorm0 = norm_n(s0)
    gamma0 = gnorm0 * gnorm0

    # A'b == 0 -> x = 0 is the least-squares solution (istop 0)
    istop0 = jnp.where(gnorm0 > zero, 0, 0).astype(jnp.int32)
    active0 = (bnorm > zero) & (gnorm0 > zero)

    carry0 = _Carry(
        itn=jnp.zeros((), jnp.int32),
        istop=istop0,
        x=jnp.zeros((n_local,), dtype),
        r=b,
        p=s0,
        gamma=gamma0,
        anorm=zero,
        rnorm=bnorm,
        # pair mode maintains A'r by the exact recurrence A'r_{k+1} =
        # A'r_k - alpha_k (A'q_k); seeded with s_0 = A'b (x_0 = 0)
        ar=s0 if pair else jnp.zeros((1,), dtype),
        gmin=gamma0,
        xbest=jnp.zeros((n_local,), dtype),
        rbest=bnorm,
    )

    def cond_fun(c: _Carry):
        return jnp.logical_and(c.istop == 0, active0)

    def body_fun(c: _Carry) -> _Carry:
        itn = c.itn + 1

        if pair:
            # q = A p and t = A'q in ONE stripe pass (the operator's
            # fused_pair with c2 = 0); t feeds the A'r recurrence below.
            q, t_adj = A.fused_pair(y=c.r, win=c.p, c1=one, c2=zero)
        else:
            q = A.matvec(c.p)
        qn = norm_m(q)
        pn = norm_n(c.p)
        delta = qn * qn + damp * damp * pn * pn
        safe_delta = jnp.where(delta > zero, delta, one)
        alpha = jnp.where(delta > zero, c.gamma / safe_delta, zero)

        x = c.x + alpha * c.p
        r = c.r - alpha * q
        # A(p)/||p|| is a Rayleigh lower bound on ||A||
        safe_pn = jnp.where(pn > zero, pn, one)
        anorm = jnp.maximum(c.anorm, jnp.where(pn > zero, qn / safe_pn, zero))

        if pair:
            ar = c.ar - alpha * t_adj
            s = ar - damp * damp * x
        else:
            ar = c.ar
            s = A.rmatvec(r) - damp * damp * x
        gnorm = norm_n(s)
        gamma = gnorm * gnorm
        safe_gamma = jnp.where(c.gamma > zero, c.gamma, one)
        beta = jnp.where(c.gamma > zero, gamma / safe_gamma, zero)
        p = s + beta * c.p

        # the damped residual norm, computed DIRECTLY from the maintained
        # r (the recurrence rnorm² -= alpha*gamma collapses to zero under
        # f32 cancellation near convergence and fires istop=1 early —
        # observed on-chip; one extra m-reduction buys an honest value)
        xnorm = norm_n(x)
        rn = norm_m(r)
        rnorm = jnp.sqrt(rn * rn + damp * damp * xnorm * xnorm)

        # stopping, mirroring LSQR's test shapes (lsqr.f90:781-810)
        safe_bnorm = jnp.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        denom2 = anorm * rnorm
        safe_d2 = jnp.where(denom2 > zero, denom2, one)
        test2 = jnp.where(denom2 > zero, gnorm / safe_d2, zero)
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        istop = jnp.zeros((), jnp.int32)
        istop = jnp.where(itn >= itnlim, 5, istop)
        istop = jnp.where(delta <= zero, 4, istop)
        istop = jnp.where(one + test2 <= one, 2, istop)
        istop = jnp.where(one + test1 <= one, 1, istop)
        istop = jnp.where(test2 <= atol, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)

        # Noise-floor divergence guard: past convergence the CG recurrence
        # has no self-correction (unlike LSQR's rotations) — gamma collapses
        # to noise, beta = gamma_new/gamma_old explodes, p overflows, and
        # the iterate diverges through finite-but-huge steps before any
        # inf/NaN appears. Track the best iterate by the optimality
        # residual gamma = ||A'r - damp^2 x||^2 and stop (istop 6) when
        # gamma climbs 8 orders of magnitude past its minimum (CG gamma is
        # not monotone, but 1e8 growth is definitive divergence); finalize
        # then returns the BEST iterate, not the diverged one.
        better = gamma < c.gmin
        gmin = jnp.where(better, gamma, c.gmin)
        xbest = jnp.where(better, x, c.xbest)
        rbest = jnp.where(better, rnorm, c.rbest)
        finite = (jnp.isfinite(delta) & jnp.isfinite(gamma)
                  & jnp.isfinite(rnorm))
        diverged = (~finite) | (gamma > 1e8 * gmin)
        istop = jnp.where(diverged, 6, istop)

        return _Carry(
            itn=itn, istop=istop, x=x, r=r, p=p, gamma=gamma,
            anorm=anorm, rnorm=rnorm, ar=ar,
            gmin=gmin, xbest=xbest, rbest=rbest,
        )

    def finalize(final: _Carry) -> CGLSResult:
        diverged = final.istop == 6
        x = jnp.where(diverged, final.xbest, final.x)
        return CGLSResult(
            x=x,
            istop=final.istop,
            itn=final.itn,
            rnorm=jnp.where(diverged, final.rbest, final.rnorm),
            arnorm=jnp.sqrt(jnp.where(diverged, final.gmin, final.gamma)),
            anorm=final.anorm,
            xnorm=nrm2(x, safe=safe_norms),
        )

    return carry0, cond_fun, body_fun, finalize


def _cgls_impl(A, b, damp, atol, btol, **static_opts) -> CGLSResult:
    carry0, cond_fun, body_fun, finalize = _build(
        A, b, damp, atol, btol, **static_opts
    )
    final = jax.lax.while_loop(cond_fun, body_fun, carry0)
    return finalize(final)


_cgls_jit = jax.jit(_cgls_impl, static_argnames=("itnlim", "safe_norms", "pair"))


@partial(jax.jit, static_argnames=("seg_len", "itnlim", "safe_norms", "pair"))
def _segment_fori(A, b, damp, atol, btol, carry, *, seg_len, **static_opts):
    from .solver import _masked_body

    carry0, cond_fun, body_fun, _ = _build(A, b, damp, atol, btol, **static_opts)
    carry = carry if carry is not None else carry0
    return jax.lax.fori_loop(
        0, seg_len, _masked_body(cond_fun, body_fun), carry, unroll=False
    )


@partial(jax.jit, static_argnames=("itnlim", "safe_norms", "pair"))
def _finalize_only(A, b, damp, atol, btol, carry, **static_opts):
    _, _, _, finalize = _build(A, b, damp, atol, btol, **static_opts)
    return finalize(carry)


def _cgls_bounded(A, b, damp, atol, btol, *, seg_len, itnlim, **static_opts):
    carry = None
    kwargs = dict(itnlim=itnlim, **static_opts)
    while True:
        prev_itn = int(carry.itn) if carry is not None else -1
        carry = _segment_fori(
            A, b, damp, atol, btol, carry,
            seg_len=min(seg_len, itnlim) if itnlim > 0 else seg_len,
            **kwargs,
        )
        if int(carry.istop) != 0 or int(carry.itn) >= itnlim:
            break
        if int(carry.itn) == prev_itn:
            break
    return _finalize_only(A, b, damp, atol, btol, carry, **kwargs)


def cgls(
    A,
    b,
    damp: float = 0.0,
    *,
    atol: float = 1e-6,
    btol: float = 1e-6,
    itnlim: Optional[int] = None,
    x0=None,
    safe_norms: bool = True,
    loop: str = "while",
    loop_segment: int = 64,
    m: Optional[int] = None,
    n: Optional[int] = None,
    pair: Optional[bool] = None,
    _jit: bool = True,
) -> CGLSResult:
    """Solve ``min ||A x - b||`` (optionally damped: ``min ||A x - b||² +
    damp² ||x||²``) by conjugate gradients on the normal equations.

    Same operator/argument conventions as :func:`lsqr_tpu.lsqr`. In exact
    arithmetic CGLS and LSQR produce the same iterates; prefer ``lsqr``
    for ill-conditioned problems (better floating-point stability) and
    ``cgls`` when matching an existing CGLS-based workflow. ``x0``
    warm-starts via the residual-correction recipe (lsqr.f90:303-320,
    undamped only — the damped correction problem differs from the
    original damped problem).
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
    # lsqr.f90:509-512); literal 0.0 would leave only the 1+t<=1 guards,
    # which f32 noise can hover just above
    eps = float(jnp.finfo(rdt).eps)
    atol = eps if atol == 0 else atol
    btol = eps if btol == 0 else btol

    if x0 is not None:
        x0 = jnp.asarray(x0, dtype)
        if isinstance(damp, (int, float)) and damp != 0.0:
            # damped warm start via the stacked undamped form (see
            # lsqr_tpu.solver lsqr())
            from .ops.compose import diagonal_operator, vstack_operators

            damp_arr = jnp.asarray(damp, dtype)
            stacked = vstack_operators(
                [A, diagonal_operator(jnp.full((A.n,), damp_arr, dtype))]
            )
            rhs = jnp.concatenate([b - A.matvec(x0), -damp_arr * x0])
            res = cgls(
                stacked, rhs, 0.0, atol=atol, btol=btol, itnlim=itnlim,
                safe_norms=safe_norms, loop=loop,
                loop_segment=loop_segment, _jit=_jit,
            )
            xw = x0 + res.x
            return res._replace(x=xw, xnorm=nrm2(xw, safe=safe_norms))
        r0 = b - A.matvec(x0)
        res = cgls(
            A, r0, damp, atol=atol, btol=btol, itnlim=itnlim,
            safe_norms=safe_norms, loop=loop, loop_segment=loop_segment,
            pair=pair, _jit=_jit,
        )
        xw = x0 + res.x
        return res._replace(x=xw, xnorm=nrm2(xw, safe=safe_norms))

    if itnlim is None:
        gn = int(getattr(A, "global_n", A.n))
        itnlim = 4 * gn
    # pair is OPT-IN for CGLS (unlike lsqr/lsmr/craig auto): the A'r
    # recurrence it introduces adds one more level of f32 drift on top of
    # CGLS's already-weaker stability; users trading a little accuracy for
    # halved stripe traffic enable it explicitly.
    if pair is None:
        pair = False
    if pair and not hasattr(A, "fused_pair"):
        raise ValueError(
            f"{type(A).__name__} does not implement fused_pair; set pair=False"
        )
    kwargs = dict(itnlim=int(itnlim), safe_norms=safe_norms, pair=pair)
    args = (
        A,
        b,
        jnp.asarray(damp, rdt),
        jnp.asarray(atol, rdt),
        jnp.asarray(btol, rdt),
    )
    if loop == "bounded":
        return _cgls_bounded(*args, seg_len=loop_segment, **kwargs)
    fn = _cgls_jit if _jit else _cgls_impl
    return fn(*args, **kwargs)
