"""CRAIG — minimum-norm solver for consistent systems, as one jitted loop.

Craig's method (Paige & Saunders, ACM TOMS 1982, §7.4 of the LSQR paper —
the same paper the reference library implements, /root/reference/src/
lsqr.f90:264-301 "See also") runs the identical Golub–Kahan
bidiagonalization as LSQR but solves the lower-bidiagonal system
``L_k y_k = beta_1 e_1`` directly, producing iterates ``x_k = V_k y_k``
that converge to the MINIMUM-NORM solution of a consistent system
``A x = b`` (square or under-determined). Per-iteration cost is LOWER than
LSQR's (no Givens rotations, one fewer n-vector), but the method requires
``b ∈ range(A)`` — for incompatible systems use :func:`lsqr_tpu.lsqr` or
:func:`lsqr_tpu.lsmr`.

Recurrence: with ``L_k`` lower-bidiagonal (diag ``alpha_i``, subdiag
``beta_{i+1}``), forward substitution gives ``y_i = -(beta_i/alpha_i)
y_{i-1}`` (``y_1 = beta_1/alpha_1``), ``x_k = x_{k-1} + y_k v_k``, and the
residual satisfies ``||r_k|| = |beta_{k+1} y_k|`` exactly.

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

__all__ = ["CRAIGResult", "craig", "CRAIG_ISTOP_MESSAGES"]

CRAIG_ISTOP_MESSAGES = {
    0: "The exact solution is x = 0",
    1: "A x = b is solved to the requested tolerance",
    2: "A x = b is solved as accurately as machine precision allows",
    4: "The bidiagonalization broke down (b is not in range(A): "
       "the system is incompatible — use lsqr/lsmr)",
    5: "The iteration limit has been reached",
}


class CRAIGResult(NamedTuple):
    x: jax.Array        #: computed minimum-norm solution (n,)
    istop: jax.Array    #: termination reason (see CRAIG_ISTOP_MESSAGES)
    itn: jax.Array      #: iterations performed
    rnorm: jax.Array    #: exact ||b - A x|| estimate |beta_{k+1} y_k|
    anorm: jax.Array    #: Frobenius-norm estimate of A
    xnorm: jax.Array    #: norm(x)

    @property
    def istop_message(self) -> str:
        return CRAIG_ISTOP_MESSAGES[int(self.istop)]


class _Carry(NamedTuple):
    itn: jax.Array
    istop: jax.Array
    u: jax.Array
    v: jax.Array
    x: jax.Array
    alpha: jax.Array
    beta: jax.Array
    y: jax.Array        # current forward-substitution coefficient y_k
    anorm2: jax.Array   # running sum of alpha^2 + beta^2
    xnorm2: jax.Array   # running sum of y_k^2
    rnorm: jax.Array


def _build(
    A: LinearOperator,
    b: jax.Array,
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
    # complex extension: vectors may be complex, the bidiagonal entries and
    # the forward-substitution y_k are REAL (rmatvec is the conjugate-
    # transpose product — see solver._build)
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
    eps = jnp.asarray(jnp.finfo(rdtype).eps, rdtype)
    axis_m = getattr(A, "axis_name_m", None)
    axis_n = getattr(A, "axis_name_n", None)

    def norm_m(vec):
        return nrm2(vec, safe=safe_norms, axis_name=axis_m)

    def norm_n(vec):
        return nrm2(vec, safe=safe_norms, axis_name=axis_n)

    # ---- setup: beta_1 u_1 = b; alpha_1 v_1 = A'u_1 ----------------------
    bnorm = norm_m(b)
    beta0 = bnorm
    safe_beta0 = jnp.where(beta0 > zero, beta0, one)
    u0 = jnp.where(beta0 > zero, b / safe_beta0, b)
    n_local = A.local_n if hasattr(A, "local_n") else n
    v0u = jnp.where(beta0 > zero, A.rmatvec(u0), jnp.zeros((n_local,), dtype))
    alpha0 = jnp.where(beta0 > zero, norm_n(v0u), zero)
    safe_alpha0 = jnp.where(alpha0 > zero, alpha0, one)
    v0 = jnp.where(alpha0 > zero, v0u / safe_alpha0, v0u)

    # alpha_1 == 0 with beta_1 > 0 means A'b = 0: b has no component in
    # range(A) -> breakdown (istop 4); beta_1 == 0 means x = 0 (istop 0).
    istop0 = jnp.where(
        beta0 > zero,
        jnp.where(alpha0 > zero, 0, 4),
        0,
    ).astype(jnp.int32)

    carry0 = _Carry(
        itn=jnp.zeros((), jnp.int32),
        istop=istop0,
        u=u0,
        v=v0,
        x=jnp.zeros((n_local,), dtype),
        alpha=alpha0,
        beta=beta0,
        y=one,          # y_0 sentinel: y_1 = (beta_1/alpha_1) * y_0-sign chain
        anorm2=alpha0 * alpha0 + beta0 * beta0,
        xnorm2=zero,
        rnorm=beta0,
    )

    def cond_fun(c: _Carry):
        return jnp.logical_and(c.istop == 0, beta0 > zero)

    def body_fun(c: _Carry) -> _Carry:
        itn = c.itn + 1

        # forward substitution: y_k. y_1 = beta_1/alpha_1 (c.y starts at 1
        # with the sign chain folded into the recurrence below).
        y = jnp.where(
            itn == 1,
            c.beta / c.alpha,
            -(c.beta / c.alpha) * c.y,
        )
        x = c.x + y * c.v
        xnorm2 = c.xnorm2 + y * y

        # bidiagonalization step: beta_{k+1} u_{k+1} = A v_k - alpha_k u_k
        if pair:
            # both products in ONE stripe pass (the operator's fused_pair)
            u, z_adj = A.fused_pair(y=c.u, win=c.v, c1=one, c2=c.alpha)
        else:
            u = A.matvec(c.v) - c.alpha * c.u
        beta = norm_m(u)
        beta_pos = beta > zero
        safe_beta = jnp.where(beta_pos, beta, one)
        u = jnp.where(beta_pos, u / safe_beta, u)

        rnorm = beta * jnp.abs(y)

        # alpha_{k+1} v_{k+1} = A'u_{k+1} - beta_{k+1} v_k
        if pair:
            v_cand = jnp.where(beta_pos, z_adj / safe_beta, z_adj) - beta * c.v
        else:
            v_cand = A.rmatvec(u) - beta * c.v
        alpha_cand = norm_n(v_cand)
        alpha_pos = alpha_cand > zero
        safe_alpha = jnp.where(alpha_pos, alpha_cand, one)
        v = jnp.where(
            beta_pos & alpha_pos, v_cand / safe_alpha, c.v
        )
        alpha = jnp.where(beta_pos & alpha_pos, alpha_cand, c.alpha)

        anorm2 = c.anorm2 + jnp.where(
            beta_pos, beta * beta + jnp.where(alpha_pos, alpha_cand**2, zero),
            zero,
        )
        anorm = jnp.sqrt(anorm2)
        xnorm = jnp.sqrt(xnorm2)

        # stopping (same shape as LSQR's compatible-system test,
        # lsqr.f90:781-810): rnorm exact via |beta_{k+1} y_k|
        safe_bnorm = jnp.where(bnorm > zero, bnorm, one)
        test1 = rnorm / safe_bnorm
        rtol = btol + atol * anorm * xnorm / safe_bnorm

        istop = jnp.zeros((), jnp.int32)
        istop = jnp.where(itn >= itnlim, 5, istop)
        # beta breakdown: exact solution reached (rnorm == 0)
        istop = jnp.where(
            jnp.logical_and(beta_pos, jnp.logical_not(alpha_pos)), 4, istop
        )
        istop = jnp.where(one + test1 <= one, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)
        istop = jnp.where(jnp.logical_not(beta_pos), 1, istop)

        return _Carry(
            itn=itn, istop=istop, u=u, v=v, x=x, alpha=alpha, beta=beta,
            y=y, anorm2=anorm2, xnorm2=xnorm2, rnorm=rnorm,
        )

    def finalize(final: _Carry) -> CRAIGResult:
        return CRAIGResult(
            x=final.x,
            istop=final.istop,
            itn=final.itn,
            rnorm=final.rnorm,
            anorm=jnp.sqrt(final.anorm2),
            xnorm=jnp.sqrt(final.xnorm2),
        )

    return carry0, cond_fun, body_fun, finalize


def _craig_impl(A, b, atol, btol, **static_opts) -> CRAIGResult:
    carry0, cond_fun, body_fun, finalize = _build(A, b, atol, btol, **static_opts)
    final = jax.lax.while_loop(cond_fun, body_fun, carry0)
    return finalize(final)


_craig_jit = jax.jit(_craig_impl, static_argnames=("itnlim", "safe_norms", "pair"))


@partial(jax.jit, static_argnames=("seg_len", "itnlim", "safe_norms", "pair"))
def _segment_fori(A, b, atol, btol, carry, *, seg_len, **static_opts):
    from .solver import _masked_body

    carry0, cond_fun, body_fun, _ = _build(A, b, atol, btol, **static_opts)
    carry = carry if carry is not None else carry0
    return jax.lax.fori_loop(
        0, seg_len, _masked_body(cond_fun, body_fun), carry, unroll=False
    )


@partial(jax.jit, static_argnames=("itnlim", "safe_norms", "pair"))
def _finalize_only(A, b, atol, btol, carry, **static_opts):
    _, _, _, finalize = _build(A, b, atol, btol, **static_opts)
    return finalize(carry)


def _craig_bounded(A, b, atol, btol, *, seg_len, itnlim, **static_opts):
    carry = None
    kwargs = dict(itnlim=itnlim, **static_opts)
    while True:
        prev_itn = int(carry.itn) if carry is not None else -1
        carry = _segment_fori(
            A, b, atol, btol, carry,
            seg_len=min(seg_len, itnlim) if itnlim > 0 else seg_len,
            **kwargs,
        )
        if int(carry.istop) != 0 or int(carry.itn) >= itnlim:
            break
        if int(carry.itn) == prev_itn:
            break
    return _finalize_only(A, b, atol, btol, carry, **kwargs)


def craig(
    A,
    b,
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
) -> CRAIGResult:
    """Minimum-norm solution of a CONSISTENT system ``A x = b`` by Craig's
    method.

    Same operator/argument conventions as :func:`lsqr_tpu.lsqr`. The system
    must be compatible (``b ∈ range(A)``) — typical uses are square and
    under-determined systems; for least-squares problems use ``lsqr`` or
    ``lsmr``. ``x0`` warm-starts via the residual-correction recipe
    (lsqr.f90:303-320).
    """
    A = as_operator(A, m=m, n=n)
    b = jnp.asarray(b)
    dtype = b.dtype
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from .config import default_dtype

        dtype = default_dtype()
        b = b.astype(dtype)
    # tolerances are always real, also for complex problems
    rdt = jnp.zeros((), dtype).real.dtype
    if b.ndim != 1 or (getattr(A, "axis_name_m", None) is None and b.shape[0] != A.m):
        raise ValueError(
            f"b must be a vector of length m = {A.m}; got shape {b.shape}"
        )

    if x0 is not None:
        x0 = jnp.asarray(x0, dtype)
        r0 = b - A.matvec(x0)
        res = craig(
            A, r0, atol=atol, btol=btol, itnlim=itnlim,
            safe_norms=safe_norms, loop=loop, loop_segment=loop_segment,
            pair=pair, _jit=_jit,
        )
        xw = x0 + res.x
        return res._replace(x=xw, xnorm=nrm2(xw, safe=safe_norms))

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
        jnp.asarray(atol, rdt),
        jnp.asarray(btol, rdt),
    )
    if loop == "bounded":
        return _craig_bounded(*args, seg_len=loop_segment, **kwargs)
    fn = _craig_jit if _jit else _craig_impl
    return fn(*args, **kwargs)
