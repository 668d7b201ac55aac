"""Vector primitives — the functional, XLA-fused replacement for the
reference's vendored BLAS-1 layer (/root/reference/src/lsqrblas.f90:8-206).

dcopy/dscal/ddot are not reproduced as functions: in a functional JAX design
they are expressions (``y = x``, ``alpha * x``, ``jnp.vdot``) that XLA fuses
into neighbouring ops. What *does* need care is the overflow-safe 2-norm
(``dnrm2``'s scale/ssq loop, lsqrblas.f90:143-154) and the safe scalar hypot
(``d2norm``, lsqr.f90:1164-1179) — both provided here with the same
robustness guarantees expressed as data-parallel reductions instead of
sequential loops, so they fuse under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["nrm2", "d2norm", "safe_divide", "abs2"]


def abs2(x: jax.Array) -> jax.Array:
    """|x|^2 elementwise, always REAL-dtyped. For real inputs this is exactly
    ``jnp.square`` (same op, same rounding — parity with the reference's
    real-only squares is untouched); for complex inputs it is
    ``re^2 + im^2``, the quantity every norm/se recurrence in the complex
    extension of LSQR needs (the bidiagonalization scalars stay real,
    Paige–Saunders 1982 §3 applies verbatim over C with A' = conj-transpose).
    """
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return jnp.real(x * jnp.conj(x))
    return jnp.square(x)


def nrm2(x: jax.Array, *, safe: bool = True, axis_name=None) -> jax.Array:
    """Euclidean norm of ``x`` without overflow/underflow.

    Functional equivalent of the reference ``dnrm2`` (lsqrblas.f90:123-159),
    which uses a sequential scale/sum-of-squares recurrence. Here: a max
    reduction picks the scale, then a scaled sum of squares — two
    reductions XLA fuses into one pass. With ``safe=False`` it is the plain
    ``sqrt(sum(x^2))`` (faster; fine at f64 and for well-scaled data).

    Complex inputs return the REAL norm sqrt(sum |x_i|^2) in the matching
    real dtype (the reference is real-only; this is the complex extension's
    primitive).

    ``axis_name``: if given, the vector is sharded over that mesh axis
    (inside shard_map) and the reductions are completed with psum/pmax over
    the axis, producing the replicated global norm.
    """
    rdtype = jnp.zeros((), x.dtype).real.dtype
    if safe:
        amax = jnp.max(jnp.abs(x)) if x.size else jnp.zeros((), rdtype)
        if axis_name is not None:
            amax = jax.lax.pmax(amax, axis_name)
        scale = jnp.where(amax > 0, amax, jnp.ones((), rdtype))
        ssq = jnp.sum(abs2(x / scale))
        if axis_name is not None:
            ssq = jax.lax.psum(ssq, axis_name)
        return jnp.where(amax > 0, scale * jnp.sqrt(ssq), jnp.zeros((), rdtype))
    ssq = jnp.sum(abs2(x))
    if axis_name is not None:
        ssq = jax.lax.psum(ssq, axis_name)
    return jnp.sqrt(ssq)


def d2norm(a: jax.Array, b: jax.Array) -> jax.Array:
    """sqrt(a**2 + b**2) avoiding overflow — exact port of the reference's
    scale-by-|a|+|b| formulation (lsqr.f90:1164-1179) so the scalar
    recurrences round the same way as the Fortran build."""
    scale = jnp.abs(a) + jnp.abs(b)
    safe = jnp.where(scale > 0, scale, jnp.ones_like(scale))
    r = safe * jnp.sqrt(jnp.square(a / safe) + jnp.square(b / safe))
    return jnp.where(scale > 0, r, jnp.zeros_like(scale))


def safe_divide(num: jax.Array, den: jax.Array) -> jax.Array:
    """num/den with 0 where den == 0 (guards jit-traced branches the
    reference skips with runtime ``if`` tests, e.g. lsqr.f90:691-699)."""
    safe_den = jnp.where(den != 0, den, jnp.ones_like(den))
    return jnp.where(den != 0, num / safe_den, jnp.zeros_like(num * safe_den))
