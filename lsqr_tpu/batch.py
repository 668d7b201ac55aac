"""Batched solves: many right-hand sides against one operator in a single
compiled program.

No reference analogue (the Fortran solves one rhs per call); on an
accelerator, batching is how small/medium solves reach high utilization: ``jax.vmap``
lifts the whole while_loop so all systems iterate together (each keeps its
own istop and stops updating once converged — the masked-carry semantics of
a vmapped while_loop), and the operator products become matrix-matrix work
that uses the card far better than lone matvecs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from .config import LSQROptions
from .ops.linop import as_operator
from .solver import LSQRResult, _build, _lsqr_impl, _masked_body

__all__ = ["lsqr_batch", "lsmr_batch", "cgls_batch"]


@partial(
    jax.jit,
    static_argnames=(
        "itnlim", "wantse", "nconv", "record_trace", "safe_norms", "debug_log",
        "scalar_dtype",
    ),
)
def _batch_impl(A, B, damp, atol, btol, conlim, **static_opts):
    def solve_one(b, d):
        return _lsqr_impl(A, b, d, atol, btol, conlim, **static_opts)

    return jax.vmap(solve_one)(B, damp)


_BATCH_STATICS = (
    "itnlim", "wantse", "nconv", "record_trace", "safe_norms", "debug_log",
    "scalar_dtype", "seg_len", "first",
)


@partial(jax.jit, static_argnames=_BATCH_STATICS)
def _batch_segment(A, B, damp, atol, btol, conlim, carry, *, seg_len, first,
                   **static_opts):
    """One fixed-length masked-fori segment for every problem in the batch
    (static trip count — the loop form that composes with Pallas kernels;
    see solver._segment_fori)."""

    def one(b, d, c):
        carry0, cond_fun, body_fun, _ = _build(
            A, b, d, atol, btol, conlim, **static_opts
        )
        c = carry0 if first else c
        return jax.lax.fori_loop(
            0, seg_len, _masked_body(cond_fun, body_fun), c, unroll=False
        )

    if first:
        return jax.vmap(lambda b, d: one(b, d, None))(B, damp)
    return jax.vmap(one)(B, damp, carry)


@partial(jax.jit, static_argnames=_BATCH_STATICS[:-2])
def _batch_finalize(A, B, damp, atol, btol, conlim, carry, **static_opts):
    def one(b, d, c):
        _, _, _, finalize = _build(A, b, d, atol, btol, conlim, **static_opts)
        return finalize(c)

    return jax.vmap(one)(B, damp, carry)


def _batch_bounded(A, B, damp, atol, btol, conlim, *, seg_len, itnlim,
                   **static_opts):
    """Host-stepped batched solve in fixed-size fori segments: the batched
    analogue of solver._lsqr_bounded. Each problem's carry freezes once its
    own stopping test fires; the host loop exits when every problem has
    stopped (or no problem makes progress — degenerate all-zero setups)."""
    carry = None
    kwargs = dict(itnlim=itnlim, **static_opts)
    sl = min(seg_len, itnlim) if itnlim > 0 else seg_len
    first = True
    while True:
        prev_itn = int(jnp.sum(carry.itn)) if carry is not None else -1
        carry = _batch_segment(
            A, B, damp, atol, btol, conlim, carry,
            seg_len=sl, first=first, **kwargs,
        )
        first = False
        done = bool(
            jnp.all((carry.istop != 0) | (carry.itn >= itnlim))
        )
        if done or int(jnp.sum(carry.itn)) == prev_itn:
            break
    return _batch_finalize(A, B, damp, atol, btol, conlim, carry, **kwargs)


def lsqr_batch(
    A,
    B,
    damp=0.0,
    *,
    options: Optional[LSQROptions] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
    **option_overrides,
) -> LSQRResult:
    """Solve ``min ||A x_i - b_i||`` for every column batch entry at once.

    Args:
      B: right-hand sides, shape (batch, m).
      damp: scalar or per-problem array of shape (batch,).

    Returns an :class:`LSQRResult` whose fields carry a leading batch
    dimension (x: (batch, n), istop: (batch,), ...). Each problem stops at
    its own iteration; ``itn`` reports per-problem counts while the compiled
    loop runs until the last one converges.
    """
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)

    A = as_operator(A, m=m, n=n)
    loop = opts.loop
    B = jnp.asarray(B)
    if B.ndim != 2 or B.shape[1] != A.m:
        raise ValueError(
            f"B must have shape (batch, m={A.m}); got {B.shape}"
        )
    dtype = opts.dtype or (
        B.dtype if jnp.issubdtype(B.dtype, jnp.inexact) else None
    )
    if dtype is None:
        from .config import default_dtype

        dtype = default_dtype()
    B = B.astype(dtype)
    batch = B.shape[0]
    # damps are always real, also for complex problems (see solver._build)
    rdt = jnp.zeros((), dtype).real.dtype
    damp_arr = jnp.broadcast_to(jnp.asarray(damp, rdt), (batch,))

    itnlim = opts.resolve_itnlim(A.n)
    kwargs = dict(
        wantse=opts.wantse,
        nconv=opts.nconv,
        record_trace=opts.record_trace,
        safe_norms=opts.safe_norms,
        debug_log=False,  # debug printing is not meaningful under vmap
        scalar_dtype=(str(jnp.dtype(opts.scalar_dtype))
                      if opts.scalar_dtype is not None else None),
    )
    args = (
        A,
        B,
        damp_arr,
        jnp.asarray(opts.atol, rdt),
        jnp.asarray(opts.btol, rdt),
        jnp.asarray(opts.conlim, rdt),
    )
    if loop == "bounded":
        return _batch_bounded(
            *args, seg_len=opts.loop_segment, itnlim=itnlim, **kwargs
        )
    return _batch_impl(*args, itnlim=itnlim, **kwargs)


# ---------------------------------------------------------------------------
# Sibling batches: the same vmapped-loop / bounded-segment pattern over the
# LSMR and CGLS builders (one operator, many right-hand sides).
# ---------------------------------------------------------------------------


_SIBLING_RUNNERS = {}


def _sibling_batch(build):
    """Factory: batched runner over a sibling solver's _build pieces;
    ``scalars`` are the solver's trailing scalar args (atol, btol, ...).
    Memoized per build function so the jitted closures (and their compile
    caches) are created once."""
    if build in _SIBLING_RUNNERS:
        return _SIBLING_RUNNERS[build]

    @partial(jax.jit, static_argnames=("static_opts", "seg_len", "first"))
    def seg(A, B, damp, scalars, carry, *, static_opts, seg_len, first):
        so = dict(static_opts)

        def one(b, d, c):
            carry0, cond_fun, body_fun, _ = build(A, b, d, *scalars, **so)
            c = carry0 if first else c
            return jax.lax.fori_loop(
                0, seg_len, _masked_body(cond_fun, body_fun), c, unroll=False
            )

        if first:
            return jax.vmap(lambda b, d: one(b, d, None))(B, damp)
        return jax.vmap(one)(B, damp, carry)

    @partial(jax.jit, static_argnames=("static_opts",))
    def fin(A, B, damp, scalars, carry, *, static_opts):
        so = dict(static_opts)

        def one(b, d, c):
            _, _, _, finalize = build(A, b, d, *scalars, **so)
            return finalize(c)

        return jax.vmap(one)(B, damp, carry)

    @partial(jax.jit, static_argnames=("static_opts",))
    def whole(A, B, damp, scalars, *, static_opts):
        so = dict(static_opts)

        def one(b, d):
            carry0, cond_fun, body_fun, finalize = build(A, b, d, *scalars,
                                                         **so)
            return finalize(jax.lax.while_loop(cond_fun, body_fun, carry0))

        return jax.vmap(one)(B, damp)

    def run(A, B, damp, scalars, *, itnlim, seg_len, loop, static_opts):
        so_key = tuple(sorted(static_opts.items()))
        if loop != "bounded":
            return whole(A, B, damp, scalars, static_opts=so_key)
        carry = None
        first = True
        sl = min(seg_len, itnlim) if itnlim > 0 else seg_len
        while True:
            prev = int(jnp.sum(carry.itn)) if carry is not None else -1
            carry = seg(A, B, damp, scalars, carry,
                        static_opts=so_key, seg_len=sl, first=first)
            first = False
            done = bool(jnp.all((carry.istop != 0) | (carry.itn >= itnlim)))
            if done or int(jnp.sum(carry.itn)) == prev:
                break
        return fin(A, B, damp, scalars, carry, static_opts=so_key)

    _SIBLING_RUNNERS[build] = run
    return run


def _batch_setup(A, B, damp, m, n):
    A = as_operator(A, m=m, n=n)
    B = jnp.asarray(B)
    if B.ndim != 2 or B.shape[1] != A.m:
        raise ValueError(f"B must have shape (batch, m={A.m}); got {B.shape}")
    dtype = B.dtype if jnp.issubdtype(B.dtype, jnp.inexact) else None
    if dtype is None:
        from .config import default_dtype

        dtype = default_dtype()
    B = B.astype(dtype)
    # damps are always real, also for complex problems (see solver._build)
    rdt = jnp.zeros((), dtype).real.dtype
    damp_arr = jnp.broadcast_to(jnp.asarray(damp, rdt), (B.shape[0],))
    return A, B, damp_arr, dtype


def lsmr_batch(A, B, damp=0.0, *, atol=1e-6, btol=1e-6, conlim=1e8,
               itnlim=None, safe_norms=True, loop="while", loop_segment=64,
               m=None, n=None):
    """Batched LSMR: solve every row of B at once (see :func:`lsqr_batch`;
    result fields carry a leading batch dimension)."""
    import importlib

    lsmr_mod = importlib.import_module("lsqr_tpu.lsmr")
    A, B, damp_arr, dtype = _batch_setup(A, B, damp, m, n)
    if itnlim is None:
        itnlim = min(int(A.m), int(A.n))
    rdt = jnp.zeros((), dtype).real.dtype
    scalars = (jnp.asarray(atol, rdt), jnp.asarray(btol, rdt),
               jnp.asarray(conlim, rdt))
    so = dict(itnlim=int(itnlim), record_trace=False, safe_norms=safe_norms)
    return _sibling_batch(lsmr_mod._build)(
        A, B, damp_arr, scalars, itnlim=int(itnlim), seg_len=loop_segment,
        loop=loop, static_opts=so,
    )


def cgls_batch(A, B, damp=0.0, *, atol=1e-6, btol=1e-6, itnlim=None,
               safe_norms=True, loop="while", loop_segment=64, m=None, n=None):
    """Batched CGLS (see :func:`lsqr_batch`)."""
    import importlib

    cgls_mod = importlib.import_module("lsqr_tpu.cgls")
    A, B, damp_arr, dtype = _batch_setup(A, B, damp, m, n)
    if itnlim is None:
        itnlim = 4 * int(A.n)
    rdt = jnp.zeros((), dtype).real.dtype
    scalars = (jnp.asarray(atol, rdt), jnp.asarray(btol, rdt))
    so = dict(itnlim=int(itnlim), safe_norms=safe_norms)
    return _sibling_batch(cgls_mod._build)(
        A, B, damp_arr, scalars, itnlim=int(itnlim), seg_len=loop_segment,
        loop=loop, static_opts=so,
    )
