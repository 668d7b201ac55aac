"""Segmented solves with checkpoint/resume.

The reference has NO checkpointing (SURVEY.md §5) — its docstring only
documents the x0 warm-start recipe (lsqr.f90:303-320), which :func:`lsqr`
already exposes. For long runs this module adds real carry-state
checkpointing: the entire solver state is the while_loop carry (~10 scalars
plus the u, v, w, x, se vectors), so a solve can be cut into fixed-size
segments with the state saved to disk between them and resumed later — on a
different host if need be.

Semantics are bit-identical to the one-shot solve: segments run the SAME
body function (lsqr_tpu.solver._build) and the stopping tests are evaluated
inside the loop exactly as before; the segment boundary only adds an upper
bound on iterations per jit call.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LSQROptions
from ..ops.linop import as_operator
from ..solver import LSQRResult, _Carry, _build

__all__ = [
    "lsqr_checkpointed",
    "lsmr_checkpointed",
    "cgls_checkpointed",
    "craig_checkpointed",
    "save_state",
    "load_state",
]


@partial(
    jax.jit,
    static_argnames=(
        "itnlim", "wantse", "nconv", "record_trace", "safe_norms", "debug_log",
        "scalar_dtype",
    ),
)
def _segment(A, b, damp, atol, btol, conlim, carry, stop_at, **static_opts):
    carry0, cond_fun, body_fun, _ = _build(
        A, b, damp, atol, btol, conlim, **static_opts
    )
    carry = carry if carry is not None else carry0

    def bounded_cond(c):
        return jnp.logical_and(cond_fun(c), c.itn < stop_at)

    return jax.lax.while_loop(bounded_cond, body_fun, carry)


@partial(
    jax.jit,
    static_argnames=(
        "itnlim", "wantse", "nconv", "record_trace", "safe_norms", "debug_log",
        "scalar_dtype",
    ),
)
def _finalize(A, b, damp, atol, btol, conlim, carry, **static_opts):
    _, _, _, finalize = _build(A, b, damp, atol, btol, conlim, **static_opts)
    return finalize(carry)


def save_state(path: str, carry) -> None:
    """Serialize a solver carry (any solver's NamedTuple) to an .npz file."""
    np.savez(path, **{f: np.asarray(getattr(carry, f)) for f in carry._fields})


def load_state(path: str, dtype=None, carry_cls=_Carry):
    """Load a solver carry saved by :func:`save_state`.

    ``carry_cls`` selects the solver (default: LSQR's carry; pass
    ``lsmr._Carry`` / ``cgls._Carry`` / ``craig._Carry`` for the
    siblings' checkpoints)."""
    data = np.load(path)
    kw = {}
    if dtype is not None:
        cdt = jnp.dtype(dtype)
        # scalar recurrence fields are REAL even when the problem (and its
        # vector fields) is complex — cast each saved field to its own
        # counterpart of the requested dtype (see solver._build)
        rdt = jnp.zeros((), cdt).real.dtype
        # complex vector fields cast to the COMPLEX counterpart of the
        # requested precision — a real `dtype` request must not silently
        # drop imaginary parts of a complex checkpoint (ADVICE.md round 3)
        ccdt = jnp.result_type(cdt, jnp.complex64)
    for f in carry_cls._fields:
        arr = jnp.asarray(data[f])
        if dtype is not None:
            if jnp.issubdtype(arr.dtype, jnp.complexfloating):
                arr = arr.astype(ccdt)
            elif jnp.issubdtype(arr.dtype, jnp.floating):
                arr = arr.astype(rdt)
        kw[f] = arr
    return carry_cls(**kw)


def lsqr_checkpointed(
    A,
    b,
    damp: float = 0.0,
    *,
    segment_iters: int = 100,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    on_segment: Optional[Callable[[int, _Carry], None]] = None,
    options: Optional[LSQROptions] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
    **option_overrides,
) -> LSQRResult:
    """Solve like :func:`lsqr_tpu.lsqr`, but in segments of
    ``segment_iters`` iterations, optionally persisting the carry after each
    segment and/or resuming from a saved carry.

    Args:
      segment_iters: iterations per jit call (one device roundtrip each).
      checkpoint_path: if given, the carry is written there (npz) after
        every segment.
      resume_from: path of a previously saved carry to resume.
      on_segment: callback (segment_index, carry) after each segment.
    """
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)

    A = as_operator(A, m=m, n=n)
    b = jnp.asarray(b)
    dtype = opts.dtype or (
        b.dtype if jnp.issubdtype(b.dtype, jnp.inexact) else None
    )
    if dtype is None:
        from ..config import default_dtype

        dtype = default_dtype()
    b = b.astype(dtype)

    itnlim = opts.resolve_itnlim(A.n)
    static_opts = dict(
        itnlim=itnlim,
        wantse=opts.wantse,
        nconv=opts.nconv,
        record_trace=opts.record_trace,
        safe_norms=opts.safe_norms,
        debug_log=opts.debug_log,
        scalar_dtype=(str(jnp.dtype(opts.scalar_dtype))
                      if opts.scalar_dtype is not None else None),
    )
    rdt = jnp.zeros((), dtype).real.dtype  # scalars are real for complex b
    args = (
        A,
        b,
        jnp.asarray(damp, rdt),
        jnp.asarray(opts.atol, rdt),
        jnp.asarray(opts.btol, rdt),
        jnp.asarray(opts.conlim, rdt),
    )

    carry = load_state(resume_from, dtype=dtype) if resume_from else None
    seg = 0
    while True:
        start = int(carry.itn) if carry is not None else 0
        stop_at = min(start + segment_iters, itnlim)
        carry = _segment(*args, carry, jnp.asarray(stop_at, jnp.int32), **static_opts)
        seg += 1
        if checkpoint_path:
            save_state(checkpoint_path, jax.device_get(carry))
        if on_segment is not None:
            on_segment(seg, carry)
        # stopped for real (istop set) or iteration budget exhausted
        if int(carry.istop) != 0 or int(carry.itn) >= itnlim:
            break
        # degenerate setup (arnorm0 == 0): the loop never runs
        if int(carry.itn) == start:
            break

    return _finalize(*args, carry, **static_opts)


# ---------------------------------------------------------------------------
# Sibling solvers (LSMR / CGLS / CRAIG) on the same segmented runner: each
# solver's _build returns the same (carry0, cond, body, finalize) pieces, so
# one generic loop checkpoints them all.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("build", "static_opts"))
def _segment_generic(build, static_opts, args, carry, stop_at):
    carry0, cond_fun, body_fun, _ = build(*args, **dict(static_opts))
    carry = carry if carry is not None else carry0

    def bounded_cond(c):
        return jnp.logical_and(cond_fun(c), c.itn < stop_at)

    return jax.lax.while_loop(bounded_cond, body_fun, carry)


@partial(jax.jit, static_argnames=("build", "static_opts"))
def _finalize_generic(build, static_opts, args, carry):
    _, _, _, finalize = build(*args, **dict(static_opts))
    return finalize(carry)


def _run_checkpointed(build, args, static_opts, itnlim, *, segment_iters,
                      checkpoint_path, resume_from, on_segment, carry_cls,
                      dtype):
    opts_key = tuple(sorted(static_opts.items()))
    carry = (load_state(resume_from, dtype=dtype, carry_cls=carry_cls)
             if resume_from else None)
    seg = 0
    while True:
        start = int(carry.itn) if carry is not None else 0
        stop_at = min(start + segment_iters, itnlim)
        carry = _segment_generic(
            build, opts_key, args, carry, jnp.asarray(stop_at, jnp.int32)
        )
        seg += 1
        if checkpoint_path:
            save_state(checkpoint_path, jax.device_get(carry))
        if on_segment is not None:
            on_segment(seg, carry)
        if int(carry.istop) != 0 or int(carry.itn) >= itnlim:
            break
        if int(carry.itn) == start:
            break
    return _finalize_generic(build, opts_key, args, carry)


def _sibling_setup(A, b, m, n, dtype=None):
    A = as_operator(A, m=m, n=n)
    b = jnp.asarray(b)
    if dtype is None:
        dtype = (b.dtype if jnp.issubdtype(b.dtype, jnp.inexact) else None)
    if dtype is None:
        from ..config import default_dtype

        dtype = default_dtype()
    return A, b.astype(dtype), dtype


def lsmr_checkpointed(
    A, b, damp: float = 0.0, *, atol=1e-6, btol=1e-6, conlim=1e8,
    itnlim=None, segment_iters: int = 100,
    checkpoint_path: Optional[str] = None, resume_from: Optional[str] = None,
    on_segment: Optional[Callable] = None, safe_norms: bool = True,
    m: Optional[int] = None, n: Optional[int] = None,
):
    """Segmented/checkpointed LSMR (same runner as
    :func:`lsqr_checkpointed`; same defaults as :func:`lsqr_tpu.lsmr`)."""
    import importlib

    lsmr_mod = importlib.import_module("lsqr_tpu.lsmr")

    A, b, dtype = _sibling_setup(A, b, m, n)
    if itnlim is None:
        itnlim = min(int(A.m), int(A.n))
    rdt = jnp.zeros((), dtype).real.dtype
    args = (A, b, jnp.asarray(damp, rdt), jnp.asarray(atol, rdt),
            jnp.asarray(btol, rdt), jnp.asarray(conlim, rdt))
    so = dict(itnlim=int(itnlim), record_trace=False, safe_norms=safe_norms)
    return _run_checkpointed(
        lsmr_mod._build, args, so, int(itnlim),
        segment_iters=segment_iters, checkpoint_path=checkpoint_path,
        resume_from=resume_from, on_segment=on_segment,
        carry_cls=lsmr_mod._Carry, dtype=dtype,
    )


def cgls_checkpointed(
    A, b, damp: float = 0.0, *, atol=1e-6, btol=1e-6, itnlim=None,
    segment_iters: int = 100, checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None, on_segment: Optional[Callable] = None,
    safe_norms: bool = True, m: Optional[int] = None, n: Optional[int] = None,
):
    """Segmented/checkpointed CGLS."""
    import importlib

    cgls_mod = importlib.import_module("lsqr_tpu.cgls")

    A, b, dtype = _sibling_setup(A, b, m, n)
    if itnlim is None:
        itnlim = 4 * int(A.n)
    rdt = jnp.zeros((), dtype).real.dtype
    args = (A, b, jnp.asarray(damp, rdt), jnp.asarray(atol, rdt),
            jnp.asarray(btol, rdt))
    so = dict(itnlim=int(itnlim), safe_norms=safe_norms)
    return _run_checkpointed(
        cgls_mod._build, args, so, int(itnlim),
        segment_iters=segment_iters, checkpoint_path=checkpoint_path,
        resume_from=resume_from, on_segment=on_segment,
        carry_cls=cgls_mod._Carry, dtype=dtype,
    )


def craig_checkpointed(
    A, b, *, atol=1e-6, btol=1e-6, itnlim=None, segment_iters: int = 100,
    checkpoint_path: Optional[str] = None, resume_from: Optional[str] = None,
    on_segment: Optional[Callable] = None, safe_norms: bool = True,
    m: Optional[int] = None, n: Optional[int] = None,
):
    """Segmented/checkpointed CRAIG."""
    import importlib

    craig_mod = importlib.import_module("lsqr_tpu.craig")

    A, b, dtype = _sibling_setup(A, b, m, n)
    if itnlim is None:
        itnlim = min(int(A.m), int(A.n))
    args = (A, b, jnp.asarray(atol, dtype), jnp.asarray(btol, dtype))
    so = dict(itnlim=int(itnlim), safe_norms=safe_norms)
    return _run_checkpointed(
        craig_mod._build, args, so, int(itnlim),
        segment_iters=segment_iters, checkpoint_path=checkpoint_path,
        resume_from=resume_from, on_segment=on_segment,
        carry_cls=craig_mod._Carry, dtype=dtype,
    )
