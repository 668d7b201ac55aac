"""Configuration layer of lsqr_tpu.

This is the analogue of the reference's L0 config layer (``lsqr_kinds``,
/root/reference/src/lsqr_kinds.F90:8-31): it selects the working precision and
holds the solver tolerances/knobs that the reference passes as (optional)
arguments (lsqr.f90:481-519 and the EZ-class defaults at lsqr.f90:46-51).

Reference semantics preserved:

* ``atol``/``btol``/``conlim`` equal to zero mean "machine precision"
  (lsqr.f90:509-512) — the solver's built-in ``1 + t <= 1`` guards give the
  same effect without substitution, so zeros are passed through untouched.
* ``itnlim`` default follows the docstring suggestion of ``4*n``
  (lsqr.f90:513-517) when left as ``None``; the EZ class defaults to 100
  (lsqr.f90:50) to match the reference class default.

Additions with no reference analogue:

* dtype policy: float32 is the fast path; float64 (via
  ``jax.config.update('jax_enable_x64', True)``, native on the GPU) is the
  precision for ill-conditioned problems and reproduces the reference's
  real64 iteration counts. The reference's optional real128 build
  (lsqr_kinds.F90:19-21) has no accelerator equivalent; x64 + safe_norms
  is the maximum-robustness configuration here.
* :func:`kernel_route` decides, in one place, whether a hand-written kernel
  runs and by which route.
* ``safe_norms`` selects the overflow-safe scaled two-pass 2-norm (the
  functional replacement for the reference's sequential scale/ssq ``dnrm2``,
  lsqrblas.f90:123-159).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = [
    "LSQROptions",
    "kernel_route",
    "default_dtype",
    "enable_x64",
    "eps_for",
]


def kernel_route(
    request: Optional[bool] = None,
    *,
    interpret: bool = False,
    platform: Optional[str] = None,
) -> Optional[str]:
    """The one place that decides how a hand-written kernel runs.

    Returns ``"triton"`` (compile the Pallas kernel for the GPU through
    Triton), ``"interpret"`` (run it in the Pallas interpreter) or ``None``
    (no kernel: the caller uses its plain XLA form).

    ``request`` is ``None`` for auto routing, ``True`` when a caller asks
    for the kernel and ``False`` when it refuses it. ``interpret=True`` is
    for tests only: it selects the interpreter on any platform. Without it,
    auto routing picks the kernel only on a GPU, and a kernel request on a
    platform with no kernel route raises instead of falling back silently.
    ``platform`` defaults to ``jax.default_backend()``.
    """
    if request is False:
        return None
    if interpret:
        return "interpret"
    platform = platform or jax.default_backend()
    if platform in ("gpu", "cuda"):
        return "triton"
    if request:
        raise ValueError(
            f"no kernel route on platform {platform!r}: the hand-written "
            "kernels compile for NVIDIA GPUs only (tests pass interpret=True)"
        )
    return None


def enable_x64(enable: bool = True) -> None:
    """Enable float64 mode (the conformance-precision analogue of the
    reference's ``-DREAL64`` build flag, lsqr_kinds.F90:16-24).

    float64 runs natively on the GPU, at about half the float32 rate for
    products that stream memory. Use it for ill-conditioned problems and
    for reproducing the reference's double-precision iteration counts.
    """
    jax.config.update("jax_enable_x64", enable)


def default_dtype() -> jnp.dtype:
    """The working precision `wp` equivalent: f64 when x64 is on, else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def eps_for(dtype) -> float:
    """Machine precision (`relpr` in the reference docs, lsqr.f90:353-356)."""
    return float(jnp.finfo(jnp.dtype(dtype)).eps)


@dataclasses.dataclass(frozen=True)
class LSQROptions:
    """Solver options. Mirrors the reference's LSQR arguments
    (lsqr.f90:481-519) plus accelerator-specific knobs.

    Attributes:
      atol: relative error estimate for A (0 => machine precision).
      btol: relative error estimate for b (0 => machine precision).
      conlim: upper limit on cond(Abar); 0 => 1/eps effectively.
      itnlim: max iterations; None => 4*n (docstring suggestion,
        lsqr.f90:513-517).
      wantse: compute standard-error estimates se (lsqr.f90:451-460).
      nconv: number of consecutive iterations the convergence criteria must
        hold (reference hardcodes nconv=1, lsqr.f90:846).
      record_trace: record the per-iteration log columns in a device-side
        buffer (the functional replacement for the `nout` iteration log,
        lsqr.f90:813-837). Shape is (itnlim+1, 11).
      safe_norms: use the overflow-safe scaled 2-norm like dnrm2
        (lsqrblas.f90:123-159); if False use the plain sqrt(sum(x^2)).
      debug_log: emit a live jax.debug.print line per logged iteration
        (throttled like the reference, lsqr.f90:815-822).
      dtype: working dtype; None => f64 if x64 enabled else f32.
    """

    atol: float = 0.0
    btol: float = 0.0
    conlim: float = 0.0
    itnlim: Optional[int] = None
    wantse: bool = False
    nconv: int = 1
    record_trace: bool = False
    safe_norms: bool = True
    debug_log: bool = False
    dtype: Optional[jnp.dtype] = None
    #: loop form: "while" (single lax.while_loop, the default) or
    #: "bounded" (host-stepped fixed-size fori segments, which can stop and
    #: resume between segments).
    loop: str = "while"
    #: segment length for the bounded loop form
    loop_segment: int = 64
    #: fuse each bidiagonalization half-step (product + axpy + norm),
    #: keeping u/v unnormalized in the carry. Never selected automatically
    #: (None acts as False, except that pair=None then stays auto). Fused
    #: norms are plain (unscaled) sums of squares.
    fused: Optional[bool] = None
    #: fuse BOTH products of each bidiagonalization step (u_new = A v -
    #: alpha u and z = A' u_new, lsqr.f90:681-694) into ONE streaming pass
    #: over the operator data (ops/triton_pair.dia_pair_triton) — the
    #: stripes are read once per iteration instead of twice, halving the
    #: dominant memory traffic. Implies the fused (unnormalized-carry) form. None = auto
    #: from the operator's prefers_pair property; False disables.
    pair: Optional[bool] = None
    #: optional WIDER dtype for the scalar recurrence only (e.g. "float64"
    #: with f32 vectors): the mixed-precision robustness mode —
    #: vectors stream at f32 speed while the O(1)-per-iteration rotations
    #: and running norm estimates accumulate in f64 (requires x64 enabled).
    #: None = scalars in the vector dtype (reference behavior).
    scalar_dtype: Optional[str] = None

    def resolve_itnlim(self, n: int) -> int:
        return int(self.itnlim) if self.itnlim is not None else 4 * int(n)

    def replace(self, **kw) -> "LSQROptions":
        return dataclasses.replace(self, **kw)
