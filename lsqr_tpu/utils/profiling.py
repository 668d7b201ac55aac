"""Profiling hooks.

The reference has no profiling (SURVEY.md §5); on the GPU the native
tooling is the XLA profiler. These are thin conveniences around
``jax.profiler`` plus a simple wall-clock product-rate meter whose
methodology is safe on asynchronous backends (times K data-dependent
products inside one jit and synchronizes via a host fetch).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import jax
import jax.numpy as jnp

__all__ = ["trace", "product_rate"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture an XLA profiler trace (view with TensorBoard or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def product_rate(A, *, iters: int = 50, pair: bool = True) -> dict:
    """Measure the SpMV(+SpMV-T) rate of an operator.

    Returns {"seconds_per_product", "gnnz_per_s" (if the operator exposes
    nnz), "iters"}; ``pair=True`` measures matvec+rmatvec per iteration
    (the LSQR inner-loop cost), else matvec only (square operators only).
    """
    n = A.n
    dtype = getattr(A, "dtype", jnp.float32)

    @jax.jit
    def run(x):
        def body(i, x):
            y = A.matvec(x)
            z = A.rmatvec(y) if pair else y
            # cheap O(1)-per-element rescale keeps the chain data-dependent
            # without overflow; a max-reduction here would add a third full
            # pass per iteration and inflate the measured product cost
            return z * jnp.asarray(1e-3, z.dtype)
        return jax.lax.fori_loop(0, iters, body, x)

    if not pair and A.m != A.n:
        raise ValueError("pair=False requires a square operator")
    x0 = jnp.ones((n,), dtype)
    out = run(x0)
    float(jnp.sum(out))  # warm-up + sync
    t0 = time.perf_counter()
    out = run(x0)
    float(jnp.sum(out))
    dt = (time.perf_counter() - t0) / iters
    result = {"seconds_per_product": dt, "iters": iters}
    nnz = getattr(A, "nnz", None)
    if nnz:
        scale = 2 if pair else 1
        result["gnnz_per_s"] = scale * nnz / dt / 1e9
    return result
