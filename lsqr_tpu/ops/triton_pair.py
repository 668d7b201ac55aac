"""Fused DIA product pair for the GPU, written in Pallas for the Triton route.

One bidiagonalization step needs both products of the same operator
(reference op sequence lsqr.f90:681-694):

    u = A (win * c1) - c2 * y        (length m)
    z = A' u                         (length n)

With the shared padded stripes of :class:`~lsqr_tpu.ops.structured.
DIASharedOperator` (``dp[d * Lp + H + i] = A[i, i + offsets[d]]``) both
products read the same stripe elements, ``z[j] = sum_d dp[d, H + j - k_d] *
u[j - k_d]``. XLA cannot fuse the two into one pass, because ``z`` on a row
tile needs ``u`` on the neighbouring ``H = max|k|`` rows of the tiles either
side. This kernel reads the stripes from device memory once for both:

* each program owns a power-of-two row tile ``[b*T, b*T + T)`` and computes
  ``u`` there, plus ``u`` on a halo of ``HB >= H`` rows each side
  (recomputed, 2*HB/T extra work) so that no program waits on another;
* it writes its ``u`` tile to the output and its halo rows to a small
  scratch output, waits on a block barrier, and reads ``u`` back at the
  per-diagonal shifts — from its own tile and halo only, never from a
  neighbour's tile, so the order in which blocks run does not matter;
* the second read of the stripes (at ``H + j - k_d``) hits the lines the
  first read just brought into the cache.

bf16 stripes are a storage format: the kernel accumulates in float32 and
returns float32, like the XLA products.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import kernel_route

__all__ = ["dia_pair_triton", "pair_fits", "PAIR_TILE", "PAIR_WARPS",
           "PAIR_MAX_HALO"]

#: row tile and warps per program (powers of two). Chosen on the card: see
#: PERF.md, "pair kernel".
PAIR_TILE = 1024
PAIR_WARPS = 8
#: widest halo (next_pow2(max|offset|) rows) at which the auto route takes
#: the kernel: each block recomputes ``u`` on 2 * halo extra rows, which
#: costs more than the second stripe pass it saves beyond this width. At
#: most PAIR_TILE. Measured on the card: see PERF.md, "halo sweep".
PAIR_MAX_HALO = 256


def _halo_rows(H):
    return pl.next_power_of_2(max(int(H), 1))


def pair_fits(nd, Lp, H):
    """Whether the kernel should serve a shared layout of ``nd`` stripes of
    ``Lp`` elements with halo ``H``: its 32-bit indices must cover the
    stripes, and the halo must be at most ``PAIR_MAX_HALO`` rows."""
    return nd * Lp < 2**31 and _halo_rows(H) <= PAIR_MAX_HALO


def _pair_kernel(offsets, H, HB, T, m, n, Lp, barrier,
                 cs_ref, dp_ref, x_ref, y_ref, u_ref, z_ref, halo_ref):
    b = pl.program_id(0)
    i0 = b * T
    c1 = cs_ref[0]
    c2 = cs_ref[1]

    def u_rows(rows):
        valid = (rows >= 0) & (rows < m)
        acc = jnp.zeros(rows.shape, jnp.float32)
        for d, k in enumerate(offsets):
            col = rows + k
            ok = valid & (col >= 0) & (col < n)
            a = plgpu.load(dp_ref.at[d * Lp + H + rows], mask=ok, other=0)
            xv = plgpu.load(x_ref.at[col], mask=ok, other=0)
            acc += a.astype(jnp.float32) * xv.astype(jnp.float32)
        yv = plgpu.load(y_ref.at[rows], mask=valid, other=0)
        return c1 * acc - c2 * yv.astype(jnp.float32)

    t = jnp.arange(T, dtype=jnp.int32)
    h = jnp.arange(HB, dtype=jnp.int32)
    rows = i0 + t
    u_main = u_rows(rows)
    plgpu.store(u_ref.at[rows], u_main.astype(u_ref.dtype), mask=rows < m)
    hbase = b * (2 * HB)
    plgpu.store(halo_ref.at[hbase + h], u_rows(i0 - HB + h))
    plgpu.store(halo_ref.at[hbase + HB + h], u_rows(i0 + T + h))
    if barrier:
        plgpu.debug_barrier()

    zvalid = rows < n
    z = jnp.zeros((T,), jnp.float32)
    for d, k in enumerate(offsets):
        src = rows - k            # u row feeding z[rows] through diagonal d
        local = t - k
        ok = zvalid & (src >= 0) & (src < m)
        in_tile = (local >= 0) & (local < T)
        um = plgpu.load(u_ref.at[src], mask=ok & in_tile, other=0)
        hidx = hbase + HB + jnp.where(local < 0, local, local - T)
        uh = plgpu.load(halo_ref.at[hidx], mask=ok & ~in_tile, other=0)
        a = plgpu.load(dp_ref.at[d * Lp + H + src], mask=ok, other=0)
        z += a.astype(jnp.float32) * (um.astype(jnp.float32) + uh)
    plgpu.store(z_ref.at[rows], z.astype(z_ref.dtype), mask=zvalid)


@functools.partial(
    jax.jit,
    static_argnames=("offsets", "m", "n", "H", "tile", "num_warps",
                     "interpret"),
)
def dia_pair_triton(dp, win, y, c1, c2, *, offsets, m, n, H,
                    tile=PAIR_TILE, num_warps=PAIR_WARPS, interpret=False):
    """(u, z) of the bidiagonalization pair from the FLAT shared stripes
    ``dp`` (``(nd * Lp,)``, see :func:`~lsqr_tpu.ops.structured.
    dia_shared_operator`). ``win`` has length n, ``y`` length m. Returns
    ``u`` (m,) and ``z`` (n,) in float32 (the accumulation dtype).

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    the CPU); otherwise it needs a GPU, and raises elsewhere."""
    route = kernel_route(True, interpret=interpret)
    ks = tuple(int(k) for k in offsets)
    nd = len(ks)
    Lp = dp.shape[0] // nd
    if dp.shape != (nd * Lp,) or Lp < 2 * H + max(m, n):
        raise ValueError(f"dp of shape {dp.shape} is not a shared layout "
                         f"for {nd} diagonals, m={m}, n={n}, H={H}")
    if H < max(abs(k) for k in ks):
        raise ValueError(f"halo H={H} is narrower than offsets {ks}")
    if nd * Lp >= 2**31:
        raise ValueError("shared stripes beyond 2**31 elements need 64-bit "
                         "indexing, which this kernel does not do")
    T = int(tile)
    if T & (T - 1) or T < 16:
        raise ValueError(f"tile must be a power of two >= 16, got {T}")
    HB = _halo_rows(H)
    if HB > T:
        raise ValueError(f"halo {H} exceeds the row tile {T}")
    nt = -(-max(m, n) // T)
    cs = jnp.stack([jnp.asarray(c1, jnp.float32).reshape(()),
                    jnp.asarray(c2, jnp.float32).reshape(())])
    kernel = functools.partial(
        _pair_kernel, ks, H, HB, T, m, n, Lp, route != "interpret"
    )
    u, z, _ = pl.pallas_call(
        kernel,
        grid=(nt,),
        out_shape=(
            jax.ShapeDtypeStruct((m,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((nt * 2 * HB,), jnp.float32),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=route == "interpret",
        backend="triton",
        name="dia_pair_triton",
    )(cs, dp, win, y)
    return u, z
