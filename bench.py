"""Throughput of the LSQR hot products and ms/iteration of the solve on one
NVIDIA GPU, against a serial-CPU CSR implementation of the same products
(the stand-in for the reference's serial Fortran COO loops,
/root/reference/src/lsqr.f90:168-172, 188-192 — the reference publishes no
throughput numbers of its own, SURVEY.md §6).

    python bench.py

One process. It names the device and the card's power limit, refuses to
run without a GPU, and prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Gnnz/s", "vs_baseline": N, ...}

Matrix: banded (11 diagonals), m = n = 2^23 = 8,388,608 => 92.3M nnz, f32.
Stages:
  roofline     plain jnp copy of 1 GiB (read + write), GB/s
  shared_pair  the solver step's product pair on the shared-stripe layout
               (the Triton pair kernel on the GPU)
  separate     separate XLA matvec + rmatvec (two stripe passes)
  xla_bf16     separate XLA products with bf16 stripe storage
  zipf         general sparsity through auto_operator: 10.5M-nnz Zipf(1.1)
               columns, n = 2048, one matvec + rmatvec
  zipf_wide    the same mass at n = 65,536
  zdia         complex-banded ZDIA pair (5 diagonals, m = 2^21)
  solve        lsqr ms/iteration on the auto-routed banded operator
  solve_bf16   lsqr ms/iteration with bf16 stripe storage
  cpu          scipy CSR products on the host (min of 3)

Product stages time ``iters`` data-dependent calls chained inside one jit
(``fori_loop``), ended by ``block_until_ready``. Throughput counts two
products per pair over the stored nnz. Designing benchmark cells and
per-layer metrics is ROADMAP S1's work; this script keeps the stages the
repository had, on the paths that survive.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
M = 8_388_608  # 2^23
NDIAG = 11
OFFSETS = tuple(range(-(NDIAG // 2), NDIAG // 2 + 1))

ZIPF_M = 1 << 21
ZIPF_N = 2048
ZIPF_WIDE_N = 65536
ZIPF_NNZ = 10 * (1 << 20)

ZDIA_M = 1 << 21
ZDIA_ND = 5
ZDIA_OFFS = tuple(range(-(ZDIA_ND // 2), ZDIA_ND // 2 + 1))

ROOF_ELEMS = 1 << 28
ITERS = 20


def _time_chain(step, operand, v0, iters=ITERS):
    """Seconds per call of ``step(operand, v)`` over ``iters`` dependent
    calls inside one jit (compile and warm-up excluded)."""
    import jax

    @jax.jit
    def run(operand, v):
        return jax.lax.fori_loop(0, iters, lambda i, v: step(operand, v), v)

    jax.block_until_ready(run(operand, v0))
    t0 = time.perf_counter()
    jax.block_until_ready(run(operand, v0))
    return (time.perf_counter() - t0) / iters


def _stripes(m, nd=NDIAG, seed=0):
    import jax
    import jax.numpy as jnp

    return jax.random.normal(jax.random.PRNGKey(seed), (nd, m), jnp.float32)


def bench_roofline():
    import jax.numpy as jnp

    x = jnp.ones((ROOF_ELEMS,), jnp.float32)
    dt = _time_chain(lambda _, v: v * 1.0000001, None, x)
    return 2 * x.nbytes / dt / 1e9


def bench_shared_pair(m=M):
    import jax.numpy as jnp

    import lsqr_tpu as lt

    A = lt.dia_shared_operator(m, m, OFFSETS, _stripes(m))
    y0 = jnp.zeros((m,), jnp.float32)

    def step(A, v):
        u, z = A.fused_pair(y=y0, win=v, c1=1.0, c2=0.0)
        return z * 1e-9

    return _time_chain(step, A, jnp.ones((m,), jnp.float32))


def bench_separate(m=M, storage_dtype=None):
    import jax.numpy as jnp

    from lsqr_tpu.ops.structured import dia_operator_device

    A = dia_operator_device(m, m, OFFSETS, _stripes(m),
                            storage_dtype=storage_dtype)
    return _time_chain(lambda A, x: A.rmatvec(A.matvec(x)) * 1e-9, A,
                       jnp.ones((m,), jnp.float32))


def _zipf_operator(n):
    import numpy as np

    import lsqr_tpu as lt

    rng = np.random.default_rng(0)
    cz = rng.zipf(1.1, size=3 * ZIPF_NNZ) - 1
    cz = cz[cz < n][:ZIPF_NNZ].astype(np.int64)
    rows = np.sort(rng.integers(0, ZIPF_M, cz.size).astype(np.int64))
    vals = rng.standard_normal(cz.size).astype(np.float32)
    return lt.auto_operator(ZIPF_M, n, vals, rows, cz), cz.size


def bench_zipf(n=ZIPF_N):
    import jax.numpy as jnp

    A, nnz = _zipf_operator(n)
    dt = _time_chain(lambda A, x: A.rmatvec(A.matvec(x)) * 1e-9, A,
                     jnp.ones((n,), jnp.float32))
    return dt, nnz, type(A).__name__


def bench_zdia():
    import jax
    import jax.numpy as jnp

    from lsqr_tpu.ops.zdia import zdia_operator_device

    m = ZDIA_M
    dr = _stripes(m, ZDIA_ND, seed=0)
    di = _stripes(m, ZDIA_ND, seed=1)
    A = zdia_operator_device(m, m, ZDIA_OFFS, jax.lax.complex(dr, di))
    y0 = jnp.zeros((m,), jnp.complex64)

    def step(A, v):
        u, z = A.fused_pair(y=y0, win=v, c1=1.0, c2=0.0)
        return z * 1e-9

    return _time_chain(step, A, jnp.full((m,), 1 + 0.5j, jnp.complex64))


def bench_solve(m=M, storage_dtype=None, itn=64):
    """lsqr ms/iteration through the public path: ``dia_shared_operator``
    (what ``auto_operator`` returns for f32 banded input) and ``lsqr``,
    damped, a fixed ``itn`` iterations (zero tolerances)."""
    import jax
    import jax.numpy as jnp

    import lsqr_tpu as lt

    A = lt.dia_shared_operator(m, m, OFFSETS, _stripes(m),
                               storage_dtype=storage_dtype)
    b = jnp.ones((m,), jnp.float32)
    kw = dict(itnlim=itn, atol=0.0, btol=0.0, conlim=0.0)
    jax.block_until_ready(lt.lsqr(A, b, 0.01, **kw))  # compile + warm
    t0 = time.perf_counter()
    res = jax.block_until_ready(lt.lsqr(A, b, 0.01, **kw))
    return (time.perf_counter() - t0) / int(res.itn)


def bench_cpu_serial(iters=4, reps=3):
    """scipy CSR products on the host CPU (min of ``reps``)."""
    import numpy as np
    import scipy.sparse

    rng = np.random.default_rng(0)
    data = rng.standard_normal((NDIAG, M)).astype(np.float32)
    S = scipy.sparse.dia_matrix((data, list(OFFSETS)), shape=(M, M)).tocsr()
    St = S.T.tocsr()
    x = np.ones(M, np.float32)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = S @ x
            x = (St @ y) * np.float32(1e-9)
        best = min(best, (time.perf_counter() - t0) / iters)
    return 2 * S.nnz / best / 1e9


def main(argv=None) -> int:
    import jax

    from lsqr_tpu.utils.compile_cache import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r} "
                         f"({dev.device_kind})")
    use_compile_cache(ROOT)
    from chip_smoke import card_info

    card = card_info()

    def gnnz(nnz_per_product, dt):
        return round(2 * nnz_per_product / dt / 1e9, 2)

    banded_nnz = NDIAG * M
    roofline = bench_roofline()
    shared = gnnz(banded_nnz, bench_shared_pair())
    separate = gnnz(banded_nnz, bench_separate())
    xla_bf16 = gnnz(banded_nnz, bench_separate(storage_dtype="bfloat16"))
    dt, nnz, zipf_op = bench_zipf(ZIPF_N)
    zipf = gnnz(nnz, dt)
    dt, nnz, zipf_wide_op = bench_zipf(ZIPF_WIDE_N)
    zipf_wide = gnnz(nnz, dt)
    zdia = gnnz(ZDIA_ND * ZDIA_M, bench_zdia())
    solve = bench_solve()
    solve_bf16 = bench_solve(storage_dtype="bfloat16")
    cpu = bench_cpu_serial()

    best = max(shared, separate)
    # byte model of one pair: stripes read once + win, y read + u, z written
    pair_gbs = best * 1e9 / (2 * NDIAG) * (NDIAG + 4) * 4 / 1e9
    print(json.dumps({
        "metric": f"spmv_pair_throughput_banded_{banded_nnz // 10**6}Mnnz_f32",
        "value": best,
        "unit": "Gnnz/s",
        "vs_baseline": round(best / cpu, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "roofline_copy_gbs": round(roofline, 1),
        "pair_pct_copy_roofline": round(100 * pair_gbs / roofline, 1),
        "shared_pair_gnnz": shared,
        "separate_gnnz": separate,
        "xla_bf16_storage_gnnz": xla_bf16,
        "zipf_gnnz": zipf,
        "zipf_operator": zipf_op,
        "zipf_wide_gnnz": zipf_wide,
        "zipf_wide_operator": zipf_wide_op,
        "zdia_pair_gnnz": zdia,
        "solve_ms_iter": round(solve * 1e3, 4),
        "solve_bf16_ms_iter": round(solve_bf16 * 1e3, 4),
        "cpu_baseline_gnnz": round(cpu, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
