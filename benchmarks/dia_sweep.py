"""Sweeps behind the banded (DIA) constants, run on one GPU.

    python benchmarks/dia_sweep.py [--m 8388608] [--out FILE]

Prints one JSON line per measurement (and appends them to ``--out`` when
given), each with the card's name and power limit:

* ``triton_tile``: the Triton pair kernel's time per call for each row tile
  and warp count, in f32 and bf16 stripe storage
  (``ops/triton_pair.PAIR_TILE`` / ``PAIR_WARPS``);
* ``halo``: the Triton pair against separate XLA products (with the
  solver's axpy) on 2-D five-point stencil patterns, offsets
  ``(-g, -1, 0, 1, g)`` at ``m = --halo-m`` rows, for each row tile the
  halo fits (``triton_pair.PAIR_MAX_HALO``);
* ``pair_threshold``: lsqr ms/iteration with separate XLA products against
  the Triton pair, on the shared layout, across sizes
  (``structured._PAIR_MIN_DIM``);
* ``copy``: a plain jnp copy of 1 GiB, the bandwidth the others are read
  against.

Times are per call, from a jitted ``fori_loop`` of ``--reps`` dependent
calls ended by ``block_until_ready``, median of three.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_info  # noqa: E402


STAGES = ("copy", "triton_tile", "halo", "pair_threshold")


def _median_time(fn, *args, reps):
    import jax

    jax.block_until_ready(fn(*args))   # compile + warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) / reps)
    return float(np.median(ts))


def pl_next_pow2(x):
    return 1 << max(int(x) - 1, 0).bit_length()


def _chain(step, reps):
    import jax

    @jax.jit
    def run(ops, v):
        return jax.lax.fori_loop(0, reps, lambda i, v: step(ops, v), v)

    return run


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--m", type=int, default=1 << 23)
    parser.add_argument("--halo-m", type=int, default=1 << 22,
                        help="rows of the halo stage (2^22: a 2048^2 grid)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=None)
    parser.add_argument("--stages", default=",".join(STAGES),
                        help="comma-separated subset of " + ",".join(STAGES))
    args = parser.parse_args(argv)
    stages = set(args.stages.split(","))

    import jax

    import jax.numpy as jnp

    import lsqr_tpu as lt
    from lsqr_tpu.ops.triton_pair import dia_pair_triton
    from lsqr_tpu.utils.compile_cache import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"dia_sweep.py needs a GPU; JAX found {dev.platform!r}")
    use_compile_cache(ROOT)
    card = card_info()
    out = open(args.out, "a") if args.out else None

    def emit(**kv):
        line = json.dumps({"card": card, "device_kind": dev.device_kind, **kv})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    m, reps = args.m, args.reps
    offs = tuple(range(-5, 6))
    key = jax.random.PRNGKey(0)
    data32 = jax.random.normal(key, (len(offs), m), jnp.float32)
    v32 = jnp.ones((m,), jnp.float32)

    # copy bandwidth: read + write 1 GiB
    if "copy" in stages:
        big = jnp.ones((1 << 28,), jnp.float32)
        t = _median_time(_chain(lambda ops, v: v * 1.0000001, reps), None,
                         big, reps=reps)
        emit(stage="copy", bytes=2 * big.nbytes, s_per_call=t,
             gb_per_s=2 * big.nbytes / t / 1e9)
        del big

    # Triton pair: row tile x warps
    for storage in ((None, "bfloat16") if "triton_tile" in stages else ()):
        A = lt.dia_shared_operator(m, m, offs, data32, storage_dtype=storage)
        for tile in (256, 512, 1024, 2048):
            for warps in (2, 4, 8, 16):
                def step(A, v, tile=tile, warps=warps):
                    u, z = dia_pair_triton(A.dp, v, v, 1.0, 0.5,
                                           offsets=offs, m=m, n=m, H=A.H,
                                           tile=tile, num_warps=warps)
                    return z * 1e-3
                try:
                    t = _median_time(_chain(step, reps), A, v32, reps=reps)
                except Exception as e:  # a refused configuration is a result
                    emit(stage="triton_tile", storage=storage or "float32",
                         tile=tile, warps=warps, error=repr(e)[:300])
                    continue
                emit(stage="triton_tile", storage=storage or "float32",
                     tile=tile, warps=warps, ms_per_call=1e3 * t,
                     stripe_gb_per_s=A.dp.nbytes / t / 1e9)
        del A

    # stencil halos: the kernel recomputes u on 2 * next_pow2(g) rows per
    # tile, the separate products read the stripes twice
    for g in ((2, 16, 64, 128, 256, 512, 1024, 2048)
              if "halo" in stages else ()):
        hm = args.halo_m
        ks = (-g, -1, 0, 1, g)
        A = lt.dia_shared_operator(hm, hm, ks, jax.random.normal(
            key, (len(ks), hm), jnp.float32) * 0.1)
        v = jnp.ones((hm,), jnp.float32)

        def separate(A, v):
            u = A.matvec(v * 1.0) - 0.5 * v
            return A.rmatvec(u) * 1e-3

        row = {"separate": 1e3 * _median_time(_chain(separate, reps), A, v,
                                              reps=reps)}
        for tile in (1024, 2048, 4096):
            if pl_next_pow2(g) > tile:
                continue

            def step(A, v, tile=tile):
                u, z = dia_pair_triton(A.dp, v, v, 1.0, 0.5, offsets=ks,
                                       m=hm, n=hm, H=A.H, tile=tile)
                return z * 1e-3

            row[f"triton_tile{tile}"] = 1e3 * _median_time(
                _chain(step, reps), A, v, reps=reps)
        emit(stage="halo", m=hm, offsets=list(ks), ms_per_pair=row)
        del A

    # lsqr ms/iteration: separate XLA products vs the Triton pair, by size
    for k in ((16, 17, 18, 20, 22) if "pair_threshold" in stages else ()):
        mm = 1 << k
        A = lt.dia_shared_operator(mm, mm, offs, data32[:, :mm])
        b = jnp.ones((mm,), jnp.float32)
        kw = dict(atol=0.0, btol=0.0, conlim=0.0, itnlim=200)
        row = {}
        for name, pair in (("separate", False), ("triton_pair", True)):
            res = jax.block_until_ready(lt.lsqr(A, b, 0.01, pair=pair, **kw))
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                res = jax.block_until_ready(lt.lsqr(A, b, 0.01, pair=pair, **kw))
                ts.append((time.perf_counter() - t0) / int(res.itn))
            row[name] = 1e3 * float(np.median(ts))
        emit(stage="pair_threshold", m=mm, ms_per_iter=row)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
