"""Run-to-run spread of two smoke checks on one GPU, behind their tolerances.

    python benchmarks/spread.py suite [--repeat 2] [--out FILE]
    python benchmarks/spread.py general [--repeat 5] [--out FILE]

``suite``: the 18 Paige-Saunders problems in float64, each solved
``--repeat`` times in this process. One JSON line per solve: ``itn``,
``anorm``, and the checks of ``check_suite_problem`` as the CPU holds them
(count pinned to ``MEASURED_ITN`` +-3). Run it in two processes, and again
with ``XLA_FLAGS=--xla_gpu_deterministic_ops=true``, to see whether the
counts move between processes.

``general``: the ``general_f32`` smoke problem (m = 2^20, n = 65,536, 16
Zipf(1.1) columns per row), packed once and solved ``--repeat`` times. One
JSON line per solve: the relative residual and ``||A'r||``, each against
scipy's float64 lsqr at the same tolerances and iteration limit.

Every line carries the card's name and power limit. Refuses to run without
a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_info, zipf_matrix  # noqa: E402


def suite(emit, repeat):
    import jax

    jax.config.update("jax_enable_x64", True)
    from lsqr_tpu.models.paige_saunders import check_suite_problem, suite_configs

    for rep in range(repeat):
        for m, n, nduplc, npower, damp in suite_configs():
            out = check_suite_problem(m, n, nduplc, npower, damp,
                                      platform="cpu")
            emit(stage="suite", rep=rep, m=m, n=n, npower=npower,
                 **out["summary"], cpu_criteria_failures=out["failures"])


def general(emit, repeat, m=1 << 20, n=65536, nnz_per_row=16, seed=3,
            itnlim=1000):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    import lsqr_tpu as lt

    vals, rows, cols = zipf_matrix(m, n, nnz_per_row, seed)
    b = np.random.default_rng(seed + 1).standard_normal(m).astype(np.float32)
    A = lt.auto_operator(m, n, vals, rows, cols)
    S = sp.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=(m, n))
    b64 = b.astype(np.float64)
    kw = dict(atol=1e-6, btol=1e-6)
    atb = np.linalg.norm(S.T @ b64)

    def measures(x):
        r = b64 - S @ np.asarray(x, np.float64)
        return (np.linalg.norm(r) / np.linalg.norm(b64),
                np.linalg.norm(S.T @ r) / atb)

    rr_ref, ar_ref = measures(spla.lsqr(S, b64, iter_lim=itnlim, **kw)[0])
    bj = jnp.asarray(b)
    for rep in range(repeat):
        res = jax.block_until_ready(lt.lsqr(A, bj, 0.0, itnlim=itnlim, **kw))
        rr, ar = measures(res.x)
        emit(stage="general", rep=rep, operator=type(A).__name__,
             itn=int(res.itn), rel_residual_diff=abs(rr - rr_ref) / rr_ref,
             atr_ratio=ar / max(ar_ref, 1e-12))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("stage", choices=("suite", "general"))
    parser.add_argument("--repeat", type=int, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import jax

    from lsqr_tpu.utils.compile_cache import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"spread.py needs a GPU; JAX found {dev.platform!r}")
    use_compile_cache(ROOT)
    card = card_info()
    out = open(args.out, "a") if args.out else None
    flags = os.environ.get("XLA_FLAGS", "")

    def emit(**kv):
        line = json.dumps({"card": card, "xla_flags": flags, **kv})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    if args.stage == "suite":
        suite(emit, args.repeat or 2)
    else:
        general(emit, args.repeat or 5)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
