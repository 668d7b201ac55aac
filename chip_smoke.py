"""Smoke run of lsqr_tpu on one NVIDIA GPU, through the public entry points.

    python chip_smoke.py              # every one-card phase, on one card
    python chip_smoke.py --mesh 4     # only the four-card mesh phase

Each phase prints one JSON object: what it compared with which reference,
at which tolerance and precision, and the times it took on the card, with
the card's name and power limit. The last line is the contract's result,
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed. Any failure raises, so the exit code is non-zero and no result
line appears. The script refuses to run on anything but a GPU.

Phases (each a function of its sizes; the tests call them at tiny sizes on
the CPU):

  banded_f32   the main path at full width: a 2^23-row, 11-diagonal f32
               banded matrix through ``auto_operator`` and ``lsqr``,
               against a known ``x_true`` and float64 numpy products
  pair         the Triton pair kernel against the XLA products (the
               band, a ragged m and the widest halo it is routed at), and
               lsqr ms/iteration of separate XLA products against the
               Triton pair, measured in turns
  general_f32  an unstructured Zipf(1.1) matrix through ``auto_operator``
               against scipy's lsqr on the host
  complex64    a complex banded matrix (ZDIA) against a known ``x_true``
  dense_f32    ``DenseOperator`` against float64 numpy ``lstsq``: catches
               float32 products that run in TF32
  suite_f64    the 18 Paige-Saunders problems in float64, held to the
               criteria of tests/test_suite.py
  mesh         (``--mesh 4`` only) ``lsqr_sharded_dia`` on four cards
               against a one-card ``lsqr`` of the same problem
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BANDED_M = 1 << 23
BANDED_HALF = 5          # offsets -5..5: 11 diagonals
DIAG_SHIFT = 12.0        # makes the random banded matrix well conditioned


def card_info() -> str:
    """Name and power limit of the first card, read by ``nvidia-smi`` in a
    child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


# --------------------------------------------------------------------------
# helpers: references in float64 numpy, timing with block_until_ready
# --------------------------------------------------------------------------


def banded_stripes(m, half, seed, shift=DIAG_SHIFT, dtype=np.float32):
    """Random row-aligned stripes ``(2*half+1, m)`` for offsets -half..half,
    with ``shift`` added to the main diagonal and out-of-matrix entries
    zeroed (square m x m)."""
    rng = np.random.default_rng(seed)
    offs = tuple(range(-half, half + 1))
    st = rng.standard_normal((len(offs), m), dtype=np.float32)
    st[half] += shift
    i = np.arange(m)
    for d, k in enumerate(offs):
        st[d, (i + k < 0) | (i + k >= m)] = 0
    return offs, st.astype(dtype)


def dia_apply(stripes, offs, x, n):
    """float64 ``A @ x`` from row-aligned stripes."""
    m = stripes.shape[1]
    y = np.zeros(m, np.result_type(stripes.dtype, x.dtype, np.float64))
    for d, k in enumerate(offs):
        lo, hi = max(0, -k), min(m, n - k)
        y[lo:hi] += stripes[d, lo:hi] * x[lo + k:hi + k]
    return y


def dia_apply_t(stripes, offs, y, n):
    """float64 ``A^H @ y`` from row-aligned stripes."""
    m = stripes.shape[1]
    z = np.zeros(n, np.result_type(stripes.dtype, y.dtype, np.float64))
    for d, k in enumerate(offs):
        lo, hi = max(0, -k), min(m, n - k)
        z[lo + k:hi + k] += np.conj(stripes[d, lo:hi]) * y[lo:hi]
    return z


def rel_err(a, ref):
    a = np.asarray(a, np.complex128 if np.iscomplexobj(a) else np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-300))


def rel_max_err(a, ref):
    a = np.asarray(a, np.complex128 if np.iscomplexobj(a) else np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))


def check(name, value, tol):
    if not value <= tol:
        raise AssertionError(f"{name} = {value!r} exceeds tolerance {tol!r}")


def timed(fn, reps=1):
    """(compile-and-first-run seconds, median warm seconds, last result)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return first, float(np.median(warm)) if warm else first, out


def peak_bytes(device=None):
    import jax

    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _coo_from_stripes(stripes, offs, n):
    m = stripes.shape[1]
    rows = np.tile(np.arange(m, dtype=np.int64), len(offs))
    cols = (rows.reshape(len(offs), m)
            + np.asarray(offs, np.int64)[:, None]).ravel()
    ok = (cols >= 0) & (cols < n)
    return stripes.ravel()[ok], rows[ok], cols[ok]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_banded_f32(m=BANDED_M, half=BANDED_HALF, seed=0):
    import jax
    import jax.numpy as jnp

    import lsqr_tpu as lt

    tol_x, tol_prod = 1e-4, 1e-5
    offs, st = banded_stripes(m, half, seed)
    rng = np.random.default_rng(seed + 1)
    x_true = rng.standard_normal(m)
    b64 = dia_apply(st, offs, x_true, m)

    t0 = time.perf_counter()
    vals, rows, cols = _coo_from_stripes(st, offs, m)
    A = lt.auto_operator(m, m, vals, rows, cols)
    jax.block_until_ready(A)
    setup_s = time.perf_counter() - t0
    del vals, rows, cols

    prod_errs = []
    for _ in range(2):
        v = rng.standard_normal(m)
        prod_errs.append(rel_max_err(
            A.matvec(jnp.asarray(v, jnp.float32)), dia_apply(st, offs, v, m)))
        prod_errs.append(rel_max_err(
            A.rmatvec(jnp.asarray(v, jnp.float32)), dia_apply_t(st, offs, v, m)))
    b = jnp.asarray(b64, jnp.float32)
    kw = dict(atol=1e-6, btol=1e-6)
    first, warm, res = timed(lambda: lt.lsqr(A, b, 0.0, **kw), reps=3)
    itn = int(res.itn)
    err_x = rel_err(res.x, x_true)
    xc = lt.xcheck(A, b=b, x=res.x, anorm=res.anorm)
    for i, e in enumerate(prod_errs):
        check(f"product {i} rel max err", e, tol_prod)
    check("rel err of x", err_x, tol_x)
    if int(xc.inform) not in (1, 2, 3):
        raise AssertionError(f"xcheck inform {int(xc.inform)}")
    return dict(
        entry="auto_operator", operator=type(A).__name__, m=m, n=m,
        ndiag=len(offs), precision="float32", damp=0.0, atol=1e-6, btol=1e-6,
        istop=int(res.istop), itn=itn,
        ms_per_iter=1e3 * warm / max(itn, 1),
        solve_compile_s=first - warm, host_setup_s=setup_s,
        rel_err_x=err_x, tol_x=tol_x,
        product_rel_max_err=max(prod_errs), tol_products=tol_prod,
        reference="x_true, float64 numpy stripe products",
        xcheck_inform=int(xc.inform), xcheck_test1=float(xc.test1),
        peak_bytes_in_use=peak_bytes(),
    )


def phase_pair(m=BANDED_M, ragged=BANDED_M - 4099, half=BANDED_HALF, seed=2,
               itnlim=100, turns=2, interpret=False):
    import jax
    import jax.numpy as jnp

    import lsqr_tpu as lt
    from lsqr_tpu.ops.structured import dia_shared_operator
    from lsqr_tpu.ops.triton_pair import PAIR_MAX_HALO, dia_pair_triton

    tol = 1e-5
    checks = []
    # the band at two sizes and both storages, then a 2-D five-point
    # stencil pattern at the widest halo the auto route sends to the kernel
    g = PAIR_MAX_HALO
    cases = [(size, storage, None) for size in (m, ragged)
             for storage in (None, "bfloat16")]
    cases.append((m, None, (-g, -1, 0, 1, g)))
    for size, storage, stencil in cases:
        offs, st = banded_stripes(size, half, seed, shift=0.0)
        if stencil is not None:
            rows = [half + max(-half, min(half, k)) for k in stencil]
            offs, st = stencil, st[rows]
            i = np.arange(size)
            for d, k in enumerate(offs):
                st[d, (i + k < 0) | (i + k >= size)] = 0
        rng = np.random.default_rng(seed + size)
        win = jnp.asarray(rng.standard_normal(size), jnp.float32)
        y = jnp.asarray(rng.standard_normal(size), jnp.float32)
        A = dia_shared_operator(size, size, offs, st, storage_dtype=storage)
        u, z = dia_pair_triton(A.dp, win, y, 0.75, 1.25, offsets=offs,
                               m=size, n=size, H=A.H, interpret=interpret)
        ur = A.matvec(win * 0.75) - 1.25 * y
        zr = A.rmatvec(ur)
        eu, ez = rel_max_err(u, np.asarray(ur)), rel_max_err(z, np.asarray(zr))
        label = f"m={size} {storage or 'float32'} offsets={offs}"
        check(f"pair u {label}", eu, tol)
        check(f"pair z {label}", ez, tol)
        checks.append(dict(m=size, storage=storage or "float32",
                           offsets=list(offs), u_rel_max_err=eu,
                           z_rel_max_err=ez))

    offs, st = banded_stripes(m, half, seed, shift=0.0)
    b = jnp.ones((m,), jnp.float32)
    kw = dict(atol=0.0, btol=0.0, conlim=0.0, itnlim=itnlim)
    timings = {}
    for storage in (None, "bfloat16"):
        A = dia_shared_operator(m, m, offs, st, storage_dtype=storage)
        variants = {
            "separate_xla": lambda: lt.lsqr(A, b, 0.01, pair=False, **kw),
            "triton_pair": lambda: lt.lsqr(A, b, 0.01, pair=True, **kw),
        }
        if interpret:  # the CPU has no Triton route; the kernel is checked above
            variants.pop("triton_pair")
        runs = {k: [] for k in variants}
        itns = {}
        compile_s = {}
        for k, fn in variants.items():
            first, _, res = timed(fn, reps=0)
            compile_s[k] = first
            itns[k] = int(res.itn)
        order = list(variants) + list(variants)[::-1]
        for _ in range(turns):
            for k in order:
                t0 = time.perf_counter()
                res = jax.block_until_ready(variants[k]())
                runs[k].append((time.perf_counter() - t0) / int(res.itn))
        timings[storage or "float32"] = {
            k: dict(ms_per_iter=1e3 * float(np.median(v)),
                    ms_per_iter_runs=[1e3 * t for t in v], itn=itns[k],
                    first_call_s=compile_s[k])
            for k, v in runs.items()
        }
    return dict(
        reference="XLA products of the same operator (float32 accumulation)",
        tol_rel_max_err=tol, precision="float32 accumulate",
        kernel_checks=checks, lsqr_m=m, lsqr_itnlim=itnlim, lsqr_damp=0.01,
        lsqr_ms_per_iter=timings, peak_bytes_in_use=peak_bytes(),
    )


def zipf_matrix(m, n, nnz_per_row, seed, a=1.1):
    """Unstructured f32 triplets: uniform rows, Zipf(a) columns."""
    rng = np.random.default_rng(seed)
    nnz = m * nnz_per_row
    cols = np.empty(0, np.int64)
    while cols.size < nnz:
        c = rng.zipf(a, size=2 * nnz) - 1
        cols = np.concatenate([cols, c[c < n]])
    cols = cols[:nnz]
    rows = np.repeat(np.arange(m, dtype=np.int64), nnz_per_row)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return vals, rows, cols


def phase_general_f32(m=1 << 20, n=65536, nnz_per_row=16, seed=3,
                      itnlim=1000):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    import lsqr_tpu as lt

    vals, rows, cols = zipf_matrix(m, n, nnz_per_row, seed)
    b = np.random.default_rng(seed + 1).standard_normal(m).astype(np.float32)
    t0 = time.perf_counter()
    A = lt.auto_operator(m, n, vals, rows, cols)
    jax.block_until_ready(A)
    pack_s = time.perf_counter() - t0
    kw = dict(atol=1e-6, btol=1e-6)
    bj = jnp.asarray(b)
    first, warm, res = timed(
        lambda: lt.lsqr(A, bj, 0.0, itnlim=itnlim, **kw), reps=1)

    S = sp.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=(m, n))
    b64 = b.astype(np.float64)
    ref = spla.lsqr(S, b64, iter_lim=itnlim, **kw)
    atb = np.linalg.norm(S.T @ b64)

    def measures(x):
        r = b64 - S @ np.asarray(x, np.float64)
        return (np.linalg.norm(r) / np.linalg.norm(b64),
                np.linalg.norm(S.T @ r) / atb)

    rr, ar = measures(res.x)
    rr_ref, ar_ref = measures(ref[0])
    # the least-squares residual is unique and its norm is flat near the
    # optimum, so it agrees closely (1.5e-5 to 1.7e-5 in eleven runs on an
    # H100 at the full size). After 1000 float32 iterations ||A'r|| sits in
    # a band of rounding noise that moves from run to run (the products'
    # atomic sums reorder): 5.4x to 11.9x scipy's float64 value in ten of
    # those runs, so it is held to 30x
    tol_rr, tol_ar = 1e-4, 30.0
    check("relative residual difference", abs(rr - rr_ref) / rr_ref, tol_rr)
    check("||A'r|| / reference ||A'r||", ar / max(ar_ref, 1e-12), tol_ar)
    return dict(
        entry="auto_operator", operator=type(A).__name__, m=m, n=n,
        nnz=int(vals.size), columns="Zipf(1.1)", precision="float32",
        reference="scipy.sparse.linalg.lsqr, float64, host, same "
                  "atol/btol/itnlim",
        atol=1e-6, btol=1e-6, itnlim=itnlim,
        itn=int(res.itn), istop=int(res.istop),
        itn_reference=int(ref[2]), istop_reference=int(ref[1]),
        rel_residual=rr, rel_residual_reference=rr_ref,
        rel_atr=ar, rel_atr_reference=ar_ref,
        tol_rel_residual_diff=tol_rr, tol_atr_ratio=tol_ar,
        host_pack_s=pack_s, solve_compile_s=first - warm,
        setup_s=pack_s + first - warm,
        ms_per_iter=1e3 * warm / max(int(res.itn), 1),
        peak_bytes_in_use=peak_bytes(),
    )


def phase_complex64(m=1 << 21, half=2, seed=4):
    import jax
    import jax.numpy as jnp

    import lsqr_tpu as lt

    offs, re = banded_stripes(m, half, seed, shift=8.0)
    _, im = banded_stripes(m, half, seed + 1, shift=0.0)
    st = (re + 1j * im).astype(np.complex64)
    rng = np.random.default_rng(seed + 2)
    x_true = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    b = jnp.asarray(dia_apply(st, offs, x_true, m), jnp.complex64)
    vals, rows, cols = _coo_from_stripes(st, offs, m)
    t0 = time.perf_counter()
    A = lt.auto_operator(m, m, vals, rows, cols)
    jax.block_until_ready(A)
    pack_s = time.perf_counter() - t0
    first, warm, res = timed(
        lambda: lt.lsqr(A, b, 0.0, atol=1e-6, btol=1e-6), reps=1)
    err = rel_err(res.x, x_true)
    tol = 1e-4
    check("complex rel err of x", err, tol)
    return dict(
        entry="auto_operator", operator=type(A).__name__, m=m, n=m,
        ndiag=len(offs), precision="complex64", reference="x_true",
        itn=int(res.itn), rel_err_x=err, tol_x=tol,
        ms_per_iter=1e3 * warm / max(int(res.itn), 1),
        host_pack_s=pack_s, solve_compile_s=first - warm,
        peak_bytes_in_use=peak_bytes(),
    )


def phase_dense_f32(m=8192, n=4096, seed=5):
    import jax.numpy as jnp

    import lsqr_tpu as lt

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    x_ref = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                            rcond=None)[0]
    A = lt.DenseOperator(jnp.asarray(a))
    first, warm, res = timed(
        lambda: lt.lsqr(A, jnp.asarray(b), 0.0, atol=1e-7, btol=1e-7,
                        itnlim=500), reps=1)
    err = rel_err(res.x, x_ref)
    # float32 products leave ~1e-6; TF32 products (10-bit mantissa) leave
    # ~1e-3, so this tolerance fails if a product fell back to TF32
    tol = 1e-4
    check("dense rel err of x vs lstsq", err, tol)
    return dict(
        entry="DenseOperator", m=m, n=n, precision="float32, HIGHEST",
        reference="numpy float64 lstsq", itn=int(res.itn), rel_err_x=err,
        tol_x=tol, ms_per_iter=1e3 * warm / max(int(res.itn), 1),
        solve_compile_s=first - warm, peak_bytes_in_use=peak_bytes(),
    )


def phase_suite_f64():
    import jax

    import lsqr_tpu as lt
    from lsqr_tpu.models.paige_saunders import check_suite_problem, suite_configs

    jax.config.update("jax_enable_x64", True)
    rows = []
    failures = []
    t0 = time.perf_counter()
    for m, n, nduplc, npower, damp in suite_configs():
        problems = check_suite_problem(m, n, nduplc, npower, damp)
        rows.append(dict(m=m, n=n, npower=npower, **problems["summary"]))
        failures += [f"P({m},{n},{npower}): {f}" for f in problems["failures"]]
    if failures:
        raise AssertionError("; ".join(failures))
    return dict(
        problems=len(rows), precision="float64",
        criteria="tests/test_suite.py: istop 3, bnorm/xnorm/rnorm to 1e-4 "
                 "of the listing, acond within 2x, xcheck, rel err <= 1e-3 "
                 "(two documented failures <= 0.2); on a GPU itn in [80% "
                 "of the CPU pin, pin + 3] and anorm within 15% of the "
                 "listing (the count moves between processes there)",
        results=rows, seconds=time.perf_counter() - t0,
        platform=jax.devices()[0].platform, solver_version=lt.__version__,
    )


def phase_mesh(ndev=4, m=BANDED_M, half=BANDED_HALF, seed=0):
    import jax
    import jax.numpy as jnp

    import lsqr_tpu as lt
    from lsqr_tpu.parallel import lsqr_sharded_dia, make_mesh

    devices = jax.devices()
    if len(devices) < ndev:
        raise RuntimeError(f"--mesh {ndev} needs {ndev} devices, "
                           f"found {len(devices)}")
    offs, st = banded_stripes(m, half, seed)
    x_true = np.random.default_rng(seed + 1).standard_normal(m)
    b = jnp.asarray(dia_apply(st, offs, x_true, m), jnp.float32)
    A = lt.dia_shared_operator(m, m, offs, st)
    kw = dict(atol=1e-6, btol=1e-6)
    first1, warm1, one = timed(lambda: lt.lsqr(A, b, 0.0, **kw), reps=1)
    mesh = make_mesh(ndev)
    firstn, warmn, many = timed(
        lambda: lsqr_sharded_dia(A, b, 0.0, mesh=mesh, **kw), reps=1)
    dx = rel_err(many.x, np.asarray(one.x, np.float64))
    err = rel_err(many.x, x_true)
    tol = 1e-5
    if int(many.itn) != int(one.itn):
        raise AssertionError(f"itn {int(many.itn)} on {ndev} devices, "
                             f"{int(one.itn)} on one")
    check("sharded vs one-device x", dx, tol)
    return dict(
        entry="lsqr_sharded_dia", devices=ndev, m=m, ndiag=len(offs),
        precision="float32", reference="one-device lsqr of the same problem",
        itn=int(many.itn), itn_one_device=int(one.itn),
        rel_diff_x=dx, tol_rel_diff_x=tol, rel_err_x_true=err,
        ms_per_iter=1e3 * warmn / max(int(many.itn), 1),
        ms_per_iter_one_device=1e3 * warm1 / max(int(one.itn), 1),
        peak_bytes_in_use=[peak_bytes(d) for d in devices[:ndev]],
    )


ONE_CARD_PHASES = {
    "banded_f32": phase_banded_f32,
    "pair": phase_pair,
    "general_f32": phase_general_f32,
    "complex64": phase_complex64,
    "dense_f32": phase_dense_f32,
    "suite_f64": phase_suite_f64,   # last: it turns on float64 mode
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="run only the N-card mesh phase")
    parser.add_argument("--phases", default=",".join(ONE_CARD_PHASES),
                        help="comma-separated one-card phases to run")
    args = parser.parse_args(argv)

    import jax

    from lsqr_tpu.utils.compile_cache import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{dev.platform!r} ({dev.device_kind})")
    use_compile_cache(ROOT)
    card = card_info()
    print(json.dumps({"card": card, "device_kind": dev.device_kind,
                      "devices": len(jax.devices()),
                      "jax": jax.__version__}), flush=True)
    if args.mesh:
        phases = {"mesh": lambda: phase_mesh(args.mesh)}
    else:
        names = [p for p in args.phases.split(",") if p]
        unknown = set(names) - set(ONE_CARD_PHASES)
        if unknown:
            parser.error(f"unknown phases {sorted(unknown)}")
        phases = {p: ONE_CARD_PHASES[p] for p in names}
    for name, fn in phases.items():
        t0 = time.perf_counter()
        out = fn()
        print(json.dumps({"phase": name, "ok": True, "card": card,
                          "phase_s": time.perf_counter() - t0, **out}),
              flush=True)
    print(json.dumps({"card": card, "phases_passed": len(phases)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
