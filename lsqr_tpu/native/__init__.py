"""Native host-runtime bindings (ctypes over lsqr_tpu/native/sparse_pack.cpp).

Compiled lazily with the system C++ toolchain on first use and cached next
to the source; every entry point has a pure-numpy fallback so the framework
works (slower) without a compiler. See sparse_pack.cpp for what lives here
and why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

__all__ = [
    "available",
    "ell_pack",
    "csr_from_coo",
    "block_pack",
    "coo_dedup",
    "jdia_assign",
]

_LIB = None
_LIB_LOCK = threading.Lock()
_SRC = os.path.join(os.path.dirname(__file__), "sparse_pack.cpp")


def _user_cache_dir() -> str:
    """Per-user cache dir with 0700 perms (never the shared temp dir: a
    predictable world-writable path invites another user pre-planting a
    malicious .so that gets dlopen'd — advisor finding, ADVICE.md round 1)."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    path = os.path.join(base, "lsqr_tpu")
    os.makedirs(path, mode=0o700, exist_ok=True)
    st = os.stat(path)
    if st.st_uid != os.getuid() or (st.st_mode & 0o022):
        raise RuntimeError(f"refusing unsafe native build dir {path}")
    return path


def _build_lib() -> str:
    """Compile the shared library next to the source, or — if the package
    directory is read-only — into a per-user 0700 cache directory (ownership
    and permissions verified before the library is ever dlopen'd)."""
    candidates = [os.path.dirname(_SRC)]
    try:
        candidates.append(_user_cache_dir())
    except (OSError, RuntimeError):
        # last resort: a fresh private directory (unique per process; no
        # pre-plant or concurrent-build race is possible on a new mkdtemp)
        candidates.append(tempfile.mkdtemp(prefix="lsqr_tpu_native_"))
    for target_dir in candidates:
        so_path = os.path.join(target_dir, "libsparse_pack.so")
        if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(_SRC):
            return so_path
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 "-o", so_path, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
            return so_path
        except (OSError, subprocess.SubprocessError):
            continue
    raise RuntimeError("could not build native sparse_pack library")


def _lib():
    global _LIB
    if _LIB is False:
        return None
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                try:
                    _LIB = ctypes.CDLL(_build_lib())
                    _declare(_LIB)
                except Exception:
                    _LIB = False
                    return None
    return _LIB or None


def _declare(lib):
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32

    lib.lsqr_row_counts.restype = i64
    lib.lsqr_row_counts.argtypes = [i32p, i64, i32, i64p]
    for sfx, fp in (("f32", f32p), ("f64", f64p)):
        fn = getattr(lib, f"lsqr_ell_pack_{sfx}")
        fn.restype = None
        fn.argtypes = [i32p, i32p, fp, i64, i32, i64, fp, i32p, i64p]
        fn = getattr(lib, f"lsqr_csr_from_coo_{sfx}")
        fn.restype = None
        fn.argtypes = [i32p, i32p, fp, i64, i32, i64p, i32p, fp]
        fn = getattr(lib, f"lsqr_block_pack_{sfx}")
        fn.restype = None
        fn.argtypes = [i32p, i32p, fp, i64, i32, i32, i32, i64, i64, fp, i32p]
        fn = getattr(lib, f"lsqr_coo_dedup_{sfx}")
        fn.restype = i64
        fn.argtypes = [i32p, i32p, fp, i64]
    lib.lsqr_block_count.restype = i64
    lib.lsqr_block_count.argtypes = [i32p, i32p, i64, i32, i32, i32, i64, i64p]
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    for sfx, fp in (("f32", f32p), ("f64", f64p)):
        fn = getattr(lib, f"lsqr_jdia_assign_{sfx}")
        fn.restype = None
        fn.argtypes = [
            i64p, i64p, fp, i64, i64, i32, i32, i32, i32p, i64p, i32p,
            fp, i8p,
        ]


def available() -> bool:
    """True if the compiled native library is usable."""
    return _lib() is not None


def _prep(rows, cols, vals):
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals)
    if vals.dtype not in (np.float32, np.float64):
        vals = vals.astype(np.float64)
    sfx = "f32" if vals.dtype == np.float32 else "f64"
    return rows, cols, vals, sfx


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------


def ell_pack(rows, cols, vals, m):
    """COO -> ELL (m, k). Returns (vals2d, cols2d)."""
    rows, cols, vals, sfx = _prep(rows, cols, vals)
    nnz = len(rows)
    lib = _lib()
    if lib is None:
        return _ell_pack_np(rows, cols, vals, m)
    counts = np.zeros(m, np.int64)
    k = max(int(lib.lsqr_row_counts(rows, nnz, m, counts)), 1)
    out_vals = np.zeros((m, k), vals.dtype)
    out_cols = np.zeros((m, k), np.int32)
    fill = np.zeros(m, np.int64)
    getattr(lib, f"lsqr_ell_pack_{sfx}")(
        rows, cols, vals, nnz, m, k, out_vals, out_cols, fill
    )
    return out_vals, out_cols


def _ell_pack_np(rows, cols, vals, m):
    counts = np.bincount(rows, minlength=m)
    k = max(int(counts.max()) if counts.size else 0, 1)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    pos = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(len(rows_s)) - pos[rows_s]
    out_vals = np.zeros((m, k), vals.dtype)
    out_cols = np.zeros((m, k), np.int32)
    out_vals[rows_s, within] = vals_s
    out_cols[rows_s, within] = cols_s
    return out_vals, out_cols


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


def csr_from_coo(rows, cols, vals, m):
    """COO -> CSR. Returns (indptr int64 (m+1,), cols int32, vals)."""
    rows, cols, vals, sfx = _prep(rows, cols, vals)
    nnz = len(rows)
    lib = _lib()
    if lib is None:
        order = np.argsort(rows, kind="stable")
        indptr = np.zeros(m + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, cols[order], vals[order]
    indptr = np.zeros(m + 1, np.int64)
    out_cols = np.empty(nnz, np.int32)
    out_vals = np.empty(nnz, vals.dtype)
    getattr(lib, f"lsqr_csr_from_coo_{sfx}")(
        rows, cols, vals, nnz, m, indptr, out_cols, out_vals
    )
    return indptr, out_cols, out_vals


# ---------------------------------------------------------------------------
# Blocked-ELL
# ---------------------------------------------------------------------------


def block_pack(rows, cols, vals, mb, bh, bw, stride, max_fill_ratio=64.0):
    """COO -> blocked-ELL. Returns (blocks (mb, kb, bh, bw), bcols (mb, kb)).

    Raises if the blocked representation would store more than
    ``max_fill_ratio`` times nnz values — a sparsity pattern that blocky
    storage cannot serve (use ELL or COO instead)."""
    rows, cols, vals, sfx = _prep(rows, cols, vals)
    nnz = len(rows)
    lib = _lib()
    if lib is None:
        uniq_ids = np.unique((rows // bh).astype(np.int64) * stride + cols // bw)
        per_row = np.bincount((uniq_ids // stride).astype(np.int64), minlength=mb)
        kb = max(int(per_row.max()) if per_row.size else 0, 1)
    else:
        counts = np.zeros(mb, np.int64)
        kb = max(
            int(lib.lsqr_block_count(rows, cols, nnz, bh, bw, mb, stride, counts)),
            1,
        )
    stored = float(mb) * kb * bh * bw
    if nnz and stored > max_fill_ratio * nnz:
        raise ValueError(
            f"block_pack would store {stored/nnz:.0f}x nnz ({stored:.3g} "
            f"values for {nnz} nonzeros) — the sparsity pattern is not "
            f"blocky at block ({bh}, {bw}); use the ELL or COO operator"
        )
    if lib is None:
        return _block_pack_np(rows, cols, vals, mb, bh, bw, stride)
    blocks = np.zeros((mb, kb, bh, bw), vals.dtype)
    bcols = np.zeros((mb, kb), np.int32)
    getattr(lib, f"lsqr_block_pack_{sfx}")(
        rows, cols, vals, nnz, bh, bw, mb, stride, kb, blocks, bcols
    )
    return blocks, bcols


def _block_pack_np(rows, cols, vals, mb, bh, bw, stride):
    br = rows // bh
    bc = cols // bw
    ids = br.astype(np.int64) * stride + bc
    uniq, inv = np.unique(ids, return_inverse=True)
    ubr = (uniq // stride).astype(np.int64)
    ubc = (uniq % stride).astype(np.int64)
    counts = np.bincount(ubr, minlength=mb)
    kb = max(int(counts.max()) if counts.size else 0, 1)
    blocks = np.zeros((mb, kb, bh, bw), vals.dtype)
    bcols = np.zeros((mb, kb), np.int32)
    slot_of = np.zeros(len(uniq), np.int64)
    next_slot = np.zeros(mb, np.int64)
    for u in range(len(uniq)):
        r = ubr[u]
        slot_of[u] = next_slot[r]
        bcols[r, next_slot[r]] = ubc[u]
        next_slot[r] += 1
    np.add.at(
        blocks, (ubr[inv], slot_of[inv], rows - br * bh, cols - bc * bw), vals
    )
    return blocks, bcols


# ---------------------------------------------------------------------------
# Dedup
# ---------------------------------------------------------------------------


def coo_dedup(rows, cols, vals):
    """Sort by (row, col) and sum duplicates. Returns (rows, cols, vals)."""
    rows, cols, vals, sfx = _prep(rows, cols, vals)
    nnz = len(rows)
    lib = _lib()
    if lib is None or nnz == 0:
        order = np.lexsort((cols, rows))
        rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
        if nnz == 0:
            return rows_s, cols_s, vals_s
        new = np.concatenate(
            [[True], (np.diff(rows_s) != 0) | (np.diff(cols_s) != 0)]
        )
        group = np.cumsum(new) - 1
        out_vals = np.zeros(group[-1] + 1, vals.dtype)
        np.add.at(out_vals, group, vals_s)
        return rows_s[new], cols_s[new], out_vals
    rows = rows.copy()
    cols = cols.copy()
    vals = vals.copy()
    out = int(getattr(lib, f"lsqr_coo_dedup_{sfx}")(rows, cols, vals, nnz))
    return rows[:out], cols[:out], vals[:out]


# ---------------------------------------------------------------------------
# JDIA greedy slot assignment
# ---------------------------------------------------------------------------


def jdia_assign(rows, deltas, vals, m_pad, tm, ns_max, jitter):
    """Greedy jittered-diagonal slot assignment + slot-array fill (the hot
    loop and scatter tail of ops/jdia._pack_side). Returns (assign_slot
    (nnz,) int32 with -1 = unassigned, slot_d (nt, ns_max) int64 window
    centers, slot_used (nt,) int32, data (ns_max, m_pad), eoff (ns_max,
    m_pad) int8). None if the native library is unavailable (caller falls
    back to the numpy loop)."""
    lib = _lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    deltas = np.ascontiguousarray(deltas, np.int64)
    vals = np.ascontiguousarray(vals)
    if vals.dtype not in (np.float32, np.float64):
        vals = vals.astype(np.float64)
    sfx = "f32" if vals.dtype == np.float32 else "f64"
    nnz = len(rows)
    nt = m_pad // tm
    assign_slot = np.empty(nnz, np.int32)
    slot_d = np.empty(nt * ns_max, np.int64)
    slot_used = np.empty(nt, np.int32)
    data = np.zeros((ns_max, m_pad), vals.dtype)
    eoff = np.zeros((ns_max, m_pad), np.int8)
    getattr(lib, f"lsqr_jdia_assign_{sfx}")(
        rows, deltas, vals, np.int64(nnz), np.int64(m_pad), np.int32(tm),
        np.int32(ns_max), np.int32(jitter), assign_slot, slot_d, slot_used,
        data, eoff,
    )
    return assign_slot, slot_d.reshape(nt, ns_max), slot_used, data, eoff
