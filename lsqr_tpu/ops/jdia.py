"""JDIA — jittered-diagonal storage for near-banded general sparsity.

The format stores entries that deviate by a bounded amount from a
diagonal:

    A[i, i + d[tile, j] + e[i, j]]   with |e| <= 32

Each row tile gets up to ``ns`` slots; a slot is a tile-local diagonal
offset ``d`` plus per-row jitter ``e`` (int8). Entries that fit no slot
spill into a small COO remainder applied with segment_sum. This covers the
structured-general class — banded matrices with irregular within-band
patterns, locally-clustered graphs, anything a bandwidth-reducing
(RCM-style) reordering can localize — at streaming speed, and degrades
gracefully (remainder fraction -> 1) on patterns with no locality at all,
where a general-sparse format takes over. The products are XLA gathers
of the packed form. Whether JDIA beats plain COO or CSR on the GPU is
unmeasured (ROADMAP S5).

Reference anchor: this replaces the serial COO scatter loops
(/root/reference/src/lsqr.f90:168-172, 188-192) for general inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .linop import LinearOperator

__all__ = ["JDIAOperator", "jdia_operator", "jdia_pack"]

JITTER = 32          # |e| budget
DEFAULT_TM = 8192    # rows per tile (multiple of 1024)


def _pack_side(rows, cols, vals, m, n, *, ns_max, tm, win_budget,
               dtype=np.float32):
    """Pack one orientation (A or A'). Returns (data, eoff, base, P_lo, win,
    m_pad, remainder_index_mask). base is per-(slot, tile) window starts in
    the kernel's contract: s = d - JITTER + P_lo (window-relative)."""
    nnz = len(vals)
    m_pad = max(-(-m // tm), 1) * tm
    nt = m_pad // tm
    # asarray, not astype: the fixpoint calls this on already-int64
    # arrays and astype always copies (measured 5s of the pack)
    deltas = np.asarray(cols, np.int64) - np.asarray(rows, np.int64)
    tile_of = rows // tm

    # hot loop: native C++ assigner when available (numpy form costs ~74 s
    # at 11M nnz — per-tile sorts through the interpreter; see
    # native/sparse_pack.cpp lsqr_jdia_assign, bit-identical greedy choices)
    from ..native import jdia_assign

    native = jdia_assign(rows, deltas, np.asarray(vals, dtype), m_pad, tm,
                         ns_max, JITTER)
    if native is not None:
        assign_slot, slot_d, slot_used, data_full, eoff_full = native
        return _finish_native(assign_slot, slot_d, slot_used, data_full,
                              eoff_full, ns_max=ns_max, tm=tm,
                              win_budget=win_budget, m_pad=m_pad, nt=nt)

    slot_d = np.zeros((nt, ns_max), np.int64)
    slot_used = np.zeros(nt, np.int32)
    assign_slot = np.full(nnz, -1, np.int32)

    order = np.argsort(tile_of, kind="stable")
    bounds = np.searchsorted(tile_of[order], np.arange(nt + 1))
    for t in range(nt):
        idx = order[bounds[t]:bounds[t + 1]]
        if idx.size == 0:
            continue
        d_t = deltas[idx]
        r_t = rows[idx]
        unassigned = np.ones(idx.size, bool)
        for s in range(ns_max):
            live = np.nonzero(unassigned)[0]
            if live.size == 0:
                break
            ds = np.sort(d_t[live])
            # best window [c - J, c + J]: sliding count over sorted deltas
            hi = np.searchsorted(ds, ds + 2 * JITTER, side="right")
            best = int(np.argmax(hi - np.arange(ds.size)))
            d_lo = ds[best]
            center = d_lo + JITTER
            cand = live[(d_t[live] >= center - JITTER)
                        & (d_t[live] <= center + JITTER)]
            if cand.size == 0:
                break
            # one entry per row per slot: keep first per row
            rr = r_t[cand]
            first = np.zeros(cand.size, bool)
            _, first_idx = np.unique(rr, return_index=True)
            first[first_idx] = True
            take = cand[first]
            assign_slot[idx[take]] = s
            slot_d[t, s] = center
            slot_used[t] = s + 1
            unassigned[take] = False

    return _finish_pack(rows, deltas, vals, m, n, assign_slot, slot_d,
                        slot_used, ns_max=ns_max, tm=tm,
                        win_budget=win_budget, m_pad=m_pad, nt=nt,
                        dtype=dtype)


def _finish_native(assign_slot, slot_d, slot_used, data_full, eoff_full, *,
                   ns_max, tm, win_budget, m_pad, nt):
    """Geometry + trimming tail for the native-filled packing (the slot
    arrays arrive already scattered; only the window math and the
    (ns, nt) base table remain)."""
    nnz = len(assign_slot)
    used_mask = (np.arange(ns_max)[None, :] < slot_used[:, None])
    d_used = np.where(used_mask, slot_d, 0)
    d_min = int(d_used.min()) if nnz else 0
    d_max = int(d_used.max()) if nnz else 0
    P_lo = max(0, -(d_min - JITTER))
    win = P_lo + d_max - JITTER + tm + 2048
    win = -(-win // 1024) * 1024
    if win * 4 > win_budget:
        raise ValueError(
            f"JDIA padded-x window {win} floats exceeds budget; matrix "
            "bandwidth too large for this tiling"
        )
    ns = max(int(slot_used.max()) if nnz else 0, 1)
    data = np.ascontiguousarray(data_full[:ns])
    eoff = np.ascontiguousarray(eoff_full[:ns])
    ns_p = -(-ns // 8) * 8
    nt_p = -(-nt // 128) * 128
    base = np.zeros((ns_p, nt_p), np.int32)
    base[:ns, :nt] = (P_lo + slot_d[:, :ns].T - JITTER).astype(np.int32)
    fitted = assign_slot >= 0
    return data, eoff, base, P_lo, int(win), m_pad, fitted


def _finish_pack(rows, deltas, vals, m, n, assign_slot, slot_d, slot_used, *,
                 ns_max, tm, win_budget, m_pad, nt, dtype):
    """Vectorized tail of the packing: window geometry + slot-array fill
    (shared by the native and numpy assignment paths)."""
    nnz = len(vals)
    tile_of = rows // tm
    # window geometry: global padded x with P_lo front margin
    used_mask = (np.arange(ns_max)[None, :] < slot_used[:, None])
    d_used = np.where(used_mask, slot_d, 0)
    d_min = int(d_used.min()) if nnz else 0
    d_max = int(d_used.max()) if nnz else 0
    P_lo = max(0, -(d_min - JITTER))
    # the kernel DMAs each slot's window x[t*tm + base .. + tm + 2048);
    # win is the padded-x coverage needed past each tile start
    win = P_lo + d_max - JITTER + tm + 2048
    win = -(-win // 1024) * 1024
    if win * 4 > win_budget:
        raise ValueError(
            f"JDIA padded-x window {win} floats exceeds budget; matrix "
            "bandwidth too large for this tiling"
        )

    fitted = assign_slot >= 0
    ns = max(int(slot_used.max()) if nnz else 0, 1)
    data = np.zeros((ns, m_pad), dtype)
    eoff = np.zeros((ns, m_pad), np.int8)
    f_idx = np.nonzero(fitted)[0]
    s_f = assign_slot[f_idx]
    r_f = rows[f_idx]
    t_f = tile_of[f_idx]
    e_f = deltas[f_idx] - slot_d[t_f, s_f]
    assert np.all(np.abs(e_f) <= JITTER)
    data[s_f, r_f] = vals[f_idx]
    eoff[s_f, r_f] = e_f.astype(np.int8)

    ns_p = -(-ns // 8) * 8
    nt_p = -(-nt // 128) * 128
    base = np.zeros((ns_p, nt_p), np.int32)
    base[:ns, :nt] = (P_lo + slot_d[:, :ns].T - JITTER).astype(np.int32)
    return data, eoff, base, P_lo, int(win), m_pad, fitted


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JDIAOperator(LinearOperator):
    """General sparse m x n operator in jittered-diagonal storage (+ COO
    remainder), with a precomputed transpose packing so SpMV-T streams the
    same way (no scatters — same layout answer as DIA/ELL)."""

    # forward packing
    data: jax.Array     # (ns, m_pad) f32 slot values
    eoff: jax.Array     # (ns, m_pad) int8 jitter
    base: jax.Array     # (ns_p, nt_p) int32 window starts
    # transpose packing
    tdata: jax.Array
    teoff: jax.Array
    tbase: jax.Array
    # COO remainder (possibly empty, padded to >=1)
    rem_vals: jax.Array
    rem_rows: jax.Array
    rem_cols: jax.Array
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    p_lo: int = dataclasses.field(metadata=dict(static=True))
    win: int = dataclasses.field(metadata=dict(static=True))
    tp_lo: int = dataclasses.field(metadata=dict(static=True))
    twin: int = dataclasses.field(metadata=dict(static=True))
    tm: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def fit_fraction(self) -> float:
        rem = int(self.rem_vals.shape[0])
        return 1.0 - rem / max(self.nnz, 1)

    def _xpad(self, x, p_lo, win, m_out):
        m_pad = -(-m_out // self.tm) * self.tm
        nt = m_pad // self.tm
        length = max((nt - 1) * self.tm + win, p_lo + x.shape[0])
        length = -(-length // 1024) * 1024
        xp = jnp.zeros((length,), x.dtype)
        return xp.at[p_lo:p_lo + x.shape[0]].set(x)

    def _product(self, data, eoff, base, x, p_lo, win, m_out):
        xp = self._xpad(x, p_lo, win, m_out)
        return _jdia_matvec_xla(data, eoff, base, xp, m_out, self.tm)

    def matvec(self, x: jax.Array) -> jax.Array:
        y = self._product(self.data, self.eoff, self.base, x,
                          self.p_lo, self.win, self.m)
        if self.rem_vals.shape[0]:
            y = y + jax.ops.segment_sum(
                self.rem_vals * x[self.rem_cols], self.rem_rows,
                num_segments=self.m,
            )
        return y

    def rmatvec(self, y: jax.Array) -> jax.Array:
        x = self._product(self.tdata, self.teoff, self.tbase, y,
                          self.tp_lo, self.twin, self.n)
        if self.rem_vals.shape[0]:
            x = x + jax.ops.segment_sum(
                self.rem_vals * y[self.rem_rows], self.rem_cols,
                num_segments=self.n,
            )
        return x

    def todense(self) -> jax.Array:
        out = np.zeros((self.m, self.n), np.float64)
        _accum_dense(out, np.asarray(self.data), np.asarray(self.eoff),
                     np.asarray(self.base), self.p_lo, self.tm)
        rv = np.asarray(self.rem_vals)
        if rv.shape[0]:
            np.add.at(out, (np.asarray(self.rem_rows),
                            np.asarray(self.rem_cols)), rv)
        return jnp.asarray(out.astype(np.asarray(self.data).dtype))


def _accum_dense(out, data, eoff, base, p_lo, tm):
    m, n = out.shape
    ns, m_pad = data.shape
    for s in range(ns):
        rows = np.nonzero(data[s, :m])[0]
        for i in rows:
            t = i // tm
            d = int(base[s, t]) + JITTER - p_lo
            c = i + d + int(eoff[s, i])
            if 0 <= c < n:
                out[i, c] += data[s, i]


def _jdia_matvec_xla(data, eoff, base, xp, m_out, tm):
    """XLA oracle/fallback: gather formulation of the packed product."""
    ns, m_pad = data.shape
    rows = jnp.arange(m_pad)
    tiles = rows // tm
    d = base[:ns, tiles] + JITTER  # (ns, m_pad) window-start + J = P_lo + d
    cols = rows[None, :] + d + eoff.astype(jnp.int32)  # index into xp
    y = jnp.sum(data * xp[cols], axis=0)
    return y[:m_out]


def jdia_pack(m, n, vals, rows, cols, *, ns_max=16, tm=DEFAULT_TM,
              win_budget=16 * 1024 * 1024, dtype=np.float32):
    """Pack COO triplets into JDIA (+ transpose packing + remainder).

    Returns a dict of arrays (see JDIAOperator fields)."""
    dtype = np.dtype(dtype)
    vals = np.asarray(vals, dtype)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)

    # An entry must stream in BOTH orientations (matvec needs the forward
    # packing, rmatvec the transpose packing) or live in the shared COO
    # remainder — one remainder set keeps the two products transpose-
    # consistent. Iterate packing both sides on the shrinking fitted set
    # until a fixpoint (greedy window choices can shift on a subset, so a
    # single intersection is not guaranteed stable).
    fit = np.ones(len(vals), bool)
    for _ in range(8):
        sub = np.nonzero(fit)[0]
        data, eoff, base, p_lo, win, _, ok_f = _pack_side(
            rows[sub], cols[sub], vals[sub], m, n,
            ns_max=ns_max, tm=tm, win_budget=win_budget, dtype=dtype,
        )
        tdata, teoff, tbase, tp_lo, twin, _, ok_t = _pack_side(
            cols[sub], rows[sub], vals[sub], n, m,
            ns_max=ns_max, tm=tm, win_budget=win_budget, dtype=dtype,
        )
        ok = ok_f & ok_t
        if ok.all():
            break
        fit[sub[~ok]] = False
    else:
        raise RuntimeError("jdia_pack failed to reach a packing fixpoint")
    rem = ~fit
    return dict(
        data=data, eoff=eoff, base=base,
        tdata=tdata, teoff=teoff, tbase=tbase,
        rem_vals=vals[rem], rem_rows=rows[rem].astype(np.int32),
        rem_cols=cols[rem].astype(np.int32),
        p_lo=p_lo, win=win, tp_lo=tp_lo, twin=twin, tm=tm,
    )


def jdia_operator(m, n, vals, rows, cols, *, ns_max=16, tm=DEFAULT_TM,
                  dtype=None) -> JDIAOperator:
    """Build a JDIAOperator from COO triplets (duplicates must be summed
    beforehand; ops.coo.coo_operator / native.coo_dedup handle that).

    ``dtype`` defaults to float32; float64 packings are supported for x64
    mode."""
    if dtype is None:
        v = np.asarray(vals)
        dtype = v.dtype if v.dtype == np.float64 else np.float32
    p = jdia_pack(m, n, vals, rows, cols, ns_max=ns_max, tm=tm, dtype=dtype)
    return JDIAOperator(
        data=jnp.asarray(p["data"]),
        eoff=jnp.asarray(p["eoff"]),
        base=jnp.asarray(p["base"]),
        tdata=jnp.asarray(p["tdata"]),
        teoff=jnp.asarray(p["teoff"]),
        tbase=jnp.asarray(p["tbase"]),
        rem_vals=jnp.asarray(p["rem_vals"]),
        rem_rows=jnp.asarray(p["rem_rows"]),
        rem_cols=jnp.asarray(p["rem_cols"]),
        m=int(m),
        n=int(n),
        p_lo=int(p["p_lo"]),
        win=int(p["win"]),
        tp_lo=int(p["tp_lo"]),
        twin=int(p["twin"]),
        tm=int(tm),
        nnz=len(np.asarray(vals)),
    )
