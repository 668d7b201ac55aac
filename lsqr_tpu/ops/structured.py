"""Structured sparse operators — storage layouts with regular products.

The reference's only sparse format is COO with a serial scatter loop
(the reference's src/lsqr.f90:156-194). These layouts make the products
dense, regular and fusable by XLA:

* DIA (diagonal/banded): each diagonal is a contiguous stripe; SpMV is a
  handful of shifted fused multiply-adds — one streaming pass at memory
  bandwidth, zero gathers/scatters. The natural format for banded systems
  (finite differences, splines, time-series regularization). The shared
  layout's solver step has a hand-written pair kernel for the GPU
  (ops/triton_pair.py).
* ELL (padded rows): fixed row width k; SpMV is one gather of x + a dense
  (m, k) multiply-reduce. The transpose product uses a precomputed ELL of
  A' (built once at construction) so that SpMV-T is also gather-based.
* Blocked-ELL (BSR-style): dense (bh, bw) blocks in ELL layout; products
  are batches of small dense matmuls.

All operators implement the LinearOperator protocol and are exact drop-ins
for COOOperator (equivalence-tested against it).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import kernel_route
from .linop import LinearOperator

__all__ = [
    "DIAOperator",
    "dia_operator_device",
    "dia_operator",
    "DIASharedOperator",
    "dia_shared_operator",
    "shared_geometry",
    "ELLOperator",
    "ell_operator",
    "hyb_operator",
    "BlockELLOperator",
    "block_ell_operator",
]


# ---------------------------------------------------------------------------
# DIA — diagonal storage
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIAOperator(LinearOperator):
    """Banded m x n matrix in diagonal storage.

    ``data[j, i] = A[i, i + offsets[j]]`` (row-aligned stripes, shape
    (ndiag, m); entries outside the matrix are zero). ``offsets`` are static
    so every shift is a compile-time constant slice — XLA fuses the whole
    matvec into a single streaming pass.
    """

    data: jax.Array    # (ndiag, m) — data[j, i] = A[i, i + offsets[j]]
    tdata: jax.Array   # (ndiag, n) — transpose stripes: A'[c, c - offsets[j]]
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    offsets: tuple = dataclasses.field(metadata=dict(static=True))  # (ndiag,)

    @property
    def dtype(self):
        # bf16 STORAGE computes and returns f32 (mixed-precision mode):
        # downstream (solver vectors, dtype resolution) sees float32
        if self.data.dtype == jnp.bfloat16:
            return jnp.dtype(jnp.float32)
        return self.data.dtype

    @property
    def nnz(self) -> int:
        # stored entries (incl. structural zeros at band edges)
        return self.data.shape[0] * self.m

    @property
    def toffsets(self) -> tuple:
        return tuple(-k for k in self.offsets)

    def fused_halfstep(self, *, forward: bool, y, win, c1, c2):
        """Bidiagonalization half-step for the solver's ``fused=True`` form:
          forward:  A  (win*c1) - c2*y   with y (m,), win (n,)
          adjoint:  A' (win*c1) - c2*y   with y (n,), win (m,)
        Returns (out, ssq(out)). Plain XLA: the product, the axpy and the
        sum of squares fuse into one streaming pass plus a reduction."""
        prod = self.matvec if forward else self.rmatvec
        out = prod(win * c1) - c2 * y
        return out, jnp.sum(jnp.square(out))

    def fused_pair(self, *, y, win, c1, c2):
        """Both products of the bidiagonalization step (reference op
        sequence lsqr.f90:681-694):
            u_new = A (win*c1) - c2*y,     z = A' u_new
        with y (m,), win (n,). Returns (u_new, z) — z unnormalized (the
        1/beta normalization commutes with A' and is applied by the
        caller). Two separate XLA products."""
        u = self.matvec(win * c1) - c2 * y
        return u, self.rmatvec(u)

    def matvec(self, x: jax.Array) -> jax.Array:
        return _dia_matvec_xla(self.data, x, self.offsets, self.m, self.n)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        # A' is itself a DIA matrix with negated offsets and shifted stripes
        # (precomputed as tdata) — SpMV-T is just another streaming SpMV;
        # no scatters (contrast the reference's column-scatter transpose,
        # lsqr.f90:188-192).
        return _dia_matvec_xla(self.tdata, y, self.toffsets, self.n, self.m)

    @property
    def is_bf16_storage(self) -> bool:
        return self.data.dtype == jnp.bfloat16

    def todense(self) -> jax.Array:
        return _dia_todense(self.data, self.offsets, self.m, self.n, self.dtype)


def _dia_todense(data, offsets, m, n, dtype):
    dense = jnp.zeros((m, n), dtype)
    i = jnp.arange(m)
    for j, k in enumerate(offsets):
        cols = i + k
        valid = (cols >= 0) & (cols < n)
        dense = dense.at[i, jnp.clip(cols, 0, n - 1)].add(
            jnp.where(valid, data[j], 0.0)
        )
    return dense


def _dia_matvec_xla(data, x, offsets, m, n):
    """Pure-XLA DIA SpMV: statically shifted slice + FMA per diagonal, which
    XLA fuses into one streaming pass. bf16 stripes accumulate in f32 (the
    convert fuses into the FMA — memory traffic stays bf16)."""
    ks = offsets or (0,)
    lo = max(0, -min(ks))                 # slice start lo + k >= 0
    hi = max(0, m + max(ks) - n)          # slice end lo + k + m fits
    acc_dt = jnp.float32 if data.dtype == jnp.bfloat16 else data.dtype
    xp = jnp.zeros((lo + n + hi,), x.dtype).at[lo : lo + n].set(x)
    y = jnp.zeros((m,), acc_dt)
    for j, k in enumerate(offsets):
        y = y + data[j].astype(acc_dt) * jax.lax.dynamic_slice(
            xp, (lo + k,), (m,)
        ).astype(acc_dt)
    return y


def dia_operator_device(
    m, n, offsets: Sequence[int], data: jax.Array, *, storage_dtype=None,
) -> DIAOperator:
    """Build a DIAOperator from stripes already resident on device, with the
    masking and transpose-stripe packing computed on device (jnp). Use this
    for large matrices: the stripes never cross to the host.

    ``storage_dtype='bfloat16'`` stores the stripes in bf16 (products still
    accumulate and return f32): matrix entries are rounded to 8-bit
    mantissa at pack time, halving the dominant stripe traffic — the
    mixed-precision mode for f32-tolerant problems.
    """
    offsets = tuple(int(k) for k in offsets)
    nd = len(offsets)
    if data.shape != (nd, m):
        raise ValueError(f"data must have shape ({nd}, {m}), got {data.shape}")
    i = jnp.arange(m)
    mask = jnp.stack([(i + k >= 0) & (i + k < n) for k in offsets])
    data = data * mask.astype(data.dtype)

    # tdata[j, c] = data[j, c - k] on an n-length axis
    tdata_rows = []
    for j, k in enumerate(offsets):
        row = jnp.zeros((n,), data.dtype)
        src_lo, src_hi = max(0, -k), min(m, n - k)
        if src_hi > src_lo:
            row = row.at[src_lo + k : src_hi + k].set(data[j, src_lo:src_hi])
        tdata_rows.append(row)
    tdata = jnp.stack(tdata_rows)
    if storage_dtype is not None:
        data = data.astype(storage_dtype)
        tdata = tdata.astype(storage_dtype)
    return DIAOperator(
        data=data, tdata=tdata, m=int(m), n=int(n), offsets=offsets,
    )


def dia_operator(
    m, n, offsets: Sequence[int], data, *, dtype=None, storage_dtype=None,
) -> DIAOperator:
    """Build a DIAOperator. ``data`` has shape (len(offsets), m) with
    ``data[j, i] = A[i, i + offsets[j]]``; out-of-matrix entries must be 0
    (they are zeroed defensively here). The transpose stripe packing is
    precomputed so SpMV-T streams exactly like SpMV.
    ``storage_dtype='bfloat16'`` selects bf16 stripe STORAGE with f32
    compute (see :func:`dia_operator_device`). Complex stripes dispatch to
    the plane-split :func:`lsqr_tpu.zdia_operator`."""
    data = np.asarray(jnp.asarray(data, dtype=dtype))
    if np.iscomplexobj(data):
        if storage_dtype is not None:
            raise ValueError("storage_dtype applies to real stripes only")
        from .zdia import zdia_operator

        return zdia_operator(m, n, offsets, data)
    offsets = tuple(int(k) for k in offsets)
    if data.shape != (len(offsets), m):
        raise ValueError(
            f"data must have shape ({len(offsets)}, {m}), got {data.shape}"
        )
    i = np.arange(m)
    mask = np.stack([(i + k >= 0) & (i + k < n) for k in offsets])
    data = data * mask

    # transpose stripes: tdata[j, c] = A[c - k, c] = data[j, c - k]
    tdata = np.zeros((len(offsets), n), data.dtype)
    for j, k in enumerate(offsets):
        src_lo = max(0, -k)               # row index range [src_lo, src_hi)
        src_hi = min(m, n - k)
        if src_hi > src_lo:
            tdata[j, src_lo + k : src_hi + k] = data[j, src_lo:src_hi]
    data_j, tdata_j = jnp.asarray(data), jnp.asarray(tdata)
    if storage_dtype is not None:
        data_j = data_j.astype(storage_dtype)
        tdata_j = tdata_j.astype(storage_dtype)
    return DIAOperator(
        data=data_j, tdata=tdata_j, m=int(m), n=int(n), offsets=offsets,
    )


# ---------------------------------------------------------------------------
# DIA with SHARED stripes — one padded array serves both products
# ---------------------------------------------------------------------------


#: smallest max(m, n) at which the shared operator's solver step takes the
#: Triton pair kernel on the GPU. Measured on the card: see PERF.md.
_PAIR_MIN_DIM = 1 << 20


def shared_geometry(offsets, m, n):
    """(H, Lp) of the shared padded stripe array: halo ``H = max|k|`` and
    per-diagonal length ``Lp >= 2H + max(m, n)``, rounded up to 1024
    elements so every stripe starts 4 KiB-aligned. Every static slice of
    either product, and every masked load of the pair kernel, stays inside
    one stripe."""
    ks = tuple(offsets) or (0,)
    H = max(max(ks), -min(ks), 0)
    Lp = 2 * H + max(m, n)
    return H, -(-Lp // 1024) * 1024


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIASharedOperator(LinearOperator):
    """Banded m x n matrix storing ONE zero-padded stripe array that serves
    both the forward and the adjoint product — no packed transpose copy, so
    operator memory is HALF of :class:`DIAOperator`'s (the largest bandable
    problem per card doubles). The f32 banded default of ``auto_operator``.

    ``dp[d * Lp + H + i] = A[i, i + offsets[d]]`` with halo ``H = max|k|``
    (:func:`shared_geometry`); both products are static per-diagonal slices
    of the stripes and the zero-padded vector. On a GPU the solver step
    takes :func:`~lsqr_tpu.ops.triton_pair.dia_pair_triton`, which reads
    the stripes once for both products. The distributed DIA row shards
    accept this class and repack each shard's row slice (via ``data``).
    """

    dp: jax.Array      # (ndiag * Lp,) FLAT padded shared stripes
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    H: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        if self.dp.dtype == jnp.bfloat16:
            return jnp.dtype(jnp.float32)
        return self.dp.dtype

    @property
    def nnz(self) -> int:
        return len(self.offsets) * self.m

    @property
    def Lp(self) -> int:
        return self.dp.shape[0] // len(self.offsets)

    @property
    def data(self) -> jax.Array:
        """The unpadded row-aligned stripes (lazy reshape+slice — fuses
        under jit; kept for parity with DIAOperator introspection)."""
        nd = len(self.offsets)
        return jax.lax.slice(
            self.dp.reshape(nd, self.Lp), (0, self.H), (nd, self.H + self.m)
        )

    fused_halfstep = DIAOperator.fused_halfstep

    def _takes_kernel(self) -> bool:
        # f64 keeps the exact two-product path; the kernel needs a GPU and
        # a geometry it serves well (32-bit indices, a narrow halo)
        if self.dp.dtype == jnp.float64 or kernel_route() is None:
            return False
        from .triton_pair import pair_fits

        return pair_fits(len(self.offsets), self.Lp, self.H)

    @property
    def prefers_pair(self) -> bool:
        # the Triton pair reads the stripes once per iteration instead of
        # twice
        return max(self.m, self.n) >= _PAIR_MIN_DIM and self._takes_kernel()

    def fused_pair(self, *, y, win, c1, c2):
        """Both bidiagonalization products of one step:
            u_new = A (win*c1) - c2*y,     z = A' u_new
        with y (m,), win (n,). On a GPU the Triton kernel reads the SHARED
        stripes once for both; elsewhere, in f64, and for geometries the
        kernel does not serve (:func:`~lsqr_tpu.ops.triton_pair.pair_fits`)
        two separate XLA products."""
        if self._takes_kernel():
            from .triton_pair import dia_pair_triton

            return dia_pair_triton(
                self.dp, win, y, c1, c2, offsets=self.offsets, m=self.m,
                n=self.n, H=self.H,
            )
        u = self.matvec(win * c1) - c2 * y
        return u, self.rmatvec(u)

    def _product_xla(self, vec, adjoint: bool):
        ks = self.offsets
        H = self.H
        dim_out = self.n if adjoint else self.m
        dim_in = self.m if adjoint else self.n
        acc_dt = jnp.float32 if self.dp.dtype == jnp.bfloat16 else self.dp.dtype
        Lp = self.Lp
        vecp = jnp.zeros((Lp,), vec.dtype).at[H : H + dim_in].set(vec)
        out = jnp.zeros((dim_out,), acc_dt)
        for d, k in enumerate(ks):
            s = (H - k if adjoint else H) + d * Lp
            sv = H - k if adjoint else H + k
            seg_d = jax.lax.slice(self.dp, (s,), (s + dim_out,))
            seg_v = jax.lax.slice(vecp, (sv,), (sv + dim_out,))
            out = out + seg_d.astype(acc_dt) * seg_v.astype(acc_dt)
        return out

    def matvec(self, x: jax.Array) -> jax.Array:
        return self._product_xla(x, adjoint=False)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return self._product_xla(y, adjoint=True)

    @property
    def is_bf16_storage(self) -> bool:
        return self.dp.dtype == jnp.bfloat16

    def todense(self) -> jax.Array:
        return _dia_todense(self.data, self.offsets, self.m, self.n, self.dtype)


def dia_shared_operator(
    m, n, offsets: Sequence[int], data, *, dtype=None, storage_dtype=None,
) -> DIASharedOperator:
    """Build a :class:`DIASharedOperator` (half the memory of
    :func:`dia_operator`). ``data`` has shape (len(offsets), m) as in
    `dia_operator`; it may be a device array — the padding is a single
    on-device copy (no transpose packing pass at all)."""
    offsets = tuple(int(k) for k in offsets)
    nd = len(offsets)
    data = jnp.asarray(data, dtype=dtype)
    if data.shape != (nd, m):
        raise ValueError(f"data must have shape ({nd}, {m}), got {data.shape}")
    i = jnp.arange(m)
    mask = jnp.stack([(i + k >= 0) & (i + k < n) for k in offsets])
    data = data * mask.astype(data.dtype)
    if storage_dtype is not None:
        data = data.astype(storage_dtype)
    H, Lp = shared_geometry(offsets, m, n)
    dp = jnp.zeros((nd, Lp), data.dtype).at[:, H : H + m].set(data).reshape(-1)
    return DIASharedOperator(dp=dp, m=int(m), n=int(n), offsets=offsets, H=H)


# ---------------------------------------------------------------------------
# ELL — padded-row storage (gather-only products)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELLOperator(LinearOperator):
    """m x n sparse matrix in ELL (padded-row) layout, with a precomputed
    transpose packing so BOTH products are gather-based (no scatters —
    contrast the reference's column-scatter transpose loop,
    lsqr.f90:188-192).

    vals/cols: (m, k) forward packing (padded entries: val 0, col 0).
    tvals/trows: (n, kt) packing of A'.
    """

    vals: jax.Array
    cols: jax.Array
    tvals: jax.Array
    trows: jax.Array
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        return self.vals.shape[0] * self.vals.shape[1]

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.sum(self.vals * x[self.cols], axis=1)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return jnp.sum(self.tvals * y[self.trows], axis=1)

    def todense(self) -> jax.Array:
        dense = jnp.zeros((self.m, self.n), self.dtype)
        rows = jnp.repeat(jnp.arange(self.m), self.vals.shape[1])
        return dense.at[rows, self.cols.reshape(-1)].add(self.vals.reshape(-1))


def ell_operator(m, n, vals, rows, cols, *, dtype=None) -> ELLOperator:
    """Build an ELLOperator (plus its transpose packing) from COO triplets.

    Packing runs in the native C++ runtime (lsqr_tpu.native) when available,
    with a vectorized numpy fallback."""
    from .. import native

    vals = np.asarray(vals, dtype=dtype if dtype else None)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    fv, fc = native.ell_pack(rows, cols, vals, m)
    tv, tr = native.ell_pack(cols, rows, vals, n)
    return ELLOperator(
        vals=jnp.asarray(fv),
        cols=jnp.asarray(fc),
        tvals=jnp.asarray(tv),
        trows=jnp.asarray(tr),
        m=int(m),
        n=int(n),
    )


#: how many times the forward ELL's slots HYB's transpose ELL may store
#: before the matrix goes to COO instead
_MAX_TRANSPOSE_FILL = 8


def hyb_operator(m, n, vals, rows, cols, *, width=None, dtype=None):
    """HYB (hybrid ELL + COO) operator for POWER-LAW row distributions.

    The classic failure mode of pure ELL is a few heavy rows inflating the
    padded width for every row (the reason ``auto_operator`` documents a
    padding blowup for true power-law patterns). HYB caps the ELL width:
    each row's first ``width`` entries go to the streaming ELL part, the
    heavy-row spill becomes a (small) COO remainder handled by
    segment-sum — composed with :class:`~lsqr_tpu.ops.compose.SumOperator`
    so each part keeps its own product path. Reference anchor: the COO
    scatter kernels this bounds, lsqr.f90:168-172, 188-192.

    ``width=None`` picks the cost-balanced width: the smallest w where the
    padded ELL volume m*w plus SPILL_COST x the spilled entries stops
    improving. SPILL_COST = 1.5 is the byte ratio of a spilled COO entry
    to a streamed ELL slot (12 vs 8 B: value, row and column against value
    and column), so HYB caps ELL's power-law padding blowup in memory. Its
    speed against the other general-sparse products on the GPU is
    unmeasured (ROADMAP S5). A matrix whose column counts would pad the
    transpose ELL beyond ``_MAX_TRANSPOSE_FILL`` times the forward ELL (a
    power-law column distribution) is returned as COO.
    """
    from .compose import add_operators
    from .coo import coo_operator

    vals = np.asarray(vals, dtype=dtype if dtype else None)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if np.iscomplexobj(vals):
        # the ELL part's native packing is real-only (silently casting
        # would drop imaginary parts — ADVICE.md round 3); complex general
        # sparsity takes the conj-correct COO path, as auto_operator does
        raise ValueError(
            "hyb_operator is real-only; complex matrices use the COO path "
            "(coo_operator / auto_operator)"
        )
    if vals.size == 0:
        return coo_operator(m, n, vals, rows, cols, dtype=dtype)

    order = np.lexsort((cols, rows))
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    counts = np.bincount(rows_s, minlength=m)
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(vals_s)) - np.repeat(row_start, counts)

    if width is None:
        SPILL_COST = 1.5
        wmax = int(counts.max())
        best_w, best_cost = wmax, m * wmax
        # cost(w) = m*w + S*spilled(w) is convex piecewise-linear with
        # breakpoints at the distinct row lengths; the integer minimum is
        # at a breakpoint OR at the w=1 boundary (one dense row in an
        # otherwise sparse matrix must pick w=1, not w=max row length —
        # ADVICE.md round 3), so include 1 in the candidate set
        for w in np.union1d([1], np.unique(counts[counts > 0])):
            w = int(w)
            spilled = int(np.maximum(counts - w, 0).sum())
            cost = m * w + SPILL_COST * spilled
            if cost < best_cost:
                best_w, best_cost = w, cost
        width = max(1, best_w)

    main = rank < width
    # the ELL part's adjoint is a transpose ELL padded to its heaviest
    # column: a power-law COLUMN distribution would store far more than
    # nnz there (it ran out of host memory at 16.7M Zipf(1.1) entries,
    # n = 65,536), so such matrices take the segment-sum COO path
    tcounts = np.bincount(cols_s[main], minlength=n)
    if n * int(tcounts.max()) > _MAX_TRANSPOSE_FILL * m * width:
        return coo_operator(m, n, vals, rows, cols, dtype=dtype)
    E = ell_operator(m, n, vals_s[main], rows_s[main], cols_s[main],
                     dtype=dtype)
    if bool(np.all(main)):
        return E
    C = coo_operator(m, n, vals_s[~main], rows_s[~main], cols_s[~main],
                     dtype=dtype)
    return add_operators([E, C])


# ---------------------------------------------------------------------------
# Blocked-ELL — dense blocks, batched small matmuls
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockELLOperator(LinearOperator):
    """Block-sparse m x n matrix: dense (bh, bw) blocks in ELL layout.

    blocks:  (mb, kb, bh, bw) — kb blocks per block-row (padded with zeros).
    bcols:   (mb, kb) block-column indices.
    tblocks/tbrows: the transpose packing (nb, kt, bw, bh).

    Products run as batched small matmuls (XLA einsum), in full float32
    precision (no TF32) for f32 blocks.
    """

    blocks: jax.Array
    bcols: jax.Array
    tblocks: jax.Array
    tbrows: jax.Array
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def bh(self) -> int:
        return self.blocks.shape[2]

    @property
    def bw(self) -> int:
        return self.blocks.shape[3]

    @property
    def nnz(self) -> int:
        return int(np.prod(self.blocks.shape))

    def _matvec_xla(self, x, blocks, bcols, out_len, blk_w):
        # gather x block segments: (mb, kb, bw)
        xb = x.reshape(-1, blk_w)[bcols]
        # (mb, kb, bh, bw) @ (mb, kb, bw) -> sum over kb -> (mb, bh)
        yb = jnp.einsum(
            "rkij,rkj->ri", blocks, xb, preferred_element_type=self.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        return yb.reshape(-1)[:out_len]

    def matvec(self, x: jax.Array) -> jax.Array:
        xp = _pad_to(x, self.tblocks.shape[0] * self.bw)
        return self._matvec_xla(xp, self.blocks, self.bcols, self.m, self.bw)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        yp = _pad_to(y, self.blocks.shape[0] * self.bh)
        return self._matvec_xla(yp, self.tblocks, self.tbrows, self.n, self.bh)

    def fused_pair(self, *, y, win, c1, c2):
        """Both products of the bidiagonalization step for a BlockELL
        matrix: u_new = A(win*c1) - c2*y and z = A'u_new. The adjoint is
        assembled WITHOUT the transpose packing: per-block partials
        zp[r, j] = blocks[r, j]' @ u_r + a block-level segment-sum over
        bcols — mb*kb rows of bw, i.e. 1/bh of the block traffic (contrast
        the reference's per-entry column scatter, lsqr.f90:188-192). Not
        auto-routed: it has no traffic advantage over separate products."""
        mb, kb, bh, bw = self.blocks.shape
        nb = self.tblocks.shape[0]
        xp = _pad_to(win, nb * bw)
        yp = _pad_to(y, mb * bh)
        hi = jax.lax.Precision.HIGHEST
        xb = xp.reshape(nb, bw)[self.bcols] * c1   # (mb, kb, bw)
        ub = jnp.einsum(
            "rkij,rkj->ri", self.blocks, xb,
            preferred_element_type=self.dtype, precision=hi,
        ) - c2 * yp.reshape(mb, bh)
        u = ub.reshape(-1)
        zp = jnp.einsum(
            "rkij,ri->rkj", self.blocks, ub,
            preferred_element_type=self.dtype, precision=hi,
        )
        z = jax.ops.segment_sum(
            zp.reshape(mb * kb, bw).astype(self.dtype),
            self.bcols.reshape(-1), num_segments=nb,
        ).reshape(-1)
        return u[: self.m], z[: self.n]

    def todense(self) -> jax.Array:
        mb, kb, bh, bw = self.blocks.shape
        dense = np.zeros((mb * bh, self.tblocks.shape[0] * bw), self.blocks.dtype)
        bcols = np.asarray(self.bcols)
        blocks = np.asarray(self.blocks)
        for r in range(mb):
            for k in range(kb):
                c = int(bcols[r, k])
                dense[r * bh : (r + 1) * bh, c * bw : (c + 1) * bw] += blocks[r, k]
        return jnp.asarray(dense[: self.m, : self.n])


def _pad_to(x: jax.Array, length: int) -> jax.Array:
    if x.shape[0] == length:
        return x
    return jnp.zeros((length,), x.dtype).at[: x.shape[0]].set(x)


def block_ell_operator(
    m, n, vals, rows, cols, *, block=(128, 128), dtype=None
) -> BlockELLOperator:
    """Build a BlockELLOperator from COO triplets by snapping nonzeros into
    dense (bh, bw) blocks. Efficient when the sparsity pattern is blocky
    (banded, block-structured); a uniformly random pattern will densify.
    """
    from .. import native

    bh, bw = block
    vals = np.asarray(vals, dtype=dtype if dtype else None)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    mb = -(-m // bh)
    nb = -(-n // bw)
    nb_all = max(nb, mb)
    fb, fc = native.block_pack(rows, cols, vals, mb, bh, bw, nb_all)
    tb, tr = native.block_pack(cols, rows, vals, nb, bw, bh, nb_all)
    return BlockELLOperator(
        blocks=jnp.asarray(fb),
        bcols=jnp.asarray(fc),
        tblocks=jnp.asarray(tb),
        tbrows=jnp.asarray(tr),
        m=int(m),
        n=int(n),
    )
