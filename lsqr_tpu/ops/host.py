"""Host-side (numpy/scipy, float64) export of operators.

Every storage format in this package is a device-resident packing tuned
for device streaming; this module walks those packings BACK into plain COO
triplets on the host, without materializing a dense matrix. Two users:

- interop: ``to_scipy(A)`` is the inverse of ``ops.interop.from_scipy``
  (round-trip tested), so results move freely between this framework and
  the scipy/Fortran world the reference lives in
  (/root/reference/test/lsqrtest_ez.f90:58-68 records scipy output as its
  oracle — now the bridge is a function call).
- mixed-precision refinement (``lsqr_tpu.refine``): the correction loop
  needs the residual ``b - A x`` evaluated in float64 while the device
  arrays are float32/bf16 — ``host_products(A)`` returns f64 matvec /
  rmatvec closures over a scipy CSR built once.

The exported matrix is the operator's STORED values (f32/bf16 entries
promoted exactly to f64) — i.e. exactly the matrix the device products
apply, which is what refinement must use.
"""

from __future__ import annotations

import numpy as np

__all__ = ["host_coo", "to_scipy", "host_products"]


def _coo_of_dia(offsets, data, m, n, dtype):
    """data[j, i] = A[i, i + offsets[j]] (row-aligned stripes)."""
    rows, cols, vals = [], [], []
    for j, k in enumerate(offsets):
        lo = max(0, -k)
        hi = min(m, n - k)
        if hi <= lo:
            continue
        i = np.arange(lo, hi, dtype=np.int64)
        rows.append(i)
        cols.append(i + k)
        vals.append(np.asarray(data[j, lo:hi], dtype))
    if not rows:
        z = np.zeros((0,), np.int64)
        return z, z, np.zeros((0,), dtype)
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def host_coo(A, *, dtype=np.float64, dense_limit: int = 1 << 25):
    """Return ``(rows, cols, vals)`` numpy COO triplets of the operator's
    stored matrix, promoted to ``dtype``.

    Duplicate (row, col) pairs may appear (e.g. structural-zero padding);
    they sum — scipy's COO->CSR conversion and ``np.add.at`` both honor
    that. Operators with no explicit storage (callbacks, implicit test
    operators) fall back to ``todense()`` when ``m * n <= dense_limit``.
    """
    # local imports: this module must not import jax at module scope so the
    # host path stays usable before any device is configured
    from .coo import COOOperator
    from .linop import DenseOperator
    from .structured import (BlockELLOperator, DIAOperator,
                             DIASharedOperator, ELLOperator)

    dtype = np.dtype(dtype)

    if isinstance(A, COOOperator):
        return (np.asarray(A.rows, np.int64), np.asarray(A.cols, np.int64),
                np.asarray(A.vals, dtype))

    if isinstance(A, DenseOperator):
        a = np.asarray(A.a, dtype)
        r, c = np.nonzero(a)
        return r.astype(np.int64), c.astype(np.int64), a[r, c]

    if isinstance(A, (DIAOperator, DIASharedOperator)):
        data = np.asarray(A.data, dtype)  # DIAShared: (nd, m) view property
        return _coo_of_dia(A.offsets, data, A.m, A.n, dtype)

    if isinstance(A, ELLOperator):
        k = A.vals.shape[1]
        rows = np.repeat(np.arange(A.m, dtype=np.int64), k)
        cols = np.asarray(A.cols, np.int64).reshape(-1)
        vals = np.asarray(A.vals, dtype).reshape(-1)
        keep = vals != 0  # padded entries are (val 0, col 0)
        return rows[keep], cols[keep], vals[keep]

    if isinstance(A, BlockELLOperator):
        mb, kb, bh, bw = A.blocks.shape
        blocks = np.asarray(A.blocks, dtype)          # (mb, kb, bh, bw)
        bcols = np.asarray(A.bcols, np.int64)         # (mb, kb)
        ii, jj = np.meshgrid(np.arange(bh, dtype=np.int64),
                             np.arange(bw, dtype=np.int64), indexing="ij")
        r0 = (np.arange(mb, dtype=np.int64) * bh)[:, None, None, None]
        c0 = (bcols * bw)[:, :, None, None]
        rows = np.broadcast_to(r0 + ii, blocks.shape).reshape(-1)
        cols = np.broadcast_to(c0 + jj, blocks.shape).reshape(-1)
        vals = blocks.reshape(-1)
        keep = (vals != 0) & (rows < A.m) & (cols < A.n)
        return rows[keep], cols[keep], vals[keep]

    from .linop import _TransposedOperator

    if isinstance(A, _TransposedOperator):
        r, c, v = host_coo(A.op, dtype=dtype, dense_limit=dense_limit)
        return c, r, v

    jdia = _try_jdia_coo(A, dtype)
    if jdia is not None:
        return jdia

    comp = _try_composite_coo(A, dtype, dense_limit)
    if comp is not None:
        return comp

    # fallback: implicit/callback operators — dense is the only general way
    if A.m * A.n > dense_limit:
        raise NotImplementedError(
            f"host_coo: no sparse host export for {type(A).__name__} and "
            f"m*n = {A.m * A.n} exceeds dense_limit = {dense_limit}; pass "
            "host_matvec/host_rmatvec callables instead"
        )
    a = np.asarray(A.todense(), dtype)
    r, c = np.nonzero(a)
    return r.astype(np.int64), c.astype(np.int64), a[r, c]


def _try_jdia_coo(A, dtype):
    from .jdia import JDIAOperator, JITTER

    if not isinstance(A, JDIAOperator):
        return None
    # mirror of ops.jdia._accum_dense, emitting triplets (vectorized over
    # rows instead of the reference loop): slot s, row i lives at column
    # i + (base[s, i // tm] + JITTER - p_lo) + eoff[s, i]
    data = np.asarray(A.data, dtype)              # (ns, m_pad)
    eoff = np.asarray(A.eoff, np.int64)
    base = np.asarray(A.base, np.int64)
    ns = data.shape[0]
    m = A.m
    i = np.arange(m, dtype=np.int64)
    tiles = i // A.tm
    rows, cols, vals = [], [], []
    for s in range(ns):
        d = base[s, tiles] + JITTER - A.p_lo
        c = i + d + eoff[s, :m]
        keep = (data[s, :m] != 0) & (c >= 0) & (c < A.n)
        rows.append(i[keep])
        cols.append(c[keep])
        vals.append(data[s, :m][keep])
    rv = np.asarray(A.rem_vals, dtype)
    if rv.shape[0]:
        keep = rv != 0  # remainder is padded to >= 1 entry
        rows.append(np.asarray(A.rem_rows, np.int64)[keep])
        cols.append(np.asarray(A.rem_cols, np.int64)[keep])
        vals.append(rv[keep])
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


def _try_composite_coo(A, dtype, dense_limit):
    from .compose import (DiagonalOperator, HStackOperator, ScaledOperator,
                          VStackOperator)
    from .precondition import ColumnScaledOperator, ComposedOperator

    if isinstance(A, VStackOperator):
        rows, cols, vals = [], [], []
        off = 0
        for op in A.ops:
            r, c, v = host_coo(op, dtype=dtype, dense_limit=dense_limit)
            rows.append(r + off)
            cols.append(c)
            vals.append(v)
            off += op.m
        return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)

    if isinstance(A, HStackOperator):
        rows, cols, vals = [], [], []
        off = 0
        for op in A.ops:
            r, c, v = host_coo(op, dtype=dtype, dense_limit=dense_limit)
            rows.append(r)
            cols.append(c + off)
            vals.append(v)
            off += op.n
        return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)

    if isinstance(A, DiagonalOperator):
        d = np.asarray(A.d, dtype)
        i = np.arange(d.shape[0], dtype=np.int64)
        return i, i, d

    if isinstance(A, ScaledOperator):
        r, c, v = host_coo(A.op, dtype=dtype, dense_limit=dense_limit)
        return r, c, v * dtype.type(np.asarray(A.alpha, dtype))

    if isinstance(A, ColumnScaledOperator):
        r, c, v = host_coo(A.op, dtype=dtype, dense_limit=dense_limit)
        return r, c, v * np.asarray(A.scale, dtype)[c]

    if isinstance(A, ComposedOperator):
        import scipy.sparse as sp

        prod = (to_scipy(A.outer, dtype=dtype, dense_limit=dense_limit)
                @ to_scipy(A.inner, dtype=dtype, dense_limit=dense_limit))
        coo = sp.coo_matrix(prod)
        return (coo.row.astype(np.int64), coo.col.astype(np.int64),
                coo.data.astype(dtype))

    return None


def to_scipy(A, *, dtype=np.float64, dense_limit: int = 1 << 25):
    """Export an operator's stored matrix as a ``scipy.sparse.csr_matrix``
    in ``dtype`` (default float64). Inverse of
    :func:`lsqr_tpu.ops.interop.from_scipy` up to storage format."""
    import scipy.sparse as sp

    r, c, v = host_coo(A, dtype=dtype, dense_limit=dense_limit)
    return sp.csr_matrix(
        sp.coo_matrix((v, (r, c)), shape=(A.m, A.n), dtype=dtype)
    )


def host_products(A, *, dtype=np.float64, dense_limit: int = 1 << 25):
    """Return ``(matvec, rmatvec)`` numpy closures (default float64)
    applying the operator's stored matrix on the host — the high-precision
    residual evaluator for :func:`lsqr_tpu.refine.lsqr_refined`. For a
    complex ``dtype`` the rmatvec is the conjugate transpose (adjoint)."""
    sp_a = to_scipy(A, dtype=dtype, dense_limit=dense_limit)
    sp_at = sp_a.T.tocsr()
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        sp_at = sp_a.conj().T.tocsr()

    def matvec(x):
        return sp_a @ np.asarray(x, dtype)

    def rmatvec(y):
        return sp_at @ np.asarray(y, dtype)

    return matvec, rmatvec
