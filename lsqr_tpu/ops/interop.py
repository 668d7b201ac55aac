"""Interop constructors: build lsqr_tpu operators from scipy.sparse
matrices, CSR triples, or dense arrays, picking a device storage
format.

The reference accepts only a COO triple (lsqr.f90:91-127); production users
usually hold scipy CSR/CSC/COO — these helpers bridge that world and choose
between the storage formats:

* DIA      — if the pattern is banded (few distinct diagonals)
* BlockELL — if the pattern is blocky at 128x128 (dense-block fill high)
* ELL      — general fallback (gather-only products)
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from .coo import COOOperator, coo_operator
from .linop import LinearOperator
from .structured import block_ell_operator, dia_operator, ell_operator

__all__ = [
    "from_scipy", "from_matrix_market", "from_bcoo", "csr_operator",
    "auto_operator", "lsqr_scipy",
]


def from_matrix_market(path, *, dtype=None,
                       format: Optional[str] = None) -> LinearOperator:
    """Load a Matrix Market (.mtx / .mtx.gz) file as an lsqr_tpu operator.

    The standard interchange format for the sparse test collections
    (SuiteSparse/Matrix Market) the LSQR literature benchmarks on; the
    reference has no file ingestion at all (COO arrays in memory only,
    lsqr.f90:91-127). Dense .mtx arrays become a DenseOperator; sparse
    ones go through :func:`from_scipy` (auto format selection unless
    ``format`` is given). Complex matrices load as COO/Dense operators
    (the core solver family supports complex; the reference is real-only,
    lsqr_kinds.F90:16-24).
    """
    import scipy.io
    import scipy.sparse

    mat = scipy.io.mmread(str(path))
    if scipy.sparse.issparse(mat):
        return from_scipy(mat, dtype=dtype, format=format)
    from .linop import DenseOperator
    import jax.numpy as jnp

    arr = np.asarray(mat)
    if dtype is None:
        if np.iscomplexobj(arr):
            dtype = arr.dtype  # keep complex (cast would drop imag)
        else:
            from ..config import default_dtype

            dtype = default_dtype()
    return DenseOperator(jnp.asarray(arr, dtype))


def from_bcoo(mat, *, dtype=None, format: Optional[str] = None) -> LinearOperator:
    """Convert a ``jax.experimental.sparse`` matrix (BCOO or BCSR) to an
    lsqr_tpu operator.

    JAX's own sparse types compute SpMV with scatter/gather primitives, as
    the plain COO path does; repacking into the structured formats
    (DIA/JDIA/BlockELL via :func:`auto_operator`, or an explicit
    ``format``) recovers the streaming products. The reference accepts only an in-memory COO triple
    (lsqr.f90:91-127); this is the bridge for users already holding
    jax-native sparse arrays.

    Only unbatched 2-D matrices (``n_batch == 0``, ``n_dense == 0``) are
    supported — batched sparse dimensions have no analogue in the solver
    API (use :func:`lsqr_tpu.lsqr_batch` over a shared pattern instead).
    """
    from jax.experimental import sparse as jsparse

    if isinstance(mat, jsparse.BCSR):
        mat = mat.to_bcoo()
    if not isinstance(mat, jsparse.BCOO):
        raise TypeError(
            f"from_bcoo expects a jax.experimental.sparse BCOO/BCSR matrix, "
            f"got {type(mat).__name__}"
        )
    if mat.n_batch or mat.n_dense or mat.ndim != 2:
        raise ValueError(
            "from_bcoo supports unbatched 2-D matrices only "
            f"(ndim={mat.ndim}, n_batch={mat.n_batch}, n_dense={mat.n_dense})"
        )
    m, n = mat.shape
    # sum_duplicates also drops the padding entries unbatched BCOO uses
    mat = mat.sum_duplicates()
    indices = np.asarray(mat.indices)
    data = np.asarray(mat.data, dtype=dtype if dtype else None)
    rows, cols = indices[:, 0], indices[:, 1]
    # sum_duplicates pads pruned slots with out-of-range indices; drop them
    keep = (rows < m) & (cols < n)
    rows, cols, data = rows[keep], cols[keep], data[keep]
    if format is None:
        return auto_operator(m, n, data, rows, cols, dtype=dtype)
    if np.iscomplexobj(data) and format != "coo":
        raise ValueError(
            f"format={format!r} is real-only; complex matrices use the COO "
            "path (format='coo' or None)"
        )
    builder = {
        "ell": ell_operator,
        "coo": coo_operator,
        "block": block_ell_operator,
    }.get(format)
    if builder is None:
        raise ValueError(f"unknown format {format!r}")
    return builder(m, n, data, rows, cols, dtype=dtype)


def csr_operator(m, n, indptr, indices, data, *, dtype=None, format="ell"):
    """Build an operator from CSR arrays (the format most sparse pipelines
    hold). The CSR is expanded to COO triplets and packed into the requested
    storage format ('ell', 'coo', or 'block')."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data, dtype=dtype if dtype else None)
    if np.iscomplexobj(data) and format != "coo":
        raise ValueError(
            f"format={format!r} is real-only; complex matrices use "
            "format='coo'"
        )
    rows = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))
    if format == "ell":
        return ell_operator(m, n, data, rows, indices, dtype=dtype)
    if format == "coo":
        return coo_operator(m, n, data, rows, indices, dtype=dtype)
    if format == "block":
        return block_ell_operator(m, n, data, rows, indices, dtype=dtype)
    raise ValueError(f"unknown format {format!r}")


def from_scipy(sp_matrix, *, dtype=None, format: Optional[str] = None) -> LinearOperator:
    """Convert a scipy.sparse matrix (any format) to an lsqr_tpu operator.

    format: 'dia' | 'ell' | 'coo' | 'block' | None (auto-detect).
    """
    import scipy.sparse

    if not scipy.sparse.issparse(sp_matrix):
        raise TypeError("from_scipy expects a scipy.sparse matrix")
    coo = sp_matrix.tocoo()
    coo.sum_duplicates()
    m, n = coo.shape
    if np.iscomplexobj(coo.data) and format not in (None, "coo", "dia"):
        # 'dia' is allowed: dia_operator dispatches complex stripes to the
        # plane-split ZDIA streaming format (ops/zdia.py)
        raise ValueError(
            f"format={format!r} is real-only; complex matrices use the COO "
            "path (format='coo' or None) or the banded ZDIA path "
            "(format='dia')"
        )
    if format is None:
        return auto_operator(
            m, n, coo.data, coo.row, coo.col, dtype=dtype
        )
    if format == "dia":
        dia = sp_matrix.todia()
        # scipy DIA stores data[j, c] indexed by COLUMN; lsqr_tpu DIA stripes
        # are ROW-aligned: data[j, i] = A[i, i + k] = scipy_data[j, i + k].
        offsets = tuple(int(k) for k in dia.offsets)
        stripes = np.zeros((len(offsets), m), dia.data.dtype)
        for j, k in enumerate(offsets):
            i_lo, i_hi = max(0, -k), min(m, n - k)
            if i_hi > i_lo:
                stripes[j, i_lo:i_hi] = dia.data[j, i_lo + k : i_hi + k]
        return dia_operator(m, n, offsets, stripes, dtype=dtype)
    if format in ("ell", "coo", "block"):
        builder = {
            "ell": ell_operator,
            "coo": coo_operator,
            "block": block_ell_operator,
        }[format]
        return builder(m, n, coo.data, coo.row, coo.col, dtype=dtype)
    raise ValueError(f"unknown format {format!r}")


def _block_fill_ratio(rows, cols, m, n, bh=128, bw=128):
    """Stored-values / nnz ratio of the (bh, bw) blocked-ELL packing —
    the cheap O(nnz) form of native.block_pack's fill check, used to
    decide blocky-vs-unstructured routing without packing anything."""
    nnz = len(rows)
    if nnz == 0:
        return float("inf")
    mb = -(-m // bh)
    stride = max(-(-n // bw), mb)
    ids = np.unique(rows.astype(np.int64) // bh * stride
                    + cols.astype(np.int64) // bw)
    per_row = np.bincount((ids // stride).astype(np.int64), minlength=mb)
    kb = max(int(per_row.max()) if per_row.size else 0, 1)
    return float(mb) * kb * bh * bw / nnz


def auto_operator(m, n, vals, rows, cols, *, dtype=None,
                  compact=False) -> LinearOperator:
    """Pick a storage format from the sparsity pattern:

    1. few distinct diagonals covering all nnz        -> DIA
       (shared-stripe layout for f32 — the Triton pair on a GPU and half
       the operator memory; packed DIA for f64; ZDIA for complex)
    2. jitter-bounded diagonals (>=95% slot fit)      -> JDIA (ZJDIA complex)
    3. blocky at (128, 128) (fill ratio <= 64x nnz)   -> BlockELL
    4. otherwise                                      -> HYB (ELL + COO spill)

    ``compact=True`` forces the shared-stripe DIA form in case 1 for
    NON-f32 dtypes too (f32 banded patterns use it by default — see
    :func:`lsqr_tpu.dia_shared_operator`): one padded stripe array
    serves both products, halving operator HBM.
    """
    rows_np = np.asarray(rows)
    cols_np = np.asarray(cols)
    vals_np = np.asarray(vals, dtype=dtype if dtype else None)
    nnz = len(vals_np)
    if nnz == 0:
        return coo_operator(m, n, vals_np, rows_np, cols_np, dtype=dtype)
    if np.iscomplexobj(vals_np):
        # complex BANDED matrices stream through the plane-split ZDIA
        # format (ops/zdia.py — each product is 4 real stripe passes, the
        # pair kernel reads each plane once); everything else takes the
        # fully-general COO path, whose segment-sum products (and
        # conjugated adjoint) support complex
        diags = np.unique(cols_np.astype(np.int64) - rows_np)
        if len(diags) * m <= 4 * nnz and len(diags) <= 1024:
            from .zdia import zdia_operator

            stripes = np.zeros((len(diags), m), vals_np.dtype)
            idx = np.searchsorted(diags, cols_np.astype(np.int64) - rows_np)
            np.add.at(stripes, (idx, rows_np), vals_np)
            return zdia_operator(
                m, n, tuple(int(k) for k in diags), stripes, dtype=dtype
            )
        # jitter-bounded complex patterns: plane-split JDIA (4 real
        # streaming products per complex product; round 4)
        from .zdia import zjdia_operator

        try:
            zcand = zjdia_operator(m, n, vals_np, rows_np, cols_np,
                                   dtype=dtype)
            if zcand.fit_fraction >= 0.95:
                return zcand
        except (ValueError, RuntimeError):
            pass
        return coo_operator(m, n, vals_np, rows_np, cols_np, dtype=dtype)

    diags = np.unique(cols_np.astype(np.int64) - rows_np)
    # DIA stores len(diags) * m values; accept modest padding
    if len(diags) * m <= 4 * nnz and len(diags) <= 1024:
        stripes = np.zeros((len(diags), m), vals_np.dtype)
        idx = np.searchsorted(diags, cols_np.astype(np.int64) - rows_np)
        np.add.at(stripes, (idx, rows_np), vals_np)
        offs = tuple(int(k) for k in diags)
        eff = (jnp.dtype(dtype) if dtype is not None
               else jnp.empty((), vals_np.dtype).dtype)
        if compact or eff == jnp.float32:
            # shared-stripe layout for f32: half the operator memory, and
            # the layout of the GPU pair kernel. f64 keeps the packed
            # layout.
            from .structured import dia_shared_operator

            return dia_shared_operator(m, n, offs, stripes, dtype=dtype)
        return dia_operator(m, n, offs, stripes, dtype=dtype)

    # JDIA: jitter-bounded diagonals. Accept when nearly all entries fit
    # slots (the remainder falls back to segment-sum).
    from .jdia import jdia_operator

    try:
        cand = jdia_operator(m, n, vals_np, rows_np, cols_np)
        if cand.fit_fraction >= 0.95:
            return cand
    except (ValueError, RuntimeError):
        pass

    try:
        return block_ell_operator(
            m, n, vals_np, rows_np, cols_np, block=(128, 128), dtype=dtype
        )
    except ValueError:
        # HYB fallback: bounded-width ELL + COO spill — degenerates to pure
        # ELL when the row-length distribution is flat, and caps the padded
        # width when it is power-law (the documented ELL blowup case)
        from .structured import hyb_operator

        return hyb_operator(m, n, vals_np, rows_np, cols_np, dtype=dtype)


def lsmr_scipy(
    A,
    b,
    damp: float = 0.0,
    atol: float = 1e-6,
    btol: float = 1e-6,
    conlim: float = 1e8,
    maxiter=None,
    show: bool = False,
    x0=None,
):
    """Drop-in replacement for ``scipy.sparse.linalg.lsmr``: same argument
    names, same defaults, same 8-tuple return
    ``(x, istop, itn, normr, normar, norma, conda, normx)``.

    ``lsqr_tpu.lsmr`` already implements scipy's istop taxonomy (0-7) and
    is cross-checked against it in tests/test_lsmr.py, so no code
    translation is needed — only the tuple shape. See :func:`lsqr_scipy`
    for the porting rationale."""
    import numpy as np

    from ..lsmr import lsmr

    try:  # scipy sparse input
        import scipy.sparse as _sp

        if _sp.issparse(A):
            A = from_scipy(A)
    except ImportError:  # pragma: no cover
        pass

    res = lsmr(
        A,
        b,
        damp,
        atol=atol,
        btol=btol,
        conlim=conlim,
        itnlim=maxiter,
        x0=x0,
    )
    if show:
        print(
            f"istop = {int(res.istop)}  itn = {int(res.itn)}  "
            f"normr = {float(res.normr):.3e}  "
            f"normar = {float(res.normar):.3e}"
        )
    return (
        np.asarray(res.x),
        int(res.istop),
        int(res.itn),
        float(res.normr),
        float(res.normar),
        float(res.norma),
        float(res.conda),
        float(res.normx),
    )


def lsqr_scipy(
    A,
    b,
    damp: float = 0.0,
    atol: float = 1e-6,
    btol: float = 1e-6,
    conlim: float = 1e8,
    iter_lim=None,
    show: bool = False,
    calc_var: bool = False,
    x0=None,
):
    """Drop-in replacement for ``scipy.sparse.linalg.lsqr``: same argument
    names, same defaults, same 10-tuple return
    ``(x, istop, itn, r1norm, r2norm, anorm, acond, arnorm, xnorm, var)``.

    ``A`` may be anything :func:`lsqr_tpu.lsqr` accepts — a LinearOperator,
    a dense array, a ``(matvec, rmatvec)`` pair — or a scipy sparse matrix
    (converted via :func:`from_scipy`). Use this to port scipy code to the
    device path one call-site at a time; for new code prefer
    :func:`lsqr_tpu.lsqr`, whose result object carries more (trace, bnorm,
    dxmax) and composes with sharding/batching.
    """
    import numpy as np

    from ..solver import lsqr

    try:  # scipy sparse input
        import scipy.sparse as _sp

        if _sp.issparse(A):
            A = from_scipy(A)
    except ImportError:  # pragma: no cover
        pass

    if iter_lim is None and hasattr(A, "n"):
        iter_lim = 2 * int(A.n)  # scipy's default policy (ours is 4n)
    res = lsqr(
        A,
        b,
        damp,
        atol=atol,
        btol=btol,
        conlim=conlim,
        itnlim=iter_lim,
        wantse=calc_var,
        x0=x0,
    )
    if show:
        from ..utils.printing import format_report

        print(format_report(res))

    # istop translation: the reference taxonomy this library implements
    # reclassifies a damped LS stop as 3 (lsqr.f90:871) and uses 4=conlim,
    # 5=itnlim; scipy keeps the original codes (2=LS stop even when damped,
    # 3=conlim, 7=itnlim; its 4/5/6 machine-precision variants fold into
    # 1/2/3 here).
    istop_map = {0: 0, 1: 1, 2: 2, 3: 2, 4: 3, 5: 7}
    istop = istop_map[int(res.istop)]

    x = np.asarray(res.x)
    rnorm = float(res.rnorm)       # scipy's r2norm: sqrt(r1norm^2 + damp^2 xnorm^2)
    xnorm = float(res.xnorm)
    r1sq = rnorm**2 - (float(damp) * xnorm) ** 2
    r1norm = float(np.sqrt(abs(r1sq)) * (1 if r1sq >= 0 else -1))
    var = None
    if calc_var:
        # the reference finalizes se = (rnorm/sqrt(t)) * sqrt(acc)
        # (lsqr.f90:857-865); scipy's var IS acc, so invert the scaling.
        m, n = (A.shape if hasattr(A, "shape") else (len(b), x.shape[0]))
        if m > n:
            t = float(m - n) if damp == 0.0 else float(m)
        else:
            t = 1.0
        se = np.asarray(res.se, np.float64)
        var = (se * np.sqrt(t) / rnorm) ** 2 if rnorm > 0 else se * 0.0
    return (
        x,
        istop,
        int(res.itn),
        r1norm,
        rnorm,
        float(res.anorm),
        float(res.acond),
        float(res.arnorm),
        xnorm,
        var,
    )
