"""COO sparse operator — the general-purpose equivalent of the reference EZ
class's scatter-accumulate SpMV kernels (/root/reference/src/lsqr.f90:134-200).

The reference loops over nnz serially, scattering ``Ax(irow(i)) += a(i) *
x(icol(i))`` (mode 1, lsqr.f90:168-172) and the symmetric column scatter for
the transpose (mode 2, lsqr.f90:188-192). The data-parallel formulation is one
gather + one segment-sum per product:

    matvec:  segment_sum(vals * x[cols], rows, m)
    rmatvec: segment_sum(vals * y[rows], cols, n)

which XLA lowers to vectorized gather/scatter-add. For structured matrices,
prefer the DIA/BSR/ELL operators in :mod:`lsqr_tpu.ops.structured` — they are
the performance path; COO is the fully general correctness path that works
for any sparsity pattern on any backend.

Indices are 0-based (Python convention; the reference is 1-based Fortran).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .linop import LinearOperator

__all__ = ["COOOperator", "coo_operator"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COOOperator(LinearOperator):
    """Sparse m x n matrix in coordinate format.

    Fields:
      vals: (nnz,) nonzero values.
      rows: (nnz,) int32 row indices in [0, m).
      cols: (nnz,) int32 column indices in [0, n).
      m, n: static shape.
      sorted_rows: static hint that ``rows`` is non-decreasing, which lets
        XLA use the faster sorted segment-sum path for matvec.
      sorted_cols: same hint for ``cols`` (rmatvec).
    """

    vals: jax.Array
    rows: jax.Array
    cols: jax.Array
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    sorted_rows: bool = dataclasses.field(default=False, metadata=dict(static=True))
    sorted_cols: bool = dataclasses.field(default=False, metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    def matvec(self, x: jax.Array) -> jax.Array:
        prods = self.vals * x[self.cols]
        return jax.ops.segment_sum(
            prods, self.rows, num_segments=self.m, indices_are_sorted=self.sorted_rows
        )

    def rmatvec(self, y: jax.Array) -> jax.Array:
        # adjoint product: for complex values this is A^H y (conjugate
        # transpose) — the scalars of the bidiagonalization stay real and
        # the reference's recurrences apply verbatim over C
        vals = (
            jnp.conj(self.vals)
            if jnp.issubdtype(self.vals.dtype, jnp.complexfloating)
            else self.vals
        )
        prods = vals * y[self.rows]
        return jax.ops.segment_sum(
            prods, self.cols, num_segments=self.n, indices_are_sorted=self.sorted_cols
        )

    def todense(self) -> jax.Array:
        dense = jnp.zeros((self.m, self.n), self.dtype)
        return dense.at[self.rows, self.cols].add(self.vals)


def coo_operator(m, n, vals, rows, cols, *, dtype=None, validate=True) -> COOOperator:
    """Build a COOOperator with the same input validation as the reference
    EZ constructor (size agreement and index bounds with hard errors,
    lsqr.f90:109-111), adjusted to 0-based indexing.
    """
    vals = jnp.asarray(vals, dtype=dtype)
    rows_np = np.asarray(rows)
    cols_np = np.asarray(cols)
    if validate:
        if not (vals.shape[0] == rows_np.shape[0] == cols_np.shape[0]):
            raise ValueError(
                f"invalid vals/rows/cols sizes: {vals.shape[0]}, "
                f"{rows_np.shape[0]}, {cols_np.shape[0]}"
            )
        if rows_np.size and (rows_np.min() < 0 or rows_np.max() >= m):
            raise ValueError(f"row indices out of range [0, {m})")
        if cols_np.size and (cols_np.min() < 0 or cols_np.max() >= n):
            raise ValueError(f"column indices out of range [0, {n})")
    sorted_rows = bool(rows_np.size == 0 or (np.diff(rows_np) >= 0).all())
    sorted_cols = bool(cols_np.size == 0 or (np.diff(cols_np) >= 0).all())
    return COOOperator(
        vals=vals,
        rows=jnp.asarray(rows_np, dtype=jnp.int32),
        cols=jnp.asarray(cols_np, dtype=jnp.int32),
        m=int(m),
        n=int(n),
        sorted_rows=sorted_rows,
        sorted_cols=sorted_cols,
    )
