"""Bandwidth-reducing reordering — the bridge from arbitrary general
sparsity to the streaming formats.

The JDIA/DIA kernels need locality (bounded |col - row - d| jitter). Many
"general" matrices have that locality hidden behind an arbitrary
row/column numbering; a reverse Cuthill-McKee pass over the bipartite
row-column graph recovers it. LSQR is invariant under the orthogonal
row/column permutations (min ||P_r A P_c' z - P_r b|| has the same norms,
istop, and iteration path as the original problem with x = P_c' z), so the
solve runs entirely in permuted space — the permutation is applied ONCE to
b on the way in and once to x on the way out, never inside the iteration
(a per-iteration permutation would itself be a gather, the thing this
module exists to avoid).

Reference anchor: the reference's COO aprod accepts any ordering
(/root/reference/src/lsqr.f90:134-200); this module is how that generality
meets the streaming formats.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

__all__ = ["bandwidth_orders", "GeneralPlan", "plan_general", "solve_general"]


def bandwidth_orders(m, n, rows, cols):
    """Row/column orderings that localize the pattern: reverse
    Cuthill-McKee over the bipartite (rows + cols) graph.

    Returns (row_order, col_order): ``row_order[i]`` = new index of row i,
    ``col_order[j]`` = new index of column j. Identity when scipy is
    unavailable or the graph is empty."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    ident = (np.arange(m), np.arange(n))
    if len(rows) == 0:
        return ident
    try:
        import scipy.sparse
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:  # pragma: no cover
        return ident
    nv = m + n
    bi = scipy.sparse.coo_matrix(
        (np.ones(len(rows), np.int8), (rows, m + cols)), shape=(nv, nv)
    )
    bi = (bi + bi.T).tocsr()
    p = np.asarray(reverse_cuthill_mckee(bi, symmetric_mode=True))
    # rank of each vertex within its own side, in p order
    is_row = p < m
    row_rank = np.empty(m, np.int64)
    row_rank[p[is_row]] = np.arange(int(is_row.sum()))
    col_rank = np.empty(n, np.int64)
    col_rank[p[~is_row] - m] = np.arange(n)
    return row_rank, col_rank


class GeneralPlan:
    """A prepared general-sparsity solve: reordered operator + the one-time
    permutations. Use :func:`plan_general` to build; reuse across many
    right-hand sides (the expensive pack/reorder happens once)."""

    def __init__(self, op, row_order, col_order, m, n):
        self.op = op
        self.row_order = row_order      # new index of each original row
        self.col_order = col_order
        self.m = m
        self.n = n

    def permute_b(self, b):
        bp = np.empty(self.m, dtype=np.asarray(b).dtype)
        bp[self.row_order] = np.asarray(b)
        return jnp.asarray(bp)

    def unpermute_x(self, x_perm):
        return jnp.asarray(np.asarray(x_perm)[self.col_order])

    def solve(self, b, damp: float = 0.0, **opts):
        """Solve in permuted space; returns an LSQRResult with x (and se)
        mapped back to the original column order. Norm estimates, istop and
        iteration counts are invariant under the permutations."""
        from ..solver import lsqr

        res = lsqr(self.op, self.permute_b(b), damp, **opts)
        out = res._replace(x=self.unpermute_x(res.x))
        if res.se is not None:
            out = out._replace(se=self.unpermute_x(res.se))
        return out


def plan_general(m, n, vals, rows, cols, *, reorder: Optional[bool] = None,
                 dtype=None) -> GeneralPlan:
    """Build a :class:`GeneralPlan` for COO triplets: optionally reorder
    (default: only if it helps), then pick the best storage format via
    auto_operator.

    ``reorder=None`` packs both ways and keeps the better one (judged by
    JDIA slot-fit fraction); True/False force."""
    from .interop import auto_operator
    from .jdia import JDIAOperator

    vals = np.asarray(vals)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    ident = (np.arange(m), np.arange(n))

    def build(ro, co):
        return auto_operator(m, n, vals, ro[rows], co[cols], dtype=dtype)

    if reorder is False:
        return GeneralPlan(build(*ident), *ident, m, n)

    ro, co = bandwidth_orders(m, n, rows, cols)
    if reorder:
        return GeneralPlan(build(ro, co), ro, co, m, n)

    def fitness(op):
        if isinstance(op, JDIAOperator):
            return op.fit_fraction
        from .structured import DIAOperator

        return 1.5 if isinstance(op, DIAOperator) else 0.0

    plain = build(*ident)
    if fitness(plain) >= 1.0:
        return GeneralPlan(plain, *ident, m, n)
    reordered = build(ro, co)
    if fitness(reordered) > fitness(plain):
        return GeneralPlan(reordered, ro, co, m, n)
    return GeneralPlan(plain, *ident, m, n)


def solve_general(m, n, vals, rows, cols, b, damp: float = 0.0, **opts):
    """One-shot general-sparsity solve: reorder if it helps, pack into the
    best storage format, solve, return x in the original ordering."""
    return plan_general(m, n, vals, rows, cols).solve(b, damp, **opts)
