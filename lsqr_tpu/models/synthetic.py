"""Synthetic benchmark/test problem generators.

These fill the benchmark configurations named in BASELINE.json ("Large
synthetic banded/random CSR matrix (~10M nnz)") — the reference publishes
no throughput benchmarks (SURVEY.md §6), so these matrices establish the
framework's fresh performance baseline.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops.coo import COOOperator, coo_operator
from ..ops.structured import DIAOperator, dia_operator

__all__ = ["banded_problem", "random_coo_problem", "banded_dia", "block_banded_coo"]


def banded_dia(m, n, offsets: Sequence[int], *, seed=0, dtype=np.float32) -> DIAOperator:
    """Random banded matrix in DIA storage with the given diagonal offsets."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), m)).astype(dtype)
    return dia_operator(m, n, offsets, data)


def banded_problem(m, n, bandwidth: int, *, seed=0, dtype=np.float32):
    """A banded least-squares problem: DIA operator with ``2*bandwidth + 1``
    diagonals, plus rhs. Returns (DIAOperator, b, nnz)."""
    offsets = list(range(-bandwidth, bandwidth + 1))
    A = banded_dia(m, n, offsets, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal(m).astype(dtype)
    # true stored nonzeros (excluding out-of-matrix stripe tails)
    i = np.arange(m)
    nnz = int(sum(((i + k >= 0) & (i + k < n)).sum() for k in offsets))
    return A, b, nnz


def random_coo_problem(m, n, nnz, *, seed=0, dtype=np.float32):
    """Uniformly random sparse COO problem (duplicates summed). Returns
    (COOOperator, b)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    b = rng.standard_normal(m).astype(dtype)
    return coo_operator(m, n, vals, rows, cols), b


def block_banded_coo(m, n, block: int, band_blocks: int, *, seed=0, dtype=np.float32):
    """Block-banded matrix as COO triplets: dense (block x block) blocks on
    the ``2*band_blocks + 1`` central block-diagonals. Returns
    (vals, rows, cols) numpy arrays — feed to coo/ell/block_ell builders."""
    rng = np.random.default_rng(seed)
    mb, nb = m // block, n // block
    rows_l, cols_l, vals_l = [], [], []
    ii, jj = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    for rb in range(mb):
        for cb in range(max(0, rb - band_blocks), min(nb, rb + band_blocks + 1)):
            rows_l.append((rb * block + ii).ravel())
            cols_l.append((cb * block + jj).ravel())
            vals_l.append(rng.standard_normal(block * block).astype(dtype))
    return (
        np.concatenate(vals_l),
        np.concatenate(rows_l),
        np.concatenate(cols_l),
    )
