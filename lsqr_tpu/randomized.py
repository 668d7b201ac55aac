"""LSRN — randomized preconditioning for strongly rectangular problems.

The reference documents right preconditioning as the user's problem
("solve A M^-1 z = b for some convenient M", lsqr.f90:322-328) but offers
no way to build a good M: in serial Fortran, constructing one costs as
much as the solve it accelerates. On the device the construction is cheap where
it matters — a Gaussian sketch is matmul/batched-product work,
and the SVD of the small sketch runs on the host.

LSRN (Meng, Saunders & Mahoney 2014, SIAM J. Sci. Comput. 36(2)):
for an over-determined A (m >= n), with s = ceil(gamma * n), gamma > 1:

1. sketch      ``S = G A``  with G an (s, m) iid N(0, 1) matrix;
2. thin SVD    ``S = U diag(sig) V'`` (host-side, (s, n) is small);
3. precondition ``N = V diag(1/sig)`` and solve
   ``min || (A N) y - b ||`` with LSQR; ``x = N y``.

Because G A has the same row space as A, every nonzero singular value of
``A N`` lies in ``[1 - sqrt(n/s), 1 + sqrt(n/s)]`` w.h.p. — e.g. gamma=4
gives cond(A N) <~ 3 regardless of cond(A), so the preconditioned LSQR
converges in a few tens of iterations INDEPENDENT of the original
conditioning. The under-determined case (m < n) is the mirror image:
sketch from the right (``A G'``), precondition from the LEFT with
``P = diag(1/sig) U'``, and the min-norm solution is preserved because
``P`` has full row rank on range(A).

The sketch itself never materializes G A against a sparse operator as a
dense product chain: each sketch row is one ``rmatvec`` (``(G A)_i =
(A' g_i)'``), evaluated as chunked vmapped batches — one matmul for
DenseOperator, O(nnz) streaming per row otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ops.compose import scale_operator, vstack_operators
from .ops.linop import DenseOperator, LinearOperator, as_operator
from .ops.precondition import ComposedOperator

#: float32 products feeding a solver run at full precision, not TF32
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["LSRNResult", "lsrn", "lsrn_preconditioner", "sketch_left",
           "sketch_right", "svd_truncated_preconditioner"]


def _chunked_rows(fn, vecs: jax.Array, chunk: int) -> jax.Array:
    """Apply ``fn`` (vector -> vector) over the rows of ``vecs`` in vmapped
    chunks of at most ``chunk`` rows (bounds peak memory at
    chunk * row_output)."""
    s = vecs.shape[0]
    outs = []
    for lo in range(0, s, chunk):
        outs.append(jax.vmap(fn)(vecs[lo:lo + chunk]))
    return jnp.concatenate(outs, axis=0)


def sketch_left(A: LinearOperator, s: int, *, seed: int = 0,
                chunk: int = 64) -> jax.Array:
    """``G A`` for an (s, m) standard Gaussian G, as an (s, n) dense array.

    DenseOperator: one (s, m) x (m, n) matmul. Anything else: each
    row is ``A.rmatvec(g_i)``, evaluated in vmapped chunks."""
    key = jax.random.PRNGKey(seed)
    if isinstance(A, DenseOperator):
        G = jax.random.normal(key, (s, A.m), A.dtype)
        return jnp.matmul(G, A.a, precision=_HIGHEST)
    G = jax.random.normal(key, (s, A.m), A.dtype)
    if jnp.issubdtype(G.dtype, jnp.complexfloating):
        # rmatvec is the ADJOINT product: row i of G A = conj(A^H conj(g_i))
        return jnp.conj(_chunked_rows(A.rmatvec, jnp.conj(G), chunk))
    return _chunked_rows(A.rmatvec, G, chunk)


def sketch_right(A: LinearOperator, s: int, *, seed: int = 0,
                 chunk: int = 64) -> jax.Array:
    """``A G'`` for an (s, n) standard Gaussian G, as an (m, s) dense array
    (stored transposed as the (s, m) row stack of ``A.matvec(g_i)``)."""
    key = jax.random.PRNGKey(seed)
    if isinstance(A, DenseOperator):
        G = jax.random.normal(key, (s, A.n), A.dtype)
        return jnp.matmul(A.a, G.T, precision=_HIGHEST)
    G = jax.random.normal(key, (s, A.n), A.dtype)
    return _chunked_rows(A.matvec, G, chunk).T


class LSRNResult(NamedTuple):
    """Outputs of :func:`lsrn`."""

    x: jax.Array            #: (n,) solution of the original problem
    result: NamedTuple      #: inner solver result (on the preconditioned op)
    N: Optional[jax.Array]  #: (n, r) right preconditioner (m >= n case)
    P: Optional[jax.Array]  #: (r, m) left preconditioner (m < n case)
    rank: int               #: numerical rank used (after rcond truncation)
    cond_bound: float       #: the w.h.p. bound (1+sqrt(r/s))/(1-sqrt(r/s))


def lsrn_preconditioner(
    A,
    *,
    gamma: float = 4.0,
    seed: int = 0,
    rcond: Optional[float] = None,
    chunk: int = 64,
):
    """Build the LSRN right preconditioner ``N = V diag(1/sig)`` for an
    over-determined operator (m >= n). Returns ``(N, rank, cond_bound)``
    with N an (n, r) array; solve ``min ||A N y - b||`` then ``x = N y``.

    ``rcond``: singular values of the sketch below ``rcond * sig_max`` are
    truncated (rank-deficient A) — default matches numpy.linalg.pinv's
    ``s * eps`` heuristic."""
    A = as_operator(A)
    if A.m < A.n:
        raise ValueError("lsrn_preconditioner expects m >= n; "
                         "use lsrn() which handles both orientations")
    s = int(np.ceil(gamma * A.n))
    S = np.asarray(sketch_left(A, s, seed=seed, chunk=chunk))
    N, r = svd_truncated_preconditioner(S, rcond=rcond)
    root = np.sqrt(r / s)
    return jnp.asarray(N, A.dtype), r, float((1 + root) / (1 - root))


def svd_truncated_preconditioner(S, rcond: Optional[float] = None):
    """``N = V diag(1/sig)`` from a sketch matrix ``S``: host SVD +
    rcond truncation (numpy.linalg.pinv's heuristic by default). Shared
    by the f32 device sketch here and refine's f64 host sketch."""
    _, sig, Vt = np.linalg.svd(S, full_matrices=False)
    if rcond is None:
        rcond = max(S.shape) * np.finfo(S.dtype).eps
    r = int(np.sum(sig > rcond * sig[0]))
    # conj-transpose: identity for real sketches, required for complex
    # (lsqr_refined's complex preconditioning path)
    return Vt[:r].conj().T / sig[:r], r


def lsrn(
    A,
    b,
    damp: float = 0.0,
    *,
    gamma: float = 4.0,
    seed: int = 0,
    rcond: Optional[float] = None,
    chunk: int = 64,
    solver: str = "lsqr",
    **opts,
) -> LSRNResult:
    """Solve ``min ||A x - b||`` (or its damped form) with LSQR after LSRN
    randomized preconditioning: iteration count becomes independent of
    cond(A).

    Cost: ceil(gamma * min(m, n)) operator products for the sketch + one
    host SVD of the (s, min(m, n)) sketch + a fixed few tens of
    preconditioned LSQR iterations. Worth it when A is ill-conditioned
    enough that plain LSQR needs (far) more than ~gamma * min(m, n)
    iterations, or when a rank-revealing / minimum-norm solution of a
    rank-deficient problem is required (plain LSQR stagnates there; LSRN
    truncates the rank in the sketch SVD).

    Args:
      damp: as in :func:`lsqr_tpu.lsqr` — handled by stacking
        ``[A; damp I]`` BEFORE sketching (damp does not commute with the
        preconditioner, so it cannot be forwarded to the inner solve).
      gamma: oversampling factor (s = gamma * min(m, n) sketch rows);
        4.0 gives cond(AN) <~ 3 w.h.p.
      rcond: relative singular-value cutoff for rank truncation.
      chunk: sketch products per vmapped batch (memory bound).
      solver: inner solver — 'lsqr' (default), 'lsmr' or 'cgls'.
      **opts: forwarded to the inner solver (atol, btol, itnlim, ...).

    Returns an :class:`LSRNResult`; ``result.result`` carries the inner
    solver's istop/itn/norm estimates (on the PRECONDITIONED operator —
    its acond estimate should sit near ``cond_bound``, not near cond(A)).
    """
    A = as_operator(A)
    b = jnp.asarray(b)
    if solver == "lsqr":
        from .solver import lsqr as _solve
    elif solver == "lsmr":
        from .lsmr import lsmr as _solve
    elif solver == "cgls":
        from .cgls import cgls as _solve
    else:
        raise ValueError(f"unknown solver {solver!r}")

    if damp != 0.0:
        # stack [A; damp*I]: the damped problem IS this undamped one
        # (lsqr.f90:264-273); damp must enter before the sketch.
        eye = DenseOperator(jnp.eye(A.n, dtype=A.dtype))
        A = vstack_operators([A, scale_operator(eye, jnp.asarray(damp, A.dtype))])
        b = jnp.concatenate([b, jnp.zeros((A.n,), b.dtype)])

    if A.m >= A.n:
        N, r, bound = lsrn_preconditioner(A, gamma=gamma, seed=seed,
                                          rcond=rcond, chunk=chunk)
        B = ComposedOperator(outer=A, inner=DenseOperator(N))
        res = _solve(B, b, **opts)
        x = jnp.matmul(N, res.x, precision=_HIGHEST)
        return LSRNResult(x=x, result=res, N=N, P=None, rank=r,
                          cond_bound=bound)

    # under-determined: sketch from the right, precondition from the left
    s = int(np.ceil(gamma * A.m))
    S = np.asarray(sketch_right(A, s, seed=seed, chunk=chunk))  # (m, s)
    U, sig, _ = np.linalg.svd(S, full_matrices=False)
    if rcond is None:
        rcond = max(S.shape) * np.finfo(S.dtype).eps
    r = int(np.sum(sig > rcond * sig[0]))
    # P = diag(1/sig) U^H — conj-transpose for complex (identity for real)
    P = jnp.asarray(U[:, :r].conj().T / sig[:r, None], A.dtype)   # (r, m)
    B = ComposedOperator(outer=DenseOperator(P), inner=A)  # (r, n)
    res = _solve(B, jnp.matmul(P, b, precision=_HIGHEST), **opts)
    root = np.sqrt(r / s)
    return LSRNResult(x=res.x, result=res, N=None, P=P, rank=r,
                      cond_bound=float((1 + root) / (1 - root)))
