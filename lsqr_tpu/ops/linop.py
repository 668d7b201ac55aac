"""Linear-operator layer — the functional replacement for the reference's
``aprod`` callback protocol (/root/reference/src/lsqr.f90:67-82).

The reference accesses A only through a user subroutine with two imperative
modes: mode 1 accumulates ``y := y + A x``, mode 2 accumulates
``x := x + A' y``. In a functional JAX design the accumulation is an
implementation detail of the caller, so the protocol here is two pure
products:

    matvec(x)  -> A  @ x     (shape (m,))
    rmatvec(y) -> A' @ y     (shape (n,))

Implementations register as pytrees so operators flow through ``jax.jit`` /
``shard_map`` with their arrays as leaves and their shapes as static aux data.

``axis_name_m`` is the multi-device hook with no reference analogue
(the reference is serial, SURVEY.md §2.2): when an operator's rows (and hence
u-vectors) are sharded over a mesh axis inside ``shard_map``, the solver
completes m-dimension reductions (norms of u) with collectives over that
axis. Operators whose ``rmatvec`` needs a reduction perform it internally.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

__all__ = ["LinearOperator", "DenseOperator", "CallbackOperator", "as_operator"]


class LinearOperator:
    """Abstract base. Subclasses must define m, n, dtype, matvec, rmatvec.

    This is the analogue of the abstract ``lsqr_solver`` class's deferred
    ``aprod`` binding (lsqr.f90:16-30) — extend it to bring your own operator.
    """

    #: number of rows of A
    m: int
    #: number of columns of A
    n: int
    #: mesh axis name(s) over which rows/u are sharded (None = unsharded)
    axis_name_m = None

    @property
    def shape(self):
        return (self.m, self.n)

    def matvec(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def rmatvec(self, y: jax.Array) -> jax.Array:
        raise NotImplementedError

    @property
    def T(self) -> "LinearOperator":
        """The adjoint operator: swaps matvec/rmatvec. Since ``rmatvec`` is
        the conjugate-transpose product for complex operators, ``T`` is the
        Hermitian adjoint A^H there (and the plain transpose for real)."""
        return _TransposedOperator(op=self)

    def todense(self) -> jax.Array:
        """Materialize A (testing convenience; O(m*n) memory)."""
        eye = jnp.eye(self.n, dtype=self.dtype)
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(eye)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Dense A — one matrix-vector product (jnp.dot, full float32
    precision: no TF32). The fastest path whenever A fits in device
    memory densely; useful for small systems and as the
    ground-truth oracle in tests."""

    a: jax.Array

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.a.shape[0]

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.a.shape[1]

    @property
    def dtype(self):
        return self.a.dtype

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.dot(self.a, x, preferred_element_type=self.a.dtype,
                       precision=jax.lax.Precision.HIGHEST)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        # adjoint product (A^H y): conjugate transpose for complex matrices,
        # plain transpose for real (conj is the identity XLA elides)
        at = (
            jnp.conj(self.a.T)
            if jnp.issubdtype(self.a.dtype, jnp.complexfloating)
            else self.a.T
        )
        return jnp.dot(at, y, preferred_element_type=self.a.dtype,
                       precision=jax.lax.Precision.HIGHEST)

    def todense(self) -> jax.Array:
        return self.a


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _TransposedOperator(LinearOperator):
    op: LinearOperator

    @property
    def m(self) -> int:  # type: ignore[override]
        return self.op.n

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.op.m

    @property
    def dtype(self):
        return self.op.dtype

    def matvec(self, x):
        return self.op.rmatvec(x)

    def rmatvec(self, y):
        return self.op.matvec(y)


@dataclasses.dataclass(frozen=True)
class CallbackOperator(LinearOperator):
    """Bring-your-own matvec/rmatvec — the direct functional analogue of
    extending ``lsqr_solver`` with a custom ``aprod`` (lsqr.f90:16-30 and the
    test harness's implicit HY*D*HZ operator, lsqrtest_module.f90:35-44).

    The callables must be jit-traceable pure functions.
    """

    m: int
    n: int
    _matvec: Callable[[jax.Array], jax.Array]
    _rmatvec: Callable[[jax.Array], jax.Array]
    dtype: jnp.dtype = None  # type: ignore[assignment]
    axis_name_m: Optional[str] = None

    def matvec(self, x):
        return self._matvec(x)

    def rmatvec(self, y):
        return self._rmatvec(y)


# CallbackOperator holds callables, which are static — register everything as
# aux data so it passes through jit boundaries unhashed-array-free.
jax.tree_util.register_pytree_node(
    CallbackOperator,
    lambda op: ((), (op.m, op.n, op._matvec, op._rmatvec, op.dtype, op.axis_name_m)),
    lambda aux, _: CallbackOperator(*aux),
)


def as_operator(a, m: Optional[int] = None, n: Optional[int] = None) -> LinearOperator:
    """Coerce common inputs to a LinearOperator.

    Accepts an existing operator, a dense 2-D array, or a
    (matvec, rmatvec) pair with explicit m, n.
    """
    if isinstance(a, LinearOperator):
        return a
    if callable(a):
        raise TypeError(
            "pass (matvec, rmatvec) as a tuple together with m and n, "
            "or build a CallbackOperator directly"
        )
    if isinstance(a, (tuple, list)) and len(a) == 2 and callable(a[0]):
        if m is None or n is None:
            raise ValueError("m and n are required for a (matvec, rmatvec) pair")
        return CallbackOperator(m=m, n=n, _matvec=a[0], _rmatvec=a[1])
    arr = jnp.asarray(a)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D array, got shape {arr.shape}")
    return DenseOperator(a=arr)
