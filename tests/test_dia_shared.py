"""Shared-stripe DIA operator: one padded array serves both products —
half the memory of the packed DIAOperator. Equivalence against the packed
operator (itself COO-equivalence-tested) and the dense oracle.

Reference anchor: the two aprod modes over one COO triple,
lsqr.f90:156-194 — here one stripe array over both directions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lsqr_tpu as lt
from lsqr_tpu.ops.structured import (dia_operator, dia_shared_operator,
                                     shared_geometry)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


CASES = [
    (300, 300, (-2, -1, 0, 1, 2)),
    (200, 330, (-3, 0, 7, 60)),
    (330, 200, (-60, -3, 0, 5)),
    (257, 129, (0,)),           # ragged, single diagonal
]


@pytest.mark.parametrize("m,n,ks", CASES)
def test_shared_matches_packed_xla(rng, m, n, ks):
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    As = dia_shared_operator(m, n, ks, data)
    Ap = dia_operator(m, n, ks, data)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    y = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(As.matvec(x)),
                                  np.asarray(Ap.matvec(x)))
    np.testing.assert_array_equal(np.asarray(As.rmatvec(y)),
                                  np.asarray(Ap.rmatvec(y)))
    np.testing.assert_array_equal(np.asarray(As.todense()),
                                  np.asarray(Ap.todense()))


@pytest.mark.parametrize("m,n,ks", CASES)
def test_shared_pallas_kernel_interpret(rng, m, n, ks):
    """The shared layout's geometry and its XLA products vs the dense
    oracle: every stripe holds ``dp[d, H + i] = A[i, i + k_d]`` and is zero
    elsewhere."""
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    A = np.asarray(dia_operator(m, n, ks, data).todense())
    op = dia_shared_operator(m, n, ks, data)
    H, Lp = shared_geometry(ks, m, n)
    assert (op.H, op.Lp) == (H, Lp)
    assert H == max(max(ks), -min(ks), 0) and Lp >= 2 * H + max(m, n)
    assert Lp % 1024 == 0
    dp = np.asarray(op.dp).reshape(len(ks), Lp)
    i = np.arange(m)
    for d, k in enumerate(ks):
        valid = (i + k >= 0) & (i + k < n)
        np.testing.assert_array_equal(dp[d, H:H + m], data[d] * valid)
        assert not dp[d, :H].any() and not dp[d, H + m:].any()
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.matvec(jnp.asarray(x))), A @ x,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(y))),
                               A.T @ y, atol=2e-5)


def test_shared_solve_bit_identical_to_packed(rng):
    m = n = 400
    ks = (-2, -1, 0, 1, 2)
    data = rng.standard_normal((5, m)).astype(np.float32)
    data[2] += 6.0  # diagonally dominant -> well-conditioned
    As = dia_shared_operator(m, n, ks, data)
    Ap = dia_operator(m, n, ks, data)
    b = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    rs = lt.lsqr(As, b, 0.05, itnlim=30, atol=0.0, btol=0.0, conlim=0.0)
    rp = lt.lsqr(Ap, b, 0.05, itnlim=30, atol=0.0, btol=0.0, conlim=0.0)
    assert int(rs.itn) == int(rp.itn)
    np.testing.assert_array_equal(np.asarray(rs.x), np.asarray(rp.x))
    # the sibling solvers run on it too
    rl = lt.lsmr(As, b, atol=1e-6, btol=1e-6)
    rg = lt.cgls(As, b, atol=1e-6, btol=1e-6)
    np.testing.assert_allclose(np.asarray(rl.x), np.asarray(rg.x),
                               rtol=1e-3, atol=1e-4)


def test_shared_memory_is_half(rng):
    """The advertised capacity win: stored bytes ~half the packed pair."""
    m = n = 100_000
    ks = tuple(range(-5, 6))
    data = rng.standard_normal((len(ks), m)).astype(np.float32)
    As = dia_shared_operator(m, n, ks, data)
    Ap = dia_operator(m, n, ks, data)
    shared = As.dp.nbytes
    packed = Ap.data.nbytes + Ap.tdata.nbytes
    assert shared < 0.55 * packed  # halo + rounding amortize at scale


def test_shared_acheck_and_bf16(rng):
    from lsqr_tpu.diagnostics import acheck

    m, n = 500, 300
    ks = (-4, 0, 3)
    data = rng.standard_normal((3, m)).astype(np.float32)
    As = dia_shared_operator(m, n, ks, data)
    assert int(acheck(As).inform) == 0
    Abf = dia_shared_operator(m, n, ks, data, storage_dtype="bfloat16")
    assert Abf.is_bf16_storage and Abf.dtype == jnp.float32
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    ref = As.matvec(x)
    out = Abf.matvec(x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-2, atol=2e-2)


def test_shared_fused_halfstep_path(rng):
    """fused=True on the shared operator (plain-XLA half-steps) matches the
    packed XLA solve at matched iteration counts; the fused form is never
    auto-selected."""
    m = n = 600
    ks = (-2, -1, 0, 1, 2)
    data = rng.standard_normal((5, m)).astype(np.float32)
    data[2] += 5.0
    As = dia_shared_operator(m, n, ks, data)
    assert not getattr(As, "prefers_fused", False)
    assert not hasattr(As, "prefers_bounded_loop")
    Ap = dia_operator(m, n, ks, data)
    b = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    rs = lt.lsqr(As, b, 0.05, itnlim=25, atol=0.0, btol=0.0, conlim=0.0,
                 fused=True)
    rp = lt.lsqr(Ap, b, 0.05, itnlim=25, atol=0.0, btol=0.0, conlim=0.0)
    assert int(rs.itn) == int(rp.itn)
    np.testing.assert_allclose(np.asarray(rs.x), np.asarray(rp.x),
                               rtol=1e-5, atol=1e-6)


def test_shared_axpy_kernel_oracle(rng):
    """The shared operator's product + axpy half-step vs the dense oracle,
    both directions, rectangular + one-sided offsets."""
    for (m, n, ks) in [(300, 300, (-2, -1, 0, 1, 2)),
                       (200, 330, (-3, 0, 7, 60)),
                       (330, 200, (-60, -3, 0, 5))]:
        data = rng.standard_normal((len(ks), m)).astype(np.float32)
        As = dia_shared_operator(m, n, ks, data)
        A = np.asarray(dia_operator(m, n, ks, data).todense())
        x = rng.standard_normal(n).astype(np.float32)
        y = rng.standard_normal(m).astype(np.float32)
        c1, c2 = 0.7, 1.3
        fw, _ = As.fused_halfstep(forward=True, y=jnp.asarray(y),
                                  win=jnp.asarray(x), c1=c1, c2=c2)
        np.testing.assert_allclose(np.asarray(fw), A @ (x * c1) - c2 * y,
                                   atol=3e-5)
        aj, _ = As.fused_halfstep(forward=False, y=jnp.asarray(x),
                                  win=jnp.asarray(y), c1=c1, c2=c2)
        np.testing.assert_allclose(np.asarray(aj), A.T @ (y * c1) - c2 * x,
                                   atol=3e-5)
