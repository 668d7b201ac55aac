"""CGLS conformance: against numpy's lstsq oracle, the damped closed form,
lsqr's iterates (same Krylov space), and the bounded-loop/Pallas path.

Reference anchors: CGLS is the method the reference's paper benchmarks
LSQR against (Paige & Saunders 1982 §9); the stopping-test shapes mirror
lsqr.f90:781-810.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lsqr_tpu as lt
from lsqr_tpu.ops.linop import as_operator


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _dense_problem(rng, m, n):
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    return A, b


@pytest.mark.parametrize("m,n", [(300, 120), (120, 120), (120, 300)])
def test_cgls_matches_lstsq(rng, m, n):
    A, b = _dense_problem(rng, m, n)
    res = lt.cgls(as_operator(jnp.asarray(A)), jnp.asarray(b),
                  atol=1e-12, btol=1e-12)
    if m >= n:
        xs, *_ = np.linalg.lstsq(A, b, rcond=None)
        np.testing.assert_allclose(np.asarray(res.x), xs, atol=1e-8)
    # optimality residual must be tiny in every shape regime
    r = b - A @ np.asarray(res.x)
    assert np.abs(A.T @ r).max() < 1e-7
    assert int(res.istop) in (1, 2)


def test_cgls_damped_matches_closed_form(rng):
    m, n, damp = 200, 80, 0.3
    A, b = _dense_problem(rng, m, n)
    res = lt.cgls(as_operator(jnp.asarray(A)), jnp.asarray(b), damp,
                  atol=1e-13, btol=1e-13)
    x_exact = np.linalg.solve(A.T @ A + damp**2 * np.eye(n), A.T @ b)
    np.testing.assert_allclose(np.asarray(res.x), x_exact, atol=1e-9)
    # rnorm is the damped residual sqrt(||Ax-b||^2 + damp^2 ||x||^2)
    r = b - A @ x_exact
    expect = np.sqrt(r @ r + damp**2 * (x_exact @ x_exact))
    np.testing.assert_allclose(float(res.rnorm), expect, rtol=1e-8)


def test_cgls_tracks_lsqr(rng):
    """Same Krylov space: iteration counts within a few, same solution."""
    m, n = 400, 150
    A, b = _dense_problem(rng, m, n)
    op = as_operator(jnp.asarray(A))
    bj = jnp.asarray(b)
    rc = lt.cgls(op, bj, atol=1e-10, btol=1e-10)
    rl = lt.lsqr(op, bj, atol=1e-10, btol=1e-10)
    np.testing.assert_allclose(np.asarray(rc.x), np.asarray(rl.x), atol=1e-7)
    assert abs(int(rc.itn) - int(rl.itn)) <= 6


def test_cgls_istop_paths(rng):
    m, n = 60, 30
    A, b = _dense_problem(rng, m, n)
    op = as_operator(jnp.asarray(A))
    # b = 0 -> x = 0, istop 0, no iterations
    r0 = lt.cgls(op, jnp.zeros((m,)))
    assert int(r0.istop) == 0 and int(r0.itn) == 0
    assert float(r0.xnorm) == 0.0
    # iteration limit
    r5 = lt.cgls(op, jnp.asarray(b), atol=0.0, btol=0.0, itnlim=3)
    assert int(r5.istop) == 5 and int(r5.itn) == 3
    # compatible square system -> istop 1
    As = rng.standard_normal((n, n)) + 4.0 * np.eye(n)
    xt = rng.standard_normal(n)
    r1 = lt.cgls(as_operator(jnp.asarray(As)), jnp.asarray(As @ xt),
                 atol=1e-12, btol=1e-10)
    assert int(r1.istop) == 1
    np.testing.assert_allclose(np.asarray(r1.x), xt, atol=1e-6)


def test_cgls_x0_warm_start(rng):
    m, n = 200, 90
    A, b = _dense_problem(rng, m, n)
    op = as_operator(jnp.asarray(A))
    xs, *_ = np.linalg.lstsq(A, b, rcond=None)
    x0 = xs + 0.01 * rng.standard_normal(n)
    res = lt.cgls(op, jnp.asarray(b), x0=jnp.asarray(x0),
                  atol=1e-12, btol=1e-12)
    np.testing.assert_allclose(np.asarray(res.x), xs, atol=1e-8)
    cold = lt.cgls(op, jnp.asarray(b), atol=1e-12, btol=1e-12)
    assert int(res.itn) <= int(cold.itn)
    # damped warm start (stacked undamped form)
    refd = lt.cgls(op, jnp.asarray(b), 0.1, atol=1e-12, btol=1e-12)
    resd = lt.cgls(op, jnp.asarray(b), 0.1, x0=refd.x, atol=1e-10,
                   btol=1e-10)
    np.testing.assert_allclose(np.asarray(resd.x), np.asarray(refd.x),
                               atol=1e-8)
    assert int(resd.itn) <= 3


def test_cgls_bounded_loop_matches_while(rng):
    m = n = 512
    offs = (-2, -1, 0, 1, 2)
    stripes = rng.standard_normal((len(offs), m)) + 3.0
    A = lt.dia_operator(m, n, offs, stripes.astype(np.float64))
    b = jnp.asarray(rng.standard_normal(m))
    rw = lt.cgls(A, b, atol=1e-10, btol=1e-10, loop="while")
    rb = lt.cgls(A, b, atol=1e-10, btol=1e-10, loop="bounded",
                 loop_segment=16)
    assert int(rw.istop) == int(rb.istop) and int(rw.itn) == int(rb.itn)
    np.testing.assert_allclose(np.asarray(rw.x), np.asarray(rb.x),
                               rtol=0, atol=0)  # bit-identical masked form


def test_cgls_anorm_is_lower_bound(rng):
    m, n = 300, 100
    A, b = _dense_problem(rng, m, n)
    res = lt.cgls(as_operator(jnp.asarray(A)), jnp.asarray(b),
                  atol=1e-10, btol=1e-10)
    true_norm = np.linalg.norm(A, 2)
    assert 0 < float(res.anorm) <= true_norm * (1 + 1e-10)
    # after a full solve the Rayleigh bound should be a decent estimate
    assert float(res.anorm) > 0.3 * true_norm


def test_cgls_vmaps(rng):
    """The while-loop form is a pure jittable function of b — multi-RHS
    via plain jax.vmap (the lsqr-specific batcher is lsqr_batch)."""
    m, n = 120, 60
    A_np, _ = _dense_problem(rng, m, n)
    op = as_operator(jnp.asarray(A_np))
    B = jnp.asarray(rng.standard_normal((5, m)))

    solve = jax.vmap(lambda b: lt.cgls(op, b, atol=0.0, btol=0.0,
                                       itnlim=30).x)
    X = solve(B)
    for i in range(5):
        seq = lt.cgls(op, B[i], atol=0.0, btol=0.0, itnlim=30)
        np.testing.assert_allclose(np.asarray(X[i]), np.asarray(seq.x),
                                   rtol=1e-9, atol=1e-12)
