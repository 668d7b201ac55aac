"""Every float32 matrix product that feeds a solver asks for full precision
(``Precision.HIGHEST``): on the GPU an f32 product may otherwise run in
TF32, which keeps about three decimal digits. Checked on the traced
programs, so it holds on the CPU too."""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.hybrid import golub_kahan
from lsqr_tpu.randomized import sketch_left, sketch_right
from lsqr_tpu.solver import _lsqr_impl

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(fn, *args):
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _assert_highest(fn, *args):
    precs = _dot_precisions(fn, *args)
    assert precs, "no matrix product traced"
    for p in precs:
        assert p is not None and all(q == HIGHEST for q in p), precs


@pytest.fixture
def dense(rng):
    return lt.DenseOperator(jnp.asarray(
        rng.standard_normal((48, 32)).astype(np.float32)))


@pytest.fixture
def bell(rng):
    from lsqr_tpu.models.synthetic import block_banded_coo

    vals, rows, cols = block_banded_coo(64, 64, block=16, band_blocks=1,
                                        dtype=np.float32)
    return lt.block_ell_operator(64, 64, vals, rows, cols, block=(16, 16))


def test_dense_matvec(dense):
    _assert_highest(dense.matvec, jnp.ones(32, jnp.float32))


def test_dense_rmatvec(dense):
    _assert_highest(dense.rmatvec, jnp.ones(48, jnp.float32))


def test_block_ell_matvec(bell):
    _assert_highest(bell.matvec, jnp.ones(64, jnp.float32))


def test_block_ell_rmatvec(bell):
    _assert_highest(bell.rmatvec, jnp.ones(64, jnp.float32))


def test_block_ell_fused_pair(bell):
    x = jnp.ones(64, jnp.float32)
    _assert_highest(lambda x: bell.fused_pair(y=x, win=x, c1=1.0, c2=0.5), x)


def test_sketch_left_dense(dense):
    _assert_highest(lambda: sketch_left(dense, 8))


def test_sketch_right_dense(dense):
    _assert_highest(lambda: sketch_right(dense, 8))


def test_golub_kahan_reorthogonalization(dense):
    b = jnp.ones(48, jnp.float32)
    _assert_highest(lambda b: golub_kahan(dense, b, 4, reorth=True).V, b)


def test_lsqr_on_dense_operator(dense):
    b = jnp.ones(48, jnp.float32)
    z = jnp.zeros((), jnp.float32)

    def solve(b):
        return _lsqr_impl(dense, b, z, z, z, z, itnlim=5, wantse=False,
                          nconv=1, record_trace=False, safe_norms=True,
                          debug_log=False).x

    _assert_highest(solve, b)


def test_lsrn_solution_map(rng):
    """lsrn maps the preconditioned solution back (x = N y) at full
    precision: its f32 answer matches float64 lstsq closely."""
    a = rng.standard_normal((200, 40)).astype(np.float32)
    b = rng.standard_normal(200).astype(np.float32)
    res = lt.lsrn(lt.DenseOperator(jnp.asarray(a)), jnp.asarray(b),
                  atol=1e-7, btol=1e-7)
    ref = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                          rcond=None)[0]
    assert np.linalg.norm(np.asarray(res.x) - ref) <= 1e-4 * np.linalg.norm(ref)
