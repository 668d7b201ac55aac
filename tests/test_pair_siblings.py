"""Pair-fused product path for the sibling solvers (LSMR, CRAIG, CGLS):
the same dia_pair stripe pass drives their bidiagonalization / CG steps.
LSMR and CRAIG consume it with normalized carries (z/beta commutes);
CGLS (opt-in) maintains A'r by the exact recurrence A'r -= alpha A'q."""

import jax.numpy as jnp
import numpy as np
import pytest

from lsqr_tpu import cgls, craig, lsmr
from lsqr_tpu.ops.structured import dia_operator


def _banded(rng, m, n, offsets, dom=6.0):
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    if 0 in offsets:
        data[offsets.index(0)] += dom
    return dia_operator(m, n, offsets, data)


def test_lsmr_pair_matches(rng):
    m = n = 2500
    A = _banded(rng, m, n, (-2, -1, 0, 1, 3))
    b = rng.standard_normal(m).astype(np.float32)
    ref = lsmr(A, b, 0.01, atol=1e-6, btol=1e-6)
    res = lsmr(A, b, 0.01, atol=1e-6, btol=1e-6, pair=True)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2
    scale = float(jnp.max(jnp.abs(ref.x))) + 1e-30
    assert float(jnp.max(jnp.abs(res.x - ref.x))) / scale < 1e-4


def test_lsmr_pair_rect(rng):
    m, n = 3000, 1800
    A = _banded(rng, m, n, (-1, 0, 2))
    b = rng.standard_normal(m).astype(np.float32)
    ref = lsmr(A, b, 0.1, atol=1e-6, btol=1e-6)
    res = lsmr(A, b, 0.1, atol=1e-6, btol=1e-6, pair=True)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2
    scale = float(jnp.max(jnp.abs(ref.x))) + 1e-30
    assert float(jnp.max(jnp.abs(res.x - ref.x))) / scale < 1e-4


def test_craig_pair_matches(rng):
    # CRAIG needs a consistent system: build b = A xt
    m = n = 2000
    A = _banded(rng, m, n, (-1, 0, 1), dom=5.0)
    xt = rng.standard_normal(n).astype(np.float32)
    b = np.asarray(A.matvec(jnp.asarray(xt)))
    ref = craig(A, b, atol=1e-7, btol=1e-7)
    res = craig(A, b, atol=1e-7, btol=1e-7, pair=True)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2
    scale = float(jnp.max(jnp.abs(ref.x))) + 1e-30
    assert float(jnp.max(jnp.abs(res.x - ref.x))) / scale < 1e-4


def test_cgls_pair_opt_in(rng):
    m = n = 2000
    A = _banded(rng, m, n, (-1, 0, 1), dom=5.0)
    b = rng.standard_normal(m).astype(np.float32)
    ref = cgls(A, b, 0.05, atol=1e-6, btol=1e-6)
    res = cgls(A, b, 0.05, atol=1e-6, btol=1e-6, pair=True)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 3
    scale = float(jnp.max(jnp.abs(ref.x))) + 1e-30
    assert float(jnp.max(jnp.abs(res.x - ref.x))) / scale < 5e-4


def test_cgls_pair_recurrence_quality(rng):
    """The A'r recurrence must stay an accurate optimality residual: the
    pair solve's final arnorm, recomputed directly, agrees."""
    m, n = 2400, 1600
    A = _banded(rng, m, n, (-1, 0, 2))
    b = rng.standard_normal(m).astype(np.float32)
    res = cgls(A, b, 0.0, atol=1e-6, btol=1e-6, pair=True)
    r = jnp.asarray(b) - A.matvec(res.x)
    direct = float(jnp.linalg.norm(A.rmatvec(r)))
    assert abs(direct - float(res.arnorm)) <= 1e-2 * (direct + 1e-6) + 1e-3


def test_pair_unsupported_raises(rng):
    from lsqr_tpu.ops.coo import coo_operator

    A = coo_operator(3, 3, np.ones(3, np.float32),
                     np.arange(3), np.arange(3))
    b = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="fused_pair"):
        lsmr(A, b, pair=True)
    with pytest.raises(ValueError, match="fused_pair"):
        craig(A, b, pair=True)
    with pytest.raises(ValueError, match="fused_pair"):
        cgls(A, b, pair=True)


def test_damped_warm_start_all_solvers(rng):
    """x0 warm start with damp > 0 (beyond the reference's undamped
    recipe): lands on the same damped solution via the stacked form."""
    import jax.numpy as jnp

    from lsqr_tpu import cgls, lsmr, lsqr

    m, n = 150, 90
    Ad = rng.standard_normal((m, n)).astype(np.float32)
    A = jnp.asarray(Ad)
    b = rng.standard_normal(m).astype(np.float32)
    damp = 0.3
    for solver, kw in [(lsqr, {}), (lsmr, {}), (cgls, {})]:
        ref = solver(A, b, damp, atol=1e-7, btol=1e-7)
        x0 = np.asarray(ref.x) + 0.05 * rng.standard_normal(n).astype(
            np.float32)
        res = solver(A, b, damp, x0=x0, atol=1e-7, btol=1e-7)
        err = float(jnp.max(jnp.abs(res.x - ref.x)))
        assert err < 1e-4, (solver.__name__, err)
    # lsqr damped istop semantics survive the mapping
    reslq = lsqr(A, b, damp, x0=np.zeros(n, np.float32),
                 atol=1e-7, btol=1e-7)
    assert int(reslq.istop) == 3
