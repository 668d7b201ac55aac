"""Fused product-PAIR kernel: one stripe pass computing both products of
the bidiagonalization step (lsqr.f90:681-694) —

    u_new = A (v*c1) - c2*u      and      z = A' u_new

so the stripes are read ONCE per LSQR iteration instead of twice. The
Triton pair kernel (interpret mode) across geometries against a dense
oracle, plus end-to-end solver equivalence with the generic path
(pair=True vs default)."""

import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.ops.structured import dia_operator, dia_shared_operator
from lsqr_tpu.ops.triton_pair import dia_pair_triton


def dia_pair(data, y, v, c1, c2, *, offsets, m, n, tm=1024, storage=None):
    """The Triton pair in interpret mode on the shared layout of ``data``;
    the tile grows to cover the halo when the offsets are wider than it."""
    op = dia_shared_operator(m, n, offsets, data, storage_dtype=storage)
    tile = max(tm, 1 << max(op.H - 1, 0).bit_length())
    return dia_pair_triton(op.dp, v, y, c1, c2, offsets=offsets, m=m, n=n,
                           H=op.H, tile=tile, interpret=True)


def _dense_from_offsets(rng, m, n, offsets):
    nd = len(offsets)
    data = np.zeros((nd, m), np.float32)
    A = np.zeros((m, n), np.float32)
    i = np.arange(m)
    for d, k in enumerate(offsets):
        j = i + k
        valid = (j >= 0) & (j < n)
        vals = rng.standard_normal(m).astype(np.float32) * valid
        data[d] = vals
        A[i[valid], j[valid]] = vals[valid]
    return data, A


@pytest.mark.parametrize(
    "m,n,offsets,tm",
    [
        (4096, 4096, (-2, -1, 0, 1, 2), 1024),   # square, aligned tiles
        (5000, 5000, (-3, 0, 5), 1024),           # ragged last tile
        (3000, 2000, (-5, -1, 0, 2), 1024),       # over-determined
        (2000, 3000, (0, 1, 900), 1024),          # under-determined, wide k
        (2048, 2048, (-1500, 0, 1500), 1024),     # offsets wider than tile
        (1024, 1024, (0,), 1024),                 # single tile
        (5000, 4000, (-4000, -1, 0), 1024),       # lo > tm
    ],
)
def test_dia_pair_kernel(rng, m, n, offsets, tm):
    data, A = _dense_from_offsets(rng, m, n, offsets)
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    c1, c2 = 0.7, 1.3
    u_ref = A @ (v * np.float32(c1)) - np.float32(c2) * y
    z_ref = A.T @ u_ref
    u, z = dia_pair(
        jnp.asarray(data), jnp.asarray(y), jnp.asarray(v), c1, c2,
        offsets=offsets, m=m, n=n, tm=tm,
    )
    scale_u = np.abs(u_ref).max() + 1e-30
    scale_z = np.abs(z_ref).max() + 1e-30
    assert np.abs(np.asarray(u) - u_ref).max() / scale_u < 5e-6
    assert np.abs(np.asarray(z) - z_ref).max() / scale_z < 5e-6


def test_dia_pair_bf16_storage(rng):
    m = n = 2048
    offsets = (-1, 0, 3)
    data, A = _dense_from_offsets(rng, m, n, offsets)
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    data16 = jnp.asarray(data).astype(jnp.bfloat16)
    u, z = dia_pair(
        jnp.asarray(data), jnp.asarray(y), jnp.asarray(v), 1.0, 0.5,
        offsets=offsets, m=m, n=n, tm=1024, storage=jnp.bfloat16,
    )
    assert u.dtype == jnp.float32 and z.dtype == jnp.float32
    A16 = np.asarray(data16.astype(jnp.float32))
    dataf = A16  # bf16-rounded stripes, f32 compute
    Af = np.zeros((m, n), np.float32)
    i = np.arange(m)
    for d, k in enumerate(offsets):
        j = i + k
        valid = (j >= 0) & (j < n)
        Af[i[valid], j[valid]] = dataf[d][valid]
    u_ref = Af @ v - np.float32(0.5) * y
    z_ref = Af.T @ u_ref
    assert np.abs(np.asarray(u) - u_ref).max() / (np.abs(u_ref).max()) < 1e-5
    assert np.abs(np.asarray(z) - z_ref).max() / (np.abs(z_ref).max()) < 1e-5


def _solve_pair_vs_ref(rng, m, n, offsets, damp, **kw):
    nd = len(offsets)
    data = rng.standard_normal((nd, m)).astype(np.float32)
    if 0 in offsets:
        data[offsets.index(0)] += 6.0
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m).astype(np.float32)
    ref = lt.lsqr(A, b, damp, atol=1e-6, btol=1e-6, **kw)
    res = lt.lsqr(A, b, damp, atol=1e-6, btol=1e-6, pair=True, **kw)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2
    scale = float(jnp.max(jnp.abs(ref.x))) + 1e-30
    assert float(jnp.max(jnp.abs(res.x - ref.x))) / scale < 1e-4
    return ref, res


def test_pair_solver_square(rng):
    _solve_pair_vs_ref(rng, 3000, 3000, (-2, -1, 0, 1, 3), 0.01)


def test_pair_solver_rect_damped_wantse(rng):
    ref, res = _solve_pair_vs_ref(
        rng, 2500, 1500, (-1, 0, 2), 0.1, wantse=True
    )
    np.testing.assert_allclose(
        np.asarray(res.se), np.asarray(ref.se), rtol=5e-2, atol=1e-5
    )


def test_pair_solver_underdetermined(rng):
    _solve_pair_vs_ref(rng, 1500, 2400, (-1, 0, 2), 0.0)


def test_pair_bounded_loop(rng):
    m = n = 2000
    offsets = (-1, 0, 1)
    data = rng.standard_normal((3, m)).astype(np.float32)
    data[1] += 5.0
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m).astype(np.float32)
    ref = lt.lsqr(A, b, 0.0, atol=1e-6, btol=1e-6, pair=True)
    res = lt.lsqr(A, b, 0.0, atol=1e-6, btol=1e-6, pair=True,
                  loop="bounded", loop_segment=16)
    assert int(res.istop) == int(ref.istop)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_pair_requires_capable_operator(rng):
    from lsqr_tpu.ops.coo import coo_operator

    rows = np.array([0, 1, 2]); cols = np.array([0, 1, 2])
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    A = coo_operator(3, 3, vals, rows, cols)
    with pytest.raises(ValueError, match="fused_pair"):
        lt.lsqr(A, np.ones(3, np.float32), pair=True)


@pytest.mark.parametrize(
    "m,n,offsets",
    [
        (4096, 4096, (-2, -1, 0, 1, 2)),
        (5000, 5000, (-3, 0, 5)),        # ragged last tile
        (3000, 2000, (-5, -1, 0, 2)),    # over-determined
        (2000, 3000, (0, 1, 7)),         # under-determined
    ],
)
def test_dia_pair_shared_kernel(rng, m, n, offsets):
    """The Triton pair at its default tile, straight from the operator's
    shared stripes."""
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    i = np.arange(m)
    A = np.zeros((m, n), np.float32)
    for d, k in enumerate(offsets):
        j = i + k
        valid = (j >= 0) & (j < n)
        data[d] *= valid
        A[i[valid], j[valid]] = data[d][valid]
    op = dia_shared_operator(m, n, offsets, data)
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    c1, c2 = 0.8, 1.1
    u_ref = A @ (v * np.float32(c1)) - np.float32(c2) * y
    z_ref = A.T @ u_ref
    u, z = dia_pair_triton(
        op.dp, jnp.asarray(v), jnp.asarray(y), c1, c2,
        offsets=offsets, m=m, n=n, H=op.H, interpret=True,
    )
    assert np.abs(np.asarray(u) - u_ref).max() / (np.abs(u_ref).max()) < 5e-6
    assert np.abs(np.asarray(z) - z_ref).max() / (np.abs(z_ref).max()) < 5e-6


def test_pair_shared_solver(rng):
    from lsqr_tpu.ops.structured import dia_shared_operator

    m = n = 3000
    offsets = (-2, -1, 0, 1, 3)
    data = rng.standard_normal((5, m)).astype(np.float32)
    data[2] += 6.0
    op = dia_shared_operator(m, n, offsets, data)
    b = rng.standard_normal(m).astype(np.float32)
    ref = lt.lsqr(op, b, 0.01, atol=1e-6, btol=1e-6)
    res = lt.lsqr(op, b, 0.01, atol=1e-6, btol=1e-6, pair=True)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2
    scale = float(jnp.max(jnp.abs(ref.x))) + 1e-30
    assert float(jnp.max(jnp.abs(res.x - ref.x))) / scale < 1e-4


def test_pair_trace_matches(rng):
    """The recorded iteration trace must agree between paths (same
    recurrence, different product fusion)."""
    m = n = 1200
    offsets = (-1, 0, 1)
    data = rng.standard_normal((3, m)).astype(np.float32)
    data[1] += 5.0
    A = dia_operator(m, n, offsets, data)
    b = rng.standard_normal(m).astype(np.float32)
    ref = lt.lsqr(A, b, 0.0, atol=1e-5, btol=1e-5, record_trace=True)
    res = lt.lsqr(A, b, 0.0, atol=1e-5, btol=1e-5, record_trace=True,
                  pair=True)
    k = int(ref.itn)
    assert int(res.itn) == k
    np.testing.assert_allclose(
        np.asarray(res.trace[: k + 1]), np.asarray(ref.trace[: k + 1]),
        rtol=2e-3, atol=1e-5,
    )


def test_pair_f64_stays_exact(rng):
    """Forced pair=True on an f64 operator must NOT route through the f32
    kernel (the ADVICE.md round-1 silent-degradation pattern): the fused
    pair falls back to exact XLA products, so an x64 solve with pair=True
    matches the plain x64 solve to f64 precision."""
    from lsqr_tpu.ops.structured import dia_operator, dia_shared_operator

    m = n = 1500
    offsets = (-1, 0, 2)
    data = rng.standard_normal((3, m))  # float64 under the x64 conftest
    data[1] += 5.0
    b = rng.standard_normal(m)
    for op in (dia_operator(m, n, offsets, data),
               dia_shared_operator(m, n, offsets, data)):
        assert op.dtype == np.float64
        ref = lt.lsqr(op, b, 0.01, atol=1e-12, btol=1e-12)
        res = lt.lsqr(op, b, 0.01, atol=1e-12, btol=1e-12, pair=True)
        assert int(res.istop) == int(ref.istop)
        assert abs(int(res.itn) - int(ref.itn)) <= 1
        err = float(jnp.max(jnp.abs(res.x - ref.x)))
        assert err < 1e-10, err  # f64-level agreement, not f32


def _block_problem(rng, mb=12, nbk=10, bh=8, bw=8, per_row=3):
    from lsqr_tpu.ops.structured import block_ell_operator

    m, n = mb * bh - 3, nbk * bw - 5
    dense = np.zeros((m, n), np.float32)
    for r in range(mb):
        for c in sorted(rng.choice(nbk, size=per_row, replace=False)):
            r0, c0 = r * bh, c * bw
            h, w = min(bh, m - r0), min(bw, n - c0)
            if h > 0 and w > 0:
                dense[r0:r0 + h, c0:c0 + w] = rng.standard_normal(
                    (h, w)).astype(np.float32)
    rr, cc = np.nonzero(dense)
    A = block_ell_operator(m, n, dense[rr, cc], rr, cc, block=(bh, bw))
    return A, dense


@pytest.mark.parametrize("use_pallas", [False, True])
def test_block_ell_pair(rng, use_pallas):
    """BlockELL fused pair: per-block adjoint partials + block-level
    segment-sum replace the transpose packing; eager and jitted (the
    ``use_pallas`` id of the removed kernel case) einsum forms agree with
    the dense oracle."""
    import jax

    A, dense = _block_problem(rng)
    m, n = dense.shape
    v = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    c1, c2 = 0.9, 1.2
    u_ref = dense @ (v * np.float32(c1)) - np.float32(c2) * y
    z_ref = dense.T @ u_ref
    pair = (jax.jit(lambda A, y, v: A.fused_pair(y=y, win=v, c1=c1, c2=c2))
            if use_pallas else
            lambda A, y, v: A.fused_pair(y=y, win=v, c1=c1, c2=c2))
    u, z = pair(A, jnp.asarray(y), jnp.asarray(v))
    assert np.abs(np.asarray(u) - u_ref).max() < 1e-4
    assert np.abs(np.asarray(z) - z_ref).max() < 1e-4


def test_block_ell_pair_solve(rng):
    A, dense = _block_problem(rng)
    m = dense.shape[0]
    b = rng.standard_normal(m).astype(np.float32)
    ref = lt.lsqr(A, b, 0.05, atol=1e-6, btol=1e-6)
    res = lt.lsqr(A, b, 0.05, atol=1e-6, btol=1e-6, pair=True)
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2
    scale = float(jnp.max(jnp.abs(ref.x))) + 1e-30
    assert float(jnp.max(jnp.abs(res.x - ref.x))) / scale < 1e-3


@pytest.mark.slow
def test_dia_pair_geometry_fuzz(rng):
    """Randomized geometry sweep for the pair kernel's halo: random shapes
    (incl. m < tile), offset sets (one-sided, wide, sparse) and scalars,
    interpret mode vs dense oracle."""
    for trial in range(25):
        m = int(rng.integers(64, 4200))
        n = int(rng.integers(64, 4200))
        nd = int(rng.integers(1, 7))
        span = int(rng.integers(1, max(2, min(m, n))))
        offsets = tuple(sorted(rng.choice(
            np.arange(-span, span + 1), size=nd, replace=False).tolist()))
        data, A = _dense_from_offsets(rng, m, n, offsets)
        v = rng.standard_normal(n).astype(np.float32)
        y = rng.standard_normal(m).astype(np.float32)
        c1 = float(rng.uniform(0.1, 2.0))
        c2 = float(rng.uniform(0.0, 2.0))
        u_ref = A @ (v * np.float32(c1)) - np.float32(c2) * y
        z_ref = A.T @ u_ref
        u, z = dia_pair(
            jnp.asarray(data), jnp.asarray(y), jnp.asarray(v), c1, c2,
            offsets=offsets, m=m, n=n, tm=1024,
        )
        su = np.abs(u_ref).max() + 1e-30
        sz = np.abs(z_ref).max() + 1e-30
        eu = np.abs(np.asarray(u) - u_ref).max() / su
        ez = np.abs(np.asarray(z) - z_ref).max() / sz
        assert eu < 1e-5 and ez < 1e-5, (
            trial, m, n, offsets, eu, ez
        )


@pytest.mark.parametrize("m,n,offs", [
    (3000, 3000, (-2, 0, 3)),
    (2500, 3100, (-7, -1, 0, 2, 9)),
    (3100, 2500, (-3, 0, 1)),
    (2048, 2048, (0,)),
])
def test_dia_fused_pair_matches_dense(rng, m, n, offs):
    """DIAOperator.fused_pair (two XLA products) against the dense oracle:
    u = A (w c1) - c2 y and z = A' u, rectangular and one-sided bands."""
    import jax.numpy as jnp

    from lsqr_tpu.ops.structured import dia_operator

    A = dia_operator(
        m, n, offs, rng.standard_normal((len(offs), m)).astype(np.float32),
    )
    dense = np.asarray(A.todense(), np.float64)
    y = rng.standard_normal(m).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    c1, c2 = np.float32(0.7), np.float32(1.3)
    u_ref = dense @ (w.astype(np.float64) * c1) - c2 * y
    z_ref = dense.T @ u_ref
    u, z = A.fused_pair(y=jnp.asarray(y), win=jnp.asarray(w), c1=c1, c2=c2)
    np.testing.assert_allclose(np.asarray(u), u_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(z), z_ref, rtol=2e-4, atol=2e-4)
