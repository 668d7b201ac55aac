"""The device route of hand-written kernels is decided in one place,
``config.kernel_route``, and the shared DIA operator follows it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu import config
from lsqr_tpu.ops import structured
from lsqr_tpu.ops.triton_pair import PAIR_MAX_HALO, PAIR_TILE, pair_fits

PLATFORMS = ["gpu", "cuda", "cpu", "rocm"]
REQUESTS = [None, True, False]


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("request_", REQUESTS, ids=["auto", "kernel", "xla"])
@pytest.mark.parametrize("platform", PLATFORMS)
def test_kernel_route(platform, request_, interpret):
    has_route = platform in ("gpu", "cuda")
    if request_ is False:
        expected = None
    elif interpret:
        expected = "interpret"
    elif has_route:
        expected = "triton"
    elif request_:
        with pytest.raises(ValueError, match="no kernel route"):
            config.kernel_route(request_, platform=platform)
        return
    else:
        expected = None
    assert config.kernel_route(request_, interpret=interpret,
                               platform=platform) == expected


def test_kernel_route_defaults_to_this_backend():
    # the test suite runs on the CPU: auto routing selects no kernel
    assert config.kernel_route() is None
    with pytest.raises(ValueError):
        config.kernel_route(True)


def _shared(m, dtype=np.float32, offsets=(-1, 0, 1)):
    data = np.ones((len(offsets), m), dtype)
    return lt.dia_shared_operator(m, m, offsets, data)


@pytest.mark.parametrize(
    "m,dtype,route,expected",
    [
        (1 << 20, np.float32, "triton", True),
        ((1 << 20) - 1, np.float32, "triton", False),   # below the threshold
        (1 << 20, np.float64, "triton", False),         # f64 stays exact
        (1 << 20, np.float32, None, False),             # no kernel route
    ],
)
def test_shared_prefers_pair(monkeypatch, m, dtype, route, expected):
    monkeypatch.setattr(structured, "kernel_route", lambda *a, **k: route)
    assert structured._PAIR_MIN_DIM == 1 << 20
    assert _shared(m, dtype).prefers_pair is expected


@pytest.mark.parametrize(
    "offsets,expected",
    [
        ((-PAIR_MAX_HALO, -1, 0, 1, PAIR_MAX_HALO), True),
        ((-1, 0, PAIR_MAX_HALO + 1), False),
        ((-2048, -1, 0, 1, 2048), False),       # 2-D stencil, 2048^2 grid
        ((-16384, -128, -1, 0, 1, 128, 16384), False),   # 3-D, 128^3
    ],
    ids=["widest-halo", "one-past", "stencil-2d", "stencil-3d"],
)
def test_shared_prefers_pair_halo(monkeypatch, offsets, expected):
    """A halo wider than PAIR_MAX_HALO (2-D and 3-D stencils) takes the
    separate products on a GPU, and so does a forced pair."""
    monkeypatch.setattr(structured, "kernel_route", lambda *a, **k: "triton")
    m = 1 << 20
    A = _shared(m, offsets=offsets)
    assert A.prefers_pair is expected
    assert A._takes_kernel() is expected


def test_shared_prefers_pair_beyond_int32(monkeypatch):
    """Stripes of 2^31 elements or more (a 2^28-row band of 11 diagonals)
    are beyond the kernel's 32-bit indices: separate products."""
    monkeypatch.setattr(structured, "kernel_route", lambda *a, **k: "triton")
    m, offs = 1 << 28, tuple(range(-5, 6))
    H, Lp = structured.shared_geometry(offs, m, m)
    A = structured.DIASharedOperator(
        dp=jax.ShapeDtypeStruct((len(offs) * Lp,), jnp.float32),
        m=m, n=m, offsets=offs, H=H)
    assert len(offs) * Lp >= 2**31
    assert A.prefers_pair is False
    assert not pair_fits(len(offs), Lp, H)
    assert pair_fits(len(offs), (2**31 - 1) // len(offs), H)


@pytest.mark.parametrize("H,expected", [
    (0, True), (5, True), (PAIR_MAX_HALO, True), (PAIR_MAX_HALO + 1, False),
    (PAIR_TILE, False),
])
def test_pair_fits_halo(H, expected):
    assert PAIR_MAX_HALO <= PAIR_TILE   # a fitting halo fits the tile
    assert pair_fits(3, 1 << 20, H) is expected


@pytest.mark.parametrize("route", ["triton", None])
def test_shared_pair_wide_halo_is_separate_products(monkeypatch, rng, route):
    """Where the kernel does not serve the geometry (here a halo wider
    than PAIR_MAX_HALO, even on a GPU route) or there is no route, a
    forced pair is the two separate products, equal to the dense oracle."""
    monkeypatch.setattr(structured, "kernel_route", lambda *a, **k: route)
    m = n = 1200
    ks = (-(PAIR_MAX_HALO + 3), 0, 2)
    data = rng.standard_normal((3, m)).astype(np.float32)
    A = lt.dia_shared_operator(m, n, ks, data)
    dense = np.asarray(A.todense(), np.float64)
    win = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    u, z = A.fused_pair(y=jnp.asarray(y), win=jnp.asarray(win), c1=0.5,
                        c2=2.0)
    ur = dense @ (0.5 * win.astype(np.float64)) - 2.0 * y
    np.testing.assert_allclose(np.asarray(u), ur, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(z), dense.T @ ur, rtol=1e-4,
                               atol=1e-4)


def test_removed_options_stay_removed():
    opts = lt.LSQROptions()
    assert not hasattr(opts, "megakernel")
    assert opts.loop == "while"
    assert not hasattr(config, "bounded_loop_workaround")
    for name in ("lsqr_megakernel", "wcoo_operator", "rwcoo_operator",
                 "wwcoo_operator"):
        assert not hasattr(lt, name)
