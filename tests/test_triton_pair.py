"""The Triton pair kernel in interpret mode: ragged row counts, one-sided
and two-sided offsets, rectangular shapes and bf16 stripe storage against a
float64 dense oracle; and the checks on its arguments. The compiled kernel
runs on the card in the ``gpu``-marked cases."""

import jax.numpy as jnp
import numpy as np
import pytest

from lsqr_tpu.ops.structured import dia_shared_operator
from lsqr_tpu.ops.triton_pair import dia_pair_triton

SHAPES = [(1000, 1000), (1537, 1537), (900, 1300), (1300, 900)]
OFFSETS = {
    "upper": (0, 1, 2, 5),
    "lower": (-7, -3, 0),
    "both": (-2, 0, 3),
}


def _case(rng, m, n, offsets, storage):
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    op = dia_shared_operator(m, n, offsets, data, storage_dtype=storage)
    dense = np.asarray(op.todense(), np.float64)   # storage-rounded values
    win = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    return op, dense, win, y


@pytest.mark.parametrize("storage", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", list(OFFSETS))
@pytest.mark.parametrize("m,n", SHAPES)
def test_triton_pair_interpret(rng, m, n, kind, storage):
    op, dense, win, y = _case(rng, m, n, OFFSETS[kind], storage)
    c1, c2 = 0.6, 1.4
    u, z = dia_pair_triton(op.dp, jnp.asarray(win), jnp.asarray(y), c1, c2,
                           offsets=op.offsets, m=m, n=n, H=op.H, tile=256,
                           interpret=True)
    assert u.dtype == jnp.float32 and z.dtype == jnp.float32
    assert u.shape == (m,) and z.shape == (n,)
    u_ref = dense @ (win.astype(np.float64) * c1) - c2 * y
    z_ref = dense.T @ u_ref
    np.testing.assert_allclose(np.asarray(u), u_ref,
                               atol=2e-6 * np.abs(u_ref).max())
    np.testing.assert_allclose(np.asarray(z), z_ref,
                               atol=2e-6 * np.abs(z_ref).max())


def test_triton_pair_needs_a_route_off_the_gpu(rng):
    op, _, win, y = _case(rng, 64, 64, (0, 1), None)
    with pytest.raises(ValueError, match="no kernel route"):
        dia_pair_triton(op.dp, jnp.asarray(win), jnp.asarray(y), 1.0, 0.0,
                        offsets=op.offsets, m=64, n=64, H=op.H)


@pytest.mark.parametrize(
    "offsets,kw,match",
    [
        ((-20, 0, 20), dict(tile=300), "power of two"),
        ((-20, 0, 20), dict(H=0), "narrower"),
        ((-40, 0), dict(tile=16), "exceeds the row tile"),
    ],
)
def test_triton_pair_rejects_bad_arguments(rng, offsets, kw, match):
    op, _, win, y = _case(rng, 128, 128, offsets, None)
    args = dict(offsets=op.offsets, m=128, n=128, H=op.H, interpret=True)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        dia_pair_triton(op.dp, jnp.asarray(win), jnp.asarray(y), 1.0, 0.0,
                        **args)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1 << 16, (1 << 16) + 77])
def test_triton_pair_compiled_matches_xla(gpu, rng, m, storage):
    """The kernel as compiled for the card against the XLA products."""
    import jax

    offsets = (-5, -1, 0, 2, 5)
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    with jax.default_device(gpu):
        op = dia_shared_operator(m, m, offsets, data, storage_dtype=storage)
        win = jnp.asarray(rng.standard_normal(m).astype(np.float32))
        y = jnp.asarray(rng.standard_normal(m).astype(np.float32))
        u, z = dia_pair_triton(op.dp, win, y, 0.75, 1.25, offsets=offsets,
                               m=m, n=m, H=op.H)
        ur = op.matvec(win * 0.75) - 1.25 * y
        zr = op.rmatvec(ur)
    np.testing.assert_allclose(np.asarray(u), np.asarray(ur),
                               atol=1e-5 * float(jnp.abs(ur).max()))
    np.testing.assert_allclose(np.asarray(z), np.asarray(zr),
                               atol=1e-5 * float(jnp.abs(zr).max()))
