"""Structured-operator products against a dense float64 oracle. These cases
once drove the removed Pallas kernels in interpret mode; the kernels are gone and the
same parametrisations now check the XLA products that replaced them
(including the padded block layouts the kernels used to consume)."""

import jax.numpy as jnp
import numpy as np
import pytest

from lsqr_tpu.models.synthetic import block_banded_coo
from lsqr_tpu.ops.structured import block_ell_operator, dia_operator


def _dense(op):
    return np.asarray(op.todense(), np.float64)


@pytest.mark.parametrize("shape", [(256, 256), (384, 256), (256, 384)])
def test_block_ell_kernel_interpret(rng, shape):
    m, n = shape
    vals, rows, cols = block_banded_coo(
        min(m, n), min(m, n), block=128, band_blocks=1, dtype=np.float32
    )
    # extend to rectangular by reusing square pattern inside the corner
    bell = block_ell_operator(m, n, vals, rows, cols, block=(128, 128))
    D = _dense(bell)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    np.testing.assert_allclose(np.asarray(bell.matvec(jnp.asarray(x))),
                               D @ x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(bell.rmatvec(jnp.asarray(y))),
                               D.T @ y, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    "shape,offsets",
    [
        ((300, 280), (-5, -1, 0, 2, 7)),
        ((280, 300), (-3, 0, 3)),
        ((256, 256), (0,)),
        ((2100, 2100), (-17, -2, 0, 1, 29)),
    ],
)
def test_dia_kernel_interpret(rng, shape, offsets):
    m, n = shape
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    A = dia_operator(m, n, offsets, data)
    D = _dense(A)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    np.testing.assert_allclose(np.asarray(A.matvec(jnp.asarray(x))), D @ x,
                               rtol=2e-5, atol=2e-5)
    # transpose stripes drive SpMV-T through the same product
    np.testing.assert_allclose(np.asarray(A.rmatvec(jnp.asarray(y))),
                               D.T @ y, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,tr", [((1024, 1024), None), ((1536, 1024), 3)])
def test_block_ell_windowed_kernel_interpret(rng, shape, tr):
    """The block-padded vectors (nb*bw, mb*bh) give the same products as the
    unpadded ones; ``tr`` keeps the old row-tile cases' ids."""
    m, n = shape
    vals, rows, cols = block_banded_coo(
        min(m, n), min(m, n), block=128, band_blocks=1, dtype=np.float32
    )
    bell = block_ell_operator(m, n, vals, rows, cols, block=(128, 128))
    D = _dense(bell)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    nb = bell.tblocks.shape[0]
    xp = jnp.zeros((nb * 128,), jnp.float32).at[:n].set(jnp.asarray(x))
    got_mv = bell._matvec_xla(xp, bell.blocks, bell.bcols, m, bell.bw)
    np.testing.assert_allclose(np.asarray(got_mv), D @ x, rtol=2e-5,
                               atol=2e-5)
    mb = bell.blocks.shape[0]
    yp = jnp.zeros((mb * 128,), jnp.float32).at[:m].set(jnp.asarray(y))
    got_rmv = bell._matvec_xla(yp, bell.tblocks, bell.tbrows, n, bell.bh)
    np.testing.assert_allclose(np.asarray(got_rmv), D.T @ y, rtol=2e-5,
                               atol=2e-5)
