"""Row-partitioned distributed solve over a device mesh.

On one host the mesh spans its cards (one process drives them all); across
hosts run this same script in every process after
``lsqr_tpu.parallel.initialize_distributed(...)``. Here it demonstrates the
mesh path on whatever devices are available (use
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu to try
an 8-way mesh without hardware)."""

import jax
import numpy as np

import lsqr_tpu as lt
from lsqr_tpu.parallel.sharding import lsqr_sharded, make_mesh

rng = np.random.default_rng(0)
m, n, nnz = 4000, 1500, 60_000
A = lt.coo_operator(
    m, n,
    rng.standard_normal(nnz),
    rng.integers(0, m, nnz),
    rng.integers(0, n, nnz),
)
b = rng.standard_normal(m)

mesh = make_mesh()  # all devices, 1-D 'rows' axis
print(f"solving on {mesh.shape['rows']} device(s)")
res = lsqr_sharded(A, b, damp=0.05, mesh=mesh, atol=1e-8, btol=1e-8, itnlim=500)
print("istop =", int(res.istop), " itn =", int(res.itn),
      " rnorm =", float(res.rnorm))

# equivalence with the single-device solve
ref = lt.lsqr(A, b, 0.05, atol=1e-8, btol=1e-8, itnlim=500)
print("max |x_sharded - x_single| =",
      float(np.abs(np.asarray(res.x) - np.asarray(ref.x)).max()))
