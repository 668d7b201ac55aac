"""Large banded system on one GPU: 8M x 8M, 11 diagonals (92M nnz), f32,
in the shared-stripe DIA layout, whose solver step is the Triton pair
kernel. Data is generated on device (no host transfer). Time on the
H100: not measured for this script (see PERF.md for the smoke run)."""

import time

import jax
import jax.numpy as jnp

import lsqr_tpu as lt
m = 1 << 23
offsets = tuple(range(-5, 6))
key = jax.random.PRNGKey(0)
data = jax.random.normal(key, (len(offsets), m), jnp.float32)
A = lt.dia_shared_operator(m, m, offsets, data)
b = jax.random.normal(jax.random.fold_in(key, 1), (m,), jnp.float32)

res = lt.lsqr(A, b, damp=0.01, atol=1e-5, btol=1e-5, itnlim=300)  # compiles
t0 = time.perf_counter()
res = lt.lsqr(A, b, damp=0.01, atol=1e-5, btol=1e-5, itnlim=300)
itn = int(res.itn)
print(f"{itn} iterations in {time.perf_counter() - t0:.2f}s "
      f"(istop={int(res.istop)}, rnorm={float(res.rnorm):.3f})")
