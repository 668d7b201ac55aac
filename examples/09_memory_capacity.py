"""Fitting the largest banded problem on one card: shared-stripe DIA.

The packed `dia_operator` keeps a transpose stripe copy so SpMV-T streams
like SpMV; at the HBM-capacity limit that copy is the difference between
fitting and not. `dia_shared_operator` stores ONE zero-padded stripe
array and serves both products from it — half the operator memory,
bit-identical products (tests/test_dia_shared.py).

Run: python examples/09_memory_capacity.py      (CPU sizes here)
"""

import jax

jax.config.update("jax_platforms", "cpu")  # illustrative sizes, on the CPU

import numpy as np

import lsqr_tpu as lt

rng = np.random.default_rng(0)
m = n = 100_000
offsets = tuple(range(-5, 6))
stripes = rng.standard_normal((len(offsets), m)).astype(np.float32)
stripes[5] += 4.0

packed = lt.dia_operator(m, n, offsets, stripes)
shared = lt.dia_shared_operator(m, n, offsets, stripes)
packed_bytes = packed.data.nbytes + packed.tdata.nbytes
print(f"packed operator: {packed_bytes / 2**20:.1f} MiB "
      f"(data + transpose copy)")
print(f"shared operator: {shared.dp.nbytes / 2**20:.1f} MiB "
      f"({shared.dp.nbytes / packed_bytes:.0%})")

b = rng.standard_normal(m).astype(np.float32)
rp = lt.lsqr(packed, b, 0.01, itnlim=50, atol=0.0, btol=0.0, conlim=0.0)
rs = lt.lsqr(shared, b, 0.01, itnlim=50, atol=0.0, btol=0.0, conlim=0.0)
print(f"solves match: itn {int(rp.itn)} == {int(rs.itn)}, "
      f"max |dx| = {np.abs(np.asarray(rp.x) - np.asarray(rs.x)).max():.1e}")

# the same switch through the format auto-selector:
rows = np.concatenate([np.arange(m)] * 3)
cols = np.clip(np.concatenate([np.arange(m) - 1, np.arange(m),
                               np.arange(m) + 1]), 0, n - 1)
vals = rng.standard_normal(len(rows)).astype(np.float32)
A = lt.ops.interop.auto_operator(m, n, vals, rows, cols, compact=True)
print("auto_operator(compact=True) ->", type(A).__name__)
