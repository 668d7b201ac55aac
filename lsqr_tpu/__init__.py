"""lsqr_tpu — LSQR and its siblings for accelerators, in JAX (XLA / Pallas).

A from-scratch re-design of the capabilities of jacobwilliams/LSQR
(Paige & Saunders, ACM TOMS 1982, Algorithm 583) for accelerators, run on
NVIDIA GPUs:

* :func:`lsqr` — the core solver: Golub–Kahan bidiagonalization + Givens
  rotations as a single jitted ``lax.while_loop`` (reference core:
  /root/reference/src/lsqr.f90:432-882).
* :class:`LSQRSolver` — class-style COO convenience API (reference EZ class:
  lsqr.f90:32-65).
* :mod:`lsqr_tpu.ops` — operator layer: dense, COO (segment-sum),
  structured DIA/ELL/BSR formats on XLA, and a Pallas (Triton) pair kernel
  for the banded solver step (reference aprod: lsqr.f90:67-82, 134-200).
* :func:`acheck` / :func:`xcheck` — built-in self-verification
  (lsqr.f90:908-994, 1015-1154).
* :mod:`lsqr_tpu.parallel` — row-partitioned distributed solves over a
  ``jax.sharding.Mesh`` with XLA collectives (no reference analogue; the
  reference is serial Fortran).
* :mod:`lsqr_tpu.models` — test-problem generators, incl. the
  Paige–Saunders HY*D*HZ family (reference: test/lsqrtest_module.f90).
"""

from .api import LSQRSolver
from .config import LSQROptions, default_dtype, enable_x64
from .diagnostics import ACheckResult, XCheckResult, acheck, xcheck
from .ops.compose import (
    DiagonalOperator,
    HStackOperator,
    ScaledOperator,
    SumOperator,
    VStackOperator,
    add_operators,
    diagonal_operator,
    hstack_operators,
    scale_operator,
    tikhonov,
    vstack_operators,
)
from .ops.coo import COOOperator, coo_operator
from .ops.linop import CallbackOperator, DenseOperator, LinearOperator, as_operator
from .batch import cgls_batch, lsmr_batch, lsqr_batch
from .hybrid import (GKBasis, HybridResult, gcv_lambda, golub_kahan,
                     hybrid_lsqr, projected_tikhonov)
from .implicit import lsqr_grad, normal_cg
from .randomized import (LSRNResult, lsrn, lsrn_preconditioner, sketch_left,
                         sketch_right)
from .refine import RefineResult, lsqr_refined
from .ops.host import host_coo, host_products, to_scipy
from .multidamp import lsmr_multidamp, lsqr_multidamp
from .regpath import (RegPath, discrepancy_damp, gcv_damp,
                      lcurve_corner, reg_sweep)
from .ops.interop import (auto_operator, csr_operator, from_bcoo,
                          from_matrix_market, from_scipy, lsqr_scipy,
                          lsmr_scipy)
from .ops.precondition import (
    ColumnScaledOperator,
    ComposedOperator,
    column_norms,
    column_scaled,
    right_preconditioned,
)
from .ops.structured import (
    BlockELLOperator,
    DIAOperator,
    ELLOperator,
    block_ell_operator,
    dia_operator,
    dia_shared_operator,
    hyb_operator,
    ell_operator,
)
from .ops.zdia import (ZDIAOperator, ZJDIAOperator, zdia_operator,
                       zdia_operator_device, zjdia_operator)
from .cgls import CGLS_ISTOP_MESSAGES, CGLSResult, cgls
from .craig import CRAIG_ISTOP_MESSAGES, CRAIGResult, craig
from .lsmr import LSMR_ISTOP_MESSAGES, LSMRResult, lsmr
from .solver import ISTOP_MESSAGES, LSQRResult, lsqr
from .utils.checkpoint import load_state, lsqr_checkpointed, save_state
from .utils.printing import format_exit_block, format_iteration_log, format_report

__version__ = "0.1.0"

__all__ = [
    "LSQRSolver",
    "LSQROptions",
    "LSQRResult",
    "ISTOP_MESSAGES",
    "lsqr",
    "lsmr",
    "LSMRResult",
    "LSMR_ISTOP_MESSAGES",
    "craig",
    "cgls",
    "CGLSResult",
    "CGLS_ISTOP_MESSAGES",
    "CRAIGResult",
    "CRAIG_ISTOP_MESSAGES",
    "acheck",
    "xcheck",
    "ACheckResult",
    "XCheckResult",
    "LinearOperator",
    "DenseOperator",
    "CallbackOperator",
    "COOOperator",
    "coo_operator",
    "as_operator",
    "default_dtype",
    "enable_x64",
    "lsqr_batch",
    "lsqr_multidamp",
    "lsmr_multidamp",
    "GKBasis",
    "HybridResult",
    "golub_kahan",
    "hybrid_lsqr",
    "projected_tikhonov",
    "gcv_lambda",
    "LSRNResult",
    "lsrn",
    "lsrn_preconditioner",
    "sketch_left",
    "sketch_right",
    "RefineResult",
    "lsqr_refined",
    "host_coo",
    "host_products",
    "to_scipy",
    "RegPath",
    "reg_sweep",
    "discrepancy_damp",
    "gcv_damp",
    "lcurve_corner",
    "from_scipy",
    "from_matrix_market",
    "from_bcoo",
    "lsqr_scipy",
    "lsmr_scipy",
    "csr_operator",
    "auto_operator",
    "DIAOperator",
    "ELLOperator",
    "BlockELLOperator",
    "dia_operator",
    "dia_shared_operator",
    "ZDIAOperator",
    "ZJDIAOperator",
    "zjdia_operator",
    "zdia_operator",
    "zdia_operator_device",
    "hyb_operator",
    "ell_operator",
    "block_ell_operator",
    "ComposedOperator",
    "ColumnScaledOperator",
    "column_norms",
    "column_scaled",
    "right_preconditioned",
    "lsqr_checkpointed",
    "save_state",
    "load_state",
    "format_report",
    "format_exit_block",
    "format_iteration_log",
]
