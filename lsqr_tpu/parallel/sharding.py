"""Distributed row-partitioned LSQR over a device mesh.

The reference is serial Fortran with no parallelism of any kind (SURVEY.md
§2.2); this module is the multi-device scaling layer it lacks. The design
follows the structure of the algorithm:

* A is partitioned by ROWS across a 1-D mesh axis; each device owns a
  contiguous block of rows (a local COO shard) and the matching slice of
  every m-vector (u, b).
* n-vectors (x, v, w) are REPLICATED: the per-iteration scalar recurrence
  (Givens rotations, norm estimates — lsqr.f90:703-810) is O(1) work, so
  every device computes it redundantly with zero communication.
* per iteration exactly TWO collectives are needed (NCCL over NVLink on
  a GPU host):
    - rmatvec: local SpMV-T partials -> psum over the row axis
      (the analogue of the reference's mode-2 full-x accumulation,
      lsqr.f90:188-192)
    - ||u||: local sum of squares -> psum (the distributed dnrm2,
      lsqrblas.f90:123-159)
  matvec and every n-vector op are communication-free.

The entire while_loop runs INSIDE one ``jax.shard_map`` call: XLA sees a
single program per device with collectives inside the loop body, so there is
no per-iteration dispatch overhead and GSPMD can overlap the psum with
neighbouring compute.

Zero-padding strategy: rows are padded so every device gets an equal block
(extra rows are all-zero => contribute nothing to any norm or product), and
each shard's nnz is padded with explicit zeros (val = 0 => no-op in the
segment sums). This keeps all shapes static and equal across devices — the
XLA-friendly answer to the reference's arbitrary m.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import LSQROptions
from ..ops.coo import COOOperator
from ..ops.linop import LinearOperator
from ..solver import LSQRResult, _lsqr_impl

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_coo",
    "ShardedCOO",
    "lsqr_sharded",
    "lsqr_sharded_dia",
    "lsqr_sharded_2d",
    "lsmr_sharded",
    "craig_sharded",
    "cgls_sharded",
    "cgls_sharded_2d",
    "cgls_sharded_dia",
    "craig_sharded_dia",
    "lsmr_sharded_dia",
    "craig_sharded_2d",
    "lsmr_sharded_2d",
]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "rows") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def make_mesh_2d(
    shape: tuple,
    axis_names: tuple = ("rows", "cols"),
) -> Mesh:
    """A 2-D (rows x cols) mesh over the first prod(shape) devices.

    The per-iteration collectives are one psum over 'cols' (matvec
    partials) and one over 'rows' (rmatvec partials). The cards of one
    host are joined all to all by NVLink, so the mesh shape follows the
    matrix, not the wiring; across hosts lay 'rows' over the slower
    interconnect."""
    r, c = shape
    devices = jax.devices()[: r * c]
    if len(devices) < r * c:
        raise ValueError(f"need {r * c} devices, have {len(devices)}")
    return Mesh(np.array(devices).reshape(r, c), axis_names)


def _rdt(dtype):
    """Real counterpart of ``dtype`` — damp/tolerances are always real,
    also for complex problems (see solver._build)."""
    return jnp.zeros((), dtype).real.dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _LocalRowShard(LinearOperator):
    """Per-device view of a row-partitioned COO matrix, used inside
    shard_map. ``m`` is the LOCAL row count; ``n`` is global (x replicated).

    ``axis_name_m`` tells the solver core to complete u-norms with psum
    over the row axis (see lsqr_tpu.solver norm hooks)."""

    vals: jax.Array
    rows: jax.Array   # local row indices in [0, m_local)
    cols: jax.Array   # global column indices
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    #: true (unpadded) global row count — used for standard-error
    #: finalization semantics (lsqr.f90:857-865)
    global_m: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def axis_name_m(self):  # consumed by the solver's norm_m
        return self.axis

    def matvec(self, x: jax.Array) -> jax.Array:
        # x replicated -> local u rows; no communication.
        return jax.ops.segment_sum(
            self.vals * x[self.cols], self.rows, num_segments=self.m
        )

    def rmatvec(self, y: jax.Array) -> jax.Array:
        # local partial A_local^H y_local -> global reduce over the row axis
        # (conj for complex values: the adjoint is the conjugate transpose,
        # and psum is dtype-generic)
        vals = (
            jnp.conj(self.vals)
            if jnp.issubdtype(self.vals.dtype, jnp.complexfloating)
            else self.vals
        )
        partial_ = jax.ops.segment_sum(
            vals * y[self.rows], self.cols, num_segments=self.n
        )
        return jax.lax.psum(partial_, self.axis)


@dataclasses.dataclass(frozen=True)
class ShardedCOO:
    """Host-side row partition of a COO matrix, ready for shard_map.

    Stacked per-device arrays with equal shapes:
      vals/rows/cols: (ndev, nnz_max) — rows hold LOCAL indices;
      m_pad: padded global row count (ndev * rows_per_dev);
      row_starts: (ndev,) global row offset of each shard.
    """

    vals: jax.Array
    rows: jax.Array
    cols: jax.Array
    m: int
    n: int
    m_pad: int
    ndev: int

    @property
    def rows_per_dev(self) -> int:
        return self.m_pad // self.ndev


def shard_coo(A: COOOperator, ndev: int) -> ShardedCOO:
    """Partition a COO operator into ``ndev`` contiguous row blocks with
    equalized shapes (zero padding for ragged nnz)."""
    rows = np.asarray(A.rows)
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    m, n = A.m, A.n

    m_pad = -(-m // ndev) * ndev
    rpd = m_pad // ndev
    dev_of = rows // rpd

    order = np.argsort(dev_of, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    dev_of = dev_of[order]
    counts = np.bincount(dev_of, minlength=ndev)
    nnz_max = int(counts.max()) if counts.size else 0
    nnz_max = max(nnz_max, 1)

    out_vals = np.zeros((ndev, nnz_max), vals.dtype)
    out_rows = np.zeros((ndev, nnz_max), np.int32)
    out_cols = np.zeros((ndev, nnz_max), np.int32)
    start = 0
    for d in range(ndev):
        c = int(counts[d])
        sl = slice(start, start + c)
        out_vals[d, :c] = vals[sl]
        out_rows[d, :c] = rows[sl] - d * rpd   # local row index
        out_cols[d, :c] = cols[sl]
        start += c

    return ShardedCOO(
        vals=jnp.asarray(out_vals),
        rows=jnp.asarray(out_rows),
        cols=jnp.asarray(out_cols),
        m=m,
        n=n,
        m_pad=m_pad,
        ndev=ndev,
    )


def _globalize(mesh: Mesh, *arrays):
    """Multi-process support: convert replicated host-local arrays into
    global jax.Arrays over ``mesh`` (every process passes identical values —
    the SPMD calling convention of lsqr_multihost). No-op single-process."""
    if jax.process_count() == 1:
        return arrays
    from jax.experimental import multihost_utils

    return tuple(
        multihost_utils.host_local_array_to_global_array(np.asarray(a), mesh, P())
        for a in arrays
    )


def lsqr_sharded(
    A,
    b,
    damp: float = 0.0,
    *,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    options: Optional[LSQROptions] = None,
    **option_overrides,
) -> LSQRResult:
    """Row-partitioned distributed LSQR solve.

    Args:
      A: a COOOperator (partitioned here) or a pre-built ShardedCOO.
      b: global right-hand side (m,).
      mesh: 1-D device mesh; default spans all local devices.

    Semantics are identical to :func:`lsqr_tpu.lsqr` — the sharded and
    unsharded solvers produce the same iterates up to reduction-order
    rounding (tested to near-machine precision on a CPU mesh).
    """
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)

    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    ndev = mesh.shape[axis_name]

    if isinstance(A, COOOperator):
        sharded = shard_coo(A, ndev)
    elif isinstance(A, ShardedCOO):
        sharded = A
        if sharded.ndev != ndev:
            raise ValueError(
                f"ShardedCOO was built for {sharded.ndev} devices, mesh has {ndev}"
            )
    else:
        raise TypeError(
            "lsqr_sharded expects a COOOperator or ShardedCOO; for custom "
            "operators run lsqr() inside your own shard_map with an operator "
            "whose axis_name_m names the row axis"
        )

    dtype = opts.dtype or jnp.result_type(jnp.asarray(b).dtype, sharded.vals.dtype)
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from ..config import default_dtype

        dtype = default_dtype()
    b = jnp.asarray(b, dtype)
    if b.shape != (sharded.m,):
        raise ValueError(f"b must have shape ({sharded.m},), got {b.shape}")
    b_pad = jnp.zeros((sharded.m_pad,), dtype).at[: sharded.m].set(b)
    vals = sharded.vals.astype(dtype)

    itnlim = opts.resolve_itnlim(sharded.n)
    solver_kw = dict(
        itnlim=itnlim,
        wantse=opts.wantse,
        nconv=opts.nconv,
        record_trace=opts.record_trace,
        safe_norms=opts.safe_norms,
        debug_log=opts.debug_log,
        scalar_dtype=(str(jnp.dtype(opts.scalar_dtype))
                      if opts.scalar_dtype is not None else None),
    )
    rpd = sharded.m_pad // ndev
    n = sharded.n

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(vals_s, rows_s, cols_s, b_local, damp_, atol_, btol_, conlim_):
        op = _LocalRowShard(
            vals=vals_s[0],
            rows=rows_s[0],
            cols=cols_s[0],
            m=rpd,
            n=n,
            axis=axis_name,
            global_m=sharded.m,
        )
        return _lsqr_impl(
            op, b_local.reshape(-1), damp_, atol_, btol_, conlim_, **solver_kw
        )

    res = jax.jit(run)(
        *_globalize(
            mesh,
            sharded.vals.astype(dtype),
            sharded.rows,
            sharded.cols,
            b_pad,
            jnp.asarray(damp, _rdt(dtype)),
            jnp.asarray(opts.atol, _rdt(dtype)),
            jnp.asarray(opts.btol, _rdt(dtype)),
            jnp.asarray(opts.conlim, _rdt(dtype)),
        )
    )
    return res


# ---------------------------------------------------------------------------
# Row-partitioned DIA (banded) shards
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _LocalDIAShard(LinearOperator):
    """Per-device view of a row-partitioned DIA matrix inside shard_map.

    Row block [row0, row0 + m_local): the local stripes are the row slice of
    the global stripes; x stays replicated, so the local matvec only shifts
    its slice window by the global row offset — no halo exchange is needed
    for the banded structure (the 'halo' is just the replicated x). The
    transpose product streams the SAME row-aligned stripes (static
    per-diagonal shifted adds into a local band window + one dynamic
    placement at the shard's global offset) — no transpose copy exists at
    all, so per-device operator memory is ndiag*m_local instead of the
    round-1 ndiag*(m_local + n) and the adjoint reads ndiag*m_local words
    per iteration instead of ndiag*n.
    """

    data: jax.Array     # (ndiag, m_local) local row slice of stripes
    row0: jax.Array     # global row offset of this shard (scalar int32)
    m: int = dataclasses.field(metadata=dict(static=True))        # local rows
    n: int = dataclasses.field(metadata=dict(static=True))
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    global_m: int = dataclasses.field(metadata=dict(static=True))
    #: padded global row count (ndev * m). Buffer sizing must use THIS, not
    #: global_m: when global_m % ndev != 0 the last shard's local rows run to
    #: global_m_pad, and a buffer sized from global_m lets the dynamic_slice
    #: start clamp — silently shifting the whole window (advisor finding,
    #: ADVICE.md round 1).
    global_m_pad: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def axis_name_m(self):
        return self.axis

    def matvec(self, x: jax.Array) -> jax.Array:
        # local row i (global row0 + i) reads x[row0 + i + k]; the last
        # shard's rows run to global_m_pad, so the padded x must cover them.
        m, n = self.m, self.n
        ks = self.offsets or (0,)
        lo = max(0, -min(ks))
        hi = max(0, self.global_m_pad + max(ks) - n)
        xp = jnp.zeros((lo + n + hi,), x.dtype).at[lo : lo + n].set(x)
        y = jnp.zeros((m,), self.dtype)
        for j, k in enumerate(self.offsets):
            seg = jax.lax.dynamic_slice(xp, (self.row0 + lo + k,), (m,))
            y = y + self.data[j] * seg
        return y

    def _adjoint_local(self, y: jax.Array) -> jax.Array:
        """This shard's additive contribution to A'y (length n, un-summed):
        z[row0 + i + k] += data[d, i] * y[i] — static per-diagonal pad-adds
        into a (lo + m_local + hi) band window, then ONE dynamic placement
        at the shard's global offset. Stripe rows beyond global_m are
        zero-padded at prep time, so no masking is needed."""
        m, n = self.m, self.n
        ks = self.offsets or (0,)
        lo = max(0, -min(ks))
        hi = max(0, max(ks))
        yd = y.astype(self.dtype)
        zloc = jnp.zeros((lo + m + hi,), self.dtype)
        for j, k in enumerate(self.offsets):
            zloc = zloc + jax.lax.pad(
                self.data[j] * yd, jnp.zeros((), self.dtype),
                [(lo + k, hi - k, 0)],
            )
        # buffer index = global column + lo; zloc[0] is column row0 - lo
        L = max(lo + self.global_m_pad + hi, lo + n)
        zbuf = jax.lax.dynamic_update_slice(
            jnp.zeros((L,), self.dtype), zloc, (self.row0,)
        )
        return jax.lax.slice(zbuf, (lo,), (lo + n,))

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return jax.lax.psum(self._adjoint_local(y), self.axis)

    def fused_pair(self, *, y, win, c1, c2):
        """Both bidiagonalization products in one local pass + one psum:
            u_new = A_local (win*c1) - c2*y_local,   z = psum(A_local' u_new)
        (the sharded analogue of the operator's fused_pair: the adjoint
        reuses the row-aligned stripes just streamed by the forward)."""
        u = self.matvec(win * c1) - c2 * y
        return u, jax.lax.psum(self._adjoint_local(u), self.axis)


def lsqr_sharded_dia(
    A,
    b,
    damp: float = 0.0,
    *,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    options: Optional[LSQROptions] = None,
    **option_overrides,
):
    """Row-partitioned distributed solve for a banded (DIA) operator.

    Each device owns a contiguous row block of the stripes; x/v/w stay
    replicated so the banded matvec needs NO halo exchange, and the
    transpose product reduces with one psum per iteration — identical
    communication structure to the COO path (lsqr_sharded)."""
    from ..ops.structured import DIAOperator, DIASharedOperator

    if not isinstance(A, (DIAOperator, DIASharedOperator)):
        raise TypeError("lsqr_sharded_dia expects a DIAOperator or "
                        "DIASharedOperator")
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)

    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    m, n = A.m, A.n
    # stacked per-device stripe slices (shared with the sibling DIA
    # solvers); the adjoint streams the same stripes — no transpose copy
    data_s, row0s, b_pad, rpd, m_pad, dtype = _prep_dia_shards(
        A, b, mesh, axis_name, dtype=opts.dtype
    )

    itnlim = opts.resolve_itnlim(n)
    solver_kw = dict(
        itnlim=itnlim,
        wantse=opts.wantse,
        nconv=opts.nconv,
        record_trace=opts.record_trace,
        safe_norms=opts.safe_norms,
        debug_log=opts.debug_log,
        scalar_dtype=(str(jnp.dtype(opts.scalar_dtype))
                      if opts.scalar_dtype is not None else None),
        # pair mode: both products from one local stripe stream + one psum
        # (the sharded analogue of dia_pair); opt-in via LSQROptions.pair
        fused=bool(opts.pair),
        pair=bool(opts.pair),
    )
    offsets = A.offsets

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name),
                  P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(data_l, row0_l, b_local, damp_, atol_, btol_, conlim_):
        op = _LocalDIAShard(
            data=data_l[0].astype(dtype),
            row0=row0_l[0],
            m=rpd,
            n=n,
            offsets=offsets,
            axis=axis_name,
            global_m=m,
            global_m_pad=m_pad,
        )
        return _lsqr_impl(
            op, b_local.reshape(-1), damp_, atol_, btol_, conlim_, **solver_kw
        )

    return jax.jit(run)(
        data_s,
        row0s,
        b_pad,
        jnp.asarray(damp, _rdt(dtype)),
        jnp.asarray(opts.atol, _rdt(dtype)),
        jnp.asarray(opts.btol, _rdt(dtype)),
        jnp.asarray(opts.conlim, _rdt(dtype)),
    )


def lsqr_multidamp_sharded(
    A,
    b,
    damps,
    *,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    options: Optional[LSQROptions] = None,
    **option_overrides,
):
    """Row-partitioned distributed multi-damp solve: the whole damp grid
    from ONE shared bidiagonalization (see :func:`lsqr_tpu.lsqr_multidamp`)
    with A row-partitioned across the mesh. Per iteration: the same two
    collectives as :func:`lsqr_sharded` (one psum for the transpose
    product, one for the u-norm) serve every damp value.

    ``A``: a COOOperator/ShardedCOO (general sparsity) or a DIAOperator
    (banded rows; pair mode via ``options.pair``). Returns an
    :class:`LSQRResult` with a leading (k,) axis, replicated on all devices.
    """
    from ..multidamp import _md_impl
    from ..ops.structured import DIAOperator, DIASharedOperator

    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)
    if opts.record_trace or opts.debug_log:
        raise ValueError("record_trace/debug_log are not supported by "
                         "the multi-damp solvers")
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    ndev = mesh.shape[axis_name]

    md_kw = dict(
        wantse=opts.wantse,
        nconv=opts.nconv,
        safe_norms=opts.safe_norms,
        scalar_dtype=(str(jnp.dtype(opts.scalar_dtype))
                      if opts.scalar_dtype is not None else None),
    )

    if isinstance(A, (DIAOperator, DIASharedOperator)):
        m, n = A.m, A.n
        data_s, row0s, b_pad, rpd, m_pad, dtype = _prep_dia_shards(
            A, b, mesh, axis_name, dtype=opts.dtype
        )
        damps = jnp.atleast_1d(jnp.asarray(damps, _rdt(dtype)))
        md_kw.update(itnlim=opts.resolve_itnlim(n), pair=bool(opts.pair))
        offsets = A.offsets

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), P(axis_name),
                      P(), P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        )
        def run_dia(data_l, row0_l, b_local, damps_, atol_, btol_, conlim_):
            op = _LocalDIAShard(
                data=data_l[0].astype(dtype),
                row0=row0_l[0],
                m=rpd,
                n=n,
                offsets=offsets,
                axis=axis_name,
                global_m=m,
                global_m_pad=m_pad,
            )
            return _md_impl(
                op, b_local.reshape(-1), damps_, atol_, btol_, conlim_, **md_kw
            )

        return jax.jit(run_dia)(*_globalize(
            mesh, data_s, row0s, b_pad, damps,
            jnp.asarray(opts.atol, _rdt(dtype)),
            jnp.asarray(opts.btol, _rdt(dtype)),
            jnp.asarray(opts.conlim, _rdt(dtype)),
        ))

    if isinstance(A, COOOperator):
        sharded = shard_coo(A, ndev)
    elif isinstance(A, ShardedCOO):
        sharded = A
        if sharded.ndev != ndev:
            raise ValueError(
                f"ShardedCOO was built for {sharded.ndev} devices, mesh has {ndev}"
            )
    else:
        raise TypeError(
            "lsqr_multidamp_sharded expects a COOOperator/ShardedCOO or a "
            "DIAOperator"
        )
    dtype = opts.dtype or jnp.result_type(jnp.asarray(b).dtype, sharded.vals.dtype)
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from ..config import default_dtype

        dtype = default_dtype()
    b = jnp.asarray(b, dtype)
    if b.shape != (sharded.m,):
        raise ValueError(f"b must have shape ({sharded.m},), got {b.shape}")
    b_pad = jnp.zeros((sharded.m_pad,), dtype).at[: sharded.m].set(b)
    damps = jnp.atleast_1d(jnp.asarray(damps, _rdt(dtype)))
    md_kw.update(itnlim=opts.resolve_itnlim(sharded.n), pair=False)
    rpd = sharded.m_pad // ndev
    n = sharded.n

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(vals_s, rows_s, cols_s, b_local, damps_, atol_, btol_, conlim_):
        op = _LocalRowShard(
            vals=vals_s[0],
            rows=rows_s[0],
            cols=cols_s[0],
            m=rpd,
            n=n,
            axis=axis_name,
            global_m=sharded.m,
        )
        return _md_impl(
            op, b_local.reshape(-1), damps_, atol_, btol_, conlim_, **md_kw
        )

    return jax.jit(run)(*_globalize(
        mesh,
        sharded.vals.astype(dtype),
        sharded.rows,
        sharded.cols,
        b_pad,
        damps,
        jnp.asarray(opts.atol, _rdt(dtype)),
        jnp.asarray(opts.btol, _rdt(dtype)),
        jnp.asarray(opts.conlim, _rdt(dtype)),
    ))


def _prep_dia_shards(A, b, mesh, axis_name, dtype=None):
    """Per-device stripe slices + padded b for
    a row-partitioned DIA operator (the plumbing of lsqr_sharded_dia,
    shared with the sibling solvers). Accepts the shared-stripe layout
    too (its lazy ``data`` property reconstructs the row-aligned
    stripes; each shard then stores its own packed row slice)."""
    from ..ops.structured import DIAOperator, DIASharedOperator

    if not isinstance(A, (DIAOperator, DIASharedOperator)):
        raise TypeError("the DIA sharded solvers expect a DIAOperator "
                        "or DIASharedOperator")
    ndev = mesh.shape[axis_name]
    m, n = A.m, A.n
    m_pad = -(-m // ndev) * ndev
    rpd = m_pad // ndev
    nd = len(A.offsets)
    dpad = jnp.zeros((nd, m_pad), A.data.dtype).at[:, :m].set(A.data)
    data_s = dpad.reshape(nd, ndev, rpd).swapaxes(0, 1)
    row0s = jnp.arange(ndev, dtype=jnp.int32) * rpd
    dtype = dtype or A.data.dtype
    b = jnp.asarray(b, dtype)
    if b.shape != (m,):
        raise ValueError(f"b must have shape ({m},), got {b.shape}")
    b_pad = jnp.zeros((m_pad,), dtype).at[:m].set(b)
    return data_s, row0s, b_pad, rpd, m_pad, dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _LocalZDIAShard(LinearOperator):
    """Per-device view of a row-partitioned complex-banded (ZDIA) matrix
    inside shard_map: the plane-split analogue of :class:`_LocalDIAShard`.

    The shard holds ROW slices of the two real stripe planes
    (``dr + 1j*di``); x stays replicated, so the local complex matvec is
    four real shifted-window products over the same slices and the
    adjoint's conjugation is a SIGN in the plane combination — exactly
    the scatter- and conj-copy-free scheme of ops/zdia.py, row-sharded.
    Communication per iteration is the DIA path's: one (complex) psum
    for the transpose product, one scalar psum for the u-norm.
    Reference anchor: the aprod mode-2 reduction, lsqr.f90:188-192.
    """

    dr: jax.Array       # (ndiag, m_local) local row slice, real plane
    di: jax.Array       # (ndiag, m_local) local row slice, imag plane
    row0: jax.Array     # global row offset of this shard (scalar int32)
    m: int = dataclasses.field(metadata=dict(static=True))   # local rows
    n: int = dataclasses.field(metadata=dict(static=True))
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    global_m: int = dataclasses.field(metadata=dict(static=True))
    global_m_pad: int = dataclasses.field(metadata=dict(static=True))

    #: solver hook: the pair path may run for complex vectors (the local
    #: pair is the plane-split stripe pass; see solver._build)
    supports_complex_pair = True

    @property
    def dtype(self):
        return jnp.dtype(
            jnp.complex64 if self.dr.dtype == jnp.float32 else jnp.complex128
        )

    @property
    def axis_name_m(self):
        return self.axis

    def matvec(self, x: jax.Array) -> jax.Array:
        # local row i (global row0 + i) reads x[row0 + i + k]; four real
        # plane/segment products per diagonal (window math as in
        # _LocalDIAShard.matvec)
        m, n = self.m, self.n
        ks = self.offsets or (0,)
        lo = max(0, -min(ks))
        hi = max(0, self.global_m_pad + max(ks) - n)
        rdt = self.dr.dtype
        xr = jnp.real(x).astype(rdt)
        xi = jnp.imag(x).astype(rdt)
        xpr = jnp.zeros((lo + n + hi,), rdt).at[lo : lo + n].set(xr)
        xpi = jnp.zeros((lo + n + hi,), rdt).at[lo : lo + n].set(xi)
        yr = jnp.zeros((m,), rdt)
        yi = jnp.zeros((m,), rdt)
        for j, k in enumerate(self.offsets):
            sr = jax.lax.dynamic_slice(xpr, (self.row0 + lo + k,), (m,))
            si = jax.lax.dynamic_slice(xpi, (self.row0 + lo + k,), (m,))
            yr = yr + self.dr[j] * sr - self.di[j] * si
            yi = yi + self.dr[j] * si + self.di[j] * sr
        return jax.lax.complex(yr, yi)

    def _adjoint_local(self, y: jax.Array) -> jax.Array:
        """This shard's additive contribution to A^H y (length n,
        un-summed): z[row0 + i + k] += conj(a[d, i]) * y[i], i.e. the
        imag plane enters with a flipped sign — applied per plane with
        the same pad-adds + one dynamic placement as _LocalDIAShard."""
        m, n = self.m, self.n
        ks = self.offsets or (0,)
        lo = max(0, -min(ks))
        hi = max(0, max(ks))
        rdt = self.dr.dtype
        yr = jnp.real(y).astype(rdt)
        yi = jnp.imag(y).astype(rdt)
        zlr = jnp.zeros((lo + m + hi,), rdt)
        zli = jnp.zeros((lo + m + hi,), rdt)
        for j, k in enumerate(self.offsets):
            pad = [(lo + k, hi - k, 0)]
            zlr = zlr + jax.lax.pad(
                self.dr[j] * yr + self.di[j] * yi, jnp.zeros((), rdt), pad)
            zli = zli + jax.lax.pad(
                self.dr[j] * yi - self.di[j] * yr, jnp.zeros((), rdt), pad)
        L = max(lo + self.global_m_pad + hi, lo + n)
        zbr = jax.lax.dynamic_update_slice(
            jnp.zeros((L,), rdt), zlr, (self.row0,))
        zbi = jax.lax.dynamic_update_slice(
            jnp.zeros((L,), rdt), zli, (self.row0,))
        return jax.lax.complex(
            jax.lax.slice(zbr, (lo,), (lo + n,)),
            jax.lax.slice(zbi, (lo,), (lo + n,)),
        )

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return jax.lax.psum(self._adjoint_local(y), self.axis)

    def fused_pair(self, *, y, win, c1, c2):
        """Both bidiagonalization products in one local plane pass + one
        psum (c1, c2 REAL — the bidiagonalization scalars stay real over
        C, see solver._build)."""
        u = self.matvec(win * c1) - c2 * y
        return u, jax.lax.psum(self._adjoint_local(u), self.axis)


def _prep_zdia_shards(A, b, mesh, axis_name):
    """Per-device plane slices + padded complex b for a row-partitioned
    ZDIA operator (the plumbing of lsqr_sharded_zdia)."""
    from ..ops.zdia import ZDIAOperator

    if not isinstance(A, ZDIAOperator):
        raise TypeError("lsqr_sharded_zdia expects a ZDIAOperator")
    ndev = mesh.shape[axis_name]
    m, n = A.m, A.n
    m_pad = -(-m // ndev) * ndev
    rpd = m_pad // ndev
    nd = len(A.offsets)
    rdt = A.dr.dtype

    def shard_plane(plane):
        p = jnp.zeros((nd, m_pad), rdt).at[:, :m].set(plane)
        return p.reshape(nd, ndev, rpd).swapaxes(0, 1)

    dr_s = shard_plane(A.dr)
    di_s = shard_plane(A.di)
    row0s = jnp.arange(ndev, dtype=jnp.int32) * rpd
    cdt = jnp.complex64 if rdt == jnp.float32 else jnp.complex128
    b = jnp.asarray(b, cdt)
    if b.shape != (m,):
        raise ValueError(f"b must have shape ({m},), got {b.shape}")
    b_pad = jnp.zeros((m_pad,), cdt).at[:m].set(b)
    return dr_s, di_s, row0s, b_pad, rpd, m_pad, rdt


def lsqr_sharded_zdia(
    A,
    b,
    damp: float = 0.0,
    *,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    options: Optional[LSQROptions] = None,
    **option_overrides,
):
    """Row-partitioned distributed solve for a COMPLEX banded (ZDIA)
    operator: the plane-split sharded counterpart of
    :func:`lsqr_sharded_dia` (round-5 item: the one single-chip fast
    path that had no sharded sibling). Each device owns a contiguous row
    block of the two real stripe planes; x/v/w stay replicated, the
    adjoint's conjugation is a sign in the plane combination, and the
    transpose product reduces with one complex psum per iteration.
    ``options.pair`` streams both products from one local plane pass."""
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    m, n = A.m, A.n
    dr_s, di_s, row0s, b_pad, rpd, m_pad, rdt = _prep_zdia_shards(
        A, b, mesh, axis_name)

    itnlim = opts.resolve_itnlim(n)
    solver_kw = dict(
        itnlim=itnlim,
        wantse=opts.wantse,
        nconv=opts.nconv,
        record_trace=opts.record_trace,
        safe_norms=opts.safe_norms,
        debug_log=opts.debug_log,
        scalar_dtype=(str(jnp.dtype(opts.scalar_dtype))
                      if opts.scalar_dtype is not None else None),
        fused=bool(opts.pair),
        pair=bool(opts.pair),
    )
    offsets = A.offsets

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(dr_l, di_l, row0_l, b_local, damp_, atol_, btol_, conlim_):
        op = _LocalZDIAShard(
            dr=dr_l[0],
            di=di_l[0],
            row0=row0_l[0],
            m=rpd,
            n=n,
            offsets=offsets,
            axis=axis_name,
            global_m=m,
            global_m_pad=m_pad,
        )
        return _lsqr_impl(
            op, b_local.reshape(-1), damp_, atol_, btol_, conlim_,
            **solver_kw
        )

    return jax.jit(run)(*_globalize(
        mesh,
        dr_s,
        di_s,
        row0s,
        b_pad,
        jnp.asarray(damp, rdt),
        jnp.asarray(opts.atol, rdt),
        jnp.asarray(opts.btol, rdt),
        jnp.asarray(opts.conlim, rdt),
    ))


def _dia_sibling_sharded(impl, n_scalars):
    """Factory for the sibling solvers over the banded row partition."""

    def solve(A, b, *scalars, mesh=None, axis_name="rows",
              itnlim=None, safe_norms=True, default_itnlim=None, **impl_kw):
        mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
        data_s, row0s, b_pad, rpd, m_pad, dtype = _prep_dia_shards(
            A, b, mesh, axis_name)
        m, n = A.m, A.n
        if itnlim is None:
            itnlim = default_itnlim(m, n)
        kw = dict(itnlim=int(itnlim), safe_norms=safe_norms, **impl_kw)
        offsets = A.offsets

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), P(axis_name))
                     + (P(),) * n_scalars,
            out_specs=P(),
            check_vma=False,
        )
        def run(data_l, row0_l, b_local, *sc):
            op = _LocalDIAShard(
                data=data_l[0].astype(dtype),
                row0=row0_l[0],
                m=rpd,
                n=n,
                offsets=offsets,
                axis=axis_name,
                global_m=m,
                global_m_pad=m_pad,
            )
            return impl(op, b_local.reshape(-1), *sc, **kw)

        return jax.jit(run)(*_globalize(
            mesh, data_s, row0s, b_pad,
            *[jnp.asarray(s, dtype) for s in scalars]))

    return solve


def lsmr_sharded_dia(A, b, damp=0.0, *, mesh=None, axis_name="rows",
                     atol=1e-6, btol=1e-6, conlim=0.0, itnlim=None,
                     safe_norms=True, pair=False):
    """Row-partitioned distributed LSMR for a banded (DIA) operator (see
    :func:`lsqr_sharded_dia` for the partition/collective layout).
    ``pair=True`` streams both products from one local stripe pass."""
    from ..lsmr import _lsmr_impl

    return _dia_sibling_sharded(_lsmr_impl, 4)(
        A, b, damp, atol, btol, conlim, mesh=mesh, axis_name=axis_name,
        itnlim=itnlim, safe_norms=safe_norms,
        default_itnlim=lambda m, n: min(m, n), record_trace=False,
        pair=bool(pair))


def craig_sharded_dia(A, b, *, mesh=None, axis_name="rows",
                      atol=1e-6, btol=1e-6, itnlim=None, safe_norms=True,
                      pair=False):
    """Row-partitioned distributed CRAIG for a banded (DIA) operator."""
    from ..craig import _craig_impl

    return _dia_sibling_sharded(_craig_impl, 2)(
        A, b, atol, btol, mesh=mesh, axis_name=axis_name,
        itnlim=itnlim, safe_norms=safe_norms,
        default_itnlim=lambda m, n: min(m, n), pair=bool(pair))


def cgls_sharded_dia(A, b, damp=0.0, *, mesh=None, axis_name="rows",
                     atol=1e-6, btol=1e-6, itnlim=None, safe_norms=True,
                     pair=False):
    """Row-partitioned distributed CGLS for a banded (DIA) operator."""
    from ..cgls import _cgls_impl

    return _dia_sibling_sharded(_cgls_impl, 3)(
        A, b, damp, atol, btol, mesh=mesh, axis_name=axis_name,
        itnlim=itnlim, safe_norms=safe_norms,
        default_itnlim=lambda m, n: 4 * n, pair=bool(pair))


# ---------------------------------------------------------------------------
# 2-D (rows x cols) sharding — large-m AND large-n scaling
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _Local2DShard(LinearOperator):
    """Per-device view of a 2-D block partition of A inside shard_map.

    Device (r, c) of a ('rows', 'cols') mesh owns the COO entries of the
    (m_local, n_local) block at (r*m_local, c*n_local), the u-rows of its
    row block (replicated across the 'cols' axis) and the x/v/w-columns of
    its column block (replicated across the 'rows' axis). This is the
    scaling answer for problems where BOTH m and n outgrow one device
    (SURVEY.md §2.2's row/column sharding; reference mode-2 loop
    lsqr.f90:188-192 is the all-ranks-touch-all-of-x pattern the column
    axis removes).

    Per iteration exactly three collectives:
      matvec:  local block product -> psum over 'cols'
      rmatvec: local transpose product -> psum over 'rows'
      norms:   scalar ssq psum over the vector's own axis (solver hooks
               axis_name_m/axis_name_n)
    """

    vals: jax.Array
    rows: jax.Array   # local row indices in [0, m_local)
    cols: jax.Array   # local col indices in [0, n_local)
    m: int = dataclasses.field(metadata=dict(static=True))   # local rows
    n: int = dataclasses.field(metadata=dict(static=True))   # local cols
    axis_m: str = dataclasses.field(metadata=dict(static=True))
    axis_n: str = dataclasses.field(metadata=dict(static=True))
    global_m: int = dataclasses.field(metadata=dict(static=True))
    global_n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def axis_name_m(self):  # u-norms complete with psum over the row axis
        return self.axis_m

    @property
    def axis_name_n(self):  # v/x-norms complete with psum over the col axis
        return self.axis_n

    def matvec(self, x: jax.Array) -> jax.Array:
        partial_ = jax.ops.segment_sum(
            self.vals * x[self.cols], self.rows, num_segments=self.m
        )
        return jax.lax.psum(partial_, self.axis_n)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        # adjoint: conjugate transpose for complex values (see _LocalRowShard)
        vals = (
            jnp.conj(self.vals)
            if jnp.issubdtype(self.vals.dtype, jnp.complexfloating)
            else self.vals
        )
        partial_ = jax.ops.segment_sum(
            vals * y[self.rows], self.cols, num_segments=self.n
        )
        return jax.lax.psum(partial_, self.axis_m)


def _shard_coo_2d(A: COOOperator, ndev_r: int, ndev_c: int):
    """Bucket COO entries into a (ndev_r, ndev_c) block grid with equalized
    nnz (zero padding), local indices."""
    rows = np.asarray(A.rows)
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    m, n = A.m, A.n
    m_pad = -(-m // ndev_r) * ndev_r
    n_pad = -(-n // ndev_c) * ndev_c
    rpd = m_pad // ndev_r
    cpd = n_pad // ndev_c
    dev_r = rows // rpd
    dev_c = cols // cpd
    bucket = dev_r * ndev_c + dev_c
    order = np.argsort(bucket, kind="stable")
    rows, cols, vals, bucket = rows[order], cols[order], vals[order], bucket[order]
    counts = np.bincount(bucket, minlength=ndev_r * ndev_c)
    nnz_max = max(int(counts.max()) if counts.size else 0, 1)
    out_vals = np.zeros((ndev_r, ndev_c, nnz_max), vals.dtype)
    out_rows = np.zeros((ndev_r, ndev_c, nnz_max), np.int32)
    out_cols = np.zeros((ndev_r, ndev_c, nnz_max), np.int32)
    start = 0
    for b in range(ndev_r * ndev_c):
        cnt = int(counts[b])
        r, c = divmod(b, ndev_c)
        sl = slice(start, start + cnt)
        out_vals[r, c, :cnt] = vals[sl]
        out_rows[r, c, :cnt] = rows[sl] - r * rpd
        out_cols[r, c, :cnt] = cols[sl] - c * cpd
        start += cnt
    return (
        jnp.asarray(out_vals),
        jnp.asarray(out_rows),
        jnp.asarray(out_cols),
        m_pad,
        n_pad,
    )


def lsqr_sharded_2d(
    A,
    b,
    damp: float = 0.0,
    *,
    mesh: Optional[Mesh] = None,
    mesh_shape: Optional[tuple] = None,
    axis_names: tuple = ("rows", "cols"),
    options: Optional[LSQROptions] = None,
    **option_overrides,
) -> LSQRResult:
    """LSQR over a 2-D (rows x cols) block partition of A.

    Every vector is sharded along its own dimension: u/b over 'rows',
    x/v/w/se over 'cols' — nothing is replicated at full length, so both
    m and n scale past one device's memory. A (1, C) mesh gives pure
    column sharding (huge-n under-determined problems); (R, 1) recovers
    the row-sharded solve.

    Returns a fully gathered (host-side) LSQRResult identical to
    :func:`lsqr_tpu.lsqr` up to reduction-order rounding.
    """
    if not isinstance(A, COOOperator):
        raise TypeError("lsqr_sharded_2d expects a COOOperator")
    opts = options or LSQROptions()
    if option_overrides:
        opts = opts.replace(**option_overrides)

    if mesh is None:
        if mesh_shape is None:
            raise ValueError("pass mesh= or mesh_shape=(R, C)")
        mesh = make_mesh_2d(mesh_shape, axis_names)
    ax_r, ax_c = axis_names
    ndev_r = mesh.shape[ax_r]
    ndev_c = mesh.shape[ax_c]
    m, n = A.m, A.n

    vals_s, rows_s, cols_s, m_pad, n_pad = _shard_coo_2d(A, ndev_r, ndev_c)
    rpd = m_pad // ndev_r
    cpd = n_pad // ndev_c

    dtype = opts.dtype or jnp.result_type(jnp.asarray(b).dtype, vals_s.dtype)
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from ..config import default_dtype

        dtype = default_dtype()
    b = jnp.asarray(b, dtype)
    if b.shape != (m,):
        raise ValueError(f"b must have shape ({m},), got {b.shape}")
    b_pad = jnp.zeros((m_pad,), dtype).at[:m].set(b)

    itnlim = opts.resolve_itnlim(n)
    solver_kw = dict(
        itnlim=itnlim,
        wantse=opts.wantse,
        nconv=opts.nconv,
        record_trace=opts.record_trace,
        safe_norms=opts.safe_norms,
        debug_log=opts.debug_log,
        scalar_dtype=(str(jnp.dtype(opts.scalar_dtype))
                      if opts.scalar_dtype is not None else None),
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(ax_r, ax_c), P(ax_r, ax_c), P(ax_r, ax_c), P(ax_r),
                  P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(vals_l, rows_l, cols_l, b_local, damp_, atol_, btol_, conlim_):
        op = _Local2DShard(
            vals=vals_l[0, 0].astype(dtype),
            rows=rows_l[0, 0],
            cols=cols_l[0, 0],
            m=rpd,
            n=cpd,
            axis_m=ax_r,
            axis_n=ax_c,
            global_m=m,
            global_n=n,
        )
        res = _lsqr_impl(
            op, b_local.reshape(-1), damp_, atol_, btol_, conlim_, **solver_kw
        )
        # x (and se) live column-sharded inside the mesh; gather them so the
        # caller sees the ordinary full-length result
        x_full = jax.lax.all_gather(res.x, ax_c, tiled=True)[:n]
        se_full = (
            jax.lax.all_gather(res.se, ax_c, tiled=True)[:n]
            if res.se is not None
            else None
        )
        return res._replace(x=x_full, se=se_full)

    return jax.jit(run)(
        *_globalize(
            mesh,
            vals_s.astype(dtype),
            rows_s,
            cols_s,
            b_pad,
            jnp.asarray(damp, _rdt(dtype)),
            jnp.asarray(opts.atol, _rdt(dtype)),
            jnp.asarray(opts.btol, _rdt(dtype)),
            jnp.asarray(opts.conlim, _rdt(dtype)),
        )
    )


def _sharded_2d_prep(A, b, mesh, axis_names, dtype_hint=None):
    """Common 2-D plumbing: block-partitioned COO shards + padded b."""
    from ..ops.coo import COOOperator

    if not isinstance(A, COOOperator):
        raise TypeError("2-D sharded solvers expect a COOOperator")
    ax_r, ax_c = axis_names
    ndev_r = mesh.shape[ax_r]
    ndev_c = mesh.shape[ax_c]
    m, n = A.m, A.n
    vals_s, rows_s, cols_s, m_pad, n_pad = _shard_coo_2d(A, ndev_r, ndev_c)
    dtype = dtype_hint or jnp.result_type(jnp.asarray(b).dtype, vals_s.dtype)
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from ..config import default_dtype

        dtype = default_dtype()
    b = jnp.asarray(b, dtype)
    if b.shape != (m,):
        raise ValueError(f"b must have shape ({m},), got {b.shape}")
    b_pad = jnp.zeros((m_pad,), dtype).at[:m].set(b)
    rpd = m_pad // ndev_r
    cpd = n_pad // ndev_c
    return vals_s, rows_s, cols_s, b_pad, rpd, cpd, dtype


def _make_2d_runner(mesh, axis_names, rpd, cpd, m, n, dtype, impl, n_scalars):
    """shard_map wrapper shared by the 2-D sibling solvers: builds the
    local block operator, runs `impl(op, b_local, *scalars)`, all_gathers
    the column-sharded x."""
    ax_r, ax_c = axis_names

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(ax_r, ax_c), P(ax_r, ax_c), P(ax_r, ax_c), P(ax_r))
                 + (P(),) * n_scalars,
        out_specs=P(),
        check_vma=False,
    )
    def run(vals_l, rows_l, cols_l, b_local, *scalars):
        op = _Local2DShard(
            vals=vals_l[0, 0].astype(dtype),
            rows=rows_l[0, 0],
            cols=cols_l[0, 0],
            m=rpd,
            n=cpd,
            axis_m=ax_r,
            axis_n=ax_c,
            global_m=m,
            global_n=n,
        )
        res = impl(op, b_local.reshape(-1), *scalars)
        x_full = jax.lax.all_gather(res.x, ax_c, tiled=True)[:n]
        return res._replace(x=x_full)

    return run


def lsmr_sharded_2d(
    A, b, damp: float = 0.0, *,
    mesh: Optional[Mesh] = None,
    mesh_shape: Optional[tuple] = None,
    axis_names: tuple = ("rows", "cols"),
    atol: float = 1e-6, btol: float = 1e-6, conlim: float = 0.0,
    itnlim: Optional[int] = None, safe_norms: bool = True,
):
    """LSMR over a 2-D (rows x cols) block partition (see
    :func:`lsqr_sharded_2d` for the partition/collective layout)."""
    from ..lsmr import _lsmr_impl

    if mesh is None:
        mesh = make_mesh_2d(mesh_shape, axis_names)
    vals_s, rows_s, cols_s, b_pad, rpd, cpd, dtype = _sharded_2d_prep(
        A, b, mesh, axis_names)
    if itnlim is None:
        itnlim = min(A.m, A.n)
    kw = dict(itnlim=int(itnlim), safe_norms=safe_norms,
              record_trace=False)

    def impl(op, bl, damp_, atol_, btol_, conlim_):
        return _lsmr_impl(op, bl, damp_, atol_, btol_, conlim_, **kw)

    run = _make_2d_runner(mesh, axis_names, rpd, cpd, A.m, A.n, dtype,
                          impl, 4)
    return jax.jit(run)(*_globalize(
        mesh, vals_s.astype(dtype), rows_s, cols_s, b_pad,
        jnp.asarray(damp, _rdt(dtype)), jnp.asarray(atol, _rdt(dtype)),
        jnp.asarray(btol, _rdt(dtype)), jnp.asarray(conlim, _rdt(dtype))))


def craig_sharded_2d(
    A, b, *,
    mesh: Optional[Mesh] = None,
    mesh_shape: Optional[tuple] = None,
    axis_names: tuple = ("rows", "cols"),
    atol: float = 1e-6, btol: float = 1e-6,
    itnlim: Optional[int] = None, safe_norms: bool = True,
):
    """CRAIG over a 2-D (rows x cols) block partition."""
    from ..craig import _craig_impl

    if mesh is None:
        mesh = make_mesh_2d(mesh_shape, axis_names)
    vals_s, rows_s, cols_s, b_pad, rpd, cpd, dtype = _sharded_2d_prep(
        A, b, mesh, axis_names)
    if itnlim is None:
        itnlim = min(A.m, A.n)
    kw = dict(itnlim=int(itnlim), safe_norms=safe_norms)

    def impl(op, bl, atol_, btol_):
        return _craig_impl(op, bl, atol_, btol_, **kw)

    run = _make_2d_runner(mesh, axis_names, rpd, cpd, A.m, A.n, dtype,
                          impl, 2)
    return jax.jit(run)(*_globalize(
        mesh, vals_s.astype(dtype), rows_s, cols_s, b_pad,
        jnp.asarray(atol, _rdt(dtype)), jnp.asarray(btol, _rdt(dtype))))


def cgls_sharded_2d(
    A, b, damp: float = 0.0, *,
    mesh: Optional[Mesh] = None,
    mesh_shape: Optional[tuple] = None,
    axis_names: tuple = ("rows", "cols"),
    atol: float = 1e-6, btol: float = 1e-6,
    itnlim: Optional[int] = None, safe_norms: bool = True,
):
    """CGLS over a 2-D (rows x cols) block partition."""
    from ..cgls import _cgls_impl

    if mesh is None:
        mesh = make_mesh_2d(mesh_shape, axis_names)
    vals_s, rows_s, cols_s, b_pad, rpd, cpd, dtype = _sharded_2d_prep(
        A, b, mesh, axis_names)
    if itnlim is None:
        itnlim = 4 * A.n
    kw = dict(itnlim=int(itnlim), safe_norms=safe_norms)

    def impl(op, bl, damp_, atol_, btol_):
        return _cgls_impl(op, bl, damp_, atol_, btol_, **kw)

    run = _make_2d_runner(mesh, axis_names, rpd, cpd, A.m, A.n, dtype,
                          impl, 3)
    return jax.jit(run)(*_globalize(
        mesh, vals_s.astype(dtype), rows_s, cols_s, b_pad,
        jnp.asarray(damp, _rdt(dtype)), jnp.asarray(atol, _rdt(dtype)),
        jnp.asarray(btol, _rdt(dtype))))


# ---------------------------------------------------------------------------
# Distributed sibling solvers: LSMR and CRAIG over the same row partition
# ---------------------------------------------------------------------------


def _prep_row_shards(A, b, mesh, axis_name, dtype=None):
    """Shared prologue for the row-partitioned sibling solvers: partition a
    COO operator (or accept a prebuilt ShardedCOO), pad b, pick a dtype."""
    ndev = mesh.shape[axis_name]
    if isinstance(A, COOOperator):
        sharded = shard_coo(A, ndev)
    elif isinstance(A, ShardedCOO):
        sharded = A
        if sharded.ndev != ndev:
            raise ValueError(
                f"ShardedCOO was built for {sharded.ndev} devices, mesh has {ndev}"
            )
    else:
        raise TypeError("expected a COOOperator or ShardedCOO")
    dtype = dtype or jnp.result_type(jnp.asarray(b).dtype, sharded.vals.dtype)
    if not jnp.issubdtype(dtype, jnp.inexact):  # ints -> default float
        from ..config import default_dtype

        dtype = default_dtype()
    b = jnp.asarray(b, dtype)
    if b.shape != (sharded.m,):
        raise ValueError(f"b must have shape ({sharded.m},), got {b.shape}")
    b_pad = jnp.zeros((sharded.m_pad,), dtype).at[: sharded.m].set(b)
    return sharded, b_pad, dtype


def lsmr_sharded(
    A,
    b,
    damp: float = 0.0,
    *,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    atol: float = 1e-6,
    btol: float = 1e-6,
    conlim: float = 1e8,
    itnlim: Optional[int] = None,
    record_trace: bool = False,
    safe_norms: bool = True,
):
    """Row-partitioned distributed LSMR (see :func:`lsqr_tpu.lsmr`).

    Same partition/collective structure as :func:`lsqr_sharded` — the LSMR
    recurrence is also O(1) scalar work per iteration, replicated on every
    device; only the transpose product and the u-norms cross the mesh.
    """
    from ..lsmr import _lsmr_impl

    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    sharded, b_pad, dtype = _prep_row_shards(A, b, mesh, axis_name)
    if itnlim is None:
        itnlim = min(sharded.m, sharded.n)
    solver_kw = dict(
        itnlim=int(itnlim), record_trace=record_trace, safe_norms=safe_norms
    )
    rpd = sharded.m_pad // mesh.shape[axis_name]
    n = sharded.n

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(vals_s, rows_s, cols_s, b_local, damp_, atol_, btol_, conlim_):
        op = _LocalRowShard(
            vals=vals_s[0], rows=rows_s[0], cols=cols_s[0],
            m=rpd, n=n, axis=axis_name, global_m=sharded.m,
        )
        return _lsmr_impl(
            op, b_local.reshape(-1), damp_, atol_, btol_, conlim_, **solver_kw
        )

    return jax.jit(run)(
        *_globalize(
            mesh,
            sharded.vals.astype(dtype),
            sharded.rows,
            sharded.cols,
            b_pad,
            jnp.asarray(damp, _rdt(dtype)),
            jnp.asarray(atol, _rdt(dtype)),
            jnp.asarray(btol, _rdt(dtype)),
            jnp.asarray(conlim, _rdt(dtype)),
        )
    )


def cgls_sharded(
    A,
    b,
    damp: float = 0.0,
    *,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    atol: float = 1e-6,
    btol: float = 1e-6,
    itnlim: Optional[int] = None,
    safe_norms: bool = True,
):
    """Row-partitioned distributed CGLS (see :func:`lsqr_tpu.cgls`)."""
    from ..cgls import _cgls_impl

    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    sharded, b_pad, dtype = _prep_row_shards(A, b, mesh, axis_name)
    if itnlim is None:
        itnlim = 4 * sharded.n
    solver_kw = dict(itnlim=int(itnlim), safe_norms=safe_norms)
    rpd = sharded.m_pad // mesh.shape[axis_name]
    n = sharded.n

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(vals_s, rows_s, cols_s, b_local, damp_, atol_, btol_):
        op = _LocalRowShard(
            vals=vals_s[0], rows=rows_s[0], cols=cols_s[0],
            m=rpd, n=n, axis=axis_name, global_m=sharded.m,
        )
        return _cgls_impl(op, b_local.reshape(-1), damp_, atol_, btol_,
                          **solver_kw)

    return jax.jit(run)(
        *_globalize(
            mesh,
            sharded.vals.astype(dtype),
            sharded.rows,
            sharded.cols,
            b_pad,
            jnp.asarray(damp, _rdt(dtype)),
            jnp.asarray(atol, _rdt(dtype)),
            jnp.asarray(btol, _rdt(dtype)),
        )
    )


def craig_sharded(
    A,
    b,
    *,
    mesh: Optional[Mesh] = None,
    axis_name: str = "rows",
    atol: float = 1e-6,
    btol: float = 1e-6,
    itnlim: Optional[int] = None,
    safe_norms: bool = True,
):
    """Row-partitioned distributed CRAIG (see :func:`lsqr_tpu.craig`)."""
    from ..craig import _craig_impl

    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    sharded, b_pad, dtype = _prep_row_shards(A, b, mesh, axis_name)
    if itnlim is None:
        itnlim = min(sharded.m, sharded.n)
    solver_kw = dict(itnlim=int(itnlim), safe_norms=safe_norms)
    rpd = sharded.m_pad // mesh.shape[axis_name]
    n = sharded.n

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(vals_s, rows_s, cols_s, b_local, atol_, btol_):
        op = _LocalRowShard(
            vals=vals_s[0], rows=rows_s[0], cols=cols_s[0],
            m=rpd, n=n, axis=axis_name, global_m=sharded.m,
        )
        return _craig_impl(op, b_local.reshape(-1), atol_, btol_, **solver_kw)

    return jax.jit(run)(
        *_globalize(
            mesh,
            sharded.vals.astype(dtype),
            sharded.rows,
            sharded.cols,
            b_pad,
            jnp.asarray(atol, _rdt(dtype)),
            jnp.asarray(btol, _rdt(dtype)),
        )
    )
