"""Complex DIA (banded) operator — plane-split streaming storage.

The reference is real-only (/root/reference/src/lsqr_kinds.F90:16-24);
complex matrices are this build's extension. Banded complex matrices are
stored by PLANE SPLITTING:

    A = Ar + i*Ai   stored as two real stripe planes (f32 planes for
                    complex64, f64 planes for complex128)

Every product is a fixed combination of real stripe passes:

    A x   : ur = Ar xr - Ai xi,  ui = Ar xi + Ai xr
    A^H y : zr = Ar' yr + Ai' yi,  zi = Ar' yi - Ai' yr

(the conjugation is a SIGN in the combination — no conjugated copy of the
matrix is ever materialized). The hot path is the fused product PAIR of
the bidiagonalization step (u = A(win*c1) - c2*y; z = A^H u with REAL
scalars c1, c2 — the complex Paige-Saunders recurrence keeps all scalars
real): the blocked XLA pair below reads each plane block once for all
four real products, so pair traffic is 8 bytes per complex nnz. complex64
is native on the GPU, so whether the plane split beats a direct complex
DIA product there is an open question (ROADMAP R3).

Reference anchors: the product pair lsqr.f90:681-694; the COO kernels this
format replaces for banded complex problems, lsqr.f90:156-194.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .linop import LinearOperator

__all__ = ["ZDIAOperator", "zdia_operator", "zdia_operator_device",
           "zdia_pair_xla"]

#: blocked complex-pair block size: keeps each fused FMA chain inside XLA's
#: fusion budget. Not timed against whole-vector forms on the GPU (ROADMAP
#: R3 weighs the plane split as a whole)
_ZPAIR_BLOCK = 256 * 1024


def _zdia_matvec_xla(P, Q, xr, xi, offsets, m, n, sign, block=_ZPAIR_BLOCK):
    """(P + i*sign*Q) @ (xr + i*xi) as blocked real stripe passes.

    Each plane block is read once for BOTH output components (4 FMAs per
    diagonal per block). ``sign=-1`` gives the conjugate plane pair, i.e.
    the adjoint combination when P/Q are the transpose stripes."""
    ks = tuple(offsets) or (0,)
    lo = max(0, -min(ks))
    kmax = max(0, max(ks))
    dt = P.dtype
    s = dt.type(sign)
    nb = -(-m // block)
    mp = nb * block
    xp_len = lo + max(n, mp + kmax)
    xpr = jnp.zeros((xp_len,), dt).at[lo : lo + n].set(xr)
    xpi = jnp.zeros((xp_len,), dt).at[lo : lo + n].set(xi)
    Pp, Qp = P, Q
    if mp != m:
        Pp = jnp.pad(P, ((0, 0), (0, mp - m)))
        Qp = jnp.pad(Q, ((0, 0), (0, mp - m)))
    outr, outi = [], []
    for b in range(nb):
        st = b * block
        yr = jnp.zeros((block,), dt)
        yi = jnp.zeros((block,), dt)
        for j, k in enumerate(offsets):
            pj = Pp[j, st : st + block]
            qj = s * Qp[j, st : st + block]
            sr = jax.lax.slice(xpr, (lo + k + st,), (lo + k + st + block,))
            si = jax.lax.slice(xpi, (lo + k + st,), (lo + k + st + block,))
            yr = yr + pj * sr - qj * si
            yi = yi + pj * si + qj * sr
        outr.append(yr)
        outi.append(yi)
    yr = jnp.concatenate(outr)[:m]
    yi = jnp.concatenate(outi)[:m]
    return jax.lax.complex(yr, yi)


def zdia_pair_xla(dr, di, y, win, c1, c2, *, offsets, m, n,
                  block=_ZPAIR_BLOCK):
    """Blocked pure-XLA complex product pair (planes read once per block
    for both products):

        u = (dr + i*di) @ (win * c1) - c2 * y,      z = A^H u

    with REAL scalars c1, c2. Returns (u (m,), z (n,)) complex."""
    ks = tuple(offsets) or (0,)
    kmin, kmax = min(ks), max(ks)
    lo = max(0, -kmin)
    dt = dr.dtype
    nb = -(-m // block)
    mp = nb * block
    xr = (jnp.real(win) * c1).astype(dt)
    xi = (jnp.imag(win) * c1).astype(dt)
    xp_len = lo + max(n, mp + max(0, kmax))
    xpr = jnp.zeros((xp_len,), dt).at[lo : lo + n].set(xr)
    xpi = jnp.zeros((xp_len,), dt).at[lo : lo + n].set(xi)
    ypr = jnp.zeros((mp,), dt).at[:m].set(jnp.real(y).astype(dt))
    ypi = jnp.zeros((mp,), dt).at[:m].set(jnp.imag(y).astype(dt))
    drp, dip = dr, di
    if mp != m:
        drp = jnp.pad(dr, ((0, 0), (0, mp - m)))
        dip = jnp.pad(di, ((0, 0), (0, mp - m)))
    span = kmax - kmin
    zp_len = lo + max(n, mp + max(0, kmax)) + span
    zpr = jnp.zeros((zp_len,), dt)
    zpi = jnp.zeros((zp_len,), dt)
    ur_blocks, ui_blocks = [], []
    for b in range(nb):
        st = b * block
        ubr = (-c2) * jax.lax.slice(ypr, (st,), (st + block,))
        ubi = (-c2) * jax.lax.slice(ypi, (st,), (st + block,))
        rsl, isl = [], []
        for j, k in enumerate(offsets):
            rj = drp[j, st : st + block]
            qj = dip[j, st : st + block]
            rsl.append(rj)
            isl.append(qj)
            sr = jax.lax.slice(xpr, (lo + k + st,), (lo + k + st + block,))
            si = jax.lax.slice(xpi, (lo + k + st,), (lo + k + st + block,))
            ubr = ubr + rj * sr - qj * si
            ubi = ubi + rj * si + qj * sr
        ur_blocks.append(ubr)
        ui_blocks.append(ubi)
        # adjoint partials while the plane blocks are hot:
        #   zr[i+k] += dr[j,i] ur[i] + di[j,i] ui[i]
        #   zi[i+k] += dr[j,i] ui[i] - di[j,i] ur[i]
        zbr = jnp.zeros((block + span,), dt)
        zbi = jnp.zeros((block + span,), dt)
        for j, k in enumerate(offsets):
            zbr = zbr.at[k - kmin : k - kmin + block].add(
                rsl[j] * ubr + isl[j] * ubi)
            zbi = zbi.at[k - kmin : k - kmin + block].add(
                rsl[j] * ubi - isl[j] * ubr)
        s0 = st + kmin + lo
        zpr = zpr.at[s0 : s0 + block + span].add(zbr)
        zpi = zpi.at[s0 : s0 + block + span].add(zbi)
    u = jax.lax.complex(jnp.concatenate(ur_blocks)[:m],
                        jnp.concatenate(ui_blocks)[:m])
    z = jax.lax.complex(jax.lax.slice(zpr, (lo,), (lo + n,)),
                        jax.lax.slice(zpi, (lo,), (lo + n,)))
    return u, z


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ZDIAOperator(LinearOperator):
    """Complex banded m x n matrix as two real DIA stripe planes.

    ``dr[j, i] + 1j*di[j, i] = A[i, i + offsets[j]]`` (row-aligned, shape
    (ndiag, m)); ``tdr/tdi`` are the TRANSPOSE stripe packings of each
    plane (shape (ndiag, n), offsets negated) — the adjoint's conjugation
    is applied as a sign in the product combination, never materialized.
    f32 planes give complex64 products; f64 planes give complex128.
    """

    dr: jax.Array
    di: jax.Array
    tdr: jax.Array
    tdi: jax.Array
    m: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    offsets: tuple = dataclasses.field(metadata=dict(static=True))

    #: solver hook: the pair path may run for complex vectors
    #: (solver._build relaxes its real-only guard on this)
    supports_complex_pair = True

    @property
    def dtype(self):
        return jnp.dtype(
            jnp.complex64 if self.dr.dtype == jnp.float32 else jnp.complex128
        )

    @property
    def nnz(self) -> int:
        # stored complex entries (incl. structural zeros at band edges)
        return self.dr.shape[0] * self.m

    @property
    def toffsets(self) -> tuple:
        return tuple(-k for k in self.offsets)

    def fused_pair(self, *, y, win, c1, c2):
        """u = A(win*c1) - c2*y and z = A^H u in one pass over the planes
        (c1, c2 REAL — see module docstring). Returns (u, z), z
        unnormalized (1/beta commutes with A^H)."""
        return zdia_pair_xla(
            self.dr, self.di, y, win, c1, c2,
            offsets=self.offsets, m=self.m, n=self.n,
        )

    def matvec(self, x: jax.Array) -> jax.Array:
        xr = jnp.real(x).astype(self.dr.dtype)
        xi = jnp.imag(x).astype(self.dr.dtype)
        return _zdia_matvec_xla(
            self.dr, self.di, xr, xi, self.offsets, self.m, self.n, 1
        )

    def rmatvec(self, y: jax.Array) -> jax.Array:
        # A^H = tdr - i*tdi on the transpose stripes: sign=-1 flips the
        # imag plane in the combination (scatter- and conj-copy-free)
        yr = jnp.real(y).astype(self.tdr.dtype)
        yi = jnp.imag(y).astype(self.tdr.dtype)
        return _zdia_matvec_xla(
            self.tdr, self.tdi, yr, yi, self.toffsets, self.n, self.m, -1
        )

    def todense(self) -> jax.Array:
        dense = jnp.zeros((self.m, self.n), self.dtype)
        i = jnp.arange(self.m)
        data = jax.lax.complex(self.dr, self.di)
        for j, k in enumerate(self.offsets):
            cols = i + k
            valid = (cols >= 0) & (cols < self.n)
            dense = dense.at[i, jnp.clip(cols, 0, self.n - 1)].add(
                jnp.where(valid, data[j], 0.0)
            )
        return dense


def _transpose_stripes(plane: np.ndarray, offsets, m, n) -> np.ndarray:
    """tdata[j, c] = plane[j, c - k] on an n-length axis (the packing of
    structured.dia_operator, applied per plane)."""
    t = np.zeros((len(offsets), n), plane.dtype)
    for j, k in enumerate(offsets):
        src_lo, src_hi = max(0, -k), min(m, n - k)
        if src_hi > src_lo:
            t[j, src_lo + k : src_hi + k] = plane[j, src_lo:src_hi]
    return t


def zdia_operator(
    m, n, offsets: Sequence[int], data, *, dtype=None,
) -> ZDIAOperator:
    """Build a ZDIAOperator from complex stripes ``data`` of shape
    (len(offsets), m) with ``data[j, i] = A[i, i + offsets[j]]``
    (out-of-matrix entries zeroed defensively). complex64 input gives f32
    planes; complex128 gives f64 planes."""
    data = np.asarray(data, dtype=dtype if dtype else None)
    if not np.iscomplexobj(data):
        data = data.astype(np.complex64)
    offsets = tuple(int(k) for k in offsets)
    if data.shape != (len(offsets), m):
        raise ValueError(
            f"data must have shape ({len(offsets)}, {m}), got {data.shape}"
        )
    i = np.arange(m)
    mask = np.stack([(i + k >= 0) & (i + k < n) for k in offsets])
    data = data * mask
    rdt = np.float32 if data.dtype == np.complex64 else np.float64
    dr = np.ascontiguousarray(data.real, dtype=rdt)
    di = np.ascontiguousarray(data.imag, dtype=rdt)
    return ZDIAOperator(
        dr=jnp.asarray(dr),
        di=jnp.asarray(di),
        tdr=jnp.asarray(_transpose_stripes(dr, offsets, m, n)),
        tdi=jnp.asarray(_transpose_stripes(di, offsets, m, n)),
        m=int(m),
        n=int(n),
        offsets=offsets,
    )


def zdia_operator_device(
    m, n, offsets: Sequence[int], data: jax.Array,
) -> ZDIAOperator:
    """Build a ZDIAOperator from complex stripes already ON DEVICE (the
    stripes never cross to the host)."""
    offsets = tuple(int(k) for k in offsets)
    nd = len(offsets)
    if data.shape != (nd, m):
        raise ValueError(f"data must have shape ({nd}, {m}), got {data.shape}")
    i = jnp.arange(m)
    mask = jnp.stack([(i + k >= 0) & (i + k < n) for k in offsets])
    rdt = jnp.float32 if data.dtype == jnp.complex64 else jnp.float64
    dr = jnp.real(data).astype(rdt) * mask
    di = jnp.imag(data).astype(rdt) * mask

    def tstripes(plane):
        rows = []
        for j, k in enumerate(offsets):
            row = jnp.zeros((n,), plane.dtype)
            src_lo, src_hi = max(0, -k), min(m, n - k)
            if src_hi > src_lo:
                row = row.at[src_lo + k : src_hi + k].set(
                    plane[j, src_lo:src_hi])
            rows.append(row)
        return jnp.stack(rows)

    return ZDIAOperator(
        dr=dr, di=di, tdr=tstripes(dr), tdi=tstripes(di),
        m=int(m), n=int(n), offsets=offsets,
    )


# ---------------------------------------------------------------------------
# Complex JDIA — plane splitting over the jittered-diagonal format
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ZJDIAOperator(LinearOperator):
    """Complex general-sparse operator: plane-split over two real
    :class:`~lsqr_tpu.ops.jdia.JDIAOperator` packings of the SAME
    sparsity pattern (jitter-bounded diagonals + COO remainder).

    Same arithmetic as :class:`ZDIAOperator` — every product is a fixed
    combination of four real streaming products, and the adjoint's
    conjugation is a SIGN in the combination, never a materialized
    conjugate copy:

        A x   : (Jr xr - Ji xi) + i (Jr xi + Ji xr)
        A^H y : (Jr' yr + Ji' yi) + i (Jr' yi - Ji' yr)

    The two planes duplicate the jitter/base index arrays (int8/int32 —
    small next to the f32 slot values); sharing them is a possible
    follow-up. No fused complex pair kernel yet: `supports_complex_pair`
    stays False and the solvers run the two-product path.
    """

    re: object  # JDIAOperator (real plane)
    im: object  # JDIAOperator (imag plane)

    @property
    def m(self) -> int:
        return self.re.m

    @property
    def n(self) -> int:
        return self.re.n

    @property
    def dtype(self):
        return jnp.dtype(
            jnp.complex64 if self.re.dtype == jnp.float32 else jnp.complex128
        )

    @property
    def nnz(self) -> int:
        return self.re.nnz

    @property
    def fit_fraction(self) -> float:
        return self.re.fit_fraction

    def matvec(self, x: jax.Array) -> jax.Array:
        rdt = self.re.dtype
        xr = jnp.real(x).astype(rdt)
        xi = jnp.imag(x).astype(rdt)
        return jax.lax.complex(
            self.re.matvec(xr) - self.im.matvec(xi),
            self.re.matvec(xi) + self.im.matvec(xr),
        )

    def rmatvec(self, y: jax.Array) -> jax.Array:
        rdt = self.re.dtype
        yr = jnp.real(y).astype(rdt)
        yi = jnp.imag(y).astype(rdt)
        return jax.lax.complex(
            self.re.rmatvec(yr) + self.im.rmatvec(yi),
            self.re.rmatvec(yi) - self.im.rmatvec(yr),
        )

    def todense(self) -> jax.Array:
        return (self.re.todense()
                + 1j * self.im.todense()).astype(self.dtype)


def zjdia_operator(m, n, vals, rows, cols, *, ns_max=16,
                   dtype=None) -> ZJDIAOperator:
    """Build a plane-split complex JDIA operator from complex COO
    triplets (both planes pack the FULL pattern so their jitter slots and
    remainders line up entry-for-entry)."""
    from .jdia import jdia_operator

    vals = np.asarray(vals, dtype=dtype if dtype else None)
    if not np.iscomplexobj(vals):
        vals = vals.astype(np.complex64)
    rdt = np.float32 if vals.dtype == np.complex64 else np.float64
    re = jdia_operator(m, n, vals.real.astype(rdt), rows, cols,
                       ns_max=ns_max, dtype=rdt)
    im = jdia_operator(m, n, vals.imag.astype(rdt), rows, cols,
                       ns_max=ns_max, dtype=rdt)
    return ZJDIAOperator(re=re, im=im)
