"""Tests for auxiliary subsystems: checkpoint/resume segmented solves and
the LIS-style report formatting (SURVEY.md §5)."""

import numpy as np
import pytest

import lsqr_tpu as lt
from lsqr_tpu.utils.checkpoint import (
    load_state,
    lsqr_checkpointed,
    save_state,
)
from lsqr_tpu.utils.printing import format_exit_block, format_report


def _problem(rng, m=120, n=80, nnz=600):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    A = lt.coo_operator(m, n, vals, rows, cols)
    b = rng.standard_normal(m)
    return A, b


def test_segmented_matches_oneshot(rng):
    A, b = _problem(rng)
    ref = lt.lsqr(A, b, 0.1, atol=1e-10, btol=1e-10, itnlim=300)
    res = lsqr_checkpointed(
        A, b, 0.1, segment_iters=7, atol=1e-10, btol=1e-10, itnlim=300
    )
    assert int(res.istop) == int(ref.istop)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    np.testing.assert_allclose(float(res.rnorm), float(ref.rnorm), rtol=0)


def test_checkpoint_save_resume(rng, tmp_path):
    A, b = _problem(rng)
    ref = lt.lsqr(A, b, 0.05, atol=1e-10, btol=1e-10, itnlim=300)

    # run only the first 3 segments, checkpointing each
    ckpt = str(tmp_path / "state.npz")
    seen = []

    def stop_early(seg, carry):
        seen.append(int(carry.itn))
        if seg >= 3:
            raise KeyboardInterrupt  # simulate preemption

    with pytest.raises(KeyboardInterrupt):
        lsqr_checkpointed(
            A, b, 0.05, segment_iters=5, checkpoint_path=ckpt,
            on_segment=stop_early, atol=1e-10, btol=1e-10, itnlim=300,
        )
    assert seen == [5, 10, 15]

    # resume from disk and finish: identical to the uninterrupted solve
    res = lsqr_checkpointed(
        A, b, 0.05, segment_iters=50, resume_from=ckpt,
        atol=1e-10, btol=1e-10, itnlim=300,
    )
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_state_roundtrip(rng, tmp_path):
    from lsqr_tpu.solver import _Carry
    from lsqr_tpu.utils.checkpoint import _segment  # noqa: F401

    A, b = _problem(rng)
    res = lsqr_checkpointed(
        A, b, 0.0, segment_iters=4,
        checkpoint_path=str(tmp_path / "s.npz"), itnlim=8,
    )
    carry = load_state(str(tmp_path / "s.npz"))
    assert isinstance(carry, _Carry)
    assert int(carry.itn) == 8 or int(carry.istop) != 0


def test_zero_rhs_segmented(rng):
    A, _ = _problem(rng)
    res = lsqr_checkpointed(A, np.zeros(A.m), 0.0, segment_iters=10, itnlim=50)
    assert int(res.istop) == 0
    assert int(res.itn) == 0


def test_report_formatting(rng):
    A, b = _problem(rng)
    res = lt.lsqr(A, b, 0.1, record_trace=True, atol=1e-8, btol=1e-8, itnlim=200)
    report = format_report(
        res, m=A.m, n=A.n, itnlim=200, damped=True,
        header_params=dict(damp=0.1, atol=1e-8, btol=1e-8, itnlim=200),
    )
    assert "Itn" in report and "Norm Abar" in report
    assert "Exit  LSQR" in report
    assert "damped least-squares solution" in report
    # parameter-echo header block (lsqr.f90:589-595)
    assert "Enter LSQR" in report
    assert f"The matrix  A  has{A.m:7d} rows   and{A.n:7d} columns" in report
    assert "damp   =" in report and "itnlim =" in report
    # exit block alone works without a trace
    res2 = lt.lsqr(A, b, 0.0, itnlim=200)
    block = format_exit_block(res2)
    assert "istop" in block
    with pytest.raises(ValueError):
        from lsqr_tpu.utils.printing import format_iteration_log

        format_iteration_log(res2)


def test_debug_log_prints(rng, capfd):
    """Live iteration logging via jax.debug.print with the reference's
    throttling (lsqr.f90:813-837)."""
    import jax.numpy as jnp

    dense = rng.standard_normal((30, 12))
    res = lt.lsqr(
        lt.DenseOperator(a=jnp.asarray(dense)),
        rng.standard_normal(30),
        0.0,
        debug_log=True,
        atol=1e-6,
        btol=1e-6,
        itnlim=50,
    )
    res.x.block_until_ready()
    out = capfd.readouterr().out
    lines = [l for l in out.splitlines() if l.strip()]
    assert len(lines) >= int(res.itn)  # n<=40 => every iteration printed
    assert lines[0].split()[0] == "1"


def test_format_summary_all_solvers(rng):
    """format_summary works for every solver family's result type."""
    import jax.numpy as jnp

    from lsqr_tpu.ops.linop import as_operator
    from lsqr_tpu.utils.printing import format_summary

    A = as_operator(jnp.asarray(rng.standard_normal((50, 25))))
    b = jnp.asarray(rng.standard_normal(50))
    for solver, name in ((lt.lsqr, "LSQR"), (lt.lsmr, "LSMR"),
                         (lt.cgls, "CGLS")):
        out = format_summary(solver(A, b))
        assert f"Exit  {name}" in out and "istop" in out
        assert out.count("\n") >= 3
    # craig needs a consistent system
    n = 25
    sq = rng.standard_normal((n, n)) + 4 * np.eye(n)
    res = lt.craig(as_operator(jnp.asarray(sq)),
                   jnp.asarray(sq @ rng.standard_normal(n)))
    assert "Exit  CRAIG" in format_summary(res)


def test_sibling_checkpointed_bit_identical(rng):
    """LSMR/CGLS/CRAIG on the generic segmented runner: segment boundaries
    must not change a single bit vs the one-shot solves."""
    from lsqr_tpu import cgls, craig, lsmr
    from lsqr_tpu.ops.structured import dia_operator
    from lsqr_tpu.utils.checkpoint import (
        cgls_checkpointed, craig_checkpointed, lsmr_checkpointed,
    )

    m = n = 600
    data = rng.standard_normal((3, m))
    data[1] += 5.0
    A = dia_operator(m, n, (-1, 0, 2), data)
    b = rng.standard_normal(m)

    ref = lsmr(A, b, 0.01, atol=1e-9, btol=1e-9)
    res = lsmr_checkpointed(A, b, 0.01, atol=1e-9, btol=1e-9,
                            segment_iters=7)
    assert int(res.istop) == int(ref.istop) and int(res.itn) == int(ref.itn)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))

    refg = cgls(A, b, 0.05, atol=1e-8, btol=1e-8)
    resg = cgls_checkpointed(A, b, 0.05, atol=1e-8, btol=1e-8,
                             segment_iters=6)
    assert int(resg.itn) == int(refg.itn)
    np.testing.assert_array_equal(np.asarray(resg.x), np.asarray(refg.x))

    xt = rng.standard_normal(n)
    bc = np.asarray(A.matvec(xt))
    refc = craig(A, bc, atol=1e-9, btol=1e-9)
    resc = craig_checkpointed(A, bc, atol=1e-9, btol=1e-9, segment_iters=4)
    assert int(resc.itn) == int(refc.itn)
    np.testing.assert_array_equal(np.asarray(resc.x), np.asarray(refc.x))


def test_sibling_checkpoint_preemption_resume(rng, tmp_path):
    """Mid-solve preemption + resume-from-disk for LSMR: identical to the
    uninterrupted solve (the lsqr_checkpointed contract, extended)."""
    from lsqr_tpu import lsmr
    from lsqr_tpu.ops.structured import dia_operator
    from lsqr_tpu.utils.checkpoint import lsmr_checkpointed

    m = n = 600
    data = rng.standard_normal((3, m))
    data[1] += 5.0
    A = dia_operator(m, n, (-1, 0, 2), data)
    b = rng.standard_normal(m)
    ref = lsmr(A, b, 0.02, atol=1e-10, btol=1e-10)

    ckpt = str(tmp_path / "lsmr.npz")
    seen = []

    def stop_early(seg, carry):
        seen.append(int(carry.itn))
        if seg >= 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        lsmr_checkpointed(A, b, 0.02, atol=1e-10, btol=1e-10,
                          segment_iters=5, checkpoint_path=ckpt,
                          on_segment=stop_early)
    assert seen == [5, 10]
    res = lsmr_checkpointed(A, b, 0.02, atol=1e-10, btol=1e-10,
                            segment_iters=100, resume_from=ckpt)
    assert int(res.itn) == int(ref.itn)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))


def test_load_state_complex_checkpoint_real_dtype_request(rng, tmp_path):
    """A real `dtype` request on a COMPLEX checkpoint casts vector fields to
    the matching complex precision instead of silently dropping the
    imaginary parts (ADVICE.md round 3)."""
    import jax.numpy as jnp

    from lsqr_tpu.utils.checkpoint import lsqr_checkpointed, load_state

    m, n, nnz = 60, 40, 300
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = (rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz))
    A = lt.coo_operator(m, n, vals, rows, cols)
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    ckpt = str(tmp_path / "z.npz")
    lsqr_checkpointed(A, b, 0.05, segment_iters=4, checkpoint_path=ckpt,
                      itnlim=8)
    carry = load_state(ckpt, dtype=np.float32)
    assert carry.u.dtype == jnp.complex64
    assert carry.x.dtype == jnp.complex64
    assert np.abs(np.asarray(carry.u).imag).max() > 0
    # scalar recurrence fields stay REAL at the requested precision
    assert carry.rhobar.dtype == jnp.float32
