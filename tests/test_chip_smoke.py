"""chip_smoke.py, bench.py and the sweep script on the CPU: every smoke
phase at a tiny size (the pair kernel in interpret mode, the mesh phase on
four of the suite's virtual devices), the refusal to measure anything
without a GPU, and where the compile cache goes."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from lsqr_tpu.ops.triton_pair import PAIR_MAX_HALO  # noqa: E402
from lsqr_tpu.utils import compile_cache  # noqa: E402


def test_phase_banded_f32_tiny():
    out = chip_smoke.phase_banded_f32(m=4096)
    assert out["operator"] == "DIASharedOperator"
    assert out["rel_err_x"] <= out["tol_x"]
    assert out["product_rel_max_err"] <= out["tol_products"]
    assert out["xcheck_inform"] in (1, 2, 3)
    assert out["precision"] == "float32"


def test_phase_pair_tiny():
    out = chip_smoke.phase_pair(m=2048, ragged=2048 - 37, itnlim=5,
                                turns=1, interpret=True)
    assert {c["m"] for c in out["kernel_checks"]} == {2048, 2011}
    assert {c["storage"] for c in out["kernel_checks"]} == {"float32",
                                                           "bfloat16"}
    for c in out["kernel_checks"]:
        assert max(c["u_rel_max_err"], c["z_rel_max_err"]) <= 1e-5
    # the widest halo the auto route sends to the kernel is checked too
    g = max(max(abs(k) for k in c["offsets"]) for c in out["kernel_checks"])
    assert g == PAIR_MAX_HALO
    for storage in ("float32", "bfloat16"):
        t = out["lsqr_ms_per_iter"][storage]
        assert set(t) == {"separate_xla"}   # no Triton route on the CPU
        assert t["separate_xla"]["itn"] == 5


def test_phase_general_f32_tiny():
    out = chip_smoke.phase_general_f32(m=4096, n=512, nnz_per_row=8)
    assert out["operator"] != "COOOperator" or out["nnz"] > 0
    assert out["istop"] in (1, 2) and out["istop_reference"] in (1, 2)
    assert (abs(out["rel_residual"] - out["rel_residual_reference"])
            <= out["tol_rel_residual_diff"] * out["rel_residual_reference"])


def test_phase_complex64_tiny():
    out = chip_smoke.phase_complex64(m=4096)
    assert out["operator"] == "ZDIAOperator"
    assert out["rel_err_x"] <= out["tol_x"]


def test_phase_dense_f32_tiny():
    out = chip_smoke.phase_dense_f32(m=512, n=256)
    assert out["rel_err_x"] <= out["tol_x"]


def test_phase_suite_f64():
    out = chip_smoke.phase_suite_f64()
    assert out["problems"] == 18
    assert all(r["istop"] == 3 for r in out["results"])


def test_phase_mesh_on_four_virtual_devices():
    out = chip_smoke.phase_mesh(4, m=1 << 14)
    assert out["devices"] == 4
    assert out["itn"] == out["itn_one_device"]
    assert out["rel_diff_x"] <= out["tol_rel_diff_x"]
    assert len(out["peak_bytes_in_use"]) == 4


def test_phase_check_raises():
    with pytest.raises(AssertionError, match="exceeds tolerance"):
        chip_smoke.check("x", 1.0, 0.5)
    with pytest.raises(AssertionError):
        chip_smoke.check("nan", float("nan"), 1.0)


def test_dia_reference_products_match_dense(rng):
    offs, st = chip_smoke.banded_stripes(50, 2, seed=1, shift=3.0)
    dense = np.zeros((50, 50))
    for d, k in enumerate(offs):
        for i in range(50):
            if 0 <= i + k < 50:
                dense[i, i + k] = st[d, i]
    x = rng.standard_normal(50)
    np.testing.assert_allclose(chip_smoke.dia_apply(st, offs, x, 50),
                               dense @ x, rtol=1e-12)
    np.testing.assert_allclose(chip_smoke.dia_apply_t(st, offs, x, 50),
                               dense.T @ x, rtol=1e-12)


@pytest.mark.parametrize("argv", [[], ["--mesh", "4"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.main(argv)
    assert '"ok": true' not in capsys.readouterr().out


def test_bench_refuses_cpu(capsys):
    import bench

    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_sweep_refuses_cpu():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import dia_sweep

    with pytest.raises(SystemExit, match="needs a GPU"):
        dia_sweep.main([])


def test_spread_refuses_cpu():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import spread

    for stage in ("suite", "general"):
        with pytest.raises(SystemExit, match="needs a GPU"):
            spread.main([stage])


def test_spread_general_tiny():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import spread

    lines = []
    spread.general(lambda **kv: lines.append(kv), 2, m=4096, n=512,
                   nnz_per_row=8)
    assert [r["rep"] for r in lines] == [0, 1]
    for r in lines:
        assert r["rel_residual_diff"] <= 1e-4
        assert np.isfinite(r["atr_ratio"])


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.compile_cache_dir("/some/checkout") == str(
        tmp_path / "c")


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.compile_cache_dir(ROOT)
    assert path == os.path.join(ROOT, ".jax_cache")
    # fixed: the same on every call, never built from a pid or the time
    assert compile_cache.compile_cache_dir(ROOT) == path
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read()


def test_use_compile_cache_sets_jax(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.use_compile_cache(ROOT) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
