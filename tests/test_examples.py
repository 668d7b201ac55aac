"""Smoke-run the small CPU examples in-process.

Catches API drift between the library and the documented usage (the
examples double as the README's executable documentation). Only the
examples that finish in seconds on CPU are run; the card- and memory-scale
ones (03, 09) and the minutes-long sweeps are exercised by their own
subsystem tests instead.
"""

import pathlib
import runpy

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


@pytest.mark.parametrize(
    "name",
    [
        "01_readme_3x3.py",
        "02_damped_least_squares.py",
        "06_solver_family.py",
        "13_hybrid_regularization.py",
        "15_mixed_precision_refinement.py",
        "16_complex_least_squares.py",
    ],
)
def test_example_runs(name, capsys):
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    out = capsys.readouterr().out
    assert "istop" in out or "x" in out  # printed something sensible
