"""The control on the card at a size a test run holds: the program with
its own float32 path switched on (the configuration's ``control``
settings, for the solve and its rescue) must come out not correct, and
the program as configured correct, on the same traffic.  Run on the
card: ``python3 -m pytest benchmark/tests -q -m cuda``; the readings at
the cells' own sizes come from ``benchmark/control.py``."""

import pytest

import harness
from conftest import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("mpc_lp.sweep128", "mpc_lp.tick16"))
def test_the_float32_control_is_not_correct(cell, card):
    spec = tiny(cell, horizon=40, lanes=16, check_share=1.0)
    control = spec["config"]["control"]
    for seed in (1, 2, 3):
        result, _ = harness.execute(spec, seed, 1.0, False, device="cuda",
                                    settings=control["settings"],
                                    rescue=control["rescue"])
        assert not result["correct"], seed
        result, _ = harness.execute(spec, seed, 1.0, False, device="cuda")
        assert result["correct"], seed
