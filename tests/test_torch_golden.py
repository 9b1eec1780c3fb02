"""The port's dense solve reproduces the committed golden values.

``tests/golden/<name>.json`` holds the reference's metrics per scenario
(smoke instance, seed 0, ``SolverConfig(num_iters=300, rho=1.9)``, dense
backend; see ``tests/test_golden.py``).  The port's dense solve on the
CPU, scored by its own ``ScenarioInstance.evaluate`` plus the total
variation, must reproduce them at that suite's tolerances (rtol 2e-3,
atol 1e-4).  This file only reads the golden files.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Solver, SolverConfig             # noqa: E402
from repro_torch.scenarios import SCENARIOS, get_scenario    # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
GOLD_CONF = SolverConfig(num_iters=300, rho=1.9)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_reproduces_golden_values(name):
    inst = get_scenario(name).build(seed=0, smoke=True, device="cpu")
    res = Solver(GOLD_CONF).run(inst.problem)
    got = inst.evaluate(res.w)
    got["tv"] = float(inst.problem.graph.total_variation(res.w))
    want = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=2e-3, atol=1e-4,
                                   err_msg=f"{name}.{key}")
