"""Scenario zoo: registered (graph x data x loss x regularizer) workloads
(counterpart of ``repro.scenarios``).

    from repro_torch.scenarios import SCENARIOS, get_scenario

    inst = get_scenario("chain_changepoint").build(seed=0, smoke=True)
    result = Solver(SolverConfig(num_iters=500)).run(inst.problem)
    inst.evaluate(result.w)   # {"objective": ..., "weight_mse": ..., ...}

Importing the package loads the built-in zoo (``repro_torch.scenarios.
zoo``); from one seed each scenario draws the same graph and data as the
reference's.
"""
from repro_torch.scenarios.base import (SCENARIOS, Scenario,
                                        ScenarioInstance, get_scenario,
                                        list_scenarios, register_scenario)
from repro_torch.scenarios import zoo  # noqa: F401  (registers the built-ins)

__all__ = [
    "SCENARIOS", "Scenario", "ScenarioInstance", "get_scenario",
    "list_scenarios", "register_scenario", "zoo",
]
