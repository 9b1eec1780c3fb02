"""Port conformance of the sharded backends: every scenario x ``sharded``
(dense and boundary exchange) and ``sharded_fused``, on a one-rank mesh,
against the reference's dense solve.

The ``sharded`` and ``sharded_fused`` columns of
``tests/test_conformance.py``, held to its bounds: under one
``SolverConfig(num_iters=200, rho=1.9)`` each scenario (built from seed
0 at smoke size by the port, on the CPU) must give a final ``w`` within
1e-4 of the reference's dense solve and a final objective within rtol
1e-4; the sharded backends evaluate metrics once, at the final iterate,
so the trace has length 1.  A scenario a backend does not run must be
refused with ``NotImplementedError`` — here none is: every scenario's
loss has prox parameters and every regularizer is edge-elementwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Solver as JSolver                      # noqa: E402
from repro.api import SolverConfig as JConfig                # noqa: E402
from repro.scenarios import get_scenario as j_get            # noqa: E402
from repro_torch.api import Solver, SolverConfig             # noqa: E402
from repro_torch.core.mesh import make_host_mesh             # noqa: E402
from repro_torch.scenarios import SCENARIOS, get_scenario    # noqa: E402

CONF = dict(num_iters=200, rho=1.9)
COLUMNS = {"sharded_dense": dict(backend="sharded", comm="dense"),
           "sharded_boundary": dict(backend="sharded", comm="boundary"),
           "sharded_fused": dict(backend="sharded_fused")}

_reference: dict = {}


def reference(name: str):
    """The reference's dense SolveResult, once per scenario."""
    if name not in _reference:
        inst = j_get(name).build(seed=0, smoke=True)
        _reference[name] = JSolver(JConfig(**CONF)).run(inst.problem)
    return _reference[name]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("column", sorted(COLUMNS))
def test_sharded_column_conforms_to_reference_dense(name, column):
    ref = reference(name)
    inst = get_scenario(name).build(seed=0, smoke=True, device="cpu")
    res = Solver(SolverConfig(**CONF, **COLUMNS[column],
                              mesh=make_host_mesh(1, 1, device="cpu"))).run(
        inst.problem)
    w_diff = float(np.max(np.abs(res.w.numpy() - np.asarray(ref.w))))
    assert w_diff <= 1e-4, (name, column, w_diff)
    assert tuple(res.objective.shape) == (1,)
    np.testing.assert_allclose(float(res.objective[-1]),
                               float(np.asarray(ref.objective)[-1]),
                               rtol=1e-4)
    assert float(res.diagnostics["dual_infeasibility"]) <= 1e-6
    assert res.diagnostics["halo_exchange_bytes"] >= 0.0
    metrics = inst.evaluate(res.w)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
