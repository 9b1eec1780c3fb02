"""Port conformance: every scenario x every port path, against the
reference's dense solve.

Shaped like ``tests/test_conformance.py``.  Each scenario is built from
seed 0 at smoke size by both packages; the datasets must be equal, and
under one ``SolverConfig(num_iters=200, rho=1.9)`` the port on the CPU —
``dense``, ``pallas`` with ``fused=False`` (the unfused path) and
``pallas`` with ``fused=True`` — must match the reference's dense solve:
final ``w`` within 1e-4, objective trace within rtol 1e-4 / atol 1e-6
(same iteration, another framework's summation order).  The unfused path
must match the port's own dense solve within 1e-6 (on the CPU they differ
only in the plain ops) and must really call ``ops.tv_prox`` on every TV
scenario and ``ops.batched_affine`` on every squared-loss one.  The
``federated_sync`` column — the message-passing runtime in synchronous
mode (``backend="federated"``: full participation, one local prox step,
no compression) — is held to the reference's dense solve as the other
paths are, and to the port's own dense solve within 1e-6 on ``w`` and
rtol 1e-6 on the objective trace (the reference's ``federated_sync``
bounds): it runs the dense iteration operation for operation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Solver as JSolver                      # noqa: E402
from repro.api import SolverConfig as JConfig                # noqa: E402
from repro.scenarios import SCENARIOS as J_SCENARIOS         # noqa: E402
from repro.scenarios import get_scenario as j_get            # noqa: E402
from repro_torch.api import Solver, SolverConfig             # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.scenarios import SCENARIOS, get_scenario    # noqa: E402

CONF = dict(num_iters=200, rho=1.9)
PATHS = {"dense": dict(backend="dense"),
         "pallas_unfused": dict(backend="pallas", fused=False),
         "pallas_fused": dict(backend="pallas", fused=True),
         "federated_sync": dict(backend="federated")}
GRAPH_FIELDS = ("src", "dst", "weights", "inc_edges", "inc_signs")
DATA_FIELDS = ("x", "y", "sample_mask", "labeled_mask")

_reference: dict = {}


def reference(name: str):
    """(reference instance, reference dense SolveResult), once per
    scenario."""
    if name not in _reference:
        inst = j_get(name).build(seed=0, smoke=True)
        _reference[name] = (inst, JSolver(JConfig(**CONF)).run(inst.problem))
    return _reference[name]


def port_instance(name: str):
    return get_scenario(name).build(seed=0, smoke=True, device="cpu")


def test_port_zoo_is_the_reference_zoo():
    assert sorted(SCENARIOS) == sorted(J_SCENARIOS)
    assert len(SCENARIOS) >= 8
    for name, s in SCENARIOS.items():
        j = J_SCENARIOS[name]
        for f in ("loss", "regularizer", "lam", "lam_path", "metric",
                  "loss_kwargs", "graph_family"):
            assert getattr(s, f) == getattr(j, f), (name, f)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_dataset_matches_reference(name):
    tinst = port_instance(name)
    jinst = j_get(name).build(seed=0, smoke=True)
    tg, jg = tinst.problem.graph, jinst.problem.graph
    assert tg.num_nodes == jg.num_nodes
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    for f in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(tinst.problem.data, f).numpy(),
                                      np.asarray(getattr(jinst.problem.data,
                                                         f)), err_msg=f)
    np.testing.assert_array_equal(tinst.w_true.numpy(),
                                  np.asarray(jinst.w_true))
    np.testing.assert_array_equal(tinst.dataset.labeled_nodes,
                                  jinst.dataset.labeled_nodes)
    assert tinst.problem.lam == jinst.problem.lam
    assert type(tinst.problem.loss).__name__ == \
        type(jinst.problem.loss).__name__


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_port_path_conforms_to_reference_dense(name, path):
    jinst, ref = reference(name)
    res = Solver(SolverConfig(**CONF, **PATHS[path])).run(
        port_instance(name).problem)
    w_diff = float(np.max(np.abs(res.w.numpy() - np.asarray(ref.w))))
    assert w_diff <= 1e-4, (name, path, w_diff)
    ref_obj = np.asarray(ref.objective)
    assert tuple(res.objective.shape) == ref_obj.shape
    np.testing.assert_allclose(res.objective.numpy(), ref_obj, rtol=1e-4,
                               atol=1e-6)
    assert float(res.diagnostics["dual_infeasibility"]) <= 1e-6
    metrics = port_instance(name).evaluate(res.w)
    assert all(np.isfinite(v) for v in metrics.values()), metrics


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_unfused_path_calls_kernel_hooks_and_matches_dense(name,
                                                            monkeypatch):
    """The unfused pallas path goes through ``ops.tv_prox`` (TV) and
    ``ops.batched_affine`` (squared loss) once per iteration each — counted
    through monkeypatched wrappers, so the hooks cannot be bypassed
    unseen — and lands within 1e-6 of the port's dense solve."""
    calls = {"tv_prox": 0, "batched_affine": 0}

    def counted(op):
        fn = getattr(ops, op)

        def wrapper(*args):
            calls[op] += 1
            return fn(*args)
        return wrapper

    for op in calls:
        monkeypatch.setattr(ops, op, counted(op))
    problem = port_instance(name).problem
    unfused = Solver(SolverConfig(**CONF, **PATHS["pallas_unfused"])).run(
        problem)
    want = {"tv_prox": CONF["num_iters"] if get_scenario(
                name).regularizer == "tv" else 0,
            "batched_affine": CONF["num_iters"] if get_scenario(
                name).loss == "squared" else 0}
    assert calls == want, (name, calls)
    dense = Solver(SolverConfig(**CONF, **PATHS["dense"])).run(problem)
    np.testing.assert_allclose(unfused.w.numpy(), dense.w.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(unfused.objective.numpy(),
                               dense.objective.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_federated_sync_matches_port_dense(name):
    problem = port_instance(name).problem
    dense = Solver(SolverConfig(**CONF, **PATHS["dense"])).run(problem)
    fed = Solver(SolverConfig(**CONF, **PATHS["federated_sync"])).run(problem)
    np.testing.assert_allclose(fed.w.numpy(), dense.w.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(fed.objective.numpy(),
                               dense.objective.numpy(), rtol=1e-6)
    E = problem.graph.num_edges
    assert fed.diagnostics["comm"]["up_messages"] == CONF["num_iters"] * E
