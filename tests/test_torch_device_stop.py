"""The port's tol engines against the reference's, and their one-fetch
contract, on the CPU.

The reference (``tests/test_device_stop.py``) stops a tol solve inside a
``lax.while_loop`` and makes exactly one device->host transfer, the
fetch of the stopping iteration.  The port enqueues every block of the
budget behind a device stop word instead (``engine.loop.device_loop``)
and routes its one transfer through ``engine.loop.device_fetch``.  Here:

  * the port's dense and fused tol solves stop at the reference's
    iteration on the same inputs, with final ``w`` within 1e-4 and the
    objective trace of the same length within rtol 1e-4 (the
    cross-backend tolerances of ``tests/test_conformance.py``: same
    iterates, another framework's summation order);
  * a tol solve calls ``device_fetch`` exactly once and nothing else
    reads a tensor on the host: ``Tensor.item``, ``__bool__``,
    ``__float__``, ``__int__`` and ``tolist`` raise during the solve; a
    ``tol=None`` solve fetches nothing;
  * with continuation both phases stop on ``tol``, as the reference's
    ``warm_cfg`` keeps it.

One difference from the reference is by design: on the dense path the
port keeps computing the budget's blocks after the stop and drops their
results (``torch.where`` on the stop word), where the reference's while
loop stops computing; the fused kernel reads the stop word and writes
nothing.  The state and traces are the reference's either way; the
test below checks that the blocks after the stop leave the state as it
was at the stop.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Solver as JSolver                      # noqa: E402
from repro.api import SolverConfig as JConfig                # noqa: E402
from repro.scenarios import get_scenario as j_get            # noqa: E402
from repro_torch.api import Solver, SolverConfig             # noqa: E402
from repro_torch.engine import loop                          # noqa: E402
from repro_torch.scenarios import get_scenario               # noqa: E402

TOL_CONF = dict(num_iters=4000, rho=1.9, metric_every=10, tol=5e-3,
                compute_diagnostics=False)
PATHS = {"dense": dict(backend="dense"),
         "pallas_fused": dict(backend="pallas", fused=True),
         "pallas_unfused": dict(backend="pallas", fused=False)}

_reference: dict = {}


def reference(path: str, **extra):
    """The reference's tol solve on sbm_regression (seed 0, smoke,
    lam 1e-2), once per configuration."""
    key = (path, tuple(sorted(extra.items())))
    if key not in _reference:
        inst = j_get("sbm_regression").build(seed=0, smoke=True, lam=1e-2)
        cfg = JConfig(**TOL_CONF, **PATHS[path], **extra)
        _reference[key] = JSolver(cfg).run(inst.problem)
    return _reference[key]


def port_problem():
    return get_scenario("sbm_regression").build(
        seed=0, smoke=True, lam=1e-2, device="cpu").problem


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Make every implicit host read of a tensor raise."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("a tensor was read on the host during the "
                             "solve")
    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
            m.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize("path", sorted(PATHS))
def test_tol_solve_matches_reference(path):
    want = reference(path)
    got = Solver(SolverConfig(**TOL_CONF, **PATHS[path])).run(port_problem())
    it = want.diagnostics["iterations"]
    assert 0 < it < TOL_CONF["num_iters"]
    assert got.diagnostics["iterations"] == it
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-4)
    assert got.objective.shape == np.asarray(want.objective).shape
    assert got.objective.shape[0] == it // TOL_CONF["metric_every"]
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-4)
    # the block residual is a max of |w+ - w| / tau over nearly converged
    # iterates: a difference of two close numbers over tau >= 1/29, so the
    # ~1e-6 drift between the frameworks' iterates shows as up to ~3e-5
    np.testing.assert_allclose(got.residual.numpy(),
                               np.asarray(want.residual), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("path", ["dense", "pallas_fused"])
def test_continuation_phases_stop_on_tol(path):
    extra = dict(continuation=True, warm_iters=2000, final_iters=2000)
    want = reference(path, **extra)
    got = Solver(SolverConfig(**TOL_CONF, **PATHS[path], **extra)).run(
        port_problem())
    it = want.diagnostics["iterations"]
    assert 0 < it < extra["final_iters"]
    assert got.diagnostics["iterations"] == it
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-4)


@pytest.mark.parametrize("path", ["dense", "pallas_fused"])
def test_tol_solve_is_one_fetch(path, monkeypatch):
    problem = port_problem()
    cfg = SolverConfig(**TOL_CONF, **PATHS[path])
    Solver(cfg).run(problem)             # plans and caches the layout
    before = loop.device_fetch.calls
    with no_host_reads(monkeypatch):
        result = Solver(cfg).run(problem)
    assert loop.device_fetch.calls == before + 1
    it = result.diagnostics["iterations"]
    assert isinstance(it, int) and 0 < it < cfg.num_iters
    assert result.objective.shape == (it // cfg.metric_every,)


@pytest.mark.parametrize("path", ["dense", "pallas_fused"])
def test_tol_none_fetches_nothing(path, monkeypatch):
    problem = port_problem()
    cfg = SolverConfig(num_iters=100, rho=1.9, metric_every=10,
                       compute_diagnostics=False, **PATHS[path])
    Solver(cfg).run(problem)
    before = loop.device_fetch.calls
    with no_host_reads(monkeypatch):
        result = Solver(cfg).run(problem)
    assert loop.device_fetch.calls == before
    assert result.objective.shape == (10,)


@pytest.mark.parametrize("path", ["dense", "pallas_fused"])
def test_blocks_after_the_stop_leave_the_state(path):
    """The budget's blocks after the stop are enqueued but change
    nothing: the tol solve's state equals a fixed-budget solve of
    exactly the stopping iteration."""
    problem = port_problem()
    stopped = Solver(SolverConfig(**TOL_CONF, **PATHS[path])).run(problem)
    it = stopped.diagnostics["iterations"]
    fixed = Solver(SolverConfig(
        num_iters=it, rho=TOL_CONF["rho"],
        metric_every=TOL_CONF["metric_every"], compute_diagnostics=False,
        **PATHS[path])).run(problem)
    assert torch.equal(stopped.w, fixed.w)
    assert torch.equal(stopped.u, fixed.u)
    assert torch.equal(stopped.objective, fixed.objective)


def test_device_loop_counts_blocks_on_the_device():
    """``device_loop`` on a toy block whose residual falls by half each
    block: block 0 always runs, the stop lands after the first block at
    or below tol, and the traces are preallocated at the budget."""
    def run_block(state, active):
        (x,) = state
        x_new = torch.where(active, x / 2, x)
        return (x_new,), (x_new,), x_new

    for tol, stop_block in ((0.3, 2), (10.0, 1), (0.0, 8)):
        state, (trace,), its = loop.device_loop(
            run_block, (torch.ones(()),), num_iters=8, metric_every=1,
            tol=tol)
        assert its.dtype == torch.int32 and its.device.type == "cpu"
        assert int(its) == stop_block
        assert trace.shape == (8,)
        np.testing.assert_allclose(float(state[0]), 0.5 ** stop_block)
