"""The port's tol engines against the reference's, and their one-fetch
contract, on the CPU.

The reference (``tests/test_device_stop.py``) stops a tol solve inside a
``lax.while_loop`` and makes exactly one device->host transfer, the
fetch of the stopping iteration.  The port keeps the stop word on the
device (``engine.loop.device_loop``: on the CPU the loop reads the
flag's own bytes and ends at the stop; on the card a CUDA graph under an
IF node on the flag, replayed over the budget) and routes its one
transfer through ``engine.loop.device_fetch``.  Here:

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
    ``warm_cfg`` keeps it;
  * no block runs after the stop (a counting ``run_block``, and the
    engine step's and fused kernel's calls in a solve), and the plain
    version (``device_loop_plain``: every block enqueued, those after the
    stop computed and dropped) gives the same state and traces bit for
    bit.

On the card (``-m cuda``; they skip here): the graph engine against the
plain loop, bit for bit, for the dense, fused, batched and masked tol
solves, with one fetch a solve under sync debug mode "error"; the
kernel's launch counter counting block 0 alone, its own count of its
runs every block to the stop, and a trace naming the replays.
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
    """Nothing after the stop moves the state: the tol solve's state
    equals a fixed-budget solve of exactly the stopping iteration."""
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


def test_device_loop_runs_only_the_blocks_to_the_stop():
    """A counting ``run_block``: the loop calls it once a block up to
    and including the stopping block, and not after; the plain version
    calls it for the whole budget and leaves the same state, records of
    the blocks that ran, and count."""
    def make(calls):
        def run_block(state, active):
            calls.append(1)
            (x,) = state
            x_new = torch.where(active, x / 2, x)
            return (x_new,), (x_new,), x_new
        return run_block

    for tol, stop_block in ((0.3, 2), (10.0, 1), (0.0, 8)):
        calls, plain_calls = [], []
        got = loop.device_loop(make(calls), (torch.ones(()),), num_iters=8,
                               metric_every=1, tol=tol)
        plain = loop.device_loop_plain(make(plain_calls),
                                       (torch.ones(()),), num_iters=8,
                                       metric_every=1, tol=tol)
        assert len(calls) == stop_block and len(plain_calls) == 8
        assert int(got[2]) == int(plain[2]) == stop_block
        assert torch.equal(got[0][0], plain[0][0])
        # the records the caller keeps: the blocks that ran
        assert torch.equal(got[1][0][:stop_block],
                           plain[1][0][:stop_block])


@pytest.mark.parametrize("path", ["dense", "pallas_fused"])
def test_tol_solve_computes_only_to_the_stop(path, monkeypatch):
    """In a solve: the dense engine's step runs once an iteration up to
    the stop (the fused kernel's plain version once a metric block, a
    single-block layout), not for the budget; the plain loop runs them
    for the whole budget and gives the same ``w``, ``u`` and traces bit
    for bit."""
    from repro_torch.api import backends
    from repro_torch.kernels import ops

    problem = port_problem()
    # a budget of 1000: past the stop (660), and the plain loop below
    # computes all of it
    cfg = SolverConfig(**dict(TOL_CONF, num_iters=1000), **PATHS[path])
    name, owner = (("engine_pd_step", backends) if path == "dense"
                   else ("pd_step", ops))
    calls = []
    real = getattr(owner, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(owner, name, counted)
    got = Solver(cfg).run(problem)
    it = got.diagnostics["iterations"]
    per_block = 1 if path == "pallas_fused" else cfg.metric_every
    assert 0 < it < cfg.num_iters
    assert len(calls) == it // cfg.metric_every * per_block
    calls.clear()
    monkeypatch.setattr(backends, "device_loop", loop.device_loop_plain)
    plain = Solver(cfg).run(problem)
    assert len(calls) == cfg.num_iters // cfg.metric_every * per_block
    assert plain.diagnostics["iterations"] == it
    for leaf in ("w", "u", "objective", "residual"):
        assert torch.equal(getattr(got, leaf), getattr(plain, leaf)), leaf


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph engine has no CPU "
                    "mode")


def _card_runs(problem):
    """The four tol engines on ``problem`` (on the card), each a
    function returning its result(s)."""
    from repro_torch.api import solve_many, solve_path

    cfg = SolverConfig(**TOL_CONF)
    pallas = cfg.replace(backend="pallas", fused=False)
    return {
        "dense": lambda: Solver(cfg).run(problem),
        "fused": lambda: Solver(cfg.replace(backend="pallas",
                                            fused=True)).run(problem),
        "batched": lambda: solve_many(
            [problem, problem.with_lam(2e-2)], pallas),
        "masked": lambda: solve_path(
            problem, (0.3, 0.003, 0.1, 0.03),
            pallas.replace(warm_iters=1000, final_iters=400))}


def _leaves(result):
    if isinstance(result, list):
        return [x for r in result for x in _leaves(r)]
    return [result.w, result.u, result.objective, result.residual,
            torch.as_tensor(np.asarray(result.diagnostics["iterations"]))]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "fused", "batched", "masked"])
def test_cuda_graph_engine_matches_plain_loop(engine, monkeypatch):
    """On the card: the graph engine's result equals the plain loop's
    bit for bit (``w``, ``u``, traces, stopping iterations), with one
    fetch a solve (two for a path: its warm solve's and the sweep's)
    under sync debug mode "error"."""
    _need_card()
    from repro_torch.api import backends, solver

    problem = get_scenario("sbm_regression").build(
        seed=0, smoke=True, lam=1e-2, device="cuda").problem
    run = _card_runs(problem)[engine]
    run()                                            # warm-up
    torch.cuda.synchronize()
    before = loop.device_fetch.calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert loop.device_fetch.calls - before == (2 if engine == "masked"
                                                else 1)
    monkeypatch.setattr(backends, "device_loop", loop.device_loop_plain)
    monkeypatch.setattr(solver, "device_loop", loop.device_loop_plain)
    plain = run()
    for a, b in zip(_leaves(got), _leaves(plain), strict=True):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_cuda_graph_engine_counts_only_real_launches(tmp_path):
    """On the card: the fused tol engine's wrapper counts block 0's launch
    alone (a call inside the capture is recorded, not launched), the
    kernel's own count of its runs holds every block to the stop, and a
    trace names each replay of the captured block."""
    _need_card()
    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.kernels.pd_step import fused_pd_step

    problem = get_scenario("sbm_regression").build(
        seed=0, smoke=True, lam=1e-2, device="cuda").problem
    run = _card_runs(problem)["fused"]
    run()                                            # warm-up
    torch.cuda.synchronize()
    before = fused_pd_step.launches
    _build.reset_executions()
    with obs.profile.trace(str(tmp_path)):
        got = run()
        torch.cuda.synchronize()
    blocks = got.diagnostics["iterations"] // TOL_CONF["metric_every"]
    assert blocks > 1
    assert fused_pd_step.launches - before == 1
    assert _build.executions("fused_pd_step") == blocks
    trace = (tmp_path / "trace.json").read_text()
    assert "solve_metric_block_replay" in trace
