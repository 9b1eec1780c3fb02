"""The port stands alone and refuses loudly what it does not run yet.

  * no module of ``src/repro_torch/`` (nor ``chip_smoke.py``, the
    examples ``examples/*_torch.py`` or ``experiments/run_torch.py``)
    imports ``jax`` or the reference package ``repro`` — the serving
    layer (``repro_torch.serving``) among them — and the public surfaces
    ``repro_torch.api`` and ``repro_torch.core`` export the reference's
    names,
  * entry points default to the CUDA card and raise without one instead
    of moving to the CPU (``solve_path`` and ``solve_many`` run on their
    problems' device, which defaults to the card; a plan file loads onto
    the card unless the caller names a device),
  * every backend of the reference is registered and runs on the CPU —
    the sharded ones on a one-rank mesh, while a mesh of many ranks
    without a process group raises — and what the port leaves out, as
    the reference does (lambda paths and batches on the sharded
    backends), raises ``NotImplementedError``.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop                             # noqa: E402
from repro_torch.api import Problem, Solver, SolverConfig   # noqa: E402
from repro_torch.api import solve_many, solve_path          # noqa: E402
from repro_torch.api.backends import get_backend, solve_pallas  # noqa: E402
from repro_torch.core.graph import build_graph              # noqa: E402
from repro_torch.data.synthetic import make_sbm_regression  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("*_torch.py"))
              + [ROOT / "experiments" / "run_torch.py",
                 ROOT / "chip_smoke.py"])


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, (path, bad)


def test_examples_and_harness_are_checked():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"examples/quickstart_torch.py", "examples/scenario_tour_torch.py",
            "examples/federated_round_trip_torch.py",
            "examples/serving_stream_torch.py",
            "examples/observability_tour_torch.py",
            "examples/distributed_nlasso_torch.py",
            "experiments/run_torch.py"} <= names


@pytest.mark.parametrize("package", ["api", "core"])
def test_public_surface_equals_reference(package):
    import importlib

    port = importlib.import_module(f"repro_torch.{package}")
    ref = importlib.import_module(f"repro.{package}")
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert getattr(port, name) is not None, name


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_serving_modules_are_checked():
    names = {p.name for p in PORT_FILES if p.parent.name == "serving"}
    assert names == {"__init__.py", "batch.py", "cache.py", "ledger.py",
                     "queue.py", "service.py", "stream.py"}


@pytest.mark.parametrize("entry", ["make_sbm_regression", "build_graph",
                                   "problem_create", "state_from_arrays",
                                   "solve_path", "solve_many",
                                   "load_plans", "make_host_mesh"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry,
                                                           tmp_path):
    if entry == "load_plans":
        from repro_torch.serving import PlanCache, SolveService
        PlanCache().save(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            SolveService().load_plans(str(tmp_path))
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "make_sbm_regression":
            make_sbm_regression(seed=0)
        elif entry == "build_graph":
            build_graph(np.array([[0, 1]]), np.ones(1, np.float32), 2)
        elif entry in ("problem_create", "solve_path", "solve_many"):
            ds = make_sbm_regression(seed=0, device="cpu")
            if entry == "solve_path":
                solve_path(Problem.create(ds.graph, ds.data, 1e-3),
                           [1e-3, 1e-2])
            elif entry == "solve_many":
                solve_many([Problem.create(ds.graph, ds.data, 1e-3)])
            else:
                Problem.create(ds.graph, ds.data, 1e-3)
        elif entry == "make_host_mesh":
            from repro_torch.core.mesh import make_host_mesh
            make_host_mesh()
        else:
            interop.state_from_arrays(np.zeros((2, 2)), np.zeros((1, 2)))


@pytest.fixture(scope="module")
def cpu_problem():
    ds = make_sbm_regression(seed=0, device="cpu")
    return Problem.create(ds.graph, ds.data, 1e-3, device="cpu")


@pytest.mark.parametrize("overrides", [dict(tol=1e-4),
                                       dict(dtype="bfloat16")])
@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_unported_solver_options_raise(cpu_problem, overrides, backend):
    """``tol`` and bf16 storage are ported: both run on the fused pallas
    path and ``tol`` on the dense one too; bf16 off the fused path still
    raises, naming "bfloat16", as in the reference."""
    cfg = SolverConfig(num_iters=10, fused=True, **overrides)
    if backend == "dense" and "dtype" in overrides:
        with pytest.raises(NotImplementedError, match="bfloat16"):
            Solver(cfg.replace(backend="dense")).run(cpu_problem)
        return
    if backend == "pallas":
        result = solve_pallas(cpu_problem, cfg)
    else:
        result = Solver(cfg.replace(backend="dense")).run(cpu_problem)
    assert result.w.dtype == torch.float32
    assert bool(torch.isfinite(result.w).all())
    if "tol" in overrides:
        assert 0 < result.diagnostics["iterations"] <= cfg.num_iters


def test_unported_paths_raise(cpu_problem):
    """What the reference does not run either stays refused, naming the
    backends it runs: a lambda path or a batch on a sharded backend
    (``tests/test_serving_batch.py:100``), and bf16 storage there."""
    for backend in ("sharded", "sharded_fused"):
        cfg = SolverConfig(num_iters=10, backend=backend)
        with pytest.raises(NotImplementedError,
                           match=f"'dense' or 'pallas', got '{backend}'"):
            solve_path(cpu_problem, [1e-3, 1e-2], cfg)
        with pytest.raises(NotImplementedError,
                           match=f"'dense' or 'pallas', got '{backend}'"):
            solve_many([cpu_problem], cfg)
        with pytest.raises(NotImplementedError, match="bfloat16"):
            Solver(cfg.replace(dtype="bfloat16")).run(cpu_problem)


def test_every_reference_backend_is_registered():
    from repro.api.backends import BACKENDS as J_BACKENDS
    from repro_torch.api.backends import BACKENDS
    assert sorted(BACKENDS) == sorted(J_BACKENDS)
    for name in BACKENDS:
        assert get_backend(name) is BACKENDS[name]


@pytest.mark.parametrize("backend", ["sharded", "sharded_fused"])
def test_sharded_backends_run_on_the_cpu(cpu_problem, backend):
    """Registered, and run on the CPU on a one-rank mesh (the default
    mesh is one rank on the problem's device)."""
    from repro_torch.core.mesh import make_host_mesh
    dense = Solver(SolverConfig(num_iters=20)).run(cpu_problem)
    for mesh in (None, make_host_mesh(1, 1, device="cpu")):
        result = Solver(SolverConfig(num_iters=20, backend=backend,
                                     mesh=mesh)).run(cpu_problem)
        assert result.w.device.type == "cpu"
        assert result.objective.shape == (1,)
        assert float((result.w - dense.w).abs().max()) <= 1e-4


def test_mesh_of_many_ranks_needs_a_process_group():
    """A mesh of more than one rank needs an initialized process group
    of that size; the port's mesh spans one axis of ranks."""
    import torch.distributed as dist

    from repro_torch.core.mesh import make_host_mesh
    assert not (dist.is_available() and dist.is_initialized())
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        make_host_mesh(4, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="model must be 1"):
        make_host_mesh(1, 2, device="cpu")
    mesh = make_host_mesh(1, 1, device="cpu")
    assert (mesh.shape, mesh.rank, mesh.group, mesh.transport) == (
        {"data": 1, "model": 1}, 0, None, None)
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_gather(t) is t and mesh.all_reduce(t, "max") is t
