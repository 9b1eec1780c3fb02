"""The port stands alone and refuses loudly what it does not run yet.

  * no module of ``src/repro_torch/`` (nor ``chip_smoke.py``) imports
    ``jax`` or the reference package ``repro`` — the serving layer
    (``repro_torch.serving``) among them,
  * entry points default to the CUDA card and raise without one instead
    of moving to the CPU (``solve_path`` and ``solve_many`` run on their
    problems' device, which defaults to the card; a plan file loads onto
    the card unless the caller names a device),
  * what the port leaves out raises ``NotImplementedError``.
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
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
                                   "load_plans"])
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
    for name in ("sharded", "sharded_fused"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_backend(name)
