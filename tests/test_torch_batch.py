"""The port's batched solves (``repro_torch.api.solve_many``) against the
reference's, on the CPU.

The reference stacks shape-matched problems along a leading batch axis
and ``jax.vmap``-s its dense engine over them; the port runs them as the
lanes of one solve (``api/backends.py:solve_dense_batched``).  Ported
from ``tests/test_serving_batch.py`` (its four ``solve_many`` tests, on
the same chain problems):

  * the batch reproduces the sequential per-problem solutions, every
    per-problem certificate holds, and the shared (batch-granular)
    iteration count is reported consistently;
  * problems with *different* graph structures but matching shapes
    batch together; genuine shape mismatches are rejected with the
    offending index;
  * fixed-length traces, and warm starts that re-certify at once.

And against the reference's ``solve_many`` on the same inputs: ``w``
within 1e-4, objective traces within rtol 1e-4, the same batch
iteration count, and each problem's certificate the one of its own
iterate, on the dense and the
``pallas`` engine (whose ``batched_affine`` takes one P per problem and
``tv_prox`` one bound per problem, each in one launch for the batch).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (Problem, Solver, SolverConfig,     # noqa: E402
                              solve_many)
from repro_torch.core.graph import chain_graph                  # noqa: E402
from repro_torch.core.losses import NodeData                    # noqa: E402
from repro_torch.engine import certificate                      # noqa: E402
from repro_torch.kernels import ops                             # noqa: E402

CFG = SolverConfig(num_iters=4000, rho=1.9, metric_every=10, tol=1e-3,
                   record_residual=True, backend="dense")


def _chain_problem(v=24, n=2, seed=0, lam=5e-2, weight=1.0):
    rng = np.random.default_rng(seed)
    g = chain_graph(rng, v, weight=weight, device="cpu")
    w_true = np.where(np.arange(v)[:, None] < v // 2, 1.0, -1.0)
    w_true = np.broadcast_to(w_true, (v, n)).astype(np.float32)
    x = rng.standard_normal((v, 4, n)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true)
    y += 0.01 * rng.standard_normal(y.shape).astype(np.float32)
    data = NodeData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                    sample_mask=torch.ones((v, 4)),
                    labeled_mask=torch.ones(v))
    return Problem.create(g, data, lam=lam, device="cpu")


def _reference_chain_problem(**kw):
    """The same problem in the reference (its test's own builder)."""
    import jax.numpy as jnp
    from repro.api import Problem as JProblem
    from repro.core.graph import chain_graph as j_chain
    from repro.core.losses import NodeData as JNodeData

    v, n = kw.get("v", 24), kw.get("n", 2)
    rng = np.random.default_rng(kw.get("seed", 0))
    g = j_chain(rng, v, weight=kw.get("weight", 1.0))
    w_true = np.where(np.arange(v)[:, None] < v // 2, 1.0, -1.0)
    w_true = np.broadcast_to(w_true, (v, n)).astype(np.float32)
    x = rng.standard_normal((v, 4, n)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true)
    y += 0.01 * rng.standard_normal(y.shape).astype(np.float32)
    data = JNodeData(x=jnp.asarray(x), y=jnp.asarray(y),
                     sample_mask=jnp.ones((v, 4), jnp.float32),
                     labeled_mask=jnp.ones(v, jnp.float32))
    return JProblem.create(g, data, lam=kw.get("lam", 5e-2))


# ---------------------------------------------------------------------------
# Ported from tests/test_serving_batch.py
# ---------------------------------------------------------------------------

def test_solve_many_matches_sequential():
    problems = [_chain_problem(seed=s) for s in range(4)]
    batched = solve_many(problems, CFG)
    assert len(batched) == 4
    iters = {r.diagnostics["iterations"] for r in batched}
    assert len(iters) == 1                       # batch-granular stopping
    for p, r in zip(problems, batched):
        seq = Solver(CFG).run(p)
        assert float(r.residual[-1]) <= CFG.tol  # per-problem certificate
        np.testing.assert_allclose(r.w.numpy(), seq.w.numpy(), atol=5e-3)
        # the batch runs at least as long as the slowest member, so the
        # batched estimate is at least as converged as the sequential one
        assert r.diagnostics["iterations"] >= seq.diagnostics["iterations"]


def test_solve_many_batches_different_structures():
    # same shapes, *different* structure hashes (edge weights differ):
    # the graphs' arrays are per-lane operands, so these stack fine
    problems = [_chain_problem(weight=1.0), _chain_problem(weight=2.0)]
    assert (problems[0].graph.structure_hash()
            != problems[1].graph.structure_hash())
    batched = solve_many(problems, CFG)
    for p, r in zip(problems, batched):
        seq = Solver(CFG).run(p)
        np.testing.assert_allclose(r.w.numpy(), seq.w.numpy(), atol=5e-3)


def test_solve_many_warm_starts_and_traces():
    problems = [_chain_problem(seed=s) for s in range(3)]
    cfg = CFG.replace(tol=None, num_iters=50, metric_every=1)
    for r in solve_many(problems, cfg):
        assert r.objective.shape == (50,)        # fixed-length traces
        assert r.residual.shape == (50,)
    # warm-starting each problem from its own certified solution
    # re-certifies at the metric_every iteration floor
    cold = solve_many(problems, CFG)
    warm = solve_many(problems, CFG, w0s=[r.w for r in cold],
                      u0s=[r.u for r in cold])
    assert all(r.diagnostics["iterations"] == CFG.metric_every
               for r in warm)


def test_solve_many_rejects_bad_batches():
    with pytest.raises(ValueError, match=r"problems\[1\]"):
        solve_many([_chain_problem(v=24), _chain_problem(v=32)], CFG)
    with pytest.raises(NotImplementedError, match="backend"):
        solve_many([_chain_problem()], CFG.replace(backend="sharded"))
    with pytest.raises(NotImplementedError, match="continuation"):
        solve_many([_chain_problem()], CFG.replace(continuation=True))
    assert solve_many([], CFG) == []


# ---------------------------------------------------------------------------
# Against the reference's solve_many
# ---------------------------------------------------------------------------

# (seed, lam, weight) per problem: own data draws, own lambdas, two
# structures of one shape
BATCH = [(0, 5e-2, 1.0), (1, 2e-2, 1.0), (2, 5e-2, 2.0), (3, 1e-1, 2.0)]


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("tol", [None, 1e-3])
def test_solve_many_matches_reference(backend, tol, monkeypatch):
    """The same four problems through both packages: ``w`` within 1e-4,
    objective traces within rtol 1e-4, and on a tol run the same
    batch-granular iteration count.  On ``pallas`` the kernels see the
    whole batch in each call: ``batched_affine`` with one P per problem,
    ``tv_prox`` with one bound row per problem."""
    from repro.api import solve_many as j_solve_many
    from repro.api import SolverConfig as JConfig

    seen = []
    for name in ("tv_prox", "batched_affine"):
        real = getattr(ops, name)

        def counted(p, v, _real=real, _name=name):
            seen.append((_name, tuple(p.shape), tuple(v.shape)))
            return _real(p, v)

        monkeypatch.setattr(ops, name, counted)
    conf = dict(num_iters=400, rho=1.9, metric_every=10, tol=tol,
                record_residual=tol is not None, backend=backend)
    kws = [dict(seed=s, lam=lam, weight=wt) for s, lam, wt in BATCH]
    problems = [_chain_problem(**kw) for kw in kws]
    got = solve_many(problems, SolverConfig(**conf))
    want = j_solve_many([_reference_chain_problem(**kw) for kw in kws],
                        JConfig(**conf))
    for p, g, w in zip(problems, got, want):
        np.testing.assert_allclose(g.w.numpy(), np.asarray(w.w), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g.objective.numpy(),
                                   np.asarray(w.objective), rtol=1e-4)
        if tol is not None:
            assert g.diagnostics["iterations"] == w.diagnostics["iterations"]
            assert g.diagnostics["iterations"] < conf["num_iters"]
        # each problem's certificate is its own solve's, at its iterate
        assert set(g.diagnostics) == set(w.diagnostics)
        for k, v in certificate(p, g.w, g.u).items():
            assert torch.equal(g.diagnostics[k], v), k
        np.testing.assert_allclose(
            float(g.diagnostics["dual_infeasibility"]),
            float(w.diagnostics["dual_infeasibility"]), atol=1e-6)
    if backend == "dense":
        assert not seen
    else:
        b, v, e, n = len(BATCH), 24, 23, 2
        assert ("batched_affine", (b, v, n, n), (b, v, n)) in seen
        assert ("tv_prox", (b, e, n), (b, e)) in seen
