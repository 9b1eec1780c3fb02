"""The port's sharded backends on a one-rank mesh, against the reference.

Mirrors the reference's one-device tests of ``sharded`` and
``sharded_fused`` (``tests/test_api.py``: every loss runs, an opaque
prox is refused, the deprecated shim, warm-started continuation;
``tests/test_distributed.py``: against the dense iteration, boundary
against dense exchange, the single-shard hierarchical solve), with the
port on the CPU and the reference's results as the yardstick:

  * ``w`` within the reference tests' bounds of the reference's solve,
    traces of length 1 (metrics at the final iterate);
  * a ``tol`` solve stops at the reference's iteration, on both;
  * the halo byte count and its two telemetry counters equal the
    reference's;
  * bf16 and custom kernel hooks are refused where the reference refuses
    them, and a mesh that does not match the problem raises.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs                                  # noqa: E402
from repro.api import Problem as JProblem                      # noqa: E402
from repro.api import Solver as JSolver                        # noqa: E402
from repro.api import SolverConfig as JConfig                  # noqa: E402
from repro.core.mesh import make_host_mesh as j_mesh           # noqa: E402
from repro.core.nlasso import nlasso                           # noqa: E402
from repro.data.synthetic import make_classification_sbm as j_cls  # noqa: E402
from repro.data.synthetic import make_sbm_regression as j_sbm  # noqa: E402
from repro_torch import obs                                    # noqa: E402
from repro_torch.api import Problem, Solver, SolverConfig      # noqa: E402
from repro_torch.api.losses import Loss, SquaredLoss           # noqa: E402
from repro_torch.core.distributed import (                     # noqa: E402
    halo_exchange_bytes_per_iter, shard_problem, shard_problem_fused,
    solve_and_unpermute)
from repro_torch.core.mesh import make_host_mesh               # noqa: E402
from repro_torch.data.synthetic import (                       # noqa: E402
    make_classification_sbm, make_sbm_regression)

SBM = dict(seed=0, cluster_sizes=(40, 40), p_in=0.5, p_out=1e-3,
           num_labeled=16)                   # tests/test_api.py's sbm
FIXTURE = dict(seed=3, cluster_sizes=(24, 24), p_in=0.5, p_out=5e-3,
               num_labeled=12)               # tests/test_distributed.py's
SHARDED = ("sharded", "sharded_fused")


def mesh():
    return make_host_mesh(1, 1, device="cpu")


def port_problem(ds, lam=1e-3, **kw):
    return Problem.create(ds.graph, ds.data, lam, device="cpu", **kw)


@pytest.fixture(scope="module")
def sbm():
    return make_sbm_regression(**SBM, device="cpu")


@pytest.fixture(scope="module")
def j_sbm_ds():
    return j_sbm(**SBM)


@pytest.fixture(scope="module")
def fixture_ds():
    return make_sbm_regression(**FIXTURE, device="cpu")


@pytest.fixture(scope="module")
def j_fixture_ds():
    return j_sbm(**FIXTURE)


@pytest.mark.parametrize("loss,kw", [("squared", {}),
                                     ("lasso", {"alpha": 0.02}),
                                     ("logistic", {})])
@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_backend_runs_every_loss(backend, loss, kw):
    """Both sharded backends run every registered loss, within 1e-4 of
    the reference's dense solve of the same problem."""
    if loss == "logistic":
        cls = dict(seed=0, cluster_sizes=(20, 20), num_labeled=10)
        jds, ds = j_cls(**cls), make_classification_sbm(**cls, device="cpu")
    else:
        jds, ds = j_sbm(**SBM), make_sbm_regression(**SBM, device="cpu")
    ref = JSolver(JConfig(num_iters=80)).run(
        JProblem.create(jds.graph, jds.data, 1e-2, loss=loss, **kw))
    res = Solver(SolverConfig(num_iters=80, backend=backend,
                              mesh=mesh())).run(
        port_problem(ds, 1e-2, loss=loss, **kw))
    diff = float(np.max(np.abs(res.w.numpy() - np.asarray(ref.w))))
    assert diff <= 1e-4, (backend, loss, diff)
    assert res.objective.shape == (1,)
    np.testing.assert_allclose(float(res.objective[0]),
                               float(ref.objective[-1]), rtol=1e-4)


@dataclasses.dataclass(frozen=True)
class OpaqueLoss(Loss):
    """A loss with a prox closure and no ``prox_setup`` parameters."""

    def empirical_error(self, data, w):
        return SquaredLoss().empirical_error(data, w)

    def make_prox(self, data, tau, *, affine_fn=None):
        return lambda v: v


@pytest.mark.parametrize("backend", SHARDED)
def test_opaque_prox_is_refused(sbm, backend):
    """An opaque prox cannot be permuted into shard rows: refused, as
    the reference refuses ``CallableLoss``."""
    p = dataclasses.replace(port_problem(sbm), loss=OpaqueLoss())
    with pytest.raises(NotImplementedError, match="prox_setup"):
        Solver(SolverConfig(num_iters=10, backend=backend,
                            mesh=mesh())).run(p)


def test_solve_and_unpermute_shim_matches_sharded_backend(sbm):
    with pytest.warns(DeprecationWarning):
        w_shim = solve_and_unpermute(sbm.graph, sbm.data, mesh(), 1e-3, 100)
    res = Solver(SolverConfig(backend="sharded", mesh=mesh(),
                              num_iters=100)).run(port_problem(sbm))
    np.testing.assert_allclose(w_shim.numpy(), res.w.numpy(), atol=1e-7)
    assert float(res.diagnostics["dual_infeasibility"]) <= 1e-6


@pytest.mark.parametrize("backend", SHARDED)
def test_warm_start_continuation_tracks_reference(sbm, j_sbm_ds, backend):
    """The warm-started duals survive the permutation round trip:
    continuation on a sharded backend tracks the reference's dense
    continuation step for step."""
    cfg = dict(continuation=True, warm_iters=300, final_iters=150, rho=1.9)
    ref = JSolver(JConfig(**cfg)).run(
        JProblem.create(j_sbm_ds.graph, j_sbm_ds.data, 1e-3),
        w_true=j_sbm_ds.w_true)
    res = Solver(SolverConfig(**cfg, backend=backend, mesh=mesh())).run(
        port_problem(sbm), w_true=sbm.w_true)
    diff = float(np.max(np.abs(res.w.numpy() - np.asarray(ref.w))))
    assert diff <= 1e-4, diff
    assert res.mse.shape == (1,)
    np.testing.assert_allclose(float(res.mse[-1]), float(ref.mse[-1]),
                               rtol=1e-4)


def test_sharded_matches_reference_single_shard(fixture_ds, j_fixture_ds):
    w = solve_and_unpermute(fixture_ds.graph, fixture_ds.data, mesh(),
                            lam=1e-3, num_iters=150)
    ref = nlasso(j_fixture_ds.graph, j_fixture_ds.data, lam=1e-3,
                 num_iters=150)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref.w), atol=2e-4)


def test_boundary_comm_matches_dense(fixture_ds):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        w_dense = solve_and_unpermute(fixture_ds.graph, fixture_ds.data,
                                      mesh(), lam=1e-3, num_iters=100,
                                      comm="dense")
        w_bnd = solve_and_unpermute(fixture_ds.graph, fixture_ds.data,
                                    mesh(), lam=1e-3, num_iters=100,
                                    comm="boundary")
    np.testing.assert_allclose(w_bnd.numpy(), w_dense.numpy(), atol=2e-4)


def test_hierarchy_single_shard_solve_matches_dense(fixture_ds,
                                                    j_fixture_ds):
    """reorder -> fused solve -> unpermute is the dense iteration."""
    ref = JSolver(JConfig(backend="dense", num_iters=150)).run(
        JProblem.create(j_fixture_ds.graph, j_fixture_ds.data, 1e-3))
    res = Solver(SolverConfig(backend="sharded_fused",
                              num_iters=150)).run(port_problem(fixture_ds))
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), atol=2e-4)
    assert "halo_exchange_bytes" in res.diagnostics


# the fixture at lambda 1e-2: the block-max residual passes 1e-3 between
# iterations 600 and 650, well clear of the tolerance on both sides
TOL = dict(num_iters=2000, rho=1.9, metric_every=50, tol=1e-3)


@pytest.fixture(scope="module")
def tol_reference(j_fixture_ds):
    """The reference's tol solve (its dense backend: every reference
    backend stops on the same block-max residual stream)."""
    return JSolver(JConfig(**TOL)).run(
        JProblem.create(j_fixture_ds.graph, j_fixture_ds.data, 1e-2))


@pytest.mark.parametrize("backend", SHARDED)
def test_tol_solve_stops_at_the_reference_iteration(fixture_ds,
                                                    tol_reference, backend):
    res = Solver(SolverConfig(**TOL, backend=backend, mesh=mesh())).run(
        port_problem(fixture_ds, 1e-2))
    its = int(res.diagnostics["iterations"])
    assert its == int(tol_reference.diagnostics["iterations"]), its
    assert 0 < its < TOL["num_iters"]
    diff = float(np.max(np.abs(res.w.numpy()
                               - np.asarray(tol_reference.w))))
    assert diff <= 1e-4, diff


@pytest.mark.parametrize("comm", ["dense", "boundary", "auto"])
@pytest.mark.parametrize("backend", SHARDED)
def test_halo_bytes_and_counters_equal_the_reference(
        fixture_ds, j_fixture_ds, backend, comm):
    """``halo_exchange_bytes_per_iter`` (at one and four shards) and the
    two telemetry counters a solve adds are the reference's."""
    from repro.core import distributed as j_dist

    for num_shards in (1, 4):
        if backend == "sharded":
            t_sp = shard_problem(fixture_ds.graph, fixture_ds.data,
                                 num_shards)
            j_sp = j_dist.shard_problem(j_fixture_ds.graph,
                                        j_fixture_ds.data, num_shards)
            comm_s = j_dist.resolve_comm(
                comm, j_sp.plan.cut_edges / j_fixture_ds.graph.num_edges)
        else:
            t_sp = shard_problem_fused(fixture_ds.graph, fixture_ds.data,
                                       num_shards)
            j_sp = j_dist.shard_problem_fused(
                j_fixture_ds.graph, j_fixture_ds.data, num_shards)
            comm_s = j_dist.resolve_comm(comm, j_sp.hier.cut_fraction)
        assert (halo_exchange_bytes_per_iter(t_sp, comm_s, 2)
                == j_dist.halo_exchange_bytes_per_iter(j_sp, comm_s, 2))

    counters = {}
    for pkg, o, run in (
            ("ref", jobs, lambda: JSolver(JConfig(
                num_iters=20, backend=backend, comm=comm,
                mesh=j_mesh(1, 1))).run(JProblem.create(
                    j_fixture_ds.graph, j_fixture_ds.data, 1e-3))),
            ("port", obs, lambda: Solver(SolverConfig(
                num_iters=20, backend=backend, comm=comm,
                mesh=mesh())).run(port_problem(fixture_ds)))):
        o.disable()
        o.reset()
        o.enable()
        try:
            res = run()
            counters[pkg] = (
                sorted((m["name"], sorted(m["labels"].items()), m["value"])
                       for m in o.export.snapshot()["metrics"]
                       if m["name"].startswith("halo_exchange")),
                float(res.diagnostics["halo_exchange_bytes_per_iter"]),
                float(res.diagnostics["halo_exchange_bytes"]))
        finally:
            o.disable()
            o.reset()
    assert len(counters["port"][0]) == 2
    assert counters["port"] == counters["ref"]


@pytest.mark.parametrize("backend", SHARDED)
def test_sharded_refusals(sbm, backend):
    """bf16 storage is refused on both (the reference's
    ``_storage_dtype(config, fused=False)``); custom kernel hooks on
    ``sharded_fused``; a mesh on another device, or with another shard
    count, raises."""
    p = port_problem(sbm)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        Solver(SolverConfig(num_iters=5, backend=backend,
                            dtype="bfloat16", mesh=mesh())).run(p)
    with pytest.raises(ValueError, match="shards"):
        Solver(SolverConfig(num_iters=5, backend=backend, num_shards=2,
                            mesh=mesh())).run(p)
    with pytest.raises(ValueError, match="mesh"):
        Solver(SolverConfig(num_iters=5, backend=backend,
                            mesh=make_host_mesh(1, 1, device="meta"))).run(p)
    if backend == "sharded_fused":
        with pytest.raises(NotImplementedError, match="hooks"):
            Solver(SolverConfig(num_iters=5, backend=backend, mesh=mesh(),
                                clip_fn=lambda u, b: u)).run(p)
