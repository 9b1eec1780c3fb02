"""The compact incidence the fused kernel reads, against the padded tables.

``core/graph.py:compact_incidence`` turns a layout's padded (rows,
max_deg) incidence tables into the form ``fused_pd_step`` reads: per row
its in-edge ids (CSR) and its out-edges as one run of consecutive
storage ids (first, count).  On the CPU, on the 8 zoo layouts, an SBM
layout with several blocks and the scale-out recipe at 6,000 nodes
(banded and whole-graph), the compact tables hold exactly the padded
tables' filled slots — same ids, same signs, same order — with empty
rows for padding nodes; they equal those rebuilt from the reference
package's own layout; and a float64 D^T u through them equals the padded
gather (1e-12: float64 sums in another order).  The auto-tuner builds
the compact tables once, for the layout it keeps.  The kernel wrapper
refuses missing or mismatched tables before it looks for the card, and
the plain version never reads them.  A node whose prox parameters pass
the kernel's shared-memory staging (its streamed variant), a problem
wider than the kernel's widest register tile (n > 16, its wide variant)
and a path past the lane plan take the solver's fused route, in bf16
storage too, held to the reference's bf16 fused solve; only what neither
of the kernel's plans takes runs unfused (on a simulated CUDA dispatch,
with the kernel's counts stubbed: the CPU has no kernel library).

On the card (``-m cuda``): every loss x storage variant of the kernel
gives bit-identical outputs over two launches (no float atomics in the
gather); on every zoo layout one step is within 1e-5 of the plain
version in float32 and one bf16 ulp in bfloat16; logistic nodes with
thousands of samples (small tiles, and the opt-in to more than 48 KB of
shared memory) hold to 1e-5; past the staging limit the kernel streams
them (a labeled node a block, its samples staged up to the plan's count:
within 1e-5 of the staged variant where both apply, of the plain version
at n = 2-16, in both storage types, with masked samples, no or every node
labeled and at the plan's staged count and one past it; six lanes give
the bits of six one-lane launches; 100 iterations within 1e-4) and the
solver fuses them; a wide logistic node past n = 336 (the plan's limit)
is refused.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (Problem, Solver,                  # noqa: E402
                              SolverConfig, backends)
from repro_torch.core import graph as core_graph              # noqa: E402
from repro_torch.core.graph import (compact_incidence,          # noqa: E402
                                    plan_edge_blocks, sbm_graph,
                                    sbm_graph_sparse)
from repro_torch.kernels import ops, pd_step                   # noqa: E402
from repro_torch.kernels.pd_step import fused_pd_step          # noqa: E402
from repro_torch.kernels.ref import fused_pd_step_ref          # noqa: E402
from repro_torch.scenarios import SCENARIOS, get_scenario      # noqa: E402

LAYOUTS = sorted(SCENARIOS) + ["sbm_blocks", "clustered_banded",
                               "clustered_whole"]


def _graph(which, mod=None, device="cpu"):
    """The graph behind a layout name, built by ``mod`` (the port's
    ``core.graph`` by default, or the reference's)."""
    kw = {"device": device} if mod is None else {}
    if which in SCENARIOS:
        return get_scenario(which).build(seed=0, smoke=True,
                                         device=device).problem.graph
    if which == "sbm_blocks":
        return (mod.sbm_graph if mod else sbm_graph)(
            np.random.default_rng(1), (100, 100), 0.1, 0.01, **kw)[0]
    # the scale-out recipe (chip_smoke.py:make_clustered) at 6,000 nodes
    v, nc = 6000, 3
    return (mod.sbm_graph_sparse if mod else sbm_graph_sparse)(
        np.random.default_rng(0), (v // nc,) * nc, p_in=20.5 / (v / nc),
        p_out=2.0 * 0.007 * v / (v * v), **kw)[0]


def _block_nodes(which):
    return {"sbm_blocks": 32, "clustered_whole": 6000}.get(which)


def _layout(which, device="cpu"):
    lt = plan_edge_blocks(_graph(which, device=device),
                          block_nodes=_block_nodes(which))
    if which in ("sbm_blocks", "clustered_banded"):
        assert lt.num_blocks > 1 and lt.klo + lt.khi > 0
    if which == "clustered_whole":
        assert lt.num_blocks == 1
    return lt


@pytest.mark.parametrize("which", LAYOUTS)
def test_compact_incidence_holds_the_filled_slots(which):
    lt = _layout(which)
    inc_e, inc_s = lt.inc_edges.numpy(), lt.inc_signs.numpy()
    in_ptr, in_ids, out_run = (t.numpy() for t in lt.compact)
    rows = inc_s.shape[0]
    assert in_ptr.dtype == in_ids.dtype == out_run.dtype == np.int32
    assert in_ptr.shape == (rows + 1,) and out_run.shape == (rows, 2)
    assert in_ptr[0] == 0 and in_ptr[-1] == in_ids.shape[0]
    assert in_ids.shape[0] == lt.num_edges == int(out_run[:, 1].sum())
    for r in range(rows):
        filled = inc_s[r] != 0
        ins = in_ids[in_ptr[r]:in_ptr[r + 1]]
        first, count = out_run[r]
        np.testing.assert_array_equal(
            np.concatenate([ins, first + np.arange(count)]),
            inc_e[r][filled])
        np.testing.assert_array_equal(
            np.repeat(np.float32([-1.0, 1.0]), [len(ins), count]),
            inc_s[r][filled])
    padding = lt.node_perm.numpy() < 0
    assert padding.any() or rows == lt.num_nodes
    assert (np.diff(in_ptr)[padding] == 0).all()
    assert (out_run[padding] == 0).all()


@pytest.mark.parametrize("which", LAYOUTS)
def test_compact_incidence_of_the_reference_layout(which):
    """The reference package's layout (bit-equal padded tables) gives
    the same compact tables, through ``interop.layout_from_arrays``."""
    from repro.core import graph as jg
    from repro_torch.interop import layout_from_arrays

    if which in SCENARIOS:
        from repro.scenarios import get_scenario as j_get
        jgraph = j_get(which).build(seed=0, smoke=True).problem.graph
    else:
        jgraph = _graph(which, mod=jg)
    jl = jg.plan_edge_blocks(jgraph, block_nodes=_block_nodes(which))
    fields = {f.name: getattr(jl, f.name) for f in dataclasses.fields(jl)}
    tl = layout_from_arrays({k: v if isinstance(v, int) else np.asarray(v)
                             for k, v in fields.items()}, device="cpu")
    for got, want in zip(tl.compact, _layout(which).compact):
        assert torch.equal(got, want)


@pytest.mark.parametrize("which", LAYOUTS)
def test_compact_gather_equals_padded_gather(which):
    lt = _layout(which)
    rng = np.random.default_rng(7)
    u_rows = (lt.num_blocks + lt.klo + lt.khi) * lt.block_edges
    u = rng.standard_normal((u_rows, 3))
    inc_e, inc_s = lt.inc_edges.numpy(), lt.inc_signs.numpy()
    padded = np.einsum("vd,vdn->vn", inc_s.astype(np.float64), u[inc_e])
    in_ptr, in_ids, out_run = (t.numpy() for t in lt.compact)
    compact = np.zeros_like(padded)
    for r in range(inc_s.shape[0]):
        first, count = out_run[r]
        compact[r] = (u[first:first + count].sum(0)
                      - u[in_ids[in_ptr[r]:in_ptr[r + 1]]].sum(0))
    np.testing.assert_allclose(compact, padded, rtol=1e-12, atol=1e-12)


def test_compact_incidence_refuses_other_slot_orders():
    """A row whose +1 slots come first, or whose +1 ids are not one run,
    is not what the planner writes: refused."""
    inc_s = np.float32([[-1, 1, 1, 0]])
    with pytest.raises(ValueError, match="-1 slots, then"):
        compact_incidence(np.int32([[3, 5, 6, 0]]), inc_s[:, ::-1].copy())
    with pytest.raises(ValueError, match="consecutive"):
        compact_incidence(np.int32([[3, 5, 7, 0]]), inc_s)
    in_ptr, in_ids, out_run = compact_incidence(np.int32([[3, 5, 6, 0]]),
                                                inc_s)
    assert in_ptr.tolist() == [0, 1] and in_ids.tolist() == [3]
    assert out_run.tolist() == [[5, 2]]


def test_auto_tuner_builds_the_compact_tables_once(monkeypatch):
    """The block-size auto-tuner plans every candidate rung without the
    compact tables and builds them once, for the layout it keeps: the
    same tables as that block size planned alone."""
    calls = []
    real = core_graph.compact_incidence

    def counted(*a):
        calls.append(a[1].shape)
        return real(*a)

    monkeypatch.setattr(core_graph, "compact_incidence", counted)
    graph = _graph("clustered_banded")
    lt = plan_edge_blocks(graph)
    assert len(calls) == 1 and calls[0][0] == lt.nodes_pad
    alone = plan_edge_blocks(graph, block_nodes=lt.block_nodes)
    for got, want in zip(lt.compact, alone.compact):
        assert torch.equal(got, want)


def _step(name="sbm_regression", *, dtype=torch.float32, device="cpu",
          block_nodes=16, seed=0, problem=None):
    """One fused step's arguments on scenario ``name``'s layout (or on
    ``problem``), as the solver passes them, from a state that moves:
    w ~ 2 N(0, 1), each dual uniform in its box [-la, la]."""
    if problem is None:
        problem = get_scenario(name).build(seed=0, smoke=True,
                                           device=device).problem
    lt = plan_edge_blocks(problem.graph, block_nodes=block_nodes)
    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, _) = \
        backends._fused_setup(problem.graph, problem.data, problem.lam,
                              None, loss=problem.loss,
                              reg=problem.regularizer, layout=lt,
                              dtype=dtype)
    rng = np.random.default_rng(seed)
    n = problem.num_features
    w0 = torch.from_numpy(2.0 * rng.standard_normal((lt.nodes_pad, n)))
    u0 = torch.from_numpy(rng.uniform(-1.0, 1.0, (lt.edges_pad, n)))
    w0, u0 = w0.float().to(device), (u0.float().to(device) * la2)
    w_store, u_store = backends._fused_stores(lt, w0, u0, dtype)
    args = (w_store, u_store, lt.pad_node_store(lt.inc_edges),
            lt.pad_node_store(lt.inc_signs), params_s, tau_s, src2, dst2,
            sig2, la2)
    kw = dict(loss=problem.loss, reg=problem.regularizer, pkeys=pkeys,
              block_nodes=lt.block_nodes, block_edges=lt.block_edges,
              kn=lt.kn, klo=lt.klo, khi=lt.khi, rho=1.9,
              compute_residual=True, incidence=lt.compact)
    return list(args), kw


def _kernel(args, kw, **more):
    """The CUDA wrapper on ``_step``'s arguments: it takes the compact
    incidence (in ``kw``) and no padded tables (``args[2:4]``)."""
    return fused_pd_step(*args[:2], *args[4:], **kw, **more)


def _plain(args, kw, **more):
    """The plain version on ``_step``'s arguments: it reads the padded
    tables and takes no compact incidence."""
    kw = {k: v for k, v in kw.items() if k != "incidence"}
    return fused_pd_step_ref(*args, **kw, **more)


def _refusals():
    """(label, how to spoil kw["incidence"], error type)."""
    def shape(k, t):
        return lambda inc: tuple(t(x) if i == k else x
                                 for i, x in enumerate(inc))
    return [
        ("missing", lambda inc: None, ValueError),
        ("two tables", lambda inc: inc[:2], ValueError),
        ("in_ptr short", shape(0, lambda x: x[:-1]), ValueError),
        ("in_ptr int64", shape(0, lambda x: x.long()), TypeError),
        ("out_run one column", shape(2, lambda x: x[:, :1].contiguous()),
         ValueError),
        ("out_run transposed", shape(2, lambda x: x.t()), ValueError),
        ("in_ids two-dim", shape(1, lambda x: x[:, None]), ValueError),
        ("in_ids too many", shape(1, lambda x: torch.cat([x] * 40)),
         ValueError),
        ("in_ids float", shape(1, lambda x: x.float()), TypeError),
    ]


@pytest.mark.parametrize("label,spoil,error", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_wrapper_refuses_missing_or_mismatched_compact_tables(label, spoil,
                                                              error):
    """Checked before the device: the CPU reaches these refusals, and
    with good tables it reaches the device check."""
    args, kw = _step()
    with pytest.raises(ValueError, match="CUDA"):
        _kernel(args, kw)
    with pytest.raises(error, match="incidence"):
        _kernel(args, dict(kw, incidence=spoil(kw["incidence"])))


def _many_samples(ms, device):
    """A logistic problem on a 40-node SBM with ``ms`` samples a node:
    the kernel stages ~16 ms bytes of them per node."""
    from repro_torch.data.synthetic import make_classification_data

    rng = np.random.default_rng(ms)
    g, assign = sbm_graph(rng, (20, 20), 0.3, 0.05, device=device)
    ds = make_classification_data(
        rng, g, np.where(assign[:, None] % 2 == 0, [2.0, 2.0], [-2.0, 2.0]),
        samples_per_node=ms, num_labeled=20)
    return Problem.create(g, ds.data, 1e-2, loss="logistic", device=device)


@pytest.mark.cuda
def test_wrapper_streams_parameters_past_shared_memory():
    """One node's logistic samples past a block's shared memory, by the
    kernel's own count: the launch runs the streamed variant, within
    1e-5 of the plain version; at half as many the staged variant runs,
    and the streamed one forced on those inputs is within 1e-5 of it and
    of the plain version (a labeled node's sums run in another order),
    the same bits over two launches."""
    _need_card()
    ms = 15000
    need, limit = pd_step.staging_bytes(2, 2, ms)
    assert need > limit >= pd_step.staging_bytes(2, 2, ms // 2)[0]
    assert pd_step.streaming_bytes(2, 2, ms)[0] <= limit
    args, kw = _step(problem=_many_samples(ms, "cuda"), device="cuda")
    before = fused_pd_step.variant_launches["logistic/float32/streamed"]
    got = _kernel(args, kw)
    want = _plain(args, kw)
    torch.cuda.synchronize()
    assert (fused_pd_step.variant_launches["logistic/float32/streamed"]
            == before + 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    args, kw = _step(problem=_many_samples(ms // 2, "cuda"), device="cuda")
    staged = _kernel(args, kw)
    streamed = _kernel(args, dict(kw, streamed=True))
    again = _kernel(args, dict(kw, streamed=True))
    want = _plain(args, kw)
    torch.cuda.synchronize()
    for s, a, g, w in zip(streamed, again, staged, want):
        assert torch.equal(s, a)
        for other in (g, w):
            np.testing.assert_allclose(s.cpu().numpy(), other.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_plain_version_ignores_the_compact_tables():
    """On CPU tensors ``ops.pd_step`` runs the plain version, which reads
    the padded tables: the same result whatever compact tables it is
    given, or none."""
    args, kw = _step()
    want = _plain(args, kw)
    for inc in (kw["incidence"], None):
        got = ops.pd_step(*args, **dict(kw, incidence=inc))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.fixture
def cuda_gate(monkeypatch):
    """The fused gate decides as on the card (the problem it sees reports
    a CUDA device) while the solve runs on the CPU tensors; and
    ``_solve_fused`` records the solves it takes (the lambdas of a
    path's lanes, None for one problem)."""
    class OnCuda(Problem):
        device = property(lambda self: torch.device("cuda"))

    real_gate, real_fused = backends._should_fuse, backends._solve_fused
    fused = []

    def gate(problem, config, **kw):
        fields = dataclasses.fields(problem)
        return real_gate(OnCuda(**{f.name: getattr(problem, f.name)
                                   for f in fields}), config, **kw)

    def solve_fused(*a, **kw):
        fused.append(kw.get("lams"))
        return real_fused(*a, **kw)

    monkeypatch.setattr(backends, "_should_fuse", gate)
    monkeypatch.setattr(backends, "_solve_fused", solve_fused)
    return fused


def _plan_stubs(monkeypatch, staged=True, streamed=True, asked=None):
    """Stub the kernel's two plan counts (the CPU has no kernel library):
    the staged plan fits where ``staged(kind, n, samples, lanes)`` is
    true, the streamed one where ``streamed(...)`` is; ``asked`` records
    the staged plan's questions."""
    def plan(fits, record):
        def count(kind, n, num_samples, lanes=1):
            if record is not None:
                record.append((kind, n, num_samples, lanes))
            ok = fits(kind, n, num_samples, lanes) if callable(fits) else fits
            return (1, 2) if ok else (3, 2)
        return count

    monkeypatch.setattr(pd_step, "staging_bytes", plan(staged, asked))
    monkeypatch.setattr(pd_step, "streaming_bytes", plan(streamed, None))


@pytest.mark.parametrize("fits", [True, False])
def test_fused_gate_runs_unstageable_nodes_unfused(fits, cuda_gate,
                                                   monkeypatch):
    """The fused gate asks the kernel's staging count (stubbed here: the
    CPU has no kernel library).  A node within the staging limit fuses
    staged; one past it fuses too, the kernel reading its parameters
    from device memory (the streamed variant): ``Solver(backend=
    "pallas")`` takes the fused route either way, within 1e-4 of the
    dense backend, and bf16 storage runs there as well."""
    asked = []
    _plan_stubs(monkeypatch, staged=fits, asked=asked)
    problem = _many_samples(40, "cpu")
    cfg = SolverConfig(backend="pallas", num_iters=30)
    got = Solver(cfg).run(problem)
    assert asked and asked[-1] == (2, 2, 40, 1)
    assert len(cuda_gate) == 1
    want = Solver(cfg.replace(backend="dense")).run(problem)
    np.testing.assert_allclose(got.w.numpy(), want.w.numpy(), rtol=1e-4,
                               atol=1e-4)
    Solver(cfg.replace(dtype="bfloat16")).run(problem)
    assert len(cuda_gate) == 2


def test_fused_gate_runs_unfused_only_past_the_kernels_limit(cuda_gate,
                                                             monkeypatch):
    """What neither of the kernel's plans takes (on the card: a wide
    logistic node whose Hessian, n (n + 1) / 2 floats, passes one warp's
    shared memory, n > 336 in one lane; stubbed here) runs unfused,
    within 1e-6 of the dense backend, and bf16 storage is refused there,
    as everywhere off the fused path."""
    _plan_stubs(monkeypatch, staged=False, streamed=False)
    problem = _many_samples(40, "cpu")
    cfg = SolverConfig(backend="pallas", num_iters=30)
    got = Solver(cfg).run(problem)
    assert not cuda_gate
    want = Solver(cfg.replace(backend="dense")).run(problem)
    np.testing.assert_allclose(got.w.numpy(), want.w.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        Solver(cfg.replace(dtype="bfloat16")).run(problem)


def _wide_problem(n, device="cpu"):
    """A squared problem with ``n`` features a node on a 40-node SBM (24
    samples a node, every other node labeled), in the port and, from the
    same numpy arrays, in the reference."""
    import jax.numpy as jnp
    from repro.api import Problem as JProblem
    from repro.core import graph as jg
    from repro.core.losses import NodeData as JNodeData
    from repro_torch.core.losses import NodeData

    def graph(mod, **kw):
        return mod.sbm_graph(np.random.default_rng(17), (20, 20), 0.3, 0.05,
                             **kw)

    g, assign = graph(core_graph, device=device)
    rng = np.random.default_rng(18)
    levels = rng.standard_normal((2, n))
    x = rng.standard_normal((40, 24, n)).astype(np.float32)
    y = (np.einsum("vmn,vn->vm", x, levels[assign % 2])
         + 0.05 * rng.standard_normal((40, 24))).astype(np.float32)
    mask = np.ones((40, 24), np.float32)
    labeled = (np.arange(40) % 2 == 0).astype(np.float32)
    arrays = (x, y, mask, labeled)
    data = NodeData(*(torch.from_numpy(a) for a in arrays))
    jdata = JNodeData(*(jnp.asarray(a) for a in arrays))
    return (Problem.create(g, data, 1e-2, device=device),
            JProblem.create(graph(jg)[0], jdata, 1e-2))


def test_fused_gate_runs_wide_problems_unfused(cuda_gate, monkeypatch):
    """n = 17 features, past the kernel's widest register tile: the
    fused gate asks the kernel's plan (stubbed: the wide variant stages
    it) and ``Solver(backend="pallas")`` takes the fused route, within
    1e-4 of the reference's dense ``w``; ``solve_path``'s fused lanes go
    through the same gate and fuse too.  At n = 16 the gate fuses."""
    from repro.api import Solver as JSolver
    from repro.api import SolverConfig as JConfig
    from repro_torch.api import solve_path

    asked = []
    _plan_stubs(monkeypatch, asked=asked)
    conf = dict(num_iters=200, rho=1.9, metric_every=50)
    problem, jproblem = _wide_problem(17)
    cfg = SolverConfig(backend="pallas", **conf)
    got = Solver(cfg).run(problem)
    assert cuda_gate == [None] and asked[-1] == (0, 17, 24, 1)
    want = JSolver(JConfig(**conf)).run(jproblem)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-4)
    lams = [1e-2, 3e-2]
    path = solve_path(problem, lams,
                      cfg.replace(warm_iters=100, final_iters=100))
    assert cuda_gate[1] is None and path.w.shape == (2, 40, 17)
    np.testing.assert_array_equal(cuda_gate[2], np.float32(lams))
    Solver(cfg).run(_wide_problem(16)[0])
    assert len(cuda_gate) == 4 and cuda_gate[-1] is None


LANE_WINDOW_SAMPLES = 14523     # fits the kernel's plan as one lane, not six
LANE_WINDOW_LAMS = np.geomspace(1e-1, 1e-3, 6).astype(np.float32)
LANE_WINDOW_CONF = dict(backend="pallas", rho=1.9, warm_iters=30,
                        final_iters=30, metric_every=10)


def test_fused_gate_counts_a_paths_lanes(cuda_gate, monkeypatch):
    """A node that fits the kernel's staging plan as one lane but not as
    six (a slot more a lane; stubbed here by the lane count the gate asks
    with): ``Solver`` fuses it staged, and ``solve_path`` over six
    lambdas asks the plan at six lanes and runs the fused lanes with the
    parameters streamed, within 1e-4 of the dense path."""
    from repro_torch.api import solve_path

    asked = []
    _plan_stubs(monkeypatch, staged=lambda *a: a[3] == 1, asked=asked)
    problem = _many_samples(40, "cpu")
    cfg = SolverConfig(**LANE_WINDOW_CONF)
    Solver(cfg.replace(num_iters=30)).run(problem)
    assert cuda_gate == [None]
    got = solve_path(problem, LANE_WINDOW_LAMS, cfg)
    assert (2, 2, 40, len(LANE_WINDOW_LAMS)) in asked
    assert cuda_gate[:2] == [None, None] and len(cuda_gate) == 3
    np.testing.assert_array_equal(cuda_gate[2], LANE_WINDOW_LAMS)
    want = solve_path(problem, LANE_WINDOW_LAMS,
                      cfg.replace(backend="dense"))
    np.testing.assert_allclose(got.w.numpy(), want.w.numpy(), rtol=0,
                               atol=1e-4)


BF16_OBJ_REL = 0.15          # the reference's gates (tests/test_precision.py)
BF16_W_REL = 0.5


def _reference_many_samples(problem, ms):
    """The reference's problem on ``_many_samples(ms)``'s graph (the same
    seed, bit-equal planners) and data (the same arrays)."""
    import jax.numpy as jnp
    from repro.api import Problem as JProblem
    from repro.core import graph as jg
    from repro.core.losses import NodeData as JNodeData

    g, _ = jg.sbm_graph(np.random.default_rng(ms), (20, 20), 0.3, 0.05)
    d = problem.data
    data = JNodeData(*(jnp.asarray(getattr(d, k).numpy()) for k in
                       ("x", "y", "sample_mask", "labeled_mask")))
    return JProblem.create(g, data, problem.lam, loss="logistic")


@pytest.mark.parametrize("which", ["wide17", "samples15000",
                                   "samples15000_f32"])
def test_bf16_fuses_where_the_reference_fuses(which, cuda_gate,
                                              monkeypatch):
    """bf16 storage on the card where the reference's TPU fuses: a
    17-feature problem (the wide variant) and logistic nodes of 15,000
    samples (past the staging plan: the streamed variant).
    ``Solver(backend="pallas", dtype="bfloat16")`` takes the fused route
    (the gate as on the card, the plan counts stubbed), and on the CPU
    its result is held to the reference's bf16 fused solve within the
    reference's bf16 gates (final objective 0.15 relative, ``w`` 0.5 of
    its scale).  Beside them the float32 route of the streamed case,
    held to the reference's float32 fused solve within 1e-4."""
    from repro.api import Solver as JSolver
    from repro.api import SolverConfig as JConfig

    conf = dict(num_iters=60, rho=1.9, metric_every=20)
    dtype = "float32" if which.endswith("_f32") else "bfloat16"
    if which == "wide17":
        _plan_stubs(monkeypatch)
        problem, jproblem = _wide_problem(17)
    else:
        _plan_stubs(monkeypatch, staged=False)
        problem = _many_samples(15000, "cpu")
        jproblem = _reference_many_samples(problem, 15000)
    got = Solver(SolverConfig(backend="pallas", dtype=dtype,
                              **conf)).run(problem)
    assert cuda_gate == [None]
    want = JSolver(JConfig(backend="pallas", fused=True, dtype=dtype,
                           **conf)).run(jproblem)
    if dtype == "float32":
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                                   rtol=0, atol=1e-4)
        return
    obj, ref_obj = got.objective.numpy(), np.asarray(want.objective)
    assert np.isfinite(obj).all()
    assert abs(obj[-1] - ref_obj[-1]) / abs(ref_obj[-1]) <= BF16_OBJ_REL
    scale = float(np.abs(np.asarray(want.w)).max()) or 1.0
    w_rel = float(np.abs(got.w.numpy() - np.asarray(want.w)).max()) / scale
    assert w_rel <= BF16_W_REL


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 5])
def test_cuda_launches_are_bit_identical(name, dtype, iters):
    """Every scenario's loss and regularizer, both storage types, one
    step on a banded layout and five on the whole-graph block."""
    _need_card()
    args, kw = _step(name, dtype=getattr(torch, dtype), device="cuda",
                     block_nodes=16 if iters == 1 else None)
    first = _kernel(args, kw, iters=iters)
    again = _kernel(args, kw, iters=iters)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version_on_zoo_layouts(name, dtype):
    """One step on each scenario's banded layout (its degrees set the
    gather's lanes) against the plain version: 1e-5 in float32; one bf16
    ulp at each output's scale in bfloat16, and that ulp over min(tau,
    sigma) on the residual."""
    _need_card()
    args, kw = _step(name, dtype=getattr(torch, dtype), device="cuda")
    got = _kernel(args, kw)
    want = _plain(args, kw)
    torch.cuda.synchronize()
    g = [t.float().cpu().numpy() for t in got]
    w = [t.float().cpu().numpy() for t in want]
    if dtype == "float32":
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        return
    for a, b in zip(g[:2], w[:2]):
        assert np.abs(a - b).max() <= _bf16_ulp(float(np.abs(b).max()))
    ulp = _bf16_ulp(max(float(np.abs(x).max()) for x in w[:2]))
    tau, sigma = args[5], args[8]
    steps = min(float(tau[tau > 0].min()), float(sigma.min()))
    np.testing.assert_allclose(g[2], w[2], rtol=1e-5, atol=ulp / steps)


@pytest.mark.cuda
@pytest.mark.parametrize("ms", [1400, 3200, 7000])
def test_cuda_kernel_stages_many_samples(ms):
    """Logistic nodes with 1400 / 3200 / 7000 samples: the tile shrinks
    to the nodes whose samples fit shared memory, and past 47 KB a node
    the launch opts in to the larger shared memory.  Within 1e-5 of the
    plain version, bit-identical across launches."""
    _need_card()
    args, kw = _step(problem=_many_samples(ms, "cuda"), device="cuda")
    got = _kernel(args, kw)
    again = _kernel(args, kw)
    want = _plain(args, kw)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_solver_runs_many_samples_fused():
    """A logistic problem whose nodes pass the kernel's staging limit
    solves on the card with the default routing through the fused
    kernel's streamed variant (no unfused launch), within 1e-4 of the
    dense backend, and in bf16 storage too."""
    _need_card()
    from repro_torch.kernels.tv_prox import tv_prox

    problem = _many_samples(15000, "cuda")
    cfg = SolverConfig(backend="pallas", num_iters=30)
    assert backends._should_fuse(problem, cfg)
    streamed = fused_pd_step.variant_launches["logistic/float32/streamed"]
    clips = tv_prox.launches
    got = Solver(cfg).run(problem)
    torch.cuda.synchronize()
    assert (fused_pd_step.variant_launches["logistic/float32/streamed"]
            > streamed and tv_prox.launches == clips)
    want = Solver(cfg.replace(backend="dense")).run(problem)
    np.testing.assert_allclose(got.w.cpu().numpy(), want.w.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    bf16 = Solver(cfg.replace(dtype="bfloat16")).run(problem)
    assert fused_pd_step.variant_launches["logistic/bfloat16/streamed"] > 0
    assert bool(torch.isfinite(bf16.w).all())


@pytest.mark.cuda
def test_cuda_path_past_the_lane_plan_runs_fused():
    """Logistic nodes of 14,523 samples fit the kernel's staging plan as
    one lane and not as six: ``solve_path`` over six lambdas runs the
    fused lanes with the parameters streamed, each lane within 1e-4 of a
    one-lane (staged) fused solve from the path's warm start (a labeled
    node's sums run in another order) and of the dense path.  On one
    step's inputs the six-lane streamed launch gives the bits of six
    one-lane streamed launches."""
    _need_card()
    from repro_torch.api import solve_path
    from repro_torch.engine import default_warm_lam

    problem = _many_samples(LANE_WINDOW_SAMPLES, "cuda")
    loss = problem.loss
    kind = pd_step._LOSSES["logistic"][0]
    assert pd_step.plan_variant(kind, 2, LANE_WINDOW_SAMPLES) == "staged"
    assert pd_step.plan_variant(kind, 2, LANE_WINDOW_SAMPLES,
                                6) == "streamed"
    assert pd_step.kernel_takes(loss, 2, LANE_WINDOW_SAMPLES, 6)
    cfg = SolverConfig(**LANE_WINDOW_CONF)
    key = "logistic/float32/streamed"
    lanes = fused_pd_step.lane_launches[key]
    got = solve_path(problem, LANE_WINDOW_LAMS, cfg)
    torch.cuda.synchronize()
    assert fused_pd_step.lane_launches[key] > lanes
    warm = backends.solve_pallas(problem.with_lam(default_warm_lam(
        float(np.max(LANE_WINDOW_LAMS)))), cfg.replace(
        num_iters=cfg.warm_iters, compute_diagnostics=False))
    final = cfg.replace(num_iters=cfg.final_iters, compute_diagnostics=False)
    for k in (0, len(LANE_WINDOW_LAMS) - 1):
        lam = float(LANE_WINDOW_LAMS[k])
        u0 = problem.regularizer.project_dual(warm.u, problem.graph, lam)
        one = backends._solve_fused(problem.with_lam(lam), final,
                                    w0=warm.w, u0=u0)
        np.testing.assert_allclose(got.w[k].cpu().numpy(),
                                   one.w.cpu().numpy(), rtol=0, atol=1e-4)
    want = solve_path(problem, LANE_WINDOW_LAMS, cfg.replace(backend="dense"))
    np.testing.assert_allclose(got.w.cpu().numpy(), want.w.cpu().numpy(),
                               rtol=0, atol=1e-4)
    args, kw = _step(problem=problem, device="cuda")
    largs = _lane_args(args, len(LANE_WINDOW_LAMS))
    lanes = fused_pd_step.lane_launches[key]
    path = _kernel(largs, kw)
    assert fused_pd_step.lane_launches[key] == lanes + 1
    ones = [_kernel(_one_lane(largs, k), kw, streamed=True)
            for k in range(len(LANE_WINDOW_LAMS))]
    torch.cuda.synchronize()
    for k, one in enumerate(ones):
        for a, b in zip(path, one):
            assert torch.equal(a[k], b)


def _lane_args(args, lanes):
    """``_step``'s arguments as ``lanes`` lanes of a lambda path: one w
    for every lane, lambda (la and the duals with it) from 1x to 0.1x."""
    scale = np.geomspace(1.0, 0.1, lanes)
    out = list(args)
    out[0] = torch.stack([args[0]] * lanes)
    out[1] = torch.stack([args[1] * float(c) for c in scale])
    out[9] = torch.stack([args[9] * float(c) for c in scale])
    return out


def _one_lane(args, k):
    out = list(args)
    out[0], out[1], out[9] = args[0][k], args[1][k], args[9][k]
    return out


def _streamed_problem(n, ms, labeled="half", masked=False, device="cuda"):
    """A logistic problem with ``n`` features and ``ms`` samples a node on
    a 40-node SBM, Bernoulli labels; every other node labeled (or none,
    or all); ``masked``: every third node's second half of samples
    masked out."""
    from repro_torch.core.losses import NodeData

    rng = np.random.default_rng(1000 * n + ms)
    g, assign = sbm_graph(rng, (20, 20), 0.3, 0.05, device=device)
    x = rng.standard_normal((40, ms, n)).astype(np.float32)
    w = rng.standard_normal((2, n))[assign % 2]
    mask = np.ones((40, ms), np.float32)
    if masked:
        mask[::3, ms // 2:] = 0.0
    y = (rng.random((40, ms)) < 1.0 / (1.0 + np.exp(
        -np.einsum("vmn,vn->vm", x, w)))).astype(np.float32) * mask
    lab = {"half": np.arange(40) % 2 == 0, "none": np.zeros(40, bool),
           "all": np.ones(40, bool)}[labeled].astype(np.float32)
    data = NodeData(*(torch.from_numpy(a).to(device)
                      for a in (x, y, mask, lab)))
    return Problem.create(g, data, 1e-2, loss="logistic", device=device)


def _assert_near_plain(got, want, dtype, tol=1e-5):
    """float32: within ``tol``; bfloat16: one bf16 ulp at each output's
    scale (both round the same f32 values to nearest even)."""
    for g, w in zip(got[:2], want[:2]):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        lim = tol if dtype == torch.float32 else _bf16_ulp(
            float(np.abs(w).max()))
        assert np.abs(g - w).max() <= lim


# (n, samples or "slab" / "slab+1": the last sample the streamed plan
# stages and one past it, storage, labeled nodes, masked samples)
STREAMED_CASES = [
    (2, 100, "float32", "half", False),
    (2, 15001, "float32", "half", False),
    (2, 15001, "bfloat16", "half", False),
    (2, "slab", "float32", "half", False),
    (2, "slab+1", "float32", "half", False),
    (2, "slab", "bfloat16", "half", False),
    (2, "slab+1", "bfloat16", "half", False),
    (3, 300, "float32", "half", False),
    (4, 300, "float32", "half", False),
    (8, 300, "float32", "half", False),
    (16, 300, "float32", "half", False),
    (3, 300, "bfloat16", "half", False),
    (8, 300, "bfloat16", "half", False),
    (16, 300, "bfloat16", "half", False),
    (2, 1000, "float32", "half", True),
    (4, 1000, "bfloat16", "half", True),
    (2, 1000, "float32", "none", False),
    (2, 1000, "bfloat16", "none", False),
    (2, 1000, "float32", "all", False),
    (2, 1000, "bfloat16", "all", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,ms,dtype,labeled,masked", STREAMED_CASES)
def test_cuda_streamed_kernel_matches_plain_version(n, ms, dtype, labeled,
                                                    masked):
    """The register tile's streamed logistic variant (a labeled node a
    block, its samples split over the block and staged in shared memory
    up to the plan's count, the rest read from device memory; unlabeled
    nodes skip the Newton steps) forced on each case: within 1e-5 of the
    plain version (bf16 one ulp), the same bits over two launches."""
    _need_card()
    dt = getattr(torch, dtype)
    if isinstance(ms, str):
        cap = pd_step.streamed_slab_samples(n, 1 << 20, 1, dt)
        ms = cap + (ms == "slab+1")
        assert pd_step.streamed_slab_samples(n, ms, 1, dt) == cap
    args, kw = _step(problem=_streamed_problem(n, ms, labeled, masked),
                     dtype=dt, device="cuda")
    key = pd_step.variant_key("logistic", dt, n, False)
    before = fused_pd_step.variant_launches[key]
    got = _kernel(args, kw, streamed=True)
    again = _kernel(args, kw, streamed=True)
    want = _plain(args, kw)
    torch.cuda.synchronize()
    assert fused_pd_step.variant_launches[key] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _assert_near_plain(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_streamed_lanes_are_one_lane_launches(dtype):
    """Six lanes of the streamed variant in one launch: each lane gives
    the bits of a one-lane streamed launch on its inputs, and the launch
    is within 1e-5 of the plain version over the six lanes (bf16 one
    ulp)."""
    _need_card()
    dt = getattr(torch, dtype)
    args, kw = _step(problem=_streamed_problem(2, 15001), dtype=dt,
                     device="cuda")
    largs = _lane_args(args, 6)
    got = _kernel(largs, kw, streamed=True)
    ones = [_kernel(_one_lane(largs, k), kw, streamed=True)
            for k in range(6)]
    want = _plain(largs, kw)
    torch.cuda.synchronize()
    for k, one in enumerate(ones):
        for a, b in zip(got, one):
            assert torch.equal(a[k], b)
    _assert_near_plain(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_streamed_kernel_100_iterations(dtype):
    """One launch of 100 iterations of the streamed variant on the
    whole-graph block (a float32 carry) against 100 plain steps: within
    1e-4 (bf16 one ulp at the state's scale beyond it)."""
    _need_card()
    dt = getattr(torch, dtype)
    args, kw = _step(problem=_streamed_problem(2, 3000), dtype=dt,
                     device="cuda", block_nodes=None)
    got = _kernel(args, kw, streamed=True, iters=100)
    want = _plain(args, kw, iters=100)
    torch.cuda.synchronize()
    for g, w in zip(got[:2], want[:2]):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        lim = 1e-4 + (0.0 if dt == torch.float32 else _bf16_ulp(
            float(np.abs(w).max())))
        assert np.abs(g - w).max() <= lim


@pytest.mark.cuda
def test_cuda_wide_logistic_limit():
    """The one width the kernel refuses: a wide logistic node keeps its
    Hessian (factored in place), n (n + 1) / 2 floats, and four rows of
    n in one warp's shared memory.  The widest n it takes in one lane is
    read from the kernel's own streamed plan against its limit, not
    written down: the kernel takes that n, streamed, and refuses one
    feature more, where the wrapper names the Hessian and the gate
    routes such a problem unfused."""
    _need_card()
    loss = _many_samples(8, "cpu").loss

    def fits(n):
        need, limit = pd_step.streaming_bytes(2, n, 8)
        return need <= limit
    widest = max(n for n in range(pd_step.TILE_FEATURES + 1, 1024)
                 if fits(n))
    assert all(fits(n) for n in range(pd_step.TILE_FEATURES + 1, widest))
    assert pd_step.kernel_takes(loss, widest, 8)
    assert not pd_step.kernel_takes(loss, widest + 1, 8)
    assert pd_step.plan_variant(2, widest, 8) == "streamed"
    problem = _wide_logistic(widest + 1, "cuda")
    args, kw = _step(problem=problem, device="cuda")
    with pytest.raises(NotImplementedError, match="Hessian"):
        _kernel(args, kw)
    assert not backends._should_fuse(problem,
                                     SolverConfig(backend="pallas"))


def _wide_logistic(n, device):
    """A logistic problem with ``n`` features and 8 samples a node on a
    40-node SBM, Bernoulli labels, every other node labeled."""
    from repro_torch.core.losses import NodeData

    rng = np.random.default_rng(n)
    g, assign = sbm_graph(rng, (20, 20), 0.3, 0.05, device=device)
    x = rng.standard_normal((40, 8, n)).astype(np.float32)
    w = rng.standard_normal((2, n))[assign % 2] / np.sqrt(n)
    y = (rng.random((40, 8)) < 1.0 / (1.0 + np.exp(
        -np.einsum("vmn,vn->vm", x, w)))).astype(np.float32)
    labeled = (np.arange(40) % 2 == 0).astype(np.float32)
    data = NodeData(*(torch.from_numpy(a).to(device) for a in (
        x, y, np.ones((40, 8), np.float32), labeled)))
    return Problem.create(g, data, 1e-2, loss="logistic", device=device)
