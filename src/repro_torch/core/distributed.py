"""Distributed (sharded) nLasso solver — message passing over a mesh of ranks.

The federated/distributed realization of Algorithm 1, the counterpart of
``repro.core.distributed``: the empirical graph is partitioned over the
``data`` axis of a mesh (``core.mesh``); each shard owns a contiguous
slice of nodes (primal state, node datasets, prox parameters) and the
edges whose ``src`` endpoint it owns (dual state).  The reference runs
the shards under ``shard_map`` from one host; here each shard is a rank
of a process group (SPMD): every rank plans the same partition from the
whole problem (the planners are deterministic numpy), keeps the rows of
its own shard, and the collectives of the executors carry the halo.

Two solvers:

  * :func:`solve_nlasso_sharded` — the canonical engine step
    (:func:`repro_torch.engine.step.pd_step`) through a
    :class:`~repro_torch.engine.executors.HaloExecutor`, whose
    per-iteration exchange is the reference's (``dense``: an all-gather
    of the primal block and an all-reduce of the dense D^T u
    accumulator, 2 * V_pad * n * 4 bytes a device; ``boundary``: only
    the rows that take part in cut edges);
  * :func:`solve_nlasso_hier` — the two-level layout
    (:class:`~repro_torch.core.partition.HierarchyPlan`): the fused
    primal-dual kernel (``kernels.ops.pd_step``) steps each shard's own
    edge-blocked layout, and a dual halo refresh
    (:class:`~repro_torch.engine.executors.HierarchicalExecutor`) runs
    between shards each iteration.

A ``tol`` solve stops at the first chunk whose residual, the max over
every rank (an all-reduce), is <= tol, so every rank stops at the same
chunk.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import EmpiricalGraph, compact_incidence
from repro_torch.core.losses import NodeData
from repro_torch.core.partition import (HierarchyPlan, PartitionPlan,
                                        block_partition, cluster_partition,
                                        gather_padded, plan_hierarchy,
                                        plan_partition)
from repro_torch.device import to_host
from repro_torch.engine import (HaloExecutor, HierarchicalExecutor,
                                pd_residual, run_chunked)
from repro_torch.engine import pd_step as engine_pd_step


@dataclasses.dataclass(frozen=True)
class ShardedProblem:
    """One shard's device-layout view of (graph, data) under a
    :class:`PartitionPlan`: the rows of shard ``shard`` of the
    reference's (S*vp, ...) / (S*ep, ...) arrays, on the graph's device
    (``send_rows`` holds every shard's rows: the boundary exchange
    needs them all)."""
    plan: PartitionPlan
    shard: int
    # node-sharded (vp, ...) arrays
    tau: torch.Tensor
    prox_params: dict
    # edge-sharded (ep,) arrays
    src: torch.Tensor
    dst: torch.Tensor
    bound_unit: torch.Tensor     # A_e (0 for padded edges)
    # boundary-exchange metadata
    send_rows: torch.Tensor      # (S*vp,) 1.0 if node participates in a cut
    loss: object = None          # Loss instance (defaults to SquaredLoss)
    num_features: int = 0


def _resolve_loss(loss):
    """Accept a Loss instance or a registry name; reject losses without a
    ``prox_setup`` parameterization (the sharded loops carry prox
    parameters, not the loss closure)."""
    from repro_torch.api.losses import Loss, get_loss

    obj = get_loss(loss) if isinstance(loss, str) else loss
    if type(obj).prox_setup is Loss.prox_setup:
        raise NotImplementedError(
            f"loss {type(obj).__name__} has no prox_setup parameterization;"
            " the sharded backends need one (use the dense/pallas backends)")
    return obj


def _permute_data(data: NodeData, perm: torch.Tensor) -> NodeData:
    """Gather node datasets into a device layout by a -1-padded
    permutation, zero-filling padding.

    Zero-filled rows are exactly the 'no samples, unlabeled' node: every
    stock ``Loss.prox_setup`` maps them to the identity prox (``counts``
    is zero-safe), so gathering the *data* and running ``prox_setup`` in
    layout order supports any parameter dict — per-node prox setup
    commutes with the gather.
    """
    return NodeData(*(gather_padded(getattr(data, k), perm)
                      for k in ("x", "y", "sample_mask", "labeled_mask")))


def _assign(graph: EmpiricalGraph, num_shards: int, partitioner: str,
            seed: int) -> np.ndarray:
    if partitioner == "cluster":
        return cluster_partition(graph, num_shards, seed=seed)
    if partitioner == "block":
        return block_partition(graph.num_nodes, num_shards)
    raise ValueError(partitioner)


def _rows(a: np.ndarray, shard: int, rows: int, device,
          dtype=torch.int64) -> torch.Tensor:
    """Shard ``shard``'s rows of a stacked host array, on ``device``."""
    part = np.ascontiguousarray(a[shard * rows:(shard + 1) * rows])
    return torch.from_numpy(part).to(device=device, dtype=dtype)


def _check_shard(shard: int, num_shards: int) -> None:
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} is not one of {num_shards} shards")


def shard_problem(graph: EmpiricalGraph, data: NodeData, num_shards: int,
                  *, partitioner: str = "cluster", loss="squared",
                  seed: int = 0, shard: int = 0) -> ShardedProblem:
    """Partition the graph + data and set up shard ``shard``'s prox
    parameters (the rank that runs it).

    Works for any :class:`repro_torch.api.losses.Loss` with a
    ``prox_setup`` parameterization (squared / lasso / logistic): the
    node datasets are gathered into the shard's rows of the plan layout
    (zero fill → identity prox on padding) and ``prox_setup`` runs
    there.
    """
    loss_obj = _resolve_loss(loss)
    _check_shard(shard, num_shards)
    assign = _assign(graph, num_shards, partitioner, seed)
    plan = plan_partition(graph, assign, num_shards)
    vp, ep = plan.nodes_per_shard, plan.edges_per_shard
    dev = graph.device

    perm = _rows(plan.node_perm, shard, vp, dev)
    tau = gather_padded(graph.primal_stepsizes(), perm, fill=1.0)
    params = loss_obj.prox_setup(_permute_data(data, perm), tau)

    # boundary rows: nodes touching a cut edge (new numbering)
    src_old = to_host(graph.src)
    dst_old = to_host(graph.dst)
    cut = assign[src_old] != assign[dst_old]
    send = np.zeros(len(plan.node_perm), np.float32)
    bn = np.unique(np.concatenate([src_old[cut], dst_old[cut]]))
    send[plan.node_inv[bn]] = 1.0

    return ShardedProblem(
        plan=plan, shard=shard, tau=tau, prox_params=params,
        src=_rows(plan.src_new, shard, ep, dev, torch.int32),
        dst=_rows(plan.dst_new, shard, ep, dev, torch.int32),
        bound_unit=_rows(plan.weights, shard, ep, dev, torch.float32),
        send_rows=torch.from_numpy(send).to(dev),
        loss=loss_obj, num_features=int(data.num_features))


def _check_mesh(mesh, axis: str, num_shards: int, shard: int,
                device: torch.device) -> None:
    """The mesh must run one shard a rank, this rank's, on the problem's
    device."""
    if mesh.shape[axis] != num_shards:
        raise ValueError(f"the problem has {num_shards} shards; the mesh's "
                         f"{axis!r} axis has {mesh.shape[axis]} ranks")
    rank = mesh.rank if axis == "data" else 0
    if shard != rank:
        raise ValueError(f"this rank ({rank}) holds shard {shard}")
    if mesh.device != device:
        raise ValueError(f"the mesh's ranks live on {mesh.device}, the "
                         f"problem on {device}")


def _chunked(step, state, *, mesh, axis: str, num_iters: int, tol,
             tol_every):
    """Run ``num_iters`` steps of ``step(state, with_residual)``; with
    ``tol``, in chunks of ``tol_every`` (default min(50, num_iters)) that
    stop at the first chunk whose residual, maxed over the ranks, is <=
    tol.  Returns ``(state, iterations)``."""
    if tol is None or num_iters == 0:
        for _ in range(num_iters):
            state, _ = step(state, False)
        return state, num_iters

    def run_chunk(st, r0, r1):
        res = None
        for _ in range(r1 - r0):
            st, r = step(st, True)
            res = r if res is None else torch.maximum(res, r)
        # every rank compares the same residual: one stop for all
        return st, (), mesh.all_reduce(res.reshape(1), "max", axis)[0]

    chunk = int(tol_every) if tol_every else min(50, num_iters)
    state, _traces, iterations, _ = run_chunked(
        run_chunk, state, total=num_iters, chunk_size=chunk, tol=tol)
    return state, iterations


def solve_nlasso_sharded(problem: ShardedProblem, mesh, lam: float,
                         num_iters: int, *, axis: str = "data",
                         rho: float = 1.0, comm: str = "dense",
                         w0: torch.Tensor | None = None,
                         u0: torch.Tensor | None = None,
                         return_u: bool = False,
                         tol: float | None = None,
                         tol_every: int | None = None, reg=None):
    """Run Algorithm 1 over the mesh; returns W in plan layout (S*vp, n),
    the same on every rank.

    ``comm``: "dense" | "boundary" (see :class:`HaloExecutor`).
    ``w0``/``u0`` warm-start the iteration (plan layout, (S*vp, n) /
    (S*ep, n); each rank reads its shard's rows); ``return_u=True``
    additionally returns the final dual state U in plan layout and the
    iteration count actually run.  ``tol`` enables residual-based early
    stopping in ``tol_every``-iteration chunks (the residual maxed over
    the ranks).
    """
    from repro_torch.api.losses import SquaredLoss
    from repro_torch.api.regularizers import TotalVariation

    plan = problem.plan
    S, vp, ep = plan.num_shards, plan.nodes_per_shard, plan.edges_per_shard
    s = problem.shard
    dev = problem.tau.device
    _check_mesh(mesh, axis, S, s, dev)
    n = problem.num_features or problem.prox_params["b"].shape[1]
    loss = problem.loss if problem.loss is not None else SquaredLoss()
    reg = reg if reg is not None else TotalVariation()
    w = (torch.zeros((vp, n), dtype=torch.float32, device=dev) if w0 is None
         else torch.as_tensor(w0, dtype=torch.float32,
                              device=dev)[s * vp:(s + 1) * vp].clone())
    u = (torch.zeros((ep, n), dtype=torch.float32, device=dev) if u0 is None
         else torch.as_tensor(u0, dtype=torch.float32,
                              device=dev)[s * ep:(s + 1) * ep].clone())
    executor = HaloExecutor.for_shard(
        mesh, axis, comm, shard=s, vp=vp, send_full=to_host(
            problem.send_rows), src=problem.src, dst=problem.dst,
        weights=problem.bound_unit)
    params, tau, sigma = problem.prox_params, problem.tau, 0.5

    def prox(v):
        return loss.prox_apply(params, v)

    def step(state, with_residual):
        new = engine_pd_step(executor, prox, reg, lam, tau, sigma, *state,
                             rho=rho)
        if with_residual:
            return new, pd_residual(tau, sigma, *state, *new)
        return new, None

    (w, u), iterations = _chunked(step, (w, u), mesh=mesh, axis=axis,
                                  num_iters=num_iters, tol=tol,
                                  tol_every=tol_every)
    w_out = mesh.all_gather(w, axis)
    if not return_u:
        return w_out
    return w_out, mesh.all_gather(u, axis), iterations


# ---------------------------------------------------------------------------
# Hierarchical (two-level) solver: the fused edge-blocked kernel inside
# each shard, a dual halo refresh between shards.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HierarchicalProblem:
    """One shard's device-layout view of (graph, data) under a
    :class:`HierarchyPlan`: shard ``shard``'s rows of the reference's
    stacked stores — node stores at ``w_store_rows`` rows (owned + halo
    layout rows plus the fused kernel's inert suffix padding), edge
    tables at ``edges_pad`` owned slots — on the graph's device, and the
    shard layout's compact incidence, which the kernel reads.  The
    refresh tables hold the shard's replicated slots only
    (``recv_slots``) with their sources for both exchange modes."""
    hier: HierarchyPlan
    shard: int
    loss: object
    num_features: int
    # node stores (WSR, ...)
    tau: torch.Tensor
    prox_params: dict
    inc_edges: torch.Tensor
    inc_signs: torch.Tensor
    incidence: tuple             # (in_ptr, in_ids, out_run) over NV rows
    node_owned: torch.Tensor     # (NV, 1)
    # owned edge slots (NE, 1)
    src: torch.Tensor
    dst: torch.Tensor
    bound_unit: torch.Tensor     # A_e (0 for padding slots)
    edge_owned: torch.Tensor
    orient: torch.Tensor
    # dual-refresh exchange tables
    send_idx: torch.Tensor       # (NS,)
    send_flip: torch.Tensor      # (NS, 1)
    recv_slots: torch.Tensor     # (k,) replicated slots
    recv_src_boundary: torch.Tensor  # (k,)
    recv_src_dense: torch.Tensor     # (k,)
    recv_flip: torch.Tensor          # (k, 1)


def _hier_gather(idx: np.ndarray, arr: np.ndarray, fill) -> np.ndarray:
    """Row-gather ``arr[idx]`` with ``idx == -1`` rows set to ``fill``."""
    arr = np.asarray(arr)
    out = np.full(idx.shape + arr.shape[1:], fill, dtype=arr.dtype)
    valid = idx >= 0
    out[valid] = arr[idx[valid]]
    return out


def _pad_shard_rows(arr: np.ndarray, num_shards: int, rows_out: int):
    """(S*rows, ...) -> (S*rows_out, ...) appending zero rows per shard."""
    rows = arr.shape[0] // num_shards
    pad = np.zeros((num_shards, rows_out - rows) + arr.shape[1:],
                   dtype=arr.dtype)
    stacked = np.concatenate(
        [arr.reshape((num_shards, rows) + arr.shape[1:]), pad], axis=1)
    return stacked.reshape((num_shards * rows_out,) + arr.shape[1:])


def shard_problem_fused(graph: EmpiricalGraph, data: NodeData,
                        num_shards: int, *, partitioner: str = "cluster",
                        loss="squared", seed: int = 0,
                        window_hint: tuple | None = None,
                        assign: np.ndarray | None = None,
                        shard: int = 0) -> HierarchicalProblem:
    """Two-level shard prep (cluster cuts between shards, an edge-blocked
    fused-kernel layout within each: ``core.partition.plan_hierarchy``)
    for shard ``shard`` (the rank that runs it).

    The node datasets are gathered into the shard's store rows (zero
    fill → identity prox on padding *and* a consistent copy on halo
    rows, whose primal updates are recomputed redundantly) and
    ``loss.prox_setup`` runs on them — per-node setup commutes with the
    gather, so any parameter dict is supported.  The shard layout's
    compact incidence is built here, once.
    """
    loss_obj = _resolve_loss(loss)
    _check_shard(shard, num_shards)
    if assign is None:
        assign = _assign(graph, num_shards, partitioner, seed)
    hier = plan_hierarchy(graph, assign, num_shards,
                          window_hint=window_hint)
    S, s, dev = hier.num_shards, shard, graph.device
    NV, NE, WSR = hier.nodes_pad, hier.edges_pad, hier.w_store_rows

    inj = _rows(hier.w_inj, s, WSR, dev)
    tau = gather_padded(graph.primal_stepsizes(), inj, fill=1.0)[:, None]
    params = loss_obj.prox_setup(_permute_data(data, inj), tau[:, 0])

    inc_e = hier.inc_edges[s * NV:(s + 1) * NV]
    inc_s = hier.inc_signs[s * NV:(s + 1) * NV]
    incidence = tuple(torch.from_numpy(a).to(dev)
                      for a in compact_incidence(inc_e, inc_s))

    def edge_col(a, dtype=torch.float32):
        return _rows(a, s, NE, dev, dtype)[:, None]

    def node_table(a, dtype):
        """The shard's rows of a layout table, padded to the store rows."""
        return torch.from_numpy(_pad_shard_rows(a, 1, WSR)).to(dev, dtype)

    flip = hier.recv_flip[s * NE:(s + 1) * NE]
    slots = np.flatnonzero(flip != 0)
    return HierarchicalProblem(
        hier=hier, shard=s, loss=loss_obj,
        num_features=int(data.num_features), tau=tau, prox_params=params,
        inc_edges=node_table(inc_e, torch.int32),
        inc_signs=node_table(inc_s, torch.float32),
        incidence=incidence,
        node_owned=_rows(hier.node_owned, s, NV, dev,
                         torch.float32)[:, None],
        src=edge_col(hier.src, torch.int32),
        dst=edge_col(hier.dst, torch.int32),
        bound_unit=edge_col(hier.weights), edge_owned=edge_col(
            hier.edge_owned), orient=edge_col(hier.orient),
        send_idx=_rows(hier.send_idx, s, hier.send_rows, dev),
        send_flip=_rows(hier.send_flip, s, hier.send_rows, dev,
                        torch.float32)[:, None],
        recv_slots=torch.from_numpy(slots).to(dev),
        recv_src_boundary=torch.from_numpy(
            hier.recv_src[s * NE:(s + 1) * NE][slots].astype(np.int64)
        ).to(dev),
        recv_src_dense=torch.from_numpy(
            hier.recv_src_dense[s * NE:(s + 1) * NE][slots]
            .astype(np.int64)).to(dev),
        recv_flip=torch.from_numpy(flip[slots][:, None]).to(dev))


def resolve_comm(comm: str, cut_fraction: float,
                 threshold: float = 0.25) -> str:
    """``auto`` → boundary when the inter-shard cut is small (the
    compacted exchange then moves far fewer rows than the owned slab)."""
    if comm == "auto":
        return "boundary" if cut_fraction < threshold else "dense"
    return comm


def halo_exchange_bytes_per_iter(problem, comm: str, num_features: int,
                                 itemsize: int = 4) -> int:
    """Per-iteration bytes *published* across the mesh (all shards), the
    reference's count.

    Mirrors ``federated.CommLedger``'s accounting convention (payload
    bytes entering the collective, not link-level traffic).  Accepts
    either a :class:`ShardedProblem` (HaloExecutor: primal all-gather +
    dense/boundary D^T u reduction → 2 blocks per device) or a
    :class:`HierarchicalProblem` (one owned-dual refresh per iteration).
    """
    n = num_features
    if isinstance(problem, HierarchicalProblem):
        h = problem.hier
        return h.num_shards * h.exchange_rows(comm) * n * itemsize
    plan = problem.plan
    S, vp = plan.num_shards, plan.nodes_per_shard
    if comm == "boundary":
        rows = int(to_host(problem.send_rows).sum())
    else:
        rows = S * vp
    return S * 2 * rows * n * itemsize


def _hier_steps(problem: HierarchicalProblem, mesh, lam: float, *,
                axis: str, rho: float, comm: str, reg=None):
    """``step(state, with_residual) -> (state, residual or None)``: one
    dual halo refresh (``HierarchicalExecutor.refresh_duals``), then one
    fused edge-blocked kernel step (``kernels.ops.pd_step``) over the
    shard's layout, written in place into the owned rows of the stores.
    Owned rows evolve exactly as the global iteration (the local
    subgraph is the 1-hop halo closure), so the owned-row residuals max
    over the ranks to the global eq.-11 residual; a residual step writes
    to fresh outputs (it reads both ends of the step) and then stores
    them.
    """
    from repro_torch.api.regularizers import TotalVariation
    from repro_torch.kernels import ops

    h = problem.hier
    reg = reg if reg is not None else TotalVariation()
    BV, EB = h.block_nodes, h.block_edges
    NV, NE, klo = h.nodes_pad, h.edges_pad, h.klo
    pkeys = tuple(sorted(problem.prox_params))
    pvals = tuple(problem.prox_params[k].contiguous() for k in pkeys)
    executor = HierarchicalExecutor(
        mesh=mesh, axis=axis, comm=comm, num_blocks=h.num_blocks,
        block_nodes=BV, block_edges=EB, klo=klo,
        node_owned=problem.node_owned, edge_owned=problem.edge_owned,
        orient=problem.orient, send_idx=problem.send_idx,
        send_flip=problem.send_flip, recv_slots=problem.recv_slots,
        recv_src=(problem.recv_src_boundary if comm == "boundary"
                  else problem.recv_src_dense),
        recv_flip=problem.recv_flip)
    sig = torch.full((NE, 1), 0.5, dtype=torch.float32,
                     device=problem.tau.device)
    la = lam * problem.bound_unit
    kw = dict(incidence=problem.incidence, loss=problem.loss, reg=reg,
              pkeys=pkeys, block_nodes=BV, block_edges=EB, kn=h.kn,
              klo=klo, khi=h.khi, rho=rho, iters=1)

    def step(state, with_residual):
        w_s, u_s = state
        u_r = executor.refresh_duals(u_s)
        args = (w_s, u_r, problem.inc_edges, problem.inc_signs, pvals,
                problem.tau, problem.src, problem.dst, sig, la)
        if not with_residual:
            ops.pd_step(*args, out=(w_s[:NV], u_r[klo * EB:klo * EB + NE]),
                        **kw)
            return (w_s, u_r), None
        w_new, u_new = ops.pd_step(*args, **kw)
        res = executor.residual(w_s, u_r, w_new, u_new, problem.tau, sig)
        return executor.write_back(w_s, u_r, w_new, u_new), res

    return step


def solve_nlasso_hier(problem: HierarchicalProblem, mesh, lam: float,
                      num_iters: int, *, axis: str = "data",
                      rho: float = 1.0, comm: str = "auto",
                      w0=None, u0=None, tol: float | None = None,
                      tol_every: int | None = None, reg=None):
    """Run Algorithm 1 through the two-level executor composition.

    ``w0`` / ``u0`` warm-start in *original* (global) order, on the
    problem's device; the returned ``(w, u, iterations, comm)`` are in
    original order too, on that device and the same on every rank — the
    hierarchy's injection/extraction gathers handle the stacked store
    layout, so callers never see it.  ``comm="auto"`` picks the
    boundary exchange when the inter-shard cut fraction is below 25%.
    """
    h = problem.hier
    n, s = problem.num_features, problem.shard
    dev = problem.tau.device
    _check_mesh(mesh, axis, h.num_shards, s, dev)
    comm = resolve_comm(comm, h.cut_fraction)
    WSR, ESR = h.w_store_rows, h.u_store_rows

    if w0 is None:
        w_st = torch.zeros((WSR, n), dtype=torch.float32, device=dev)
    else:
        w_st = gather_padded(torch.as_tensor(w0, dtype=torch.float32,
                                             device=dev),
                             _rows(h.w_inj, s, WSR, dev))
    if u0 is None:
        u_st = torch.zeros((ESR, n), dtype=torch.float32, device=dev)
    else:
        u_st = (gather_padded(torch.as_tensor(u0, dtype=torch.float32,
                                              device=dev),
                              _rows(h.u_inj, s, ESR, dev))
                * _rows(h.u_inj_flip, s, ESR, dev, torch.float32)[:, None])
    step = _hier_steps(problem, mesh, lam, axis=axis, rho=rho, comm=comm,
                       reg=reg)
    (w_st, u_st), iterations = _chunked(
        step, (w_st, u_st), mesh=mesh, axis=axis, num_iters=num_iters,
        tol=tol, tol_every=tol_every)

    def index(a):
        return torch.from_numpy(a).to(dev)
    w = mesh.all_gather(w_st, axis)[index(h.w_sel)]
    u = (mesh.all_gather(u_st, axis)[index(h.u_sel)]
         * index(h.u_flip)[:, None])
    return w, u, iterations, comm


def solve_and_unpermute(graph: EmpiricalGraph, data: NodeData, mesh,
                        lam: float, num_iters: int, **kw) -> torch.Tensor:
    """Deprecated shim: shard, solve, return W in the original node order.

    Thin adapter over the unified API — equivalent to
    ``Solver(SolverConfig(backend="sharded", mesh=mesh, ...)).run(problem)``;
    prefer that surface for new code (it also returns duals, traces, and
    diagnostics).
    """
    import warnings

    from repro_torch.api import Problem, Solver, SolverConfig

    warnings.warn(
        "solve_and_unpermute is deprecated; use repro_torch.api.Solver "
        "with SolverConfig(backend='sharded')", DeprecationWarning,
        stacklevel=2)

    cfg = SolverConfig(
        backend="sharded", mesh=mesh, num_iters=num_iters,
        mesh_axis=kw.pop("axis", "data"), rho=kw.pop("rho", 1.0),
        comm=kw.pop("comm", "dense"),
        partitioner=kw.pop("partitioner", "cluster"))
    if kw:
        raise TypeError(f"unexpected arguments {sorted(kw)}")
    res = Solver(cfg).run(Problem.create(graph, data, lam,
                                         device=graph.device))
    return res.w
