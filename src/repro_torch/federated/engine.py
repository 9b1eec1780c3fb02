"""Round-based federated message-passing runtime for Algorithm 1.

The port's ``repro.federated.engine``.  The paper's central claim is
that the primal-dual method *is* a federated learning algorithm via a
message-passing implementation: each node i keeps its local model w^(i)
and primal step size tau_i; each edge e = {i, j} keeps a dual variable
u^(e).  This module executes that protocol as an explicit round loop
over per-node clients instead of a centralized array program.

Protocol per round (edge e = {i, j} with i = src owning the dual):

  1. every *active* client computes its primal update from the duals it
     holds — owned edges read u^(e) locally, non-owned edges read the
     mirror last broadcast by the owner (stale if the owner has been
     inactive) — applying the configured local-update policy (one exact
     prox = Algorithm 1 eq. 17, or several FedProx-style local steps);
  2. it forms the primal message z^(i) = 2 w^(i)+ - w^(i) (the eq. 15
     operand) and sends it, through the configured compression policy,
     to the owner of every edge where it is the dst endpoint; mailboxes
     persist, so a message sent to a currently-inactive owner is consumed
     when the owner next wakes;
  3. every active *owner* refreshes its duals (Algorithm 1 step 10: the
     regularizer's resolvent of u + sigma (z_src - z_dst), using its own
     exact z and the mailbox copy of the neighbour's) and broadcasts the
     new u^(e) back to the dst endpoint (float32);
  4. inactive clients freeze: their w, their outgoing messages, and the
     duals they own are all left as-is — neighbours keep consuming stale
     state (the partial-participation semantics of asynchronous
     primal-dual methods).

With full participation, one local prox step, and no compression, every
``where(active, new, old)`` collapses and the round is *operation-for-
operation* the dense backend's iteration (the port's ``dense`` backend:
the same prox, the same gather and einsum for D^T u, the same
``z[src] - z[dst]``, the same resolvent and relaxation) — the port's
conformance suite locks the two traces together.  The
:class:`~repro_torch.federated.ledger.CommLedger` meters what crossed the
network each round.

Checkpointing: with ``checkpoint_every=K`` the engine advances in chunks
of K rounds and saves ``(state, round, traces, ledger)`` at each
boundary.  The rounds are eager PyTorch ops with no atomics, so a chunk
boundary changes nothing, and a straight run and an interrupted-then-
resumed run give the same state bit for bit (``tests/
test_torch_federated.py``; at 1M nodes on the card, ``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.api.backends import make_metrics_fn
from repro_torch.api.problem import Problem, SolveResult
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.engine import (MailboxExecutor, capped, certificate,
                                pd_residual, run_chunked)
from repro_torch.engine import pd_step as engine_pd_step
from repro_torch.federated.ledger import CommLedger
from repro_torch.federated.policies import (CompressionPolicy,
                                            LocalUpdatePolicy,
                                            ParticipationPolicy,
                                            get_compression,
                                            get_local_update,
                                            get_participation)

_META_NAME = "meta.json"


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """How to run the federated runtime (everything Python-side).

    Core loop:
      num_rounds:   communication rounds (one Algorithm 1 iteration each
                    under the ``single`` local-update policy).
      rho:          Krasnosel'skii-Mann over-relaxation, exactly as the
                    dense backend applies it (node-local on w, edge-local
                    on u).
      metric_every: objective/MSE cadence; must divide num_rounds.

    Runtime policies (registry names or policy instances; see
    ``repro_torch.federated.policies``):
      participation: ``full`` | ``bernoulli`` | ``dropout`` |
                    ``straggler`` | ``fixed``.
      local_update: ``single`` | ``prox``.
      compression:  ``none`` | ``int8`` | ``topk``.
      seed:         drives the participation schedule (and nothing else);
                    same seed -> identical schedule and ledger, the
                    reference's from the same seed.
      tol:          residual-based early stopping: advance in
                    ``metric_every``-round chunks and stop at the first
                    chunk whose *max per-round* eq.-11 fixed-point
                    residual (``repro_torch.engine.step.pd_residual``) is
                    <= tol — the max makes single idle rounds under
                    partial participation not read as convergence.  The
                    residual stream is the dense backend's in
                    synchronous mode, so both stop at the same round.

    Checkpointing (``repro_torch.checkpoint``):
      checkpoint_dir:   where to save; None disables.
      checkpoint_every: save cadence in rounds (multiple of metric_every).
      resume:           load the latest checkpoint from checkpoint_dir
                        and continue from its round.
    """

    num_rounds: int = 500
    rho: float = 1.0
    metric_every: int = 1
    participation: Any = "full"
    local_update: Any = "single"
    compression: Any = "none"
    seed: int = 0
    tol: float | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int | None = None
    resume: bool = False
    compute_diagnostics: bool = True

    def replace(self, **kw) -> "FederatedConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FederatedState:
    """The distributed system state between rounds.

    Attributes:
      w:      (V, n) per-client local models.
      u:      (E, n) edge duals, as held by their owning (src) endpoint.
      u_recv: (E, n) the dst endpoint's mirror of each dual — the value
              last broadcast by the owner (stale while the owner sleeps).
      z_recv: (E, n) the owner's mailbox of the dst endpoint's last
              (compressed) primal message.
    """

    w: torch.Tensor
    u: torch.Tensor
    u_recv: torch.Tensor
    z_recv: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FederatedResult:
    """What ``run_federated`` returns.

    ``w``/``u``/``objective``/``mse``/``lam``/``diagnostics`` mirror
    :class:`~repro_torch.api.problem.SolveResult`; on top of those:

      ledger:   the per-round :class:`CommLedger`.
      schedule: (rounds, V) numpy activity mask actually executed.
      state:    final :class:`FederatedState` (resume/warm-start).
    """

    w: torch.Tensor
    u: torch.Tensor
    objective: torch.Tensor
    mse: torch.Tensor | None
    lam: Any
    diagnostics: dict
    ledger: CommLedger
    schedule: np.ndarray
    state: FederatedState

    @property
    def final_objective(self):
        return self.objective[-1]

    def to_solve_result(self) -> SolveResult:
        """Backend-compatible view; ledger totals fold into diagnostics."""
        diag = dict(self.diagnostics)
        diag["comm"] = self.ledger.summary()
        return SolveResult(w=self.w, u=self.u, objective=self.objective,
                           mse=self.mse, lam=self.lam, diagnostics=diag)


# ---------------------------------------------------------------------------
# One chunk: metric_every message-passing rounds at a time
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Round:
    """What every round of a solve shares, set up once per solve: the
    reference computes the prox parameters inside its jitted chunk or
    eagerly depending on chunking (``repro/federated/engine.py``), a
    distinction eager PyTorch does not have — here they are computed
    once, as the port's dense backend computes them once per solve
    (``loss.make_prox``), so the synchronous mode stays its iteration."""

    graph: Any
    prox: Any
    metrics: Any
    reg: Any
    lam: Any
    tau: torch.Tensor
    sigma: torch.Tensor
    pos_signs: torch.Tensor
    up_cost: torch.Tensor
    down_cost: torch.Tensor
    local_update: LocalUpdatePolicy
    compression: CompressionPolicy
    rho: float


def _round_setup(problem: Problem, w_true, *, local_update, compression,
                 rho: float) -> _Round:
    graph, data = problem.graph, problem.data
    tau = graph.primal_stepsizes()
    n, dev = problem.num_features, problem.device

    def cost(v):
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    return _Round(
        graph=graph, prox=problem.loss.make_prox(data, tau),
        metrics=make_metrics_fn(problem.loss, problem.regularizer, graph,
                                data, problem.lam, w_true),
        reg=problem.regularizer, lam=problem.lam, tau=tau,
        sigma=graph.dual_stepsizes(),
        pos_signs=(graph.inc_signs > 0.0)[..., None],
        up_cost=cost(compression.message_bytes(n)), down_cost=cost(4.0 * n),
        local_update=local_update, compression=compression, rho=rho)


def _one_round(rs: _Round, state: tuple, active: torch.Tensor):
    """One communication round: the canonical engine step
    (:func:`repro_torch.engine.step.pd_step`) through a
    :class:`~repro_torch.engine.executors.MailboxExecutor`, then the
    round protocol around it — who is active, which mailboxes refresh,
    what the meter records.  ``active`` is the round's (V,) float32
    activity row.  Returns ``(state, meter)``, the meter the round's
    (up messages, up bytes, down messages, down bytes)."""
    g = rs.graph
    w, u, u_recv, z_recv = state
    act_dst = active[g.dst]
    act_src = active[g.src]
    active_dst = act_dst[:, None] > 0.0
    executor = MailboxExecutor(g, u_recv, z_recv, rs.pos_signs, active_dst,
                               rs.compression.compress)
    w_raw, u_raw = engine_pd_step(
        executor, rs.prox, rs.reg, rs.lam, rs.tau, rs.sigma, w, u,
        rho=rs.rho, primal_update=rs.local_update.apply)
    active_node = active[:, None] > 0.0
    active_src = act_src[:, None] > 0.0
    w_new = torch.where(active_node, w_raw, w)
    u_new = torch.where(active_src, u_raw, u)
    # active owners broadcast refreshed duals to the dst mirrors
    u_recv_new = torch.where(active_src, u_new, u_recv)
    up, down = torch.sum(act_dst), torch.sum(act_src)
    meter = (up, up * rs.up_cost, down, down * rs.down_cost)
    return (w_new, u_new, u_recv_new, executor.z_recv_new), meter


def _run_chunk(rs: _Round, state: tuple, sched: torch.Tensor, *,
               metric_every: int, with_residual: bool):
    """Run the (rounds, V) schedule chunk ``sched``, metrics on the
    cadence.  Returns ``(state, (obj, mse), meter, residual)``: the
    metric traces (rounds // metric_every,), the per-round meters
    (rounds,) each, and under ``with_residual`` the chunk's *max*
    per-round eq.-11 residual (a single idle round — few or no active
    clients — moves nothing and must not read as convergence under
    partial participation; only a whole chunk without movement stops)."""
    records, meters, residuals = [], [], []
    for r in range(sched.shape[0]):
        new, meter = _one_round(rs, state, sched[r])
        if with_residual:
            residuals.append(pd_residual(rs.tau, rs.sigma, state[0],
                                         state[1], new[0], new[1]))
        meters.append(meter)
        state = new
        if (r + 1) % metric_every == 0:
            records.append(rs.metrics(state[0]))
    obj, mse = (torch.stack(col) for col in zip(*records))
    meter = tuple(torch.stack(col) for col in zip(*meters))
    res = torch.max(torch.stack(residuals)) if with_residual else None
    return state, (obj, mse), meter, res


# ---------------------------------------------------------------------------
# Checkpoint wiring (repro_torch.checkpoint: npz payload + json manifest)
# ---------------------------------------------------------------------------

def _ckpt_tree(state: FederatedState, objective, mse, ledger: CommLedger):
    return {"state": state, "objective": objective, "mse": mse,
            "ledger": ledger}


def _problem_fingerprint(problem: Problem) -> str:
    """Content hash of the optimization problem a trajectory solves:
    graph structure/weights, node data, lambda, and the loss/regularizer
    templates.  Two same-shaped but different problems must not splice."""
    h = hashlib.blake2b(digest_size=16)
    for t in (problem.graph.src, problem.graph.dst, problem.graph.weights,
              problem.data.x, problem.data.y, problem.data.sample_mask,
              problem.data.labeled_mask):
        h.update(np.ascontiguousarray(t.cpu().numpy()).tobytes())
    h.update(repr((float(problem.lam), problem.loss,
                   problem.regularizer)).encode())
    return h.hexdigest()


def _config_fingerprint(cfg: FederatedConfig, problem: Problem,
                        have_mse: bool) -> dict:
    """What a checkpointed trajectory depends on: resuming under any
    different value would splice two incompatible runs, so resume
    validates every field (policies and templates are frozen dataclasses
    — their repr is a faithful fingerprint; the problem itself is
    content-hashed)."""
    return {
        "seed": cfg.seed,
        "participation": repr(get_participation(cfg.participation)),
        "local_update": repr(get_local_update(cfg.local_update)),
        "compression": repr(get_compression(cfg.compression)),
        "rho": float(cfg.rho),
        "metric_every": int(cfg.metric_every),
        # the chunk-boundary sequence, kept as the reference keeps it
        "checkpoint_every": int(cfg.checkpoint_every or 0),
        # tol re-chunks the horizon at metric_every (and may stop early)
        "tol": None if cfg.tol is None else float(cfg.tol),
        "have_mse": bool(have_mse),
        "problem": _problem_fingerprint(problem),
    }


def _save_checkpoint(path: str, rnd: int, state: FederatedState,
                     objective, mse, ledger: CommLedger,
                     fingerprint: dict) -> None:
    """Crash-safe save: the payload goes into a per-round subdirectory
    first; only then is ``meta.json`` swapped in atomically (tmp file +
    ``os.replace``) to point at it.  A kill mid-save leaves the previous
    checkpoint fully intact; stale round directories are pruned after
    the pointer moves."""
    subdir = f"round_{rnd:08d}"
    ckpt.save(os.path.join(path, subdir),
              _ckpt_tree(state, objective, mse, ledger))
    meta = {"round": int(rnd), "trace_len": int(objective.shape[0]),
            "dir": subdir, "config": fingerprint}
    tmp = os.path.join(path, _META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, _META_NAME))
    for name in os.listdir(path):
        if name.startswith("round_") and name != subdir:
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)


def has_checkpoint(path: str | None) -> bool:
    return bool(path) and os.path.exists(os.path.join(path, _META_NAME))


def _load_checkpoint(path: str, problem: Problem, *,
                     fingerprint: dict | None = None):
    """(round, state, objective, mse, ledger) from a saved checkpoint,
    on the problem's device.

    ``fingerprint`` (when given) must match the one recorded at save
    time — same seed, policies, rho, metric cadence, and w_true-ness —
    otherwise the resumed suffix would run a different protocol than the
    checkpointed prefix and the spliced result would be inconsistent.
    """
    with open(os.path.join(path, _META_NAME)) as f:
        meta = json.load(f)
    rnd, tlen = int(meta["round"]), int(meta["trace_len"])
    if fingerprint is not None:
        saved = meta.get("config", {})
        bad = sorted(k for k in fingerprint
                     if saved.get(k) != fingerprint[k])
        if bad:
            raise ValueError(
                f"checkpoint at {path!r} was written under a different "
                f"run configuration (mismatched: {bad}); resume must use "
                f"the same seed/policies/rho/metric_every/w_true "
                f"(saved {[saved.get(k) for k in bad]} vs "
                f"requested {[fingerprint[k] for k in bad]})")
    V, n = problem.num_nodes, problem.num_features
    E = problem.graph.num_edges

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=problem.device)

    like = _ckpt_tree(
        FederatedState(w=zeros(V, n), u=zeros(E, n), u_recv=zeros(E, n),
                       z_recv=zeros(E, n)),
        zeros(tlen), zeros(tlen), CommLedger(*(zeros(rnd) for _ in range(4))))
    tree = ckpt.restore(os.path.join(path, meta.get("dir", "")), like)
    return rnd, tree["state"], tree["objective"], tree["mse"], tree["ledger"]


# ---------------------------------------------------------------------------
# The runtime front-end
# ---------------------------------------------------------------------------

def participation_schedule(config: FederatedConfig, num_rounds: int,
                           num_nodes: int) -> np.ndarray:
    """The (rounds, nodes) activity mask a run with this config executes
    (deterministic in ``config.seed``; the reference's from the same
    seed, bit for bit)."""
    policy: ParticipationPolicy = get_participation(config.participation)
    sched = policy.schedule(np.random.default_rng(config.seed), num_rounds,
                            num_nodes)
    if sched.shape != (num_rounds, num_nodes):
        raise ValueError(f"schedule shape {sched.shape} != "
                         f"{(num_rounds, num_nodes)}")
    return np.ascontiguousarray(sched, np.float32)


def run_federated(problem: Problem, config: FederatedConfig | None = None,
                  *, w0=None, u0=None, w_true=None) -> FederatedResult:
    """Execute the federated message-passing runtime on ``problem``, on
    the problem's device.

    Synchronous full participation with ``single`` local updates and no
    compression reproduces the dense backend exactly (same trace); every
    other configuration trades accuracy-per-round against the metered
    communication cost in the returned ledger.  The (rounds, V) schedule
    is built on the host (numpy, from ``config.seed``) and moved to the
    device one chunk at a time, as float32.
    """
    cfg = config if config is not None else FederatedConfig()
    me = cfg.metric_every
    # the solver's REPRO_SOLVER_MAX_ITERS knob caps rounds the same way
    # it caps iterations (one shared implementation, no drift)
    R = capped(cfg.num_rounds, me)
    if R % me:
        raise ValueError(
            f"metric_every={me} must divide num_rounds={R}")
    if cfg.checkpoint_every is not None:
        if cfg.checkpoint_dir is None:
            raise ValueError("checkpoint_every needs checkpoint_dir")
        if cfg.checkpoint_every % me:
            raise ValueError(
                f"checkpoint_every={cfg.checkpoint_every} must be a "
                f"multiple of metric_every={me}")
    local_update = get_local_update(cfg.local_update)
    compression = get_compression(cfg.compression)

    graph = problem.graph
    V, n, dev = problem.num_nodes, problem.num_features, problem.device
    E = graph.num_edges
    schedule = participation_schedule(cfg, R, V)
    if w_true is not None:
        w_true = w_true.to(dev)

    w0 = (torch.zeros((V, n), dtype=torch.float32, device=dev) if w0 is None
          else torch.as_tensor(w0, dtype=torch.float32, device=dev))
    u0 = (torch.zeros((E, n), dtype=torch.float32, device=dev) if u0 is None
          else torch.as_tensor(u0, dtype=torch.float32, device=dev))

    start_round = 0
    obj_prefix: list = []
    mse_prefix: list = []
    ledger_prefix: list[CommLedger] = []
    # the content hash reads the problem back to the host: only a run
    # that saves or resumes needs it
    fingerprint = (_config_fingerprint(cfg, problem, w_true is not None)
                   if cfg.checkpoint_dir is not None else None)
    if cfg.resume and has_checkpoint(cfg.checkpoint_dir):
        start_round, state, obj0, mse0, led0 = _load_checkpoint(
            cfg.checkpoint_dir, problem, fingerprint=fingerprint)
        if start_round % me or start_round > R:
            raise ValueError(
                f"checkpoint round {start_round} incompatible with "
                f"num_rounds={R}, metric_every={me}")
        obj_prefix, mse_prefix = [obj0], [mse0]
        ledger_prefix = [led0]
    else:
        # at join time every client knows the initial model (setup
        # broadcast, not metered): mirrors and mailboxes start consistent
        state = FederatedState(w=w0, u=u0, u_recv=u0, z_recv=w0[graph.dst])

    # chunk boundaries: the whole horizon is one chunk unless
    # checkpointing or tol early stopping splits it; a tol run re-chunks
    # at the metric cadence so the residual is checked at every metric
    # boundary.
    checkpointing = (cfg.checkpoint_dir is not None
                     and bool(cfg.checkpoint_every))
    with_residual = cfg.tol is not None
    if with_residual:
        step_rounds = me
    elif checkpointing:
        step_rounds = cfg.checkpoint_every
    else:
        step_rounds = max(R - start_round, 1)

    rs = _round_setup(problem, w_true, local_update=local_update,
                      compression=compression, rho=cfg.rho)

    def run_chunk(chunk_state, r0, r1):
        sched_chunk = torch.from_numpy(schedule[r0:r1]).to(dev)
        new_state, (obj, mse), meter, res = _run_chunk(
            rs, chunk_state, sched_chunk, metric_every=me,
            with_residual=with_residual)
        return new_state, (obj, mse, CommLedger(*meter)), res

    last_saved = start_round if cfg.resume else None
    last_parts: list = []

    def save_at(chunk_state, r1, parts):
        nonlocal last_saved
        _save_checkpoint(
            cfg.checkpoint_dir, r1, FederatedState(*chunk_state),
            torch.cat(obj_prefix + [p[0] for p in parts]),
            torch.cat(mse_prefix + [p[1] for p in parts]),
            CommLedger.concat(ledger_prefix + [p[2] for p in parts]),
            fingerprint)
        last_saved = r1

    def on_chunk(chunk_state, r1, parts):
        last_parts[:] = parts
        if not checkpointing:
            return
        if r1 % cfg.checkpoint_every and r1 != R:
            return
        save_at(chunk_state, r1, parts)

    chunk_state, traces, iterations, _stopped = run_chunked(
        run_chunk, (state.w, state.u, state.u_recv, state.z_recv),
        total=R, start=start_round, chunk_size=step_rounds, tol=cfg.tol,
        on_chunk=on_chunk)
    if checkpointing and last_parts and last_saved != iterations:
        # a tol-stop can land between checkpoint_every boundaries; the
        # converged final state must still be saved
        save_at(chunk_state, iterations, last_parts)
    w, u, u_recv, z_recv = chunk_state
    obj_parts = obj_prefix + ([traces[0]] if traces is not None else [])
    mse_parts = mse_prefix + ([traces[1]] if traces is not None else [])
    ledger_parts = ledger_prefix + ([traces[2]]
                                    if traces is not None else [])
    objective = (torch.cat(obj_parts) if obj_parts
                 else torch.zeros((0,), dtype=torch.float32, device=dev))
    mse_tr = (torch.cat(mse_parts) if mse_parts
              else torch.zeros((0,), dtype=torch.float32, device=dev))
    ledger = (CommLedger.concat(ledger_parts) if ledger_parts
              else CommLedger.empty(dev))
    ledger.export_obs()
    state = FederatedState(w=w, u=u, u_recv=u_recv, z_recv=z_recv)

    diagnostics = (certificate(problem, w, u) if cfg.compute_diagnostics
                   else {})
    if with_residual:
        diagnostics = dict(diagnostics)
        diagnostics["iterations"] = int(iterations)
    return FederatedResult(
        w=w, u=u, objective=objective,
        mse=None if w_true is None else mse_tr, lam=problem.lam,
        diagnostics=diagnostics, ledger=ledger,
        schedule=schedule[:iterations], state=state)
