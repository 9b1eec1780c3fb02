"""The port's federated message-passing runtime, against the reference's.

Ports of ``tests/test_federated.py`` on the port's objects (CPU tensors):

  * the runtime is *deterministic in the seed*: one seed -> one
    participation schedule -> one ledger -> one trajectory, bitwise;
  * the partial-participation semantics are real message-passing
    semantics: inactive clients freeze, neighbours consume stale
    messages, mailboxes persist;
  * the ledger meters exactly what the protocol sends (counts follow
    from the schedule; bytes follow from the compression policy);
  * checkpoint/resume through ``repro_torch.checkpoint`` is bitwise: a
    run interrupted at round K and resumed equals the straight run.

Held against the reference on the same inputs:

  * ``participation_schedule`` bit-equal for every policy and seed;
  * ``int8`` / ``topk`` compression outputs equal (tolerance 0; ties and
    halves included);
  * synchronous ``run_federated`` on the §5 instance within 1e-6 of the
    port's dense solve and within 1e-4 (the conformance suite's bound) of
    the reference's federated run;
  * a ``bernoulli`` + ``int8`` + ``prox`` run: schedule and ledger
    equal, bit for bit, and ``w`` within 1e-5 of the reference's over 60
    rounds at rho 1 (the test says why that horizon);
  * a ``tol`` run stops at the reference's round.

The round-for-round equality with the dense backend on all eight
scenarios is the ``federated_sync`` column of
``tests/test_torch_conformance.py``.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                        # noqa: E402
from repro import federated as jfed                            # noqa: E402
from repro.scenarios import get_scenario as j_get              # noqa: E402
from repro_torch.api import Solver, SolverConfig               # noqa: E402
from repro_torch.federated import (COMPRESSIONS, LOCAL_UPDATES,  # noqa: E402
                                   PARTICIPATION, FederatedConfig,
                                   FixedSchedule, Int8Quantization,
                                   MultiProxSteps, TopKSparsification,
                                   get_compression, get_local_update,
                                   get_participation,
                                   participation_schedule, run_federated)
from repro_torch.federated.engine import _load_checkpoint     # noqa: E402
from repro_torch.scenarios import get_scenario                 # noqa: E402

LEDGER_FIELDS = ("up_msgs", "up_bytes", "down_msgs", "down_bytes")


def _instance(name="sbm_regression", seed=0):
    return get_scenario(name).build(seed=seed, smoke=True, device="cpu")


def _bitwise_equal(a, b):
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def test_policy_registries_resolve():
    assert {"full", "bernoulli", "dropout", "straggler",
            "fixed"} <= set(PARTICIPATION)
    assert {"single", "prox"} <= set(LOCAL_UPDATES)
    assert {"none", "int8", "topk"} <= set(COMPRESSIONS)
    assert get_participation("bernoulli", p=0.25).p == 0.25
    assert get_local_update("prox", num_steps=3).num_steps == 3
    assert get_compression("topk", fraction=0.25).fraction == 0.25
    with pytest.raises(ValueError):
        get_participation("nope")
    with pytest.raises(TypeError):
        get_compression(Int8Quantization(), extra=1)


# ---------------------------------------------------------------------------
# participation schedules
# ---------------------------------------------------------------------------

def test_schedule_deterministic_in_seed():
    cfg = FederatedConfig(participation="bernoulli", seed=7)
    a = participation_schedule(cfg, 50, 30)
    b = participation_schedule(cfg, 50, 30)
    c = participation_schedule(cfg.replace(seed=8), 50, 30)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_bernoulli_rate():
    cfg = FederatedConfig(participation=get_participation("bernoulli",
                                                          p=0.3))
    sched = participation_schedule(cfg, 400, 50)
    assert abs(sched.mean() - 0.3) < 0.02


def test_dropout_is_permanent():
    cfg = FederatedConfig(
        participation=get_participation("dropout", rate=0.05), seed=1)
    sched = participation_schedule(cfg, 100, 40)
    # once a node goes inactive it never comes back
    for v in range(40):
        col = sched[:, v]
        dead = np.where(col == 0.0)[0]
        if len(dead):
            assert np.all(col[dead[0]:] == 0.0)
    assert sched[0].sum() > sched[-1].sum()  # attrition really happened


def test_straggler_shifts_rounds_late():
    policy = get_participation("straggler", p=1.0, p_slow=1.0, delay=4)
    cfg = FederatedConfig(participation=policy, seed=0)
    sched = participation_schedule(cfg, 20, 8)
    assert np.all(sched[:4] == 0.0)
    assert np.all(sched[4:] == 1.0)


def test_fixed_schedule_repeats_last_row():
    mask = ((1.0, 0.0), (0.0, 1.0))
    cfg = FederatedConfig(participation=FixedSchedule(mask=mask))
    sched = participation_schedule(cfg, 4, 2)
    assert np.array_equal(sched, [[1, 0], [0, 1], [0, 1], [0, 1]])


def test_schedule_prefix_stable_across_horizons():
    """Every policy's schedule prefix is independent of the horizon —
    resuming with an extended num_rounds replays the executed prefix."""
    for name in sorted(PARTICIPATION):
        if name == "fixed":
            continue
        cfg = FederatedConfig(participation=name, seed=6)
        short = participation_schedule(cfg, 20, 9)
        long = participation_schedule(cfg, 45, 9)
        assert np.array_equal(long[:20], short), name
    cfg = FederatedConfig(
        participation=get_participation("dropout", rate=0.02, p=0.7),
        seed=6)
    assert np.array_equal(participation_schedule(cfg, 45, 9)[:20],
                          participation_schedule(cfg, 20, 9))


POLICIES = {
    "full": {}, "bernoulli": {"p": 0.4}, "dropout": {"rate": 0.05},
    "dropout_sampled": {"rate": 0.02, "p": 0.7},
    "straggler": {"p": 0.8, "p_slow": 0.3, "delay": 3},
    "fixed": {"mask": ((1.0, 0.0, 1.0), (0.0, 1.0, 1.0))}}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_schedule_equals_reference(policy, seed):
    name = policy.split("_")[0]
    kw = POLICIES[policy]
    nodes = 3 if name == "fixed" else 37
    got = participation_schedule(FederatedConfig(
        participation=get_participation(name, **kw), seed=seed), 60, nodes)
    want = jfed.participation_schedule(jfed.FederatedConfig(
        participation=jfed.get_participation(name, **kw), seed=seed), 60,
        nodes)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# compression policies
# ---------------------------------------------------------------------------

def test_int8_quantization_error_bound():
    rng = np.random.default_rng(0)
    msg = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    out = Int8Quantization().compress(msg).numpy()
    scale = np.max(np.abs(msg.numpy()), axis=-1, keepdims=True) / 127.0
    assert np.all(np.abs(out - msg.numpy()) <= 0.5 * scale + 1e-7)
    assert Int8Quantization().message_bytes(8) == 12.0


def test_topk_keeps_largest_coordinates():
    msg = torch.tensor([[3.0, -1.0, 0.5, 2.0]])
    out = TopKSparsification(fraction=0.5).compress(msg).numpy()
    assert np.array_equal(out, [[3.0, 0.0, 0.0, 2.0]])
    assert TopKSparsification(fraction=0.5).message_bytes(4) == 16.0
    tied = torch.ones((1, 4))
    out = TopKSparsification(fraction=0.5).compress(tied).numpy()
    assert int(np.count_nonzero(out)) == 2


def test_none_compression_is_identity():
    msg = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 3)).astype(np.float32))
    assert _bitwise_equal(get_compression("none").compress(msg), msg)


def _messages():
    """Random messages, plus rows with exact halves (127 * k/2 over the
    row max: round half to even) and tied magnitudes (topk's order)."""
    rng = np.random.default_rng(5)
    msg = rng.standard_normal((200, 6)).astype(np.float32)
    msg[0] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    msg[1] = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    msg[2] = [2.0, -2.0, 1.0, -1.0, 2.0, 0.0]
    msg[3] = 0.0
    return msg


@pytest.mark.parametrize("policy", [("int8", {}), ("topk", {}),
                                    ("topk", {"fraction": 0.25}),
                                    ("topk", {"fraction": 0.7})])
def test_compression_equals_reference(policy):
    """Tolerance 0: the same float32 operations in both frameworks."""
    name, kw = policy
    msg = _messages()
    got = get_compression(name, **kw).compress(torch.from_numpy(msg))
    want = jfed.get_compression(name, **kw).compress(jnp.asarray(msg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (get_compression(name, **kw).message_bytes(6)
            == jfed.get_compression(name, **kw).message_bytes(6))


# ---------------------------------------------------------------------------
# runtime semantics
# ---------------------------------------------------------------------------

def test_run_deterministic_in_seed():
    inst = _instance()
    cfg = FederatedConfig(num_rounds=40, rho=1.9,
                          participation="bernoulli", compression="int8",
                          local_update="prox", seed=11)
    a = run_federated(inst.problem, cfg)
    b = run_federated(inst.problem, cfg)
    assert np.array_equal(a.schedule, b.schedule)
    assert _bitwise_equal(a.w, b.w)
    assert _bitwise_equal(a.objective, b.objective)
    for f in LEDGER_FIELDS:
        assert _bitwise_equal(getattr(a.ledger, f), getattr(b.ledger, f))


def test_inactive_clients_freeze():
    """A node that never participates keeps its initial model."""
    inst = _instance("chain_changepoint")
    V = inst.problem.num_nodes
    mask = np.ones((1, V), np.float32)
    mask[0, 0] = 0.0
    cfg = FederatedConfig(num_rounds=20, rho=1.9,
                          participation=FixedSchedule(
                              mask=tuple(map(tuple, mask))))
    res = run_federated(inst.problem, cfg)
    assert np.all(res.w.numpy()[0] == 0.0)
    assert np.any(res.w.numpy()[1:] != 0.0)


@pytest.mark.parametrize("case", ["stale", "prox_int8"])
def test_partial_participation_still_converges(case):
    """Stale-message semantics (bernoulli 0.5 on grid2d) and FedProx-style
    local steps with int8 messages both drive the objective down."""
    if case == "stale":
        inst = _instance("grid2d")
        cfg = FederatedConfig(num_rounds=60, rho=1.9,
                              participation=get_participation("bernoulli",
                                                              p=0.5), seed=3)
        factor = 0.5
    else:
        inst = _instance()
        cfg = FederatedConfig(num_rounds=60, rho=1.9,
                              participation="bernoulli",
                              local_update=MultiProxSteps(num_steps=3),
                              compression="int8", seed=5)
        factor = 0.2
    obj = run_federated(inst.problem, cfg).objective.numpy()
    assert np.all(np.isfinite(obj))
    assert obj[-1] < factor * obj[0]


def test_solver_backend_dispatch_and_config_plumbing():
    """backend='federated' flows policies through SolverConfig.federated
    and folds the ledger summary into the diagnostics."""
    inst = _instance("grid2d")
    fed = FederatedConfig(participation="bernoulli", compression="int8",
                          seed=2)
    res = Solver(SolverConfig(num_iters=30, rho=1.9, backend="federated",
                              federated=fed)).run(inst.problem)
    comm = res.diagnostics["comm"]
    assert comm["rounds"] == 30.0
    E = inst.problem.graph.num_edges
    assert 0 < comm["up_messages"] < 30 * E
    with pytest.raises(TypeError):
        Solver(SolverConfig(backend="federated",
                            federated="bogus")).run(inst.problem)


# ---------------------------------------------------------------------------
# ledger accounting
# ---------------------------------------------------------------------------

def test_ledger_counts_follow_schedule_exactly():
    inst = _instance("grid2d")
    problem = inst.problem
    g = problem.graph
    n = problem.num_features
    cfg = FederatedConfig(num_rounds=25, participation="bernoulli",
                          compression="int8", seed=9)
    res = run_federated(problem, cfg)
    sched = res.schedule
    up_expect = sched[:, g.dst.numpy()].sum(axis=1)
    down_expect = sched[:, g.src.numpy()].sum(axis=1)
    np.testing.assert_array_equal(res.ledger.up_msgs.numpy(), up_expect)
    np.testing.assert_array_equal(res.ledger.down_msgs.numpy(), down_expect)
    np.testing.assert_allclose(res.ledger.up_bytes.numpy(),
                               up_expect * (n + 4.0))
    np.testing.assert_allclose(res.ledger.down_bytes.numpy(),
                               down_expect * 4.0 * n)
    cum = res.ledger.cumulative_bytes()
    assert np.all(np.diff(cum) >= 0)
    assert cum[-1] == res.ledger.total_bytes
    summary = res.ledger.summary()
    assert summary["rounds"] == 25.0
    assert summary["total_bytes"] == res.ledger.total_bytes


def test_full_participation_ledger_is_every_edge_every_round():
    inst = _instance("chain_changepoint")
    E = inst.problem.graph.num_edges
    n = inst.problem.num_features
    res = run_federated(inst.problem, FederatedConfig(num_rounds=10))
    assert np.all(res.ledger.up_msgs.numpy() == E)
    assert np.all(res.ledger.down_msgs.numpy() == E)
    assert res.ledger.total_bytes == 10 * E * (4.0 * n + 4.0 * n)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w_true", [False, True])
def test_checkpoint_resume_is_bitwise(tmp_path, w_true):
    inst = _instance("grid2d")
    wt = inst.w_true if w_true else None
    d = str(tmp_path / "ckpt")
    cfg = FederatedConfig(num_rounds=40, rho=1.9,
                          participation="bernoulli", compression="int8",
                          local_update="prox", seed=4,
                          checkpoint_dir=d, checkpoint_every=10)
    straight = run_federated(inst.problem, cfg, w_true=wt)

    shutil.rmtree(d)
    os.makedirs(d)
    run_federated(inst.problem, cfg.replace(num_rounds=20), w_true=wt)
    resumed = run_federated(inst.problem, cfg.replace(resume=True),
                            w_true=wt)

    assert _bitwise_equal(straight.w, resumed.w)
    assert _bitwise_equal(straight.u, resumed.u)
    assert _bitwise_equal(straight.objective, resumed.objective)
    if w_true:
        assert _bitwise_equal(straight.mse, resumed.mse)
    for f in LEDGER_FIELDS:
        assert _bitwise_equal(getattr(straight.ledger, f),
                              getattr(resumed.ledger, f))
    assert straight.ledger.num_rounds == resumed.ledger.num_rounds == 40


def test_checkpoint_state_round_trips(tmp_path):
    """The saved (w, u, round, ledger) really is the live state, in the
    reference's file layout: arrays.npz under the reference's leaf keys
    plus manifest.json."""
    inst = _instance("chain_changepoint")
    d = str(tmp_path / "ckpt")
    cfg = FederatedConfig(num_rounds=12, rho=1.9, checkpoint_dir=d,
                          checkpoint_every=12)
    res = run_federated(inst.problem, cfg)
    rnd, state, obj, mse, ledger = _load_checkpoint(d, inst.problem)
    assert rnd == 12
    assert _bitwise_equal(state.w, res.w)
    assert _bitwise_equal(state.u, res.u)
    assert _bitwise_equal(obj, res.objective)
    assert _bitwise_equal(ledger.up_bytes, res.ledger.up_bytes)
    payload = os.path.join(d, "round_00000012")
    with np.load(os.path.join(payload, "arrays.npz")) as data:
        keys = sorted(data.files)
    assert keys == ["ledger/0", "ledger/1", "ledger/2", "ledger/3", "mse",
                    "objective", "state/0", "state/1", "state/2", "state/3"]
    with open(os.path.join(payload, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["state/0"] == {"shape": list(res.w.shape),
                                   "dtype": "float32"}


def test_checkpoint_config_validation(tmp_path):
    inst = _instance("chain_changepoint")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_federated(inst.problem,
                      FederatedConfig(num_rounds=4, checkpoint_every=2))
    with pytest.raises(ValueError, match="multiple of metric_every"):
        run_federated(inst.problem, FederatedConfig(
            num_rounds=4, metric_every=2, checkpoint_every=3,
            checkpoint_dir=str(tmp_path)))


def test_resume_rejects_config_mismatch(tmp_path):
    """Resuming under a different seed/policy would splice two different
    protocols; the recorded config fingerprint rejects it."""
    inst = _instance("chain_changepoint")
    cfg = FederatedConfig(num_rounds=8, participation="bernoulli", seed=4,
                          checkpoint_dir=str(tmp_path), checkpoint_every=4)
    run_federated(inst.problem, cfg.replace(num_rounds=4))
    for bad in (cfg.replace(seed=5), cfg.replace(compression="int8"),
                cfg.replace(rho=1.9), cfg.replace(checkpoint_every=2)):
        with pytest.raises(ValueError, match="different run config"):
            run_federated(inst.problem, bad.replace(resume=True))
    run_federated(inst.problem, cfg.replace(resume=True))


def test_checkpoint_save_is_crash_safe(tmp_path):
    """A torn save must never destroy the previous checkpoint: payloads
    land in a per-round dir and meta.json is swapped in last."""
    inst = _instance("chain_changepoint")
    d = str(tmp_path)
    cfg = FederatedConfig(num_rounds=8, checkpoint_dir=d,
                          checkpoint_every=4)
    run_federated(inst.problem, cfg.replace(num_rounds=4))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["round"] == 4 and meta["dir"] == "round_00000004"
    os.makedirs(os.path.join(d, "round_00000008"))
    res = run_federated(inst.problem, cfg.replace(resume=True))
    assert res.ledger.num_rounds == 8
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["round"] == 8
    assert sorted(n for n in os.listdir(d) if n.startswith("round_")) == \
        ["round_00000008"]


def test_resume_extends_horizon_bitwise(tmp_path):
    """A straggler run checkpointed at its horizon and resumed with a
    longer one equals the straight long run (prefix-stable schedules)."""
    inst = _instance("chain_changepoint")
    d = str(tmp_path / "ck")
    cfg = FederatedConfig(num_rounds=40, participation="straggler", seed=8,
                          checkpoint_dir=d, checkpoint_every=20)
    straight = run_federated(inst.problem, cfg)
    shutil.rmtree(d)
    os.makedirs(d)
    run_federated(inst.problem, cfg.replace(num_rounds=20))
    resumed = run_federated(inst.problem, cfg.replace(resume=True))
    assert _bitwise_equal(straight.w, resumed.w)
    assert _bitwise_equal(straight.objective, resumed.objective)


@pytest.mark.parametrize("case", ["problem_content", "w_true",
                                  "problem_shape"])
def test_resume_rejects_a_different_problem(tmp_path, case):
    """Same shapes but another lambda, a w_true-ness other than the
    saved one (the MSE trace prefix would be silently zero), or another
    problem's shapes: the fingerprint refuses each, and without one,
    the checkpoint's shape validation refuses the last."""
    name = "grid2d" if case == "problem_content" else "chain_changepoint"
    inst = _instance(name)
    cfg = FederatedConfig(num_rounds=8, checkpoint_dir=str(tmp_path),
                          checkpoint_every=4)
    run_federated(inst.problem, cfg.replace(num_rounds=4))
    resume = cfg.replace(resume=True)
    if case == "problem_content":
        with pytest.raises(ValueError, match="different run config"):
            run_federated(inst.problem.with_lam(0.1), resume)
    elif case == "w_true":
        with pytest.raises(ValueError, match="w_true"):
            run_federated(inst.problem, resume, w_true=inst.w_true)
        run_federated(inst.problem, resume)
    else:
        other = _instance("grid2d")
        with pytest.raises(ValueError, match="different run config"):
            run_federated(other.problem, resume)
        with pytest.raises(ValueError, match="shape mismatch"):
            _load_checkpoint(str(tmp_path), other.problem)


# ---------------------------------------------------------------------------
# against the reference's runtime
# ---------------------------------------------------------------------------

def _s5_pair():
    """The §5 instance (``make_sbm_regression(seed=0)``, lambda 1e-3) in
    both packages."""
    from repro.api import Problem as JProblem
    from repro.data.synthetic import make_sbm_regression as j_make
    from repro_torch.api import Problem
    from repro_torch.data.synthetic import make_sbm_regression

    ds = make_sbm_regression(seed=0, device="cpu")
    jds = j_make(seed=0)
    return (Problem.create(ds.graph, ds.data, 1e-3, device="cpu"), ds.w_true,
            JProblem.create(jds.graph, jds.data, 1e-3), jds.w_true)


S5_CONF = dict(num_rounds=200, rho=1.9, metric_every=10)


def test_sync_run_on_s5_matches_dense_and_reference():
    problem, w_true, jproblem, jw_true = _s5_pair()
    got = run_federated(problem, FederatedConfig(**S5_CONF), w_true=w_true)
    dense = Solver(SolverConfig(num_iters=200, rho=1.9,
                                metric_every=10)).run(problem, w_true=w_true)
    np.testing.assert_allclose(got.w.numpy(), dense.w.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.objective.numpy(),
                               dense.objective.numpy(), rtol=1e-6)
    want = jfed.run_federated(jproblem, jfed.FederatedConfig(**S5_CONF),
                              w_true=jw_true)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-4)
    for f in LEDGER_FIELDS:
        np.testing.assert_array_equal(getattr(got.ledger, f).numpy(),
                                      np.asarray(getattr(want.ledger, f)))


def test_partial_run_matches_reference():
    """bernoulli (0.5) + int8 + prox (2 steps) on grid2d, 60 rounds at
    rho 1: the schedule and every ledger meter equal the reference's bit
    for bit; ``w`` within 1e-5 of the reference's and the objective trace
    within rtol 1e-5.

    Why this horizon and rho: the two frameworks differ by ~4e-7 after
    one round (summation order), and partial participation does not
    damp that.  Measured on this instance: at rho 1.9 without
    compression the gap grows to 1.3e-3 by round 60; at rho 1 it stays
    at 2.0e-6 through round 60 with or without int8, and by round 120
    one int8 rounding that falls the other way has moved a message by a
    quantum (8e-3 on ``w``).  The ledger does not depend on the
    trajectory and is equal at any horizon."""
    conf = dict(num_rounds=60, rho=1.0, metric_every=10, seed=13,
                compression="int8")
    inst = _instance("grid2d")
    jinst = j_get("grid2d").build(seed=0, smoke=True)
    got = run_federated(inst.problem, FederatedConfig(
        **conf, participation=get_participation("bernoulli", p=0.5),
        local_update=get_local_update("prox", num_steps=2)))
    want = jfed.run_federated(jinst.problem, jfed.FederatedConfig(
        **conf, participation=jfed.get_participation("bernoulli", p=0.5),
        local_update=jfed.get_local_update("prox", num_steps=2)))
    assert np.array_equal(got.schedule, want.schedule)
    for f in LEDGER_FIELDS:
        np.testing.assert_array_equal(getattr(got.ledger, f).numpy(),
                                      np.asarray(getattr(want.ledger, f)))
    assert got.ledger.summary() == want.ledger.summary()
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-5)


def test_tol_run_stops_at_the_reference_round():
    """Residual-based stopping (chunk max at the metric cadence) on the
    §5 instance: the port stops at the reference's round, and the
    synchronous run stops where the port's dense tol solve does."""
    problem, _, jproblem, _ = _s5_pair()
    conf = dict(num_rounds=1000, rho=1.9, metric_every=10, tol=5e-2)
    got = run_federated(problem, FederatedConfig(**conf))
    want = jfed.run_federated(jproblem, jfed.FederatedConfig(**conf))
    its = got.diagnostics["iterations"]
    assert its == want.diagnostics["iterations"]
    assert 0 < its < conf["num_rounds"]
    assert got.ledger.num_rounds == its == got.schedule.shape[0]
    # the dense tol solve on the same budget stops there too
    dense = Solver(SolverConfig(num_iters=conf["num_rounds"], rho=1.9,
                                metric_every=10, tol=5e-2)).run(problem)
    assert dense.diagnostics["iterations"] == its
