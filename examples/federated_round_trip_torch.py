"""Federated round trip (PyTorch port): the message-passing runtime end
to end.

Walks the port's federated runtime through its whole surface on one
scenario:

  1. the synchronous full-participation mode reproduces the dense
     backend's trajectory exactly (the runtime *is* Algorithm 1),
  2. partial participation + int8-compressed messages trade accuracy
     per round against metered communication (the ledger),
  3. a run checkpointed every K rounds, interrupted, and resumed is
     bitwise the straight run.

    python examples/federated_round_trip_torch.py               # CUDA card
    python examples/federated_round_trip_torch.py --device cpu  # on the CPU
    REPRO_SMOKE=1 python examples/federated_round_trip_torch.py # CI-sized
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch                                                   # noqa: E402

from repro_torch.api import Solver, SolverConfig               # noqa: E402
from repro_torch.federated import (FederatedConfig,            # noqa: E402
                                   run_federated)
from repro_torch.scenarios import get_scenario                 # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    smoke = bool(os.environ.get("REPRO_SMOKE"))
    rounds = 200 if smoke else 1000

    # 1. a scenario from the zoo: the paper's §5 SBM regression setup
    inst = get_scenario("sbm_regression").build(seed=0, smoke=smoke,
                                                device=args.device)
    g = inst.problem.graph
    print(f"empirical graph: |V|={g.num_nodes} |E|={g.num_edges}")

    # 2. synchronous full participation == the dense backend, exactly
    dense = Solver(SolverConfig(num_iters=rounds, rho=1.9)).run(inst.problem)
    sync = run_federated(inst.problem,
                         FederatedConfig(num_rounds=rounds, rho=1.9))
    w_diff = float((sync.w - dense.w).abs().max())
    print(f"sync runtime vs dense backend: max|w - w_dense| = {w_diff:.1e}")
    if w_diff > 1e-6:
        raise SystemExit(f"sync mode must be the dense oracle: {w_diff}")
    print(f"  full-participation communication: "
          f"{sync.ledger.total_bytes / 1e6:.2f} MB over {rounds} rounds")

    # 3. a realistic federation: half the clients show up each round,
    #    messages cross the edges int8-quantized, four local prox steps
    fed_cfg = FederatedConfig(num_rounds=rounds, rho=1.9,
                              participation="bernoulli", compression="int8",
                              local_update="prox", seed=1)
    fed = run_federated(inst.problem, fed_cfg)
    print("partial participation (p=0.5) + int8 messages + 4 local steps:")
    print(f"  objective {float(fed.objective[0]):.2f} -> "
          f"{float(fed.objective[-1]):.4f} "
          f"(dense oracle: {float(dense.objective[-1]):.4f})")
    for k, v in fed.ledger.summary().items():
        print(f"  ledger {k}: {v:,.0f}")
    saving = 1.0 - fed.ledger.total_bytes / sync.ledger.total_bytes
    print(f"  wire bytes saved vs sync full participation: {saving:.0%}")

    # 4. checkpoint every K rounds, interrupt at the halfway mark, resume —
    #    the resumed trajectory is bitwise the straight one
    ckpt_dir = tempfile.mkdtemp(prefix="fed_ckpt_")
    try:
        ck = fed_cfg.replace(checkpoint_dir=ckpt_dir,
                             checkpoint_every=rounds // 4)
        straight = run_federated(inst.problem, ck)
        shutil.rmtree(ckpt_dir)
        os.makedirs(ckpt_dir)
        run_federated(inst.problem, ck.replace(num_rounds=rounds // 2))
        resumed = run_federated(inst.problem, ck.replace(resume=True))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    bitwise = (torch.equal(straight.w, resumed.w)
               and torch.equal(straight.objective, resumed.objective))
    print(f"checkpoint/resume at round {rounds // 2}: bitwise = {bitwise}")
    if not bitwise:
        raise SystemExit("resumed run must equal the straight run bitwise")
    return 0


if __name__ == "__main__":
    sys.exit(main())
