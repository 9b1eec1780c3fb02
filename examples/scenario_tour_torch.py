"""Tour of the scenario zoo (PyTorch port): every registered workload,
solved end to end.

Walks the port's scenario registry (``repro_torch.scenarios``): prints
each scenario's metadata, builds its smoke-sized instance, solves it on
the dense backend with lambda continuation, and reports the reference
metrics — the five-minute "what can this system do" demo.

    python examples/scenario_tour_torch.py               # smoke, CUDA card
    python examples/scenario_tour_torch.py --device cpu  # on the CPU
    REPRO_FULL=1 python examples/scenario_tour_torch.py  # full-size instances
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.api import Solver, SolverConfig               # noqa: E402
from repro_torch.scenarios import SCENARIOS, get_scenario      # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    smoke = not os.environ.get("REPRO_FULL")
    config = SolverConfig(continuation=True, rho=1.9,
                          warm_iters=600 if smoke else 3000,
                          final_iters=300 if smoke else 1000)

    print(f"{len(SCENARIOS)} registered scenarios"
          f" ({'smoke' if smoke else 'full'} instances)\n")
    for name in sorted(SCENARIOS):
        scenario = get_scenario(name)
        inst = scenario.build(seed=0, smoke=smoke, device=args.device)
        g = inst.problem.graph
        print(f"== {name} ==")
        print(f"   {scenario.description}")
        print(f"   graph: {scenario.graph_family} |V|={g.num_nodes} "
              f"|E|={g.num_edges}   data: {scenario.data_model}")
        print(f"   loss: {scenario.loss}   regularizer: "
              f"{scenario.regularizer}   lam: {scenario.lam}   "
              f"sweep grid: {list(scenario.lam_path)}")
        res = Solver(config).run(inst.problem)
        metrics = inst.evaluate(res.w)
        print("   solved:", "  ".join(f"{k}={v:.3g}"
                                      for k, v in sorted(metrics.items())))
        print()

    print("next: sweep all of this across backends and lambda with\n"
          "    python experiments/run_torch.py --smoke")
    return 0


if __name__ == "__main__":
    sys.exit(main())
