"""Readings that set the benchmark's limits, on the card, in one process.

    python3 perfbench/control.py readings --workload squared.solve_tol \
        --seeds 1-12 --calls 4 [--dtype bfloat16] [--fault frozen]

runs the cell's set-up and a short closed loop of ``--calls`` calls a
seed, then the comparison with the plain reference, and prints one JSON
line a seed with the numbers compared.  ``--dtype bfloat16`` is the
control (the program's own bfloat16 storage path); ``--fault`` plants a
fault of ``faults.py`` under the timed path.  The benchmark's own runs
never run this.

    python3 perfbench/control.py probe --config sbm1m-squared --seed 0

prints the eq.-11 residual of each metric block of a tol-0 solve from
zeros (2000 iterations), the probe a configuration's tol is set from.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def seeds(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def readings(args) -> None:
    from perfbench import bench

    cell = bench.Cell.load(args.workload)
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        out = bench.run_cell(cell, seed=seed, seconds=1e9, trace=False,
                             device="cuda", t_start=t0, dtype=args.dtype,
                             fault=args.fault, max_calls=args.calls)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "dtype": args.dtype,
            "fault": args.fault, "correct": out["correct"],
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "compared": {k: v["value"] for k, v in out["compared"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)


def probe(args) -> None:
    import torch
    from repro_torch.api import Solver

    from perfbench import bench

    spec = bench.load_json(ROOT / "BENCHMARK.json")
    cell_name = next(w["name"] for w in spec["workloads"]
                     if w["config"] == args.config)
    ctx = bench.Context(bench.Cell.load(cell_name), args.seed, "cuda")
    ctx.load_graph()
    ctx.draw_pool()
    ctx.attach_plan()
    cfg = ctx.solver_config(tol=0.0, num_iters=args.iters,
                            compute_diagnostics=False)
    r = Solver(cfg).run(ctx.problem(ctx.dataset(0)))
    res = r.residual.cpu().tolist()
    torch.cuda.synchronize()
    print(json.dumps({"config": args.config, "seed": args.seed,
                      "metric_every": ctx.metric_every,
                      "residual_at_800": res[800 // ctx.metric_every - 1],
                      "residuals": res}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", required=True)
    r.add_argument("--calls", type=int, required=True)
    r.add_argument("--dtype", default=None)
    r.add_argument("--fault", default=None)
    q = sub.add_parser("probe")
    q.add_argument("--config", required=True)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--iters", type=int, default=2000)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    (readings if args.what == "readings" else probe)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
