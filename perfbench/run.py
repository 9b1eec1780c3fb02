"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 perfbench/run.py --workload squared.solve_tol --seed 7 \
        --seconds 40 --trace 0

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``), the numbers compared
with the plain reference last under ``compared``; the same numbers,
each beside its limit, are the last lines of standard error.  Exits
with 3, printing no result, without a CUDA device (or with fewer than
the cell needs), and with 4 if the JAX package or JAX is loaded once the
window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import bench

    cell = bench.Cell.load(args.workload)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # the program's float32 is float32: no TF32 in any matrix product
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    try:
        out = bench.run_cell(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device="cuda",
                             t_start=T_START)
    except bench.ForbiddenModules as e:
        print(f"perfbench: forbidden modules loaded: {e.args[0]}",
              file=sys.stderr)
        return 4
    found = bench.check_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    if "beyond_p90" in out["notes"]:
        print(f"requests {out['notes']['requests']}, beyond the 90th "
              f"percentile {out['notes']['beyond_p90']}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
