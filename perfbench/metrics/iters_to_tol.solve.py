"""iters_to_tol.solve: mean stopping iteration of the window's tol
solves, from each `SolveResult` (solver / tol engine layer; moves
solve_s)."""


def read(run):
    if run.kind != "solve":
        return None
    return sum(r["iterations"] for r in run.records) / len(run.records)
