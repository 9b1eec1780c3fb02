"""serve_host_ms.serve: mean milliseconds a request spends outside the
service's own timed solve (the response's `solve_seconds`): the update,
the plan lookup, the warm start, the response's read and the weights'
copy (serving layer; moves request_p90_ms)."""


def read(run):
    if run.kind != "serve":
        return None
    return 1e3 * sum(r["seconds"] - r["solve_seconds"]
                     for r in run.records) / len(run.records)
