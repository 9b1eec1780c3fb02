"""load_plans_s: seconds `PlanCache.load` takes to restore the
configuration's saved plans in set-up (plan cache layer; moves setup_s).
Timed by the harness around the call."""


def read(run):
    return run.ctx.load_plans_s
