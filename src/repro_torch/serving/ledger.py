"""ServiceLedger: per-tenant request accounting for the solve service.

The port's copy of ``repro.serving.ledger``, with the same meters and obs
names. The serving twin of the federated
:class:`~repro_torch.federated.ledger.CommLedger`: where the federated
runtime meters what a run costs *on the wire*, the service ledger meters
what a tenant's request stream costs *in compute* — requests by kind,
plan-cache hits/misses, compile events, iterations spent, and the
iterations the warm-start machinery saved against each session's own cold
baseline.

Counters are plain host-side integers (requests are host events, unlike
the per-round device traces the CommLedger concatenates); ``summary()``
returns the same JSON/CSV-ready flat float dict shape.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ServiceLedger:
    """Per-tenant request/compute meter.

    Attributes:
      requests:     every service call made by the tenant
                    (create/update/solve/solve_path/close).
      creates, updates, solves, path_points, closes: per-kind splits
                    (``solves`` counts solve_path points too, so it is
                    the number of SolveResponses produced).
      cache_hits, cache_misses: plan-cache outcomes of those solves.
      compiles:     solves whose executable signature (loss, regularizer,
                    backend, shapes) was new to the service — each one
                    paid the first solve of that signature in the
                    process (the port's counterpart of an XLA trace).
      iterations:   total solver iterations run for the tenant.
      iterations_cold_ref: sum, over *warm-started* solves, of the owning
                    session's cold-solve iteration count (the baseline
                    those solves are measured against).
      iterations_saved: sum of max(cold_ref - iterations, 0) over
                    warm-started solves — iterations not run thanks to
                    warm starts.
    """

    tenant: str
    requests: int = 0
    creates: int = 0
    updates: int = 0
    solves: int = 0
    path_points: int = 0
    closes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    compiles: int = 0
    iterations: int = 0
    iterations_cold_ref: int = 0
    iterations_saved: int = 0

    # -- recording -----------------------------------------------------------
    def record_solve(self, *, cache_hit: bool, compiled: bool,
                     iterations: int, cold_ref: int | None) -> None:
        """One SolveResponse produced: cache outcome + iteration cost.

        ``cold_ref`` is the owning session's cold-iterations baseline
        when this solve was warm-started, None when it *is* the cold
        solve (nothing to save against yet).
        """
        self.solves += 1
        if cache_hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        if compiled:
            self.compiles += 1
        self.iterations += int(iterations)
        if cold_ref is not None:
            self.iterations_cold_ref += int(cold_ref)
            self.iterations_saved += max(int(cold_ref) - int(iterations), 0)

    def record_path(self, *, points: int, point_iterations: int,
                    warm_iterations: int, cache_hit: bool,
                    compiled: bool) -> None:
        """One solve_path sweep producing ``points`` responses.

        A sweep is a single plan lookup (hit/compile attributed once,
        not once per point) plus one *shared* warm pre-solve
        (``warm_iterations``, counted once per sweep) followed by
        ``points`` lane-stacked final solves of ``point_iterations`` each.
        """
        self.solves += points
        self.path_points += points
        if cache_hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        if compiled:
            self.compiles += 1
        self.iterations += (int(warm_iterations)
                            + int(points) * int(point_iterations))

    # -- aggregates ----------------------------------------------------------
    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def warm_iteration_ratio(self) -> float:
        """iterations-run / cold-baseline over warm solves (lower is
        better; 1.0 means warm starts saved nothing)."""
        if not self.iterations_cold_ref:
            return 1.0
        warm_iters = self.iterations_cold_ref - self.iterations_saved
        return warm_iters / self.iterations_cold_ref

    def export_obs(self) -> None:
        """Mirror the tenant's aggregates into the obs registry.

        Every exported value is guarded finite by construction:
        ``cache_hit_rate`` and ``warm_iteration_ratio`` both define an
        empty ledger as 0.0 / 1.0 rather than 0/0, so a zero-request
        tenant still exports clean gauges (no NaN ever reaches a
        snapshot — ``export_json`` would refuse to serialize it).
        """
        from repro_torch import obs
        if not obs.enabled():
            return
        labels = {"tenant": self.tenant}
        obs.gauge("repro_tenant_requests",
                  help="service calls by tenant", **labels
                  ).set(float(self.requests))
        obs.gauge("repro_tenant_solves",
                  help="solve responses produced by tenant", **labels
                  ).set(float(self.solves))
        obs.gauge("repro_tenant_iterations",
                  help="solver iterations spent by tenant", **labels
                  ).set(float(self.iterations))
        obs.gauge("repro_tenant_cache_hit_rate",
                  help="plan-cache hit rate by tenant", **labels
                  ).set(float(self.cache_hit_rate))
        obs.gauge("repro_tenant_warm_iteration_ratio",
                  help="warm iterations / cold baseline by tenant "
                       "(1.0 = warm starts saved nothing)", **labels
                  ).set(float(self.warm_iteration_ratio))

    def summary(self) -> dict[str, float]:
        """Flat float dict (JSON/CSV-ready) of the tenant's totals."""
        return {
            "requests": float(self.requests),
            "creates": float(self.creates),
            "updates": float(self.updates),
            "solves": float(self.solves),
            "path_points": float(self.path_points),
            "closes": float(self.closes),
            "cache_hits": float(self.cache_hits),
            "cache_misses": float(self.cache_misses),
            "cache_hit_rate": float(self.cache_hit_rate),
            "compiles": float(self.compiles),
            "iterations": float(self.iterations),
            "iterations_saved": float(self.iterations_saved),
            "warm_iteration_ratio": float(self.warm_iteration_ratio),
        }
