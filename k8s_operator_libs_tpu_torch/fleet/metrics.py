"""``tpu_operator_fleet_*``: the fleet control plane's metric family.

The JAX package's ``fleet/metrics.py``; its text is the JAX collector's,
byte for byte, rendered through the shared emitter of
``upgrade/metrics.py`` and served by the ``MetricsServer``:

* **the ledger** (``FleetOrchestrator``): grants, budget denials, ticks
  and API errors as counters, and the last grant round's ledger (the
  resolved budget, the pools granted, done and pending, and the budget's
  **headroom**, the slots the next round could grant);
* **the Leases** (each ``ShardWorker``): each worker's owned shards, its
  Lease acquisitions and their failover part (a shard taken from a stale
  owner, the number to alert on), its Lease losses;
* **the passes**: each worker's passes and each shard's
  (``shard_passes{shard=...}``): a shard whose count stands still while its
  Lease is held is a wedged worker.

Both halves are duck-typed and either may be absent: a worker process
exports the Lease and pass half, the orchestrator daemon the ledger half.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ..upgrade.metrics import merge_label, prom_label, render_rows, render_samples

_PREFIX = "tpu_operator_fleet"


class FleetMetrics:
    """Render the fleet tier's counters for the shared MetricsServer."""

    def __init__(self, orchestrator: Optional[Any] = None,
                 workers: Optional[list] = None) -> None:
        self._orchestrator = orchestrator
        self._lock = threading.Lock()
        self._workers: list[Any] = list(workers or [])

    def add_worker(self, worker: Any) -> None:
        with self._lock:
            if worker not in self._workers:
                self._workers.append(worker)

    def render(self) -> str:
        out: list[str] = []
        orch = self._orchestrator
        if orch is not None:
            summary = getattr(orch, "last_summary", None) or {}
            budget = int(summary.get("budget", 0) or 0)
            granted = int(summary.get("granted", 0) or 0)
            done = int(summary.get("done", 0) or 0)
            rows = [
                ("grants_total", "counter",
                 "Pool roll grants issued by this orchestrator", orch.grants_issued),
                ("budget_denials_total", "counter",
                 "Pending pools deferred by the global disruption budget", orch.budget_denials),
                ("orchestrator_ticks_total", "counter", "Grant rounds attempted", orch.ticks),
                ("orchestrator_api_errors_total", "counter",
                 "Grant rounds lost to API errors/conflicts", orch.api_errors),
            ]
            if summary:
                rows.extend([
                    ("budget_pools", "gauge",
                     "Resolved maxUnavailablePools of the active rollout", budget),
                    ("pools_granted", "gauge",
                     "Pools currently granted (disruption charged)", granted),
                    ("pools_done", "gauge", "Pools reported done by their shard owners", done),
                    ("pools_pending", "gauge", "Pools still waiting for a grant",
                     int(summary.get("pending", 0) or 0)),
                    ("budget_headroom", "gauge",
                     "Grant slots available to the next round (budget - (granted - done))",
                     max(0, budget - max(0, granted - done))),
                ])
            out.append(render_rows(_PREFIX, "", rows))
        with self._lock:
            workers = list(self._workers)
        if workers:
            def worker_label(worker) -> str:
                return prom_label("worker", str(getattr(worker.config, "identity", "")))

            lease_stats = [(w, w.lease_stats()) for w in workers]
            out.append(render_samples(_PREFIX, [
                ("worker_owned_shards", "gauge", "Shards currently leased per worker",
                 [(worker_label(w), len(w.owned_shards())) for w in workers]),
                ("worker_passes_total", "counter", "Reconcile passes per worker",
                 [(worker_label(w), w.passes) for w in workers]),
                ("lease_acquisitions_total", "counter",
                 "Lifetime shard-lease acquisitions per worker",
                 [(worker_label(w), s["acquisitions"]) for w, s in lease_stats]),
                ("lease_failovers_total", "counter",
                 "Acquisitions of NON-preferred shards (stolen from a "
                 "stale owner) per worker — alert on sustained growth",
                 [(worker_label(w), s["failover_acquisitions"]) for w, s in lease_stats]),
                ("lease_losses_total", "counter",
                 "Held leases lost past the renew deadline per worker",
                 [(worker_label(w), s["losses"]) for w, s in lease_stats]),
                ("shard_passes_total", "counter",
                 "Reconcile passes per shard (under whichever worker "
                 "held its lease) — a flatline under a held lease is a "
                 "wedged worker",
                 [
                     (merge_label(worker_label(w), "shard", shard), count)
                     for w in workers
                     for shard, count in sorted(w.shard_passes.items())
                 ]),
            ]))
        return "".join(out)
