"""Continuous health monitoring of a GPU node: the node-problem-detector
shape.

The upgrade flow probes the cards only when it validates a node; a link
that degrades between upgrades goes unnoticed until workloads fail. The
monitor runs the health battery periodically and publishes the verdict
where schedulers and operators already look:

* a **Node condition** ``TpuIciHealthy`` (True/False, a reason, the
  battery's summary as message), debounced by ``failure_threshold``
  consecutive failures and ``success_threshold`` consecutive passes;
* an **Event** on every transition;
* with a :class:`ReportPublisher`, a **NodeHealthReport** of every battery
  (``api/telemetry_v1alpha1.py``), which the planner's degraded-first
  order reads.

A node carrying the upgrade skip label is not probed, and neither is a
node where a live pod holds ``nvidia.com/gpu``: a probe raced against a
workload fails on contention, which reads as a dead link. The condition
type and reason strings are the JAX package's, the contract the planner
keys on.

As a DaemonSet payload, ``python -m k8s_operator_libs_tpu_torch.tpu.monitor``
with ``NODE_NAME`` from the downward API covers the node it runs on. By
default each cycle runs the battery in a child process
(``SubprocessHealthGate``), so the monitor holds no card between cycles;
``--in-process`` forms the gate's world in the monitor's own process.
``--quick-only`` runs the cheap quick battery and publishes reports only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Mapping, Optional

from ..api.telemetry_v1alpha1 import (
    DEFAULT_HEALTHY_LINK_GBYTES_PER_S,
    DEFAULT_HEALTHY_RING_GBYTES_PER_S,
    DEFAULT_HISTORY_WINDOW,
    DEFAULT_LATENCY_BUDGET_S,
    DEFAULT_LINK_LATENCY_BUDGET_S,
    LINK_OK,
    NODE_HEALTH_REPORT_KIND,
    make_node_health_report,
    node_health_report_name,
    parse_node_health,
    raw_link_entries,
    report_history,
)
from ..kube.client import (
    AlreadyExistsError,
    ConflictError,
    get_or_none,
    has_reason,
    retry_on_conflict,
)
from ..kube.objects import Node, Pod, condition_status, set_condition, wrap
from ..upgrade.consts import TRUE_STRING, DeviceClass, UpgradeKeys
from ..utils.log import get_logger
from .health import HealthGate, HealthReport, IciHealthGate
from .libtpu import TPU_RESOURCE

log = get_logger("tpu.monitor")

#: Probes the metrics keep, so a scrape between cycles still sees the
#: degradation that flipped the condition.
METRIC_WINDOW = 8

#: The Node condition the monitor owns.
ICI_HEALTHY_CONDITION = "TpuIciHealthy"

REASON_PASSED = "ProbePassed"
REASON_FAILED = "ProbeFailed"


class MonitorMetrics:
    """Prometheus counters and gauges of the monitor, served by
    ``upgrade.metrics.MetricsServer``. The monitor passes its state into
    :meth:`record`, and every value is written under one lock, so a scrape
    sees one consistent snapshot."""

    _PREFIX = "tpu_monitor"

    def __init__(self, node_name: str) -> None:
        self._node = node_name
        self._lock = threading.Lock()
        self._probes_total = 0
        self._skipped_total = 0
        self._failures_total = 0
        self._errors_total = 0
        self._last_elapsed_s = 0.0
        self._last_ok: Optional[bool] = None
        self._consecutive_failures = 0
        self._published: Optional[bool] = None
        self._ring_window: deque = deque(maxlen=METRIC_WINDOW)
        self._elapsed_window: deque = deque(maxlen=METRIC_WINDOW)

    def record(
        self,
        report: Optional[HealthReport],
        consecutive_failures: int = 0,
        published: Optional[bool] = None,
    ) -> None:
        with self._lock:
            self._consecutive_failures = consecutive_failures
            self._published = published
            if report is None:
                self._skipped_total += 1
                return
            self._probes_total += 1
            self._last_elapsed_s = report.elapsed_s
            self._elapsed_window.append(report.elapsed_s)
            ring = report.ring_bandwidth()
            if ring is not None:
                self._ring_window.append(ring)
            self._last_ok = report.ok
            if not report.ok:
                self._failures_total += 1

    def record_error(self) -> None:
        """A cycle that raised: counted, so an error loop does not read as
        a run of the last good value."""
        with self._lock:
            self._errors_total += 1

    def render(self) -> str:
        from ..upgrade.metrics import prom_label, render_rows

        label = prom_label("node", self._node)
        with self._lock:
            rows = [
                ("probes_total", "counter", "Probe batteries run", self._probes_total),
                ("probes_skipped_total", "counter",
                 "Cycles skipped (skip label, busy cards, missing node)",
                 self._skipped_total),
                ("probe_failures_total", "counter",
                 "Probe batteries that failed", self._failures_total),
                ("cycle_errors_total", "counter",
                 "Probe cycles that raised (no verdict produced)",
                 self._errors_total),
                ("last_probe_duration_seconds", "gauge",
                 "Wall-clock of the most recent battery",
                 round(self._last_elapsed_s, 3)),
                ("consecutive_failures", "gauge",
                 "Failing batteries since the last pass (debounce)",
                 self._consecutive_failures),
            ]
            if self._elapsed_window:
                rows.append(
                    ("probe_duration_window_max_seconds", "gauge",
                     f"Slowest battery in the last {METRIC_WINDOW} probes",
                     round(max(self._elapsed_window), 3))
                )
            if self._ring_window:
                rows.extend([
                    ("ring_gbytes_per_s", "gauge",
                     "Ring bandwidth measured by the most recent battery",
                     round(self._ring_window[-1], 3)),
                    ("ring_window_min_gbytes_per_s", "gauge",
                     f"Worst ring bandwidth in the last {METRIC_WINDOW} probes",
                     round(min(self._ring_window), 3)),
                ])
            if self._last_ok is not None:
                rows.append(
                    ("last_probe_ok", "gauge",
                     "1 when the most recent battery passed", int(self._last_ok))
                )
            if self._published is not None:
                rows.append(
                    ("published_healthy", "gauge",
                     "Last TpuIciHealthy verdict published (1=True)",
                     int(self._published))
                )
        return render_rows(self._PREFIX, label, rows)


def tpu_chips_busy(client, node_name: str, keys: UpgradeKeys) -> bool:
    """Whether a live pod on the node requests or limits ``nvidia.com/gpu``.
    Pods with the drain-skip label do not count: the way out for helper
    pods that hold a card briefly. Every probe tier asks this first."""
    for obj in client.list("Pod", field_selector=f"spec.nodeName={node_name}"):
        pod = Pod(obj.raw)
        if pod.is_finished() or pod.deletion_timestamp is not None:
            continue
        if pod.labels.get(keys.skip_drain_pod_label) == TRUE_STRING:
            continue
        for container in pod.spec.get("containers") or []:
            resources = container.get("resources") or {}
            if TPU_RESOURCE in (resources.get("requests") or {}) or TPU_RESOURCE in (
                resources.get("limits") or {}
            ):
                return True
    return False


def make_quick_probe_guard(client, node_name: str, keys: Optional[UpgradeKeys] = None):
    """The quick tier's skip check, the full monitor's discipline: ``None``
    to probe, or why not (the skip label, cards held by workloads)."""
    keys = keys or UpgradeKeys(DeviceClass.nvidia("gpu"))

    def guard() -> Optional[str]:
        node_obj = get_or_none(client, "Node", node_name)
        if node_obj is not None:
            if Node(node_obj.raw).labels.get(keys.skip_label) == TRUE_STRING:
                return "skip label set"
        if tpu_chips_busy(client, node_name, keys):
            return "GPUs in use by workloads"
        return None

    return guard


class ReportPublisher:
    """Publishes batteries as the node's ``NodeHealthReport``.

    * read-modify-write carrying the live report's resourceVersion, retried
      on a conflict (the quick tier may write the same report);
    * debounced: an observation with the same failing checks, a score
      within ``min_score_delta`` and the same non-ok links is not written
      while the last one is younger than ``heartbeat_seconds``; a link
      that turns sick or recovers is written at once;
    * windowed: the report carries a bounded history and bounded link
      windows, so its trend survives a publisher's restart.
    """

    def __init__(
        self,
        client,
        node_name: str,
        source: str = "monitor",
        min_score_delta: float = 1.0,
        heartbeat_seconds: float = 900.0,
        history_window: int = DEFAULT_HISTORY_WINDOW,
        healthy_ring_gbytes_per_s: float = DEFAULT_HEALTHY_RING_GBYTES_PER_S,
        latency_budget_s: float = DEFAULT_LATENCY_BUDGET_S,
        healthy_link_gbytes_per_s: float = DEFAULT_HEALTHY_LINK_GBYTES_PER_S,
        link_latency_budget_s: float = DEFAULT_LINK_LATENCY_BUDGET_S,
        now=time.time,
    ) -> None:
        self._client = client
        self._node = node_name
        self._source = source
        self._min_score_delta = min_score_delta
        self._heartbeat = heartbeat_seconds
        self._window = history_window
        self._healthy_ring = healthy_ring_gbytes_per_s
        self._latency_budget = latency_budget_s
        self._healthy_link = healthy_link_gbytes_per_s
        self._link_latency_budget = link_latency_budget_s
        self._now = now

    @staticmethod
    def _sick_links(entries: Optional[Mapping]) -> frozenset:
        """(peer, verdict) of the links not ok: the link half of the
        debounce key (the full map would defeat it on timing jitter)."""
        out = set()
        for peer, entry in (entries or {}).items():
            verdict = (
                entry.get("verdict")
                if isinstance(entry, Mapping)
                else getattr(entry, "verdict", LINK_OK)
            )
            if verdict != LINK_OK:
                out.add((str(peer), str(verdict)))
        return frozenset(out)

    def publish(
        self,
        checks: Mapping[str, bool],
        metrics: Mapping[str, float],
        links: Optional[Mapping[str, Mapping]] = None,
    ) -> bool:
        """Create or update the node's report from one observation; whether
        a write happened (``False``: debounced). ``links`` (peer -> {ok,
        latency_s, gbytes_per_s}) replaces the report's link map, an empty
        map included; ``None`` means no link tier ran, and the live map is
        carried forward as it is."""
        observed_at = float(self._now())
        name = node_health_report_name(self._node)

        def attempt() -> bool:
            existing = get_or_none(self._client, NODE_HEALTH_REPORT_KIND, name)
            history = report_history(existing.raw) if existing is not None else []
            previous = parse_node_health(existing.raw) if existing is not None else None
            desired = make_node_health_report(
                self._node,
                checks,
                metrics,
                source=self._source,
                observed_at=observed_at,
                history=history,
                history_window=self._window,
                healthy_ring_gbytes_per_s=self._healthy_ring,
                latency_budget_s=self._latency_budget,
                links=links,
                prior_links=previous.links if previous is not None else None,
                healthy_link_gbytes_per_s=self._healthy_link,
                link_latency_budget_s=self._link_latency_budget,
            )
            if links is None and previous is not None and previous.links:
                desired["status"]["links"] = raw_link_entries(previous.links)
            if existing is not None:
                failing = {k for k, v in desired["status"]["checks"].items() if not v}
                if (
                    previous is not None
                    and {k for k, v in previous.checks.items() if not v} == failing
                    and abs(previous.score - desired["status"]["score"])
                    < self._min_score_delta
                    and self._sick_links(previous.links)
                    == self._sick_links(desired["status"].get("links"))
                    and observed_at - previous.observed_at < self._heartbeat
                ):
                    return False
                rv = (existing.raw.get("metadata") or {}).get("resourceVersion")
                if rv is not None:
                    desired["metadata"]["resourceVersion"] = rv
                # The observation is status, which the main resource's
                # update ignores: the status write is the one that counts.
                self._client.update_status(wrap(desired))
                return True
            try:
                created = self._client.create(wrap(desired))
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if not has_reason(e, AlreadyExistsError):
                    raise
                # Lost a create race: read again and take the update path.
                raise ConflictError(str(e)) from e
            # A server with a status subresource drops status on create.
            rv = (created.raw.get("metadata") or {}).get("resourceVersion")
            if rv is not None:
                desired["metadata"]["resourceVersion"] = rv
            self._client.update_status(wrap(desired))
            return True

        wrote = retry_on_conflict(attempt)
        if wrote:
            log.info("published NodeHealthReport for %s", self._node)
        return bool(wrote)

    def publish_report(self, report: HealthReport) -> bool:
        """Publish a full battery; its link map rides along when it has one."""
        checks, metrics = report.observation()
        links = report.links_observation()
        return self.publish(checks, metrics, links=links or None)


class TpuHealthMonitor:
    """Runs the gate on one node and publishes its verdict (module doc)."""

    def __init__(
        self,
        client,
        node_name: str,
        gate: Optional[HealthGate] = None,
        interval_seconds: float = 300.0,
        failure_threshold: int = 3,
        success_threshold: int = 2,
        device: Optional[DeviceClass] = None,
        recorder=None,
        metrics: Optional[MonitorMetrics] = None,
        report_publisher: Optional[ReportPublisher] = None,
    ) -> None:
        self.client = client
        self.node_name = node_name
        self.gate = gate or IciHealthGate.tpu_defaults()
        self.interval_seconds = interval_seconds
        #: ``failure_threshold`` failing batteries in a row flip the
        #: condition False, ``success_threshold`` passes flip it back: a
        #: marginal link that sometimes passes must not flap it.
        self.failure_threshold = failure_threshold
        self.success_threshold = success_threshold
        self.keys = UpgradeKeys(device or DeviceClass.nvidia("gpu"))
        self.recorder = recorder
        self.metrics = metrics
        self.report_publisher = report_publisher
        self._consecutive_failures = 0
        self._consecutive_passes = 0
        #: The last verdict this monitor published (``None`` before one).
        self._last_published: Optional[bool] = None
        self._stop = threading.Event()

    def check_once(self) -> Optional[HealthReport]:
        """One cycle: the battery and its verdict published. ``None`` when
        the cycle was skipped (skip label, missing node, busy cards)."""
        try:
            report = self._check_once()
        except Exception:
            if self.metrics is not None:
                self.metrics.record_error()
            raise
        if self.metrics is not None:
            self.metrics.record(
                report,
                consecutive_failures=self._consecutive_failures,
                published=self._last_published,
            )
        return report

    def _check_once(self) -> Optional[HealthReport]:
        node_obj = get_or_none(self.client, "Node", self.node_name)
        if node_obj is None:
            log.warning("monitored node %s not found", self.node_name)
            return None
        node = Node(node_obj.raw)
        if node.labels.get(self.keys.skip_label) == TRUE_STRING:
            log.info("node %s has the skip label; not probing", self.node_name)
            return None
        if self._last_published is None:
            # A restarted monitor starts from the published condition: one
            # lucky pass must not clear what took failure_threshold to earn.
            existing = condition_status(node.status, ICI_HEALTHY_CONDITION)
            if existing is not None:
                self._last_published = existing == "True"
        if tpu_chips_busy(self.client, self.node_name, self.keys):
            log.info("node %s: GPUs in use by workloads; skipping probe", self.node_name)
            return None

        report = self.gate.run()
        if report.ok:
            self._consecutive_failures = 0
            self._consecutive_passes += 1
            if (
                self._last_published in (None, True)
                or self._consecutive_passes >= self.success_threshold
            ):
                self._publish(healthy=True, report=report)
        else:
            self._consecutive_passes = 0
            self._consecutive_failures += 1
            log.warning(
                "node %s failed probe %d/%d: %s",
                self.node_name, self._consecutive_failures,
                self.failure_threshold, "; ".join(report.failures),
            )
            if self._consecutive_failures >= self.failure_threshold:
                self._publish(healthy=False, report=report)
        if self.report_publisher is not None:
            # After the condition: a failed report write fails the cycle,
            # but not before the condition has flipped.
            self.report_publisher.publish_report(report)
        return report

    def _publish(self, healthy: bool, report: HealthReport) -> None:
        """Write the condition where it changes (read-modify-write under
        optimistic locking) and an Event on a transition. The steady state
        writes nothing, so ``lastTransitionTime`` keeps its meaning."""
        self._last_published = healthy
        changed = False

        def attempt():
            nonlocal changed
            node = Node(self.client.get("Node", self.node_name).raw)
            desired = "True" if healthy else "False"
            changed = condition_status(node.status, ICI_HEALTHY_CONDITION) != desired
            if changed:
                set_condition(
                    node.status, ICI_HEALTHY_CONDITION, desired,
                    reason=REASON_PASSED if healthy else REASON_FAILED,
                    message=report.summary(),
                )
                self.client.update_status(node)
            return node

        node = retry_on_conflict(attempt)
        if changed and self.recorder is not None:
            self.recorder.eventf(
                node,
                "Normal" if healthy else "Warning",
                self.keys.event_reason(),
                "ICI health condition %s: %s",
                "True" if healthy else "False",
                report.summary(),
            )

    def run_forever(self) -> None:
        while not self._stop.is_set():
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 - the monitor outlives blips
                log.exception("health probe cycle failed")
            self._stop.wait(self.interval_seconds)

    def stop(self) -> None:
        self._stop.set()


def run_quick_probe_loop(
    publisher,
    interval_seconds: float = 60.0,
    once: bool = False,
    battery=None,
    stop_event: Optional[threading.Event] = None,
    skip_cycle=None,
    device=None,
) -> int:
    """The quick tier's loop: one ``run_quick_probe_cycle`` a tick, a cycle
    that raises logged and the cadence kept. ``skip_cycle``
    (:func:`make_quick_probe_guard`) is asked first; a skipped cycle is not
    a failure. ``once`` runs one cycle and returns its verdict as an exit
    code. Without ``battery`` the loop forms a world of ``device``'s
    devices (default every card) at its first cycle, runs the quick
    battery over it, forms it again after a failure and closes it when the
    loop ends."""
    from ..ops.probe_harness import quick_battery, run_quick_probe_cycle
    from ..parallel.mesh import World, available_devices

    stop = stop_event if stop_event is not None else threading.Event()
    world: Optional[World] = None

    def own_battery():
        nonlocal world
        if world is not None and world.error is not None:
            world = None
        if world is None:
            world = World(available_devices(device))
        return quick_battery(world)

    try:
        while True:
            ok = False
            try:
                reason = skip_cycle() if skip_cycle is not None else None
                if reason is not None:
                    log.info("quick-probe cycle skipped: %s", reason)
                    ok = True
                else:
                    ok = run_quick_probe_cycle(publisher, battery or own_battery).ok
            except Exception:  # noqa: BLE001 - the loop outlives blips
                log.exception("quick-probe cycle failed")
            if once:
                return 0 if ok else 1
            if stop.wait(interval_seconds):
                return 0
    finally:
        if world is not None:
            world.close()


def build_parser():
    """The monitor's flags: the JAX monitor's, plus ``--device``."""
    import argparse
    import os

    parser = argparse.ArgumentParser(
        prog="k8s_operator_libs_tpu_torch.tpu.monitor",
        description="continuous GPU health monitor",
    )
    parser.add_argument(
        "--node-name", default=os.environ.get("NODE_NAME", ""),
        help="node whose condition to manage (default: $NODE_NAME)",
    )
    parser.add_argument("--interval-seconds", type=float, default=300.0)
    parser.add_argument("--failure-threshold", type=int, default=3)
    parser.add_argument("--once", action="store_true", help="one probe cycle, then exit")
    parser.add_argument(
        "--in-process", action="store_true",
        help="run the battery inside this process instead of a per-cycle "
        "subprocess (the monitor then holds its world of cards between "
        "cycles: only where nothing else needs them)",
    )
    parser.add_argument(
        "--probe-timeout-seconds", type=float, default=600.0,
        help="deadline for one subprocess probe cycle",
    )
    parser.add_argument(
        "--gate-preset", choices=("tpu", "portable"), default="tpu",
        help="probe configuration: 'tpu' = IciHealthGate.tpu_defaults() (both "
        "CUDA kernels and the flash probe, floors 0); 'portable' = no "
        "floors, no kernels, runs on any device",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device the battery runs on (default cuda; cpu runs the plain versions)",
    )
    parser.add_argument(
        "--min-ring-gbps", type=float, default=None,
        help="override the preset's ring-bandwidth floor (GB/s)",
    )
    parser.add_argument(
        "--min-mxu-tflops", type=float, default=None,
        help="override the preset's matmul throughput floor (TFLOP/s)",
    )
    parser.add_argument(
        "--publish-reports", action="store_true",
        help="publish each battery as a NodeHealthReport next to the condition",
    )
    parser.add_argument(
        "--quick-only", action="store_true",
        help="the quick-probe tier: only the cheap quick battery (a small "
        "all-reduce, each ring hop, a small plain matmul) on its own cadence, "
        "publishing NodeHealthReports; no full gate, no condition writes. "
        "Implies --publish-reports.",
    )
    parser.add_argument(
        "--quick-interval-seconds", type=float, default=60.0,
        help="quick-probe cadence under --quick-only",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="serve Prometheus probe metrics on this port (0 = off)",
    )
    parser.add_argument(
        "--metrics-host", default="0.0.0.0",
        help="metrics bind address (a DaemonSet pod needs a scrapeable one)",
    )
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    """DaemonSet payload: ``python -m k8s_operator_libs_tpu_torch.tpu.monitor``."""
    import logging

    from ..kube.events import EventRecorder
    from ..kube.rest import RestClient
    from .health import SubprocessHealthGate

    parser = build_parser()
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s %(message)s")
    args = parser.parse_args(argv)
    if not args.node_name:
        parser.error("--node-name or $NODE_NAME is required")
    if args.quick_only:
        if args.metrics_port:
            parser.error(
                "--metrics-port is not supported with --quick-only "
                "(the quick tier's telemetry is the NodeHealthReport)"
            )
        client = RestClient.from_environment()
        return run_quick_probe_loop(
            ReportPublisher(client, args.node_name, source="quick-probe"),
            interval_seconds=args.quick_interval_seconds,
            once=args.once,
            skip_cycle=make_quick_probe_guard(client, args.node_name),
            device=args.device,
        )
    failure_threshold, success_threshold = args.failure_threshold, 2
    if args.once and failure_threshold != 1:
        # The counters live in the process: a --once process only ever
        # reaches 1, so a higher threshold could never flip the condition.
        log.info("--once: failure/success thresholds set to 1")
        failure_threshold = success_threshold = 1

    overrides: dict = {}
    if args.min_ring_gbps is not None:
        overrides["min_ring_gbytes_per_s"] = args.min_ring_gbps
    if args.min_mxu_tflops is not None:
        overrides["min_mxu_tflops"] = args.min_mxu_tflops
    if args.gate_preset == "tpu":
        probe_gate = IciHealthGate.tpu_defaults(device=args.device, **overrides)
    else:
        probe_gate = IciHealthGate(
            run_seq_parallel_probes=True, device=args.device, **overrides
        )
    if args.in_process:
        gate = probe_gate
    else:
        gate = SubprocessHealthGate(
            cli_args=probe_gate.to_cli_args() + ["--device", args.device],
            timeout_seconds=args.probe_timeout_seconds,
        )
    client = RestClient.from_environment()
    metrics = MonitorMetrics(args.node_name)
    publisher = (
        # The latency budget scales with the probe deadline: a full battery
        # takes far longer than a quick one, and each tier is graded on
        # its own cadence.
        ReportPublisher(
            client,
            args.node_name,
            latency_budget_s=max(DEFAULT_LATENCY_BUDGET_S, args.probe_timeout_seconds / 4.0),
        )
        if args.publish_reports
        else None
    )
    monitor = TpuHealthMonitor(
        client,
        args.node_name,
        gate=gate,
        interval_seconds=args.interval_seconds,
        failure_threshold=failure_threshold,
        success_threshold=success_threshold,
        recorder=EventRecorder(client),
        metrics=metrics,
        report_publisher=publisher,
    )
    metrics_server = None
    if args.metrics_port:
        from ..upgrade.metrics import MetricsServer

        metrics_server = MetricsServer(
            metrics, port=args.metrics_port, host=args.metrics_host
        ).start()
    try:
        if args.once:
            report = monitor.check_once()
            return 0 if report is None or report.ok else 1
        monitor.run_forever()
        return 0
    finally:
        if metrics_server is not None:
            metrics_server.stop()
        if args.in_process:
            probe_gate.close()


if __name__ == "__main__":
    raise SystemExit(main())
