"""upgrade-controller: a reconcile-loop process over the port's upgrade
state machine.

    python -m k8s_operator_libs_tpu_torch.upgrade_controller [--watch] ...

The upgrade library is consumed by operators that call ``build_state`` and
``apply_state`` from their controller's ``Reconcile``. This command is that
consumer as a process of its own, for a pool of NVIDIA GPU nodes: every
interval (or, with ``--watch``, on every batch of watch events) it runs one
idempotent pass of the state machine over the cluster its kubeconfig (or
in-cluster service account) names and prints the nodes by state.

It is the ``main``, ``_reconcile_loop`` and ``_reconcile_passes`` of the
JAX package's example command ``examples/upgrade_controller.py``, over the
port; there is no module at this path in the JAX package. Every background
component (informers, workqueue, metrics endpoint, lease elector) is
adopted by a :class:`~.runtime.Supervisor`: SIGTERM or SIGINT prints
``shutdown requested; draining``, drains them consumers first and exits 0,
releasing a held Lease at once, so a standby takes over without waiting
out the lease. The manager's background tasks (a drain, an eviction wait)
write node state after the pass that started them: the shutdown waits
for them while the Lease is still held, and hands the Lease over only if
they all ended; otherwise it leaves the Lease to expire and the process
exits at once, ending them, so no write lands after another replica
leads. A leader that loses its Lease exits 3 without waiting for them.
Unlike the JAX
command, a wait for the next batch of events or the next interval looks
at the stop event and the Lease every ``WAKE_S`` seconds: a watch-driven
controller with a long interval still stops promptly.

``--shards N --shard-index i`` makes the process one of N cooperating
fleet workers (``fleet/worker.py``): it campaigns for a Lease a shard
(``fleet-shard-NN``), prefers shard ``i``, and reconciles only the nodes
whose pool hashes to the shards it holds; ``--pool-prefix-sep SEP`` maps a
node to its pool by what precedes the last ``SEP`` of its name (none: the
node is its pool). With ``--fleet-rollout NAME`` the worker starts a
pool's nodes only while the FleetRollout ``NAME`` grants the pool, and
reports it done there; ``--orchestrate`` also runs the grant issuer
(``runtime/daemon.py``) behind the ``fleet-orchestrator`` Lease. A worker
ticks at least every Lease retry period, since its ticks renew its shard
Leases. Its shard Leases, like the controller's Lease, are released on
the way out only after the manager's background tasks ended, and the
orchestrator's only after its tick thread did; otherwise they are left to
expire.

``--device`` is ``nvidia`` (``DeviceClass.nvidia("gpu")``: the default
Lease is ``upgrade-controller-nvidia``, the default selector the port's
driver DaemonSet's, ``tpu/libtpu.py``). ``--watch-relay URL`` routes every
watch of the process's informers through a ``kube/relay.py`` ``WatchRelay``
at URL (a ``RelayWatchSource``, adopted as ``relay-source``): the worker
processes of one host then share one upstream watch a kind, and a dead
relay degrades the process to direct watches for a bounded window, then
the relay is tried again; lists and writes stay on the API server.

``--demo`` needs no cluster: the process rolls a driver update over the
port's in-memory cluster (``kube/fake.py``), four Ready GPU nodes of one
NVLink domain (one ``nvidia.com/gpu.clique``) whose ``gpu-installer``
DaemonSet (``kube/sim.py``'s ``DaemonSetSimulator``) moves from one
driver revision to the next. Each uncordon is gated by the in-process
health gate of ``--ici-gate``, run on ``--gate-device`` (the card by
default; ``cpu`` only when asked for: without a card the gate raises and
the node stays in validation); ``--validation-pod`` has the probe pods
run by ``ValidationPodSimulator`` instead, and ``--requestor`` has
``MaintenanceOperatorSimulator`` play the maintenance operator. The
manager's tasks run inline, each gate verdict is printed (``demo gate:
...``), and the process exits 0 with ``demo: rolling upgrade complete in
N passes``, or 1 when the roll has not converged within the pass cap.
``--watch`` and ``--watch-relay`` do not apply to the demo.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
import threading
import time

from .api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from .runtime import FuncComponent, Supervisor
from .upgrade import ClusterUpgradeStateManager, DeviceClass, TaskRunner, UpgradeState

#: The workqueue key of triggers that cannot be scoped to one node (a
#: DaemonSet or ControllerRevision delta, the periodic resync, a
#: NodeMaintenance object naming no node).
RESYNC_KEY = "__resync__"

#: The NVIDIA driver DaemonSet's labels (``tpu/libtpu.py``: ``app`` is
#: ``<driver>-installer``).
DEFAULT_SELECTOR = "app=gpu-installer"

#: The longest the loop waits without looking at the stop event and the
#: Lease: a wait for the next batch or the interval is cut into such
#: slices, so SIGTERM or a lost Lease is seen within it, not an interval
#: later.
WAKE_S = 0.5

#: Each supervised component's stop budget, the wait for the manager's
#: background tasks included.
COMPONENT_TIMEOUT_S = 10.0

#: The demo's pool: its nodes, the NVLink domain they share, and the
#: driver revisions it rolls between.
DEMO_POOL = "h100-pool"
DEMO_NODES = 4
DEMO_CLIQUE = "demo-nvl-domain.1"
DEMO_DRIVER_HASHES = ("nvidia-driver-550", "nvidia-driver-560")

#: The pass cap of a demo roll: four nodes converge in under 40 passes,
#: and the fleet demo spends passes between grant waves.
MAX_DEMO_PASSES = 100
MAX_FLEET_DEMO_PASSES = 300


def parse_selector(raw: str) -> dict[str, str]:
    labels = {}
    for part in filter(None, raw.split(",")):
        key, _, value = part.partition("=")
        labels[key.strip()] = value.strip()
    return labels


def load_policy(path: str | None) -> DriverUpgradePolicySpec:
    """The policy document at ``path`` (YAML, which needs PyYAML, or
    JSON); automatic upgrades with the defaults when there is none."""
    if path is None:
        return DriverUpgradePolicySpec(auto_upgrade=True)
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        doc = yaml.safe_load(text)
    return DriverUpgradePolicySpec.from_dict(doc or {})


def state_counts(state) -> str:
    parts = [
        f"{name or 'unknown'}={len(nodes)}" for name, nodes in sorted(state.node_states.items())
    ]
    return " ".join(parts) if parts else "(no managed nodes)"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="upgrade-controller", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", choices=["nvidia"], default="nvidia")
    parser.add_argument("--namespace", default="kube-system")
    parser.add_argument("--selector", default=DEFAULT_SELECTOR,
                        help="driver DaemonSet labels, k=v[,k=v...]")
    parser.add_argument("--policy", default=None,
                        help="YAML or JSON file with a DriverUpgradePolicySpec")
    parser.add_argument("--interval", type=float, default=30.0)
    parser.add_argument(
        "--watch", action="store_true",
        help="reconcile on watch events (informers over Nodes, driver Pods, "
        "DaemonSets, ControllerRevisions and, with --requestor, "
        "NodeMaintenance objects) instead of a fixed interval; the interval "
        "becomes the resync fallback. Events feed a rate-limited workqueue "
        "keyed by node, and the snapshot source keeps the cluster state "
        "incrementally",
    )
    parser.add_argument(
        "--verify-every-n", type=int, default=0,
        help="with --watch: every n-th reconcile audits the incremental state "
        "against a full rebuild, repairing and counting divergences (0: off)",
    )
    parser.add_argument("--once", action="store_true", help="one reconcile pass, then exit")
    parser.add_argument("--slice-aware", action="store_true",
                        help="plan a whole NVLink domain per disruption window")
    parser.add_argument("--ici-gate", action="store_true",
                        help="gate uncordon on the health gate run in this process "
                        "on its card (no CPU fallback)")
    parser.add_argument("--validation-pod", action="store_true",
                        help="validate through probe pods on each node")
    parser.add_argument("--requestor", action="store_true",
                        help="delegate cordon and drain to a maintenance operator "
                        "over NodeMaintenance objects")
    parser.add_argument("--post-maintenance", action="store_true",
                        help="with --requestor: route Ready nodes through "
                        "post-maintenance-required and count maintenance states "
                        "in the upgrade budget")
    parser.add_argument("--metrics-port", type=int, default=0,
                        help="serve Prometheus metrics on this port (0: off)")
    parser.add_argument("--metrics-host", default="0.0.0.0", help="metrics bind address")
    parser.add_argument("--leader-elect", action="store_true",
                        help="campaign for a coordination.k8s.io Lease before "
                        "reconciling; losing it is fatal (exit 3)")
    parser.add_argument("--leader-elect-id", default="",
                        help="holder identity (default: <hostname>_<pid>)")
    parser.add_argument("--leader-elect-lease", default="",
                        help="Lease name (default: upgrade-controller-<device>)")
    parser.add_argument("--trace-export", default="", metavar="PATH",
                        help="trace the process's lifetime and export the spans "
                        "as JSONL to PATH on exit (python -m "
                        "k8s_operator_libs_tpu_torch.tools.trace_view PATH)")
    parser.add_argument("--stats-json", default="", metavar="PATH",
                        help="write the passes, the wall seconds and the transport's "
                        "(and the relay source's) counters as JSON to PATH on exit")
    parser.add_argument("--watch-relay", default="", metavar="URL",
                        help="route the informers' watches through the WatchRelay at URL: "
                        "the processes of one host share one upstream watch a kind; a "
                        "dead relay degrades to direct watches for a bounded window")
    parser.add_argument("--shards", type=int, default=0,
                        help="fleet mode: the fleet's shard count; campaign for a Lease a "
                        "shard and reconcile only the nodes of the shards held (0: off)")
    parser.add_argument("--shard-index", type=int, default=0,
                        help="with --shards: this worker's preferred shard; the others "
                        "are probed at the failover cadence only")
    parser.add_argument("--fleet-rollout", default="", metavar="NAME",
                        help="with --shards: the FleetRollout whose grants gate each "
                        "pool's start and which each pool is reported done in")
    parser.add_argument("--pool-prefix-sep", default="", metavar="SEP",
                        help="with --shards: a node's pool is its name up to the last "
                        "SEP (written --pool-prefix-sep=-); none: the node is its pool")
    parser.add_argument("--orchestrate", action="store_true",
                        help="also issue the FleetRollout's grants under its global "
                        "budget, behind the 'fleet-orchestrator' Lease; needs "
                        "--fleet-rollout")
    parser.add_argument("--demo", action="store_true",
                        help="roll a driver update over an in-memory pool of four GPU "
                        "nodes, no cluster needed")
    parser.add_argument("--gate-device", default="cuda", metavar="DEVICE",
                        help="the device of the in-process health gate (--ici-gate, and "
                        "the demo's): 'cuda' (every visible card) or 'cpu'")
    return parser


def build_demo(args):
    """The in-memory pool of ``--demo``: four Ready GPU nodes with the GFD
    labels of one NVLink domain, the driver DaemonSet settled at one
    revision and then bumped to the next, and, with ``--fleet-rollout``,
    the FleetRollout its grants come from. Returns the cluster and the
    DaemonSet's simulator."""
    from .kube.fake import FakeCluster
    from .kube.objects import Node
    from .kube.sim import DaemonSetSimulator
    from .parallel.topology import (
        GPU_CLIQUE_LABEL,
        GPU_COUNT_LABEL,
        GPU_MEMORY_LABEL,
        GPU_PRESENT_LABEL,
        GPU_PRODUCT_LABEL,
    )

    cluster = FakeCluster()
    node_names = []
    for i in range(DEMO_NODES):
        node = Node.new(
            f"{DEMO_POOL}-{i}",
            labels={
                GPU_PRESENT_LABEL: "true",
                GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
                GPU_COUNT_LABEL: "8",
                GPU_MEMORY_LABEL: "81559",
                GPU_CLIQUE_LABEL: DEMO_CLIQUE,
            },
        )
        node.set_ready(True)
        cluster.create(node)
        node_names.append(node.name)
    if args.fleet_rollout:
        # Each node is its own pool (no --pool-prefix-sep); a budget of
        # half the pools makes the grant waves visible.
        from .api.fleet_v1alpha1 import make_fleet_rollout
        from .kube.objects import KubeObject

        cluster.create(KubeObject(make_fleet_rollout(args.fleet_rollout, node_names, "50%")))
    first, second = DEMO_DRIVER_HASHES
    sim = DaemonSetSimulator(cluster, name="gpu-installer", namespace=args.namespace,
                             match_labels=parse_selector(args.selector), initial_hash=first)
    sim.settle()
    sim.set_template_hash(second)  # the update the controller must roll
    return cluster, sim


def _printed_verdicts(hook):
    """The demo's gate hook: the gate's verdict on each node, printed."""

    def verdict(node) -> bool:
        began = time.monotonic()
        ok = hook(node)
        print(f"demo gate: node={node.name} ok={ok} seconds={time.monotonic() - began:.3f}",
              flush=True)
        return ok

    return verdict


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.orchestrate and not args.fleet_rollout:
        parser.error("--orchestrate requires --fleet-rollout")
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    # The Supervisor owns every background component this process starts
    # and drains them in reverse dependency order, each within a budget.
    # SIGTERM and SIGINT only set its event; the loop sees
    # ``stop_requested`` and returns, and the finally below drains.
    sup = Supervisor(drain_timeout_s=30.0, component_timeout_s=COMPONENT_TIMEOUT_S)
    sup.install_signal_handlers()
    elector = None
    queue = None
    worker = None
    orchestrator = None
    tracer = None
    if args.trace_export:
        from .utils import tracing

        tracer = tracing.Tracer()
        tracing.install_tracer(tracer)
    # One try over all acquisition: each component is adopted as it starts,
    # so a signal in the middle of the setup still drains what started.
    try:
        device = DeviceClass.nvidia("gpu")
        policy = load_policy(args.policy)
        selector = parse_selector(args.selector)
        sims = Demo()
        if args.demo:
            client, sims.driver = build_demo(args)
        else:
            try:
                from .kube.rest import RestClient

                client = RestClient.from_environment()
            except Exception as e:  # noqa: BLE001 - RestConfigError when unconfigured
                raise SystemExit(f"no cluster access configured ({e}); use --demo for the "
                                 "in-memory pool")

        relay_source = None
        if args.watch_relay and not args.demo:
            from .kube.relay import RelayWatchSource

            # Every informer below streams through the relay; lists and
            # writes stay direct. The source owns a transport to the
            # relay, so it closes only after the consumers that name it.
            relay_source = RelayWatchSource(args.watch_relay, direct=client)
            sup.adopt(FuncComponent("relay-source", stop=relay_source.close))

        # The holder identity of every Lease this process campaigns for.
        identity = args.leader_elect_id or f"{socket.gethostname()}_{os.getpid()}"
        runner = TaskRunner(inline=args.demo)
        mgr = ClusterUpgradeStateManager(client, device, runner=runner)
        probe_selector = ""
        tasks_ended = threading.Event()

        def stop_tasks() -> None:
            # The tasks drain before the elector, so they finish under the
            # Lease. A deposed leader stops waiting at once: its writes must
            # end with the process, not go on.
            deadline = time.monotonic() + COMPONENT_TIMEOUT_S
            while True:
                if runner.wait_idle(timeout=max(0.0, min(WAKE_S, deadline - time.monotonic()))):
                    runner.shutdown()
                    tasks_ended.set()
                    return
                if time.monotonic() >= deadline or (elector is not None
                                                    and not elector.is_leader()):
                    return

        # The tasks consume the leadership of the Leases they write under,
        # so they drain before those Leases' holders.
        sup.adopt(FuncComponent("task-runner", stop=stop_tasks),
                  depends_on=(["leader-elector"] if args.leader_elect else [])
                  + (["shard-worker"] if args.shards else []))
        if args.validation_pod:
            from .tpu.slice_gate import SliceProbeSpec, make_validation_provisioner
            from .tpu.validation_pod import ValidationPodManager, ValidationPodSpec

            if args.slice_aware:
                # A probe gang for each multi-host NVLink domain, per-node
                # pods for the single-host ones.
                spec = SliceProbeSpec(namespace=args.namespace)
                provisioner = make_validation_provisioner(client, spec)
            else:
                spec = ValidationPodSpec(namespace=args.namespace)
                provisioner = ValidationPodManager(client, spec)
            mgr.with_validation_enabled(pod_provisioner=provisioner)
            probe_selector = spec.pod_selector
            if args.demo:
                # The demo has no kubelet: a simulated one runs the probe pods.
                from .kube.sim import ValidationPodSimulator

                sims.validation_pods = ValidationPodSimulator(client, namespace=args.namespace)
        elif args.ici_gate or args.demo:
            from .tpu.health import IciHealthGate, SliceScopedGate

            # The plain product on purpose, as the JAX command's gate takes
            # XLA's dot: the gate of the probe pods is the one of the kernels.
            gate = IciHealthGate(payload_mb=1.0, matmul_size=1024, run_burnin=True,
                                 device=args.gate_device)
            hook = (
                SliceScopedGate(gate).validation_hook()
                if args.slice_aware
                else gate.validation_hook()
            )
            mgr.with_validation_enabled(
                validation_hook=_printed_verdicts(hook) if args.demo else hook)
        if args.slice_aware:
            from .tpu.planner import enable_slice_aware_planning

            enable_slice_aware_planning(mgr)
        if args.requestor:
            from .upgrade import RequestorOptions, enable_requestor_mode

            opts = RequestorOptions.from_env()
            opts.use_maintenance_operator = True  # the flag is the opt-in
            # The environment's namespace wins over the flag's default.
            if not os.environ.get("MAINTENANCE_OPERATOR_REQUESTOR_NAMESPACE"):
                opts.namespace = args.namespace
            if args.post_maintenance:
                opts.use_post_maintenance = True
                if args.ici_gate and not args.validation_pod and not args.demo:
                    # An in-process warm-up only where the in-process gate
                    # applies (this process owns the node's cards); with
                    # probe pods this process is off the node.
                    from .tpu.health import cache_warmup_hook

                    opts.post_maintenance_hook = cache_warmup_hook()
            enable_requestor_mode(mgr, opts)
            if args.demo:
                from .kube.sim import MaintenanceOperatorSimulator

                sims.maintenance = MaintenanceOperatorSimulator(client, namespace=args.namespace)

        if args.shards:
            # Before the watch wiring: the worker's scoped source is the
            # snapshot source, and its informers are the triggers too.
            worker = _shard_worker(args, client, mgr, selector, identity, relay_source)

        if args.watch and not args.demo:
            queue = _watch(args, client, mgr, selector, sup, probe_selector, worker,
                           relay_source)

        if worker is not None:
            if not worker.source.started:
                worker.start(sync_timeout=30)

            def stop_worker() -> None:
                if tasks_ended.is_set():
                    worker.stop()
                    return
                print("fleet: background tasks outlived the shutdown; leaving the shard "
                      "Leases to expire", file=sys.stderr, flush=True)
                worker.stop(release=False)

            worker_deps = ["nm-informer"] if (args.watch and not args.demo
                                              and args.requestor) else []
            if args.leader_elect:
                worker_deps.append("leader-elector")
            if relay_source is not None:
                worker_deps.append("relay-source")
            sup.adopt(FuncComponent("shard-worker", stop=stop_worker), depends_on=worker_deps)

        if args.orchestrate:
            from .runtime import OrchestratorDaemon

            orchestrator = OrchestratorDaemon(
                client, args.fleet_rollout, namespace=args.namespace, identity=identity,
                # The demo's passes run at full tilt: the grant rounds keep
                # pace on a short interval, not on watch wakeups.
                interval_s=0.1 if args.demo else min(args.interval, 2.0),
                use_wakeups=not args.demo,
            ).start()
            sup.adopt(orchestrator)
            print(f"fleet orchestrator: campaigning as {identity!r}", flush=True)

        metrics = None
        if args.metrics_port:
            from .upgrade import MetricsServer, UpgradeMetrics

            metrics = UpgradeMetrics(mgr)
            metrics_server = MetricsServer(metrics, port=args.metrics_port,
                                           host=args.metrics_host).start()
            print(f"metrics: {metrics_server.url}", flush=True)
            sup.adopt(FuncComponent("metrics", stop=metrics_server.stop))

        if args.leader_elect:
            from .kube.leader import LeaderElectionConfig, LeaderElector

            elector = LeaderElector(
                client,
                LeaderElectionConfig(
                    name=args.leader_elect_lease or f"upgrade-controller-{args.device}",
                    namespace=args.namespace,
                    identity=identity,
                ),
            ).start()

            def stop_elector() -> None:
                if tasks_ended.is_set():
                    elector.stop()
                    return
                print("leader election: background tasks outlived the shutdown; "
                      "leaving the Lease to expire", file=sys.stderr, flush=True)
                elector.stop(release=False)

            # No depends_on: whatever consumes the leadership names this
            # component, so the elector drains last and releases the Lease
            # only after the work it gated has stopped, the tasks included.
            sup.adopt(FuncComponent("leader-elector", stop=stop_elector))
            print(f"leader election: campaigning as {identity!r}", flush=True)
            while not elector.wait_for_leadership(timeout=0.5):
                if sup.stop_requested:
                    return 0
            print("leader election: leading; starting reconciles", flush=True)

        return _reconcile_loop(args, mgr, policy, selector, elector, queue, metrics, sup,
                               worker, orchestrator, relay_source, sims)
    finally:
        # Every exit (--once, SIGTERM even in the setup, the lease lost, an
        # error) drains what the supervisor adopted; a Lease is released
        # (a no-op where this replica holds none). The tracer exports
        # after every component that makes spans has stopped.
        sup.stop()
        sup.restore_signal_handlers()
        if tracer is not None:
            from .utils import tracing

            tracing.clear_tracer()
            count = tracer.export_jsonl(args.trace_export)
            print(f"trace: {count} spans exported to {args.trace_export}", file=sys.stderr)


def _shard_worker(args, client, mgr, selector, identity: str, relay_source=None):
    """The fleet worker around the configured manager: a Lease a shard,
    the shard-scoped snapshot source (its watches through
    ``relay_source`` where there is one) and, with a rollout, the
    grant-gated planner. Not started."""
    from .fleet import FleetWorkerConfig, ShardWorker, shard_id

    sep = args.pool_prefix_sep

    def pool_of(name: str) -> str:
        return name.rsplit(sep, 1)[0] if sep else name

    return ShardWorker(
        client,
        FleetWorkerConfig(
            identity=identity,
            pool_of=pool_of,
            shards=args.shards,
            namespace=args.namespace,
            driver_labels=selector,
            rollout_name=args.fleet_rollout,
            preferred_shards=[shard_id(args.shard_index % args.shards)],
            lease_namespace=args.namespace,
            verify_every_n=args.verify_every_n,
            watch_hub=relay_source,
        ),
        manager=mgr,
    )


def _watch(args, client, mgr, selector, sup, probe_selector: str = "", worker=None,
           relay_source=None):
    """The watch path: informer deltas add node keys to a rate-limited
    workqueue, and one informer set is both the trigger and the
    incremental snapshot source (a fleet worker's scoped one where
    ``worker`` is given); with probe pods (``probe_selector``), an
    informer over them wakes their nodes too, since a probe pod turning
    Ready is what a node in validation waits for. The queue, started and
    adopted."""
    from .kube.informer import Informer
    from .kube.workqueue import RateLimitingQueue, default_controller_rate_limiter
    from .upgrade import IncrementalSnapshotSource, condition_changed_predicate

    queue = RateLimitingQueue(default_controller_rate_limiter())
    # The queue consumes the informers' deltas: it drains first, so nothing
    # enqueues into a half-stopped trigger path.
    queue_deps = ([("shard-worker" if worker is not None else "snapshot-source")]
                  + (["nm-informer"] if args.requestor else [])
                  + (["probe-informer"] if probe_selector else []))
    sup.adopt(FuncComponent("workqueue", stop=queue.shutdown), depends_on=queue_deps)

    def enqueue_node(event_type, obj, old):
        queue.add(obj.name)

    def enqueue_pod_node(event_type, obj, old):
        # A pod's event wakes its node, old and new placement; a pod on no
        # node yet wakes the world, so the pass sees the snapshot short.
        names = {obj.node_name or ""}
        if old is not None:
            names.add(old.node_name or "")
        names.discard("")
        for name in names or {RESYNC_KEY}:
            queue.add(name)

    def enqueue_world(event_type, obj, old):
        # A DaemonSet or ControllerRevision delta re-hashes every node's
        # sync check.
        queue.add(RESYNC_KEY)

    def nm_node_names(obj):
        name = (obj.raw.get("spec") or {}).get("nodeName", "")
        return [name] if name else []

    def maintenance_enqueue(event_type, obj, old):
        # Condition changes and deletions only, as the upstream predicate
        # filters the watch.
        if event_type != "MODIFIED" or old is None or condition_changed_predicate(old.raw, obj.raw):
            for name in nm_node_names(obj) or [RESYNC_KEY]:
                queue.add(name)

    source = worker.source if worker is not None else IncrementalSnapshotSource(
        client, args.namespace, selector, verify_every_n=args.verify_every_n,
        watch_hub=relay_source,
    )
    # A new ControllerRevision is the rollout's trigger: the driver bump
    # lands as one, and nothing else would wake the controller to start.
    source.informer("Node").add_event_handler(enqueue_node)
    source.informer("Pod").add_event_handler(enqueue_pod_node)
    for kind in ("DaemonSet", "ControllerRevision"):
        source.informer(kind).add_event_handler(enqueue_world)
    nm_informer = None
    if args.requestor:
        nm_informer = Informer(client, "NodeMaintenance")
        nm_informer.add_event_handler(maintenance_enqueue)
        # The kept state must see these deltas too: each object marks its
        # node dirty (one naming no node invalidates the whole state).
        source.mark_dirty_on(nm_informer, nm_node_names)
        nm_informer.start()
        # The source consumes its marks, so it stops first; the elector
        # outlives both.
        sup.adopt(FuncComponent("nm-informer", stop=nm_informer.stop),
                  depends_on=["leader-elector"] if args.leader_elect else [])
    # start() returns once the stores are seeded: a snapshot before that
    # would be empty, not stale. The worker wired its source into the
    # manager, and its component stops it.
    if worker is not None:
        worker.start(sync_timeout=30)
    else:
        source.start(sync_timeout=30)
        mgr.snapshot_source = source
        mgr.provider.set_write_through(source.record_write)
        mgr.common.pod_manager.revision_source = source
    if probe_selector:
        # Not part of the kept state (the validation manager reads its pods
        # itself): only a trigger.
        probe_informer = Informer(client, "Pod", namespace=args.namespace,
                                  label_selector=probe_selector)
        probe_informer.add_event_handler(enqueue_pod_node)
        probe_informer.start()
        sup.adopt(FuncComponent("probe-informer", stop=probe_informer.stop),
                  depends_on=["leader-elector"] if args.leader_elect else [])
        if not probe_informer.wait_for_sync(timeout=30):
            logging.warning("probe pod informer did not sync within 30s; reconciles may "
                            "miss a probe pod's readiness until it catches up")
    if worker is None:
        source_deps = ["nm-informer"] if args.requestor else []
        if args.leader_elect:
            source_deps.append("leader-elector")
        if relay_source is not None:
            source_deps.append("relay-source")
        sup.adopt(FuncComponent("snapshot-source", stop=source.stop), depends_on=source_deps)
    if nm_informer is not None and not nm_informer.wait_for_sync(timeout=30):
        logging.warning("%s informer did not sync within 30s; reconciles may miss its "
                        "triggers until it catches up", nm_informer.kind)
    return queue


class Demo:
    """The demo's simulators, stepped around each pass: the driver
    DaemonSet's, and where the flags ask for them, the probe pods' kubelet
    and the maintenance operator. All ``None`` outside the demo."""

    def __init__(self) -> None:
        self.driver = None
        self.validation_pods = None
        self.maintenance = None

    def step_before_pass(self) -> None:
        for sim in (self.driver, self.maintenance, self.validation_pods):
            if sim is not None:
                sim.step()

    def complete(self, mgr) -> bool:
        """Every node ``upgrade-done`` and every driver pod Ready at the
        newest revision, read from the node labels: never an extra
        ``build_state``, which would consume an incremental source's dirty
        set."""
        objs = mgr.client.list("Node")
        return bool(objs) and all(
            ((o.raw.get("metadata") or {}).get("labels") or {}).get(mgr.keys.state_label)
            == UpgradeState.DONE
            for o in objs
        ) and self.driver.all_pods_ready_and_current()


def _reconcile_loop(args, mgr, policy, selector, elector, queue, metrics, sup,
                    worker=None, orchestrator=None, relay_source=None, sims=None):
    # The stats file is written on every exit. With --watch, ``woken_by``
    # counts the passes after the first by what woke them: a node's key, the
    # world's key alone, or the interval running out. A fleet worker adds
    # its ticks that held no shard, the shards it held last and the pools
    # it reported done; an orchestrator its grants.
    stats: dict = {"passes": 0}
    if queue is not None:
        stats["woken_by"] = {"nodes": 0, "resync": 0, "interval": 0}
    if worker is not None:
        stats.update(idle_ticks=0, shards=[], pools_reported_done=0)
    started = time.monotonic()
    try:
        return _reconcile_passes(args, mgr, policy, selector, elector, queue, metrics, sup,
                                 stats, worker, sims or Demo())
    finally:
        if orchestrator is not None:
            orch = orchestrator.orchestrator
            stats["orchestrator"] = {
                "grants_issued": orch.grants_issued, "grant_order": list(orch.grant_order),
                "budget_denials": orch.budget_denials, "ticks": orch.ticks,
                "led_ticks": orchestrator.led_ticks, "api_errors": orch.api_errors,
            }
        if args.stats_json:
            transport_stats = getattr(mgr.client, "transport_stats", None)
            if callable(transport_stats):
                stats["transport"] = transport_stats()
            if relay_source is not None:
                stats["relay"] = relay_source.stats()
            with open(args.stats_json, "w") as f:
                json.dump(dict(stats, wall_s=time.monotonic() - started),
                          f, indent=2, sort_keys=True)


def _reconcile_passes(args, mgr, policy, selector, elector, queue, metrics, sup, stats,
                      worker, sims):
    # A fleet worker renews its shard Leases in its ticks, so it ticks at
    # least every retry period whatever the interval.
    interval = (min(args.interval, worker.config.retry_period_s) if worker is not None
                else args.interval)
    demo = sims.driver is not None
    max_demo_passes = MAX_FLEET_DEMO_PASSES if args.fleet_rollout else MAX_DEMO_PASSES
    if demo:
        # The demo spins at full speed, but over a fleet worker it paces
        # its passes a little: the orchestrator's grant rounds, and the
        # deliveries of the informers the worker's snapshot is kept from,
        # land between them (at full speed the pass cap can run out while
        # the informers still lag a driver pod's restart).
        interval = 0.02 if worker is not None else 0.0
    passes = 0
    consecutive_failures = 0
    #: The workqueue keys the current pass reconciles (--watch). A pass
    #: covers the whole world, so one batch a pass; each key is done()
    #: after it, forgotten on success, rate-limited again on failure.
    keys: list = []
    while True:
        if sup.stop_requested:
            # The signal handler only set the event; this is where the
            # process acts on it. The caller's finally drains.
            print("shutdown requested; draining", file=sys.stderr, flush=True)
            return 0
        if elector is not None and not elector.is_leader():
            # A deposed leader must never reconcile on: exit, and let the
            # restart policy campaign again from scratch.
            print("leader election: lease lost; exiting", file=sys.stderr, flush=True)
            return 3
        if queue is not None and passes:
            woken = "interval" if not keys else "resync" if set(keys) == {RESYNC_KEY} else "nodes"
            stats["woken_by"][woken] += 1
        passes += 1
        stats["passes"] = passes
        if demo and passes > max_demo_passes:
            print(f"demo: did not converge within {max_demo_passes} passes",
                  file=sys.stderr, flush=True)
            return 1
        sims.step_before_pass()
        try:
            if worker is not None:
                # One tick: the shard Leases, a pass over the shards held,
                # the ledger's grants and completions. No state: no shard.
                ticked = worker.tick(policy)
                state = ticked.state
                stats["shards"] = sorted(ticked.owned)
                stats["pools_reported_done"] = worker.pools_reported_done
            else:
                state = mgr.build_state(args.namespace, selector)
                mgr.apply_state(state, policy)
        except Exception as e:  # noqa: BLE001 - the process outlives its passes
            if args.once:
                raise
            # An error aborts the pass, never the controller: the next pass
            # resumes from the labels. A transient gap heals in a requeue or
            # two; a persistent error must not spin.
            consecutive_failures += 1
            if queue is not None:
                # The pass's keys back off through the rate limiter (5 ms
                # doubling to 1000 s) while fresh events still trigger; a
                # pass no event woke backs off the world's key. done() only
                # on keys get_batch handed out.
                for key in keys:
                    queue.add_rate_limited(key)
                    queue.done(key)
                if not keys:
                    queue.add_rate_limited(RESYNC_KEY)
                requeues = queue.num_requeues(keys[0] if keys else RESYNC_KEY)
                print(f"pass {passes}: reconcile failed (rate-limited requeue #{requeues}): {e}",
                      file=sys.stderr, flush=True)
                keys = _next_batch(queue, interval, sup, elector)
                continue
            # Interval mode: 0.5 s doubling to 30 s, reset by a success; the
            # exponent is capped before the power.
            delay = min(0.5 * 2 ** min(consecutive_failures - 1, 10), 30.0)
            print(f"pass {passes}: reconcile failed (retry #{consecutive_failures} in "
                  f"{delay:.1f}s): {e}", file=sys.stderr, flush=True)
            # A signal wakes the backoff at once; the demo does not back off.
            _pause(0.0 if demo else delay, sup, elector)
            continue
        consecutive_failures = 0
        if queue is not None:
            # Success retires the pass's keys; one added again during the
            # pass is handed out again by done().
            for key in keys:
                queue.forget(key)
                queue.done(key)
        if state is None:
            stats["idle_ticks"] += 1
            print(f"pass {passes}: no shards owned (campaigning for {sorted(worker.shards)})",
                  flush=True)
        else:
            if metrics is not None:
                metrics.observe(state)
            if demo:
                sims.driver.step()
            shard_note = (f" | shards={','.join(sorted(worker.owned_shards()))}"
                          if worker is not None else "")
            print(
                f"pass {passes}: {state_counts(state)} | "
                f"in-progress={mgr.get_upgrades_in_progress(state)} "
                f"done={mgr.get_upgrades_done(state)} "
                f"failed={mgr.get_upgrades_failed(state)}{shard_note}",
                flush=True,
            )
            if demo and sims.complete(mgr):
                print(f"demo: rolling upgrade complete in {passes} passes", flush=True)
                return 0
        if args.once:
            return 0
        if queue is not None:
            # Block for the first key, then take what gathered during the
            # pass: one pass covers them all. An empty batch (the timeout)
            # is the periodic resync.
            keys = _next_batch(queue, interval, sup, elector)
        else:
            _pause(interval, sup, elector)


def _interrupted(sup, elector) -> bool:
    return sup.stop_requested or (elector is not None and not elector.is_leader())


def _next_batch(queue, interval: float, sup, elector) -> list:
    """``queue.get_batch(timeout=interval)`` in slices of ``WAKE_S``; empty
    once the interval passed, a stop was asked for or the Lease was lost."""
    deadline = time.monotonic() + interval
    while True:
        remaining = deadline - time.monotonic()
        keys = queue.get_batch(timeout=max(0.0, min(remaining, WAKE_S)))
        if keys or remaining <= WAKE_S or _interrupted(sup, elector):
            return keys


def _pause(seconds: float, sup, elector) -> None:
    """``sup.wait(seconds)``, cut short by a lost Lease too."""
    deadline = time.monotonic() + seconds
    while not _interrupted(sup, elector):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        sup.wait(min(remaining, WAKE_S))


def run_process() -> None:
    """``main`` as the process: its code, then ``os._exit``. Tasks that
    outlived the shutdown end with the process here, while the Lease they
    wrote under has not expired: the interpreter's own exit would join
    them and let them write after another replica leads."""
    code = 1
    try:
        code = main()
    except SystemExit as e:
        if e.code is None or isinstance(e.code, int):
            code = e.code or 0
        else:
            print(e.code, file=sys.stderr)
    except Exception:
        logging.exception("upgrade-controller: unhandled error")
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


if __name__ == "__main__":
    run_process()
