#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit;
2. build both CUDA kernels from ``k8s_operator_libs_tpu_torch/ops/csrc``
   (one ``nvcc`` a source, all at once) and show ``-Xptxas -v``;
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's shapes and at the burn-in's head_dims, with the
   tolerance stated, and timed beside the plain version, one PyTorch
   library call (a yardstick the port never calls) and the least time the
   card could take. Each matmul row (``shape`` is M, K, N) asserts and
   names the kernel it took: ``wgmma`` at the gate's and larger sizes, the
   masked WMMA kernel at a shape TMA cannot describe. ``ms`` and
   ``library_ms`` time a CUDA graph of back-to-back calls (the card's
   time); ``call_ms`` and ``plain_ms`` time calls made one by one from
   Python (the host's cost per call included);
4. gate phase (the main path): ``IciHealthGate.tpu_defaults().run()`` on
   the card with every launch count set to 0 just before; the report must
   be ok, both kernels must have been launched, the chain's CUDA graph
   must hold ``chain`` matmul launches by the wrapper's own count, and the
   matmul kernel must have run exactly ``1 + 4 * chain`` times (one
   numerics call, then the chain run once outside its graph and replayed
   three times). The gate forms a world of one NCCL rank process per card
   for its collective battery and its sharded burn-in; neither launches a
   kernel of the port, so the counts are the parent's;
5. collectives phase, on an NCCL world of ``torch.cuda.device_count()``
   ranks: the collective battery (``run_ici_probes``, all four ops ok, each
   op's ``elapsed_s`` and the time of its call from here), the quick
   battery twice, first and warm (checks ok, ``mxu_tflops`` and
   ``probe_latency_s`` in its metrics), and the gate at ``tpu_defaults()``
   twice (first and warm ``elapsed_s``: what forming the world costs, with
   the world's own split of it into spawn and import, device context,
   process-group join and first all-reduce), its
   collectives ok. With two or more cards the per-link tier, the sharded
   burn-in and the ring and Ulysses probes must be ok too; with one card a
   line says they were not run;
6. the burn-in at ``BurninConfig()`` width: three train steps, the loss
   finite and falling;
7. the burn-in's forward at ``BurninConfig()`` width with the flash core
   (head_dim 32), counts set to 0 just before: the kernel runs once a
   layer and the logits match the plain core's;
8. entry phase, the flagship model (``entry.ENTRY_CFG``: vocab 1024,
   d_model 256, 8 heads, d_ff 1024, 4 layers, seq 256, batch 4) on the
   card: ``entry()``'s forward, first and warm, its logits finite and its
   loss within ``CARD_VS_CPU_REL`` of the same parameters' f32 loss on the
   CPU; the same widths with four experts a layer, three train steps, the
   loss finite, falling and first within ``CARD_VS_CPU_REL`` of the CPU's;
   and that MoE forward with the flash core, counts set to 0 just before:
   the flash kernel runs once a layer (4 times), the matmul kernel never,
   and the logits match the plain core's;
9. dryrun phase, on an NCCL world of every card: ``dryrun_multichip``,
   the JAX dry run's programs for the world's size, two steps each (mesh,
   loss, each step's seconds), every loss finite; then the MoE flagship's
   sharded step over the world's layouts (one card: dp 1; four cards:
   {ep2, tp2}, {tp2, sp2} with ring and with Ulysses, {dp2, pp2}), its
   first loss within ``SHARDED_REL`` of the unsharded step's on the card
   and equal on every rank. With one card a line says which axes were
   not exercised;
10. the CLI payload in a subprocess: its report must parse and be ok;
11. device-class phase (the GPU node roll's probe pod): the node's GPU
    Feature Discovery labels built from the card's own facts must make the
    node detector see a GPU node of ``torch.cuda.device_count()`` cards;
    the validation pod built for it with the default spec must ask for
    that many ``nvidia.com/gpu`` (the node's own count); and its container
    command runs as a kubelet would (``python`` is this interpreter, the
    container's environment applies with the kernel-cache host path mapped
    to a temporary directory, the ready file lies in a temporary
    directory), twice on one cache: cold (``nvcc`` runs inside the pod)
    and warm. Each run must write its ready file within
    ``POD_READY_TIMEOUT_S``, print an ok report with the matmul and flash
    probes ok, launch each kernel as often as the gate phase did (the
    payload's own counts, from its stderr line) and still be alive
    (parked) after; then it is stopped. The line ``{"device_class": ...}``
    gives the seconds to Ready, the report's ``elapsed_s``,
    ``mxu_tflops``, flash ok and the build seconds of each;
12. roll phase (the port's own rolling-upgrade state machine): two GPU
    nodes labelled from the card's own facts, each with a workload pod,
    in a ``DictClient``; the NVIDIA driver DaemonSet of
    ``LibtpuDaemonSetManager`` at 550.54.15 with a driver pod on each
    node, then bumped to 560.35.03. ``RollKubelet`` plays the DaemonSet
    controller and the kubelet between passes: a ControllerRevision per
    version, a driver pod recreated at the new revision (held by the
    safe-load gate until the machine removes the node's annotation, Ready
    a tick later), and each validation pod's container command run as the
    device-class phase runs it (``run_probe_pod``, each node's kernel
    cache its own temporary directory, so each pod runs ``nvcc``), the
    pod turning Ready from its ready file. The port's
    ``ClusterUpgradeStateManager`` with its default task runner,
    ``with_validation_enabled(pod_provisioner=ValidationPodManager(client,
    ValidationPodSpec()))`` and the policy ``ROLL_POLICY``
    (``maxParallelUpgrades`` 1, drain on) reconciles until both nodes read
    ``upgrade-done`` and are uncordoned; ``upgrade-failed``, or no node
    changing state for ``ROLL_STALL_S`` seconds, fails the script. Each
    probe pod's payload must report ok and launch each kernel as often as
    the gate phase; the parent's counts, set to 0 just before, must stay
    0. ``{"roll": ...}`` gives the passes, the roll's wall seconds, each
    node's states with the pass each began, each probe pod's seconds to
    Ready, report, build seconds and launches, and the workload pods the
    drain evicted. Each node's kernel cache outlives the phase for the
    next one;
13. requestor_roll phase (the port's machine in the requestor mode): two
    more nodes, ``gpu-req-0`` and ``gpu-req-1``, labelled from the card,
    each with a workload pod, rolled 550 → 560 under ``ROLL_POLICY`` by a
    ``ClusterUpgradeStateManager`` with ``enable_requestor_mode``
    (``use_maintenance_operator`` and ``use_post_maintenance`` on, the
    post-maintenance hook the port's ``cache_warmup_hook`` with the gate
    at ``tpu_defaults()`` on the card in this process) and validation by
    the same probe pods. The port's ``MaintenanceOperatorSimulator``
    stands in for NVIDIA's maintenance operator, stepped once a pass: it
    cordons and drains each node through its ``NodeMaintenance`` object
    and, on the object's deletion, uncordons the node and removes its
    finalizer (``DictClient`` holds a deleted object until then). Each
    node's probe pod runs on the kernel cache of a roll-phase node (a
    printed line says so), so no pod runs ``nvcc``. Every node must end
    ``upgrade-done`` and uncordoned, each having passed through
    ``node-maintenance-required`` and ``post-maintenance-required``, with
    no NodeMaintenance and no workload pod left and every driver pod
    Ready at 560; the hook runs once a node, on the cordoned node; each
    hook call must launch each kernel as often as the gate phase (its
    counts read before and after), the controller's counts, set to 0
    just before, must be exactly the hook calls' (twice the gate's), and
    each probe pod's payload must launch the gate's counts.
    ``{"requestor_roll": ...}`` gives the passes, the wall seconds, each
    node's states with the pass and second each began, each hook call's
    seconds and launches, each probe pod's seconds to Ready, report and
    launches, and each pass's NodeMaintenance reasons. The watch phase's
    NodeMaintenance informer (15) watches this phase's client throughout;
14. checkpoint_roll phase (the checkpoint arc): two more nodes rolled the
    same way in place under ``CHECKPOINT_POLICY`` (the roll's policy with
    ``checkpoint`` on ``app=trainer``), validated by probe pods on the
    roll phase's kernel caches. The port's ``CheckpointingWorkloadSimulator``
    keeps one training pod a node, ticked once a pass, and each pod is
    backed by ``Trainer``: the flagship model (``entry.ENTRY_CFG``) on the
    card, trained for real up to the simulator's step, saved with
    ``torch.save`` at each ack and loaded with ``torch.load`` at each
    restore. After the roll the jobs tick until each is back past the step
    it stopped at. Every node must end ``upgrade-done`` and uncordoned,
    having passed ``checkpoint-required``, ``drain-required`` and
    ``validation-required`` in that order, its drain event
    checkpoint-coordinated, its manifest written and then retired; the
    checkpoint totals 2 completions, 2 restores verified, no escalation;
    the steps the trainer trained again must equal the simulator's lost
    steps, below its total; each restore's parameters must be
    ``torch.equal`` to those saved and its first loss (a forward pass on
    the next step's batch) equal to the loss recorded there before the
    eviction; each probe pod must launch the gate's counts without
    ``nvcc``, the controller none. ``{"checkpoint_roll": ...}`` gives the
    passes, the wall seconds, each node's states with the pass and second
    each began, each pass's checkpoint ``PassStats``, each probe pod's
    seconds to Ready and launches, the trainer's ms a step and save and
    load seconds, each restore, and the lost, total and restarted steps.
    The phase is traced (``TracedPhase``: a port ``Tracer`` installed for
    it alone, an ``UpgradeMetrics`` over its manager observed after every
    pass and served by ``MetricsServer``): ``{"trace": ...}`` gives the
    spans by name, the events by name, the port's ``tools/trace_view.py``
    attribution of the window's seconds by category and each node's
    journey (every ``state.transition`` with its cause, the bucket span it
    lies in, its pass and the pass's wake links), and ``{"metrics": ...}``
    the gauges of one scrape of ``/metrics`` over HTTP. Each journey must
    run from ``upgrade-required`` to ``upgrade-done`` with every cause in
    a bucket span, every bucket span must lie in a ``reconcile.pass``,
    the scrape must count the passes observed, 2 checkpoints completed
    and no escalation, and the trace must hold the arc's events;
15. watch phase (the port's informer, ``kube/informer.py``, over
    ``DictClient``'s journal-backed watch, which selects through the port's
    ``kube/selectors.py``), around the requestor roll and the monitor
    phase. A NodeMaintenance informer in ``MAINTENANCE_NS`` with
    ``WATCH_WINDOW_S`` windows starts before the requestor roll; after it,
    a handler filtered by ``requestor_id_predicate`` must have seen one
    ADDED and one DELETED for each requestor node's object, the store must
    be empty and at least one window must have resumed; then the journal
    is compacted below the informer's revision, which must re-list, its
    store equal to ``client.list``. Before the monitor phase its client is
    seeded with ``WATCH_POOL_NODES`` GPU nodes of about 2.6 KB each (labels
    from the card, the kubelet's status), and a Node informer on
    ``WATCH_NODE_SELECTOR`` must hold all 257 nodes after
    ``wait_for_sync`` (timed), with a NodeHealthReport informer beside it.
    During the monitor phase the report informer's copy of the monitored
    node's report must equal the published one (resourceVersion and
    status), with the card's ``mxu_tflops``; after it, a handler filtered
    by ``condition_changed_predicate`` must have seen the node's
    ``TpuIciHealthy`` turn True and then False. ``{"watch": ...}`` gives
    the sync seconds, the events each informer's handlers saw, the windows
    and resumed windows, the re-lists and each informer's events a second;
16. monitor phase: ``TpuHealthMonitor.check_once()`` on a node labelled
    from the card, against a dict-backed client (``DictClient``: Node,
    Pod, Event, NodeHealthReport), its gate the port's
    ``SubprocessHealthGate`` at ``tpu_defaults()``, so each cycle is the
    card's payload with both kernels. A passing cycle must write
    ``TpuIciHealthy=True`` and, through ``ReportPublisher``, a
    NodeHealthReport whose ``mxu_tflops`` is the report's; its payload must
    launch each kernel as often as the gate phase (the child's own counts,
    from its stderr line). A cycle with ``--min-mxu-tflops 1e9`` and
    ``failure_threshold=1`` must write ``False`` and one Warning Event; that
    Warning recorded once more through the monitor's correlated
    ``EventRecorder`` must leave the same one Event object, its ``count``
    2. A live pod holding ``nvidia.com/gpu`` on the node must skip the cycle
    without running the gate. One quick-tier cycle,
    ``run_quick_probe_loop(once=True)``, forms a world of every card and
    publishes a report. ``{"monitor": ...}`` gives each cycle's wall seconds
    (the child included) and the payload's launches;
17. gang phase: the payload as a slice gang pod, a child process with
    ``--coordinator 127.0.0.1:<free port> --num-processes 1 --process-id 0
    --publish-report`` (``NODE_NAME`` set, the kubeconfig pointing at
    ``ApiStub``, an HTTP front of the same kind of dict-backed client). Its
    ranks join through the TCP store; its report must say
    ``process_count`` 1, ``slice_devices_total`` = the cards, and
    ``slice=`` in its summary and ready file, be published as the node's
    NodeHealthReport, and launch each kernel as often as the gate phase.
    With two or more cards, two such children, each with its own half of
    the cards in ``CUDA_VISIBLE_DEVICES`` and ``--num-processes 2``: both
    ready files must read ``slice=N/N over 2 hosts`` and each report's
    hop to the other child must name the other member's node.
    ``{"gang": ...}`` gives each child's world formation split as
    ``World.form_times`` does, the TCP join included;
18. quarantine phase (the quarantine arc and the health telemetry it
    reads), after the monitor phase and before the gang phase: the monitor
    phase keeps the two NodeHealthReports it published, after its passing
    and its failing cycle (the failing cycle must publish one). A pool of
    ``QUARANTINE_NODES`` (the monitored node and three more, the roll's
    helpers, ``ROLL_POLICY``'s budget of one node) in a ``DictClient``,
    reconciled by the port's ``ClusterUpgradeStateManager`` with
    ``with_health_telemetry()`` (its ``HealthSource`` an informer over the
    client), validation by probe pods, and the quarantine arc on: the
    entry threshold halfway between the two reports' scores, recovery at
    the healthy report's, both read off the reports; its clock virtual,
    advanced past each deadline. The pool settles ``upgrade-done``; the
    failing report, written as the node's report, makes one pass
    quarantine and cordon that node alone, with an event saying so; a
    recheck past the backoff keeps it and doubles the backoff; the passing
    report releases and uncordons it and the next pass classifies it
    done; the failing report again quarantines it and, past
    ``QUARANTINE_HANDOFF_S``, hands it off to ``upgrade-required`` still
    cordoned; the roll then takes it to ``upgrade-done`` through its probe
    pod, on a roll-phase node's kernel cache (no ``nvcc``), launching each
    kernel as often as the gate phase; the controller launches none.
    ``HealthMetrics.render()`` must count 2 entries, 1 release and 1
    hand-off. ``{"quarantine": ...}`` gives both scores and thresholds
    (the healthy card's score among them), each pass's node states, the
    totals, the rendered counters, the probe pod's seconds to Ready and
    launches, and the phase's wall seconds;
19. informer_roll phase (the CRD utility and the informer-fed reconcile),
    after the quarantine phase: ``ApiStub`` in front of a ``DictClient``
    whose CRDs' served versions turn discoverable ``CRD_DISCOVERY_DELAY_S``
    after they are written. Three child processes run ``python -m
    k8s_operator_libs_tpu_torch.crdutil --crds-path manifests/crds`` with a
    kubeconfig at the stub: ``--operation apply`` (both CRDs,
    ``nodemaintenances.maintenance.nvidia.com`` and
    ``tpuupgradepolicies.tpu-operator.dev``, stored and discoverable after
    it, the wait having polled discovery), the same again (the update
    path: both ``resourceVersion``s move) and, at the phase's end,
    ``--operation delete`` (both gone from storage and discovery). In the
    same client, ``WATCH_POOL_NODES`` nodes of another pool (``pool_node``,
    no driver pod) and ``INFORMER_NODES``, labelled from the card with a
    workload pod each and the driver DaemonSet at 550: 258 nodes. The
    port's machine with validation by probe pods (on the roll phase's
    kernel caches, so no ``nvcc``),
    ``with_snapshot_from_informers(..., incremental=True,
    verify_every_n=VERIFY_EVERY_N)`` and ``enable_write_batching()`` rolls
    the two to 560 under ``ROLL_POLICY``, each pass after the informers'
    stores have caught up with the client. Then ``SETTLED_PASSES`` settled
    passes, ``audit_incremental()``, and three ``build_state`` calls and
    one pass of a second manager on the LIST source. Every rolled node
    must end ``upgrade-done`` and uncordoned; the other 256 carry no
    upgrade key and were never cordoned (the client's journal); every
    settled pass reads and writes nothing (``PassStats`` and the client's
    own call counts); the audit finds no divergence; the batcher flushed
    every write the provider issued; the LIST pass reads 3 or more; the
    controller launches no kernel, and each probe pod the gate's counts.
    The phase is traced as the checkpoint phase is (``DictClient``'s
    writes record their trace by revision, so each ``informer.deliver``
    span joins the write it delivers and the next pass links to it); the
    settled passes start once every delivery is handed to the handlers,
    and each one served from the kept state must start no span and time
    no bucket; the same passes run again with the tracer cleared (what
    tracing costs a settled pass). Last, the stale view: a fault plan
    holds the Pod stream at ``watch.deliver`` while ``JOIN_NODE`` joins
    the pool (a Ready driver pod at the new version, the desired count
    3); one pass must abort on the completeness check, counted in
    ``aborted_completeness_races``, and after the release the passes
    until the pool settles must begin with a full rebuild and leave the
    joined node ``upgrade-done`` (259 nodes in all).
    ``{"informer_roll": ...}`` gives the CRD utility's runs (seconds, last
    line, discovery polls), the passes, wall seconds, trajectories and
    each pass's ``PassStats``, the reads and writes of the roll and of
    each settled pass, the batcher's ``stats()``, the provider's write
    counts, each informer's ``full_relists``, ``build_state`` milliseconds
    (settled incremental and LIST), the probe pods' seconds to Ready and
    launches, the settled passes again untraced and the traced and
    untraced milliseconds of those served from the kept state
    (``tracing_cost_ms``), the stale view's abort and heal
    (``stale_view``), the passes observed, and the phase's wall seconds
    (``phase_wall_s``; ``wall_s`` is the roll's);
20. controller_roll phase (the controller runtime), after the informer
    roll: two more nodes, ``CONTROLLER_NODES``, labelled from the card with
    a workload pod each, in a ``DictClient`` behind ``ApiStub``; the port's
    ``DaemonSetSimulator`` makes the NVIDIA driver DaemonSet of
    ``tpu/libtpu.py`` at 550 (its pods held by the safe-load key once
    armed) and the port's ``ValidationPodSimulator`` with a
    ``KubeletPayloadExecutor`` runs each probe pod's own command (its
    output kept in files, its kernel cache a roll-phase node's, so no
    ``nvcc``); both tick every ``KUBELET_TICK_S`` in a thread here. Two
    replicas of ``python -m k8s_operator_libs_tpu_torch.upgrade_controller
    --watch --interval 600 --validation-pod --policy <ROLL_POLICY>
    --leader-elect`` run as children over a kubeconfig at the stub,
    ``ctl-a`` first, ``ctl-b`` once ``ctl-a`` leads, each with
    ``--metrics-port``, ``--trace-export`` and ``--stats-json``, their
    output drained continuously. After ``ctl-a``'s first pass the driver is
    bumped to 560: only watch-triggered passes can roll the pool. Both
    nodes must end ``upgrade-done`` and uncordoned with every driver pod
    Ready at 560 and no workload pod left; then the kubelet stops,
    ``/metrics`` is scraped once (``reconcile_passes_total`` must equal the
    passes ``ctl-a`` printed), ``ctl-a`` gets SIGTERM, ``ctl-b`` must lead
    within ``LEASE_DURATION_S`` of the signal and run a pass, and ``ctl-b``
    gets SIGTERM. Both must exit 0, the Lease must not be ``ctl-a``'s after
    its stop nor anyone's after ``ctl-b``'s, ``ctl-b`` must print no pass
    before ``ctl-a`` prints that it drains, each ``--stats-json`` must count the passes its
    replica printed, each trace must hold a ``lease.round`` span, each probe
    pod's payload must launch the gate's counts and this process none.
    The stub drops a write that changes nothing (no revision, no event),
    so the kubelet's ticks wake no pass: ``ctl-a``'s ``woken_by`` must
    show the interval never ran out and more passes woken by node and pod
    keys than by the world's key alone.
    ``{"controller_roll": ...}`` gives the passes, the wall seconds, the
    kubelet's ticks over the roll,
    each node's states with the second each began, each probe pod's
    seconds to Ready and kernels, the scrape, the takeover seconds, the
    return codes, the Lease's holder after each stop and its transitions,
    each trace's spans by name and each stats file;
21. fleet_roll phase (the fleet tier), after the controller roll: two
    fleet workers of the same command roll two pools under one
    FleetRollout's budget of one pool (``fleet_roll_phase``); then
    relay_roll, the same through a ``WatchRelay`` on pools of its own;
22. in-memory phase (the port's in-memory cluster, ``kube/fake.py``),
    after relay_roll and before the gang phase: ``demo``, the command's
    ``--demo`` as two child processes at once on the card, plain and
    ``--requestor --post-maintenance``, each uncordon gated by the in-process gate on
    the card (the plain product, as the JAX demo's takes XLA's dot): each
    must exit 0 printing ``rolling upgrade complete`` with every demo
    node's gate verdict ok (``{"demo": ...}``: seconds, passes, each
    node's verdict and gate seconds); ``crdutil_demo``, ``python -m
    k8s_operator_libs_tpu_torch.crdutil --demo`` on ``manifests/crds``,
    apply then delete, each printing ``processed 2 CRD(s)``
    (``{"crdutil_demo": ...}``: seconds), beside the demo children;
    ``fake_roll``, the roll phase's
    scenario over the port's ``FakeCluster`` with 256 more GPU nodes, the
    manager and the provider reading through ``CachedClient`` in its auto
    mode, each probe pod on the kernel cache the roll phase left for its
    node: each pod must launch both kernels as often as the gate phase
    did and the controller neither (``{"fake_roll": ...}``: the roll's
    fields, the cluster's node count and the provider's read-back waits);
    then server_roll (``controller_roll_phase(..., server=True)``), in the
    same kernel-cache block: the port's own ``LocalApiServer`` in this
    process (a random token, bookmarks every ``SERVER_BOOKMARK_S``, the
    loop-stall watchdog at ``SERVER_STALL_S``, the default priority and
    fairness), ``SERVER_NODES`` labelled from the card among
    ``SERVER_POOL_NODES`` GPU nodes of another pool, one replica of the
    controller_roll's command over the kubeconfig the server writes (its
    kernel directory an empty one it must leave empty), the kubelets'
    simulators over the port's ``RestClient`` at the server (their Node
    reads by name, scoped to the two nodes), every connection killed once
    when the first node is done, a Table read of the two nodes after the
    roll, then SIGTERM. Both nodes must end ``upgrade-done`` uncordoned
    with each probe pod the gate's counts; the command's Node list paged
    (two or more continue tokens); the lease, reconcile and informer flows
    each admitting, none shedding; no server-loop stall over the
    threshold; after the kill, watches resumed and no full Node LIST; the
    Table Name and Age with two rows; a ``server.request`` span joined to
    a span of the command's exported trace; exit 0 and the Lease empty
    (``{"server_roll": ...}``: the roll's fields, the server's counters,
    flows, stalls, continue tokens, the requests after the kill by verb
    and resource, the spans, the Table);
23. calibration phase, after the gang phase: ``python -m
    k8s_operator_libs_tpu_torch.tools.calibration`` as a child on every
    card; its one line is printed as ``{"calibration": ...}`` and must
    carry the port's keys (``CALIBRATION_KEYS``) with ``ok``,
    ``matmul_kernel_launched`` and ``flash_attention_ok`` true and both
    TFLOP/s above 0. The gate's floors stay 0: this line is what they
    will be set from;
24. monitor_manifest phase, after the calibration: the port's two
    DaemonSet manifests, read through the package's own data path, each
    container run as its kubelet would (``DaemonSetPod``: ``python`` this
    interpreter, a free metrics port, ``NODE_NAME`` the monitored node,
    ``KUBECONFIG`` at an ``ApiStub`` holding that node labelled from the
    card, the kernel-cache hostPath a fresh empty directory). The full
    tier twice on that directory, each until the node's ``TpuIciHealthy``
    is True and ``/metrics`` counts the first cycle, then SIGTERM: the
    first pod must build both kernels there, the second (the restart)
    must build nothing and leave every ``.so`` with its name and mtime,
    and must write nothing (it starts from the published condition); each
    pod's payload, as the monitor logs it, launches the gate phase's
    counts. Then the quick tier until its NodeHealthReport (source
    ``quick-probe``), which must not write the Node; then the full tier
    in process with an impossible floor, the condition set back to True
    each time it writes False, until its recorder patches a repeated
    Warning. Every request each pod made (method and path, as the stub
    logged them, mapped to group, resource with its subresource, and
    verb) must be allowed by its own shipped ClusterRole.
    ``{"monitor_manifest": ...}`` gives each pod's seconds, build seconds,
    launches and ``.so`` files, the seconds the cache saved the restart,
    the quick report's checks, the flaps and Warning counts, and each
    pod's requests by verb and resource.

The last lines are the kernel table as one JSON object (each row with the
launches of the gate, the burn-in forward, the flagship MoE flash
forward, the probe pod, the roll's probe pods together, the requestor
roll's hook calls together and its probe pods together, the checkpoint
roll's probe pods together, the monitor's payload, the quarantine
hand-off's probe pod, the informer roll's probe pods together, the
controller roll's probe pods together, the fleet roll's probe pods
together, the relay roll's, the fake roll's and the server roll's probe
pods together, the gang's payload and the first full-tier monitor pod's
payload),
the card's name and power limit, and
``{"ok": true, "device": {...}}``. Without a card,
or run from a directory that holds only this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data-sheet peaks (dense), at a 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: K1 vs its plain version: bf16 products are exact in f32, so the two
#: differ only in the order of the f32 sums.
K1_ATOL_PER_SQRT_K = 1e-3
#: K2 vs its plain version, elementwise |kernel - plain| <= atol + rtol*|plain|:
#: the kernel rounds P to bf16 before P.V (the plain version keeps f32), and
#: both round the output to bf16, which may differ by one bf16 step (2^-7
#: relative) between two nearly equal values.
K2_ATOL = 2e-2
K2_RTOL = 2.0**-7

#: Burn-in logits with the flash core vs the plain core: the two cores
#: round their bf16 outputs at different places, and one bf16 step of
#: difference there reaches the logits through the bf16 residual stream.
BURNIN_ATOL = 5e-2
BURNIN_RTOL = 2e-2

#: A loss on the card (bf16) against the same parameters' loss in f32 on
#: the CPU: bf16 rounds at other places (``tests/test_torch_cuda.py``).
CARD_VS_CPU_REL = 5e-3
#: A sharded step's first loss against the unsharded step's on the same
#: parameters: the JAX package's own tolerance for its sharded step in bf16.
SHARDED_REL = 2e-2

#: ((M, K, N), the kernel family it must take): the gate's size and two
#: larger ones through ``wgmma``, and a shape TMA cannot describe (K and N
#: not multiples of 8) through the masked WMMA kernel.
MATMUL_CASES = (
    ((1024, 1024, 1024), "wgmma"),
    ((2048, 2048, 2048), "wgmma"),
    ((4096, 4096, 4096), "wgmma"),
    ((129, 77, 257), "wmma_masked"),
)
#: (shape, causal): the probe's shape both ways, ``BurninConfig()`` with the
#: flash core, a common head_dim, and a size where the bound, not launch
#: latency, sets the goal.
FLASH_CASES = (
    ((1, 4, 1024, 128), True),
    ((1, 4, 1024, 128), False),
    ((8, 4, 128, 32), True),
    ((1, 4, 1024, 64), True),
    ((2, 16, 4096, 128), True),
)
CLI_TIMEOUT_S = 600
#: Seconds a probe pod's payload may take to write its ready file.
POD_READY_TIMEOUT_S = 600
#: The monitored node and the gang's nodes.
MONITOR_NODE = "gpu-node-0"
ROLL_NODES = ("gpu-roll-0", "gpu-roll-1")
ROLL_VERSIONS = ("550.54.15", "560.35.03")
#: The roll's policy document: one node at a time, drained.
ROLL_POLICY = {
    "autoUpgrade": True,
    "maxParallelUpgrades": 1,
    "maxUnavailable": "25%",
    "drain": {"enable": True, "force": True, "timeoutSeconds": 300},
}
#: The roll fails when no node changed state for this long.
ROLL_STALL_S = 300.0
#: Seconds between two passes of the roll.
ROLL_PASS_INTERVAL_S = 0.2
#: The requestor roll's nodes, the namespace of their NodeMaintenance
#: objects and the requestor's id.
REQUESTOR_NODES = ("gpu-req-0", "gpu-req-1")
MAINTENANCE_NS = "nvidia-maintenance-operator"
REQUESTOR_ID = "gpu.operator.dev"
#: The watch phase's pool beside the monitored node (256 nodes: at 8 cards
#: a node, one large training cluster; each labelled from this card), the
#: label its Node informer selects, and
#: the NodeMaintenance informer's watch window (short, so that windows end
#: and resume during the requestor roll).
WATCH_POOL_NODES = 256
WATCH_NODE_SELECTOR = "nvidia.com/gpu.present=true"
WATCH_WINDOW_S = 1
#: Seconds an informer may take to catch up with a write it must see.
WATCH_SETTLE_S = 30.0
#: The checkpoint roll's nodes, the namespace of its training pods, its
#: policy (the roll's, with the checkpoint arc on the training pods) and
#: the seed of its trainers' parameters and batches.
CHECKPOINT_NODES = ("gpu-ckpt-0", "gpu-ckpt-1")
TRAINING_NS = "training"
CHECKPOINT_POLICY = {
    **ROLL_POLICY,
    "checkpoint": {"enable": True, "podSelector": "app=trainer", "timeoutSeconds": 300},
}
TRAINER_SEED = 1017
#: Workload ticks after the roll for the evicted jobs to come back and
#: train past the step they stopped at.
CATCH_UP_TICKS = 20
#: The checkpoint fields of ``PassStats`` read after each pass.
CHECKPOINT_STATS = (
    "checkpoint_nodes_waiting",
    "checkpoint_requests_issued",
    "checkpoint_completions",
    "checkpoint_escalations",
    "checkpoint_escalations_total",
    "checkpoints_completed_total",
    "checkpoint_restores_verified_total",
    "checkpoint_restore_escalations_total",
)
GANG_NODES = ("gang-node-0", "gang-node-1")
#: The quarantine phase's pool: the monitored node, whose reports it
#: replays, and three more; and its clocks, in virtual seconds: the first
#: recheck, the backoff's cap, and the hand-off.
QUARANTINE_NODES = (MONITOR_NODE, "gpu-quar-1", "gpu-quar-2", "gpu-quar-3")
QUARANTINE_BACKOFF_S = 60
QUARANTINE_MAX_BACKOFF_S = 900
QUARANTINE_HANDOFF_S = 600
#: The informer roll: the driver's pool of two nodes in a cluster of
#: ``WATCH_POOL_NODES`` more, the settled passes after it, the audit
#: cadence, and the seconds a CRD's version waits to be discoverable.
INFORMER_NODES = ("gpu-inf-0", "gpu-inf-1")
INFORMER_OTHER_POOL = {"cloud.google.com/gke-nodepool": "cpu-pool"}
SETTLED_PASSES = 10
#: The node that joins the driver pool while the Pod stream is held.
JOIN_NODE = "gpu-inf-2"
VERIFY_EVERY_N = 5
CRD_DISCOVERY_DELAY_S = 0.2
CRDS = ("nodemaintenances.maintenance.nvidia.com", "tpuupgradepolicies.tpu-operator.dev")
#: The controller roll: its two nodes, the replicas' identities, the
#: command's interval (so long that only watch events drive the roll), the
#: lease duration the command campaigns with (client-go's default, which a
#: takeover must beat), the kubelet's tick, and the seconds a replica may
#: take to start, to lead and to stop.
CONTROLLER_NODES = ("gpu-ctl-0", "gpu-ctl-1")
CONTROLLER_IDS = ("ctl-a", "ctl-b")
CONTROLLER_INTERVAL_S = 600
LEASE_DURATION_S = 15.0
KUBELET_TICK_S = 0.2
CONTROLLER_START_S = 120.0
CONTROLLER_QUIET_S = 2.0
#: The server roll (``controller_roll_phase(..., server=True)``): its two
#: nodes, the GPU nodes beside them in the cluster (more than two of the
#: client's list pages of 500, so the command's first Node LIST comes in
#: three), their pool label, the one replica's identity, and the server's
#: bookmark interval and loop-stall threshold.
SERVER_NODES = ("gpu-srv-0", "gpu-srv-1")
SERVER_POOL_NODES = 1024
SERVER_OTHER_POOL = {"cloud.google.com/gke-nodepool": "gpu-pool"}
SERVER_ID = "ctl-srv"
SERVER_BOOKMARK_S = 1.0
SERVER_STALL_S = 0.5
TABLE_ACCEPT = "application/json;as=Table;v=v1;g=meta.k8s.io"
#: The fleet roll: one node a pool, the FleetRollout over both pools with a
#: global budget of one pool, the workers' shard count and identities (the
#: first also the orchestrator), and their interval. The pool of a node is
#: its name up to the last ``-``.
FLEET_NODES = ("fleet-a-h0", "fleet-b-h0")
FLEET_POOLS = ("fleet-a", "fleet-b")
FLEET_ROLLOUT = "gpu-fleet"
FLEET_SHARDS = 2
FLEET_IDS = ("fleet-w0", "fleet-w1")
FLEET_INTERVAL_S = 1
FLEET_LEASES = ("fleet-orchestrator", "fleet-shard-00", "fleet-shard-01")
#: The relay roll: the fleet roll's shape on pools of its own, the workers
#: watching through a ``WatchRelay`` in this process until the first pool
#: is done.
RELAY_NODES = ("relay-a-h0", "relay-b-h0")
RELAY_POOLS = ("relay-a", "relay-b")
RELAY_ROLLOUT = "gpu-relay-fleet"
RELAY_IDS = ("relay-w0", "relay-w1")
#: The in-memory phase: the demo pool's nodes (``upgrade_controller``'s
#: ``DEMO_POOL``), the seconds a demo child may take, and the nodes
#: ``fake_roll`` rolls, each on the kernel cache ``roll`` left for the
#: node of ``ROLL_NODES`` in its place.
DEMO_NODES = tuple(f"h100-pool-{i}" for i in range(4))
DEMO_TIMEOUT_S = 300
FAKE_ROLL_NODES = ("gpu-fake-0", "gpu-fake-1")
#: The port's monitor DaemonSets (package data), the seconds a pod of
#: them may take to what it is waited for, and the flapping pod's cadence.
FULL_MANIFEST = "monitor-daemonset.yaml"
QUICK_MANIFEST = "monitor-quickprobe-daemonset.yaml"
MONITOR_POD_TIMEOUT_S = 300.0
FLAP_INTERVAL_S = 0.2
#: The keys of the calibration line (``tools/calibration.py``).
CALIBRATION_KEYS = {
    "platform", "n_devices", "links_exercised", "ok", "failures", "mxu_tflops",
    "torch_matmul_tflops", "kernel_vs_torch_matmul", "matmul_kernel_launched",
    "ring_gbytes_per_s", "flash_attention_ok", "elapsed_s",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int, graph: bool = True) -> float:
    """Mean ms of one ``fn()`` on the card, from CUDA events after a
    warm-up. With ``graph``, the ``reps`` calls are captured into one CUDA
    graph and its replay is timed: the card's time for back-to-back calls,
    the host's cost per call left out. Without, the calls are made from
    Python one by one, host included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = None
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(reps):
                fn()
        captured.replay()
        torch.cuda.synchronize()
        run = captured.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if run is not None:
        run()
    else:
        for _ in range(reps):
            fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least ms the card could take, and what sets it."""
    compute_ms = flops / PEAK_BF16_FLOPS * 1e3
    memory_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    if memory_ms >= compute_ms:
        return memory_ms, "bytes"
    return compute_ms, "operations"


def kernel_phase() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from k8s_operator_libs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        split_plan,
    )
    from k8s_operator_libs_tpu_torch.ops.matmul import (
        matmul,
        matmul_path,
        matmul_reference,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (m, k, n), family in MATMUL_CASES:
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
        path = matmul_path(a, b)
        if not path.startswith(family):
            raise AssertionError(f"matmul {(m, k, n)} took {path}, not {family}")
        got = matmul(a, b)
        want = matmul_reference(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = K1_ATOL_PER_SQRT_K * math.sqrt(k)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"matmul {(m, k, n)}: max_abs_err {err} > {tol}")
        flops = 2.0 * m * k * n
        bound_ms, bound_by = bound(flops, 2 * (m * k + k * n) + 4 * m * n)
        reps = max(10, min(1000, int(2e12 / flops)))
        rows.append({
            "name": "matmul",
            "route": "cuda",
            "source": "k8s_operator_libs_tpu_torch/ops/csrc/matmul.cu",
            "replaces": "k8s_operator_libs_tpu/ops/matmul.py:32",
            "shape": [m, k, n],
            "path": path,
            "max_abs_err": err,
            "tol": tol,
            "ms": time_ms(lambda: matmul(a, b), reps),
            "call_ms": time_ms(lambda: matmul(a, b), reps, graph=False),
            "plain_ms": time_ms(lambda: matmul_reference(a, b), reps, graph=False),
            "library_ms": time_ms(lambda: torch.matmul(a, b), reps),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
    for shape, causal in FLASH_CASES:
        b_, h, s, d = shape
        q, k, v = (
            torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)
        )
        got = flash_attention(q, k, v, causal=causal).float()
        want = flash_attention_reference(q, k, v, causal=causal).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        excess = float((diff - (K2_ATOL + K2_RTOL * want.abs())).max())
        if not math.isfinite(err) or excess > 0:
            raise AssertionError(
                f"flash attention {shape} causal={causal}: max_abs_err {err} "
                f"beyond {K2_ATOL} + {K2_RTOL}*|plain|"
            )
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4.0 * d * pairs * b_ * h
        bound_ms, bound_by = bound(flops, 4 * b_ * h * s * d * 2)
        split, blocks = split_plan(b_ * h, s, causal, sms)
        reps = max(20, min(200, int(2e11 / flops)))
        rows.append({
            "name": "flash_attention_causal" if causal else "flash_attention",
            "route": "cuda",
            "source": "k8s_operator_libs_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "k8s_operator_libs_tpu/ops/flash_attention.py:44",
            "shape": list(shape),
            "split": split,
            "blocks": blocks,
            "max_abs_err": err,
            "tol": f"{K2_ATOL} + {K2_RTOL}*|plain|",
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal), reps),
            "call_ms": time_ms(
                lambda: flash_attention(q, k, v, causal=causal), reps, graph=False
            ),
            "plain_ms": time_ms(
                lambda: flash_attention_reference(q, k, v, causal=causal),
                max(5, reps // 4),
                graph=False,
            ),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                reps,
            ),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
        del q, k, v, got, want, diff
    for row in rows:
        row["kernel_ms"] = row["ms"]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return rows


def counts() -> dict:
    """Every launch count of the port, by wrapper, and K1's by kernel."""
    from k8s_operator_libs_tpu_torch.ops.flash_attention import flash_attention
    from k8s_operator_libs_tpu_torch.ops.matmul import matmul

    return {
        "matmul": matmul.launches,
        "flash_attention": flash_attention.launches,
        "matmul_by_path": dict(matmul.path_launches),
    }


def reset_counts() -> None:
    from k8s_operator_libs_tpu_torch.ops.flash_attention import flash_attention
    from k8s_operator_libs_tpu_torch.ops.matmul import matmul

    matmul.launches = 0
    matmul.path_launches.clear()
    flash_attention.launches = 0


def gate_phase(kernel_ms_at_gate_size: float) -> dict:
    import torch

    from k8s_operator_libs_tpu_torch.ops import matmul as matmul_mod
    from k8s_operator_libs_tpu_torch.ops.collectives import run_ici_probes
    from k8s_operator_libs_tpu_torch.ops.flash_attention import flash_attention_probe
    from k8s_operator_libs_tpu_torch.ops.matmul import mxu_probe
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate

    gate = IciHealthGate.tpu_defaults(device="cuda")
    reset_counts()
    report = gate.run()
    launches = counts()
    print(json.dumps({"gate_report": dataclasses.asdict(report)}), flush=True)
    if not report.ok:
        raise AssertionError(f"gate failed: {report.failures}")
    if not (report.mxu and report.mxu.tflops > 0):
        raise AssertionError("gate: no matmul throughput")
    if not (report.flash and report.flash.tokens_per_s > 0):
        raise AssertionError("gate: no flash-attention throughput")
    if not report.burnin_ok:
        raise AssertionError("gate: burn-in did not pass")
    for name in ("matmul", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"gate: the {name} kernel was never launched")
    n = gate.matmul_size
    chain = matmul_mod._auto_chain(n, True)

    # Where a warm gate run's wall time goes: each probe again, alone, on
    # the gate's own device (the matmul probe's inputs are cached by it).
    device = gate.world_devices()[0]
    world = gate._world
    breakdown = {}
    for name, probe in (
        ("collective_battery", lambda: run_ici_probes(world, payload_mb=gate.payload_mb)),
        ("mxu_probe", lambda: mxu_probe(size=n, use_pallas=True, device=device)),
        ("burnin", lambda: gate._burnin(world)),
        ("flash_attention_probe", lambda: flash_attention_probe(device=device)),
    ):
        start = time.perf_counter()
        probe()
        torch.cuda.synchronize()
        breakdown[name] = time.perf_counter() - start
    gate.close()

    # Is the timed chain bound by the host? Compare the time to enqueue one
    # replay of the captured chain with the time until it has run.
    entry = matmul_mod._probe_entry(n, torch.bfloat16, device)
    chain_graph, _ = matmul_mod._chain_graph(entry, chain, use_pallas=True)
    torch.cuda.synchronize()
    start = time.perf_counter()
    matmul_mod._replay_chain(chain_graph)
    enqueued = time.perf_counter() - start
    torch.cuda.synchronize()
    finished = time.perf_counter() - start
    info = {
        "chain_host_enqueue_us_per_link": enqueued / chain * 1e6,
        "chain_wall_us_per_link": finished / chain * 1e6,
        "kernel_us": kernel_ms_at_gate_size * 1e3,
        "launches": launches,
        "matmul_chain_links": chain,
        "matmul_launches_in_the_chain_graph": dict(chain_graph.launches),
        "matmul_expected_launches": 1 + 4 * chain,
        "chain_tflops": report.mxu.tflops,
        "kernel_tflops": 2.0 * n**3 / (kernel_ms_at_gate_size * 1e-3) / 1e12,
        "flash_tokens_per_s": report.flash.tokens_per_s,
        "elapsed_s": report.elapsed_s,
        "warm_probe_seconds": breakdown,
    }
    print(json.dumps({"gate": info}), flush=True)
    if sum(chain_graph.launches.values()) != chain:
        raise AssertionError(
            f"gate: the chain's graph holds {dict(chain_graph.launches)} launches, "
            f"not {chain}"
        )
    if launches["matmul"] != info["matmul_expected_launches"]:
        raise AssertionError(
            f"gate: matmul kernel launched {launches['matmul']} times, "
            f"expected {info['matmul_expected_launches']}"
        )
    return launches


def collectives_phase(card: str) -> dict:
    """The collective battery, the quick battery and the gate's collectives
    on an NCCL world of every card. Every line printed carries the card's
    name and power limit."""
    import torch

    from k8s_operator_libs_tpu_torch.ops import collectives
    from k8s_operator_libs_tpu_torch.ops.probe_harness import quick_battery
    from k8s_operator_libs_tpu_torch.parallel.mesh import World, available_devices
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate

    def show(key: str, value) -> None:
        print(json.dumps({key: value, "card": card}), flush=True)

    n = torch.cuda.device_count()
    version = torch.cuda.nccl.version()
    show("nccl", {
        "version": ".".join(map(str, version)) if isinstance(version, tuple) else version,
        "world_size": n,
    })
    world = World(available_devices())
    if world.backend != "nccl":
        raise AssertionError(f"a world of cards joined through {world.backend}")
    try:
        start = time.perf_counter()
        world.start()
        form_s = time.perf_counter() - start
        reports, ops = [], []
        for check in (
            collectives.psum_check,
            collectives.all_gather_check,
            collectives.reduce_scatter_check,
            collectives.ppermute_ring,
            collectives.psum_bandwidth,
        ):
            start = time.perf_counter()
            reports.append(check(world, "x"))
            ops.append({
                **dataclasses.asdict(reports[-1]),
                "call_s": time.perf_counter() - start,
            })
        show("collective_ops", {
            "world_form_s": form_s, "world_form_phases_s": world.form_times, "ops": ops,
        })
        battery = collectives.run_ici_probes(world)
        if [r.op for r in battery] != ["psum", "all_gather", "reduce_scatter", "ppermute_ring"]:
            raise AssertionError(f"battery ops: {[r.op for r in battery]}")
        failed = [f"{r.op}: {r.error}" for r in reports + battery if not r.ok]
        if failed:
            raise AssertionError(f"collective battery failed: {failed}")
        # First and warm: the first builds the 256^2 matmul probe's inputs
        # and host reference, as the first run of a periodic loop does.
        for run in ("first", "warm"):
            quick = quick_battery(world)
            show("quick_battery", {"run": run, **dataclasses.asdict(quick)})
            if not quick.ok or not {"mxu_tflops", "probe_latency_s"} <= set(quick.metrics):
                raise AssertionError(f"quick battery: {quick}")
    finally:
        world.close()

    gate = IciHealthGate.tpu_defaults()
    try:
        first, warm = gate.run(), gate.run()
        form_phases = gate._world.form_times
    finally:
        gate.close()
    info = {
        "first_elapsed_s": first.elapsed_s,
        "warm_elapsed_s": warm.elapsed_s,
        "world_form_phases_s": form_phases,
        "collectives": [dataclasses.asdict(c) for c in warm.collectives],
        "links": [dataclasses.asdict(h) for h in warm.links],
        "burnin_ok": warm.burnin_ok,
        "ring_attention": warm.ring_attention and dataclasses.asdict(warm.ring_attention),
        "ulysses": warm.ulysses and dataclasses.asdict(warm.ulysses),
    }
    show("gate_collectives", info)
    for report in (first, warm):
        if not report.ok:
            raise AssertionError(f"gate failed: {report.failures}")
        if not report.collectives or not all(c.ok for c in report.collectives):
            raise AssertionError(f"gate collectives: {report.collectives}")
    if n < 2:
        show("not_run", "the per-link tier, the ring floor, the dp x tp sharding of "
             "the burn-in (dp 1 x tp 1 here) and the ring and Ulysses probes need "
             "two or more cards; this machine has one")
    else:
        if len(warm.links) != n or not all(h.ok for h in warm.links):
            raise AssertionError(f"per-link tier: {warm.links}")
        if not (warm.ring_attention and warm.ring_attention.ok
                and warm.ulysses and warm.ulysses.ok and warm.burnin_ok):
            raise AssertionError("sharded burn-in or sequence-parallel probes failed")
    return info


def burnin_phase() -> list[float]:
    import torch

    from k8s_operator_libs_tpu_torch.models.burnin import (
        BurninConfig,
        init_params,
        synthetic_batch,
        train_step,
    )

    cfg = BurninConfig()
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg, "cuda")
    losses = []
    start = time.perf_counter()
    for _ in range(3):
        params, loss = train_step(params, batch, cfg)
        losses.append(float(loss))
    elapsed = time.perf_counter() - start
    print(json.dumps({"burnin": {"losses": losses, "seconds": elapsed}}), flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"burn-in loss not finite and falling: {losses}")
    return losses


def burnin_flash_phase() -> dict:
    import torch

    from k8s_operator_libs_tpu_torch.models.burnin import (
        BurninConfig,
        forward,
        init_params,
        synthetic_batch,
    )
    cfg = BurninConfig(use_flash_attention=True)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    tokens = synthetic_batch(torch.Generator().manual_seed(1), cfg, "cuda")["tokens"]
    reset_counts()
    got = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = counts()
    want = forward(params, tokens, BurninConfig())
    diff = (got - want).abs()
    excess = float((diff - (BURNIN_ATOL + BURNIN_RTOL * want.abs())).max())
    info = {
        "head_dim": cfg.head_dim,
        "logits_shape": list(got.shape),
        "max_abs_err": float(diff.max()),
        "tol": f"{BURNIN_ATOL} + {BURNIN_RTOL}*|plain|",
        "launches": launches,
    }
    print(json.dumps({"burnin_flash_forward": info}), flush=True)
    if not bool(torch.isfinite(got).all()) or excess > 0:
        raise AssertionError(f"burn-in flash forward disagrees with the plain core: {info}")
    if launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"burn-in flash forward: kernel launches {launches}")
    return launches


def entry_phase(card: str) -> dict:
    """The flagship model (``entry.ENTRY_CFG``) on the card: ``entry()``'s
    forward, three train steps of its widths with four experts a layer,
    and that MoE forward through the flash core, counts set to 0 just
    before. The kernel is held to its stated tolerance on each layer's
    operands; after 4 bf16 layers the logits differ from the plain core's
    by more than one kernel call's rounding, so the forward as a whole is
    held by its loss against the f32 loss on the CPU."""
    import torch

    from k8s_operator_libs_tpu_torch.ops import flash_attention as flash_mod
    from k8s_operator_libs_tpu_torch.entry import ENTRY_CFG, entry
    from k8s_operator_libs_tpu_torch.models.burnin import (
        _leaves,
        _rebuild,
        forward,
        init_params,
        loss_fn,
        synthetic_batch,
        train_step,
    )

    def cpu_f32_loss(params, batch, cfg) -> float:
        """The reference: the same parameters and tokens in f32 on the CPU."""
        host = _rebuild(params, [p.float().cpu() for p in _leaves(params)])
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        return float(loss_fn(host, {k: t.cpu() for k, t in batch.items()}, f32))

    fn, (params, tokens) = entry()
    forward_s = []
    for _ in range(2):
        start = time.perf_counter()
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        forward_s.append(time.perf_counter() - start)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=-1)}
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, ENTRY_CFG.vocab), batch["targets"].reshape(-1)
    )
    entry_loss, entry_ref = float(nll), cpu_f32_loss(params, batch, ENTRY_CFG)

    moe = dataclasses.replace(ENTRY_CFG, n_experts=4)
    params = init_params(torch.Generator().manual_seed(0), moe, "cuda")
    batch = synthetic_batch(torch.Generator().manual_seed(1), moe, "cuda")
    moe_ref = cpu_f32_loss(params, batch, moe)
    losses, step_s, p = [], [], params
    for _ in range(3):
        start = time.perf_counter()
        p, loss = train_step(p, batch, moe)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)

    # The MoE forward through the flash kernel; each call's inputs and
    # output are kept, to hold the kernel against its plain version on the
    # very operands this path gives it. The model finds the wrapper by the
    # module's name, and the wrapper counts its launches under that name,
    # so the name is the wrapper's own while it runs.
    flash = dataclasses.replace(moe, use_flash_attention=True)
    kernel, calls = flash_mod.flash_attention, []

    def recorded(q, k, v, causal=True):
        flash_mod.flash_attention = kernel
        try:
            out = kernel(q, k, v, causal)
        finally:
            flash_mod.flash_attention = recorded
        calls.append((q, k, v, out))
        return out

    reset_counts()
    flash_mod.flash_attention = recorded
    try:
        start = time.perf_counter()
        got = forward(params, batch["tokens"], flash)
        torch.cuda.synchronize()
        flash_s = time.perf_counter() - start
    finally:
        flash_mod.flash_attention = kernel
    launches = counts()
    layer_errs, layer_excess = [], []
    for q, k, v, out in calls:
        ref = flash_mod.flash_attention_reference(q, k, v).float()
        err = (out.float() - ref).abs()
        layer_errs.append(float(err.max()))
        layer_excess.append(float((err - (K2_ATOL + K2_RTOL * ref.abs())).max()))
    want = forward(params, batch["tokens"], moe)
    diff = (got - want).abs()
    flash_nll = torch.nn.functional.cross_entropy(
        got.reshape(-1, moe.vocab), batch["targets"].reshape(-1)
    )
    flash_loss = float(flash_nll)
    info = {
        "cfg": {k: getattr(ENTRY_CFG, k) for k in
                ("vocab", "d_model", "n_heads", "d_ff", "n_layers", "seq_len", "batch")},
        "forward_s": forward_s,
        "logits_shape": list(logits.shape),
        "loss": entry_loss,
        "cpu_f32_loss": entry_ref,
        "moe": {"n_experts": moe.n_experts, "losses": losses, "cpu_f32_loss": moe_ref,
                "step_s": step_s},
        "flash_forward": {"seconds": flash_s, "launches": launches,
                          "kernel_max_abs_err_by_layer": layer_errs,
                          "kernel_tol": f"{K2_ATOL} + {K2_RTOL}*|plain|",
                          "loss": flash_loss,
                          "logits_max_abs_diff_to_plain_core": float(diff.max())},
    }
    print(json.dumps({"entry": info, "card": card}), flush=True)
    if tuple(logits.shape) != (ENTRY_CFG.batch, ENTRY_CFG.seq_len, ENTRY_CFG.vocab) or not bool(
        torch.isfinite(logits).all()
    ):
        raise AssertionError(f"entry forward: logits {tuple(logits.shape)} not finite or shaped")
    for name, ours, ref in (("entry", entry_loss, entry_ref), ("moe", losses[0], moe_ref)):
        if not abs(ours - ref) <= CARD_VS_CPU_REL * abs(ref):
            raise AssertionError(f"{name} loss {ours} on the card, {ref} in f32 on the CPU")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE train step loss not finite and falling: {losses}")
    if not bool(torch.isfinite(got).all()) or any(x > 0 for x in layer_excess):
        raise AssertionError(f"MoE flash forward: the kernel is off its plain version: {info}")
    if not abs(flash_loss - moe_ref) <= CARD_VS_CPU_REL * abs(moe_ref):
        raise AssertionError(f"MoE flash forward loss {flash_loss}, {moe_ref} in f32 on the CPU")
    if len(calls) != moe.n_layers or launches["flash_attention"] != moe.n_layers \
            or launches["matmul"] != 0:
        raise AssertionError(f"MoE flash forward: kernel launches {launches}")
    return info


def flagship_layouts(n: int) -> list[dict]:
    """The MoE flagship's sharded layouts over a world of ``n`` cards: the
    one card's own, else the expert and tensor axes, tensor and sequence
    (ring and Ulysses), and the pipeline with dp."""
    if n == 1:
        return [{"axes": {"dp": 1}}]
    if n % 4 == 0:
        dp = n // 4
        return [
            {"axes": {"dp": dp, "ep": 2, "tp": 2}},
            {"axes": {"dp": dp, "tp": 2, "sp": 2}, "sp_impl": "ring"},
            {"axes": {"dp": dp, "tp": 2, "sp": 2}, "sp_impl": "ulysses"},
            {"axes": {"dp": n // 2, "pp": 2}, "n_microbatches": 2},
        ]
    dp = n // 2
    return [
        {"axes": {"dp": dp, "ep": 2}},
        {"axes": {"dp": dp, "sp": 2}, "sp_impl": "ring"},
        {"axes": {"dp": dp, "sp": 2}, "sp_impl": "ulysses"},
        {"axes": {"dp": dp, "pp": 2}, "n_microbatches": 2},
    ]


def dryrun_phase(card: str) -> dict:
    """``dryrun_multichip`` on an NCCL world of every card, two steps each
    program, then the MoE flagship's sharded step over the world's layouts,
    its first loss held against the unsharded step's on the card."""
    import torch

    from k8s_operator_libs_tpu_torch.entry import ENTRY_CFG, dryrun_multichip, timed_steps
    from k8s_operator_libs_tpu_torch.models.burnin import init_params, loss_fn, synthetic_batch
    from k8s_operator_libs_tpu_torch.parallel.mesh import World, available_devices

    def show(key: str, value) -> None:
        print(json.dumps({key: value, "card": card}), flush=True)

    n = torch.cuda.device_count()
    moe = dataclasses.replace(ENTRY_CFG, n_experts=4)
    unsharded = float(loss_fn(
        init_params(torch.Generator().manual_seed(0), moe, "cuda"),
        synthetic_batch(torch.Generator().manual_seed(1), moe, "cuda"),
        moe,
    ))
    world = World(available_devices())
    if world.backend != "nccl":
        raise AssertionError(f"a world of cards joined through {world.backend}")
    try:
        start = time.perf_counter()
        world.start()
        form_s = time.perf_counter() - start
        programs = dryrun_multichip(world, steps=2)
        show("dryrun_multichip", {"world_size": n, "world_form_s": form_s, "programs": programs})
        flagship = []
        for layout in flagship_layouts(n):
            per_rank = world.run(
                timed_steps, layout["axes"], moe, 2, layout.get("sp_impl", "ring"),
                layout.get("n_microbatches"),
            )
            result = {
                **layout,
                "losses": per_rank[0]["losses"],
                "seconds": [max(r["seconds"][i] for r in per_rank) for i in range(2)],
                "same_on_every_rank": all(r["losses"] == per_rank[0]["losses"] for r in per_rank),
            }
            flagship.append(result)
            show("dryrun_flagship", {"unsharded_loss": unsharded, **result})
    finally:
        world.close()
    for program in programs:
        if not all(math.isfinite(x) for x in program["losses"]):
            raise AssertionError(f"dryrun program {program['name']}: {program['losses']}")
    for result in flagship:
        first = result["losses"][0]
        if not (result["same_on_every_rank"] and all(math.isfinite(x) for x in result["losses"])
                and abs(first - unsharded) <= SHARDED_REL * abs(unsharded)):
            raise AssertionError(f"MoE flagship sharded step: {result}, unsharded {unsharded}")
    if n < 2:
        show("not_run", "the ep, tp, sp and pp axes and dp > 1 need two or more cards, "
             "and the dry run's expert and pipeline programs four and two; this machine "
             "has one card, so each program ran at every axis 1")
    return {"programs": programs, "flagship": flagship}


def cli_phase() -> None:
    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.tpu.health",
         "--pallas-matmul", "--flash-attention", "--matmul-size", "1024"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(
            f"CLI printed no report (rc {proc.returncode}): {proc.stderr[-2000:]}"
        )
    report = HealthReport.from_dict(json.loads(lines[-1]))
    print(json.dumps({"cli": {"rc": proc.returncode, "summary": report.summary()}}),
          flush=True)
    if proc.returncode != 0 or not report.ok:
        raise AssertionError(f"CLI gate failed: {report.failures}")


def _last_json(path: str, key: str = "") -> dict:
    with open(path) as f:
        for line in reversed(f.read().splitlines()):
            if line.startswith("{") and (not key or key in json.loads(line)):
                return json.loads(line)
    raise AssertionError(f"no JSON line{' with ' + key if key else ''} in {path}")


def run_probe_pod(container: dict, host_paths: dict, workdir: str, label: str) -> dict:
    """Run the pod's container command as the kubelet would, until its ready
    file appears; check it parked; stop it. ``host_paths`` maps a hostPath
    the pod mounts to the directory that stands for it here."""
    import signal

    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    argv = list(container["command"])
    argv[0] = sys.executable
    ready = os.path.join(workdir, f"{label}.ready")
    argv[argv.index("--ready-file") + 1] = ready
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for item in container["env"]:
        env[item["name"]] = host_paths.get(item["value"], item["value"])
    out_path = os.path.join(workdir, f"{label}.out")
    err_path = os.path.join(workdir, f"{label}.err")
    with open(out_path, "w") as out, open(err_path, "w") as err:
        start = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=workdir, env=env, stdout=out, stderr=err,
                                start_new_session=True)
        try:
            while not os.path.exists(ready):
                if proc.poll() is not None:
                    with open(err_path) as f:
                        tail = f.read()[-3000:]
                    raise AssertionError(
                        f"{label} probe pod exited {proc.returncode} before Ready: {tail}"
                    )
                if time.perf_counter() - start > POD_READY_TIMEOUT_S:
                    raise AssertionError(
                        f"{label} probe pod not Ready within {POD_READY_TIMEOUT_S} s"
                    )
                time.sleep(0.05)
            seconds_to_ready = time.perf_counter() - start
            time.sleep(1.0)
            parked = proc.poll() is None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
    report = HealthReport.from_dict(_last_json(out_path))
    kernels = _last_json(err_path, "kernels")["kernels"]
    if not parked:
        raise AssertionError(f"{label} probe pod did not park after its pass")
    if not (report.ok and report.mxu and report.mxu.ok and report.flash and report.flash.ok):
        raise AssertionError(f"{label} probe pod report: {report.summary()}")
    return {
        "seconds_to_ready": seconds_to_ready,
        "elapsed_s": report.elapsed_s,
        "mxu_tflops": report.mxu.tflops,
        "flash_ok": report.flash.ok,
        "flash_tokens_per_s": report.flash.tokens_per_s,
        "build_s": kernels["build_s"],
        "launches": kernels["launches"],
    }


def device_class_phase(card: str, gate_launches: dict) -> dict:
    """The GPU node's labels, detection and probe pod, and the pod's
    payload run cold and warm on one kernel cache."""
    import torch

    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.detector import TpuNodeDetector
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
        ValidationPodManager,
        ValidationPodSpec,
    )

    count = torch.cuda.device_count()
    node = Node.new("gpu-node-0", labels=local_gpu_labels())
    info = TpuNodeDetector().detect(node)
    if info is None or info.chips != count:
        raise AssertionError(f"detector on {node.labels}: {info}")
    # The default spec: the pod asks for the node's own count, not the
    # spec's 8 cards.
    spec = ValidationPodSpec()
    manager = ValidationPodManager(None, spec)
    (container,) = manager.build_pod(node.name, manager.cards(node)).spec["containers"]
    limits = container["resources"]["limits"]
    if limits != {"nvidia.com/gpu": str(count)}:
        raise AssertionError(f"probe pod limits: {limits}")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="probe-pod-") as workdir:
        host_paths = {spec.compile_cache_dir: os.path.join(workdir, "kernel-cache")}
        for label in ("cold", "warm"):
            runs[label] = run_probe_pod(container, host_paths, workdir, label)
    result = {
        "node_labels": node.labels,
        "product": info.topology.accelerator,
        "chips": info.chips,
        "slice_id": info.slice_id,
        "limits": limits,
        "command": container["command"],
        **runs,
    }
    print(json.dumps({"device_class": result, "card": card}), flush=True)
    cold, warm = runs["cold"], runs["warm"]
    if not all(cold["build_s"].get(lib, 0.0) > 0 for lib in ("matmul", "flash_attention")):
        raise AssertionError(f"the cold pod did not build both kernels: {cold['build_s']}")
    if any(warm["build_s"].values()):
        raise AssertionError(f"the warm pod built again: {warm['build_s']}")
    for label, run in runs.items():
        for lib in ("matmul", "flash_attention"):
            if run["launches"][lib] != gate_launches[lib]:
                raise AssertionError(
                    f"{label} probe pod launched {lib} {run['launches'][lib]} times, "
                    f"the gate phase {gate_launches[lib]}"
                )
    return result


# ----------------------------------------------------------------------
# The monitor and the slice gang.
# ----------------------------------------------------------------------

class DictClient:
    """The operator's client, as far as the monitor, the report publisher,
    the state machine and the informer use it, over dicts: Node, Pod,
    Event, NodeHealthReport, DaemonSet, ControllerRevision and
    NodeMaintenance, resourceVersions checked on update, errors with the
    API's reasons; an eviction deletes the pod (no disruption budget guards
    it). Finalizers hold a deleted object as the API server does: the
    delete sets its ``deletionTimestamp``, and the write that empties its
    finalizers removes it. Lists and watches select through the port's
    ``kube/selectors.py``. Every write appends ``(rv, type, object, old
    object)`` to a journal that ``watch`` streams from: resumed after a
    revision, an object that leaves a watch's selectors arriving as
    DELETED; a revision older than ``compact`` left raises the port's
    ``WatchExpiredError``. A write that changes nothing is no write, as on
    the API server: no new revision, no event. Watches serve no
    bookmarks."""

    CLUSTER_SCOPED = ("Node", "NodeHealthReport", "FleetRollout")

    def __init__(self) -> None:
        self.objects: dict[tuple, dict] = {}
        self.version = 0
        self.lock = threading.Lock()
        self.changed = threading.Condition(self.lock)
        self.journal: list[tuple] = []
        #: The journal holds no entry at or below this revision.
        self.compacted = 0
        #: Watch windows opened, by kind.
        self.windows: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        #: Seconds after a CRD write before a newly served version is
        #: discoverable, and when each (CRD, version) becomes so.
        self.discovery_delay_s = 0.0
        self.discoverable_at: dict[tuple, float] = {}

    def _call(self, verb: str) -> None:
        self.calls[verb] = self.calls.get(verb, 0) + 1

    def discover(self, group: str, version: str) -> list:
        """The resources served under ``group/version`` (the core group
        when ``group`` is empty); NotFound while none is discoverable."""
        from k8s_operator_libs_tpu_torch.kube.client import NotFoundError

        with self.lock:
            self._call("discover")
            if not group:
                if version != "v1":
                    raise NotFoundError(f"no resources discoverable for {version}")
                return [{"name": n, "kind": k, "namespaced": ns} for n, k, ns in self.CORE]
            now = time.monotonic()
            out = []
            for (kind, _, name), raw in sorted(self.objects.items()):
                spec = raw.get("spec") or {}
                if kind != "CustomResourceDefinition" or spec.get("group") != group:
                    continue
                at = self.discoverable_at.get((name, version))
                if at is not None and now >= at:
                    names = spec.get("names") or {}
                    out.append({"name": names.get("plural", ""), "kind": names.get("kind", ""),
                                "namespaced": spec.get("scope") == "Namespaced"})
            if not out:
                raise NotFoundError(f"no resources discoverable for {group}/{version}")
            return out

    def _served(self, key: tuple, raw: Optional[dict]) -> None:
        """Keep a CRD's discoverable versions (lock held): a version it
        newly serves becomes discoverable after the delay; a deleted CRD
        leaves discovery."""
        if key[0] != "CustomResourceDefinition":
            return
        name = key[2]
        served = set() if raw is None else {
            v.get("name") for v in (raw.get("spec") or {}).get("versions") or []
            if v.get("served")
        }
        for entry in [e for e in self.discoverable_at if e[0] == name and e[1] not in served]:
            del self.discoverable_at[entry]
        for version in served:
            self.discoverable_at.setdefault(
                (name, version), time.monotonic() + self.discovery_delay_s
            )

    def _key(self, kind: str, name: str, namespace: str) -> tuple:
        return (kind, "" if kind in self.CLUSTER_SCOPED else namespace or "default", name)

    def _stored(self, key: tuple) -> dict:
        from k8s_operator_libs_tpu_torch.kube.client import NotFoundError

        if key not in self.objects:
            raise NotFoundError(f"{key[0]} {key[2]} not found")
        return self.objects[key]

    def _record(self, event: str, key: tuple, raw: dict, old: Optional[dict]) -> None:
        from k8s_operator_libs_tpu_torch.kube.objects import deep_copy_json
        from k8s_operator_libs_tpu_torch.utils import tracing

        # The write's trace, by revision, as an API server's choke point
        # keeps it: the informer's delivery of it joins that trace.
        tracing.record_write_origin(self.version)
        self.journal.append((self.version, event, key, deep_copy_json(raw), old))
        self.changed.notify_all()

    def _put(self, key: tuple, raw: dict):
        from k8s_operator_libs_tpu_torch.kube.objects import wrap

        old = self.objects.get(key)
        if old is not None:
            raw["metadata"]["resourceVersion"] = old["metadata"]["resourceVersion"]
            if raw == old:
                return wrap(json.loads(json.dumps(old)))
        self.version += 1
        raw["metadata"]["resourceVersion"] = str(self.version)
        if raw["metadata"].get("deletionTimestamp") and not raw["metadata"].get("finalizers"):
            self.objects.pop(key, None)  # the last finalizer is gone
            self._served(key, None)
            self._record("DELETED", key, raw, old)
        else:
            self.objects[key] = raw
            self._served(key, raw)
            self._record("ADDED" if old is None else "MODIFIED", key, raw, old)
        return wrap(json.loads(json.dumps(raw)))

    def get(self, kind: str, name: str, namespace: str = ""):
        from k8s_operator_libs_tpu_torch.kube.objects import wrap

        with self.lock:
            self._call("get")
            return wrap(json.loads(json.dumps(self._stored(self._key(kind, name, namespace)))))

    @staticmethod
    def _selectors(label_selector, field_selector):
        from k8s_operator_libs_tpu_torch.kube.selectors import (
            LabelSelector,
            parse_field_selector,
            parse_selector,
        )

        if isinstance(label_selector, dict):
            labels = LabelSelector.from_match_labels(label_selector)
        else:
            labels = parse_selector(label_selector)
        return labels, parse_field_selector(field_selector)

    @staticmethod
    def _selected(raw: Optional[dict], selectors) -> bool:
        labels, fields = selectors
        return (
            raw is not None
            and labels.matches(raw["metadata"].get("labels"))
            and fields.matches(raw)
        )

    def list_with_revision(self, kind: str, namespace: str = "", label_selector=None,
                           field_selector=None):
        """``list`` and the revision a watch resumes from after it."""
        from k8s_operator_libs_tpu_torch.kube.objects import wrap

        selectors = self._selectors(label_selector, field_selector)
        out = []
        with self.lock:
            for (k, ns, _), raw in sorted(self.objects.items()):
                if k != kind or (namespace and ns != namespace):
                    continue
                if self._selected(raw, selectors):
                    out.append(wrap(json.loads(json.dumps(raw))))
            return out, str(self.version)

    def list(self, kind: str, namespace: str = "", label_selector=None, field_selector=None):
        with self.lock:
            self._call("list")
        return self.list_with_revision(kind, namespace, label_selector, field_selector)[0]

    def watch(self, kind: str, namespace: str = "", label_selector=None, field_selector=None,
              timeout_seconds=None, resource_version=None, handle=None,
              allow_bookmarks: bool = False):
        """The journal's events after ``resource_version`` (after now
        without one) for ``kind`` in ``namespace`` within the selectors,
        until ``timeout_seconds`` (the client's default window without
        one) pass or ``handle`` is cancelled."""
        from k8s_operator_libs_tpu_torch.kube.client import WatchExpiredError
        from k8s_operator_libs_tpu_torch.kube.objects import deep_copy_json, wrap
        from k8s_operator_libs_tpu_torch.kube.rest import DEFAULT_WATCH_TIMEOUT_SECONDS

        selectors = self._selectors(label_selector, field_selector)
        if timeout_seconds is None:
            timeout_seconds = DEFAULT_WATCH_TIMEOUT_SECONDS
        deadline = time.monotonic() + timeout_seconds
        with self.lock:
            self.windows[kind] = self.windows.get(kind, 0) + 1
            since = int(resource_version) if resource_version else self.version
        while not (handle is not None and handle.cancelled):
            with self.changed:
                if since < self.compacted:
                    raise WatchExpiredError(
                        f"resourceVersion {since} is older than the journal, "
                        f"compacted through {self.compacted}"
                    )
                first = len(self.journal)
                while first > 0 and self.journal[first - 1][0] > since:
                    first -= 1
                batch = self.journal[first:]
                if not batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    self.changed.wait(min(remaining, 0.1))
                    continue
            for rv, event, (k, ns, _), raw, old in batch:
                since = rv
                if k != kind or (namespace and ns != namespace):
                    continue
                now_in, was_in = self._selected(raw, selectors), self._selected(old, selectors)
                if event == "DELETED":
                    event = "DELETED" if now_in or was_in else ""
                elif now_in:
                    event = "MODIFIED" if was_in else "ADDED"
                else:
                    event = "DELETED" if was_in else ""
                if event:
                    yield event, wrap(deep_copy_json(raw))

    def compact(self) -> int:
        """Drop the whole journal; a watch from any earlier revision than
        now raises ``WatchExpiredError``. The revision compacted through."""
        with self.lock:
            self.journal.clear()
            self.compacted = self.version
            return self.compacted

    def create(self, obj):
        from k8s_operator_libs_tpu_torch.kube.client import AlreadyExistsError

        raw = json.loads(json.dumps(obj.raw))
        key = self._key(raw["kind"], raw["metadata"]["name"], raw["metadata"].get("namespace", ""))
        with self.lock:
            self._call("create")
            if key in self.objects:
                raise AlreadyExistsError(f"{key[0]} {key[2]} already exists")
            raw["metadata"]["uid"] = f"uid-{self.version + 1}"
            return self._put(key, raw)

    def _replace(self, obj, status_only: bool):
        from k8s_operator_libs_tpu_torch.kube.client import ConflictError

        raw = json.loads(json.dumps(obj.raw))
        key = self._key(raw["kind"], raw["metadata"]["name"], raw["metadata"].get("namespace", ""))
        with self.lock:
            self._call("update")
            stored = self._stored(key)
            rv = raw["metadata"].get("resourceVersion")
            if rv and rv != stored["metadata"]["resourceVersion"]:
                raise ConflictError(f"{key[0]} {key[2]}: stale resourceVersion {rv}")
            if status_only:
                stored = json.loads(json.dumps(stored))
                stored["status"] = raw.get("status") or {}
                raw = stored
            else:
                # The server owns the uid and the deletion mark: an update
                # keeps them.
                raw["metadata"]["uid"] = stored["metadata"].get("uid")
                raw["metadata"].pop("deletionTimestamp", None)
                if stored["metadata"].get("deletionTimestamp"):
                    raw["metadata"]["deletionTimestamp"] = stored["metadata"]["deletionTimestamp"]
            return self._put(key, raw)

    def update(self, obj):
        return self._replace(obj, status_only=False)

    def update_status(self, obj):
        return self._replace(obj, status_only=True)

    def patch(self, kind: str, name: str, namespace: str = "", patch=None, patch_type="merge"):
        def merge(target: dict, change: dict) -> None:
            for k, v in change.items():
                if v is None:
                    target.pop(k, None)
                elif isinstance(v, dict) and isinstance(target.get(k), dict):
                    merge(target[k], v)
                else:
                    target[k] = v

        key = self._key(kind, name, namespace)
        with self.lock:
            self._call("patch")
            raw = json.loads(json.dumps(self._stored(key)))
            merge(raw, patch or {})
            return self._put(key, raw)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        from k8s_operator_libs_tpu_torch.kube.objects import rfc3339_now

        key = self._key(kind, name, namespace)
        with self.lock:
            self._call("delete")
            meta = self._stored(key)["metadata"]
            if not meta.get("finalizers"):
                old = self.objects.pop(key)
                self._served(key, None)
                self.version += 1
                gone = json.loads(json.dumps(old))
                gone["metadata"]["resourceVersion"] = str(self.version)
                self._record("DELETED", key, gone, old)
            elif not meta.get("deletionTimestamp"):
                raw = json.loads(json.dumps(self.objects[key]))
                raw["metadata"]["deletionTimestamp"] = rfc3339_now()
                self._put(key, raw)

    def evict(self, pod_name: str, namespace: str = "") -> None:
        self.delete("Pod", pod_name, namespace)

class ApiStub(ThreadingHTTPServer):
    """A ``DictClient`` behind the API's REST paths on 127.0.0.1, for the
    port's ``RestClient`` in a child process (the payload's
    ``--publish-report``, the CRD utility's command line, the
    ``upgrade_controller`` command): GET (an object, or a list with its
    label and field selectors and its resourceVersion), POST, PUT
    (``/status`` too), PATCH (merge and strategic merge, which agree on
    the maps the machine writes) and DELETE of an object, a pod's
    ``eviction`` subresource, the discovery documents ``/api/v1`` and
    ``/apis/<group>/<version>``, and ``?watch=true``: the client's journal
    streamed after ``resourceVersion`` as chunked frames, ended after
    ``timeoutSeconds`` by the terminal chunk; a revision compacted away is
    a 410 ``Status``. HTTP/1.1: every reply has its ``Content-Length`` (a
    watch window its chunks), so a connection stays open for the next
    request or window, pipelined ones included. A request whose ``Accept``
    lists the compact encoding (``kube/wire.py``) is answered compact, and
    a compact body is read by its ``Content-Type``. It neither pages a
    list nor serves ``sinceResourceVersion``: a list is always whole,
    which the client takes as an older server's answer. Each request's
    method and path are logged in ``requests``, for the RBAC check of the
    monitor's pods; the watch streams open on each (plural, namespace,
    label selector, field selector) are counted in ``watch_open``, with
    their high-water mark in ``watch_high`` and the streams ever opened in
    ``watch_opens``."""

    daemon_threads = True
    request_queue_size = 128
    DISCOVERY = re.compile(
        r"^/(?:api/(?P<core>[^/?]+)|apis/(?P<group>[^/?]+)/(?P<version>[^/?]+))$"
    )
    PATH = re.compile(
        r"^/(?:api/v1|apis/[^/]+/[^/]+)(?:/namespaces/(?P<ns>[^/]+))?"
        r"/(?P<plural>[^/?]+)(?:/(?P<name>[^/?]+))?(?:/(?P<sub>status|eviction))?$"
    )
    CODES = {"NotFound": 404, "AlreadyExists": 409, "Conflict": 409, "Expired": 410,
             "Invalid": 422, "UnsupportedMediaType": 415}

    def __init__(self, client: DictClient) -> None:
        import urllib.parse

        from k8s_operator_libs_tpu_torch.kube import wire
        from k8s_operator_libs_tpu_torch.kube.resources import _REGISTRY

        kinds = {info.plural: kind for kind, info in _REGISTRY.items()}
        stub = self
        #: Every request served: (method, path with its query).
        self.requests: list[tuple[str, str]] = []
        self.watch_lock = threading.Lock()
        #: Watch streams open now, and the most open at once, by scope.
        self.watch_open: dict[tuple, int] = {}
        self.watch_high: dict[tuple, int] = {}
        self.watch_opens: dict[tuple, int] = {}

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _serve(self) -> None:
                stub.requests.append((self.command, self.path))
                url = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(url.query))
                m = stub.PATH.match(url.path)
                d = stub.DISCOVERY.match(url.path)
                self.encoding = wire.negotiate_encoding(self.headers.get("Accept"))
                length = int(self.headers.get("Content-Length") or 0)
                body = (wire.decode_body(self.rfile.read(length), self.headers.get("Content-Type"))
                        if length else None)
                try:
                    if d is not None and self.command == "GET":
                        group = d.group("group") or ""
                        version = d.group("core") or d.group("version")
                        out = {"kind": "APIResourceList",
                               "groupVersion": f"{group}/{version}" if group else version,
                               "resources": client.discover(group, version)}
                    elif (self.command == "GET" and query.get("watch") == "true"
                          and m is not None and not m.group("name")):
                        self._watch(m.group("plural"), m.group("ns") or "", query)
                        return
                    else:
                        out = self._object(m, body, query)
                    code = 200
                except Exception as e:  # noqa: BLE001 - answered as the API does
                    reason = getattr(e, "reason", "BadRequest")
                    code = stub.CODES.get(reason, 400)
                    out = {"kind": "Status", "reason": reason, "message": str(e), "code": code}
                self._reply(code, out)

            def _reply(self, code: int, out: dict) -> None:
                data = wire.encode_body(out, self.encoding)
                self.send_response(code)
                self.send_header("Content-Type", wire.content_type_for(self.encoding))
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _chunk(self, event: dict) -> None:
                frame = wire.encode_watch_frame(event, self.encoding)
                self.wfile.write(b"%x\r\n%s\r\n" % (len(frame), frame))

            def _watch(self, plural: str, ns: str, query: dict) -> None:
                """The journal's events as chunked frames; the terminal
                chunk ends the window and the connection stays open."""
                rv = query.get("resourceVersion") or None
                if rv is not None and int(rv) < client.compacted:
                    self._reply(410, {"kind": "Status", "reason": "Expired", "code": 410,
                                      "message": f"resourceVersion {rv} is compacted"})
                    return
                scope = (plural, ns, query.get("labelSelector", ""), query.get("fieldSelector", ""))
                events = client.watch(
                    kinds[plural], ns, label_selector=query.get("labelSelector") or None,
                    field_selector=query.get("fieldSelector") or None,
                    timeout_seconds=int(query.get("timeoutSeconds") or 300),
                    resource_version=rv,
                )
                self.send_response(200)
                self.send_header("Content-Type", wire.content_type_for(self.encoding))
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                stub.watch_opened(scope)
                try:
                    try:
                        for event, obj in events:
                            self._chunk({"type": event, "object": obj.raw})
                    except OSError:
                        self.close_connection = True
                        return  # the watcher went away
                    except Exception as e:  # noqa: BLE001 - an ERROR frame, as the API sends
                        reason = getattr(e, "reason", "InternalError")
                        self._chunk({"type": "ERROR", "object": {
                            "kind": "Status", "reason": reason, "message": str(e),
                            "code": stub.CODES.get(reason, 500)}})
                finally:
                    # Closed before the terminal chunk: the watcher may
                    # open its next window at once.
                    stub.watch_closed(scope)
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    self.close_connection = True

            def _object(self, m, body, query) -> dict:
                from k8s_operator_libs_tpu_torch.kube.client import ApiError
                from k8s_operator_libs_tpu_torch.kube.objects import wrap

                kind = kinds[m.group("plural")]
                ns, name, sub = m.group("ns") or "", m.group("name") or "", m.group("sub")
                if self.command == "GET" and name:
                    return client.get(kind, name, ns).raw
                if self.command == "GET":
                    with client.lock:
                        client._call("list")
                    items, rv = client.list_with_revision(
                        kind, ns, query.get("labelSelector") or None,
                        query.get("fieldSelector") or None,
                    )
                    return {"items": [o.raw for o in items], "metadata": {"resourceVersion": rv}}
                if self.command == "POST" and sub == "eviction":
                    client.evict(name, ns)
                    return {"kind": "Status", "status": "Success"}
                if self.command == "POST":
                    return client.create(wrap(body)).raw
                if self.command == "PUT":
                    return client._replace(wrap(body), sub == "status").raw
                if self.command == "PATCH":
                    if "json-patch" in (self.headers.get("Content-Type") or ""):
                        error = ApiError("JSON patches are not served here")
                        error.reason = "UnsupportedMediaType"
                        raise error
                    return client.patch(kind, name, ns, patch=body).raw
                if self.command == "DELETE":
                    client.delete(kind, name, ns)
                    return {"kind": "Status", "status": "Success"}
                raise ValueError(f"{self.command} is not served here")

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _serve

            def log_message(self, fmt, *args):  # noqa: D102
                pass

        super().__init__(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.serve_forever, daemon=True)

    def watch_opened(self, scope: tuple) -> None:
        with self.watch_lock:
            self.watch_open[scope] = self.watch_open.get(scope, 0) + 1
            self.watch_opens[scope] = self.watch_opens.get(scope, 0) + 1
            self.watch_high[scope] = max(self.watch_high.get(scope, 0), self.watch_open[scope])

    def watch_closed(self, scope: tuple) -> None:
        with self.watch_lock:
            self.watch_open[scope] -= 1

    def watch_marks(self, restart: bool = False) -> dict:
        """The high-water mark of each scope's open streams, as
        ``plural ns label field`` -> count; ``restart`` starts the next
        marks from the streams open now."""
        with self.watch_lock:
            marks = {" ".join(scope): n for scope, n in sorted(self.watch_high.items())}
            if restart:
                self.watch_high = dict(self.watch_open)
        return marks

    def watch_opens_by_scope(self) -> dict:
        """The streams ever opened on each scope, keyed as ``watch_marks``."""
        with self.watch_lock:
            return {" ".join(scope): n for scope, n in sorted(self.watch_opens.items())}

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server_address[1]}"

    def __enter__(self) -> "ApiStub":
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        self.server_close()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def child_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def payload_lines(stderr: str) -> dict:
    """The payload's stderr line of kernel builds, launches and world."""
    for line in reversed(stderr.splitlines()):
        if line.startswith("{") and "kernels" in line:
            return json.loads(line)
    raise AssertionError(f"no kernels line on the payload's stderr: {stderr[-2000:]}")


def check_launches(label: str, launches: dict, gate_launches: dict) -> None:
    for lib in ("matmul", "flash_attention"):
        if launches[lib] != gate_launches[lib]:
            raise AssertionError(
                f"{label} launched {lib} {launches[lib]} times, the gate phase "
                f"{gate_launches[lib]}"
            )


def pool_node(name: str, labels: dict):
    """A Node as a GPU host's kubelet reports it (labels, capacity,
    conditions, node info, addresses, images): about 2.6 KB of JSON."""
    from k8s_operator_libs_tpu_torch.kube.objects import Node

    gpus = labels.get("nvidia.com/gpu.count", "1")
    node = Node.new(name, labels={
        **labels,
        "kubernetes.io/hostname": name,
        "kubernetes.io/os": "linux",
        "kubernetes.io/arch": "amd64",
        "node.kubernetes.io/instance-type": "gpu-8x",
        "topology.kubernetes.io/zone": "zone-a",
    })
    resources = {"cpu": "208", "memory": "2113389068Ki", "ephemeral-storage": "3748905412Ki",
                 "hugepages-2Mi": "0", "nvidia.com/gpu": gpus, "pods": "110"}
    stamp = "2026-01-01T00:00:00Z"
    node.raw["spec"] = {"podCIDR": "10.64.0.0/24", "providerID": f"gce://fleet/zone-a/{name}"}
    node.raw["status"] = {
        "capacity": dict(resources),
        "allocatable": dict(resources),
        "conditions": [
            {"type": kind, "status": status, "reason": reason, "message": message,
             "lastHeartbeatTime": stamp, "lastTransitionTime": stamp}
            for kind, status, reason, message in (
                ("MemoryPressure", "False", "KubeletHasSufficientMemory",
                 "kubelet has sufficient memory available"),
                ("DiskPressure", "False", "KubeletHasNoDiskPressure",
                 "kubelet has no disk pressure"),
                ("PIDPressure", "False", "KubeletHasSufficientPID",
                 "kubelet has sufficient PID available"),
                ("Ready", "True", "KubeletReady", "kubelet is posting ready status"),
            )
        ],
        "addresses": [{"type": "InternalIP", "address": "10.128.0.2"},
                      {"type": "Hostname", "address": name}],
        "daemonEndpoints": {"kubeletEndpoint": {"Port": 10250}},
        "nodeInfo": {
            "machineID": "3f6c0e1d2b8a4c7e9f10a2b3c4d5e6f7",
            "systemUUID": "4c4c4544-0042-3510-8052-b4c04f4e3732",
            "bootID": "a1b2c3d4-e5f6-4789-a0b1-c2d3e4f5a6b7",
            "kernelVersion": "6.8.0-1015-gcp", "osImage": "Ubuntu 22.04.4 LTS",
            "containerRuntimeVersion": "containerd://1.7.19", "kubeletVersion": "v1.30.3",
            "kubeProxyVersion": "v1.30.3", "operatingSystem": "linux", "architecture": "amd64",
        },
        "images": [
            {"names": [f"nvcr.io/nvidia/{image}"], "sizeBytes": size}
            for image, size in (("driver:560.35.03-ubuntu22.04", 1450000000),
                                ("k8s-device-plugin:v0.16.2", 130000000),
                                ("gpu-feature-discovery:v0.16.2", 120000000),
                                ("dcgm-exporter:3.3.7-3.5.0-ubuntu22.04", 450000000))
        ],
    }
    return node


class WatchPhase:
    """The port's informers over the monitor's and the requestor roll's
    ``DictClient``: a Node informer on the GPU label over a pool of
    ``WATCH_POOL_NODES`` nodes beside the monitored one, a NodeHealthReport
    informer, and a NodeMaintenance informer with ``WATCH_WINDOW_S``
    windows. Each informer counts every event its handlers see; a handler
    filtered by ``condition_changed_predicate`` keeps the monitored node's
    ``TpuIciHealthy`` transitions, one filtered by ``requestor_id_predicate``
    the NodeMaintenance events by node. Any check that fails raises."""

    def __init__(self) -> None:
        self.info: dict = {}
        self.informers: dict = {}
        self.counts: dict[str, int] = {}
        self.started: dict[str, float] = {}
        self.transitions: list[str] = []
        self.maintenance_events: list[tuple] = []

    def _start(self, label: str, client, kind: str, handler=None, **kw):
        """Start an informer with the counting handler and ``handler``."""
        from k8s_operator_libs_tpu_torch.kube.informer import Informer

        informer = Informer(client, kind, **kw)
        self.counts[label] = 0

        def count(event_type, obj, old) -> None:
            self.counts[label] += 1

        for h in (count, handler):
            if h is not None:
                informer.add_event_handler(h)
        self.informers[label] = informer
        self.started[label] = time.perf_counter()
        informer.start()
        return informer

    @staticmethod
    def _settle(what: str, predicate) -> None:
        deadline = time.monotonic() + WATCH_SETTLE_S
        while not predicate():
            if time.monotonic() > deadline:
                raise AssertionError(f"watch: {what} within {WATCH_SETTLE_S} s")
            time.sleep(0.02)

    def start_maintenance(self, client) -> None:
        """The NodeMaintenance informer on the requestor roll's client."""
        from k8s_operator_libs_tpu_torch.kube.objects import NodeMaintenance
        from k8s_operator_libs_tpu_torch.upgrade import requestor_id_predicate

        def ours(event_type, obj, old) -> None:
            if requestor_id_predicate(obj.raw, REQUESTOR_ID):
                self.maintenance_events.append((NodeMaintenance(obj.raw).node_name, event_type))

        informer = self._start("node_maintenance", client, "NodeMaintenance", ours,
                               namespace=MAINTENANCE_NS, watch_timeout_seconds=WATCH_WINDOW_S)
        if not informer.wait_for_sync(WATCH_SETTLE_S):
            raise AssertionError("watch: the NodeMaintenance informer never synced")

    def check_maintenance(self, client) -> None:
        """After the roll: each node's object ADDED then DELETED once, the
        store empty, a window resumed; then the journal compacted below the
        informer's revision: it must re-list, and its store equal the list."""
        from k8s_operator_libs_tpu_torch.kube.objects import NodeMaintenance

        informer = self.informers["node_maintenance"]
        self._settle("the NodeMaintenance store empties", lambda: not informer.list())
        by_node = {node: [e for n, e in self.maintenance_events if n == node]
                   for node in REQUESTOR_NODES}
        for node, events in by_node.items():
            if events.count("ADDED") != 1 or events.count("DELETED") != 1:
                raise AssertionError(f"watch: {node}'s NodeMaintenance events {events}")
        windows = client.windows.get("NodeMaintenance", 0)
        resumed = windows - informer.full_relists - informer.delta_relists
        if resumed < 1:
            raise AssertionError(f"watch: no NodeMaintenance window resumed ({windows} windows)")
        relists = informer.full_relists
        client.patch("Node", REQUESTOR_NODES[0],
                     patch={"metadata": {"labels": {"watch-phase": "compact"}}})
        compacted = client.compact()
        self._settle("the NodeMaintenance informer re-lists after the compaction",
                     lambda: informer.full_relists > relists)
        probe = NodeMaintenance.new("watch-phase-probe", namespace=MAINTENANCE_NS)
        probe.requestor_id = "other.operator.dev"
        client.create(probe)
        self._settle(
            "the NodeMaintenance store equals the list after the re-list",
            lambda: [o.raw for o in informer.list()]
            == [o.raw for o in client.list("NodeMaintenance", namespace=MAINTENANCE_NS)],
        )
        client.delete("NodeMaintenance", probe.name, MAINTENANCE_NS)
        self._settle("the probe's deletion reaches the store", lambda: not informer.list())
        self._finish("node_maintenance")
        self.info["node_maintenance"].update({
            "events_by_node": by_node,
            "windows": windows,
            "resumed_windows": resumed,
            "relists_before_compaction": relists,
            "compacted_through": compacted,
            "relists_after_compaction": informer.full_relists - relists,
        })

    def start_pool(self, client) -> None:
        """Seed ``client`` (holding the monitored node) with the pool, then
        the Node and NodeHealthReport informers; the Node informer's sync
        is timed and must hold every node."""
        from k8s_operator_libs_tpu_torch.kube.objects import condition_status
        from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
        from k8s_operator_libs_tpu_torch.tpu.monitor import ICI_HEALTHY_CONDITION
        from k8s_operator_libs_tpu_torch.upgrade import condition_changed_predicate

        labels = local_gpu_labels()
        sizes = []
        for i in range(WATCH_POOL_NODES):
            node = pool_node(f"gpu-pool-{i:03d}", labels)
            sizes.append(len(json.dumps(node.raw)))
            client.create(node)
        expected = len(client.list("Node", label_selector=WATCH_NODE_SELECTOR))

        def transitions(event_type, obj, old) -> None:
            if (obj.name == MONITOR_NODE and old is not None
                    and condition_changed_predicate(old.raw, obj.raw)):
                self.transitions.append(condition_status(obj.raw.get("status") or {},
                                                         ICI_HEALTHY_CONDITION))

        start = time.perf_counter()
        nodes = self._start("node", client, "Node", transitions,
                            label_selector=WATCH_NODE_SELECTOR)
        if not nodes.wait_for_sync(WATCH_SETTLE_S):
            raise AssertionError("watch: the Node informer never synced")
        sync_s = time.perf_counter() - start
        held = len(nodes.list())
        self.info["node"] = {
            "pool_nodes": WATCH_POOL_NODES, "node_bytes_mean": sum(sizes) / len(sizes),
            "synced": held, "sync_s": sync_s, "synced_per_s": held / sync_s,
        }
        if held != expected or held != WATCH_POOL_NODES + 1:
            raise AssertionError(f"watch: the Node informer holds {held} nodes, {expected} listed")
        reports = self._start("node_health_report", client, "NodeHealthReport")
        if not reports.wait_for_sync(WATCH_SETTLE_S):
            raise AssertionError("watch: the NodeHealthReport informer never synced")

    def check_report(self, client, mxu_tflops: float) -> None:
        """The NodeHealthReport informer's copy of the monitored node's
        report equals the published one, and carries the card's
        ``mxu_tflops``."""
        reports = self.informers["node_health_report"]
        published = client.get("NodeHealthReport", MONITOR_NODE).raw
        self._settle(
            "the NodeHealthReport informer reaches the published report",
            lambda: (reports.get(MONITOR_NODE) is not None
                     and reports.get(MONITOR_NODE).resource_version
                     == published["metadata"]["resourceVersion"]),
        )
        cached = reports.get(MONITOR_NODE).raw
        if cached["status"] != published["status"]:
            raise AssertionError("watch: the cached NodeHealthReport's status differs")
        if cached["status"]["metrics"].get("mxu_tflops") != mxu_tflops:
            raise AssertionError(
                f"watch: the cached report's mxu_tflops {cached['status']['metrics']}, "
                f"the card's {mxu_tflops}"
            )
        self.info["node_health_report"] = {
            "resource_version": cached["metadata"]["resourceVersion"],
            "mxu_tflops": cached["status"]["metrics"]["mxu_tflops"],
        }

    def check_monitor(self, client) -> None:
        """The predicate-filtered handler saw ``TpuIciHealthy`` go True on
        the passing cycle and then False on the failing one."""
        nodes = self.informers["node"]
        stored = client.get("Node", MONITOR_NODE).resource_version
        self._settle("the Node informer reaches the monitored node's last write",
                     lambda: nodes.get(MONITOR_NODE).resource_version == stored)
        seen = [t for i, t in enumerate(self.transitions) if i == 0 or t != self.transitions[i - 1]]
        self.info["node"]["ici_healthy_transitions"] = list(self.transitions)
        if seen[:2] != ["True", "False"]:
            raise AssertionError(f"watch: TpuIciHealthy transitions seen {self.transitions}")

    def _finish(self, label: str) -> None:
        """Stop one informer (again: no-op) and record its life."""
        informer = self.informers[label]
        if not informer.started:
            return
        informer.stop()
        seconds = time.perf_counter() - self.started[label]
        self.info.setdefault(label, {}).update({
            "events": self.counts[label],
            "seconds": seconds,
            "events_per_s": self.counts[label] / seconds,
            "full_relists": informer.full_relists,
            "delta_relists": informer.delta_relists,
        })

    def stop(self) -> dict:
        """Stop every informer; the phase's line."""
        for label in self.informers:
            self._finish(label)
        return self.info


def monitor_client():
    """A ``DictClient`` holding the monitored node, labelled from the card."""
    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels

    client = DictClient()
    node = Node.new(MONITOR_NODE, labels=local_gpu_labels())
    node.set_ready(True)
    client.create(node)
    return client


def monitor_phase(card: str, gate_launches: dict, client, watch: "WatchPhase") -> dict:
    """Monitor cycles on the card: pass, fail, busy, quick tier, over
    ``client`` (``monitor_client()``, its pool seeded and watched by
    ``watch``). The Warning the failing cycle records is recorded once
    more through the monitor's recorder: one Event object, its count 2."""
    from k8s_operator_libs_tpu_torch.kube.events import EventRecorder
    from k8s_operator_libs_tpu_torch.kube.objects import Pod, condition_status
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate, SubprocessHealthGate
    from k8s_operator_libs_tpu_torch.tpu.monitor import (
        ICI_HEALTHY_CONDITION,
        ReportPublisher,
        TpuHealthMonitor,
        make_quick_probe_guard,
        run_quick_probe_loop,
    )

    node = client.get("Node", MONITOR_NODE)
    recorder = EventRecorder(client)

    def condition() -> str:
        return condition_status(client.get("Node", MONITOR_NODE).status, ICI_HEALTHY_CONDITION)

    def cycle(gate) -> tuple:
        monitor = TpuHealthMonitor(
            client, MONITOR_NODE, gate=gate, failure_threshold=1, success_threshold=1,
            recorder=recorder, report_publisher=ReportPublisher(client, MONITOR_NODE),
        )
        start = time.perf_counter()
        report = monitor.check_once()
        return report, time.perf_counter() - start

    def subprocess_gate(**overrides):
        return SubprocessHealthGate(
            cli_args=IciHealthGate.tpu_defaults(**overrides).to_cli_args(),
            timeout_seconds=CLI_TIMEOUT_S, env=child_env(), cwd=REPO,
        )

    info: dict = {"node_labels": node.labels}
    gate = subprocess_gate()
    report, info["pass_wall_s"] = cycle(gate)
    payload = payload_lines(gate.last_stderr)
    info["pass_launches"] = payload["kernels"]["launches"]
    info["pass_world_form_times"] = payload["world"]["form_times"]
    info["pass_elapsed_s"] = report.elapsed_s if report else None
    info["pass_condition"] = condition()
    published = client.get("NodeHealthReport", MONITOR_NODE).raw
    reports = {"healthy": published}
    info["report_mxu_tflops"] = published["status"]["metrics"].get("mxu_tflops")
    info["report_score"] = published["status"]["score"]
    if report is None or not report.ok:
        raise AssertionError(f"monitor: the passing cycle failed: {report and report.failures}")
    if info["pass_condition"] != "True":
        raise AssertionError(f"monitor: condition {info['pass_condition']} after a pass")
    if info["report_mxu_tflops"] != report.mxu.tflops:
        raise AssertionError(
            f"monitor: NodeHealthReport mxu_tflops {info['report_mxu_tflops']}, "
            f"the card's {report.mxu.tflops}"
        )
    watch.check_report(client, report.mxu.tflops)

    gate = subprocess_gate(min_mxu_tflops=1e9)
    report, info["fail_wall_s"] = cycle(gate)
    info["fail_launches"] = payload_lines(gate.last_stderr)["kernels"]["launches"]
    info["fail_condition"] = condition()
    reports["degraded"] = client.get("NodeHealthReport", MONITOR_NODE).raw
    info["report_scores"] = {k: raw["status"]["score"] for k, raw in reports.items()}
    rvs = {raw["metadata"]["resourceVersion"] for raw in reports.values()}
    if len(rvs) != 2:
        raise AssertionError("monitor: the failing cycle published no NodeHealthReport")
    warnings = [e.raw for e in client.list("Event") if e.raw["type"] == "Warning"]
    info["warning_events"] = [e["message"] for e in warnings]
    if report is None or report.ok or info["fail_condition"] != "False" or len(warnings) != 1:
        raise AssertionError(f"monitor: the failing cycle: {info}")
    # The correlated recorder: the same Warning again patches its count.
    recorder.event(client.get("Node", MONITOR_NODE), warnings[0]["type"], warnings[0]["reason"],
                   warnings[0]["message"])
    again = [e.raw for e in client.list("Event") if e.raw["type"] == "Warning"]
    info["warning_event_counts"] = [e["count"] for e in again]
    same = again[0]["metadata"]["name"] == warnings[0]["metadata"]["name"]
    if info["warning_event_counts"] != [2] or not same:
        raise AssertionError(f"monitor: the repeated Warning left {again}")

    class Counted:
        runs = 0

        def run(self):
            Counted.runs += 1
            raise AssertionError("the gate ran on a busy node")

    busy = Pod.new("trainer", namespace="default")
    busy.node_name = MONITOR_NODE
    busy.spec["containers"] = [{"name": "t", "resources": {"limits": {"nvidia.com/gpu": "1"}}}]
    busy.raw["status"] = {"phase": "Running"}
    client.create(busy)
    skipped, _ = cycle(Counted())
    info["busy_skipped"] = skipped is None and Counted.runs == 0
    client.delete("Pod", "trainer", "default")
    if not info["busy_skipped"]:
        raise AssertionError("monitor: a busy node was probed")

    start = time.perf_counter()
    # A heartbeat of 0 writes every cycle: the full tier's report is fresh,
    # and the quick tier's healthy checks would otherwise be debounced.
    rc = run_quick_probe_loop(
        ReportPublisher(client, MONITOR_NODE, source="quick-probe", heartbeat_seconds=0.0),
        once=True,
        skip_cycle=make_quick_probe_guard(client, MONITOR_NODE),
    )
    info["quick_wall_s"] = time.perf_counter() - start
    quick = client.get("NodeHealthReport", MONITOR_NODE).raw
    info["quick_report"] = {k: quick["status"][k] for k in ("checks", "metrics")}
    print(json.dumps({"monitor": info, "card": card}), flush=True)
    # The quick battery's own checks (the report's spec keeps the source
    # that created it: a status write leaves the spec).
    if rc != 0 or quick["status"]["checks"] != {"ring_allreduce": True, "mxu": True}:
        raise AssertionError(f"monitor: quick tier rc {rc}: {quick['status']}")
    check_launches("monitor payload", info["pass_launches"], gate_launches)
    return {**info, "reports": reports}


def gang_phase(card: str, gate_launches: dict) -> dict:
    """The payload as a slice gang pod: one child on every card, then (with
    two or more cards) two children on half the cards each."""
    import torch

    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    n = torch.cuda.device_count()
    client = DictClient()
    for name in GANG_NODES:
        client.create(Node.new(name))
    info: dict = {}
    with ApiStub(client) as stub, tempfile.TemporaryDirectory(prefix="gang-") as work:
        kubeconfig = write_kubeconfig(work, stub.url)

        def run_gang(label: str, cards: list[list[int]]) -> list[dict]:
            coordinator = f"127.0.0.1:{free_port()}"
            procs = []
            start = time.perf_counter()
            for i, visible in enumerate(cards):
                ready = os.path.join(work, f"{label}-{i}.ready")
                out = open(os.path.join(work, f"{label}-{i}.out"), "w")
                err = open(os.path.join(work, f"{label}-{i}.err"), "w")
                argv = [
                    sys.executable, "-m", "k8s_operator_libs_tpu_torch.tpu.health",
                    "--coordinator", coordinator, "--num-processes", str(len(cards)),
                    "--process-id", str(i), "--link-peers", ",".join(GANG_NODES[:len(cards)]),
                    "--publish-report", "--ready-file", ready,
                ]
                env = child_env(
                    KUBECONFIG=kubeconfig, NODE_NAME=GANG_NODES[i],
                    CUDA_VISIBLE_DEVICES=",".join(map(str, visible)),
                )
                procs.append((subprocess.Popen(argv, cwd=REPO, env=env, stdout=out,
                                               stderr=err), out, err, ready))
            results = []
            for proc, out, err, ready in procs:
                try:
                    rc = proc.wait(timeout=CLI_TIMEOUT_S)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait(30)
                    out.close()
                    err.close()
                with open(out.name) as f:
                    lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
                with open(err.name) as f:
                    stderr = f.read()
                if not lines:
                    raise AssertionError(f"gang {label}: no report (rc {rc}): {stderr[-3000:]}")
                report = HealthReport.from_dict(json.loads(lines[-1]))
                payload = payload_lines(stderr)
                results.append({
                    "rc": rc,
                    "report": report,
                    "summary": report.summary(),
                    "ready": open(ready).read().strip() if os.path.exists(ready) else None,
                    "launches": payload["kernels"]["launches"],
                    "world_form_times": payload["world"]["form_times"],
                    "links": [(h.src, h.dst, h.peer, h.ok) for h in report.links],
                })
            wall = time.perf_counter() - start
            for r in results:
                r["wall_s"] = wall
            return results

        (one,) = run_gang("one-pod", [list(range(n))])
        report = one.pop("report")
        published = client.get("NodeHealthReport", GANG_NODES[0]).raw
        info["one_pod"] = {**one, "process_count": report.process_count,
                           "slice_devices_total": report.slice_devices_total,
                           "published_source": published["spec"]["source"]}
        if not (one["rc"] == 0 and report.ok and report.process_count == 1
                and report.slice_devices_total == n and "slice=" in report.summary()
                and one["ready"] and "slice=" in one["ready"]
                and published["spec"]["source"] == "gate"):
            raise AssertionError(f"gang of one pod: {info['one_pod']} {report.failures}")
        check_launches("gang payload", one["launches"], gate_launches)
        if n >= 2:
            k = n // 2
            pods = run_gang("two-pod", [list(range(k)), list(range(k, 2 * k))])
            info["two_pods"] = []
            for i, pod in enumerate(pods):
                report = pod.pop("report")
                info["two_pods"].append(pod)
                want = f"slice={2 * k}/{2 * k} over 2 hosts"
                other = GANG_NODES[1 - i]
                if pod["rc"] != 0 or not pod["ready"] or want not in pod["ready"]:
                    raise AssertionError(f"gang of two pods, pod {i}: {pod} {report.failures}")
                if not any(peer == other for _, _, peer, ok in pod["links"] if ok):
                    raise AssertionError(f"gang pod {i}: no hop to {other}: {pod['links']}")
        else:
            info["two_pods"] = "not run: a gang of two pods needs two or more cards"
    print(json.dumps({"gang": info, "card": card}), flush=True)
    return info


# ----------------------------------------------------------------------
# The rolling upgrade through the port's state machine.
# ----------------------------------------------------------------------

class RollKubelet:
    """The DaemonSet controller and the kubelets of the roll's nodes, over
    ``DictClient``: a ControllerRevision per driver version, a driver pod
    on each node at the newest revision (the new driver's held by its
    safe-load gate until the state machine removes the node's annotation,
    Ready a tick later), and each validation pod's command run until its
    ready file appears (``run_probe_pod``), the node's kernel cache the
    directory ``caches`` names for it."""

    def __init__(self, client, installer, nodes, workdir: str, gate_launches: dict,
                 caches: dict) -> None:
        self.client = client
        self.installer = installer
        self.nodes = nodes
        self.workdir = workdir
        self.gate_launches = gate_launches
        self.caches = caches
        self.revisions: dict[str, int] = {}
        #: Driver pods whose safe-load gate waits: pod name -> node.
        self.blocked: dict[str, str] = {}
        #: Driver pods that load their driver on the next tick.
        self.loading: set[str] = set()
        self.probe_runs: dict[str, dict] = {}

    @property
    def namespace(self) -> str:
        return self.installer.spec.namespace

    def version(self) -> str:
        return self.installer.spec.version

    def pod_name(self, node: str) -> str:
        return f"{self.installer.name}-{node}"

    def publish_revision(self) -> None:
        from k8s_operator_libs_tpu_torch.kube.objects import ControllerRevision

        version = self.version()
        if version in self.revisions:
            return
        self.revisions[version] = len(self.revisions) + 1
        cr = ControllerRevision.new(
            f"{self.installer.name}-{version}", namespace=self.namespace,
            labels=self.installer.match_labels,
        )
        cr.revision = self.revisions[version]
        self.client.create(cr)

    def ensure_driver_pod(self, ds, node: str, ready: bool) -> None:
        from k8s_operator_libs_tpu_torch.kube.client import get_or_none
        from k8s_operator_libs_tpu_torch.kube.objects import CONTROLLER_REVISION_HASH_LABEL, Pod

        name = self.pod_name(node)
        if get_or_none(self.client, "Pod", name, self.namespace) is not None:
            return
        pod = Pod.new(name, namespace=self.namespace, labels=self.installer.match_labels)
        pod.labels[CONTROLLER_REVISION_HASH_LABEL] = self.version()
        pod.node_name = node
        pod.add_owner_reference(ds)
        if ready:
            pod.raw["status"] = self.driver_status(ready=True)
        else:
            # The init container annotates the node and blocks.
            self.client.patch("Node", node, patch={"metadata": {"annotations": {
                self.installer.keys.safe_driver_load_annotation: "true"}}})
            pod.raw["status"] = self.driver_status(ready=False)
            self.blocked[name] = node
        self.client.create(pod)

    @staticmethod
    def driver_status(ready: bool) -> dict:
        return {
            "phase": "Running" if ready else "Pending",
            "conditions": [{"type": "Ready", "status": "True" if ready else "False"}],
            "initContainerStatuses": [
                {"name": "safe-load-gate", "ready": ready, "restartCount": 0}
            ],
            "containerStatuses": [{"name": "installer", "ready": ready, "restartCount": 0}],
        }

    def advance_driver_pods(self) -> None:
        for name in list(self.loading):
            self.loading.discard(name)
            self.client.patch("Pod", name, self.namespace,
                              patch={"status": self.driver_status(ready=True)})
        key = self.installer.keys.safe_driver_load_annotation
        for name, node in list(self.blocked.items()):
            if key not in self.client.get("Node", node).annotations:
                del self.blocked[name]
                self.loading.add(name)

    def run_probe_pods(self) -> None:
        from k8s_operator_libs_tpu_torch.kube.objects import Pod
        from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodSpec

        for obj in self.client.list("Pod", label_selector=ValidationPodSpec().pod_selector):
            pod = Pod(obj.raw)
            if pod.phase:
                continue
            (container,) = pod.spec["containers"]
            cache = self.caches[pod.node_name]
            host_paths = {v["hostPath"]["path"]: cache for v in pod.spec.get("volumes") or []}
            run = run_probe_pod(container, host_paths, self.workdir, pod.name)
            check_launches(f"roll probe pod {pod.name}", run["launches"], self.gate_launches)
            run["node"] = pod.node_name
            self.probe_runs[pod.name] = run
            self.client.patch("Pod", pod.name, pod.namespace, patch={"status": {
                "phase": "Running",
                "conditions": [{"type": "Ready", "status": "True"}],
                "containerStatuses": [{"name": "probe", "ready": True, "restartCount": 0}],
            }})

    def tick(self) -> None:
        from k8s_operator_libs_tpu_torch.kube.objects import DaemonSet

        self.publish_revision()
        ds = DaemonSet(self.client.get("DaemonSet", self.installer.name, self.namespace).raw)
        fresh = len(self.revisions) == 1
        for node in self.nodes:
            self.ensure_driver_pod(ds, node, ready=fresh)
        self.advance_driver_pods()
        self.client.patch("DaemonSet", ds.name, self.namespace,
                          patch={"status": {"desiredNumberScheduled": len(self.nodes)}})
        self.run_probe_pods()


def roll_pool(client, nodes):
    """``nodes`` labelled from the card, each Ready with a controller-owned
    workload pod, and the NVIDIA driver DaemonSet at the old version."""
    from k8s_operator_libs_tpu_torch.tpu.libtpu import LibtpuDaemonSetManager, LibtpuSpec

    pool_nodes(client, nodes)
    installer = LibtpuDaemonSetManager(client, LibtpuSpec(version=ROLL_VERSIONS[0]))
    installer.apply()
    return installer


def pool_nodes(client, nodes) -> None:
    """``nodes`` labelled from the card, each Ready with a controller-owned
    workload pod."""
    from k8s_operator_libs_tpu_torch.kube.objects import Node, Pod
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels

    for name in nodes:
        node = Node.new(name, labels=local_gpu_labels())
        node.set_ready(True)
        client.create(node)
        workload = Pod.new(f"train-{name}", namespace="default", labels={"app": "train"})
        workload.node_name = name
        workload.metadata["ownerReferences"] = [
            {"apiVersion": "apps/v1", "kind": "ReplicaSet", "name": "train",
             "uid": "uid-train", "controller": True}
        ]
        workload.raw["status"] = {"phase": "Running"}
        client.create(workload)


def drive_roll(label: str, client, mgr, installer, kubelet, before_apply=None,
               after_apply=None, policy: dict = ROLL_POLICY, observe=None) -> dict:
    """Bump the driver to the new version, set every launch count to 0,
    then passes (the kubelet's tick, ``before_apply()``, one pass of
    ``mgr`` under ``policy``, ``observe(state)`` where the pass built its
    state, ``after_apply()``) until every node of the
    kubelet reads ``upgrade-done`` uncordoned and ``after_apply()`` (if
    given) returned True. A node in
    ``upgrade-failed``, or none changing state for ``ROLL_STALL_S``, fails
    the phase. The passes, wall seconds, build_state retries and each
    node's states with the pass and second each began."""
    from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.upgrade import BuildStateError, DeviceClass, UpgradeKeys

    keys = UpgradeKeys(DeviceClass.nvidia("gpu"))
    policy = DriverUpgradePolicySpec.from_dict(policy)
    trajectories: dict[str, list] = {name: [] for name in kubelet.nodes}
    retries = passes = 0
    kubelet.tick()  # every driver pod at the old version
    installer.spec.version = ROLL_VERSIONS[1]
    installer.apply()
    reset_counts()
    start = last_change = time.perf_counter()
    while True:
        kubelet.tick()
        if before_apply is not None:
            before_apply()
        passes += 1
        try:
            state = mgr.build_state(installer.spec.namespace, installer.match_labels)
            mgr.apply_state(state, policy)
            if observe is not None:
                observe(state)
        except BuildStateError:
            retries += 1  # a pod the kubelet has still to deliver
        phase_done = after_apply() if after_apply is not None else True
        now = time.perf_counter()
        nodes = {name: Node(client.get("Node", name).raw) for name in kubelet.nodes}
        for name, node in nodes.items():
            state = node.labels.get(keys.state_label, "")
            if not trajectories[name] or trajectories[name][-1][1] != state:
                trajectories[name].append([passes, state, round(now - start, 3)])
                last_change = now
            if state == "upgrade-failed":
                raise AssertionError(f"{label}: {name} failed: {trajectories}")
        if phase_done and all(
            n.labels.get(keys.state_label) == "upgrade-done" and not n.unschedulable
            for n in nodes.values()
        ):
            return {"passes": passes, "wall_s": time.perf_counter() - start,
                    "build_state_retries": retries, "trajectories": trajectories}
        if now - last_change > ROLL_STALL_S:
            raise AssertionError(
                f"{label}: no node changed state for {ROLL_STALL_S} s: {trajectories}"
            )
        time.sleep(ROLL_PASS_INTERVAL_S)


def check_rolled_pods(label: str, client, installer, nodes, runs: dict, others=()) -> list:
    """Each node's probe pod ran; no workload pod is left but ``others``
    and every driver pod is Ready at the new version. The pods left."""
    from k8s_operator_libs_tpu_torch.kube.objects import Pod

    if sorted(run["node"] for run in runs.values()) != sorted(nodes):
        raise AssertionError(f"{label}: probe pods ran on {[r['node'] for r in runs.values()]}")
    pods = sorted(p.name for p in client.list("Pod"))
    if any(name.startswith("train-") for name in pods):
        raise AssertionError(f"{label}: the drain left workload pods: {pods}")
    driver = {installer.name + "-" + n for n in nodes}
    if set(pods) != driver | set(others):
        raise AssertionError(f"{label}: pods after the roll: {pods}")
    for name in driver:
        pod = Pod(client.get("Pod", name, installer.spec.namespace).raw)
        if pod.controller_revision_hash() != ROLL_VERSIONS[1] or not pod.is_ready():
            raise AssertionError(f"{label}: driver pod {name} not Ready at {ROLL_VERSIONS[1]}")
    return pods


def total_launches(calls) -> dict:
    return {lib: sum(c["launches"][lib] for c in calls) for lib in ("matmul", "flash_attention")}


def roll_phase(card: str, gate_launches: dict, cache_root: str, client, label: str = "roll",
               nodes=ROLL_NODES, reader=None, caches: Optional[dict] = None,
               extra: Optional[dict] = None) -> dict:
    """Two GPU nodes of ``client`` rolled from driver 550 to 560 by the
    port's own state machine (reading through ``reader`` where given),
    each let back in by its probe pod's payload on the card; each node's
    kernel cache is the directory ``caches`` names for it, by default its
    own under ``cache_root``. ``extra()`` adds to the result printed."""
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
        ValidationPodManager,
        ValidationPodSpec,
    )
    from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager, DeviceClass

    installer = roll_pool(client, nodes)
    if reader is not None:
        # A controller starts once its cache has synced: the reader holds
        # the pool before the first pass.
        reader.sync()
    mgr = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"), reader=reader)
    mgr.with_validation_enabled(
        pod_provisioner=ValidationPodManager(client, ValidationPodSpec())
    )
    if caches is None:
        caches = {name: os.path.join(cache_root, name) for name in nodes}
    with tempfile.TemporaryDirectory(prefix=f"{label}-") as workdir:
        kubelet = RollKubelet(client, installer, nodes, workdir, gate_launches, caches)
        try:
            run = drive_roll(label, client, mgr, installer, kubelet)
        finally:
            mgr.runner.shutdown()
        parent = counts()
    if parent["matmul"] or parent["flash_attention"]:
        raise AssertionError(f"{label}: the controller launched kernels itself: {parent}")
    runs = kubelet.probe_runs
    result = {
        "nodes": list(nodes),
        "versions": list(ROLL_VERSIONS),
        "policy": ROLL_POLICY,
        **run,
        "probe_pods": runs,
        "launches": total_launches(runs.values()),
        "controller_launches": parent,
        "pods_after": sorted(p.name for p in client.list("Pod")),
        **(extra() if extra is not None else {}),
    }
    print(json.dumps({label: result, "card": card}), flush=True)
    check_rolled_pods(label, client, installer, nodes, runs)
    return result


def demo_child(label: str, *args: str) -> dict:
    """``python -m k8s_operator_libs_tpu_torch.upgrade_controller --demo``
    with ``args``, its gate on the card: its seconds, passes and each
    node's gate verdict. A non-zero exit, no ``rolling upgrade complete``
    or a gate that did not pass fails the phase."""
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller", "--demo",
         *args],
        cwd=REPO, env=child_env(), capture_output=True, text=True, timeout=DEMO_TIMEOUT_S,
    )
    seconds = time.perf_counter() - start
    tail = proc.stdout[-2000:] + proc.stderr[-2000:]
    done = re.search(r"^demo: rolling upgrade complete in (\d+) passes$", proc.stdout, re.M)
    if proc.returncode != 0 or done is None:
        raise AssertionError(f"demo {label}: rc {proc.returncode}: {tail}")
    gate = {m.group(1): {"ok": m.group(2) == "True", "seconds": float(m.group(3))}
            for m in re.finditer(r"^demo gate: node=(\S+) ok=(True|False) seconds=([0-9.]+)$",
                                 proc.stdout, re.M)}
    if sorted(gate) != list(DEMO_NODES) or not all(v["ok"] for v in gate.values()):
        raise AssertionError(f"demo {label}: gate verdicts {gate}: {tail}")
    return {"args": list(args), "rc": proc.returncode, "seconds": seconds,
            "passes": int(done.group(1)),
            "pass_lines": sum(1 for ln in proc.stdout.splitlines() if ln.startswith("pass ")),
            "gate": gate}


def crdutil_demo_child(operation: str) -> dict:
    """``python -m k8s_operator_libs_tpu_torch.crdutil --demo`` on the
    repo's CRDs: its seconds and last line."""
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.crdutil", "--demo",
         "--crds-path", os.path.join(REPO, "manifests", "crds"), "--operation", operation],
        cwd=REPO, env=child_env(), capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
    )
    seconds = time.perf_counter() - start
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or last != f"{operation}: processed 2 CRD(s)":
        raise AssertionError(f"crdutil_demo {operation}: rc {proc.returncode}, last line "
                             f"{last!r}: {proc.stderr[-2000:]}")
    return {"seconds": seconds, "last_line": last}


def in_memory_phase(card: str, gate_launches: dict, cache_root: str) -> dict:
    """The port's in-memory cluster on the card: both commands' ``--demo``
    as child processes, then ``roll``'s scenario over a ``FakeCluster`` of
    256 more GPU nodes, the manager and provider reading through a
    ``CachedClient`` in its auto mode, each probe pod on the kernel cache
    ``roll`` left for its node."""
    from k8s_operator_libs_tpu_torch.kube.cache import CachedClient
    from k8s_operator_libs_tpu_torch.kube.fake import FakeCluster
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels

    from concurrent.futures import ThreadPoolExecutor

    started = time.perf_counter()

    # The two demo children share the card, each with its own world, and
    # run beside the crdutil children: the phase's seconds are the roll's.
    with ThreadPoolExecutor(max_workers=2) as pool:
        plain = pool.submit(demo_child, "plain")
        requestor = pool.submit(demo_child, "requestor", "--requestor", "--post-maintenance")
        crdutil = {op: crdutil_demo_child(op) for op in ("apply", "delete")}
        demo = {"plain": plain.result(), "requestor": requestor.result()}
    print(json.dumps({"demo": demo, "card": card}), flush=True)
    print(json.dumps({"crdutil_demo": crdutil, "card": card}), flush=True)

    cluster = FakeCluster()
    labels = local_gpu_labels()
    for i in range(WATCH_POOL_NODES):
        cluster.create(pool_node(f"gpu-other-{i:03d}", labels))
    reader = CachedClient(cluster, sync_mode="auto")
    waits: list = []
    wait_until = reader.wait_until

    def timed_wait(predicate, timeout):
        began = time.perf_counter()
        ok = wait_until(predicate, timeout)
        waits.append((round(time.perf_counter() - began, 4), ok))
        return ok

    # The provider's read-back waits, each timed: the instance's own
    # attribute shadows the method.
    reader.wait_until = timed_wait

    def read_back() -> dict:
        seconds = [w for w, _ in waits]
        return {"cluster_nodes": len(cluster.list("Node")), "reader": "CachedClient(auto)",
                "read_back_waits": len(waits),
                "read_back_s_total": round(sum(seconds), 4),
                "read_back_s_max": max(seconds, default=0.0),
                "read_back_timeouts": sum(1 for _, ok in waits if not ok)}

    try:
        fake = roll_phase(card, gate_launches, cache_root, cluster, label="fake_roll",
                          nodes=FAKE_ROLL_NODES, reader=reader,
                          caches={name: os.path.join(cache_root, roll_node)
                                  for name, roll_node in zip(FAKE_ROLL_NODES, ROLL_NODES)},
                          extra=read_back)
    finally:
        reader.close()
        cluster.close()
    if not waits or fake["read_back_timeouts"]:
        raise AssertionError(f"fake_roll: read-back waits {waits}")
    if fake["cluster_nodes"] != WATCH_POOL_NODES + len(FAKE_ROLL_NODES):
        raise AssertionError(f"fake_roll: {fake['cluster_nodes']} nodes in the cluster")
    print(json.dumps({"in_memory": {"seconds": time.perf_counter() - started}, "card": card}),
          flush=True)
    return {"demo": demo, "crdutil_demo": crdutil, "fake_roll": fake}


def requestor_roll_phase(card: str, gate_launches: dict, cache_root: str, client) -> dict:
    """Two more GPU nodes rolled from driver 550 to 560 by the port's
    machine in the requestor mode: the maintenance operator's stand-in
    cordons and drains them through NodeMaintenance objects, the
    post-maintenance hook runs the gate on the card in this process, and
    each node's probe pod validates it, on the kernel cache a node of the
    roll phase left (a second roll of the same hosts). ``client`` is a
    fresh ``DictClient``."""
    import torch

    from k8s_operator_libs_tpu_torch.kube.sim import MaintenanceOperatorSimulator
    from k8s_operator_libs_tpu_torch.tpu.health import IciHealthGate, cache_warmup_hook
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
        ValidationPodManager,
        ValidationPodSpec,
    )
    from k8s_operator_libs_tpu_torch.upgrade import (
        ClusterUpgradeStateManager,
        DeviceClass,
        RequestorOptions,
        enable_requestor_mode,
    )

    installer = roll_pool(client, REQUESTOR_NODES)
    mgr = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"))
    mgr.with_validation_enabled(
        pod_provisioner=ValidationPodManager(client, ValidationPodSpec())
    )
    warm_gate = IciHealthGate.tpu_defaults(device="cuda")
    warmup = cache_warmup_hook(warm_gate)
    hook_calls: list[dict] = []
    hook_errors: list[str] = []

    def hook(node) -> bool:
        """The port's warm-up hook, its launches read before and after."""
        before = counts()
        start = time.perf_counter()
        try:
            done = warmup(node)
        except Exception as e:
            hook_errors.append(f"{node.name}: {e!r}")
            raise
        torch.cuda.synchronize()
        after = counts()
        hook_calls.append({
            "node": node.name,
            "cordoned": bool(node.unschedulable),
            "seconds": time.perf_counter() - start,
            "launches": {lib: after[lib] - before[lib] for lib in ("matmul", "flash_attention")},
        })
        return done

    enable_requestor_mode(mgr, RequestorOptions(
        use_maintenance_operator=True, use_post_maintenance=True,
        requestor_id=REQUESTOR_ID, namespace=MAINTENANCE_NS,
        post_maintenance_hook=hook,
    ))
    operator = MaintenanceOperatorSimulator(client, namespace=MAINTENANCE_NS)
    reasons: list[dict] = []

    def after_apply() -> bool:
        """The hook's errors fail the phase; each object's Ready reason is
        recorded; the phase ends when no object is left."""
        if hook_errors:
            raise AssertionError(f"requestor_roll: the hook raised: {hook_errors}")
        objects = client.list("NodeMaintenance", namespace=MAINTENANCE_NS)
        reasons.append({
            o.name: "deleting" if o.deletion_timestamp else o.ready_reason() or "Pending"
            for o in objects
        })
        return not objects

    caches = {req: os.path.join(cache_root, roll) for req, roll in zip(REQUESTOR_NODES, ROLL_NODES)}
    print(f"requestor_roll: each node's probe pod takes the kernel cache of "
          f"{json.dumps(dict(zip(REQUESTOR_NODES, ROLL_NODES)))} from the roll phase, "
          "so its payload skips nvcc", flush=True)
    with tempfile.TemporaryDirectory(prefix="requestor-roll-") as workdir:
        kubelet = RollKubelet(client, installer, REQUESTOR_NODES, workdir, gate_launches, caches)
        try:
            run = drive_roll("requestor_roll", client, mgr, installer, kubelet,
                             before_apply=operator.step, after_apply=after_apply)
        finally:
            mgr.runner.shutdown()
            warm_gate.close()
        controller = counts()
    runs = kubelet.probe_runs
    result = {
        "nodes": list(REQUESTOR_NODES),
        "versions": list(ROLL_VERSIONS),
        "policy": ROLL_POLICY,
        **run,
        "hook_calls": hook_calls,
        "probe_pods": runs,
        "maintenance_reasons_by_pass": reasons,
        "controller_launches": {lib: controller[lib] for lib in ("matmul", "flash_attention")},
        "hook_launches": total_launches(hook_calls),
        "pod_launches": total_launches(runs.values()),
        "pods_after": sorted(p.name for p in client.list("Pod")),
    }
    print(json.dumps({"requestor_roll": result, "card": card}), flush=True)
    for name, trajectory in run["trajectories"].items():
        states = [step[1] for step in trajectory]
        for wanted in ("node-maintenance-required", "post-maintenance-required", "upgrade-done"):
            if wanted not in states:
                raise AssertionError(f"requestor_roll: {name} never reached {wanted}: {states}")
    if sorted(call["node"] for call in hook_calls) != sorted(REQUESTOR_NODES):
        raise AssertionError(f"requestor_roll: hook calls {hook_calls}")
    for call in hook_calls:
        if not call["cordoned"]:
            raise AssertionError(f"requestor_roll: the hook ran on an uncordoned node: {call}")
        check_launches(f"requestor_roll hook on {call['node']}", call["launches"], gate_launches)
    for lib in ("matmul", "flash_attention"):
        hooked = result["hook_launches"][lib]
        if controller[lib] != 2 * gate_launches[lib] or hooked != controller[lib]:
            raise AssertionError(
                f"requestor_roll: the controller launched {lib} {controller[lib]} times, "
                f"its hook calls {hooked}, twice the gate's {2 * gate_launches[lib]}"
            )
    built = {name: run["build_s"] for name, run in runs.items() if any(run["build_s"].values())}
    if built:
        raise AssertionError(f"requestor_roll: pods built their kernels again: {built}")
    check_rolled_pods("requestor_roll", client, installer, REQUESTOR_NODES, runs)
    return result


class TrainingJob:
    """One training pod's model, as ``Trainer`` keeps it."""

    def __init__(self, pod: str, seed: int) -> None:
        self.pod = pod
        self.seed = seed
        self.params = None
        #: The step the parameters are at, and the highest ever trained.
        self.step = 0
        self.high_water = 0
        self.restarts = 0
        #: The last ack acted on: (epoch, step).
        self.ack: Optional[tuple] = None
        #: Each step's loss (the train step's, before its update), first time.
        self.losses: dict[int, float] = {}
        #: Step -> a CPU copy of the parameters saved there (step 0: made
        #: from the seed), and the loss of a forward pass at them on the
        #: next step's batch.
        self.saved: dict[int, list] = {}
        self.saved_forward_loss: dict[int, float] = {}
        self.retrained = 0
        #: Steps trained again whose loss differs from the first time's.
        self.replay_loss_diffs: list = []


class Trainer:
    """The training job behind each pod of a ``CheckpointingWorkloadSimulator``
    on ``nodes``: the burn-in model (``models/burnin.py``) at ``cfg`` on
    ``device``, trained for real up to the simulator's step for the pod
    (``sync``, after each of the simulator's ticks). Step ``s`` trains on
    the batch of seed ``job.seed + s``, so a step trained again sees the
    same data. A pod's new ack saves its parameters at the acked step
    (``torch.save`` under ``directory``); a pod made again from
    ``base_step`` b loads the step-b file (b = 0: made again from the
    seed). Each restore holds the loaded parameters against the saved ones
    (``torch.equal``) and the first loss after it, a forward pass on the
    batch of step b + 1, against the loss recorded at that step before the
    eviction (the train step's, and the forward pass's at the save)."""

    def __init__(self, client, workload, keys, cfg, device: str, seed: int, directory: str,
                 nodes) -> None:
        self.client = client
        self.workload = workload
        self.keys = keys
        self.cfg = cfg
        self.device = device
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.jobs = {
            node: TrainingJob(pod=workload.workload(node).pod_name, seed=seed + 1000 * i)
            for i, node in enumerate(nodes)
        }
        self.step_ms: list[float] = []
        self.save_s: list[float] = []
        self.load_s: list[float] = []
        self.restores: list[dict] = []

    def _batch(self, job: TrainingJob, step: int) -> dict:
        import torch

        from k8s_operator_libs_tpu_torch.models.burnin import synthetic_batch

        return synthetic_batch(torch.Generator().manual_seed(job.seed + step), self.cfg,
                               self.device)

    def _forward_loss(self, job: TrainingJob, params, step: int) -> float:
        import torch

        from k8s_operator_libs_tpu_torch.models.burnin import loss_fn

        with torch.no_grad():
            return loss_fn(params, self._batch(job, step), self.cfg).item()

    def _init(self, job: TrainingJob):
        import torch

        from k8s_operator_libs_tpu_torch.models.burnin import init_params

        return init_params(torch.Generator().manual_seed(job.seed), self.cfg, self.device)

    @staticmethod
    def _cpu_leaves(params) -> list:
        from k8s_operator_libs_tpu_torch.models.burnin import _leaves

        return [t.detach().to("cpu", copy=True) for t in _leaves(params)]

    def _ack(self, pod: str) -> Optional[tuple]:
        from k8s_operator_libs_tpu_torch.kube.client import get_or_none

        obj = get_or_none(self.client, "Pod", pod, self.workload.namespace)
        if obj is None:
            return None
        annotations = obj.raw["metadata"].get("annotations") or {}
        epoch = annotations.get(self.keys.checkpoint_complete_annotation)
        if not epoch:
            return None
        return epoch, int(annotations[self.keys.checkpoint_step_annotation])

    def sync(self) -> None:
        for node, job in self.jobs.items():
            w = self.workload.workload(node)
            if w.restarts != job.restarts:  # evicted; maybe made again since
                job.restarts = w.restarts
                job.params = None
            if not w.running:
                continue
            if job.params is None:
                self._start(job, w.base_step)
            ack = self._ack(job.pod)
            if ack is not None and ack != job.ack:
                job.ack = ack
                self._train_to(job, ack[1])
                self._save(job)
            self._train_to(job, w.step)

    def _start(self, job: TrainingJob, base: int) -> None:
        """The first start from the seed, or a restore from step ``base``."""
        import torch

        if job.high_water == 0 and not job.saved:
            job.params = self._init(job)
            job.saved[0] = self._cpu_leaves(job.params)
            job.saved_forward_loss[0] = self._forward_loss(job, job.params, 1)
            return
        load_s = None
        if base == 0:
            params = self._init(job)
        else:
            start = time.perf_counter()
            params = torch.load(self._path(job, base), map_location=self.device)
            if self.device == "cuda":
                torch.cuda.synchronize()
            load_s = time.perf_counter() - start
            self.load_s.append(load_s)
        loaded = self._cpu_leaves(params)
        equal = all(torch.equal(a, b) for a, b in zip(loaded, job.saved[base], strict=True))
        first = self._forward_loss(job, params, base + 1)
        before = job.losses.get(base + 1)
        self.restores.append({
            "pod": job.pod,
            "restored_step": base,
            "stopped_at": job.step,
            "load_s": load_s,
            "params_equal": equal,
            "first_loss": first,
            "loss_at_save": job.saved_forward_loss[base],
            "loss_before_eviction": before,
            "first_minus_at_save": first - job.saved_forward_loss[base],
            "first_minus_before_eviction": None if before is None else first - before,
        })
        job.params = params
        job.step = base

    def _path(self, job: TrainingJob, step: int) -> str:
        return os.path.join(self.directory, f"{job.pod}-step{step}.pt")

    def _save(self, job: TrainingJob) -> None:
        import torch

        start = time.perf_counter()
        torch.save(job.params, self._path(job, job.step))
        self.save_s.append(time.perf_counter() - start)
        job.saved[job.step] = self._cpu_leaves(job.params)
        job.saved_forward_loss[job.step] = self._forward_loss(job, job.params, job.step + 1)

    def _train_to(self, job: TrainingJob, target: int) -> None:
        from k8s_operator_libs_tpu_torch.models.burnin import train_step

        while job.step < target:
            batch = self._batch(job, job.step + 1)
            start = time.perf_counter()
            job.params, loss = train_step(job.params, batch, self.cfg)
            loss = loss.item()  # waits for the step
            self.step_ms.append((time.perf_counter() - start) * 1e3)
            job.step += 1
            if job.step <= job.high_water:
                job.retrained += 1
                if loss != job.losses[job.step]:
                    job.replay_loss_diffs.append([job.step, loss - job.losses[job.step]])
            else:
                job.high_water = job.step
                job.losses[job.step] = loss

    def retrained(self) -> int:
        return sum(job.retrained for job in self.jobs.values())

    def caught_up(self) -> bool:
        """Every job running again and past the step it stopped at."""
        return all(
            self.workload.workload(node).running and job.params is not None
            and job.step >= job.high_water
            for node, job in self.jobs.items()
        )


class EventLog:
    """A recorder that keeps each event's object name, type and message."""

    def __init__(self) -> None:
        self.events: list[tuple] = []

    def eventf(self, obj, event_type, reason, fmt, *args) -> None:
        self.events.append((obj.name, event_type, fmt % args if args else fmt))


class TracedPhase:
    """A port ``Tracer`` installed over one phase (process-wide, one at a
    time), and an ``UpgradeMetrics`` over the phase's manager, observed
    after every pass that built a state and served by ``MetricsServer`` on
    a free port. :meth:`report` exports the ring to JSONL, reads it with
    the port's ``tools/trace_view.py``, checks it, scrapes ``/metrics``
    once over HTTP and prints ``{"trace": ...}`` and ``{"metrics": ...}``."""

    def __init__(self, label: str) -> None:
        from k8s_operator_libs_tpu_torch.utils import tracing

        self.label = label
        self.tracer = tracing.Tracer()
        tracing.install_tracer(self.tracer)
        self.metrics = None
        self.server = None
        self.observed = 0

    def serve(self, mgr) -> None:
        from k8s_operator_libs_tpu_torch.upgrade.metrics import MetricsServer, UpgradeMetrics

        self.metrics = UpgradeMetrics(mgr)
        self.server = MetricsServer(self.metrics, port=0).start()

    def observe(self, state) -> None:
        self.metrics.observe(state)
        self.observed += 1

    def pause(self) -> None:
        from k8s_operator_libs_tpu_torch.utils import tracing

        tracing.clear_tracer()

    def resume(self) -> None:
        from k8s_operator_libs_tpu_torch.utils import tracing

        tracing.install_tracer(self.tracer)

    def close(self) -> None:
        from k8s_operator_libs_tpu_torch.utils import tracing

        if tracing.tracer() is self.tracer:
            tracing.clear_tracer()
        if self.server is not None:
            self.server.stop()
            self.server = None

    def scrape(self) -> dict:
        """``/metrics`` once over HTTP: the pass and checkpoint gauges, the
        bucket seconds and the passes counted."""
        import urllib.request

        body = urllib.request.urlopen(self.server.url, timeout=10).read().decode()
        prefix = "tpu_operator_upgrade_"
        gauges: dict = {}
        buckets: dict = {}
        for line in body.splitlines():
            if line.startswith("#") or not line.startswith(prefix):
                continue
            name, value = line.rsplit(" ", 1)
            suffix = name[len(prefix):].split("{", 1)[0]
            number = float(value) if "." in value or "e" in value else int(value)
            if suffix == "pass_bucket_seconds":
                buckets[re.search(r'bucket="([^"]*)"', name).group(1)] = number
            else:
                gauges[suffix] = number
        return {"url": self.server.url, "bytes": len(body), "gauges": gauges,
                "pass_bucket_seconds": buckets}

    def report(self, workdir: str, nodes, card: str) -> dict:
        """Export, read and check the trace (each rolled node's journey
        from ``upgrade-required`` to ``upgrade-done``, every transition's
        cause inside a bucket span, every bucket span under a pass span),
        scrape the metrics (the passes counted are the passes observed),
        and print both. The trace's summary and the scrape."""
        import contextlib
        import io

        from k8s_operator_libs_tpu_torch.tools import trace_view

        label = self.label
        path = os.path.join(workdir, f"{label}-trace.jsonl")
        exported = self.tracer.export_jsonl(path)
        spans = trace_view.load_spans(path)
        by_id = {s["span"]: s for s in spans}
        names: dict = {}
        events: dict = {}
        for s in spans:
            names[s["name"]] = names.get(s["name"], 0) + 1
            for event in s["events"]:
                events[event["name"]] = events.get(event["name"], 0) + 1
        orphans = [s["name"] for s in spans if s["name"].startswith("bucket.")
                   and by_id.get(s["parent"], {}).get("name") != "reconcile.pass"]
        if orphans:
            raise AssertionError(f"{label}: bucket spans outside a pass: {orphans}")
        start = min(s["start"] for s in spans)
        journeys = {}
        for node in nodes:
            legs = trace_view.node_journey(spans, node)
            for leg in legs:
                cause = by_id.get(leg["span"])
                while cause is not None and not cause["name"].startswith("bucket."):
                    cause = by_id.get(cause["parent"])
                leg["bucket"] = cause["name"] if cause is not None else None
            tos = [leg["to"] for leg in legs]
            if ("upgrade-required" not in tos or tos[-1] != "upgrade-done"
                    or any(b["from"] != a["to"] for a, b in zip(legs, legs[1:]))
                    or any(leg["bucket"] is None for leg in legs)):
                raise AssertionError(f"{label}: {node}'s journey is not whole: {legs}")
            journeys[node] = [
                [round(leg["ts"] - start, 3), leg["from"], leg["to"], leg["cause"],
                 leg["bucket"], leg["pass"], len(leg["woken_by"])]
                for leg in legs
            ]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = trace_view.main([path, "--node", nodes[0], "--json"])
        if rc != 0 or json.loads(out.getvalue())["journey"] != trace_view.node_journey(
                spans, nodes[0]):
            raise AssertionError(f"{label}: trace_view's command line gave rc {rc}")
        trace = {
            "phase": label,
            "exported": exported,
            "started": self.tracer.started,
            "finished": self.tracer.finished,
            "spans_by_name": dict(sorted(names.items())),
            "events_by_name": dict(sorted(events.items())),
            "attribution": trace_view.attribution(spans),
            "journeys": journeys,
        }
        print(json.dumps({"trace": trace, "card": card}), flush=True)
        scraped = self.scrape()
        print(json.dumps({"metrics": {"phase": label, **scraped}, "card": card}), flush=True)
        if scraped["gauges"].get("reconcile_passes_total") != self.observed:
            raise AssertionError(f"{label}: /metrics counts "
                                 f"{scraped['gauges'].get('reconcile_passes_total')} passes, "
                                 f"{self.observed} were observed")
        return {"trace": trace, "metrics": scraped}


def checkpoint_roll(client, mgr, installer, kubelet, workload, trainer, observe=None) -> dict:
    """Roll under ``CHECKPOINT_POLICY``, the simulator ticked and the
    trainer synced once a pass, each pass's checkpoint stats and whether
    each node holds a manifest read after it (``observe(state)`` after
    each pass that built one); then tick until every evicted job is back
    and past the step it stopped at."""
    from k8s_operator_libs_tpu_torch.kube.objects import Node

    pass_stats: list[dict] = []
    manifests: list[dict] = []

    def before_apply() -> None:
        workload.step()
        trainer.sync()

    def after_apply() -> bool:
        stats = mgr.last_pass_stats
        pass_stats.append({f: getattr(stats, f) for f in CHECKPOINT_STATS})
        manifests.append({
            n.name: mgr.keys.checkpoint_manifest_annotation in Node(n.raw).annotations
            for n in client.list("Node")
        })
        return True

    run = drive_roll("checkpoint_roll", client, mgr, installer, kubelet,
                     before_apply=before_apply, after_apply=after_apply,
                     policy=CHECKPOINT_POLICY, observe=observe)
    ticks = 0
    while not trainer.caught_up():
        if ticks == CATCH_UP_TICKS:
            raise AssertionError(f"checkpoint_roll: the jobs did not come back in "
                                 f"{CATCH_UP_TICKS} ticks: {trainer.restores}")
        workload.step()
        trainer.sync()
        ticks += 1
    return {**run, "catch_up_ticks": ticks, "pass_stats": pass_stats,
            "manifests_by_pass": manifests}


def check_checkpoint_roll(run: dict, nodes, mgr, workload, trainer, events) -> dict:
    """The arc on every node (``checkpoint-required``, then
    ``drain-required``, then ``validation-required``; a coordinated drain;
    the manifest written, then retired; each checkpoint verified, none
    escalated) and the trainer's account (its steps trained again are the
    simulator's lost steps, below its total; each restore equal to its
    save). The summary."""
    label = "checkpoint_roll"
    for name in nodes:
        states = [step[1] for step in run["trajectories"][name]]
        wanted = ("checkpoint-required", "drain-required", "validation-required", "upgrade-done")
        missing = [w for w in wanted if w not in states]
        order = [states.index(w) for w in wanted if w in states]
        if missing or order != sorted(order):
            raise AssertionError(f"{label}: {name} went {states}")
        drains = [m for n, _, m in events if n == name and m.startswith("Scheduling")]
        if drains != ["Scheduling checkpoint-coordinated drain of the node"]:
            raise AssertionError(f"{label}: {name}'s drain events {drains}")
        held = [m[name] for m in run["manifests_by_pass"]]
        if not any(held) or held[-1]:
            raise AssertionError(f"{label}: {name}'s manifest by pass {held}")
    totals = mgr.common.checkpoint_manager.totals()
    if (totals["restores_verified"] != len(nodes) or totals["completions"] != len(nodes)
            or totals["escalations"] or totals["restore_escalations"]):
        raise AssertionError(f"{label}: checkpoint totals {totals}")
    steps = {"lost_steps": workload.lost_steps(), "total_steps": workload.total_steps(),
             "restarts": workload.restarts(), "retrained_steps": trainer.retrained()}
    if steps["retrained_steps"] != steps["lost_steps"] or not (
            steps["lost_steps"] < steps["total_steps"]):
        raise AssertionError(f"{label}: steps {steps}")
    if len(trainer.restores) != steps["restarts"] or steps["restarts"] != len(nodes):
        raise AssertionError(f"{label}: restores {trainer.restores}, steps {steps}")
    for restore in trainer.restores:
        if not restore["params_equal"] or restore["first_loss"] != restore["loss_at_save"] or (
                restore["loss_before_eviction"] is not None
                and restore["first_loss"] != restore["loss_before_eviction"]):
            raise AssertionError(f"{label}: a restore differs from its save: {restore}")
    summed = {f: sum(s[f] for s in run["pass_stats"]) for f in CHECKPOINT_STATS[:4]}
    lifetime = {f: run["pass_stats"][-1][f] for f in CHECKPOINT_STATS[4:]}
    return {**steps, "totals": totals, "pass_stats_summed": summed,
            "pass_stats_lifetime": lifetime}


def checkpoint_roll_phase(card: str, gate_launches: dict, cache_root: str) -> dict:
    """Two more GPU nodes rolled from driver 550 to 560 by the port's machine
    with the checkpoint arc: a training pod a node (the port's
    ``CheckpointingWorkloadSimulator``, ticked once a pass), each backed
    by a real trainer of the flagship model on the card, checkpointed
    before its node's drain and restored after; each node's probe pod
    validates it on a roll-phase node's kernel cache."""
    import torch

    from k8s_operator_libs_tpu_torch.entry import ENTRY_CFG
    from k8s_operator_libs_tpu_torch.kube.sim import CheckpointingWorkloadSimulator
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
        ValidationPodManager,
        ValidationPodSpec,
    )
    from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager, DeviceClass

    client = DictClient()
    installer = roll_pool(client, CHECKPOINT_NODES)
    recorder = EventLog()
    mgr = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"), recorder=recorder)
    mgr.with_validation_enabled(
        pod_provisioner=ValidationPodManager(client, ValidationPodSpec())
    )
    workload = CheckpointingWorkloadSimulator(client, mgr.keys, namespace=TRAINING_NS,
                                              name="trainer")
    caches = {c: os.path.join(cache_root, r) for c, r in zip(CHECKPOINT_NODES, ROLL_NODES)}
    print(f"checkpoint_roll: each node's probe pod takes the kernel cache of "
          f"{json.dumps(dict(zip(CHECKPOINT_NODES, ROLL_NODES)))} from the roll phase, "
          "so its payload skips nvcc", flush=True)
    traced = TracedPhase("checkpoint_roll")
    with tempfile.TemporaryDirectory(prefix="checkpoint-roll-") as workdir:
        try:
            traced.serve(mgr)
            trainer = Trainer(client, workload, mgr.keys, ENTRY_CFG, "cuda", TRAINER_SEED,
                              os.path.join(workdir, "checkpoints"), CHECKPOINT_NODES)
            kubelet = RollKubelet(client, installer, CHECKPOINT_NODES, workdir, gate_launches,
                                  caches)
            try:
                run = checkpoint_roll(client, mgr, installer, kubelet, workload, trainer,
                                      observe=traced.observe)
            finally:
                mgr.runner.shutdown()
            torch.cuda.synchronize()
            controller = counts()
            traced_report = traced.report(workdir, CHECKPOINT_NODES, card)
        finally:
            traced.close()
    runs = kubelet.probe_runs
    step_ms = sorted(trainer.step_ms)
    result = {
        "nodes": list(CHECKPOINT_NODES),
        "versions": list(ROLL_VERSIONS),
        "policy": CHECKPOINT_POLICY,
        **run,
        "probe_pods": runs,
        "pod_launches": total_launches(runs.values()),
        "controller_launches": {lib: controller[lib] for lib in ("matmul", "flash_attention")},
        "trainer": {
            "cfg": {k: str(v) if k == "dtype" else v
                    for k, v in dataclasses.asdict(ENTRY_CFG).items()},
            "steps_trained": len(step_ms),
            "ms_per_step_median": step_ms[len(step_ms) // 2],
            "ms_per_step_mean": sum(step_ms) / len(step_ms),
            "ms_first_step": trainer.step_ms[0],
            "save_s": trainer.save_s,
            "load_s": trainer.load_s,
            "restores": trainer.restores,
            "replay_loss_diffs": {j.pod: j.replay_loss_diffs for j in trainer.jobs.values()},
        },
        "drain_events": [e for e in recorder.events if e[2].startswith("Scheduling")],
        "lost_steps": workload.lost_steps(),
        "total_steps": workload.total_steps(),
        "restarts": workload.restarts(),
        "retrained_steps": trainer.retrained(),
        "checkpoint_totals": mgr.common.checkpoint_manager.totals(),
        "pods_after": sorted(p.name for p in client.list("Pod")),
        "observed_passes": traced.observed,
    }
    print(json.dumps({"checkpoint_roll": result, "card": card}), flush=True)
    gauges = traced_report["metrics"]["gauges"]
    if gauges.get("checkpoint_escalations_total") != 0 or gauges.get(
            "checkpoint_completed_total") != len(CHECKPOINT_NODES):
        raise AssertionError(f"checkpoint_roll: /metrics {gauges}")
    if traced.observed != run["passes"] - run["build_state_retries"]:
        raise AssertionError(f"checkpoint_roll: {traced.observed} passes observed of "
                             f"{run['passes']} ({run['build_state_retries']} aborted)")
    spans, events = (traced_report["trace"][k] for k in ("spans_by_name", "events_by_name"))
    wanted = {"checkpoint.complete": len(CHECKPOINT_NODES),
              "checkpoint.restore_verified": len(CHECKPOINT_NODES)}
    if (not spans.get("bucket.checkpoint") or not spans.get("drain.node")
            or any(events.get(k) != v for k, v in wanted.items())
            or not events.get("checkpoint.request") or events.get("checkpoint.escalate")):
        raise AssertionError(f"checkpoint_roll: the trace's arc: {spans} {events}")
    result["summary"] = check_checkpoint_roll(run, CHECKPOINT_NODES, mgr, workload, trainer,
                                              recorder.events)
    if controller["matmul"] or controller["flash_attention"]:
        raise AssertionError(f"checkpoint_roll: the controller launched kernels: {controller}")
    built = {name: run["build_s"] for name, run in runs.items() if any(run["build_s"].values())}
    if built:
        raise AssertionError(f"checkpoint_roll: pods built their kernels again: {built}")
    check_rolled_pods("checkpoint_roll", client, installer, CHECKPOINT_NODES, runs,
                      others=[job.pod for job in trainer.jobs.values()])
    return result


def put_report(client, raw: dict) -> None:
    """Write ``raw`` (a NodeHealthReport as the monitor published it) as the
    node's live report: created, or replacing the one there."""
    from k8s_operator_libs_tpu_torch.kube.client import get_or_none
    from k8s_operator_libs_tpu_torch.kube.objects import deep_copy_json, wrap

    body = deep_copy_json(raw)
    name = body["metadata"]["name"]
    body["metadata"] = {"name": name}
    existing = get_or_none(client, "NodeHealthReport", name)
    if existing is None:
        client.create(wrap(body))
        return
    body["metadata"]["resourceVersion"] = existing.resource_version
    client.update(wrap(body))


def quarantine_policy(healthy_score: float, degraded_score: float) -> dict:
    """The roll's policy with the quarantine arc: the entry threshold halfway
    between the two reports' scores, recovery at the healthy report's."""
    return {
        **ROLL_POLICY,
        "quarantine": {
            "enable": True,
            "unhealthyScore": (healthy_score + degraded_score) / 2,
            "recoveryScore": healthy_score,
            "reprobeBackoffSeconds": QUARANTINE_BACKOFF_S,
            "maxBackoffSeconds": QUARANTINE_MAX_BACKOFF_S,
            "handoffAfterSeconds": QUARANTINE_HANDOFF_S,
        },
    }


class VirtualClock:
    """The quarantine manager's clock, advanced past its deadlines by the
    phase instead of waited out."""

    def __init__(self, start: float) -> None:
        self.now = start

    def wall(self) -> float:
        return self.now


def quarantine_arc(client, mgr, installer, kubelet, reports: dict, events) -> dict:
    """The quarantine arc of ``QUARANTINE_NODES[0]`` on ``mgr`` (with health
    telemetry), driven by ``reports`` ("healthy" and "degraded", raw
    NodeHealthReports): settle the pool, the degraded report quarantines
    and cordons the node alone, a recheck past the backoff keeps it and
    doubles the backoff, the healthy report releases and uncordons it and
    the next pass classifies it done, the degraded report again and the
    hand-off deadline send it still cordoned to ``upgrade-required``, and
    the roll takes it to ``upgrade-done`` through its probe pod. The
    quarantine clock is virtual; every other wait is bounded. Each pass's
    node states, the scores, thresholds and totals, and the counters
    ``HealthMetrics`` renders."""
    from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.upgrade import HealthMetrics

    node = QUARANTINE_NODES[0]
    keys = mgr.keys
    source = mgr.health_source
    qm = mgr.common.quarantine_manager
    clock = VirtualClock(time.time())
    qm._now = clock.wall
    scores = {k: float(raw["status"]["score"]) for k, raw in reports.items()}
    if not scores["degraded"] < scores["healthy"]:
        raise AssertionError(f"quarantine: the failing report does not score lower: {scores}")
    doc = quarantine_policy(scores["healthy"], scores["degraded"])
    policy = DriverUpgradePolicySpec.from_dict(doc)
    family = HealthMetrics(source, quarantine_totals=qm.totals)
    passes: list = []

    def nodes() -> dict:
        return {n.name: Node(n.raw) for n in client.list("Node")}

    def one_pass(label: str) -> dict:
        kubelet.tick()
        mgr.apply_state(mgr.build_state(installer.spec.namespace, installer.match_labels),
                        policy)
        states = {name: [n.labels.get(keys.state_label, ""), bool(n.unschedulable)]
                  for name, n in nodes().items()}
        passes.append({"label": label, "clock_s": round(clock.now - start, 3), "states": states})
        return states

    def expect(label: str, states: dict, wanted: list) -> None:
        others = {n: s for n, s in states.items() if n != node}
        if states[node] != wanted or any(s != ["upgrade-done", False] for s in others.values()):
            raise AssertionError(f"quarantine: after {label} {states}, {node} should be {wanted}")

    def report(kind: str) -> None:
        put_report(client, reports[kind])
        deadline = time.perf_counter() + WATCH_SETTLE_S
        while (source.health_of(node) is None
               or source.health_of(node).score != scores[kind]):
            if time.perf_counter() > deadline:
                raise AssertionError(f"quarantine: the health source never saw the {kind} report")
            time.sleep(0.01)

    start = clock.now
    kubelet.tick()  # the driver pods
    for _ in range(3):
        states = one_pass("settle")
    expect("settling", states, ["upgrade-done", False])
    report("degraded")
    expect("the degraded report", one_pass("degraded"), ["quarantined", True])
    if not any(n == node and "quarantined" in m for n, _, m in events.events):
        raise AssertionError(f"quarantine: no event says {node} was quarantined: {events.events}")
    clock.now += QUARANTINE_BACKOFF_S + 1
    expect("the first recheck", one_pass("recheck"), ["quarantined", True])
    backoff = nodes()[node].annotations.get(keys.quarantine_backoff_annotation)
    if backoff != str(2 * QUARANTINE_BACKOFF_S):
        raise AssertionError(f"quarantine: backoff {backoff} after a recheck that found it sick")
    report("healthy")
    clock.now += 2 * QUARANTINE_BACKOFF_S + 1
    expect("the healthy report", one_pass("recovered"), ["", False])
    expect("the reclassification", one_pass("reclassified"), ["upgrade-done", False])
    report("degraded")
    expect("the degraded report again", one_pass("degraded-again"), ["quarantined", True])
    clock.now += QUARANTINE_HANDOFF_S + 1
    expect("the hand-off deadline", one_pass("handoff"), ["upgrade-required", True])
    roll_start = last_change = time.perf_counter()
    while True:
        states = one_pass("roll")
        if states[node] == ["upgrade-done", False]:
            break
        if states[node][0] == "upgrade-failed":
            raise AssertionError(f"quarantine: the roll failed {node}: {passes[-1]}")
        if passes[-2]["states"][node] != states[node]:
            last_change = time.perf_counter()
        elif time.perf_counter() - last_change > ROLL_STALL_S:
            raise AssertionError(f"quarantine: {node} stuck in {states[node]}")
        time.sleep(ROLL_PASS_INTERVAL_S)
    expect("the roll", states, ["upgrade-done", False])
    rendered = family.render()
    counters = {
        key: int(line.rsplit(" ", 1)[1])
        for line in rendered.splitlines()
        for key, name in (("entered", "entries"), ("released", "releases"),
                          ("handed_off", "handoffs"))
        if line.startswith(f"tpu_operator_health_quarantine_{name}_total ")
    }
    if counters != {"entered": 2, "released": 1, "handed_off": 1}:
        raise AssertionError(f"quarantine: HealthMetrics counted {counters}: {rendered}")
    return {
        "node": node,
        "scores": scores,
        "thresholds": {"unhealthy": doc["quarantine"]["unhealthyScore"],
                       "recovery": doc["quarantine"]["recoveryScore"]},
        "passes": passes,
        "roll_wall_s": time.perf_counter() - roll_start,
        "totals": qm.totals(),
        "counters": counters,
        "events": [m for n, _, m in events.events if n == node and "uarantine" in m],
    }


def quarantine_phase(card: str, gate_launches: dict, cache_root: str, reports: dict) -> dict:
    """The quarantine arc on the port's machine with health telemetry, over
    the monitor phase's two published reports of the card, in a pool of
    ``QUARANTINE_NODES``; the handed-off node's probe pod validates it on a
    roll-phase node's kernel cache."""
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
        ValidationPodManager,
        ValidationPodSpec,
    )
    from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager, DeviceClass

    start = time.perf_counter()
    client = DictClient()
    installer = roll_pool(client, QUARANTINE_NODES)
    events = EventLog()
    mgr = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"), recorder=events)
    mgr.with_validation_enabled(
        pod_provisioner=ValidationPodManager(client, ValidationPodSpec())
    )
    caches = {name: os.path.join(cache_root, ROLL_NODES[0]) for name in QUARANTINE_NODES}
    print(f"quarantine: {QUARANTINE_NODES[0]}'s probe pod takes the kernel cache of "
          f"{ROLL_NODES[0]} from the roll phase, so its payload skips nvcc", flush=True)
    source = mgr.with_health_telemetry()
    try:
        with tempfile.TemporaryDirectory(prefix="quarantine-") as workdir:
            kubelet = RollKubelet(client, installer, QUARANTINE_NODES, workdir, gate_launches,
                                  caches)
            reset_counts()
            run = quarantine_arc(client, mgr, installer, kubelet, reports, events)
            controller = counts()
    finally:
        source.stop()
        mgr.runner.shutdown()
    runs = kubelet.probe_runs
    result = {
        **run,
        "healthy_card_score": run["scores"]["healthy"],
        "probe_pods": runs,
        "pod_launches": total_launches(runs.values()),
        "controller_launches": {lib: controller[lib] for lib in ("matmul", "flash_attention")},
        "wall_s": time.perf_counter() - start,
    }
    print(json.dumps({"quarantine": result, "card": card}), flush=True)
    if [r["node"] for r in runs.values()] != [QUARANTINE_NODES[0]]:
        raise AssertionError(f"quarantine: probe pods ran on {[r['node'] for r in runs.values()]}")
    built = {name: r["build_s"] for name, r in runs.items() if any(r["build_s"].values())}
    if built:
        raise AssertionError(f"quarantine: the probe pod built its kernels again: {built}")
    if controller["matmul"] or controller["flash_attention"]:
        raise AssertionError(f"quarantine: the controller launched kernels: {controller}")
    return result


def write_kubeconfig(workdir: str, url: str) -> str:
    """A JSON kubeconfig at ``url`` in ``workdir``; its path."""
    path = os.path.join(workdir, "kubeconfig")
    with open(path, "w") as f:
        json.dump({
            "current-context": "c",
            "clusters": [{"name": "c", "cluster": {"server": url}}],
            "users": [{"name": "u", "user": {}}],
            "contexts": [{"name": "c", "context": {"cluster": "c", "user": "u"}}],
        }, f)
    return path


def crdutil_child(label: str, client, url: str, workdir: str, *args: str) -> dict:
    """``python -m k8s_operator_libs_tpu_torch.crdutil`` on the repo's CRDs
    with a kubeconfig at ``url``; its seconds, last line, and the discovery
    polls and updates the stub served it. A non-zero exit fails the
    phase."""
    env = child_env(KUBECONFIG=write_kubeconfig(workdir, url), HOME=workdir)
    env.pop("KUBERNETES_SERVICE_HOST", None)
    polls = client.calls.get("discover", 0)
    updates = client.calls.get("update", 0)
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.crdutil",
         "--crds-path", os.path.join(REPO, "manifests", "crds"), *args],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
    )
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"crdutil {label}: rc {proc.returncode}: {proc.stderr[-2000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    return {"seconds": seconds, "last_line": last,
            "discovery_polls": client.calls.get("discover", 0) - polls,
            "updates": client.calls.get("update", 0) - updates}


def crd_state(client) -> dict:
    """Each of ``CRDS``: its resourceVersion and whether discovery lists
    its plural at each served version (None where it is not stored)."""
    from k8s_operator_libs_tpu_torch.kube.client import NotFoundError, get_or_none
    from k8s_operator_libs_tpu_torch.kube.objects import CustomResourceDefinition

    out = {}
    for name in CRDS:
        obj = get_or_none(client, "CustomResourceDefinition", name)
        if obj is None:
            out[name] = None
            continue
        crd = CustomResourceDefinition(obj.raw)
        served = {}
        for version in crd.served_versions:
            try:
                served[version] = any(
                    r["name"] == crd.plural for r in client.discover(crd.group, version)
                )
            except NotFoundError:
                served[version] = False
        out[name] = {"resource_version": crd.resource_version, "discoverable": served}
    return out


class HoldPodStream:
    """A fault plan: ``HOLD`` at the informers' ``watch.deliver`` point for
    the Pod stream, every other consult answered with nothing."""

    def __init__(self) -> None:
        self.holds = 0

    def consult(self, point: str, ctx: dict):
        from k8s_operator_libs_tpu_torch.utils.faultpoints import HOLD, FaultAction

        if point == "watch.deliver" and ctx.get("kind") == "Pod":
            self.holds += 1
            return FaultAction(HOLD)
        return None


def settled_passes(mgr, ns: str, labels: dict, policy, observe, tracer) -> list:
    """``SETTLED_PASSES`` passes of a settled pool, each observed; each
    pass's reads, writes, source counters, ``build_state`` and pass
    milliseconds, bucket seconds, whether the manager's build counter
    made it an audit, and the spans it started and the finished spans'
    names and categories (None when ``tracer`` is None: the tracer is
    cleared)."""
    out = []
    for _ in range(SETTLED_PASSES):
        started = tracer.started if tracer is not None else 0
        finished = tracer.finished if tracer is not None else 0
        t0 = time.perf_counter()
        state = mgr.build_state(ns, labels)
        build_ms = (time.perf_counter() - t0) * 1e3
        mgr.apply_state(state, policy)
        pass_ms = (time.perf_counter() - t0) * 1e3
        observe(state)
        st = mgr.last_pass_stats
        ended = None
        if tracer is not None:
            new = tracer.finished - finished
            ended = [(r["name"], r["category"]) for r in tracer.records()[-new:]] if new else []
        out.append({"audit": mgr._incremental_builds % VERIFY_EVERY_N == 0,
                    "build_state_ms": build_ms, "pass_ms": pass_ms,
                    "reads_issued": st.reads_issued, "writes_issued": st.writes_issued,
                    "snapshot_skipped": st.snapshot_skipped, "full_rebuild": st.full_rebuild,
                    "dirty_node_count": st.dirty_node_count,
                    "verify_divergences": st.verify_divergences,
                    "delta_hit_rate": st.delta_hit_rate,
                    "bucket_seconds": dict(st.bucket_seconds),
                    "spans": None if tracer is None else tracer.started - started,
                    "ended": ended})
    return out


def check_settled_spans(settled: list) -> None:
    """A settled pass served from the kept state opens no span and times
    no bucket. The others are the audits, where the manager's build
    counter is a multiple of ``VERIFY_EVERY_N`` (``SETTLED_PASSES //
    VERIFY_EVERY_N`` of them), and at most one delta pass, the first,
    which consumes the roll's last write (an audit in its place consumes
    it instead). Each of those opens one ``reconcile.pass`` span, ends
    every span it opens, and all of them are of the ``reconcile``
    category: a classify bucket, no drain, probe, write or checkpoint."""
    audits = [i for i, p in enumerate(settled) if p["audit"]]
    deltas = [i for i, p in enumerate(settled)
              if not p["audit"] and not p["snapshot_skipped"]]
    if len(audits) != SETTLED_PASSES // VERIFY_EVERY_N or deltas not in ([], [0]):
        raise AssertionError(f"informer_roll: settled passes {audits} audited, {deltas} "
                             f"took deltas: {settled}")
    if any(not settled[i]["full_rebuild"] or settled[i]["snapshot_skipped"] for i in audits):
        raise AssertionError(f"informer_roll: an audit did not rebuild: {settled}")
    for i, p in enumerate(settled):
        names = [name for name, _ in p["ended"]]
        if i in audits or i in deltas:
            wrong = (names.count("reconcile.pass") != 1 or p["spans"] != len(names)
                     or any(cat != "reconcile" for _, cat in p["ended"]))
        else:
            wrong = bool(p["spans"] or names or p["bucket_seconds"])
        if wrong:
            raise AssertionError(f"informer_roll: settled pass {i} traced {p}")


def stale_view(client, mgr, source, kubelet, installer, policy, traced, caught_up) -> dict:
    """One pass over a stale informer view, then its heal: with the Pod
    stream held (``HoldPodStream``), ``JOIN_NODE`` joins the driver pool
    (a Ready driver pod at the current version, the DaemonSet's desired
    count one higher); the pass must abort on the completeness check,
    counted in ``aborted_completeness_races``. The plan cleared and the
    stores caught up, passes run until the pool settles; the first must
    be a full rebuild, and the joined node ends ``upgrade-done``."""
    from k8s_operator_libs_tpu_torch.kube.objects import DaemonSet, Node
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.upgrade import BuildStateError
    from k8s_operator_libs_tpu_torch.utils import faultpoints

    label = "informer_roll stale view"
    ns, labels = installer.spec.namespace, installer.match_labels
    plan = HoldPodStream()
    faultpoints.install_plan(plan)
    try:
        node = Node.new(JOIN_NODE, labels=local_gpu_labels())
        node.set_ready(True)
        client.create(node)
        kubelet.nodes = (*kubelet.nodes, JOIN_NODE)
        ds = DaemonSet(client.get("DaemonSet", installer.name, ns).raw)
        kubelet.ensure_driver_pod(ds, JOIN_NODE, ready=True)
        kubelet.tick()  # the desired count follows the pool

        def stale() -> bool:
            desired = [(o.raw.get("status") or {}).get("desiredNumberScheduled")
                       for o in source.informer("DaemonSet").list(copy=False)]
            nodes = {o.name for o in source.informer("Node").list(copy=False)}
            return plan.holds > 0 and desired == [len(kubelet.nodes)] and JOIN_NODE in nodes

        deadline = time.monotonic() + 5.0
        while not stale():
            if time.monotonic() > deadline:
                raise AssertionError(f"{label}: the stores did not reach the stale view")
            time.sleep(0.01)
        pods_in_store = len(source.informer("Pod").list(copy=False))
        try:
            mgr.build_state(ns, labels)
        except BuildStateError as e:
            error = str(e)
        else:
            raise AssertionError(f"{label}: the pass over the held Pod stream did not abort")
        abort = mgr.last_pass_stats
    finally:
        faultpoints.clear_plan()
    heal = []
    for _ in range(SETTLED_PASSES):
        caught_up()
        state = mgr.build_state(ns, labels)
        mgr.apply_state(state, policy)
        traced.observe(state)
        st = mgr.last_pass_stats
        heal.append({"full_rebuild": st.full_rebuild, "snapshot_skipped": st.snapshot_skipped,
                     "dirty_node_count": st.dirty_node_count,
                     "nodes_reclassified": st.nodes_reclassified,
                     "reads_issued": st.reads_issued, "writes_issued": st.writes_issued,
                     "snapshot_s": st.snapshot_s, "apply_s": st.apply_s,
                     "bucket_seconds": dict(st.bucket_seconds),
                     "aborted_completeness_races": st.aborted_completeness_races})
        if st.snapshot_skipped:
            break
    joined = Node(client.get("Node", JOIN_NODE).raw)
    result = {
        "joined_node": JOIN_NODE,
        "pod_stream_holds": plan.holds,
        "pods_in_store_at_abort": pods_in_store,
        "error": error,
        "abort": {"aborted_completeness_races": abort.aborted_completeness_races,
                  "snapshot_s": abort.snapshot_s},
        "completeness_aborts_total": mgr.completeness_aborts_total,
        "heal": heal,
        "joined_state": joined.labels.get(mgr.keys.state_label, ""),
        "probe_pod_for_joined": any(r["node"] == JOIN_NODE
                                    for r in kubelet.probe_runs.values()),
    }
    if (abort.aborted_completeness_races != 1 or mgr.completeness_aborts_total != 1
            or "desired" not in error):
        raise AssertionError(f"{label}: the abort {result}")
    if not heal[0]["full_rebuild"] or not heal[-1]["snapshot_skipped"]:
        raise AssertionError(f"{label}: the heal {heal}")
    if result["joined_state"] != "upgrade-done" or joined.unschedulable:
        raise AssertionError(f"{label}: {JOIN_NODE} ended {result['joined_state']}")
    return result


def informer_roll_phase(card: str, gate_launches: dict, cache_root: str) -> dict:
    """The CRD utility's command line against ``ApiStub``, then a roll of
    ``INFORMER_NODES`` among ``WATCH_POOL_NODES`` other nodes by the port's
    machine reading from an incremental informer source with its writes
    batched; settled passes, an audit and a pass from the LIST source
    after it. The probe pods run on roll-phase kernel caches."""
    from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
    from k8s_operator_libs_tpu_torch.kube.client import get_or_none
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import (
        ValidationPodManager,
        ValidationPodSpec,
    )
    from k8s_operator_libs_tpu_torch.upgrade import (
        ClusterUpgradeStateManager,
        DeviceClass,
        UpgradeKeys,
    )

    start = time.perf_counter()
    keys = UpgradeKeys(DeviceClass.nvidia("gpu"))
    client = DictClient()
    client.discovery_delay_s = CRD_DISCOVERY_DELAY_S
    crd = {}
    with ApiStub(client) as stub, tempfile.TemporaryDirectory(prefix="crdutil-") as workdir:
        crd["apply"] = crdutil_child("apply", client, stub.url, workdir, "--operation", "apply")
        crd["after_apply"] = crd_state(client)
        crd["update"] = crdutil_child("update", client, stub.url, workdir, "--operation", "apply")
        crd["after_update"] = crd_state(client)
        for name in CRDS:
            first, again = crd["after_apply"][name], crd["after_update"][name]
            if first is None or not all(first["discoverable"].values()):
                raise AssertionError(f"informer_roll: {name} not discoverable after apply: {crd}")
            if again is None or not all(again["discoverable"].values()):
                raise AssertionError(f"informer_roll: {name} not discoverable after update: {crd}")
        # The second apply updates each CRD in place; an update that changes
        # nothing keeps its resourceVersion, as on the API server.
        if crd["update"]["updates"] < len(CRDS):
            raise AssertionError(f"informer_roll: the second apply did not update the CRDs: {crd}")
        for step in ("apply", "update"):
            if crd[step]["last_line"] != f"apply: processed {len(CRDS)} CRD(s)":
                raise AssertionError(f"informer_roll: crdutil {step} printed {crd[step]}")
        if crd["apply"]["discovery_polls"] < 2:
            raise AssertionError(f"informer_roll: the wait did not poll discovery: {crd}")

        traced = TracedPhase("informer_roll")
        try:
            for i in range(WATCH_POOL_NODES):
                client.create(pool_node(f"cpu-pool-{i:03d}", INFORMER_OTHER_POOL))
            installer = roll_pool(client, INFORMER_NODES)
            mgr = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"))
            mgr.with_validation_enabled(
                pod_provisioner=ValidationPodManager(client, ValidationPodSpec())
            )
            traced.serve(mgr)
            ns, labels = installer.spec.namespace, installer.match_labels
            source = mgr.with_snapshot_from_informers(
                ns, labels, incremental=True, verify_every_n=VERIFY_EVERY_N
            )
            batcher = mgr.enable_write_batching()
            caches = {name: os.path.join(cache_root, ROLL_NODES[i % len(ROLL_NODES)])
                      for i, name in enumerate(INFORMER_NODES)}
            print(f"informer_roll: the probe pods take the kernel caches of "
                  f"{list(ROLL_NODES)} from the roll phase, so their payloads skip nvcc",
                  flush=True)
            stats: list = []

            def caught_up() -> None:
                """Wait (at most 5 s) until the source's stores hold what the
                client holds, so a pass reads what the kubelet just wrote."""
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline:
                    if all(
                        {o.name: o.resource_version
                         for o in source.informer(kind).list(copy=False)}
                        == {o.name: o.resource_version for o in client.list_with_revision(
                            kind, ns if kind != "Node" else "",
                            labels if kind in ("Pod", "DaemonSet") else None)[0]}
                        for kind in ("Node", "Pod", "DaemonSet", "ControllerRevision")
                    ):
                        return
                    time.sleep(0.01)
                raise AssertionError("informer_roll: the informers did not catch up in 5 s")

            def delivered() -> None:
                """``caught_up()``, and every stored revision handed to the
                handlers too (a write-through lands in the store before its
                watch echo is delivered), so the settled passes start from
                a quiet stream."""
                caught_up()
                deadline = time.monotonic() + 5.0
                while any(source.informer(kind).pending_dispatch()[0]
                          for kind in ("Node", "Pod", "DaemonSet", "ControllerRevision")):
                    if time.monotonic() > deadline:
                        raise AssertionError("informer_roll: deliveries still pending after 5 s")
                    time.sleep(0.01)

            def after_apply() -> bool:
                stats.append(dataclasses.asdict(mgr.last_pass_stats))
                return True

            try:
                with tempfile.TemporaryDirectory(prefix="informer-roll-") as podwork:
                    kubelet = RollKubelet(client, installer, INFORMER_NODES, podwork,
                                          gate_launches, caches)
                    run = drive_roll("informer_roll", client, mgr, installer, kubelet,
                                     before_apply=caught_up, after_apply=after_apply,
                                     observe=traced.observe)
                    controller = counts()
                    policy = DriverUpgradePolicySpec.from_dict(ROLL_POLICY)
                    delivered()
                    calls_before = dict(client.calls)
                    settled = settled_passes(mgr, ns, labels, policy, traced.observe,
                                             traced.tracer)
                    settled_calls = {k: v - calls_before.get(k, 0)
                                     for k, v in client.calls.items()
                                     if v != calls_before.get(k, 0)}
                    # The same passes again with the tracer cleared: what
                    # tracing costs a settled pass.
                    traced.pause()
                    try:
                        untraced = settled_passes(mgr, ns, labels, policy, traced.observe,
                                                  None)
                    finally:
                        traced.resume()
                    audit = mgr.audit_incremental(ns, labels)
                    listing = ClusterUpgradeStateManager(client, DeviceClass.nvidia("gpu"))
                    list_ms = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        list_state = listing.build_state(ns, labels)
                        list_ms.append((time.perf_counter() - t0) * 1e3)
                    listing.apply_state(list_state, policy)
                    list_pass = dataclasses.asdict(listing.last_pass_stats)
                    stale = stale_view(client, mgr, source, kubelet, installer, policy,
                                       traced, caught_up)
                    controller_after = counts()
                    relists = {kind: source.informer(kind).full_relists
                               for kind in ("Node", "Pod", "DaemonSet", "ControllerRevision")}
            finally:
                source.stop()
                mgr.runner.shutdown()
            traced_report = traced.report(workdir, INFORMER_NODES, card)
        finally:
            traced.close()
        crd["delete"] = crdutil_child("delete", client, stub.url, workdir, "--operation", "delete")
        crd["after_delete"] = crd_state(client)

    runs = kubelet.probe_runs
    others = [f"cpu-pool-{i:03d}" for i in range(WATCH_POOL_NODES)]
    touched = sorted({
        key[2] for _, _, key, raw, _ in client.journal
        if key[0] == "Node" and key[2] in set(others)
        and ((raw.get("spec") or {}).get("unschedulable")
             or any(k.startswith(f"{keys.device.domain}/{keys.device.driver}-driver-")
                    for k in {**(raw["metadata"].get("labels") or {}),
                              **(raw["metadata"].get("annotations") or {})}))
    })
    writes = mgr.provider.write_stats()
    result = {
        "cluster_nodes": len(client.list("Node")),
        "driver_pool": list(INFORMER_NODES),
        "crdutil": crd,
        **run,
        "pass_stats": stats,
        "reads_issued_roll": sum(p["reads_issued"] for p in stats),
        "writes_issued_roll": sum(p["writes_issued"] for p in stats),
        "settled": settled,
        "settled_untraced": untraced,
        "tracing_cost_ms": {
            "traced_skipped_passes": [p["pass_ms"] for p in settled if p["snapshot_skipped"]],
            "untraced_skipped_passes": [p["pass_ms"] for p in untraced
                                        if p["snapshot_skipped"]],
        },
        "stale_view": stale,
        "observed_passes": traced.observed,
        "settled_client_calls": settled_calls,
        "delta_hit_rate": settled[-1]["delta_hit_rate"],
        "batcher": batcher.stats(),
        "provider_writes": {"issued": writes["issued"], "skipped": writes["skipped"]},
        "full_relists": relists,
        "audit_divergences": audit,
        "verify_divergences_total": source.verify_divergences_total,
        "build_state_ms": {"incremental_settled": [p["build_state_ms"] for p in settled],
                           "list": list_ms},
        "list_pass": {k: list_pass[k] for k in ("reads_issued", "writes_issued")},
        "probe_pods": runs,
        "pod_launches": total_launches(runs.values()),
        "controller_launches": {lib: controller[lib] for lib in ("matmul", "flash_attention")},
        "other_nodes_touched": touched,
        "phase_wall_s": time.perf_counter() - start,
    }
    print(json.dumps({"informer_roll": result, "card": card}), flush=True)
    check_rolled_pods("informer_roll", client, installer, INFORMER_NODES, runs,
                      others=[kubelet.pod_name(JOIN_NODE)])
    for name in CRDS:
        if crd["after_delete"][name] is not None:
            raise AssertionError(f"informer_roll: {name} left after the delete")
        if get_or_none(client, "CustomResourceDefinition", name) is not None:
            raise AssertionError(f"informer_roll: {name} still stored")
    if crd["delete"]["last_line"] != f"delete: processed {len(CRDS)} CRD(s)":
        raise AssertionError(f"informer_roll: crdutil delete printed {crd['delete']}")
    if result["cluster_nodes"] != WATCH_POOL_NODES + len(INFORMER_NODES) + 1:  # JOIN_NODE
        raise AssertionError(f"informer_roll: {result['cluster_nodes']} nodes in the cluster")
    if touched:
        raise AssertionError(f"informer_roll: the roll touched other nodes: {touched}")
    bad = [p for p in settled if p["reads_issued"] or p["writes_issued"]]
    if bad or settled_calls:
        raise AssertionError(f"informer_roll: settled passes did work: {bad} {settled_calls}")
    check_settled_spans(settled)
    expected = run["passes"] - run["build_state_retries"] + 2 * SETTLED_PASSES + len(
        stale["heal"])
    if traced.observed != expected:
        raise AssertionError(f"informer_roll: {traced.observed} passes observed, not {expected}")
    if audit or source.verify_divergences_total:
        raise AssertionError(f"informer_roll: the audit found {audit} divergences "
                             f"({source.verify_divergences_total} in all)")
    if batcher.stats()["writes_flushed"] != writes["issued"]:
        raise AssertionError(f"informer_roll: the batcher flushed {batcher.stats()}, "
                             f"the provider issued {writes['issued']}")
    if list_pass["reads_issued"] < 3:
        raise AssertionError(f"informer_roll: the LIST pass read {list_pass['reads_issued']}")
    if any(c["matmul"] or c["flash_attention"] for c in (controller, controller_after)):
        raise AssertionError(f"informer_roll: the controller launched kernels: "
                             f"{controller} {controller_after}")
    built = {name: r["build_s"] for name, r in runs.items() if any(r["build_s"].values())}
    if built:
        raise AssertionError(f"informer_roll: probe pods built their kernels again: {built}")
    result["trace_summary"] = {k: traced_report["trace"][k]
                               for k in ("started", "finished", "spans_by_name")}
    return result

class ControllerReplica:
    """One ``python -m k8s_operator_libs_tpu_torch.upgrade_controller`` child
    over a kubeconfig, its merged stdout and stderr drained continuously
    into ``lines`` (seconds on this process's clock, line). ``flags``
    replace the controller_roll's own (a leader-elected replica woken by
    watch events); ``--trace-export`` and ``--stats-json`` are always
    given; ``env`` adds to the child's environment."""

    def __init__(self, identity: str, kubeconfig: str, policy: str, workdir: str,
                 flags: Optional[list] = None, label: str = "controller_roll",
                 env: Optional[dict] = None) -> None:
        self.identity = identity
        self.label = label
        self.metrics_port = free_port()
        self.trace = os.path.join(workdir, f"{identity}.trace.jsonl")
        self.stats = os.path.join(workdir, f"{identity}.stats.json")
        env = child_env(KUBECONFIG=kubeconfig, HOME=workdir, **(env or {}))
        env.pop("KUBERNETES_SERVICE_HOST", None)
        if flags is None:
            flags = ["--watch", "--interval", str(CONTROLLER_INTERVAL_S), "--validation-pod",
                     "--policy", policy, "--leader-elect", "--leader-elect-id", identity,
                     "--metrics-port", str(self.metrics_port)]
        self.started = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller",
             *flags, "--trace-export", self.trace, "--stats-json", self.stats],
            cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True,
        )
        self.lines: list[tuple[float, str]] = []
        self.drainer = threading.Thread(target=self._drain, daemon=True)
        self.drainer.start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter(), line.rstrip("\n")))

    def first(self, prefix: str) -> Optional[float]:
        """When the first line starting with ``prefix`` was read."""
        return next((t for t, line in list(self.lines) if line.startswith(prefix)), None)

    def passes(self) -> list[float]:
        """When each pass that completed printed its line."""
        return [t for t, line in list(self.lines)
                if re.match(r"pass \d+: ", line) and "reconcile failed" not in line]

    def attempts(self) -> list[float]:
        """When each pass printed its line, those that failed too."""
        return [t for t, line in list(self.lines) if re.match(r"pass \d+: ", line)]

    def wait_for(self, prefix: str, timeout: float) -> float:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            at = self.first(prefix)
            if at is not None:
                return at
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"{self.label}: {self.identity} printed no {prefix!r} "
                             f"(rc {self.proc.poll()}): {self.tail()}")

    def tail(self, n: int = 40) -> str:
        return "\n".join(line for _, line in self.lines[-n:])

    def wait_quiet(self, timeout: float) -> None:
        """Until the replica has printed nothing for ``CONTROLLER_QUIET_S``."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() - max(t for t, _ in self.lines) < CONTROLLER_QUIET_S:
            if time.perf_counter() > deadline:
                raise AssertionError(f"{self.label}: {self.identity} did not go quiet "
                                     f"within {timeout} s: {self.tail()}")
            time.sleep(0.1)

    def scrape(self) -> dict:
        """``/metrics`` once over HTTP: the gauges by name."""
        import urllib.request

        url = f"http://127.0.0.1:{self.metrics_port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        prefix = "tpu_operator_upgrade_"
        gauges = {}
        for line in body.splitlines():
            if line.startswith(prefix) and "{" in line and "bucket=" not in line:
                name, value = line.rsplit(" ", 1)
                gauges[name[len(prefix):].split("{", 1)[0]] = float(value)
        return gauges

    def terminate(self) -> tuple[int, float, float]:
        """SIGTERM; the return code, when the signal was sent and when the
        process ended."""
        import signal

        sent = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=60)
        ended = time.perf_counter()
        self.drainer.join(timeout=10)
        return rc, sent, ended

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def controller_pod_argv(workdir: str):
    """The executor's ``argv_transform``: each probe pod's stdout and stderr
    to ``<workdir>/<pod>.out`` and ``.err``."""

    def transform(pod, argv: list) -> list:
        out = os.path.join(workdir, pod.name)
        return ["/bin/sh", "-c", 'exec "$@" >"$0.out" 2>"$0.err"', out, *argv]

    return transform


def read_pod_run(workdir: str, pod_name: str, label: str = "controller_roll") -> dict:
    """A probe pod's report and kernels line, from its output files."""
    from k8s_operator_libs_tpu_torch.tpu.health import HealthReport

    base = os.path.join(workdir, pod_name)
    report = HealthReport.from_dict(_last_json(base + ".out"))
    kernels = _last_json(base + ".err", "kernels")["kernels"]
    if not (report.ok and report.mxu and report.mxu.ok and report.flash and report.flash.ok):
        raise AssertionError(f"{label}: probe pod {pod_name}: {report.summary()}")
    return {"elapsed_s": report.elapsed_s, "mxu_tflops": report.mxu.tflops,
            "build_s": kernels["build_s"], "launches": kernels["launches"]}


class NodeScope:
    """A client whose Node reads see only ``nodes`` (each read by name, never
    by a LIST): the kubelets of a pool that shares its cluster with other
    nodes. Everything else is the client's."""

    def __init__(self, client, nodes) -> None:
        self.client = client
        self.nodes = tuple(nodes)

    def list(self, kind: str, *args, **kwargs) -> list:
        from k8s_operator_libs_tpu_torch.kube.client import get_or_none

        if kind != "Node":
            return self.client.list(kind, *args, **kwargs)
        found = (get_or_none(self.client, "Node", name) for name in self.nodes)
        return [node for node in found if node is not None]

    def __getattr__(self, name: str):
        return getattr(self.client, name)


class ServerRoll:
    """The server side of the server_roll: the port's ``LocalApiServer`` in
    this process (a random bearer token, bookmarks every
    ``SERVER_BOOKMARK_S``, the loop-stall watchdog at ``SERVER_STALL_S``,
    the default priority and fairness), its cluster seeded with
    ``SERVER_POOL_NODES`` GPU nodes of another pool, every request it
    serves logged, a tracer installed for its ``server.request`` and
    ``apf.queue`` spans, and the kubelets' client: the port's
    ``RestClient`` at the server, its Node reads scoped to the rolled
    nodes."""

    def __init__(self, nodes) -> None:
        import secrets

        from k8s_operator_libs_tpu_torch.kube.apiserver import LocalApiServer
        from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
        from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
        from k8s_operator_libs_tpu_torch.utils import tracing

        self.token = secrets.token_hex(16)
        self.tracer = tracing.Tracer()
        tracing.install_tracer(self.tracer)
        self.server = LocalApiServer(token=self.token, bookmark_interval_s=SERVER_BOOKMARK_S,
                                     stall_watchdog_threshold_s=SERVER_STALL_S).start()
        self.cluster = self.server.cluster
        labels = {**local_gpu_labels(), **SERVER_OTHER_POOL}
        for i in range(SERVER_POOL_NODES):
            self.cluster.create(pool_node(f"gpu-pool-{i:04d}", labels))
        self.rest = RestClient(RestConfig(server=self.server.url, token=self.token))
        self.kubelet_client = NodeScope(self.rest, nodes)
        self.log = self.server.start_request_log()
        #: The request log's length when every connection was killed, and
        #: when the Table read went out: the requests between are the roll's
        #: after the kill.
        self.killed_at: Optional[int] = None
        self.table_at: Optional[int] = None
        self.killed_wall = 0.0
        self.connections_killed = 0

    def kill_once(self) -> None:
        if self.killed_at is None:
            self.killed_at = len(self.log)
            self.killed_wall = time.perf_counter()
            self.connections_killed = self.server.kill_connections()

    def table(self, state_label: str) -> dict:
        """One GET of the rolled nodes (by their state label) as a Table."""
        import urllib.parse
        import urllib.request

        self.table_at = len(self.log)
        query = urllib.parse.urlencode({"labelSelector": f"{state_label}=upgrade-done"})
        request = urllib.request.Request(
            f"{self.server.url}/api/v1/nodes?{query}",
            headers={"Accept": TABLE_ACCEPT, "Authorization": f"Bearer {self.token}"})
        with urllib.request.urlopen(request, timeout=30) as response:
            table = json.load(response)
        return {"kind": table.get("kind"),
                "columns": [c["name"] for c in table.get("columnDefinitions", [])],
                "rows": len(table.get("rows", [])),
                "names": sorted(row["cells"][0] for row in table.get("rows", []))}

    def close(self) -> None:
        from k8s_operator_libs_tpu_torch.utils import tracing

        self.rest.close()
        self.server.stop()
        tracing.clear_tracer()

    def report(self, command_trace: str) -> dict:
        """The counters, flows, stalls and continue tokens, the requests
        after the kill by verb and resource, and the server's spans with
        how many of them join a span of the command's exported trace."""
        import urllib.parse

        from k8s_operator_libs_tpu_torch.tools import trace_view

        log = list(self.log)
        end = self.table_at if self.table_at is not None else len(log)
        roll = log[:end]
        after_kill = roll[self.killed_at if self.killed_at is not None else end:]
        node_lists = [q for method, path, q in roll
                      if method == "GET" and path == "/api/v1/nodes" and q.get("watch") != "true"]
        after: dict = {}
        for method, path, query in after_kill:
            url = path + ("?" + urllib.parse.urlencode(query) if query else "")
            name = request_name(rbac_request(method, url))
            after[name] = after.get(name, 0) + 1
        full_node_lists_after = sum(
            1 for method, path, q in after_kill
            if method == "GET" and path == "/api/v1/nodes" and q.get("watch") != "true"
            and not q.get("sinceResourceVersion"))
        records = self.tracer.records()
        command = {(r["trace"], r["span"]): r for r in trace_view.load_spans(command_trace)}

        def joins_command(record: dict) -> bool:
            parent = command.get((record["trace"], record.get("parent")))
            if parent is None or not parent["name"].startswith("http."):
                return False
            attrs, mine = parent.get("attrs") or {}, record.get("attrs") or {}
            return (attrs.get("method") == mine.get("method")
                    and attrs.get("path", mine.get("path")) == mine.get("path"))

        served = [r for r in records if r["name"] == "server.request"]
        server = self.server
        return {
            "pool_nodes": SERVER_POOL_NODES,
            "counters": {"connections_opened": server.connections_opened,
                         "requests_served": server.requests_served,
                         "watch_streams": server.watch_streams,
                         "watch_frames_sent": server.watch_frames_sent,
                         "bytes_sent": server.bytes_sent,
                         "watch_bytes_sent": server.watch_bytes_sent},
            "apf": server.apf_stats(),
            "loop_stall": server.loop_stall_stats(),
            "node_lists": len(node_lists),
            "continue_tokens": len({q["continue"] for q in node_lists if q.get("continue")}),
            "connections_killed": self.connections_killed,
            "requests_after_kill": dict(sorted(after.items())),
            "full_node_lists_after_kill": full_node_lists_after,
            "node_watches_after_kill": after.get("watch nodes", 0),
            "spans": {"server.request": len(served),
                      "apf.queue": sum(1 for r in records if r["name"] == "apf.queue")},
            "server_requests_joined_to_command": sum(1 for r in served if joins_command(r)),
        }


def check_server_roll(result: dict) -> None:
    """server_roll's own checks, on its printed result."""
    server = result["server"]
    apf = server["apf"]
    if server["continue_tokens"] < 2:
        raise AssertionError(f"server_roll: the Node list was not paged: {server}")
    if any(apf[flow]["admitted_total"] < 1 for flow in ("lease", "reconcile", "informer")):
        raise AssertionError(f"server_roll: a flow admitted nothing: {apf}")
    if any(stats["shed_429_total"] for stats in apf.values()):
        raise AssertionError(f"server_roll: a flow shed: {apf}")
    if server["loop_stall"].get("stalls_over_threshold", 1):
        raise AssertionError(f"server_roll: the server's loop stalled: {server['loop_stall']}")
    if not server["connections_killed"] or not server["node_watches_after_kill"]:
        raise AssertionError(f"server_roll: no watch resumed after the kill: {server}")
    if server["full_node_lists_after_kill"]:
        raise AssertionError(f"server_roll: the informers re-listed Nodes after the kill: "
                             f"{server['requests_after_kill']}")
    table = result["table"]
    if table["columns"][:2] != ["Name", "Age"] or table["rows"] != 2 or \
            table["names"] != sorted(SERVER_NODES):
        raise AssertionError(f"server_roll: the Table read {table}")
    if not server["server_requests_joined_to_command"]:
        raise AssertionError(f"server_roll: no server.request joined the command's trace: "
                             f"{server['spans']}")
    if result["command_kernel_files"]:
        raise AssertionError(f"server_roll: the command built kernels: "
                             f"{result['command_kernel_files']}")


def controller_roll_phase(card: str, gate_launches: dict, cache_root: str,
                          server: bool = False) -> dict:
    """Two GPU nodes rolled 550 -> 560 by the port's ``upgrade_controller``
    command, run as two replicas (``ctl-a``, then ``ctl-b`` standing by)
    over ``ApiStub``; the port's ``DaemonSetSimulator`` and
    ``ValidationPodSimulator`` with a ``KubeletPayloadExecutor`` play the
    kubelets here, each probe pod's payload on the card with a kernel
    cache an earlier phase warmed. Then ``/metrics`` scraped once, ``ctl-a``
    stopped by SIGTERM, ``ctl-b`` taking over, ``ctl-b`` stopped.

    With ``server``, the server_roll: ``SERVER_NODES`` among
    ``SERVER_POOL_NODES`` more GPU nodes in the port's own
    ``LocalApiServer`` (``ServerRoll``), one replica over the kubeconfig the
    server writes, the kubelets over the port's ``RestClient`` at the
    server; every connection killed once when the first node is done; after
    the roll, a Table read of the two nodes, then SIGTERM."""
    from k8s_operator_libs_tpu_torch.kube.client import get_or_none
    from k8s_operator_libs_tpu_torch.kube.objects import Node
    from k8s_operator_libs_tpu_torch.kube.sim import (
        DaemonSetSimulator,
        KubeletPayloadExecutor,
        ValidationPodSimulator,
    )
    from k8s_operator_libs_tpu_torch.ops._build import KERNEL_DIR_ENV
    from k8s_operator_libs_tpu_torch.tools import trace_view
    from k8s_operator_libs_tpu_torch.tpu.libtpu import LibtpuDaemonSetManager, LibtpuSpec
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodSpec
    from k8s_operator_libs_tpu_torch.upgrade import DeviceClass, UpgradeKeys

    label = "server_roll" if server else "controller_roll"
    roll_nodes = SERVER_NODES if server else CONTROLLER_NODES
    identities = (SERVER_ID,) if server else CONTROLLER_IDS
    start = time.perf_counter()
    keys = UpgradeKeys(DeviceClass.nvidia("gpu"))
    cache = os.path.join(cache_root, ROLL_NODES[0])
    print(f"{label}: probe pods on the kernel cache of {ROLL_NODES[0]}", flush=True)
    spec = ValidationPodSpec()
    replicas: list = []
    served: Optional[ServerRoll] = None
    with contextlib.ExitStack() as stack:
        workdir = stack.enter_context(tempfile.TemporaryDirectory(prefix="controller-"))
        if server:
            served = ServerRoll(roll_nodes)
            stack.callback(served.close)
            client, kubelet_client = served.cluster, served.kubelet_client
            kubeconfig = served.server.write_kubeconfig(os.path.join(workdir, "kubeconfig"))
            # The command's kernel directory: empty at its end, or it built.
            command_kernels = os.path.join(workdir, "command-kernels")
            os.makedirs(command_kernels)
            command_env = {KERNEL_DIR_ENV: command_kernels}
        else:
            client = kubelet_client = DictClient()
            stub = stack.enter_context(ApiStub(client))
            kubeconfig = write_kubeconfig(workdir, stub.url)
            command_env = None
        pool_nodes(client, roll_nodes)
        installer = LibtpuDaemonSetManager(client, LibtpuSpec(version=ROLL_VERSIONS[0]))
        lease_name, lease_ns = "upgrade-controller-nvidia", installer.spec.namespace
        driver = DaemonSetSimulator(kubelet_client, name=installer.name,
                                    namespace=installer.spec.namespace,
                                    match_labels=installer.match_labels,
                                    initial_hash=ROLL_VERSIONS[0])
        driver.settle()
        # The new driver's pods block on the safe-load key until the machine
        # has drained their node.
        driver.safe_load_annotation = keys.safe_driver_load_annotation
        policy = os.path.join(workdir, "policy.json")
        with open(policy, "w") as f:
            json.dump(ROLL_POLICY, f)
        executor = KubeletPayloadExecutor(
            env=child_env(**{KERNEL_DIR_ENV: cache}), timeout_seconds=POD_READY_TIMEOUT_S,
            argv_transform=controller_pod_argv(workdir),
        )
        pods = ValidationPodSimulator(kubelet_client, namespace=spec.namespace,
                                      label_selector=spec.pod_selector, executor=executor)
        trajectories: dict[str, list] = {name: [] for name in roll_nodes}
        pod_seen: dict[str, float] = {}
        pod_ready: dict[str, float] = {}
        stop, failure = threading.Event(), []
        ticks = [0]

        def kubelet() -> None:
            try:
                while not stop.is_set():
                    ticks[0] += 1
                    driver.step()
                    pods.step()
                    now = time.perf_counter()
                    for name in executor.tracked_pods():
                        pod_seen.setdefault(name, now)
                    for name, verdict in executor.history.items():
                        if name not in pod_ready:
                            pod_ready[name] = now
                            if not verdict:
                                raise AssertionError(f"probe pod {name} failed")
                    stop.wait(KUBELET_TICK_S)
            except Exception as e:  # noqa: BLE001 - raised in the phase's thread
                failure.append(e)

        ticker = threading.Thread(target=kubelet, daemon=True)
        ticker.start()
        try:
            a = ControllerReplica(identities[0], kubeconfig, policy, workdir, label=label,
                                  env=command_env)
            replicas.append(a)
            a.wait_for("leader election: leading", CONTROLLER_START_S)
            if not server:
                b = ControllerReplica(identities[1], kubeconfig, policy, workdir)
                replicas.append(b)
            a.wait_for("pass 1: ", CONTROLLER_START_S)
            reset_counts()
            bumped = last_change = time.perf_counter()
            ticks_at_bump = ticks[0]
            driver.set_template_hash(ROLL_VERSIONS[1])  # the update lands: watch events
            while True:
                if failure:
                    raise failure[0]
                if a.proc.poll() is not None:
                    raise AssertionError(f"{label}: {a.identity} exited {a.proc.returncode}: "
                                         f"{a.tail()}")
                nodes = {n: Node(client.get("Node", n).raw) for n in roll_nodes}
                states = {n: node.labels.get(keys.state_label, "") for n, node in nodes.items()}
                now = time.perf_counter()
                for name, state in states.items():
                    if not trajectories[name] or trajectories[name][-1][0] != state:
                        trajectories[name].append([state, round(now - bumped, 3)])
                        last_change = now
                if served is not None and any(
                        len(steps) > 1 and steps[-1][0] == "upgrade-done"
                        for steps in trajectories.values()):
                    served.kill_once()  # the fault in mid-roll: the first node done
                if "upgrade-failed" in states.values():
                    raise AssertionError(f"{label}: a node failed: {trajectories}")
                if (set(states.values()) == {"upgrade-done"}
                        and not any(n.unschedulable for n in nodes.values())
                        and driver.all_pods_ready_and_current()
                        and len(pod_ready) == len(roll_nodes)):
                    break
                if time.perf_counter() - last_change > ROLL_STALL_S:
                    raise AssertionError(f"{label}: no node changed state for "
                                         f"{ROLL_STALL_S} s: {trajectories} {a.tail()}")
                time.sleep(0.1)
            wall_s = time.perf_counter() - bumped
            roll_ticks = ticks[0] - ticks_at_bump
            # The kubelet stops, so no event wakes a pass; once ctl-a prints
            # nothing for a while, its count and its scrape must agree.
            stop.set()
            ticker.join(timeout=30)
            a.wait_quiet(CONTROLLER_START_S)
            a_passes = len(a.passes())
            if server:
                table = served.table(keys.state_label)
                rc_a, a_signalled, a_ended = a.terminate()
                holder_after_a = lease_holder(client, lease_name, lease_ns)
            else:
                gauges = a.scrape()
                b_before = len(b.attempts())
                b.wait_for("leader election: campaigning", CONTROLLER_START_S)
                rc_a, a_signalled, a_ended = a.terminate()
                holder_after_a = lease_holder(client, lease_name, lease_ns)
                a_stopped = a.first("shutdown requested; draining")
                led_at = b.wait_for("leader election: leading", LEASE_DURATION_S + 30)
                takeover_s = led_at - a_signalled
                b.wait_for("pass 1: ", 60)
                b.wait_quiet(CONTROLLER_START_S)
                rc_b, _, _ = b.terminate()
                holder_after_b = lease_holder(client, lease_name, lease_ns)
            transitions = get_or_none(client, "Lease", lease_name, lease_ns).lease_transitions
        finally:
            stop.set()
            ticker.join(timeout=30)
            for replica in replicas:
                replica.kill()
            executor.close()
        runs = {}
        for name, seen_at in sorted(pod_seen.items()):
            run = read_pod_run(workdir, name, label)
            run["seconds_to_ready"] = pod_ready[name] - seen_at
            check_launches(f"{label} probe pod {name}", run["launches"], gate_launches)
            runs[name] = run
        spans = {}
        for replica in replicas:
            by_name: dict = {}
            for record in trace_view.load_spans(replica.trace):
                by_name[record["name"]] = by_name.get(record["name"], 0) + 1
            spans[replica.identity] = dict(sorted(by_name.items()))
        stats = {}
        for replica in replicas:
            with open(replica.stats) as f:
                stats[replica.identity] = json.load(f)
        printed = {r.identity: len(r.passes()) for r in replicas}
        attempted = {r.identity: len(r.attempts()) for r in replicas}
        tails = {r.identity: r.tail(8) for r in replicas}
        if served is not None:
            server_report = served.report(a.trace)
            server_report["killed_after_s"] = served.killed_wall - bumped
            command_kernel_files = sorted(os.listdir(command_kernels))
        pods_left = sorted(p.name for p in client.list("Pod"))
    controller = counts()
    result = {
        "nodes": list(roll_nodes),
        "versions": list(ROLL_VERSIONS),
        "policy": ROLL_POLICY,
        "interval_s": CONTROLLER_INTERVAL_S,
        "passes": printed,
        "passes_failed": {r: attempted[r] - printed[r] for r in printed},
        "wall_s": wall_s,
        "kubelet_ticks": roll_ticks,
        "trajectories": trajectories,
        "probe_pods": runs,
        "pod_launches": total_launches(runs.values()),
    }
    if server:
        result.update({
            "server": server_report,
            "table": table,
            "return_code": rc_a,
            "exit_s": a_ended - a_signalled,
            "lease_holder_after": holder_after_a,
            "lease_transitions": transitions,
            "command_kernel_files": command_kernel_files,
        })
    else:
        result.update({
            "reconcile_passes_total": gauges.get("reconcile_passes_total"),
            "leader_passes_at_scrape": a_passes,
            "standby_passes_while_leader_ran": b_before,
            "seconds_to_campaign": {r.identity: r.first("leader election: campaigning")
                                    - r.started for r in replicas},
            "takeover_s": takeover_s,
            "ctl_a_exit_s": a_ended - a_signalled,
            "return_codes": {"ctl-a": rc_a, "ctl-b": rc_b},
            "lease_holder_after": {"ctl-a": holder_after_a, "ctl-b": holder_after_b},
            "lease_transitions": transitions,
        })
    result.update({
        "spans_by_name": spans,
        "stats_json": stats,
        "controller_launches": {lib: controller[lib] for lib in ("matmul", "flash_attention")},
        "phase_wall_s": time.perf_counter() - start,
    })
    print(json.dumps({label: result, "card": card}), flush=True)
    if server:
        check_server_roll(result)
        if rc_a != 0 or holder_after_a:
            raise AssertionError(f"server_roll: return code {rc_a}, the Lease held by "
                                 f"{holder_after_a!r}: {tails}")
        if stats[SERVER_ID]["passes"] != attempted[SERVER_ID] or a_passes != printed[SERVER_ID]:
            raise AssertionError(f"server_roll: stats {stats}, printed {attempted}")
    else:
        # ctl-a stops reconciling when it prints that it drains, and releases
        # the Lease only after that: no pass of ctl-b may come before it.
        b_first = min(replicas[1].attempts(), default=None)
        if b_before or a_stopped is None or (b_first is not None and b_first < a_stopped):
            raise AssertionError(f"controller_roll: the standby reconciled while ctl-a led: "
                                 f"{tails}")
        if rc_a != 0 or rc_b != 0:
            raise AssertionError(f"controller_roll: return codes {rc_a}, {rc_b}: {tails}")
        if holder_after_a == CONTROLLER_IDS[0] or holder_after_b:
            raise AssertionError(f"controller_roll: the Lease was left held: {holder_after_a!r} "
                                 f"after ctl-a, {holder_after_b!r} after ctl-b")
        if not takeover_s < LEASE_DURATION_S:
            raise AssertionError(f"controller_roll: the takeover took {takeover_s} s")
        if result["reconcile_passes_total"] != a_passes:
            raise AssertionError(f"controller_roll: /metrics counted "
                                 f"{result['reconcile_passes_total']} passes, ctl-a printed "
                                 f"{a_passes}")
        if any(stats[r]["passes"] != attempted[r] for r in attempted):
            raise AssertionError(f"controller_roll: stats {stats}, printed {attempted}")
        # The kubelet's ticks write nothing that changes (a no-op write is no
        # event): the interval never ran out, and node and pod events, not
        # the world's key, woke most of ctl-a's passes.
        woken = stats[CONTROLLER_IDS[0]]["woken_by"]
        if woken["interval"] or woken["nodes"] <= woken["resync"]:
            raise AssertionError(f"controller_roll: ctl-a's passes were not woken by node and "
                                 f"pod events: {woken}")
    if not all(s.get("lease.round") for s in spans.values()):
        raise AssertionError(f"{label}: no lease.round span: {spans}")
    if sorted(run_node(name) for name in runs) != sorted(roll_nodes):
        raise AssertionError(f"{label}: probe pods ran for {sorted(runs)}")
    if controller["matmul"] or controller["flash_attention"]:
        raise AssertionError(f"{label}: the parent launched kernels: {controller}")
    if any(name.startswith("train-") for name in pods_left):
        raise AssertionError(f"{label}: the drain left workload pods: {pods_left}")
    return result


def cordoned_pools(journal, nodes) -> list[list[str]]:
    """After each Node write of ``journal`` that touched ``nodes``, the
    pools (``FLEET_POOLS``) with a cordoned node."""
    cordoned: dict[str, bool] = {}
    out = []
    for _, _, (kind, _, name), raw, _ in journal:
        if kind != "Node" or name not in nodes:
            continue
        cordoned[name] = bool((raw.get("spec") or {}).get("unschedulable"))
        out.append(sorted({name.rsplit("-", 1)[0] for name, on in cordoned.items() if on}))
    return out


def fleet_roll_phase(card: str, gate_launches: dict, cache_root: str,
                     label: str = "fleet_roll", nodes=FLEET_NODES, pools=FLEET_POOLS,
                     rollout: str = FLEET_ROLLOUT, ids=FLEET_IDS, relay: bool = False) -> dict:
    """Two GPU pools, ``fleet-a`` and ``fleet-b`` (a node each), rolled
    550 -> 560 under one FleetRollout whose global budget is one pool, by
    two fleet workers of the port's ``upgrade_controller`` command
    (``--shards 2``, the first also ``--orchestrate``) over ``ApiStub``,
    interval-driven; the port's simulators play the kubelets, each probe
    pod's payload on the card with a kernel cache an earlier phase warmed.
    Then both workers stopped by SIGTERM.

    With ``relay`` (the ``relay_roll`` phase, its own pools) a port
    ``WatchRelay`` over ``ApiStub`` runs in this process, with the wire
    loop's stall watchdog, and the workers watch through it
    (``--watch-relay``); it is stopped once the first pool is done, and
    the second pool finishes on direct watches. The phase then holds the
    stub's watch streams a scope, the workers' fallbacks and the
    watchdog's stalls to the contract, and checks the transport on the
    stub (``relay_transport``)."""
    from k8s_operator_libs_tpu_torch.api import make_fleet_rollout, pool_phase
    from k8s_operator_libs_tpu_torch.kube.objects import Node, wrap
    from k8s_operator_libs_tpu_torch.kube.sim import (
        DaemonSetSimulator,
        KubeletPayloadExecutor,
        ValidationPodSimulator,
    )
    from k8s_operator_libs_tpu_torch.ops._build import KERNEL_DIR_ENV
    from k8s_operator_libs_tpu_torch.tools import trace_view
    from k8s_operator_libs_tpu_torch.tpu.libtpu import LibtpuDaemonSetManager, LibtpuSpec
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import ValidationPodSpec
    from k8s_operator_libs_tpu_torch.upgrade import DeviceClass, UpgradeKeys

    start = time.perf_counter()
    keys = UpgradeKeys(DeviceClass.nvidia("gpu"))
    client = DictClient()
    pool_nodes(client, nodes)
    installer = LibtpuDaemonSetManager(client, LibtpuSpec(version=ROLL_VERSIONS[0]))
    lease_ns = installer.spec.namespace
    driver = DaemonSetSimulator(client, name=installer.name, namespace=installer.spec.namespace,
                                match_labels=installer.match_labels,
                                initial_hash=ROLL_VERSIONS[0])
    driver.settle()
    driver.safe_load_annotation = keys.safe_driver_load_annotation
    client.create(wrap(make_fleet_rollout(rollout, list(pools), 1)))
    cache = os.path.join(cache_root, ROLL_NODES[0])
    print(f"{label}: probe pods on the kernel cache of {ROLL_NODES[0]}", flush=True)
    spec = ValidationPodSpec()
    policy_doc = dict(ROLL_POLICY, maxUnavailable="100%")  # the grant is the budget
    workers: list = []
    watch_relay = watchdog = None
    relay_stats: dict = {}
    marks_with_relay: dict = {}
    opens_at_stop: dict = {}
    killed_at = None
    with ApiStub(client) as stub, tempfile.TemporaryDirectory(prefix="fleet-") as workdir:
        kubeconfig = write_kubeconfig(workdir, stub.url)
        policy = os.path.join(workdir, "policy.json")
        with open(policy, "w") as f:
            json.dump(policy_doc, f)
        executor = KubeletPayloadExecutor(
            env=child_env(**{KERNEL_DIR_ENV: cache}), timeout_seconds=POD_READY_TIMEOUT_S,
            argv_transform=controller_pod_argv(workdir),
        )
        pods = ValidationPodSimulator(client, namespace=spec.namespace,
                                      label_selector=spec.pod_selector, executor=executor)
        pod_seen: dict[str, float] = {}
        pod_ready: dict[str, float] = {}
        granted_at: dict[str, float] = {}
        done_at: dict[str, float] = {}
        stop, failure = threading.Event(), []

        def kubelet() -> None:
            try:
                while not stop.is_set():
                    driver.step()
                    pods.step()
                    now = time.perf_counter()
                    for name in executor.tracked_pods():
                        pod_seen.setdefault(name, now)
                    for name, verdict in executor.history.items():
                        if name not in pod_ready:
                            pod_ready[name] = now
                            if not verdict:
                                raise AssertionError(f"probe pod {name} failed")
                    stop.wait(KUBELET_TICK_S)
            except Exception as e:  # noqa: BLE001 - raised in the phase's thread
                failure.append(e)

        ticker = threading.Thread(target=kubelet, daemon=True)
        ticker.start()
        try:
            relay_flags = []
            if relay:
                from k8s_operator_libs_tpu_torch.kube.loopwatch import install_wire_loop_watchdog
                from k8s_operator_libs_tpu_torch.kube.relay import WatchRelay
                from k8s_operator_libs_tpu_torch.kube.rest import RestConfig

                watchdog = install_wire_loop_watchdog()
                watch_relay = WatchRelay(RestConfig(server=stub.url)).start()
                relay_flags = ["--watch-relay", watch_relay.url]
                stub.watch_marks(restart=True)
            for index, identity in enumerate(ids):
                flags = ["--shards", str(FLEET_SHARDS), "--shard-index", str(index),
                         "--fleet-rollout", rollout, "--pool-prefix-sep=-",
                         "--validation-pod", "--interval", str(FLEET_INTERVAL_S),
                         "--policy", policy, "--leader-elect-id", identity, *relay_flags]
                if index == 0:
                    flags.append("--orchestrate")
                workers.append(ControllerReplica(identity, kubeconfig, policy, workdir,
                                                 flags=flags, label=label))
            for worker in workers:
                worker.wait_for("pass 1: ", CONTROLLER_START_S)
            workers[0].wait_for("fleet orchestrator: campaigning", CONTROLLER_START_S)
            reset_counts()
            if watchdog is not None:
                watchdog.reset()
            journal_at = len(client.journal)
            bumped = last_change = time.perf_counter()
            driver.set_template_hash(ROLL_VERSIONS[1])
            seen: dict = {}
            while True:
                if failure:
                    raise failure[0]
                for worker in workers:
                    if worker.proc.poll() is not None:
                        raise AssertionError(f"{label}: {worker.identity} exited "
                                             f"{worker.proc.returncode}: {worker.tail()}")
                ledger = client.get("FleetRollout", rollout).raw
                node_objs = {n: Node(client.get("Node", n).raw) for n in nodes}
                now = time.perf_counter()
                if watch_relay is not None and done_at:
                    # The first pool is done: the relay goes, and the
                    # second pool must finish on direct watches.
                    relay_stats = watch_relay.stats()
                    marks_with_relay = stub.watch_marks(restart=True)
                    opens_at_stop = stub.watch_opens_by_scope()
                    watch_relay.stop()
                    watch_relay, killed_at = None, now - bumped
                for pool in pools:
                    phase = pool_phase(ledger, pool)
                    if phase in ("granted", "done"):
                        granted_at.setdefault(pool, now - bumped)
                    if phase == "done":
                        done_at.setdefault(pool, now - bumped)
                view = ({n: (node.labels.get(keys.state_label, ""), node.unschedulable)
                         for n, node in node_objs.items()}, sorted(granted_at), sorted(done_at))
                if view != seen:
                    seen, last_change = view, now
                if any(state == "upgrade-failed" for state, _ in view[0].values()):
                    raise AssertionError(f"{label}: a node failed: {view}")
                if (len(done_at) == len(pools)
                        and all(state == "upgrade-done" and not cordoned
                                for state, cordoned in view[0].values())
                        and driver.all_pods_ready_and_current()):
                    break
                if now - last_change > ROLL_STALL_S:
                    raise AssertionError(f"{label}: nothing moved for {ROLL_STALL_S} s: "
                                         f"{view} {workers[1].tail()}")
                time.sleep(0.1)
            wall_s = time.perf_counter() - bumped
            stop.set()
            ticker.join(timeout=30)
            stalls = watchdog.stats() if watchdog is not None else None
            marks_after_kill = stub.watch_marks()
            opens_after_stop = {scope: n - opens_at_stop.get(scope, 0)
                                for scope, n in stub.watch_opens_by_scope().items()}
            with client.lock:
                journal = list(client.journal[journal_at:])
            out_at_once = cordoned_pools(journal, nodes)
            ends = [worker.terminate() for worker in workers]
            leases = {name: lease_holder(client, name, lease_ns) for name in FLEET_LEASES}
            transport = relay_transport(stub.url, keys, installer, nodes) if relay else None
        finally:
            stop.set()
            ticker.join(timeout=30)
            for worker in workers:
                worker.kill()
            if watch_relay is not None:
                watch_relay.stop()
            executor.close()
        runs = {}
        for name, seen_at in sorted(pod_seen.items()):
            run = read_pod_run(workdir, name, label)
            run["seconds_to_ready"] = pod_ready[name] - seen_at
            check_launches(f"{label} probe pod {name}", run["launches"], gate_launches)
            runs[name] = run
        stats, spans = {}, {}
        for worker in workers:
            with open(worker.stats) as f:
                stats[worker.identity] = json.load(f)
            by_name: dict = {}
            for record in trace_view.load_spans(worker.trace):
                if record["name"].startswith("fleet."):
                    by_name[record["name"]] = by_name.get(record["name"], 0) + 1
            spans[worker.identity] = dict(sorted(by_name.items()))
        tails = {w.identity: w.tail(8) for w in workers}
    parent = counts()
    orchestrator = stats[ids[0]].get("orchestrator", {})
    result = {
        "nodes": list(nodes),
        "pools": list(pools),
        "versions": list(ROLL_VERSIONS),
        "max_unavailable_pools": 1,
        "interval_s": FLEET_INTERVAL_S,
        "granted_s": granted_at,
        "done_s": done_at,
        "grant_order": orchestrator.get("grant_order"),
        "most_pools_out_at_once": max((len(p) for p in out_at_once), default=0),
        "node_writes": len(out_at_once),
        "workers": {w: {"passes": stats[w]["passes"], "idle_ticks": stats[w]["idle_ticks"],
                        "shards": stats[w]["shards"],
                        "pools_reported_done": stats[w]["pools_reported_done"],
                        "transport": stats[w].get("transport"), "relay": stats[w].get("relay")}
                    for w in ids},
        "orchestrator": orchestrator,
        "probe_pods": runs,
        "pod_launches": total_launches(runs.values()),
        "spans_by_name": spans,
        "return_codes": {w.identity: rc for w, (rc, _, _) in zip(workers, ends)},
        "exit_s": {w.identity: ended - sent for w, (_, sent, ended) in zip(workers, ends)},
        "leases_after": leases,
        "wall_s": wall_s,
        "parent_launches": {lib: parent[lib] for lib in ("matmul", "flash_attention")},
        "phase_wall_s": time.perf_counter() - start,
    }
    if relay:
        result.update({
            "relay_stopped_s": killed_at,
            "upstream_watch_streams_with_relay": marks_with_relay,
            "upstream_watch_streams_after_stop": marks_after_kill,
            "upstream_watch_streams_opened_after_stop": opens_after_stop,
            "relay": relay_stats,
            "watchdog": stalls,
            "transport_check": transport,
        })
    print(json.dumps({label: result, "card": card}), flush=True)
    if any(len(p) > 1 for p in out_at_once):
        raise AssertionError(f"{label}: two pools were cordoned at once: {out_at_once}")
    if {p[0] for p in out_at_once if p} != set(pools):
        raise AssertionError(f"{label}: the pools cordoned were {out_at_once}")
    if any(rc != 0 for rc in result["return_codes"].values()):
        raise AssertionError(f"{label}: return codes {result['return_codes']}: {tails}")
    if any(leases.values()):
        raise AssertionError(f"{label}: Leases left held: {leases}")
    if sorted(run_node(name) for name in runs) != sorted(nodes):
        raise AssertionError(f"{label}: probe pods ran for {sorted(runs)}")
    if parent["matmul"] or parent["flash_attention"]:
        raise AssertionError(f"{label}: the parent launched kernels: {parent}")
    if orchestrator.get("grants_issued") != len(pools):
        raise AssertionError(f"{label}: the orchestrator granted {orchestrator}")
    if not spans[ids[0]].get("fleet.grant_round"):
        raise AssertionError(f"{label}: no fleet.grant_round span: {spans}")
    if not any(s.get("fleet.report_done") for s in spans.values()):
        raise AssertionError(f"{label}: no fleet.report_done span: {spans}")
    if sorted(shard for w in ids for shard in stats[w]["shards"]) != [
            "shard-00", "shard-01"]:
        raise AssertionError(f"{label}: shards held {stats}")
    pods_left = sorted(p.name for p in client.list("Pod"))
    if any(name.startswith("train-") for name in pods_left):
        raise AssertionError(f"{label}: the drain left workload pods: {pods_left}")
    if relay:
        check_relay_roll(result)
    return result


def check_relay_roll(result: dict) -> None:
    """The relay_roll's own contract (``fleet_roll_phase`` with a relay)."""
    if result["relay_stopped_s"] is None:
        raise AssertionError("relay_roll: the relay was never stopped")
    shared = result["upstream_watch_streams_with_relay"]
    if not shared or max(shared.values()) > 1:
        raise AssertionError(f"relay_roll: upstream watch streams while the relay lived: "
                             f"{shared}")
    if not result["relay"].get("streams_total"):
        raise AssertionError(f"relay_roll: no stream went through the relay: {result['relay']}")
    for identity, worker in result["workers"].items():
        relay, transport = worker["relay"] or {}, worker["transport"] or {}
        if not relay.get("fallbacks_to_direct") or not relay.get("direct_windows"):
            raise AssertionError(f"relay_roll: {identity} never fell back to direct watches: "
                                 f"{relay}")
        if not transport.get("server_speaks_compact"):
            raise AssertionError(f"relay_roll: {identity} never got a compact answer: "
                                 f"{transport}")
    stalls = result["watchdog"] or {}
    if stalls.get("stalls_over_threshold", 1):
        raise AssertionError(f"relay_roll: the wire loop stalled: {stalls}")
    check = result["transport_check"]
    if check["primed_requests_sent"] != 0:
        raise AssertionError(f"relay_roll: the primed lists sent requests: {check}")
    if check["batch_pipelined_batches"] != 1 or check["batch_connections_opened"] > 1:
        raise AssertionError(f"relay_roll: the batched flush was not one pipelined batch on "
                             f"one connection: {check}")


def relay_transport(url: str, keys, installer, nodes) -> dict:
    """The transport on ``ApiStub`` after the relay roll: the lists the
    workers' informers make, primed in one pipelined batch, then listed
    (no request may go out for them); and two nodes' annotations flushed
    together through the write batcher (one pipelined batch, on at most
    one new connection). The counters' deltas."""
    from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
    from k8s_operator_libs_tpu_torch.upgrade.write_batch import WriteBatcher

    client = RestClient(RestConfig(server=url, wire_encoding="compact"))
    try:
        ns, labels = installer.spec.namespace, dict(installer.match_labels)
        specs = [("Node", "", None, None), ("Pod", ns, labels, None),
                 ("DaemonSet", ns, labels, None), ("ControllerRevision", ns, None, None)]
        primed = client.prime_list_cache(specs)
        before = client.transport_stats()
        listed = {kind: len(client.list_with_revision(kind, ns_, label_sel, field_sel)[0])
                  for kind, ns_, label_sel, field_sel in specs}
        after_lists = client.transport_stats()
        batcher = WriteBatcher(client)
        annotation = keys.upgrade_requested_annotation
        patches = [(name, {"metadata": {"annotations": {annotation: None}}}) for name in nodes]
        results = flush_together(batcher, "Node", patches)
        after_batch = client.transport_stats()
    finally:
        client.close()
    return {
        "lists_primed": primed,
        "listed": listed,
        "primed_requests_sent": after_lists["requests_sent"] - before["requests_sent"],
        "batch_results": [getattr(r, "name", repr(r)) for r in results],
        "batch_pipelined_batches": (after_batch["pipelined_batches"]
                                    - after_lists["pipelined_batches"]),
        "batch_connections_opened": (after_batch["connections_opened"]
                                     - after_lists["connections_opened"]),
        "batch_requests_sent": after_batch["requests_sent"] - after_lists["requests_sent"],
        "server_speaks_compact": after_batch["server_speaks_compact"],
    }


def flush_together(batcher, kind: str, patches: list) -> list:
    """Stage ``(name, patch)`` writes from a thread each while this thread
    holds the batcher's flush, then lead the one flush that carries them
    all: a batch of exactly these writes, whatever the threads' timing."""
    with batcher._lock:
        batcher._flushing = True  # as a leader mid-flush: every stage follows
    results: dict = {}

    def stage(name, patch) -> None:
        try:
            results[name] = batcher.stage(kind, name, patch)
        except Exception as e:  # noqa: BLE001 - kept as the slot's result
            results[name] = e

    threads = [threading.Thread(target=stage, args=item) for item in patches]
    for thread in threads:
        thread.start()
    deadline = time.monotonic() + 30
    while True:
        with batcher._lock:
            if len(batcher._pending) == len(patches):
                break
        if time.monotonic() > deadline:
            raise AssertionError("relay_roll: the staged writes never queued")
        time.sleep(0.01)
    batcher._drain()
    for thread in threads:
        thread.join(timeout=30)
    return [results[name] for name, _ in patches]


# ----------------------------------------------------------------------
# The calibration line, and the monitor's shipped DaemonSets.
# ----------------------------------------------------------------------

def calibration_phase(card: str) -> dict:
    """``python -m k8s_operator_libs_tpu_torch.tools.calibration`` as a
    child on every card: one line with the port's keys, the gate ok, K1
    launched, the flash probe ok, both rates measured."""
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.tools.calibration"],
        cwd=REPO, env=child_env(), capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
    )
    wall_s = time.perf_counter() - start
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(
            f"calibration: rc {proc.returncode}, {len(lines)} lines: {proc.stderr[-2000:]}"
        )
    line = json.loads(lines[0])
    print(json.dumps({"calibration": line, "wall_s": wall_s, "card": card}), flush=True)
    if set(line) != CALIBRATION_KEYS:
        raise AssertionError(f"calibration keys: {sorted(line)}")
    if not (line["ok"] and line["matmul_kernel_launched"] is True
            and line["flash_attention_ok"] is True
            and line["mxu_tflops"] > 0 and line["torch_matmul_tflops"] > 0):
        raise AssertionError(f"calibration: {line}")
    return line


def shipped_manifest(name: str) -> dict:
    """One of the port's DaemonSet manifests, read through the package's
    own data path (what an installed package ships), by kind."""
    import importlib.resources

    import yaml

    text = (importlib.resources.files("k8s_operator_libs_tpu_torch") / "manifests"
            / name).read_text()
    return {doc["kind"]: doc for doc in yaml.safe_load_all(text) if doc}


#: A request path of the API: its group, resource, object and subresource.
API_PATH = re.compile(
    r"^/(?:api/v1|apis/(?P<group>[^/]+)/[^/]+)(?:/namespaces/[^/]+)?"
    r"/(?P<plural>[^/]+)(?:/(?P<name>[^/]+))?(?:/(?P<sub>[^/]+))?$"
)


def rbac_request(method: str, path: str) -> tuple[str, str, str]:
    """A logged request as (API group, resource, verb): the subresource
    kept on the resource (``nodes/status``) and ``patch`` apart from
    ``update``. A path that names no resource maps to one no rule grants."""
    import urllib.parse

    url = urllib.parse.urlsplit(path)
    m = API_PATH.match(url.path)
    if m is None:
        return ("", f"? {url.path}", method.lower())
    resource = m.group("plural") + (f"/{m.group('sub')}" if m.group("sub") else "")
    named = m.group("name") is not None
    if method == "GET":
        verb = "get" if named else ("watch" if "watch=true" in url.query else "list")
    elif method == "DELETE":
        verb = "delete" if named else "deletecollection"
    else:
        verb = {"POST": "create", "PUT": "update", "PATCH": "patch"}.get(method, method.lower())
    return (m.group("group") or "", resource, verb)


def request_name(request: tuple[str, str, str]) -> str:
    group, resource, verb = request
    return f"{verb} {group}/{resource}" if group else f"{verb} {resource}"


def role_allows(role: dict, request: tuple[str, str, str]) -> bool:
    group, resource, verb = request
    return any(group in rule.get("apiGroups", ()) and resource in rule.get("resources", ())
               and verb in rule.get("verbs", ()) for rule in role["rules"])


def child_pids(pid: int) -> list[int]:
    """The processes whose parent is ``pid``."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


class DaemonSetPod:
    """A DaemonSet's container run as the kubelet would: its command with
    ``python`` this interpreter and the metrics port a free one, its
    environment with ``NODE_NAME`` from the downward API (the monitored
    node), each hostPath mount a directory here, and ``KUBECONFIG`` at the
    stub in place of the service account; ``flags`` replace or add
    command-line flags. Its output goes to files; :meth:`stop` sends
    SIGTERM to its process group and to its children's (the per-cycle
    payload runs in a session of its own)."""

    def __init__(self, docs: dict, label: str, workdir: str, kubeconfig: str,
                 host_paths: dict, flags: Optional[dict] = None) -> None:
        pod = docs["DaemonSet"]["spec"]["template"]["spec"]
        (container,) = pod["containers"]
        volumes = {v["name"]: v["hostPath"]["path"] for v in pod.get("volumes", [])}
        if set(volumes.values()) != set(host_paths):
            raise AssertionError(f"{label}: hostPaths {volumes}, mapped {host_paths}")
        here = {m["mountPath"]: host_paths[volumes[m["name"]]]
                for m in container.get("volumeMounts", [])}
        argv = list(container["command"])
        argv[0] = sys.executable
        self.metrics_port = 0
        if "--metrics-port" in argv:
            self.metrics_port = free_port()
            argv[argv.index("--metrics-port") + 1] = str(self.metrics_port)
        for flag, value in (flags or {}).items():
            if flag in argv and value is not None:
                argv[argv.index(flag) + 1] = value
            elif flag not in argv:
                argv += [flag] if value is None else [flag, value]
        env = child_env(KUBECONFIG=kubeconfig)
        env.pop("KUBERNETES_SERVICE_HOST", None)
        for item in container.get("env", []):
            if "valueFrom" in item:
                if item["valueFrom"]["fieldRef"]["fieldPath"] != "spec.nodeName":
                    raise AssertionError(f"{label}: downward API field {item}")
                env[item["name"]] = MONITOR_NODE
            else:
                env[item["name"]] = here.get(item["value"], item["value"])
        self.label, self.argv = label, argv
        self.err_path = os.path.join(workdir, f"{label}.err")
        with open(os.path.join(workdir, f"{label}.out"), "w") as out, \
                open(self.err_path, "w") as err:
            self.start = time.perf_counter()
            self.proc = subprocess.Popen(argv, cwd=workdir, env=env, stdout=out, stderr=err,
                                         start_new_session=True)

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()

    def scrape(self) -> str:
        """``/metrics`` of the pod, or "" while it does not answer 200."""
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.metrics_port}/metrics", timeout=2) as resp:
                return resp.read().decode() if resp.status == 200 else ""
        except OSError:
            return ""

    def wait(self, what: str, predicate, timeout: float) -> float:
        """Seconds from the pod's start until ``predicate()`` holds."""
        while not predicate():
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"{self.label} exited {self.proc.returncode} before {what}: "
                    f"{self.stderr()[-3000:]}"
                )
            if time.perf_counter() - self.start > timeout:
                raise AssertionError(f"{self.label}: no {what} within {timeout} s: "
                                     f"{self.stderr()[-3000:]}")
            time.sleep(0.1)
        return time.perf_counter() - self.start

    def stop(self) -> Optional[int]:
        import signal

        kids = child_pids(self.proc.pid)
        for pid in [self.proc.pid] + kids:
            try:
                os.killpg(os.getpgid(pid), signal.SIGTERM)
            except ProcessLookupError:
                pass
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            return self.proc.wait(timeout=30)


def probes_total(metrics: str) -> float:
    m = re.search(r"^tpu_monitor_probes_total\{[^}]*\} (\S+)$", metrics, re.MULTILINE)
    return float(m.group(1)) if m else 0.0


def payload_cost(stderr: str) -> dict:
    """The first probe payload's kernel builds and launches, as the
    monitor logged them."""
    for line in stderr.splitlines():
        if "probe payload: " in line:
            return json.loads(line.split("probe payload: ", 1)[1])["kernels"]
    raise AssertionError(f"no probe payload line in the monitor's log: {stderr[-2000:]}")


def monitor_manifest_phase(card: str, gate_launches: dict) -> dict:
    """The port's two shipped monitor DaemonSets run as the kubelet would
    on a GPU node over ``ApiStub``: the full tier twice on one fresh kernel
    cache (a restart), the quick tier once, and the full tier flapping
    until its recorder repeats a Warning; every request each pod made is
    held to its shipped ClusterRole."""
    from k8s_operator_libs_tpu_torch.kube.client import get_or_none
    from k8s_operator_libs_tpu_torch.kube.objects import Node, condition_status, set_condition
    from k8s_operator_libs_tpu_torch.parallel.topology import local_gpu_labels
    from k8s_operator_libs_tpu_torch.tpu.health import KERNEL_CACHE_DIR
    from k8s_operator_libs_tpu_torch.tpu.monitor import ICI_HEALTHY_CONDITION

    phase_start = time.perf_counter()
    docs = {"full": shipped_manifest(FULL_MANIFEST), "quick": shipped_manifest(QUICK_MANIFEST)}
    client = DictClient()
    node = Node.new(MONITOR_NODE, labels=local_gpu_labels())
    node.set_ready(True)
    client.create(node)

    def condition() -> Optional[str]:
        return condition_status(client.get("Node", MONITOR_NODE).status, ICI_HEALTHY_CONDITION)

    info: dict = {"node_labels": node.labels}
    requests: dict = {}
    with tempfile.TemporaryDirectory(prefix="monitor-manifest-") as workdir, \
            ApiStub(client) as stub:
        kubeconfig = write_kubeconfig(workdir, stub.url)
        # Fresh and empty: the first pod must build, not find the
        # kernels this script built at its start.
        cache = os.path.join(workdir, "kernel-cache")
        os.mkdir(cache)
        host_paths = {KERNEL_CACHE_DIR: cache}

        def so_files() -> dict:
            return {name: os.stat(os.path.join(cache, name)).st_mtime_ns
                    for name in sorted(os.listdir(cache)) if name.endswith(".so")}

        def run(label: str, tier: str, paths: dict, until, what: str, flags=None) -> dict:
            mark = len(stub.requests)
            pod = DaemonSetPod(docs[tier], label, workdir, kubeconfig, paths, flags)
            try:
                seconds = pod.wait(what, until(pod), MONITOR_POD_TIMEOUT_S)
            finally:
                rc = pod.stop()
            requests[label] = [rbac_request(m, p) for m, p in stub.requests[mark:]]
            return {"seconds": seconds, "rc_after_sigterm": rc, "stderr": pod.stderr(),
                    "argv": pod.argv[1:]}

        def first_cycle(pod):
            return lambda: condition() == "True" and probes_total(pod.scrape()) >= 1

        for label in ("full_1", "full_2"):
            pod = run(label, "full", host_paths, first_cycle, "first cycle")
            cost = payload_cost(pod.pop("stderr"))
            check_launches(f"monitor_manifest {label} payload", cost["launches"], gate_launches)
            info[label] = {"seconds_to_first_cycle": pod["seconds"],
                           "rc_after_sigterm": pod["rc_after_sigterm"],
                           "build_s": cost["build_s"], "launches": cost["launches"],
                           "so_files": so_files()}
        info["command"] = pod["argv"]
        info["nvcc_saved_s"] = (info["full_1"]["seconds_to_first_cycle"]
                                - info["full_2"]["seconds_to_first_cycle"])

        rv = client.get("Node", MONITOR_NODE).raw["metadata"]["resourceVersion"]

        def status_writes() -> int:
            path = f"/nodehealthreports/{MONITOR_NODE}/status"
            return sum(1 for m, p in list(stub.requests) if m == "PUT" and p.endswith(path))

        def quick_report(pod):
            writes = status_writes()

            def published() -> bool:
                # The status write, not the create (which this client
                # stores with its status): the pod stops after it.
                report = get_or_none(client, "NodeHealthReport", MONITOR_NODE)
                return (report is not None and report.raw["spec"].get("source") == "quick-probe"
                        and bool(report.raw.get("status", {}).get("checks"))
                        and status_writes() > writes)
            return published

        pod = run("quick", "quick", {}, quick_report, "NodeHealthReport")
        report = client.get("NodeHealthReport", MONITOR_NODE).raw
        info["quick"] = {"seconds_to_report": pod["seconds"],
                         "rc_after_sigterm": pod["rc_after_sigterm"],
                         "checks": report["status"]["checks"],
                         "node_rv_unchanged":
                             client.get("Node", MONITOR_NODE).raw["metadata"]["resourceVersion"]
                             == rv}

        # A flapping node: the full tier in process with an impossible
        # floor, the condition set back to True by hand each time the pod
        # writes False, until the recorder repeats a Warning. A Warning
        # is recorded only on a transition, and its message carries the
        # battery's seconds and rate, so a repeat is a message that came
        # out the same, or the eleventh similar one in ten minutes (the
        # correlator's aggregate); either is a PATCH of the Event.
        flips = 0

        def repeated(pod):
            def check() -> bool:
                nonlocal flips
                if any(e.raw["type"] == "Warning" and e.raw["count"] >= 2
                       for e in client.list("Event")):
                    return True
                current = client.get("Node", MONITOR_NODE)
                if condition_status(current.status, ICI_HEALTHY_CONDITION) == "False":
                    set_condition(current.status, ICI_HEALTHY_CONDITION, "True",
                                  reason="ClearedByHand", message="cleared")
                    try:
                        client.update_status(current)
                        flips += 1
                    except Exception as e:  # noqa: BLE001 - raced the pod's write
                        if getattr(e, "reason", "") != "Conflict":
                            raise
                return False
            return check

        pod = run("full_flap", "full", host_paths, repeated, "repeated Warning",
                  flags={"--in-process": None, "--min-mxu-tflops": "1e9",
                         "--interval-seconds": str(FLAP_INTERVAL_S)})
        warnings = [e.raw for e in client.list("Event") if e.raw["type"] == "Warning"]
        info["full_flap"] = {"seconds": pod["seconds"], "flips": flips,
                             "rc_after_sigterm": pod["rc_after_sigterm"],
                             "warning_events": len(warnings),
                             "warning_counts": sorted(e["count"] for e in warnings),
                             "argv": pod["argv"]}
        info["so_files_after"] = so_files()

    denied = {}
    for label, seen in requests.items():
        role = docs["quick" if label == "quick" else "full"]["ClusterRole"]
        info.setdefault("requests", {})[label] = {
            request_name(r): seen.count(r) for r in sorted(set(seen))
        }
        bad = sorted({request_name(r) for r in seen if not role_allows(role, r)})
        if bad:
            denied[label] = bad
    info["denied"] = denied
    info["phase_wall_s"] = time.perf_counter() - phase_start
    print(json.dumps({"monitor_manifest": info, "card": card}), flush=True)

    full_1, full_2 = info["full_1"], info["full_2"]
    writes_2 = [r for r in requests["full_2"] if r[2] not in ("get", "list", "watch")]
    if writes_2:
        raise AssertionError(f"monitor_manifest: the restarted pod wrote {writes_2}")
    quick_writes = [r for r in requests["quick"] if r[1].startswith("nodes") and r[2] != "get"]
    if quick_writes or not info["quick"]["node_rv_unchanged"]:
        raise AssertionError(f"monitor_manifest: the quick tier wrote the node: {quick_writes}")
    if info["quick"]["checks"] != {"ring_allreduce": True, "mxu": True}:
        raise AssertionError(f"monitor_manifest: quick report {info['quick']['checks']}")
    if ("", "events", "patch") not in requests["full_flap"]:
        raise AssertionError("monitor_manifest: no Event was patched")
    if denied:
        raise AssertionError(f"monitor_manifest: requests the ClusterRole denies: {denied}")
    # Last, what only the card shows (a CPU rehearsal stops here): pod 1
    # built both kernels into the empty cache, and the restart built
    # nothing, leaving each .so as pod 1 wrote it.
    if any(full_2["build_s"].values()) or full_2["so_files"] != full_1["so_files"]:
        raise AssertionError(
            f"monitor_manifest: the restarted pod built: {full_2['build_s']}, "
            f"{full_1['so_files']} -> {full_2['so_files']}"
        )
    if not (full_1["so_files"] and all(
            full_1["build_s"].get(lib, 0.0) > 0 for lib in ("matmul", "flash_attention"))):
        raise AssertionError(
            f"monitor_manifest: pod 1 did not build: {full_1['build_s']}, {full_1['so_files']}"
        )
    return info


def lease_holder(client, name: str, namespace: str) -> str:
    from k8s_operator_libs_tpu_torch.kube.client import get_or_none

    lease = get_or_none(client, "Lease", name, namespace)
    return lease.holder_identity if lease is not None else ""


def run_node(pod_name: str) -> str:
    """The node of a probe pod, from its name (``ValidationPodManager``)."""
    from k8s_operator_libs_tpu_torch.tpu.validation_pod import VALIDATION_APP

    return pod_name[len(VALIDATION_APP) + 1:]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from k8s_operator_libs_tpu_torch.ops import _build

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    start = time.perf_counter()
    seconds = _build.build()
    print(f"build: {time.perf_counter() - start:.1f} s wall, per source "
          f"{json.dumps(seconds)}", flush=True)
    for lib in _build.SIGNATURES:
        for line in _build.ptxas_report(lib).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {lib}: {line.strip()}", flush=True)

    rows = kernel_phase()
    launches = gate_phase(
        next(r["ms"] for r in rows if r["name"] == "matmul" and r["shape"][0] == 1024)
    )
    collectives_phase(card)
    burnin_phase()
    burnin_launches = burnin_flash_phase()
    flagship = entry_phase(card)
    dryrun_phase(card)
    cli_phase()
    pod = device_class_phase(card, launches)
    watch = WatchPhase()
    try:
        with tempfile.TemporaryDirectory(prefix="kernel-caches-") as cache_root:
            roll = roll_phase(card, launches, cache_root, DictClient())
            requestor_client = DictClient()
            watch.start_maintenance(requestor_client)
            requestor = requestor_roll_phase(card, launches, cache_root, requestor_client)
            watch.check_maintenance(requestor_client)
            checkpoint = checkpoint_roll_phase(card, launches, cache_root)
            client = monitor_client()
            watch.start_pool(client)
            monitor = monitor_phase(card, launches, client, watch)
            watch.check_monitor(client)
            quarantine = quarantine_phase(card, launches, cache_root, monitor["reports"])
            informer = informer_roll_phase(card, launches, cache_root)
            controller = controller_roll_phase(card, launches, cache_root)
            fleet = fleet_roll_phase(card, launches, cache_root)
            relayed = fleet_roll_phase(card, launches, cache_root, label="relay_roll",
                                       nodes=RELAY_NODES, pools=RELAY_POOLS,
                                       rollout=RELAY_ROLLOUT, ids=RELAY_IDS, relay=True)
            in_memory = in_memory_phase(card, launches, cache_root)
            server_roll = controller_roll_phase(card, launches, cache_root, server=True)
    finally:
        watched = watch.stop()
    print(json.dumps({"watch": watched, "card": card}), flush=True)
    gang = gang_phase(card, launches)
    calibration_phase(card)
    manifest = monitor_manifest_phase(card, launches)

    for row in rows:
        kernel = "matmul" if row["name"] == "matmul" else "flash_attention"
        row["launches"] = launches[kernel]
        row["launches_burnin_flash_forward"] = burnin_launches[kernel]
        row["launches_entry_flash_forward"] = flagship["flash_forward"]["launches"][kernel]
        row["launches_validation_pod"] = pod["cold"]["launches"][kernel]
        row["launches_roll"] = roll["launches"][kernel]
        row["launches_requestor_hook"] = requestor["hook_launches"][kernel]
        row["launches_requestor_pods"] = requestor["pod_launches"][kernel]
        row["launches_checkpoint_roll"] = checkpoint["pod_launches"][kernel]
        row["launches_monitor"] = monitor["pass_launches"][kernel]
        row["launches_quarantine_pod"] = quarantine["pod_launches"][kernel]
        row["launches_informer_roll"] = informer["pod_launches"][kernel]
        row["launches_controller_roll"] = controller["pod_launches"][kernel]
        row["launches_fleet_roll"] = fleet["pod_launches"][kernel]
        row["launches_relay_roll"] = relayed["pod_launches"][kernel]
        row["launches_fake_roll"] = in_memory["fake_roll"]["launches"][kernel]
        row["launches_server_roll"] = server_roll["pod_launches"][kernel]
        row["launches_gang"] = gang["one_pod"]["launches"][kernel]
        row["launches_monitor_manifest"] = manifest["full_1"]["launches"][kernel]
        if kernel == "matmul":
            row["path_launches"] = launches["matmul_by_path"].get(row["path"], 0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
