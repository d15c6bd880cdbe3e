"""The post-upgrade health gate on a node's NVIDIA cards.

The upgrade state machine lets a node back into service only after this
battery passes on it (``IciHealthGate.validation_hook()`` plugs into
``ClusterUpgradeStateManager.with_validation_enabled``); the probe pod runs
the same battery through ``python -m k8s_operator_libs_tpu_torch.tpu.health``
and prints one ``HealthReport`` JSON line that the control plane parses.
The names, the report shape and the CLI flags are the JAX package's, so
either package's report parses into the other's ``HealthReport``.

The battery, in the JAX gate's order, on a world of one rank process per
card (``parallel.mesh.World``: NCCL between cards, gloo between CPU ranks):

1. **collective battery** (``ops.collectives``): psum, all_gather and
   reduce_scatter checked exactly, the ring exchange timed; with more than
   one card, the ring floor and each ring hop timed alone (per-link tier);
2. **matmul probe** (``ops.matmul``): numerics-checked throughput of the
   hand-written CUDA matmul kernel, on one card;
3. **burn-in** (``models.burnin``): two train steps sharded dp x tp over
   the world, the loss must fall;
4. **ring and Ulysses attention probes** over the world, with more than
   one card;
5. **flash-attention probe** (``ops.flash_attention``): numerics-checked
   throughput of the hand-written CUDA flash kernel, on one card.

The world is formed at a gate's first run and serves its later runs; a
world that fails is dropped and the next run forms a new one.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Optional, Protocol

import torch

from ..ops.collectives import (
    CollectiveReport,
    LinkProbeReport,
    ppermute_per_link,
    run_ici_probes,
)
from ..ops.flash_attention import FlashAttentionReport, flash_attention_probe
from ..ops.matmul import MxuReport, mxu_probe
from ..ops.ring_attention import RingAttentionReport, ring_attention_probe
from ..ops.ulysses import UlyssesReport, ulysses_probe
from ..parallel.mesh import World, available_devices
from ..utils.device import DeviceLike, resolve_device
from ..utils.log import get_logger

log = get_logger("tpu.health")


@dataclass
class HealthReport:
    ok: bool
    collectives: list[CollectiveReport] = field(default_factory=list)
    mxu: Optional[MxuReport] = None
    burnin_ok: Optional[bool] = None
    ring_attention: Optional[RingAttentionReport] = None
    ulysses: Optional[UlyssesReport] = None
    flash: Optional[FlashAttentionReport] = None
    elapsed_s: float = 0.0
    failures: list[str] = field(default_factory=list)
    #: Per-hop link reports; empty on one device or with the tier off.
    links: list[LinkProbeReport] = field(default_factory=list)
    #: Slice-wide gang battery only: how many processes formed the world
    #: and how many devices passed.
    process_count: int = 1
    slice_devices_passed: Optional[int] = None
    slice_devices_total: Optional[int] = None

    @classmethod
    def from_dict(cls, data: dict) -> "HealthReport":
        """Rebuild a report from ``dataclasses.asdict`` output — the JSON
        line the probe-pod payload prints (see :func:`main`). Unknown keys
        are dropped so a newer payload's report still parses."""

        def build(dc_cls, value):
            if not isinstance(value, dict):
                return value
            names = {f.name for f in dataclasses.fields(dc_cls)}
            return dc_cls(**{k: v for k, v in value.items() if k in names})

        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in data.items() if k in names}
        kwargs["collectives"] = [
            build(CollectiveReport, c) for c in kwargs.get("collectives") or []
        ]
        kwargs["links"] = [
            build(LinkProbeReport, entry) for entry in kwargs.get("links") or []
        ]
        for key, dc_cls in (
            ("mxu", MxuReport),
            ("ring_attention", RingAttentionReport),
            ("ulysses", UlyssesReport),
            ("flash", FlashAttentionReport),
        ):
            if kwargs.get(key) is not None:
                kwargs[key] = build(dc_cls, kwargs[key])
        return cls(**kwargs)

    def ring_bandwidth(self) -> Optional[float]:
        """Measured ring bandwidth in GB/s, preferring the all-reduce probe
        over the ppermute hop; ``None`` when neither carried a number."""
        for op in ("psum_ring_allreduce", "ppermute_ring"):
            for report in self.collectives:
                if report.op == op and report.gbytes_per_s:
                    return report.gbytes_per_s
        return None

    def observation(self) -> tuple[dict[str, bool], dict[str, float]]:
        """``(checks, metrics)`` for the telemetry plane: per-probe verdicts
        plus every numeric signal the battery measured. Probes that did not
        run are absent, not failed."""
        from ..api.telemetry_v1alpha1 import (
            METRIC_MXU_TFLOPS,
            METRIC_PROBE_LATENCY_S,
            METRIC_RING_GBYTES_PER_S,
            METRIC_TOKENS_PER_S,
            METRIC_WORST_LINK_GBYTES_PER_S,
            METRIC_WORST_LINK_LATENCY_S,
        )

        checks: dict[str, bool] = {c.op: c.ok for c in self.collectives}
        if self.mxu is not None:
            checks["mxu"] = self.mxu.ok
        if self.burnin_ok is not None:
            checks["burnin"] = self.burnin_ok
        if self.ring_attention is not None:
            checks["ring_attention"] = self.ring_attention.ok
        if self.ulysses is not None:
            checks["ulysses"] = self.ulysses.ok
        if self.flash is not None:
            checks["flash_attention"] = self.flash.ok
        metrics: dict[str, float] = {}
        if self.elapsed_s:
            metrics[METRIC_PROBE_LATENCY_S] = self.elapsed_s
        ring = self.ring_bandwidth()
        if ring is not None:
            metrics[METRIC_RING_GBYTES_PER_S] = ring
        if self.mxu is not None and self.mxu.ok and self.mxu.tflops:
            metrics[METRIC_MXU_TFLOPS] = self.mxu.tflops
        tokens = 0.0
        for probe in (self.ring_attention, self.ulysses, self.flash):
            rate = getattr(probe, "tokens_per_s", 0.0) if probe else 0.0
            if probe is not None and probe.ok and rate:
                tokens = max(tokens, rate)
        if tokens:
            metrics[METRIC_TOKENS_PER_S] = tokens
        if self.links:
            checks["links"] = all(hop.ok for hop in self.links)
            timed = [h for h in self.links if h.ok and h.gbytes_per_s]
            if timed:
                metrics[METRIC_WORST_LINK_GBYTES_PER_S] = min(
                    h.gbytes_per_s for h in timed
                )
                metrics[METRIC_WORST_LINK_LATENCY_S] = max(
                    h.latency_s for h in timed
                )
        return checks, metrics

    def summary(self) -> str:
        parts = [f"ok={self.ok}", f"elapsed={self.elapsed_s:.2f}s"]
        ring = next(
            (c for c in self.collectives if c.op == "ppermute_ring"), None
        )
        if ring is not None and ring.gbytes_per_s:
            parts.append(f"ring={ring.gbytes_per_s:.2f}GB/s")
        if self.mxu is not None and self.mxu.ok:
            parts.append(f"mxu={self.mxu.tflops:.1f}TFLOP/s")
        if self.slice_devices_total is not None:
            parts.append(
                f"slice={self.slice_devices_passed}/"
                f"{self.slice_devices_total} over {self.process_count} hosts"
            )
        if self.failures:
            parts.append("failures=" + "; ".join(self.failures))
        return " ".join(parts)


class HealthGate(Protocol):
    """One probe battery -> one report. Both gate shapes satisfy it:
    :class:`IciHealthGate` (in-process) and :class:`SubprocessHealthGate`
    (per-cycle child)."""

    def run(self) -> HealthReport: ...  # pragma: no cover - typing only


class IciHealthGate:
    """The health gate. The class keeps the JAX package's name so a reader
    finds its counterpart; on the cards it probes the links, the tensor
    cores, a sharded train step and attention."""

    def __init__(
        self,
        min_ring_gbytes_per_s: float = 0.0,
        min_mxu_tflops: float = 0.0,
        payload_mb: float = 4.0,
        matmul_size: int = 1024,
        use_pallas_matmul: bool = False,
        run_burnin: bool = True,
        run_seq_parallel_probes: bool = False,
        run_flash_attention: bool = False,
        devices: Optional[list] = None,
        local_device: DeviceLike = None,
        run_link_probes: bool = True,
        link_peer_names: Optional[list[str]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.min_ring_gbytes_per_s = min_ring_gbytes_per_s
        self.min_mxu_tflops = min_mxu_tflops
        self.payload_mb = payload_mb
        self.matmul_size = matmul_size
        #: Run the matmul probe through the CUDA kernel (the JAX name says
        #: Pallas); off, it runs the plain product.
        self.use_pallas_matmul = use_pallas_matmul
        self.run_burnin = run_burnin
        #: Per-link tier: each ring hop timed alone, on more than one rank.
        self.run_link_probes = run_link_probes
        #: Gang rank -> node name, for the link map's peer ids.
        self.link_peer_names = list(link_peer_names or []) or None
        self.run_seq_parallel_probes = run_seq_parallel_probes
        self.run_flash_attention = run_flash_attention
        #: The world's devices, one rank each; ``None`` means what
        #: ``device`` names: every visible card (``None`` or ``cuda``), one
        #: card (``cuda:<i>``) or one CPU rank (``cpu``).
        self.devices = devices
        self.device = device
        #: The device of the single-device probes (matmul, flash);
        #: default the world's first.
        self.local_device = local_device
        # Formed at the first run and reused; dropped when it fails.
        self._world: Optional[World] = None

    @classmethod
    def tpu_defaults(cls, **overrides) -> "IciHealthGate":
        """The JAX package's calibrated gate, on the card: both CUDA kernels
        and the flash probe on, the sequence-parallel probes on (skipped,
        with a logged reason, on one device). The perf floors stay at 0
        until measured floors exist for the card. Keyword overrides win."""
        kwargs: dict = dict(
            use_pallas_matmul=True,
            run_flash_attention=True,
            run_seq_parallel_probes=True,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def to_cli_args(self) -> list[str]:
        """Serialize this gate's configuration to the payload CLI flags
        (:func:`main`) — the same flags the JAX gate emits for the same
        knobs. ``device``/``devices`` don't serialize: the child probes
        the card it sees."""
        args = [
            "--payload-mb", str(self.payload_mb),
            "--matmul-size", str(self.matmul_size),
        ]
        if self.min_ring_gbytes_per_s > 0:
            args += ["--min-ring-gbps", str(self.min_ring_gbytes_per_s)]
        if self.min_mxu_tflops > 0:
            args += ["--min-mxu-tflops", str(self.min_mxu_tflops)]
        # Kernel knobs serialize both ways, so the child runs exactly this
        # battery and never depends on main()'s automatic choice.
        args.append(
            "--pallas-matmul" if self.use_pallas_matmul
            else "--no-pallas-matmul"
        )
        args.append(
            "--flash-attention" if self.run_flash_attention
            else "--no-flash-attention"
        )
        args.append(
            "--seq-parallel" if self.run_seq_parallel_probes
            else "--no-seq-parallel"
        )
        if not self.run_burnin:
            args.append("--no-burnin")
        if not self.run_link_probes:
            args.append("--no-link-probes")
        if self.link_peer_names:
            args += ["--link-peers", ",".join(self.link_peer_names)]
        return args

    def world_devices(self) -> list[torch.device]:
        """The devices the gate's world spans; asking for a card where none
        is visible raises."""
        if self.devices:
            return [resolve_device(d) for d in self.devices]
        return available_devices(self.device)

    def _get_world(self, devices: list[torch.device]) -> World:
        if self._world is not None and self._world.error is not None:
            self._world = None
        if self._world is None:
            self._world = World(devices)
        return self._world

    def close(self) -> None:
        """Stop the gate's world (the next run forms a new one)."""
        if self._world is not None:
            self._world.close()
            self._world = None

    def run(self) -> HealthReport:
        start = time.perf_counter()
        failures: list[str] = []
        devices = self.world_devices()
        single_device = resolve_device(
            self.local_device if self.local_device is not None else devices[0]
        )
        world = self._get_world(devices)
        n = world.size

        collectives = run_ici_probes(world, "x", payload_mb=self.payload_mb)
        for c in collectives:
            if not c.ok:
                failures.append(f"{c.op}: {c.error}")
        ring = next((c for c in collectives if c.op == "ppermute_ring"), None)
        # One rank has no links: the floor is met vacuously, not failed.
        if (
            ring is not None
            and ring.ok
            and n > 1
            and self.min_ring_gbytes_per_s > 0
            and ring.gbytes_per_s < self.min_ring_gbytes_per_s
        ):
            failures.append(
                f"ring bandwidth {ring.gbytes_per_s:.2f} GB/s below floor "
                f"{self.min_ring_gbytes_per_s:.2f}"
            )

        links: list[LinkProbeReport] = []
        if self.run_link_probes and n > 1:
            # A failed hop fails the gate like a failed collective; a slow
            # one is a telemetry verdict, graded by the control plane.
            from ..ops.collectives import make_peer_resolver

            peer_of, owns_hop = make_peer_resolver(self.link_peer_names)
            links = [
                hop
                for hop in ppermute_per_link(
                    world, "x",
                    payload_mb=min(self.payload_mb, 1.0),
                    peer_of=peer_of,
                )
                if owns_hop(hop)
            ]
            for hop in links:
                if not hop.ok:
                    failures.append(
                        f"link {hop.src}->{hop.dst} ({hop.peer}): {hop.error}"
                    )

        mxu = mxu_probe(
            size=self.matmul_size,
            use_pallas=self.use_pallas_matmul,
            device=single_device,
        )
        if not mxu.ok:
            failures.append(f"mxu: {mxu.error}")
        elif self.min_mxu_tflops > 0 and mxu.tflops < self.min_mxu_tflops:
            failures.append(
                f"mxu {mxu.tflops:.2f} TFLOP/s below floor "
                f"{self.min_mxu_tflops:.2f}"
            )

        burnin_ok: Optional[bool] = None
        if self.run_burnin:
            burnin_ok = self._burnin(world)
            if not burnin_ok:
                failures.append("burn-in train step failed")

        ring_attn: Optional[RingAttentionReport] = None
        ulysses: Optional[UlyssesReport] = None
        if self.run_seq_parallel_probes:
            if n > 1:
                ring_attn = ring_attention_probe(
                    world, "x", seq_per_device=64, head_dim=32
                )
                if not ring_attn.ok:
                    failures.append(f"ring attention: {ring_attn.error}")
                ulysses = ulysses_probe(world, "x", seq_per_device=64, head_dim=32)
                if not ulysses.ok:
                    failures.append(f"ulysses: {ulysses.error}")
            else:
                # Not a failure (one card has no links to exercise), but
                # said, so the empty fields do not read as "ran and passed".
                log.warning(
                    "seq-parallel probes skipped: a single device has no "
                    "links to exercise"
                )

        flash: Optional[FlashAttentionReport] = None
        if self.run_flash_attention:
            flash = flash_attention_probe(device=single_device)
            if not flash.ok:
                failures.append(f"flash attention: {flash.error}")

        # One node is one host: the slice-wide agreement across hosts
        # (slice_agreement) waits for the multi-host gang.
        report = HealthReport(
            ok=not failures,
            collectives=collectives,
            mxu=mxu,
            burnin_ok=burnin_ok,
            ring_attention=ring_attn,
            ulysses=ulysses,
            flash=flash,
            links=links,
            elapsed_s=time.perf_counter() - start,
            failures=failures,
            process_count=1,
        )
        log.info("health gate: %s", report.summary())
        return report

    def _burnin(self, world: World) -> bool:
        """Two train steps of the gate's small config, sharded dp x tp over
        the world (tp 2 on an even number of ranks); the loss must be
        finite and fall."""
        try:
            from ..models.burnin import BurninConfig, sharded_losses

            n = world.size
            tp = 2 if n % 2 == 0 and n > 1 else 1
            cfg = BurninConfig(
                d_model=64, n_heads=4, d_ff=128, n_layers=1,
                seq_len=32, batch=max(2, (n // tp) * 2),
            )
            l1, l2 = world.run(sharded_losses, {"dp": n // tp, "tp": tp}, cfg)[0]
            return math.isfinite(l1) and math.isfinite(l2) and l2 < l1
        except Exception as e:  # noqa: BLE001 - any crash = unhealthy node
            log.error("burn-in failed: %s", e)
            return False

    def validation_hook(self):
        """A ValidationHook for with_validation_enabled: node -> healthy?"""

        def hook(node) -> bool:
            report = self.run()
            if not report.ok:
                log.warning(
                    "node %s failed the health gate: %s",
                    node.name, "; ".join(report.failures),
                )
            return report.ok

        return hook


def cache_warmup_hook(gate: Optional[HealthGate] = None):
    """Post-maintenance hook: run one battery while the node is still
    drained, so the gate that follows finds its world formed and its
    kernels built. A warm-up is not a gate: the result is logged and the
    hook always reports done (an unhealthy node is the validation gate's
    to catch)."""
    warm_gate = gate or IciHealthGate()

    def hook(node) -> bool:
        report = warm_gate.run()
        log.info(
            "post-maintenance warm-up on node %s: %s",
            node.name, report.summary(),
        )
        return True

    return hook


class SubprocessHealthGate:
    """Run the gate battery in a short-lived child process per cycle.

    The child is the same CLI the validation pod runs (:func:`main`); its
    JSON report line is parsed back into a :class:`HealthReport`. A child
    that outlives ``timeout_seconds`` is killed with its whole process group
    and becomes a failed report, never a hung monitor.
    """

    def __init__(
        self,
        cli_args: Optional[list[str]] = None,
        timeout_seconds: float = 600.0,
        env: Optional[dict] = None,
        cwd: Optional[str] = None,
    ) -> None:
        self.cli_args = list(cli_args) if cli_args is not None else []
        self.timeout_seconds = timeout_seconds
        self.env = env
        self.cwd = cwd

    def run(self) -> HealthReport:
        import json
        import os
        import signal
        import subprocess
        import sys

        cmd = [
            sys.executable, "-m", "k8s_operator_libs_tpu_torch.tpu.health",
            *self.cli_args,
        ]
        start = time.perf_counter()
        # Own session, so a timeout kills the whole group, grandchildren too.
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=self.env,
            cwd=self.cwd,
            start_new_session=True,
        )
        try:
            stdout, stderr = proc.communicate(timeout=self.timeout_seconds)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            try:
                proc.communicate(timeout=10.0)
            except subprocess.TimeoutExpired:
                for pipe in (proc.stdout, proc.stderr):
                    if pipe is not None:
                        pipe.close()
                proc.poll()
            return HealthReport(
                ok=False,
                elapsed_s=time.perf_counter() - start,
                failures=[
                    f"probe subprocess exceeded {self.timeout_seconds:.0f}s"
                ],
            )
        # The payload prints its report as the last JSON line even when the
        # battery fails (rc=1); fall back to stderr only when the child
        # crashed before reporting.
        for line in reversed((stdout or "").strip().splitlines()):
            try:
                parsed = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(parsed, dict):
                continue
            try:
                return HealthReport.from_dict(parsed)
            except TypeError:
                continue
        tail = (stderr or "").strip().splitlines()[-3:]
        return HealthReport(
            ok=False,
            elapsed_s=time.perf_counter() - start,
            failures=[
                f"probe subprocess rc={proc.returncode}: " + " | ".join(tail)
            ],
        )


def build_parser():
    """The payload's flags: the JAX payload's, less the gang, publish and
    XLA-cache flags, plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="k8s_operator_libs_tpu_torch.tpu.health",
        description="GPU health gate (validation-pod payload)",
    )
    parser.add_argument("--payload-mb", type=float, default=4.0)
    parser.add_argument("--matmul-size", type=int, default=1024)
    parser.add_argument("--min-ring-gbps", type=float, default=0.0)
    parser.add_argument("--min-mxu-tflops", type=float, default=0.0)
    parser.add_argument(
        "--device", default="cuda",
        help="device to probe (default cuda; cpu runs the plain versions)",
    )
    parser.add_argument(
        "--pallas-matmul", action="store_true",
        help="force the CUDA matmul kernel on",
    )
    parser.add_argument(
        "--no-pallas-matmul", action="store_true",
        help="force the CUDA matmul kernel OFF, overriding the automatic "
        "choice on cuda",
    )
    parser.add_argument(
        "--flash-attention", action="store_true",
        help="force the flash-attention probe on",
    )
    parser.add_argument(
        "--no-flash-attention", action="store_true",
        help="force the flash-attention probe OFF, overriding the automatic "
        "choice on cuda",
    )
    parser.add_argument(
        "--seq-parallel", action="store_true",
        help="run ring/ulysses attention probes (needs >1 device)",
    )
    parser.add_argument(
        "--no-seq-parallel", action="store_true",
        help="force the ring/ulysses probes OFF",
    )
    parser.add_argument("--no-burnin", action="store_true")
    parser.add_argument(
        "--no-link-probes", action="store_true",
        help="skip the per-hop link tier (runs only where there are links)",
    )
    parser.add_argument(
        "--link-peers", default="",
        help="comma-separated gang member node names by rank",
    )
    parser.add_argument(
        "--ready-file", default="",
        help="file written on pass (readinessProbe target)",
    )
    parser.add_argument(
        "--park", action="store_true",
        help="sleep forever after a pass (keeps the pod Ready)",
    )
    return parser


def main(argv: Optional[list[str]] = None) -> int:
    """Probe-pod payload: ``python -m k8s_operator_libs_tpu_torch.tpu.health``.

    Runs the gate battery on the card (or on ``--device``), prints the
    report as one JSON line, and on pass writes ``--ready-file`` — the
    pod's readinessProbe watches that file. ``--park`` keeps the process
    alive after a pass; on failure the process exits non-zero.
    """
    import json

    args = build_parser().parse_args(argv)

    device = resolve_device(args.device)
    # Kernel choice: explicit force-on/force-off flags win; with neither,
    # the kernels are on when the device is cuda.
    on_cuda = device.type == "cuda"
    use_pallas = args.pallas_matmul or (on_cuda and not args.no_pallas_matmul)
    use_flash = args.flash_attention or (on_cuda and not args.no_flash_attention)
    gate = IciHealthGate(
        min_ring_gbytes_per_s=args.min_ring_gbps,
        min_mxu_tflops=args.min_mxu_tflops,
        payload_mb=args.payload_mb,
        matmul_size=args.matmul_size,
        use_pallas_matmul=use_pallas,
        run_burnin=not args.no_burnin,
        run_seq_parallel_probes=args.seq_parallel and not args.no_seq_parallel,
        run_flash_attention=use_flash,
        device=device,
        run_link_probes=not args.no_link_probes,
        link_peer_names=[n for n in args.link_peers.split(",") if n] or None,
    )
    try:
        report = gate.run()
    finally:
        gate.close()
    print(json.dumps(dataclasses.asdict(report)), flush=True)
    if not report.ok:
        return 1
    if args.ready_file:
        with open(args.ready_file, "w") as f:
            f.write(report.summary() + "\n")
    if args.park:
        while True:
            time.sleep(3600)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
