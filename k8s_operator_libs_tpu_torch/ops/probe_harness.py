"""Shared harness for numerics-checked attention probes, and the cheap
periodic probe tier (:func:`quick_battery`).

A probe runs the op on the device, compares it with the host oracle
(``reference_attention``) on the same quantized inputs, then times three
runs after the first. Inside a rank of a world each rank checks its own
block of the output, and the error and the times are the maximum over the
ranks, so every rank takes the same branch and reports the same numbers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.device import synchronize
from ..utils.log import get_logger

log = get_logger("ops.probe")


@dataclass
class ProbeReport:
    ok: bool
    max_abs_err: float = 0.0
    elapsed_s: float = 0.0
    tokens_per_s: float = 0.0
    error: str = ""


def host_qkv(shape: tuple[int, ...], seed: int) -> tuple[np.ndarray, ...]:
    """Host-generated q/k/v: the same seed gives the same operands here, in
    every rank, and in the JAX package."""
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape, dtype=np.float32) for _ in range(3)
    )


def quantize(t: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The values the device actually saw, back in f32 for the oracle."""
    return torch.from_numpy(np.ascontiguousarray(t)).to(dtype).float().numpy()


def shard_max_abs_err(
    out: torch.Tensor, expected: np.ndarray, index: tuple = (...,)
) -> float:
    """Max |out - expected[index]|, where ``out`` is this rank's block of
    the result and ``index`` its place in the whole."""
    got = out.float().cpu().numpy()
    return float(np.max(np.abs(got - expected[index])))


def run_checked_probe(
    name: str,
    run: Callable[[], torch.Tensor],
    expected: np.ndarray,
    *,
    tokens: int,
    tol: float,
    index: tuple = (...,),
    mesh=None,
    axis: str = "",
) -> ProbeReport:
    """Execute, verify against ``expected[index]``, then time 3 further
    runs. With ``mesh`` (inside a rank) the error and each sample are the
    maximum over the ranks of ``axis``."""
    out = run()
    synchronize(out.device)
    max_err = shard_max_abs_err(out, expected, index)
    if mesh is not None:
        from ..parallel.mesh import max_over

        (max_err,) = max_over(mesh, axis, [max_err])
    if not np.isfinite(max_err) or max_err > tol:
        return ProbeReport(
            ok=False,
            max_abs_err=max_err,
            error=f"numerics mismatch: max_abs_err={max_err:.4f} > {tol}",
        )
    samples = []
    for _ in range(3):
        start = time.perf_counter()
        synchronize(run().device)
        samples.append(time.perf_counter() - start)
    if mesh is not None:
        samples = max_over(mesh, axis, samples)
    elapsed = float(np.median(samples))
    report = ProbeReport(
        ok=True,
        max_abs_err=max_err,
        elapsed_s=elapsed,
        tokens_per_s=tokens / elapsed if elapsed > 0 else 0.0,
    )
    log.info(
        "%s probe: ok, %.0f tok/s, max_abs_err %.2e",
        name, report.tokens_per_s, max_err,
    )
    return report


def run_world_probe(world, fn: Callable, *args) -> ProbeReport:
    """A probe run by ``fn(*args)`` in every rank of ``world``, as one
    report: the ranks agree on the numbers, so the first failure or rank
    0's report. A failed world is a failed report."""
    try:
        reports = world.run(fn, *args)
    except Exception as e:  # noqa: BLE001 - a dead link is a failed probe
        return ProbeReport(ok=False, error=str(e))
    return next((r for r in reports if not r.ok), reports[0])


# ----------------------------------------------------------------------
# The quick battery: the low-rate telemetry probe tier.
# ----------------------------------------------------------------------

@dataclass
class QuickBatteryReport:
    """One quick-battery run in the telemetry plane's shape: per-check
    verdicts, numeric metrics and the per-neighbor link map (the
    ``(checks, metrics, links)`` a report publisher takes)."""

    ok: bool
    checks: dict[str, bool] = field(default_factory=dict)
    metrics: dict[str, float] = field(default_factory=dict)
    #: peer id -> {ok, latency_s, gbytes_per_s}. ``None`` means the link
    #: tier measured nothing this run (off, one rank, or it raised), which
    #: the publisher reads as "keep the last map"; an empty map replaces it.
    links: Optional[dict[str, dict]] = None
    elapsed_s: float = 0.0
    error: str = ""


def quick_battery(
    world,
    axis: str = "x",
    payload_mb: float = 0.25,
    matmul_size: int = 256,
    run_matmul: bool = True,
    probe_links: bool = True,
    peer_of=None,
    link_src_filter=None,
) -> QuickBatteryReport:
    """The cheap periodic probe tier, safe to run beside live workloads: a
    small-payload all-reduce, checked and timed (``psum_bandwidth``), each
    ring hop alone (``ppermute_per_link``, with ``probe_links``) and one
    small plain matmul on the world's first device: the plain product on
    purpose, as in the JAX package (no kernel, burn-in or attention here).

    ``peer_of`` maps destination ranks to link-map peer ids;
    ``link_src_filter`` keeps only the hops this caller owns. Failures
    degrade to verdicts, never raise.
    """
    from ..api.telemetry_v1alpha1 import (
        METRIC_MXU_TFLOPS,
        METRIC_PROBE_LATENCY_S,
        METRIC_RING_GBYTES_PER_S,
        METRIC_WORST_LINK_GBYTES_PER_S,
        METRIC_WORST_LINK_LATENCY_S,
    )
    from .collectives import ppermute_per_link, psum_bandwidth
    from .matmul import mxu_probe

    start = time.perf_counter()
    checks: dict[str, bool] = {}
    metrics: dict[str, float] = {}
    links: Optional[dict[str, dict]] = None
    error = ""
    try:
        ring = psum_bandwidth(world, axis, payload_mb=payload_mb)
        checks["ring_allreduce"] = ring.ok
        if ring.gbytes_per_s:
            metrics[METRIC_RING_GBYTES_PER_S] = round(ring.gbytes_per_s, 4)
        if not ring.ok:
            error = ring.error
    except Exception as e:  # noqa: BLE001 - a failed probe is a verdict
        checks["ring_allreduce"] = False
        error = str(e)
    if probe_links:
        try:
            hops = ppermute_per_link(
                world, axis, payload_mb=payload_mb, peer_of=peer_of
            )
            if link_src_filter is not None:
                hops = [h for h in hops if link_src_filter(h)]
            if hops:
                checks["links"] = all(h.ok for h in hops)
                links = {h.peer: h.observation() for h in hops}
                timed = [h for h in hops if h.ok and h.gbytes_per_s]
                if timed:
                    worst = min(timed, key=lambda h: h.gbytes_per_s)
                    metrics[METRIC_WORST_LINK_GBYTES_PER_S] = round(
                        worst.gbytes_per_s, 4
                    )
                    metrics[METRIC_WORST_LINK_LATENCY_S] = round(
                        max(h.latency_s for h in timed), 6
                    )
                if not checks["links"] and not error:
                    error = next(
                        (h.error for h in hops if not h.ok), "link probe failed"
                    )
        except Exception as e:  # noqa: BLE001
            checks["links"] = False
            if not error:
                error = str(e)
    if run_matmul:
        try:
            mxu = mxu_probe(
                size=matmul_size, use_pallas=False, device=world.devices[0]
            )
            checks["mxu"] = mxu.ok
            if mxu.ok and mxu.tflops:
                metrics[METRIC_MXU_TFLOPS] = round(mxu.tflops, 4)
            if not mxu.ok and not error:
                error = mxu.error
        except Exception as e:  # noqa: BLE001
            checks["mxu"] = False
            if not error:
                error = str(e)
    elapsed = time.perf_counter() - start
    metrics[METRIC_PROBE_LATENCY_S] = round(elapsed, 4)
    ok = all(checks.values()) if checks else False
    log.info(
        "quick battery: %s in %.2fs (%s)",
        "ok" if ok else f"FAILED ({error})",
        elapsed,
        ", ".join(f"{k}={v}" for k, v in sorted(metrics.items())),
    )
    return QuickBatteryReport(
        ok=ok, checks=checks, metrics=metrics, links=links,
        elapsed_s=elapsed, error=error,
    )


def slice_gang_quick_battery(
    world,
    axis: str = "x",
    member_names: Optional[list] = None,
    payload_mb: float = 0.25,
    matmul_size: int = 256,
) -> QuickBatteryReport:
    """The quick battery in slice-gang shape: the link tier on, hops to
    ranks on other hosts keyed by the peer host's node name
    (``member_names``, by gang rank), and only the hops whose source is on
    this host reported. On one node every rank is local, so the peers keep
    their ``device-<rank>`` tags."""
    from .collectives import make_peer_resolver

    peer_of, owns_hop = make_peer_resolver(member_names)
    return quick_battery(
        world=world,
        axis=axis,
        payload_mb=payload_mb,
        matmul_size=matmul_size,
        probe_links=True,
        peer_of=peer_of,
        link_src_filter=owns_hop,
    )


def run_quick_probe_cycle(
    publisher, battery: Callable[[], QuickBatteryReport]
) -> QuickBatteryReport:
    """One quick-probe publish cycle: run ``battery`` (a quick battery over
    a world the caller keeps, e.g. ``lambda: quick_battery(world)``) and
    hand its checks, metrics and link map to ``publisher.publish``."""
    report = battery()
    publisher.publish(report.checks, report.metrics, links=report.links)
    return report
