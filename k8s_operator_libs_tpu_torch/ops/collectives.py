"""Link probes: correctness-checked collectives with bandwidth timing, over
NCCL between cards (gloo between CPU ranks).

The data-plane half of the health gate. Each probe is a collective whose
result is exactly verifiable: a flapping link shows up either as wrong
numerics or as a throughput collapse, and both fail the gate. The names,
``op`` strings, checked values and error texts are the JAX package's.

Each probe runs in every rank of a :class:`~..parallel.mesh.World` at once
(the ``_*_rank`` functions below), on the ranks' single-axis mesh; the
caller folds the ranks' answers into one report. Every failure, a dead or
silent rank included, becomes a failed report, never an exception. A timed
op's time is the same on every rank: the maximum over ranks of each sample,
then the median of the samples.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh, World, exchange, max_over, single_axis_mesh
from ..utils.device import synchronize
from ..utils.log import get_logger

log = get_logger("ops.collectives")

# torch renamed the tensor forms of all-gather and reduce-scatter; take the
# name the installed torch has.
_all_gather_tensor = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_tensor = (
    getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
)


@dataclass
class CollectiveReport:
    op: str
    ok: bool
    elapsed_s: float = 0.0
    gbytes_per_s: float = 0.0
    error: str = ""


@dataclass
class LinkProbeReport:
    """One timed neighbor exchange, rank ``src`` -> rank ``dst``, exercised
    and timed alone so the number attributes to one link. ``peer`` is the
    id the telemetry link map is keyed by."""

    src: int
    dst: int
    peer: str
    ok: bool
    latency_s: float = 0.0
    gbytes_per_s: float = 0.0
    error: str = ""

    def observation(self) -> dict:
        """The per-hop observation shape of the telemetry link map."""
        return {
            "ok": self.ok,
            "latency_s": self.latency_s,
            "gbytes_per_s": self.gbytes_per_s,
        }


def _timed(fn: Callable[[], object], mesh: Mesh, axis: str,
           warmup: int = 1, iters: int = 3) -> float:
    """Median over ``iters`` samples, after ``warmup`` runs, of the slowest
    rank's wall time for ``fn`` (the card synchronized in each)."""
    for _ in range(warmup):
        fn()
        synchronize(mesh.device)
    samples = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        synchronize(mesh.device)
        samples.append(time.perf_counter() - start)
    return float(np.median(max_over(mesh, axis, samples)))


def _rate(nbytes: float, seconds: float) -> float:
    return nbytes / seconds / 1e9 if seconds > 0 else 0.0


def _shard(mesh: Mesh, axis: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``full``, split evenly over ``axis``."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    size = full.shape[0] // n
    return full[i * size:(i + 1) * size].to(mesh.device)


def _run(world: World, op: str, fn: Callable, *args) -> Union[list, CollectiveReport]:
    """The ranks' answers, or a failed report when the world failed."""
    try:
        return world.run(fn, *args)
    except Exception as e:  # noqa: BLE001 - a dead world is a failed link
        return CollectiveReport(op=op, ok=False, error=str(e))


# ----------------------------------------------------------------------
# The battery.
# ----------------------------------------------------------------------

def _psum_rank(axis: str) -> list[float]:
    mesh = single_axis_mesh(axis)
    x = _shard(mesh, axis, torch.arange(mesh.shape[axis], dtype=torch.float32))
    dist.all_reduce(x, group=mesh.groups[axis])
    return x.cpu().tolist()


def psum_check(world: World, axis: str = "x") -> CollectiveReport:
    """All-reduce correctness: every rank contributes its index; the sum
    must be exactly n(n-1)/2 everywhere."""
    parts = _run(world, "psum", _psum_rank, axis)
    if isinstance(parts, CollectiveReport):
        return parts
    n = world.size
    expected = n * (n - 1) / 2
    got = [v for part in parts for v in part]
    ok = all(v == expected for v in got)
    return CollectiveReport(
        op="psum", ok=ok, error="" if ok else f"expected {expected}, got {got}",
    )


def _all_gather_rank(axis: str) -> list[float]:
    mesh = single_axis_mesh(axis)
    n = mesh.shape[axis]
    out = torch.empty(n, dtype=torch.float32, device=mesh.device)
    _all_gather_tensor(
        out, _shard(mesh, axis, torch.arange(n, dtype=torch.float32)),
        group=mesh.groups[axis],
    )
    return out.cpu().tolist()


def all_gather_check(world: World, axis: str = "x") -> CollectiveReport:
    """all_gather correctness: each rank's shard must appear in order, on
    every rank."""
    parts = _run(world, "all_gather", _all_gather_rank, axis)
    if isinstance(parts, CollectiveReport):
        return parts
    expected = [float(i) for i in range(world.size)]
    ok = all(part == expected for part in parts)
    return CollectiveReport(
        op="all_gather", ok=ok, error="" if ok else "gathered order mismatch",
    )


def _reduce_scatter_rank(axis: str) -> list[float]:
    mesh = single_axis_mesh(axis)
    n = mesh.shape[axis]
    out = torch.empty(1, dtype=torch.float32, device=mesh.device)
    _reduce_scatter_tensor(
        out, torch.ones(n, dtype=torch.float32, device=mesh.device),
        group=mesh.groups[axis],
    )
    return out.cpu().tolist()


def reduce_scatter_check(world: World, axis: str = "x") -> CollectiveReport:
    """Reduce-scatter correctness: ``ones(n)`` on every rank, summed and
    scattered, is exactly ``n`` everywhere."""
    parts = _run(world, "reduce_scatter", _reduce_scatter_rank, axis)
    if isinstance(parts, CollectiveReport):
        return parts
    n = world.size
    got = [v for part in parts for v in part]
    ok = all(v == n for v in got)
    return CollectiveReport(
        op="reduce_scatter", ok=ok,
        error="" if ok else f"expected all {n}, got {got[:8]}...",
    )


def _payload_elems(payload_mb: float) -> int:
    return max(1, int(payload_mb * 1e6 / 4))


def _ring_rank(axis: str, elems: int) -> tuple[bool, float]:
    mesh = single_axis_mesh(axis)
    n, i = mesh.shape[axis], mesh.coords[axis]
    x = _shard(mesh, axis, torch.arange(n * elems, dtype=torch.float32))

    def hop(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(t)
        exchange(mesh, axis, [(t, (i + 1) % n)], [(out, (i - 1) % n)])
        return out

    elapsed = _timed(lambda: hop(x), mesh, axis)
    # n hops return every shard to its origin.
    y = x
    for _ in range(n):
        y = hop(y)
    return torch.equal(y, x), elapsed


def ppermute_ring(world: World, axis: str = "x",
                  payload_mb: float = 4.0) -> CollectiveReport:
    """Ring neighbor exchange with bandwidth: each rank sends its buffer to
    the next one around the ring; after n hops every buffer is back home,
    which is verified exactly. Bandwidth = payload bytes / median hop time.
    One rank has no ring: it reports ok, "single device", and sends
    nothing."""
    if world.size < 2:
        return CollectiveReport(op="ppermute_ring", ok=True, error="single device")
    elems = _payload_elems(payload_mb)
    parts = _run(world, "ppermute_ring", _ring_rank, axis, elems)
    if isinstance(parts, CollectiveReport):
        return parts
    ok = all(part[0] for part in parts)
    elapsed = parts[0][1]
    return CollectiveReport(
        op="ppermute_ring",
        ok=ok,
        elapsed_s=elapsed,
        gbytes_per_s=_rate(elems * 4, elapsed),
        error="" if ok else "ring did not return shards to origin",
    )


def default_peer_name(rank: int) -> str:
    """Link-map peer id for a rank with no caller-supplied name: a stable
    local tag, deliberately not a node name, so intra-node hops stay out of
    the fleet topology fold."""
    return f"device-{rank}"


def make_peer_resolver(
    member_names: Optional[list] = None,
    world: Optional[World] = None,
) -> tuple[Callable[[int], str], Callable[[LinkProbeReport], bool]]:
    """The one peer-id policy every battery shape shares, so the full gate
    and the quick battery emit the same link-map keys. Returns
    ``(peer_of, owns_hop)``:

    * ``peer_of(rank)``: a rank on another host of ``world`` resolves to
      ``member_names[host]`` (gang host -> node name, the fleet fold's join
      key) where the list covers that host; a rank on this host, or one
      the list does not cover, keeps its :func:`default_peer_name` tag (a
      wrong node name would poison the fold; a device tag stays out of it);
    * ``owns_hop(hop)``: whether the hop's source rank is on this host, so
      each gang member publishes its own outgoing links.

    Without ``world`` (or on a world of one host) every rank is local.
    """
    hosts = world.num_hosts if world is not None else 1
    me = world.host_index if world is not None else 0

    def host_of(rank: int) -> int:
        return world.host_of(rank) if hosts > 1 else me

    def peer_of(rank: int) -> str:
        host = host_of(rank)
        if member_names is not None and host != me and 0 <= host < len(member_names):
            return str(member_names[host])
        return default_peer_name(rank)

    def owns_hop(hop: LinkProbeReport) -> bool:
        return host_of(hop.src) == me

    return peer_of, owns_hop


#: A hop's error on the ranks that did not see the fault themselves.
_ELSEWHERE = "failed on another rank"


def _link_rank(axis: str, elems: int, src: int, dst: int) -> tuple[bool, str, float]:
    mesh = single_axis_mesh(axis)
    n, i = mesh.shape[axis], mesh.coords[axis]
    base = torch.arange(n * elems, dtype=torch.float32)
    x = _shard(mesh, axis, base)
    out = torch.zeros_like(x)

    def hop() -> None:
        out.zero_()
        exchange(
            mesh, axis,
            [(x, dst)] if i == src else [],
            [(out, src)] if i == dst else [],
        )

    elapsed = _timed(hop, mesh, axis)
    hop()
    error = ""
    if i == dst:
        sent = base[src * elems:(src + 1) * elems]
        if not torch.equal(out.cpu(), sent):
            error = f"hop {src}->{dst}: payload corrupted"
    elif bool(out.any()):
        error = f"hop {src}->{dst}: leak into untargeted shard"
    # Every rank learns the hop's verdict: across hosts the hop's owner (its
    # source) is not the rank that checks the payload.
    (failed,) = max_over(mesh, axis, [1.0 if error else 0.0])
    if failed and not error:
        error = f"hop {src}->{dst}: {_ELSEWHERE}"
    return not error, error, elapsed


def ppermute_per_link(
    world: World,
    axis: str = "x",
    payload_mb: float = 1.0,
    peer_of: Optional[Callable[[int], str]] = None,
) -> list[LinkProbeReport]:
    """Time each ring hop alone: hop ``i -> (i+1) % n`` has only rank ``i``
    send and only its successor receive, so the time attributes to one
    link. Every rank's buffer starts at zero; afterwards exactly the
    successor's must hold the payload and every other must still be zero.
    ``peer_of(rank)`` maps the hop's destination to its link-map peer id.
    A failed hop is a failed report for that link, never an exception."""
    n = world.size
    if n < 2:
        return []
    elems = _payload_elems(payload_mb)
    reports: list[LinkProbeReport] = []
    for i in range(n):
        j = (i + 1) % n
        peer = peer_of(j) if peer_of is not None else default_peer_name(j)
        try:
            parts = world.run(_link_rank, axis, elems, i, j)
        except Exception as e:  # noqa: BLE001 - a dead hop is a verdict
            reports.append(LinkProbeReport(src=i, dst=j, peer=peer, ok=False, error=str(e)))
            continue
        # The rank that saw the fault says what it was; the others only
        # that it happened elsewhere.
        errors = sorted(
            (err for ok, err, _ in parts if not ok), key=lambda e: e.endswith(_ELSEWHERE)
        )
        error = errors[0] if errors else ""
        elapsed = parts[0][2]
        reports.append(
            LinkProbeReport(
                src=i, dst=j, peer=peer, ok=not error,
                latency_s=elapsed,
                gbytes_per_s=_rate(elems * 4, elapsed),
                error=error,
            )
        )
    return reports


def _psum_bandwidth_rank(axis: str, elems: int) -> tuple[bool, float]:
    mesh = single_axis_mesh(axis)
    n, i = mesh.shape[axis], mesh.coords[axis]
    x = (torch.arange(elems, dtype=torch.float32) + i).to(mesh.device)
    y = torch.empty_like(x)

    def reduce() -> None:
        y.copy_(x)
        dist.all_reduce(y, group=mesh.groups[axis])

    elapsed = _timed(reduce, mesh, axis)
    reduce()
    # Sum over ranks: n * arange + n(n-1)/2, the same on every rank.
    expected = torch.arange(elems, dtype=torch.float32) * n + n * (n - 1) / 2
    return torch.equal(y.cpu(), expected), elapsed


def psum_bandwidth(world: World, axis: str = "x",
                   payload_mb: float = 4.0) -> CollectiveReport:
    """Ring all-reduce with correctness and bandwidth: every rank
    contributes ``arange + rank``, the sum is checked exactly, and
    ``gbytes_per_s`` is NCCL's bus bandwidth, ``2(n-1)/n * bytes / time``
    (nccl-tests' busbw column)."""
    n = world.size
    if n < 2:
        return CollectiveReport(
            op="psum_ring_allreduce", ok=True, error="single device"
        )
    elems = _payload_elems(payload_mb)
    parts = _run(world, "psum_ring_allreduce", _psum_bandwidth_rank, axis, elems)
    if isinstance(parts, CollectiveReport):
        return parts
    ok = all(part[0] for part in parts)
    elapsed = parts[0][1]
    return CollectiveReport(
        op="psum_ring_allreduce",
        ok=ok,
        elapsed_s=elapsed,
        gbytes_per_s=_rate(2 * (n - 1) / n * elems * 4, elapsed),
        error="" if ok else "all-reduce sum mismatch",
    )


def _agreement_rank(axis: str, local_ok: bool) -> int:
    mesh = single_axis_mesh(axis)
    x = torch.tensor([1.0 if local_ok else 0.0], device=mesh.device)
    dist.all_reduce(x, group=mesh.groups[axis])
    return int(round(float(x.item())))


def slice_agreement(world: World, axis: str = "x", local_ok: bool = True) -> tuple[int, int]:
    """``(ranks that passed, ranks)``: every rank contributes the verdict to
    an all-reduce over the links under test, so every rank learns whether
    every rank passed; ``passed == ranks`` only if all said ok."""
    passed = world.run(_agreement_rank, axis, local_ok)[0]
    log.info("slice agreement: %d/%d ranks passed", passed, world.size)
    return passed, world.size


def run_ici_probes(
    world: World,
    axis: str = "x",
    payload_mb: float = 4.0,
) -> list[CollectiveReport]:
    """The collective battery over one axis of ``world``: psum, all_gather
    and reduce_scatter checked exactly, and the ring exchange timed."""
    reports = [
        psum_check(world, axis),
        all_gather_check(world, axis),
        reduce_scatter_check(world, axis),
        ppermute_ring(world, axis, payload_mb=payload_mb),
    ]
    for r in reports:
        log.info(
            "collective probe %s: %s%s",
            r.op,
            "ok" if r.ok else f"FAILED ({r.error})",
            f", {r.gbytes_per_s:.2f} GB/s" if r.gbytes_per_s else "",
        )
    return reports
