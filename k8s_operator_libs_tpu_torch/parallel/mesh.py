"""Worlds of rank processes and the meshes the probes run over: the
counterpart of the JAX package's ``parallel/mesh.py``.

JAX drives every local device from one process, names them in a ``Mesh``
and lets XLA insert the collectives. Here each device is driven by a rank
process of its own, and the collectives go through ``torch.distributed``:

* :class:`World`, in the calling process, starts one rank process per
  device with the ``spawn`` start method, joins them through NCCL on cards
  or through gloo on the CPU, and runs module-level functions of this
  package in every rank at once. Every wait is bounded: a rank that dies,
  raises or does not answer in time makes the call raise
  :class:`WorldError`, and the world is killed, never left waiting. A
  world may span hosts (the slice gang): each host's ``World`` spawns its
  own devices' ranks, and all of them join one group through a TCP
  rendezvous at a coordinator address, the JAX package's
  ``jax.distributed`` gang in torch's terms.
* :func:`build_mesh` and :func:`single_axis_mesh`, inside a rank, lay the
  world's ranks out on named axes in the JAX package's grid order and give
  each axis its process group.

The functions a world runs live in this package: under ``spawn`` a rank
imports the module that holds each function it is sent.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback
import weakref
from dataclasses import dataclass
from datetime import timedelta
from multiprocessing.connection import wait
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from ..utils.log import get_logger

log = get_logger("parallel.mesh")

#: Seconds a world may take to form: spawn, import torch, join the group.
FORM_TIMEOUT_S = 300.0
#: Seconds one call may take in every rank; also the collectives' timeout.
CALL_TIMEOUT_S = 300.0
#: Seconds the ranks are given to leave before they are killed.
CLOSE_TIMEOUT_S = 10.0


def available_devices(device: DeviceLike = None) -> list[torch.device]:
    """The devices a world spans: every visible card (``device`` None or
    ``cuda``), one card (``cuda:<i>``) or one CPU rank (``cpu``). Asking for
    a card where none is visible raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class WorldError(RuntimeError):
    """A world failed: a rank died, raised or did not answer in time."""


class World:
    """One rank process per device, joined into one ``torch.distributed``
    group: NCCL when the devices are cards, gloo when they are the CPU
    (``["cpu"] * n``). It is never one on behalf of the other.

    The ranks start at the first :meth:`run` (or :meth:`start`) and live
    until :meth:`close`, a failure, or the world's garbage collection, so
    one world serves many calls. Rendezvous goes through a ``file://``
    store in a fresh temporary directory, so concurrent worlds never
    contend for a port.

    **Across hosts.** With ``coordinator`` (``host:port``), this world is
    host ``host_index`` of ``num_hosts``: its ranks join the others' through
    a TCP store that rank 0 of host 0 holds at that address. Global rank
    is ``host_index * len(devices) + local rank``; :attr:`size` is the
    whole world's, :attr:`devices` this host's, and :meth:`run` returns
    this host's ranks' results. Every host must bring the same number of
    devices: a mismatch fails the world with the counts in its error. Every
    host calls the same functions in the same order, as a gang does. A
    host that never arrives fails the world after ``form_timeout_s``. One
    host with a coordinator is a gang of one: it still goes through the
    TCP rendezvous.
    """

    def __init__(
        self,
        devices: Sequence[DeviceLike],
        *,
        form_timeout_s: Optional[float] = None,
        call_timeout_s: Optional[float] = None,
        coordinator: str = "",
        num_hosts: int = 1,
        host_index: int = 0,
    ) -> None:
        if num_hosts < 1 or not 0 <= host_index < num_hosts:
            raise ValueError(f"host {host_index} of {num_hosts} hosts")
        if num_hosts > 1 and not coordinator:
            raise ValueError("a world of more than one host needs a coordinator")
        if coordinator and not coordinator.rpartition(":")[2].isdigit():
            raise ValueError(f"coordinator {coordinator!r} is not host:port")
        #: The TCP rendezvous address; empty for a world on one host.
        self.coordinator = coordinator
        self.num_hosts = num_hosts
        self.host_index = host_index
        devs = [torch.device(d) for d in devices]
        kinds = {d.type for d in devs}
        if not devs or len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(
                f"a world spans cards or CPU ranks, one kind only: {devs}"
            )
        # A card named without an index is the rank's own: cuda:<rank>.
        self.devices = [
            torch.device("cuda", i if d.index is None else d.index)
            if d.type == "cuda" else d
            for i, d in enumerate(devs)
        ]
        # The module's defaults are read here, not when the class is made.
        self.form_timeout_s = FORM_TIMEOUT_S if form_timeout_s is None else form_timeout_s
        self.call_timeout_s = CALL_TIMEOUT_S if call_timeout_s is None else call_timeout_s
        #: Why the world went down; every later call raises with it.
        self.error: Optional[str] = None
        #: Where forming the world went, in seconds, each phase the slowest
        #: rank's (:data:`FORM_PHASES`); empty until the world has formed.
        self.form_times: dict[str, float] = {}
        self._procs: list = []
        self._conns: list = []
        self._dir: Optional[str] = None
        self._finalizer: Optional[weakref.finalize] = None

    @property
    def size(self) -> int:
        """Ranks in the whole world, every host's."""
        return len(self.devices) * self.num_hosts

    @property
    def local_size(self) -> int:
        """Ranks on this host."""
        return len(self.devices)

    def host_of(self, rank: int) -> int:
        """The host a global rank runs on."""
        return rank // self.local_size

    @property
    def backend(self) -> str:
        return "nccl" if self.devices[0].type == "cuda" else "gloo"

    def start(self) -> "World":
        """Spawn the ranks and wait, within ``form_timeout_s``, until every
        one has joined and carried one all-reduce."""
        if self.error is not None:
            raise WorldError(self.error)
        if self._procs:
            return self
        ctx = mp.get_context("spawn")
        if self.coordinator:
            rendezvous = {
                "coordinator": self.coordinator,
                "num_hosts": self.num_hosts,
                "host_index": self.host_index,
                "timeout_s": self.form_timeout_s,
            }
        else:
            self._dir = tempfile.mkdtemp(prefix="torch-world-")
            rendezvous = {"init_method": "file://" + os.path.join(self._dir, "rendezvous")}
        names = [str(d) for d in self.devices]
        # Registered first, so ranks already started are stopped whatever
        # happens next; it sees the lists as they fill.
        self._finalizer = weakref.finalize(
            self, _shutdown, self._procs, self._conns, self._dir
        )
        spawned = time.time()
        start = time.perf_counter()
        for rank in range(self.local_size):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main,
                args=(rank, names, rendezvous, self.call_timeout_s, child),
                name=f"world-rank-{rank}",
                daemon=True,
            )
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        stamps = self._gather("forming the world", self.form_timeout_s)
        phases = GANG_FORM_PHASES if self.coordinator else FORM_PHASES
        self.form_times = _form_times(spawned, stamps, phases)
        self.form_times["total"] = time.perf_counter() - start
        log.info(
            "world of %d %s rank(s) over %d host(s) formed in %.2f s (%s)",
            self.size, self.backend, self.num_hosts, self.form_times["total"],
            ", ".join(f"{k} {v:.2f} s" for k, v in self.form_times.items()),
        )
        return self

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None) -> list:
        """``fn(*args)`` in every rank at once; the results, by rank.

        ``fn`` is a module-level function of this package (it is sent by
        name). Raises :class:`WorldError`, and kills the world, when a rank
        raises, dies, or any rank has not answered within ``timeout_s``
        (default ``call_timeout_s``)."""
        self.start()
        what = getattr(fn, "__qualname__", repr(fn))
        for rank, conn in enumerate(self._conns):
            try:
                conn.send((fn, args))
            except (OSError, ValueError) as e:
                self._fail(f"{what}: rank {rank} is gone ({e})")
        return self._gather(what, timeout_s or self.call_timeout_s)

    def close(self) -> None:
        """Ask every rank to leave, kill those that have not within
        ``CLOSE_TIMEOUT_S``, and remove the rendezvous directory."""
        if self.error is None:
            self.error = "the world was closed"
        if self._finalizer is not None:
            self._finalizer()

    def _gather(self, what: str, timeout_s: float) -> list:
        deadline = time.monotonic() + timeout_s
        results: dict[int, Any] = {}
        while len(results) < self.local_size:
            pending = [r for r in range(self.local_size) if r not in results]
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._fail(
                    f"{what}: rank(s) {pending} did not answer within "
                    f"{timeout_s:g} s"
                )
            waitables = {self._conns[r]: r for r in pending}
            waitables.update({self._procs[r].sentinel: r for r in pending})
            for ready in wait(list(waitables), timeout=remaining):
                rank = waitables[ready]
                if rank in results:
                    continue
                conn = self._conns[rank]
                try:
                    if ready is not conn and not conn.poll():
                        raise EOFError
                    status, value = conn.recv()
                except (EOFError, OSError):
                    self._procs[rank].join(1.0)
                    self._fail(
                        f"{what}: rank {rank} died "
                        f"(exit code {self._procs[rank].exitcode})"
                    )
                if status != "ok":
                    self._fail(f"{what}: rank {rank} raised:\n{value}")
                results[rank] = value
        return [results[r] for r in range(self.local_size)]

    def _fail(self, message: str) -> None:
        self.error = message
        if self._finalizer is not None:
            self._finalizer.detach()
            _shutdown(self._procs, self._conns, self._dir, graceful=False)
        log.error("world of %d rank(s) killed: %s", self.size, message)
        raise WorldError(message)


#: The phases of forming a world, each timed in every rank: from the spawn
#: until the rank runs (a new interpreter, ``import torch`` and this
#: package), the device's context, joining the process group (NCCL makes
#: its communicator here), and the first all-reduce.
FORM_PHASES = ("spawn_import", "device_context", "group_init", "first_collective")
#: A world across hosts adds the TCP join: reaching the coordinator's store
#: and every host's card count being there.
GANG_FORM_PHASES = (
    "spawn_import", "device_context", "tcp_join", "group_init", "first_collective",
)


def _form_times(
    spawned: float, stamps: Sequence[Sequence[float]], phases: Sequence[str] = FORM_PHASES
) -> dict[str, float]:
    """Each phase's seconds in the slowest rank of this host, from the
    wall-clock stamps each rank took at the end of each phase (the host's
    clock, which its ranks share)."""
    times: dict[str, float] = {}
    for i, phase in enumerate(phases):
        times[phase] = max(
            rank[i] - (rank[i - 1] if i else spawned) for rank in stamps
        )
    return times


def _shutdown(procs, conns, directory, graceful: bool = True) -> None:
    if graceful:
        for conn in conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + CLOSE_TIMEOUT_S
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(CLOSE_TIMEOUT_S)
    for conn in conns:
        conn.close()
    if directory is not None:
        shutil.rmtree(directory, ignore_errors=True)


# ----------------------------------------------------------------------
# Inside a rank.
# ----------------------------------------------------------------------

def _tcp_join(local_rank: int, local_size: int, rendezvous: dict):
    """Reach the gang's TCP store (rank 0 of host 0 holds it), post this
    host's card count and wait for every host's; the store and this rank's
    global rank. Hosts with different counts fail here, every one of them,
    with the counts in the error."""
    host, _, port = rendezvous["coordinator"].rpartition(":")
    hosts, index = rendezvous["num_hosts"], rendezvous["host_index"]
    rank = index * local_size + local_rank
    timeout = timedelta(seconds=rendezvous["timeout_s"])
    store = dist.TCPStore(
        host, int(port), is_master=rank == 0, timeout=timeout, wait_for_workers=False,
    )
    if local_rank == 0:
        store.set(f"cards/{index}", str(local_size))
    keys = [f"cards/{h}" for h in range(hosts)]
    store.wait(keys, timeout)
    counts = [int(store.get(k)) for k in keys]
    if any(c != local_size for c in counts):
        raise RuntimeError(
            f"the gang's hosts brought different card counts {counts} "
            f"(host {index} brought {local_size}); every host must bring the same"
        )
    return store, rank, local_size * hosts


def _rank_main(local_rank: int, devices: list[str], rendezvous: dict,
               timeout_s: float, conn) -> None:
    """A rank process: join the group, then run what the world sends until
    it sends ``None`` or goes away. Its answer to the join is the wall-clock
    time at the end of each of :data:`FORM_PHASES` (with a coordinator,
    :data:`GANG_FORM_PHASES`)."""
    stamps = [time.time()]
    device = torch.device(devices[local_rank])
    try:
        options: dict = {}
        if device.type == "cuda":
            # A peer that dies makes a collective raise instead of block.
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
            torch.cuda.set_device(device)
            torch.empty(1, device=device)  # the context, made here to time it
            backend = "nccl"
            options["device_id"] = device
        else:
            # Ranks share the host's cores with each other and the caller.
            torch.set_num_threads(1)
            backend = "gloo"
        stamps.append(time.time())
        if "coordinator" in rendezvous:
            store, rank, size = _tcp_join(local_rank, len(devices), rendezvous)
            options["store"] = dist.PrefixStore("world", store)
            stamps.append(time.time())
        else:
            rank, size = local_rank, len(devices)
            options["init_method"] = rendezvous["init_method"]
        dist.init_process_group(
            backend,
            world_size=size,
            rank=rank,
            timeout=timedelta(seconds=timeout_s),
            **options,
        )
        stamps.append(time.time())
        joined = torch.ones(1, device=device)
        dist.all_reduce(joined)
        if int(joined.item()) != size:
            raise RuntimeError(f"{int(joined.item())} of {size} ranks joined")
        stamps.append(time.time())
    except Exception:  # noqa: BLE001 - reported to the world, which fails
        conn.send(("error", traceback.format_exc()))
        return
    conn.send(("ok", stamps))
    try:
        while True:
            try:
                message = conn.recv()
            except EOFError:
                break
            if message is None:
                break
            fn, args = message
            try:
                reply = ("ok", fn(*args))
            except Exception:  # noqa: BLE001 - reported to the world
                reply = ("error", traceback.format_exc())
            conn.send(reply)
    finally:
        dist.destroy_process_group()


def rank_device() -> torch.device:
    """The device this rank drives."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclass(frozen=True)
class Mesh:
    """This rank's place on named axes: for each axis its size, this
    rank's index on it, the process group of the ranks that differ from
    this one only on it, and that group's global ranks by index."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Any]
    ranks: dict[str, tuple[int, ...]]
    device: torch.device


#: Meshes this rank has built: ``dist.new_group`` is collective, so each
#: layout is made once, by every rank, in the same order.
_MESHES: dict[tuple, Mesh] = {}


def build_mesh(axes: Mapping[str, int]) -> Mesh:
    """Lay the world out on named axes (inside a rank). The axis order is
    the grid order, row-major as in the JAX package: the last axis varies
    fastest, so it should carry the heaviest traffic. The axis sizes must
    multiply to the world size."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh runs inside a rank of a World")
    names = tuple(axes)
    sizes = tuple(int(axes[name]) for name in names)
    key = (names, sizes)
    if key in _MESHES:
        return _MESHES[key]
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(
            f"mesh axes {dict(axes)} need {math.prod(sizes)} ranks, "
            f"the world has {world}"
        )
    me = dist.get_rank()
    grid = np.arange(world).reshape(sizes)
    coords = {
        name: int(c) for name, c in zip(names, np.argwhere(grid == me)[0])
    }
    groups: dict[str, Any] = {}
    ranks: dict[str, tuple[int, ...]] = {}
    for i, name in enumerate(names):
        for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            members = tuple(int(r) for r in line)
            group = (
                dist.group.WORLD if len(members) == world
                else dist.new_group(list(members))
            )
            if me in members:
                groups[name] = group
                ranks[name] = members
    mesh = Mesh(
        shape=dict(zip(names, sizes)),
        coords=coords,
        groups=groups,
        ranks=ranks,
        device=rank_device(),
    )
    _MESHES[key] = mesh
    return mesh


def single_axis_mesh(name: str = "x") -> Mesh:
    """Every rank of the world on one axis: the shape the ring probes use."""
    return build_mesh({name: dist.get_world_size()})


def max_over(mesh: Mesh, axis: str, values: Sequence[float]) -> list[float]:
    """Elementwise maximum of ``values`` over the ranks of ``axis`` (inside
    a rank); a value that is not finite counts as infinite."""
    t = torch.tensor(
        [v if math.isfinite(v) else math.inf for v in values],
        dtype=torch.float64, device=mesh.device,
    )
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.groups[axis])
    return t.cpu().tolist()


def exchange(
    mesh: Mesh,
    axis: str,
    sends: Sequence[tuple[torch.Tensor, int]],
    recvs: Sequence[tuple[torch.Tensor, int]],
) -> None:
    """Point-to-point sends and receives in one ``batch_isend_irecv`` (inside
    a rank), each ``(tensor, peer)`` with the peer's index on ``axis``;
    returns when all have completed. A rank with neither takes no part."""
    group, ranks = mesh.groups[axis], mesh.ranks[axis]
    ops = [dist.P2POp(dist.isend, t, ranks[p], group) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, t, ranks[p], group) for t, p in recvs]
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
