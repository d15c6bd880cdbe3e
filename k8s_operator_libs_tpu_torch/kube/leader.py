"""Lease-based leader election for controller processes.

The JAX package's ``kube/leader.py``: client-go's ``tools/leaderelection``
over a ``coordination.k8s.io/v1`` Lease, for the port's
``upgrade_controller --leader-elect``. Only one replica reconciles,
standbys campaign, and a crashed leader is superseded after the lease
duration:

* **Acquire**: create the Lease if absent, or take it over when the
  observed holder has not renewed within ``lease_duration_s`` *as seen by
  this process's own clock*. A follower times from when it last SAW the
  record change, never from the ``renewTime`` inside it, so wall-clock skew
  between replicas cannot cause a false steal. A takeover increments
  ``leaseTransitions``.
* **Renew**: the leader updates ``renewTime`` every ``retry_period_s``; if
  no renewal succeeds for ``renew_deadline_s`` the elector reports the
  leadership lost. That is fatal to the caller by convention: a deposed
  leader must never keep reconciling (the command exits 3).
* **Release**: a graceful stop clears ``holderIdentity`` so that a standby
  acquires at once instead of waiting out the lease.

Every write is an update at the observed ``resourceVersion``; a conflict
is a lost race, observed again next round. API errors are told apart by
their ``reason`` (``kube/client.py``), whichever client raised them. Each
protocol round is one ``lease.round`` span (category ``lease``, with
``held``) and passes ``fault_point("lease.round")``; the Lease's
timestamps come from :func:`~..utils.faultpoints.wall_now`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Any, Callable, Optional

from .client import Client, ConflictError, NotFoundError, has_reason, is_api_error
from .objects import Lease
from ..utils import tracing
from ..utils.faultpoints import fault_point, wall_now
from ..utils.lifecycle import lifecycle_resource
from ..utils.log import get_logger

log = get_logger("kube.leader")


def _rfc3339_micro(now_wall: float) -> str:
    return (
        datetime.fromtimestamp(now_wall, tz=timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    )


@dataclass
class LeaderElectionConfig:
    """Tuning mirrors client-go's defaults (15s/10s/2s)."""

    name: str
    namespace: str
    identity: str
    lease_duration_s: float = 15.0
    renew_deadline_s: float = 10.0
    retry_period_s: float = 2.0
    on_started_leading: Optional[Callable[[], None]] = None
    on_stopped_leading: Optional[Callable[[], None]] = None
    on_new_leader: Optional[Callable[[str], None]] = None

    def __post_init__(self) -> None:
        if not self.identity:
            raise ValueError("leader election requires a non-empty identity")
        if self.renew_deadline_s >= self.lease_duration_s:
            raise ValueError(
                "renew_deadline_s must be shorter than lease_duration_s "
                "(a leader must notice loss before a standby can steal)"
            )
        if self.retry_period_s >= self.renew_deadline_s:
            raise ValueError(
                "retry_period_s must be shorter than renew_deadline_s"
            )


@dataclass
class _ObservedRecord:
    """What this process last saw in the Lease, and WHEN it saw it (local
    monotonic clock) — the skew-free liveness signal."""

    holder: str = ""
    raw_record: str = ""
    observed_at: float = 0.0
    transitions: int = 0
    resource_version: str = ""
    exists: bool = False


@lifecycle_resource(acquire="start", release="stop")
class LeaderElector:
    """Campaign for, hold, and release a Lease.

    Drive it either with the background thread (``start``/``stop``,
    ``wait_for_leadership``, ``is_leader``) or synchronously in tests via
    :meth:`try_acquire_or_renew` with an injected clock.
    """

    def __init__(
        self,
        client: Client,
        config: LeaderElectionConfig,
        now_fn: Callable[[], float] = time.monotonic,
        wall_fn: Callable[[], float] = wall_now,
    ) -> None:
        self._client = client
        self.config = config
        self._now = now_fn
        self._wall = wall_fn
        self._observed = _ObservedRecord()
        self._leader_since: Optional[float] = None
        self._last_renew: float = 0.0
        self._leading = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- observation -------------------------------------------------------

    def _observe(self, lease: Optional[Lease]) -> None:
        """Record the Lease state; restart the liveness clock only when
        the record actually CHANGED (client-go's observedRecord rule)."""
        if lease is None:
            if self._observed.exists:
                self._observed = _ObservedRecord()
            return
        raw_record = "|".join(
            (
                lease.holder_identity,
                lease.renew_time,
                str(lease.lease_transitions),
            )
        )
        if raw_record != self._observed.raw_record:
            self._observed = _ObservedRecord(
                holder=lease.holder_identity,
                raw_record=raw_record,
                observed_at=self._now(),
                transitions=lease.lease_transitions,
                resource_version=lease.resource_version,
                exists=True,
            )
            if (
                self.config.on_new_leader is not None
                and lease.holder_identity
                and lease.holder_identity != self.config.identity
            ):
                self.config.on_new_leader(lease.holder_identity)
        else:
            # Same record, fresher resourceVersion is still worth keeping
            # for the next optimistic write.
            self._observed.resource_version = lease.resource_version

    def _lease_spec(self, acquire: bool) -> dict[str, Any]:
        spec: dict[str, Any] = {
            "holderIdentity": self.config.identity,
            "leaseDurationSeconds": int(self.config.lease_duration_s),
            "renewTime": _rfc3339_micro(self._wall()),
        }
        if acquire:
            spec["acquireTime"] = spec["renewTime"]
            spec["leaseTransitions"] = self._observed.transitions + (
                1 if self._observed.exists else 0
            )
        return spec

    # -- the acquire/renew primitive (client-go tryAcquireOrRenew) ---------

    def try_acquire_or_renew(self) -> bool:
        """One protocol round; returns True iff this identity holds the
        lease afterwards. Never raises on API errors (a flaky apiserver
        must surface as lost renewals, not a crashed elector)."""
        cfg = self.config
        # One span a protocol round: a roll stalled behind a failover
        # shows as a run of held=False lease spans. A null scope when
        # tracing is off.
        with tracing.span(
            "lease.round", category="lease",
            lease=cfg.name, identity=cfg.identity,
        ) as round_span:
            held = self._try_acquire_or_renew()
            if round_span is not None:
                round_span.attrs["held"] = held
            return held

    def _try_acquire_or_renew(self) -> bool:
        cfg = self.config
        if fault_point("lease.round", name=cfg.name,
                       identity=cfg.identity) is not None:
            # An installed fault plan fails this round as a lost update
            # race would: the campaign's own retry and deadline are what
            # such a plan tests, so the fault enters through them.
            return False
        try:
            lease = Lease(self._client.get("Lease", cfg.name, cfg.namespace).raw)
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if has_reason(e, NotFoundError):
                lease = None
            elif is_api_error(e):
                log.warning("leader election: get lease failed: %s", e)
                return False
            else:
                raise
        self._observe(lease)

        if lease is None:
            fresh = Lease.new(cfg.name, namespace=cfg.namespace)
            fresh.raw["spec"] = self._lease_spec(acquire=True)
            try:
                created = Lease(self._client.create(fresh).raw)
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if not is_api_error(e):
                    raise
                log.info("leader election: create lost the race: %s", e)
                return False
            self._observe(created)
            return True

        holder = lease.holder_identity
        if holder and holder != cfg.identity:
            age = self._now() - self._observed.observed_at
            if age < cfg.lease_duration_s:
                return False  # live leader elsewhere — stand by
            log.info(
                "leader election: lease %s/%s held by %r went stale "
                "(%.1fs unobserved); taking over",
                cfg.namespace, cfg.name, holder, age,
            )

        if holder == cfg.identity:
            # Renewal preserves the acquisition record (client-go keeps
            # acquireTime/leaseTransitions across renewals — only the
            # renewTime moves).
            lease.spec["holderIdentity"] = cfg.identity
            lease.spec["leaseDurationSeconds"] = int(cfg.lease_duration_s)
            lease.spec["renewTime"] = _rfc3339_micro(self._wall())
        else:
            lease.raw["spec"] = self._lease_spec(acquire=True)
        try:
            updated = Lease(self._client.update(lease).raw)
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if has_reason(e, ConflictError):
                log.info("leader election: renew/steal lost an update race")
                return False
            if not is_api_error(e):
                raise
            log.warning("leader election: update lease failed: %s", e)
            return False
        self._observe(updated)
        return True

    def release(self) -> None:
        """Clear holderIdentity if we hold the lease (ReleaseOnCancel):
        standbys acquire immediately instead of timing the lease out."""
        cfg = self.config
        try:
            lease = Lease(self._client.get("Lease", cfg.name, cfg.namespace).raw)
            if lease.holder_identity != cfg.identity:
                return
            lease.spec["holderIdentity"] = ""
            lease.spec["renewTime"] = _rfc3339_micro(self._wall())
            self._client.update(lease)
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if has_reason(e, NotFoundError):
                return  # never acquired: nothing to release
            if not is_api_error(e):
                raise
            log.warning("leader election: release failed: %s", e)

    # -- background campaign ----------------------------------------------

    def is_leader(self) -> bool:
        return self._leading.is_set()

    def wait_for_leadership(self, timeout: Optional[float] = None) -> bool:
        return self._leading.wait(timeout)

    def start(self) -> "LeaderElector":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("elector already started")
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="leader-elector"
            )
            self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout=30)
        self._leading.clear()
        if release:
            # Unconditionally, not gated on _leading: the campaign thread
            # can be stopped BETWEEN writing the Lease and marking itself
            # leader — release() is identity-guarded and tolerates both a
            # missing lease and another holder, so it is always safe.
            self.release()
        with self._lock:
            self._thread = None

    def _run(self) -> None:
        cfg = self.config
        while not self._stop.is_set():
            # Campaign.
            while not self._stop.is_set() and not self.try_acquire_or_renew():
                self._stop.wait(cfg.retry_period_s)
            if self._stop.is_set():
                return
            self._last_renew = self._now()
            self._leader_since = self._last_renew
            self._leading.set()
            log.info(
                "leader election: %r acquired %s/%s",
                cfg.identity, cfg.namespace, cfg.name,
            )
            if cfg.on_started_leading is not None:
                cfg.on_started_leading()
            # Renew until the deadline passes without a success.
            while not self._stop.is_set():
                self._stop.wait(cfg.retry_period_s)
                if self._stop.is_set():
                    return
                if self.try_acquire_or_renew():
                    self._last_renew = self._now()
                elif self._now() - self._last_renew > cfg.renew_deadline_s:
                    break
            self._leading.clear()
            self._leader_since = None
            log.warning(
                "leader election: %r LOST %s/%s (no renewal within %.1fs)",
                cfg.identity, cfg.namespace, cfg.name, cfg.renew_deadline_s,
            )
            if cfg.on_stopped_leading is not None:
                cfg.on_stopped_leading()
