"""Consistent-hash ring: the fleet tier's key partitioner.

The JAX package's ``fleet/hashring.py``. The fleet control plane splits
pool keys across shards, and shards across workers, under two
requirements a plain ``hash(key) % n`` cannot meet:

* **stable across processes**: every worker computes the same owner for
  the same key with no coordination. Python's ``hash`` is randomized per
  process, so the ring hashes with BLAKE2b, byte-stable everywhere (and
  the same owner as the JAX package's ring for every key);
* **bounded churn**: a membership change moves only the keys next to the
  changed member, never reshuffles the world, which would invalidate every
  worker's incremental snapshot at once. Virtual nodes (``replicas``
  points a member) give about K/N moved keys a change.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Iterable, Mapping


def stable_hash(key: str) -> int:
    """A process-stable 64-bit hash (BLAKE2b), never the builtin ``hash``:
    two workers that disagree on a key's owner would both roll its pool or
    neither would."""
    digest = hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class HashRing:
    """A consistent-hash ring over string members with virtual nodes.

    Membership changes and lookups take a leaf lock, under which nothing
    blocks.
    """

    def __init__(self, members: Iterable[str] = (), replicas: int = 128) -> None:
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.replicas = int(replicas)
        self._lock = threading.Lock()
        self._members: set[str] = set()
        #: The sorted virtual nodes: (point hash, member).
        self._points: list[tuple[int, str]] = []
        for member in members:
            self.add(member)

    # -- membership ------------------------------------------------------------
    def add(self, member: str) -> None:
        if not member:
            raise ValueError("ring member must be a non-empty string")
        with self._lock:
            if member in self._members:
                return
            self._members.add(member)
            for replica in range(self.replicas):
                bisect.insort(self._points, (stable_hash(f"{member}#{replica}"), member))

    def remove(self, member: str) -> None:
        with self._lock:
            if member not in self._members:
                return
            self._members.discard(member)
            self._points = [(point, m) for point, m in self._points if m != member]

    def members(self) -> frozenset[str]:
        with self._lock:
            return frozenset(self._members)

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    # -- ownership -------------------------------------------------------------
    def owner(self, key: str) -> str:
        """The member owning ``key``: the first virtual node clockwise from
        the key's hash, wrapping at the top. An empty ring raises: a
        default owner would let an unconfigured worker claim the fleet."""
        with self._lock:
            if not self._points:
                raise ValueError("hash ring has no members")
            index = bisect.bisect_right(self._points, (stable_hash(key), ""))
            if index == len(self._points):
                index = 0
            return self._points[index][1]

    def assignment(self, keys: Iterable[str]) -> Mapping[str, list[str]]:
        """member -> its sorted keys, every member present (maybe empty)."""
        out: dict[str, list[str]] = {m: [] for m in self.members()}
        for key in keys:
            out[self.owner(key)].append(key)
        for owned in out.values():
            owned.sort()
        return out
