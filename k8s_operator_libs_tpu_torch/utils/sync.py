"""Concurrency primitives for per-node operations.

A copy of the JAX package's ``utils/sync.py``: a thread-safe string set
that keeps a node with an operation in flight from being scheduled twice,
and a mutex per key that serializes the state writes of one node.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator


class StringSet:
    """A thread-safe set of strings (the task runner's "in progress" set)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: set[str] = set()

    def add_if_absent(self, item: str) -> bool:
        """Add ``item`` unless present, in one lock hold; True when added
        (a test, then an add, would let two callers both claim it)."""
        with self._lock:
            if item in self._items:
                return False
            self._items.add(item)
            return True

    def remove(self, item: str) -> None:
        with self._lock:
            self._items.discard(item)


class KeyedMutex:
    """A mutex per key, created on first use and kept (one per node)."""

    def __init__(self) -> None:
        self._guard = threading.Lock()
        self._locks: dict[str, threading.Lock] = {}

    def _lock_for(self, key: str) -> threading.Lock:
        with self._guard:
            lock = self._locks.get(key)
            if lock is None:
                lock = threading.Lock()
                self._locks[key] = lock
            return lock

    @contextmanager
    def locked(self, key: str) -> Iterator[None]:
        lock = self._lock_for(key)
        lock.acquire()
        try:
            yield
        finally:
            lock.release()
