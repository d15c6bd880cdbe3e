"""Per-node tasks, with a node's operation never scheduled twice at once.

The JAX package's ``upgrade/task_runner.py`` without its tracing spans.
Two shapes of work:

* :meth:`TaskRunner.submit` runs a keyed task in the background (a drain,
  an eviction and its wait); a key still in flight is refused, and the
  task writes its outcome as the node's next state, never returning it;
* :meth:`TaskRunner.run_bucket` fans a pass's per-state bucket out over a
  bounded pool and joins it before the pass moves on; one node's error is
  captured and never stops the others.

``inline=True`` runs everything on the caller's thread, in order: the
deterministic mode of the tests and of a simulated roll.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

from ..utils.log import get_logger
from ..utils.sync import StringSet

log = get_logger("upgrade.task_runner")


class TaskRunner:
    def __init__(self, max_workers: int = 16, inline: bool = False) -> None:
        self._inline = inline
        self._max_workers = max_workers
        self._in_progress = StringSet()
        self._executor: Optional[ThreadPoolExecutor] = None
        if not inline:
            self._executor = ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix="upgrade-task"
            )
        # A pool of its own for buckets, made on first use, so queued
        # background tasks never starve a joined bucket.
        self._bucket_executor: Optional[ThreadPoolExecutor] = None
        self._bucket_executor_lock = threading.Lock()

    def run_bucket(
        self,
        tasks: Sequence[tuple[str, Callable[[], None]]],
        width: Optional[int] = None,
    ) -> list[Optional[Exception]]:
        """Run keyed tasks at most ``width`` at a time (default
        ``max_workers``) and join them; each task's exception, or None, in
        input order. Inline runners, width 1 and single tasks run serially
        on the caller's thread."""
        tasks = list(tasks)
        results: list[Optional[Exception]] = [None] * len(tasks)

        def guarded(index: int, key: str, fn: Callable[[], None]) -> None:
            try:
                fn()
            except Exception as e:  # isolation: collect, never bubble here
                results[index] = e
                log.warning("bucket task %s failed: %s", key, e)

        effective = self._max_workers if width is None else width
        if self._inline or effective <= 1 or len(tasks) <= 1:
            for i, (key, fn) in enumerate(tasks):
                guarded(i, key, fn)
            return results
        with self._bucket_executor_lock:
            if self._bucket_executor is None:
                self._bucket_executor = ThreadPoolExecutor(
                    max_workers=self._max_workers, thread_name_prefix="upgrade-bucket"
                )
            executor = self._bucket_executor
        gate = threading.Semaphore(min(effective, self._max_workers))

        def gated(index: int, key: str, fn: Callable[[], None]) -> None:
            with gate:
                guarded(index, key, fn)

        futures = [executor.submit(gated, i, key, fn) for i, (key, fn) in enumerate(tasks)]
        for future in futures:
            future.result()  # guarded() never raises; this is a join
        return results

    def submit(self, key: str, fn: Callable[[], None]) -> bool:
        """Run ``fn`` under ``key``; False (and nothing run) when an
        operation of the same key is still in flight."""
        if not self._in_progress.add_if_absent(key):
            log.debug("task %s already in progress, skipping", key)
            return False
        if self._inline:
            try:
                fn()
            finally:
                self._in_progress.remove(key)
            return True

        def run() -> None:
            try:
                fn()
            except Exception:  # tasks own their error handling; never bubble
                log.exception("task %s raised unexpectedly", key)
            finally:
                self._in_progress.remove(key)

        assert self._executor is not None
        self._executor.submit(run)
        return True

    def shutdown(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
        with self._bucket_executor_lock:
            executor, self._bucket_executor = self._bucket_executor, None
        if executor is not None:
            executor.shutdown(wait=True)
