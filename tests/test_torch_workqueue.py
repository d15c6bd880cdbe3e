"""The port's workqueue against the JAX package's, case by case.

Every case of ``tests/test_workqueue.py`` runs once with each package's
``kube/workqueue.py`` on the same inputs (the same fake clock where the JAX
case has one); each run makes the JAX case's checks and returns what it
observed, and the two packages' observations must be equal.
"""

from __future__ import annotations

import threading
import time

import pytest

from k8s_operator_libs_tpu.kube import workqueue as jax_wq
from k8s_operator_libs_tpu_torch.kube import workqueue as port_wq

MODS = {"jax": jax_wq, "port": port_wq}


def on_both(case):
    """``case(module)`` for each package; their outcomes must be equal."""
    outcomes = {name: case(mod) for name, mod in MODS.items()}
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


class TestWorkQueue:
    def test_fifo_and_dedup(self):
        def case(wq):
            q = wq.WorkQueue()
            q.add("a")
            q.add("b")
            q.add("a")  # dedup: already dirty
            length = len(q)
            got = [q.get(), q.get()]
            q.done("a")
            q.done("b")
            assert length == 2 and got == ["a", "b"] and len(q) == 0
            return length, got, len(q)

        on_both(case)

    def test_in_flight_exclusion_defers_readd(self):
        def case(wq):
            q = wq.WorkQueue()
            q.add("a")
            first = q.get()
            q.add("a")  # re-added while processing: not handed out concurrently
            during = q.get(timeout=0.05)
            q.done("a")  # ...but queued again the moment processing ends
            again = q.get(timeout=5.0)
            q.done("a")
            after = q.get(timeout=0.05)
            assert (first, during, again, after) == ("a", None, "a", None)
            return first, during, again, after

        on_both(case)

    def test_add_during_processing_coalesces(self):
        def case(wq):
            q = wq.WorkQueue()
            q.add("a")
            first = q.get()
            for _ in range(3):
                q.add("a")
            q.done("a")
            again = q.get(timeout=5.0)
            q.done("a")
            after = q.get(timeout=0.05)  # three adds, one re-add
            assert (first, again, after) == ("a", "a", None)
            return first, again, after

        on_both(case)

    def test_no_concurrent_processing_of_same_key(self):
        def case(wq):
            q = wq.WorkQueue()
            in_flight: dict[str, int] = {}
            max_seen = {"v": 0}
            lock = threading.Lock()
            stop = threading.Event()

            def worker():
                while not stop.is_set():
                    item = q.get(timeout=0.2)
                    if item is None:
                        continue
                    with lock:
                        in_flight[item] = in_flight.get(item, 0) + 1
                        max_seen["v"] = max(max_seen["v"], in_flight[item])
                    time.sleep(0.002)
                    with lock:
                        in_flight[item] -= 1
                    q.done(item)

            workers = [threading.Thread(target=worker) for _ in range(4)]
            for w in workers:
                w.start()
            for i in range(300):
                q.add(f"key-{i % 3}")  # heavy contention on 3 keys
                if i % 10 == 0:
                    time.sleep(0.001)
            deadline = time.monotonic() + 10
            while len(q) and time.monotonic() < deadline:
                time.sleep(0.01)
            stop.set()
            for w in workers:
                w.join(timeout=5)
            assert max_seen["v"] == 1, "same key processed concurrently"
            return max_seen["v"]

        on_both(case)

    def test_shutdown_wakes_getters(self):
        def case(wq):
            q = wq.WorkQueue()
            got = {}
            t = threading.Thread(target=lambda: got.setdefault("v", q.get()))
            t.start()
            time.sleep(0.05)
            q.shutdown()
            t.join(timeout=5)
            alive = t.is_alive()
            q.add("late")  # adds after shutdown are dropped
            assert not alive and got["v"] is None and len(q) == 0
            return alive, got["v"], len(q)

        on_both(case)

    def test_shutdown_with_drain_waits_for_in_flight(self):
        def case(wq):
            q = wq.WorkQueue()
            q.add("a")
            item = q.get()
            done_at = {}

            def finish():
                time.sleep(0.1)
                done_at["t"] = time.monotonic()
                q.done(item)

            t = threading.Thread(target=finish)
            t.start()
            drained = q.shutdown_with_drain(timeout=5.0)
            waited = time.monotonic() >= done_at["t"]
            t.join()
            assert drained is True and waited
            return drained, waited

        on_both(case)

    def test_shutdown_with_drain_times_out(self):
        def case(wq):
            q = wq.WorkQueue()
            q.add("stuck")
            q.get()  # never done
            drained = q.shutdown_with_drain(timeout=0.1)
            assert drained is False
            return drained

        on_both(case)


class TestDelayingQueue:
    def test_add_after_matures(self):
        def case(wq):
            q = wq.DelayingQueue()
            t0 = time.monotonic()
            q.add_after("a", 0.15)
            early = q.get(timeout=0.05)  # not yet
            got = q.get(timeout=5.0)
            waited = time.monotonic() - t0 >= 0.14
            q.done("a")
            q.shutdown()
            assert (early, got, waited) == (None, "a", True)
            return early, got, waited

        on_both(case)

    def test_nonpositive_delay_is_immediate(self):
        def case(wq):
            q = wq.DelayingQueue()
            q.add_after("a", 0.0)
            got = q.get(timeout=5.0)
            q.done("a")
            q.shutdown()
            assert got == "a"
            return got

        on_both(case)

    def test_sooner_deadline_wins(self):
        def case(wq):
            q = wq.DelayingQueue()
            q.add_after("a", 30.0)
            q.add_after("a", 0.05)  # supersedes with the sooner deadline
            t0 = time.monotonic()
            got = q.get(timeout=5.0)
            prompt = time.monotonic() - t0 < 5.0
            q.done("a")
            stale = q.get(timeout=0.2)  # the 30 s entry must not fire again
            q.shutdown()
            assert (got, prompt, stale) == ("a", True, None)
            return got, prompt, stale

        on_both(case)

    def test_later_duplicate_deadline_ignored(self):
        def case(wq):
            q = wq.DelayingQueue()
            q.add_after("a", 0.05)
            q.add_after("a", 30.0)  # ignored: an earlier timer pends
            got = q.get(timeout=5.0)
            q.done("a")
            after = q.get(timeout=0.2)
            q.shutdown()
            assert (got, after) == ("a", None)
            return got, after

        on_both(case)

    def test_shutdown_drops_pending_timers(self):
        def case(wq):
            q = wq.DelayingQueue()
            q.add_after("a", 0.05)
            q.shutdown()
            got = q.get(timeout=0.3)
            assert got is None
            return got

        on_both(case)


class TestRateLimiters:
    def test_item_exponential_progression_and_forget(self):
        def case(wq):
            rl = wq.ItemExponentialFailureRateLimiter(base_delay=0.005, max_delay=1000.0)
            seen = [rl.when("a") for _ in range(3)]
            requeues = rl.num_requeues("a")
            other = rl.when("b")  # independent per item
            rl.forget("a")
            forgotten = rl.num_requeues("a")
            fresh = rl.when("a")
            assert seen == pytest.approx([0.005, 0.010, 0.020]) and requeues == 3
            assert other == pytest.approx(0.005) and forgotten == 0
            assert fresh == pytest.approx(0.005)
            return seen, requeues, other, forgotten, fresh

        on_both(case)

    def test_item_exponential_caps_at_max(self):
        def case(wq):
            rl = wq.ItemExponentialFailureRateLimiter(base_delay=1.0, max_delay=8.0)
            delays = [rl.when("a") for _ in range(80)]
            assert delays[:4] == [1.0, 2.0, 4.0, 8.0]
            assert all(d == 8.0 for d in delays[4:])  # huge counts included
            return delays

        on_both(case)

    def test_bucket_burst_then_smoothing(self):
        def case(wq):
            clock = {"t": 0.0}
            rl = wq.BucketRateLimiter(qps=10.0, burst=3, clock=lambda: clock["t"])
            burst = [rl.when("x") for _ in range(3)]
            # The bucket is empty: each reservation matures 100 ms later.
            smoothed = [rl.when("x"), rl.when("x")]
            clock["t"] = 10.0  # time refills it
            refilled = rl.when("x")
            assert burst == [0.0, 0.0, 0.0] and smoothed == pytest.approx([0.1, 0.2])
            assert refilled == 0.0
            return burst, smoothed, refilled

        on_both(case)

    def test_max_of_combines(self):
        def case(wq):
            clock = {"t": 0.0}
            rl = wq.MaxOfRateLimiter(
                wq.ItemExponentialFailureRateLimiter(0.005, 1000.0),
                wq.BucketRateLimiter(qps=1.0, burst=1, clock=lambda: clock["t"]),
            )
            a = rl.when("a")  # bucket 0, item 5 ms
            b = rl.when("b")  # the bucket is empty now
            rl.forget("a")
            assert a == pytest.approx(0.005) and b == pytest.approx(1.0)
            assert rl.num_requeues("a") == 0
            return a, b, rl.num_requeues("a")

        on_both(case)

    def test_default_controller_rate_limiter_shape(self):
        def case(wq):
            rl = wq.default_controller_rate_limiter()
            seen = [rl.when("a"), rl.when("a")]
            assert seen == pytest.approx([0.005, 0.010])
            return seen

        on_both(case)


class TestRateLimitingQueue:
    def test_backoff_then_forget(self):
        def case(wq):
            q = wq.RateLimitingQueue(
                wq.ItemExponentialFailureRateLimiter(base_delay=0.03, max_delay=1.0)
            )
            q.add_rate_limited("a")
            requeues = q.num_requeues("a")
            early = q.get(timeout=0.01)  # still backing off
            got = q.get(timeout=5.0)
            q.done("a")
            q.forget("a")
            forgotten = q.num_requeues("a")
            q.shutdown()
            assert (requeues, early, got, forgotten) == (1, None, "a", 0)
            return requeues, early, got, forgotten

        on_both(case)
