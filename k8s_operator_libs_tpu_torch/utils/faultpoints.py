"""The wall clock behind the state machine's durable clocks.

The part of the JAX package's ``utils/faultpoints.py`` that the upgrade
managers read: :func:`wall_now` is ``time.time`` unless a clock is
installed, and the annotation-backed deadlines (the validation timeout,
the wait for workload pods) read it. A test installs a virtual clock, an
object with a ``wall()`` method, so a deadline passes when the test says
time passed; the same clock object may be installed here and in the JAX
package to drive both machines alike. The fault plans of the JAX module
have no counterpart here.
"""

from __future__ import annotations

import time
from typing import Optional, Protocol


class WallClock(Protocol):
    def wall(self) -> float: ...


_clock: Optional[WallClock] = None


def install_clock(clock: Optional[WallClock]) -> None:
    """Install the clock behind :func:`wall_now`; one at a time."""
    global _clock
    if _clock is not None and clock is not None:
        raise RuntimeError("a clock is already installed")
    _clock = clock


def clear_clock() -> None:
    global _clock
    _clock = None


def wall_now() -> float:
    """``time.time()``, or the installed clock's ``wall()``."""
    clock = _clock
    return time.time() if clock is None else clock.wall()
