"""The port's ``LocalApiServer`` on the wire, held to what the JAX
package's wire cases ask of a server.

Every case of ``tests/test_wire_transport.py``'s server classes runs here
once more with the port's server: content negotiation (JSON and
compact), connection reuse and pipelining, the fallbacks, the Status
errors, bookmark resumption after killed connections, Table-negotiated
watches, the server loop's stall watchdog, and watch-frame buffering.
The server serves twin clusters (``tests/torch_cluster_twins.py``); the
cases drive it with the JAX client, as they were written.
"""

import pytest

import test_wire_transport
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_wire_transport, globals(), server=True, only=[
    "TestNegotiation", "TestConnectionReuse", "TestContentNegotiationFallback",
    "TestErrorMapping", "TestBookmarkResume", "TestTableWatch", "TestLoopStallWatchdog",
    "TestWatchFrameBuffering",
])


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world
