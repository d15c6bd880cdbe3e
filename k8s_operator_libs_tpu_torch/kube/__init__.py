"""The Kubernetes object views, API-error helpers, Event recorder, label
and field selectors, minimal REST client with its watch, and the
list-watch informer that the GPU device class, the monitor, the slice gang,
the state machine and the CRD utility need; the wire path under the
client (the compact codec, the wire loop's stall watchdog) and the shared
watch over it (``WatchHub`` in one process, ``WatchRelay`` and
``RelayWatchSource`` across processes); and the controller runtime over
them: the rate-limited workqueue, the informer-fed ``Controller`` and
Lease-based leader election; and the in-memory cluster of the tests and
demos (``FakeCluster`` with its patch engines, server-side apply and
structural schemas, ``CachedClient`` over it, ``FakeRecorder``), the
HTTP API server over that cluster (``LocalApiServer``) and the resource
registry every client routes through. The operator passes in its own client and
objects; the port reads them by duck typing and imports none of the
operator's code. The monitor, run as a pod, builds its own
``rest.RestClient``."""

from .apiserver import LocalApiServer
from .cache import CachedClient
from .client import ListDelta, UnsupportedMediaTypeError, WatchExpiredError, patch_many
from .controller import Controller, Request, Result
from .events import EventRecorder, FakeRecorder
from .fake import FakeCluster, json_patch, merge_patch
from .informer import EventHandler, Informer
from .leader import LeaderElectionConfig, LeaderElector
from .loopwatch import LoopStallWatchdog, install_wire_loop_watchdog, wire_loop_stall_stats
from .objects import ConfigMap, CustomResourceDefinition, Lease, deep_copy_json
from .relay import RelayWatchSource, WatchRelay
from .resources import ResourceInfo, register_resource, resource_for_kind
from .rest import DEFAULT_WATCH_TIMEOUT_SECONDS, RestClient, RestConfig, WatchHandle
from .selectors import (
    FieldRequirement,
    FieldSelector,
    LabelSelector,
    Requirement,
    SelectorError,
    parse_field_selector,
    parse_selector,
)
from .ssa import ApplyConflictError, server_side_apply
from .structural import StructuralSchema, schema_for_crd_version
from .watchhub import WatchHub
from .wire import (
    WireDecodeError,
    decode_body,
    decode_compact,
    encode_body,
    encode_compact,
    encode_watch_frame,
    negotiate_encoding,
)
from .workqueue import (
    BucketRateLimiter,
    DelayingQueue,
    ItemExponentialFailureRateLimiter,
    MaxOfRateLimiter,
    RateLimitingQueue,
    WorkQueue,
    default_controller_rate_limiter,
)

__all__ = [
    "ApplyConflictError",
    "BucketRateLimiter",
    "CachedClient",
    "ConfigMap",
    "Controller",
    "CustomResourceDefinition",
    "DEFAULT_WATCH_TIMEOUT_SECONDS",
    "DelayingQueue",
    "EventHandler",
    "EventRecorder",
    "FakeCluster",
    "FakeRecorder",
    "FieldRequirement",
    "FieldSelector",
    "Informer",
    "ItemExponentialFailureRateLimiter",
    "LabelSelector",
    "LeaderElectionConfig",
    "LeaderElector",
    "Lease",
    "ListDelta",
    "LocalApiServer",
    "LoopStallWatchdog",
    "MaxOfRateLimiter",
    "RateLimitingQueue",
    "RelayWatchSource",
    "Request",
    "Requirement",
    "ResourceInfo",
    "RestClient",
    "RestConfig",
    "Result",
    "SelectorError",
    "StructuralSchema",
    "UnsupportedMediaTypeError",
    "WatchExpiredError",
    "WatchHandle",
    "WatchHub",
    "WatchRelay",
    "WireDecodeError",
    "WorkQueue",
    "decode_body",
    "decode_compact",
    "deep_copy_json",
    "default_controller_rate_limiter",
    "encode_body",
    "encode_compact",
    "encode_watch_frame",
    "install_wire_loop_watchdog",
    "json_patch",
    "merge_patch",
    "negotiate_encoding",
    "parse_field_selector",
    "parse_selector",
    "patch_many",
    "register_resource",
    "resource_for_kind",
    "schema_for_crd_version",
    "server_side_apply",
    "wire_loop_stall_stats",
]
