"""The Kubernetes object views, API-error helpers, Event recorder, label
and field selectors, minimal REST client with its watch, and the
list-watch informer that the GPU device class, the monitor, the slice gang,
the state machine and the CRD utility need; and the controller runtime
over them: the rate-limited workqueue, the informer-fed ``Controller`` and
Lease-based leader election. The operator passes in its own client and
objects; the port reads them by duck typing and imports none of the
operator's code. The monitor, run as a pod, builds its own
``rest.RestClient``."""

from .client import WatchExpiredError, patch_many
from .controller import Controller, Request, Result
from .events import EventRecorder
from .informer import EventHandler, Informer
from .leader import LeaderElectionConfig, LeaderElector
from .objects import CustomResourceDefinition, Lease, deep_copy_json
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
    "BucketRateLimiter",
    "Controller",
    "CustomResourceDefinition",
    "DEFAULT_WATCH_TIMEOUT_SECONDS",
    "DelayingQueue",
    "EventHandler",
    "EventRecorder",
    "FieldRequirement",
    "FieldSelector",
    "Informer",
    "ItemExponentialFailureRateLimiter",
    "LabelSelector",
    "LeaderElectionConfig",
    "LeaderElector",
    "Lease",
    "MaxOfRateLimiter",
    "RateLimitingQueue",
    "Request",
    "Requirement",
    "RestClient",
    "RestConfig",
    "Result",
    "SelectorError",
    "WatchExpiredError",
    "WatchHandle",
    "WorkQueue",
    "default_controller_rate_limiter",
    "deep_copy_json",
    "parse_field_selector",
    "parse_selector",
    "patch_many",
]
