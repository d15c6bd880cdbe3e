"""The Kubernetes object views, API-error helpers, Event recorder, label
and field selectors, minimal REST client with its watch, and the
list-watch informer that the GPU device class, the monitor, the slice gang,
the state machine and the CRD utility need. The operator passes in its own client and
objects; the port reads them by duck typing and imports none of the
operator's code. The monitor, run as a pod, builds its own
``rest.RestClient``."""

from .client import WatchExpiredError, patch_many
from .events import EventRecorder
from .informer import EventHandler, Informer
from .objects import CustomResourceDefinition, deep_copy_json
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

__all__ = [
    "CustomResourceDefinition",
    "DEFAULT_WATCH_TIMEOUT_SECONDS",
    "EventHandler",
    "EventRecorder",
    "FieldRequirement",
    "FieldSelector",
    "Informer",
    "LabelSelector",
    "Requirement",
    "RestClient",
    "RestConfig",
    "SelectorError",
    "WatchExpiredError",
    "WatchHandle",
    "deep_copy_json",
    "parse_field_selector",
    "parse_selector",
    "patch_many",
]
