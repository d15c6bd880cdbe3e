"""Lifecycle-resource registration.

The JAX package's ``utils/lifecycle.py``. Decorating a class with
:func:`lifecycle_resource` declares, with LITERAL method names readable
straight off the AST, which call pair bounds the class's background
footprint (threads, watch streams, sockets). A leaf module, so that any
layer can decorate its classes without an import cycle. The JAX package's
analyzer (its ``tools/analyze/lifecycle_discipline.py``) reads these
decorators; computed names are invisible to it and so are not used.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

__all__ = ["lifecycle_resource", "registered_resources"]

#: Class name -> (acquire method names, release method names).
_RESOURCES: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {}


def lifecycle_resource(
    acquire: Union[str, Iterable[str]] = "start",
    release: Union[str, Iterable[str]] = "stop",
) -> Callable[[type], type]:
    """Class decorator declaring the (acquire, release) method pair
    that bounds the class's background footprint.

    Arguments must be literals (the POL704 literal-registration
    contract). ``acquire="__init__"`` declares construction itself as
    the acquisition — the shape of a class whose ``__init__`` starts
    threads.
    """
    acquires = (acquire,) if isinstance(acquire, str) else tuple(acquire)
    releases = (release,) if isinstance(release, str) else tuple(release)

    def deco(cls: type) -> type:
        _RESOURCES[cls.__name__] = (acquires, releases)
        return cls

    return deco


def registered_resources() -> dict[str, tuple[tuple[str, ...], tuple[str, ...]]]:
    """Snapshot of the runtime registry (class name -> method pairs)."""
    return dict(_RESOURCES)
