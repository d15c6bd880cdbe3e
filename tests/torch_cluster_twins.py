"""Lockstep twins of the JAX package's in-memory cluster and the port's,
for the parity files ``tests/test_torch_{fake_cluster,ssa,structural,
json_patch,patch_semantics,owner_gc,generation,cache}.py``.

Each of those files collects every case of its JAX file (the classes,
functions and fixtures are imported into it, so pytest collects them
again under the port file's name) and installs :func:`twin_world` as an
autouse fixture. While a case runs, the names the JAX case reaches for
the in-memory cluster (``FakeCluster``, ``CachedClient``, the patch
engines, server-side apply, the structural schemas, the resource
registry) are twins: every call goes to the JAX object and to the port's
counterpart in turn, under one lock, and the twin compares

* what each returns (objects by their documents, tuples, lists, deltas),
* the arguments after the call (the patch engines and the schemas edit
  their target in place),
* the error each raised: its class name, its ``reason``, its message and
  its attributes,

and hands the JAX side's result (or raises the JAX side's error) to the
case, whose own assertions then run unchanged. When the case ends, each
twin cluster's store, event journal, revision, call log and the events
each subscriber received are compared, and both clusters are closed.
A ``LocalApiServer`` the case starts serves a twin cluster, so the wire
cases drive both clusters too.

Normalized before any comparison, and only these: ``creationTimestamp``
and ``deletionTimestamp`` (the wall clock at the write) and the ``time``
of each ``managedFields`` entry. uids and continue tokens are made equal
instead: both modules draw them from generators seeded alike for each
case.

Reactors and subscribers are passed to the JAX cluster as given; the
port's cluster gets a stand-in that replays what the JAX reactor did
(raising the port's error of the same class name) and that records what
the port's cluster delivered.
"""

from __future__ import annotations

import random
import threading
import time
import types
import uuid
from collections import deque
from typing import Any, Callable

import pytest

import k8s_operator_libs_tpu.kube as jax_kube
import k8s_operator_libs_tpu.kube.apiserver as jax_apiserver
import k8s_operator_libs_tpu.kube.cache as jax_cache
import k8s_operator_libs_tpu.kube.fake as jax_fake
import k8s_operator_libs_tpu.kube.resources as jax_resources
import k8s_operator_libs_tpu.kube.ssa as jax_ssa
import k8s_operator_libs_tpu.kube.structural as jax_structural
from k8s_operator_libs_tpu.kube.objects import KubeObject as JaxKubeObject
import k8s_operator_libs_tpu_torch.kube.cache as port_cache
import k8s_operator_libs_tpu_torch.kube.client as port_client
import k8s_operator_libs_tpu_torch.kube.fake as port_fake
import k8s_operator_libs_tpu_torch.kube.resources as port_resources
import k8s_operator_libs_tpu_torch.kube.ssa as port_ssa
import k8s_operator_libs_tpu_torch.kube.structural as port_structural
from k8s_operator_libs_tpu_torch.kube.objects import KubeObject as PortKubeObject
from k8s_operator_libs_tpu_torch.kube.objects import wrap as port_wrap

#: JAX module name -> the port's module of the same relative path.
PORT_MODULES = {
    jax_mod.__name__: port_mod
    for jax_mod, port_mod in ((jax_fake, port_fake), (jax_ssa, port_ssa),
                              (jax_structural, port_structural), (jax_cache, port_cache),
                              (jax_resources, port_resources))
}
#: Keys whose values are the wall clock at a write.
TIME_KEYS = frozenset({"creationTimestamp", "deletionTimestamp"})


class Mismatch(AssertionError):
    pass


# -- normalization ---------------------------------------------------------
def norm(value: Any) -> Any:
    """A comparable form: views by their documents, the clock-valued
    fields blanked."""
    if isinstance(value, (JaxKubeObject, PortKubeObject)):
        return ("object", norm(value.raw))
    if isinstance(value, dict):
        out = {}
        managed = "manager" in value and "time" in value
        for k, v in value.items():
            if k in TIME_KEYS or (managed and k == "time"):
                out[k] = "<time>"
            else:
                out[k] = norm(v)
        return out
    if isinstance(value, (list, tuple, deque)):
        return [norm(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return ("set", sorted(repr(norm(v)) for v in value))
    if type(value).__name__ == "ListDelta":
        return ("delta", norm(value.items), norm(value.deleted), value.revision,
                getattr(value, "full", False))
    if isinstance(value, BaseException):
        return error_view(value)
    if isinstance(value, Twin):
        return ("twin", type(value.jax).__name__)
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return ("instance", type(value).__name__)


def error_view(exc: BaseException) -> tuple:
    attrs = {k: norm(v) for k, v in vars(exc).items() if k not in ("message",)}
    return (type(exc).__name__, getattr(exc, "reason", None), str(exc), attrs)


# -- argument translation ---------------------------------------------------
def to_port(value: Any) -> Any:
    """The port's side's copy of an argument: JAX views as the port's
    views of a copy of their document, containers copied; a plain
    callable (a ``retry`` body, a predicate) is passed as it is."""
    if isinstance(value, Twin):
        return value.port
    if isinstance(value, JaxKubeObject):
        return port_wrap(port_fake.deep_copy_json(value.raw))
    if isinstance(value, dict):
        return {k: to_port(v) for k, v in value.items()}
    if isinstance(value, list):
        return [to_port(v) for v in value]
    if isinstance(value, tuple):
        return tuple(to_port(v) for v in value)
    return value


def to_jax(value: Any) -> Any:
    if isinstance(value, Twin):
        return value.jax
    if isinstance(value, list):
        return [to_jax(v) for v in value]
    if isinstance(value, tuple):
        return tuple(to_jax(v) for v in value)
    return value


class JaxView:
    """The port's object seen through the JAX package's views: what a
    predicate written for the JAX side reads on the port's side."""

    def __init__(self, port_obj: Any) -> None:
        self._port = port_obj

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._port, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            return _as_jax(attr(*args, **kwargs))

        return call


def _as_jax(value: Any) -> Any:
    if isinstance(value, PortKubeObject):
        return jax_fake.wrap(jax_fake.deep_copy_json(value.raw))
    if isinstance(value, list):
        return [_as_jax(v) for v in value]
    return value


def port_error(exc: BaseException) -> BaseException:
    """The port's error of the same class name as a JAX one, else the
    error itself."""
    cls = getattr(port_client, type(exc).__name__, None)
    if isinstance(cls, type) and issubclass(cls, BaseException) and cls is not type(exc):
        return cls(str(exc))
    return exc


# -- the twins ---------------------------------------------------------------
class Twin:
    """A JAX object and its port counterpart, driven call by call."""

    def __init__(self, world: "World", jax_obj: Any, port_obj: Any, label: str) -> None:
        object.__setattr__(self, "_world", world)
        object.__setattr__(self, "jax", jax_obj)
        object.__setattr__(self, "port", port_obj)
        object.__setattr__(self, "_label", label)
        object.__setattr__(self, "_subscribers", {})

    def __getattr__(self, name: str) -> Any:
        jattr = getattr(self.jax, name)
        if not callable(jattr):
            pattr = getattr(self.port, name)
            self._world.check(f"{self._label}.{name}", norm(jattr), norm(pattr))
            return jattr
        handler = getattr(self, "_twin_" + name, None)
        if handler is not None:
            return handler
        return lambda *a, **k: self._world.call(
            f"{self._label}.{name}", getattr(self.jax, name), getattr(self.port, name), a, k)

    def __setattr__(self, name: str, value: Any) -> None:
        # ``monkeypatch.setattr(cluster, "evict", ...)``: both sides get it;
        # its undo hands back one of this twin's own methods, which
        # restores both sides' class methods.
        if callable(value) and getattr(value, "__self__", None) is None and \
                getattr(value, "__qualname__", "").startswith("Twin."):
            value = None
        for side in (self.jax, self.port):
            if value is None and name in vars(side):
                delattr(side, name)
            elif value is not None:
                setattr(side, name, value)

    def __len__(self) -> int:
        return self._world.call(f"{self._label}.__len__", self.jax.__len__,
                                self.port.__len__, (), {})

    # Reactors: the port's side replays the JAX reactor's outcomes.
    def _twin_add_reactor(self, verb: str, kind: str, fn: Callable) -> None:
        outcomes: deque = deque()

        def jax_fn(v, k, payload):
            seen = (v, k, norm(payload))
            try:
                fn(v, k, payload)
            except BaseException as e:
                outcomes.append((seen, e))
                raise
            outcomes.append((seen, None))

        def port_fn(v, k, payload):
            if not outcomes:
                self._world.fail(f"{self._label}: the port ran reactor {verb}/{kind} on "
                                 f"{(v, k)} where the JAX cluster did not")
                return
            seen, exc = outcomes.popleft()
            self._world.check(f"{self._label}.reactor({verb},{kind})", seen,
                              (v, k, norm(payload)))
            if exc is not None:
                raise port_error(exc)

        with self._world.lock:
            self.jax.add_reactor(verb, kind, jax_fn)
            self.port.add_reactor(verb, kind, port_fn)

    # Subscribers: each side's deliveries are recorded and compared.
    def _pair(self, fn: Callable) -> tuple[Callable, Callable]:
        if fn in self._subscribers:
            return self._subscribers[fn][:2]
        jax_seen: list = []
        port_seen: list = []

        def jax_fn(event, data, old=None):
            jax_seen.append((event, norm(data), norm(old)))
            return fn(event, data, old)

        def port_fn(event, data, old=None):
            port_seen.append((event, norm(data), norm(old)))

        self._subscribers[fn] = (jax_fn, port_fn, jax_seen, port_seen)
        return jax_fn, port_fn

    def _twin_subscribe(self, fn: Callable) -> None:
        jax_fn, port_fn = self._pair(fn)
        with self._world.lock:
            self.jax.subscribe(jax_fn)
            self.port.subscribe(port_fn)

    def _twin_subscribe_since(self, fn: Callable, resource_version=None):
        jax_fn, port_fn = self._pair(fn)
        return self._world.call(
            f"{self._label}.subscribe_since", self.jax.subscribe_since,
            self.port.subscribe_since, (jax_fn, resource_version), {},
            port_args=((port_fn, resource_version), {}),
        )

    def _twin_unsubscribe(self, fn: Callable) -> None:
        jax_fn, port_fn = self._pair(fn)
        with self._world.lock:
            self.jax.unsubscribe(jax_fn)
            self.port.unsubscribe(port_fn)

    def _twin_watch(self, *args, **kwargs):
        raise NotImplementedError("the twin cluster does not pair watch streams")

    def _twin_wait_until(self, predicate: Callable, timeout: float) -> bool:
        # Each side waits on its own cache, outside the lock (another
        # thread's twin call may be what it waits for); the predicate
        # reads the JAX views on both.
        jax_ok = self.jax.wait_until(predicate, timeout)
        port_ok = self.port.wait_until(lambda c: predicate(JaxView(c)), timeout)
        self._world.check(f"{self._label}.wait_until", jax_ok, port_ok)
        return jax_ok

    def subscriber_streams(self) -> list[tuple[list, list]]:
        return [(j, p) for _, _, j, p in self._subscribers.values()]


class World:
    """The twins of one case: its lock, its seeded generators, and the
    clusters to compare when it ends."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.failures: list[str] = []
        self.clusters: list[Twin] = []
        self.others: list[Twin] = []
        self._port_callables: dict[int, Callable] = {}

    def fail(self, message: str) -> None:
        self.failures.append(message)

    def check(self, what: str, jax_value: Any, port_value: Any) -> None:
        if jax_value != port_value:
            message = f"{what}: JAX {jax_value!r} != port {port_value!r}"
            self.fail(message)
            raise Mismatch(message)

    def call(self, what: str, jax_fn: Callable, port_fn: Callable, args: tuple,
             kwargs: dict, port_args=None) -> Any:
        with self.lock:
            if port_args is None:
                pargs = tuple(to_port(a) for a in args)
                pkwargs = {k: to_port(v) for k, v in kwargs.items()}
            else:
                pargs, pkwargs = port_args
            jargs = tuple(to_jax(a) for a in args)
            jkwargs = {k: to_jax(v) for k, v in kwargs.items()}
            jres = pres = jexc = pexc = None
            try:
                jres = jax_fn(*jargs, **jkwargs)
            except BaseException as e:  # noqa: BLE001 - compared below
                jexc = e
            try:
                pres = port_fn(*pargs, **pkwargs)
            except BaseException as e:  # noqa: BLE001 - compared below
                pexc = e
            if isinstance(jexc, Mismatch):
                raise jexc
            if isinstance(pexc, Mismatch):
                raise pexc
            if (jexc is None) != (pexc is None):
                self.check(f"{what} raised", error_view(jexc) if jexc else None,
                           error_view(pexc) if pexc else None)
            if jexc is not None:
                self.check(f"{what} error", error_view(jexc), error_view(pexc))
                raise jexc
            if port_args is None:
                self.check(f"{what} arguments after the call",
                           norm([jargs, jkwargs]), norm([pargs, pkwargs]))
            if _is_plain(jres):
                self.check(f"{what} result", norm(jres), norm(pres))
                return jres
            return Twin(self, jres, pres, f"{what}()")

    def verify(self) -> None:
        """The end of a case: every twin cluster's store, journal,
        revision, call log and subscriber streams, side by side."""
        deadline = time.monotonic() + 5.0
        for twin in self.clusters:
            # Work a timer or a server thread still finishes lands first.
            while time.monotonic() < deadline:
                with self.lock:
                    if all(len(j) == len(p) for j, p in twin.subscriber_streams()):
                        break
                time.sleep(0.01)
            with self.lock:
                jax_c, port_c = twin.jax, twin.port
                with jax_c._lock, port_c._lock:
                    self.check(f"{twin._label} store", norm(dict(sorted(jax_c._store.items()))),
                               norm(dict(sorted(port_c._store.items()))))
                    self.check(f"{twin._label} journal", norm(list(jax_c._history)),
                               norm(list(port_c._history)))
                    self.check(f"{twin._label} revision", jax_c.current_resource_version(),
                               port_c.current_resource_version())
                    self.check(f"{twin._label} call log", jax_c._call_log, port_c._call_log)
                for i, (jax_seen, port_seen) in enumerate(twin.subscriber_streams()):
                    self.check(f"{twin._label} subscriber {i}", jax_seen, port_seen)

    def close(self) -> None:
        for twin in self.others:
            for side in (twin.jax, twin.port):
                close = getattr(side, "close", None)
                if callable(close):
                    try:
                        close()
                    except Exception:  # noqa: BLE001 - teardown
                        pass
        for twin in self.clusters:
            twin.jax.close()
            twin.port.close()


def _is_plain(value: Any) -> bool:
    if value is None or isinstance(value, (str, int, float, bool, dict, list, tuple,
                                           set, frozenset, deque, JaxKubeObject)):
        return True
    return type(value).__name__ == "ListDelta"


def _factory(world: World, jax_cls: type, port_cls: type, registry: list) -> Callable:
    def make(*args, **kwargs):
        with world.lock:
            jax_obj = jax_cls(*(to_jax(a) for a in args),
                              **{k: to_jax(v) for k, v in kwargs.items()})
            port_obj = port_cls(*(to_port(a) for a in args),
                                **{k: to_port(v) for k, v in kwargs.items()})
        twin = Twin(world, jax_obj, port_obj, f"{jax_cls.__name__}#{len(registry)}")
        registry.append(twin)
        return twin

    make.__name__ = jax_cls.__name__
    return make


def _function(world: World, jax_fn: Callable, port_fn: Callable) -> Callable:
    def call(*args, **kwargs):
        return world.call(jax_fn.__name__, jax_fn, port_fn, args, kwargs)

    call.__name__ = jax_fn.__name__
    return call


def _twinned(world: World, name: str, value: Any) -> Any:
    """The twin of one JAX name, or None where the name stays the JAX
    package's (its errors, its views, everything outside the cluster)."""
    module = getattr(value, "__module__", None)
    port_mod = PORT_MODULES.get(module or "")
    if port_mod is None:
        return None
    if isinstance(value, type) and issubclass(value, BaseException):
        return None
    port_value = getattr(port_mod, getattr(value, "__name__", name), None)
    assert port_value is not None, f"the port has no {module}.{name}"
    if isinstance(value, type):
        registry = world.clusters if value is jax_fake.FakeCluster else world.others
        return _factory(world, value, port_value, registry)
    if callable(value):
        return _function(world, value, port_value)
    return None


@pytest.fixture
def twin_world(request, monkeypatch):
    """Installs the twins for one JAX case and compares the clusters at
    its end. Use as ``autouse`` in a parity file, with ``JAX_CASES`` the
    JAX test module."""
    jax_module = request.module.JAX_CASES
    world = World()
    seed = random.Random(request.node.nodeid).getrandbits(64)
    for mod in (jax_fake, port_fake):
        monkeypatch.setattr(mod, "_UID_RNG", random.Random(seed))
        token_rng = random.Random(seed + 1)
        monkeypatch.setattr(mod, "uuid", types.SimpleNamespace(
            UUID=uuid.UUID,
            uuid4=lambda rng=token_rng: uuid.UUID(int=rng.getrandbits(128), version=4),
        ))
    for name, value in list(vars(jax_module).items()):
        twin = _twinned(world, name, value)
        if twin is not None:
            monkeypatch.setattr(jax_module, name, twin)
    # Names a case imports inside its body, and the server's own cluster.
    cluster_factory = _twinned(world, "FakeCluster", jax_fake.FakeCluster)
    monkeypatch.setattr(jax_kube, "FakeCluster", cluster_factory)
    monkeypatch.setattr(jax_apiserver, "FakeCluster", cluster_factory)
    cache_factory = _twinned(world, "CachedClient", jax_cache.CachedClient)
    monkeypatch.setattr(jax_kube, "CachedClient", cache_factory)
    monkeypatch.setattr(jax_cache, "CachedClient", cache_factory)
    register = _twinned(world, "register_resource", jax_resources.register_resource)
    monkeypatch.setattr(jax_kube, "register_resource", register)
    monkeypatch.setattr(jax_resources, "register_resource", register)
    yield world
    try:
        if not world.failures:
            world.verify()
    finally:
        world.close()
    assert not world.failures, "\n".join(world.failures)


def adopt_cases(jax_module: types.ModuleType, namespace: dict) -> None:
    """Collect every case of ``jax_module`` again in the parity file
    whose ``globals()`` is ``namespace``: its test classes, its test
    functions and the fixtures they take; ``JAX_CASES`` names the module
    for :func:`twin_world`."""
    namespace["JAX_CASES"] = jax_module
    for name, value in vars(jax_module).items():
        fixture = hasattr(value, "_fixture_function_marker")
        if name.startswith(("Test", "test_")) or fixture:
            assert name not in namespace, f"{name} is already defined here"
            namespace[name] = value
