"""The port's compact codec and watch framing against the JAX package's.

``k8s_operator_libs_tpu_torch/kube/wire.py`` is the JAX ``kube/wire.py``:
``tests/test_wire_transport.py``'s ``TestCompactCodec`` and
``TestNegotiation`` run here on both modules, and the two must agree
case by case. A seeded corpus of JSON documents (``random.Random(seed)``:
nested maps and lists, ints of every size and sign, floats, unicode
strings, booleans, nulls, repeated keys) is encoded by each package:
the bytes must be identical, and each package must decode the other's,
bodies and watch frames alike, so the port's client and a JAX server (or
the reverse) need no shim.
"""

from __future__ import annotations

import json
import random

import pytest

from k8s_operator_libs_tpu.kube import wire as jax_wire
from k8s_operator_libs_tpu_torch.kube import wire

MODULES = {"jax": jax_wire, "port": wire}

CASES = [
    None, True, False, 0, 1, -1, 7, 2**40, -(2**40), 1.5, -0.25,
    "", "plain", "héllo 世界", [], {}, [1, [2, [3]]],
    {"a": 1, "b": {"a": 2}},
    {"metadata": {"name": "n", "labels": {"app": "x"}},
     "items": [{"metadata": {"name": f"n{i}"}} for i in range(10)]},
]


@pytest.mark.parametrize("pkg", sorted(MODULES))
class TestCompactCodec:
    def test_round_trips(self, pkg):
        w = MODULES[pkg]
        for case in CASES:
            assert w.decode_compact(w.encode_compact(case)) == case

    def test_key_table_compresses_repeated_keys(self, pkg):
        w = MODULES[pkg]
        items = [{"metadata": {"name": f"node-{i}", "labels": {"a": "b"}}} for i in range(64)]
        doc = {"items": items}
        compact = w.encode_compact(doc)
        assert len(compact) < 0.7 * len(json.dumps(doc).encode())
        assert w.decode_compact(compact) == doc

    def test_truncated_payload_raises(self, pkg):
        w = MODULES[pkg]
        with pytest.raises(w.WireDecodeError):
            w.decode_compact(w.encode_compact({"a": [1, 2, 3]})[:-2])

    def test_trailing_bytes_raise(self, pkg):
        w = MODULES[pkg]
        with pytest.raises(w.WireDecodeError):
            w.decode_compact(w.encode_compact({"a": 1}) + b"\x00")

    def test_bad_tag_raises(self, pkg):
        w = MODULES[pkg]
        with pytest.raises(w.WireDecodeError):
            w.decode_compact(b"\xff")

    def test_non_string_keys_rejected(self, pkg):
        w = MODULES[pkg]
        with pytest.raises(TypeError):
            w.encode_compact({1: "x"})


def test_codec_cases_equal_jax_bytes():
    for case in CASES:
        assert wire.encode_compact(case) == jax_wire.encode_compact(case)


def test_decode_errors_name_the_same_fault():
    """Each malformed payload fails in both packages with the same
    message (the port's ``WireDecodeError`` is its own class)."""
    bad = [jax_wire.encode_compact({"a": [1, 2, 3]})[:-2],
           jax_wire.encode_compact({"a": 1}) + b"\x00", b"\xff",
           b"\x07\x01\x01\x05", b"\x03" + b"\xff" * 20]
    for data in bad:
        messages = []
        for w in (jax_wire, wire):
            with pytest.raises(w.WireDecodeError) as raised:
                w.decode_compact(data)
            messages.append(str(raised.value))
        assert messages[1] == messages[0], data


@pytest.mark.parametrize("pkg", sorted(MODULES))
class TestNegotiation:
    def test_compact_only_when_asked(self, pkg):
        w = MODULES[pkg]
        assert w.negotiate_encoding(w.CLIENT_ACCEPT_COMPACT) == "compact"
        assert w.negotiate_encoding(w.COMPACT_CONTENT_TYPE) == "compact"
        assert w.negotiate_encoding("application/json") == "json"
        assert w.negotiate_encoding("") == "json"
        assert w.negotiate_encoding(None) == "json"
        assert w.negotiate_encoding("application/json;as=Table;v=v1;g=meta.k8s.io") == "json"

    def test_frame_decoder_spans_chunk_boundaries(self, pkg):
        w = MODULES[pkg]
        frames = b"".join(
            w.encode_watch_frame({"type": "ADDED", "object": {"i": i}}, "compact")
            for i in range(5)
        )
        decoder = w.FrameDecoder(w.COMPACT_CONTENT_TYPE)
        got = []
        for i in range(0, len(frames), 3):  # drip-fed in 3-byte pieces
            got.extend(e["object"]["i"] for e in decoder.feed(frames[i:i + 3]))
        assert got == [0, 1, 2, 3, 4]
        assert decoder.pending_bytes == 0


def test_content_types_and_constants_equal_jax():
    for name in ("COMPACT_CONTENT_TYPE", "JSON_CONTENT_TYPE", "CLIENT_ACCEPT_COMPACT"):
        assert getattr(wire, name) == getattr(jax_wire, name)
    for encoding in ("json", "compact"):
        assert wire.content_type_for(encoding) == jax_wire.content_type_for(encoding)
    for content_type in (None, "", "application/json", wire.COMPACT_CONTENT_TYPE,
                         " Application/VND.tpu-operator.compact;v=2"):
        assert (wire.is_compact_content_type(content_type)
                == jax_wire.is_compact_content_type(content_type))


# ----------------------------------------------------------------------
# The seeded corpus
# ----------------------------------------------------------------------

KEYS = ["metadata", "name", "namespace", "labels", "annotations", "spec", "status",
        "items", "resourceVersion", "nodeName", "conditions", "type", "reason", "ключ", "键"]


def _value(rng: random.Random, depth: int):
    roll = rng.random()
    if depth <= 0 or roll < 0.45:
        kind = rng.randrange(8)
        if kind == 0:
            return None
        if kind == 1:
            return rng.random() < 0.5
        if kind == 2:
            return rng.randrange(-300, 300)
        if kind == 3:
            return rng.choice([1, -1]) * rng.getrandbits(rng.choice([7, 14, 31, 63, 100]))
        if kind == 4:
            return rng.uniform(-1e6, 1e6)
        if kind == 5:
            return rng.choice([0.0, -0.0, 1e-300, 1.5e300, 0.1])
        if kind == 6:
            return "".join(rng.choice("ab-./:éü世界🙂 \n\"\\") for _ in range(rng.randrange(12)))
        return rng.choice(["", "Ready", "True", "x" * 200])
    if roll < 0.7:
        return [_value(rng, depth - 1) for _ in range(rng.randrange(6))]
    return {rng.choice(KEYS) + ("" if rng.random() < 0.7 else str(rng.randrange(50))):
            _value(rng, depth - 1) for _ in range(rng.randrange(7))}


def corpus(seed: int, n: int = 40) -> list:
    rng = random.Random(seed)
    docs = [_value(rng, 5) for _ in range(n)]
    # A NodeList-shaped document: the repeated keys the key table exists for.
    docs.append({"kind": "NodeList", "metadata": {"resourceVersion": str(seed)},
                 "items": [{"metadata": {"name": f"node-{i}", "labels": {"pool": str(i % 3)}},
                            "spec": {"unschedulable": i % 2 == 0}} for i in range(50)]})
    return docs


@pytest.mark.parametrize("seed", [0, 1, 7, 2026, 31337])
def test_seeded_corpus_is_byte_identical_and_cross_decodes(seed):
    for doc in corpus(seed):
        ours, theirs = wire.encode_compact(doc), jax_wire.encode_compact(doc)
        assert ours == theirs
        assert wire.decode_compact(theirs) == doc == jax_wire.decode_compact(ours)
        for encoding in ("json", "compact"):
            body = wire.encode_body(doc, encoding)
            assert body == jax_wire.encode_body(doc, encoding)
            content_type = wire.content_type_for(encoding)
            assert wire.decode_body(body, content_type) == jax_wire.decode_body(body, content_type)


@pytest.mark.parametrize("encoding", ["json", "compact"])
@pytest.mark.parametrize("seed", [3, 99])
def test_seeded_watch_frames_cross_decode(seed, encoding):
    """Frames written by one package, fed to the other's decoder in
    pieces of random size, come out as the events that were written."""
    rng = random.Random(seed)
    events = [{"type": rng.choice(["ADDED", "MODIFIED", "DELETED", "BOOKMARK"]),
               "object": {"kind": "Node", "metadata": {"name": f"n{i}"}, "x": doc}}
              for i, doc in enumerate(corpus(seed, n=15))]
    content_type = wire.content_type_for(encoding)
    for writer, reader in ((jax_wire, wire), (wire, jax_wire)):
        stream = b"".join(writer.encode_watch_frame(e, encoding) for e in events)
        assert stream == b"".join(reader.encode_watch_frame(e, encoding) for e in events)
        decoder = reader.FrameDecoder(content_type)
        got, pos = [], 0
        while pos < len(stream):
            step = rng.randrange(1, 64)
            got.extend(decoder.feed(stream[pos:pos + step]))
            pos += step
        assert got == json.loads(json.dumps(events)) and decoder.pending_bytes == 0
