"""Per-roll flight recorder over a trace JSONL export.

The counterpart of the JAX repository's ``tools/trace_view.py`` (a tool
beside the JAX package, not a module of it), copied so the port reads
its own exports without it. It reads the spans that
``utils/tracing.py``'s ``Tracer.export_jsonl`` writes (``chip_smoke.py``'s
traced phases write one each) and answers what the metric families
cannot:

* **where the roll's wall time went**: a deepest-active-span sweep
  attributes every instant of the trace window to one category (grant /
  lease / reconcile / wire / queue / drain / checkpoint / probe / write),
  ``idle`` when no span covers it, ``other`` for a span outside the
  taxonomy; rendered as a table and a text waterfall of the longest spans;
* **what happened to one node**: ``--node NAME`` gives every
  ``state.transition`` event of the node with its time, the bucket span
  that caused it, that bucket's pass, and the pass's links to the writes
  that woke it.

``--assert-coverage F`` exits nonzero unless at least the fraction ``F``
of the window's wall time is covered by spans (idle does not count)::

    python -m k8s_operator_libs_tpu_torch.tools.trace_view trace.jsonl --assert-coverage 0.9
    python -m k8s_operator_libs_tpu_torch.tools.trace_view trace.jsonl --node gpu-inf-0
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Iterable, Optional

#: The attribution taxonomy (``utils.tracing.CATEGORIES``, kept literal so
#: the tool reads an export from either package).
KNOWN_CATEGORIES = (
    "grant", "lease", "reconcile", "wire", "queue", "drain",
    "checkpoint", "probe", "write",
)


def load_spans(path: str) -> list[dict[str, Any]]:
    spans = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                spans.append(json.loads(line))
    return spans


def _window(
    spans: list[dict], start: Optional[float], end: Optional[float]
) -> tuple[float, float]:
    if not spans:
        return (0.0, 0.0)
    lo = min(s["start"] for s in spans) if start is None else start
    hi = max(s["end"] for s in spans) if end is None else end
    return (lo, max(lo, hi))


def _depths(spans: list[dict]) -> dict[str, int]:
    """Span id -> nesting depth (parent-chain length). Deeper = more
    specific; the sweep attributes each instant to the deepest active
    span, so a queue wait inside a server request inside a pass reads as
    queue time, not reconcile time."""
    by_id = {s["span"]: s for s in spans}
    depths: dict[str, int] = {}

    def depth(span_id: str, seen: frozenset = frozenset()) -> int:
        if span_id in depths:
            return depths[span_id]
        span = by_id.get(span_id)
        if span is None or span_id in seen:
            return 0
        parent = span.get("parent") or ""
        d = 1 + depth(parent, seen | {span_id}) if parent in by_id else 1
        depths[span_id] = d
        return d

    for s in spans:
        depth(s["span"])
    return depths


def attribution(
    spans: list[dict],
    start: Optional[float] = None,
    end: Optional[float] = None,
) -> dict[str, Any]:
    """Attribute the trace window's wall time.

    Sweep over elementary intervals between span boundaries: each
    instant belongs to the DEEPEST span active then (ties: the later-
    starting one); its category buckets the time. ``idle`` = no span
    active; ``other`` = deepest span's category outside the taxonomy.
    ``coverage`` is the fraction of wall covered by ANY span — idle is
    attributed but deliberately does not count toward coverage, so the
    --assert-coverage gate fails when instrumentation loses the roll.
    """
    import heapq

    lo, hi = _window(spans, start, end)
    wall = hi - lo
    out: dict[str, Any] = {
        "wall_s": round(wall, 6),
        "window": [round(lo, 6), round(hi, 6)],
        "spans": len(spans),
        "categories": {},
        "coverage": 0.0,
        "idle_s": round(wall, 6),
    }
    if wall <= 0 or not spans:
        return out
    depths = _depths(spans)
    # Event sweep, O(S log S): +1/-1 boundaries; the active set's
    # deepest span is tracked through a max-heap with lazy deletion.
    events: list[tuple[float, int, int]] = []
    meta: list[tuple[int, float, str]] = []  # (depth, start, category)
    for s in spans:
        s_lo, s_hi = max(s["start"], lo), min(s["end"], hi)
        if s_hi <= s_lo:
            continue  # zero-width or outside the window: no wall time
        category = s.get("category") or "other"
        if category not in KNOWN_CATEGORIES:
            category = "other"
        index = len(meta)
        meta.append((depths[s["span"]], s_lo, category))
        events.append((s_lo, 1, index))
        events.append((s_hi, 0, index))
    events.sort(key=lambda e: (e[0], e[1]))
    by_category: dict[str, float] = {}
    covered = 0.0
    active: set[int] = set()
    heap: list[tuple[float, float, int]] = []
    prev = lo
    events.append((hi, 2, -1))  # sentinel closes the window
    for t, kind, index in events:
        t = min(max(t, lo), hi)
        if t > prev:
            width = t - prev
            while heap and heap[0][2] not in active:
                heapq.heappop(heap)
            if heap:
                covered += width
                category = meta[heap[0][2]][2]
            else:
                category = "idle"
            by_category[category] = by_category.get(category, 0.0) + width
            prev = t
        if kind == 1:
            active.add(index)
            depth, s_lo, _ = meta[index]
            # Negated keys: heap[0] = deepest, later-starting span.
            heapq.heappush(heap, (-depth, -s_lo, index))
        elif kind == 0:
            active.discard(index)
    out["categories"] = {
        k: round(v, 6) for k, v in sorted(
            by_category.items(), key=lambda item: -item[1]
        )
    }
    out["coverage"] = round(covered / wall, 6)
    out["idle_s"] = round(by_category.get("idle", 0.0), 6)
    return out


def node_journey(spans: list[dict], node: str) -> list[dict[str, Any]]:
    """One node's flight-recorder timeline: every ``state.transition``
    event naming the node, each with its causal chain — the bucket span
    it rode, that bucket's pass span (pass seq + worker), and the
    pass's links back to the writes that woke it."""
    by_id = {s["span"]: s for s in spans}
    journey = []
    for s in spans:
        for event in s.get("events", []):
            if event.get("name") != "state.transition":
                continue
            attrs = event.get("attrs", {})
            if attrs.get("node") != node:
                continue
            pass_span = s
            while pass_span is not None and pass_span["name"] != (
                "reconcile.pass"
            ):
                pass_span = by_id.get(pass_span.get("parent") or "")
            journey.append({
                "ts": event["ts"],
                "from": attrs.get("frm", ""),
                "to": attrs.get("to", ""),
                "cause": attrs.get("cause", s["name"]),
                "span": s["span"],
                "parent": s.get("parent", ""),
                "pass": (pass_span or {}).get("attrs", {}).get("pass"),
                "worker": (pass_span or {}).get("attrs", {}).get("worker"),
                "woken_by": list((pass_span or {}).get("links", [])),
            })
    journey.sort(key=lambda e: e["ts"])
    return journey


def render_waterfall(
    spans: list[dict], limit: int = 40, width: int = 60
) -> str:
    """Text waterfall of the longest spans across the trace window."""
    lo, hi = _window(spans, None, None)
    wall = max(hi - lo, 1e-9)
    longest = sorted(
        spans, key=lambda s: s["end"] - s["start"], reverse=True
    )[:limit]
    longest.sort(key=lambda s: s["start"])
    lines = [f"window {lo:.3f} .. {hi:.3f} ({wall:.3f}s), "
             f"{len(spans)} spans; longest {len(longest)}:"]
    for s in longest:
        left = int((s["start"] - lo) / wall * width)
        bar = max(1, int((s["end"] - s["start"]) / wall * width))
        label = f"{s['name']} [{s.get('category') or '-'}]"
        duration = s["end"] - s["start"]
        lines.append(
            f"  {' ' * left}{'█' * min(bar, width - left)} "
            f"{label} {duration * 1000:.1f}ms"
        )
    return "\n".join(lines)


def render_journey(node: str, journey: Iterable[dict]) -> str:
    lines = [f"flight recorder: node {node}"]
    for leg in journey:
        woken = (
            f" woken_by={','.join(leg['woken_by'])}"
            if leg.get("woken_by") else ""
        )
        worker = f" worker={leg['worker']}" if leg.get("worker") else ""
        lines.append(
            f"  {leg['ts']:.3f}  {leg['from'] or '<none>'} -> "
            f"{leg['to'] or '<none>'}  cause={leg['cause']} "
            f"pass={leg['pass']}{worker}{woken}"
        )
    if len(lines) == 1:
        lines.append("  (no state transitions recorded)")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0]
    )
    parser.add_argument("trace", help="trace JSONL file (utils/tracing.py export)")
    parser.add_argument("--node", default="",
                        help="render one node's flight-recorder timeline")
    parser.add_argument("--assert-coverage", type=float, default=None,
                        metavar="F",
                        help="exit 1 unless span coverage of the trace "
                             "window is >= F (0..1)")
    parser.add_argument("--json", action="store_true",
                        help="emit the attribution (and journey) as JSON")
    parser.add_argument("--waterfall", type=int, default=25,
                        help="how many of the longest spans to draw (0=off)")
    args = parser.parse_args(argv)

    spans = load_spans(args.trace)
    result = attribution(spans)
    if args.node:
        journey = node_journey(spans, args.node)
        if args.json:
            print(json.dumps({"attribution": result, "node": args.node,
                              "journey": journey}, sort_keys=True))
        else:
            print(render_journey(args.node, journey))
        # Deliberate fall-through: --assert-coverage composes with
        # --node (adding journey context must not disable the gate).
    elif args.json:
        print(json.dumps(result, sort_keys=True))
    else:
        wall = result["wall_s"] or 1.0
        print(f"trace: {args.trace} — {result['spans']} spans over "
              f"{result['wall_s']:.3f}s, coverage "
              f"{result['coverage'] * 100:.1f}%")
        for category, seconds in result["categories"].items():
            print(f"  {category:<12} {seconds:>10.3f}s "
                  f"{seconds / wall * 100:>5.1f}%")
        if args.waterfall and spans:
            print(render_waterfall(spans, limit=args.waterfall))
    if args.assert_coverage is not None:
        if result["coverage"] < args.assert_coverage:
            print(
                f"FAIL: coverage {result['coverage']:.3f} < "
                f"{args.assert_coverage} — the instrumentation lost "
                f"{(1 - result['coverage']) * 100:.1f}% of the window",
                file=sys.stderr,
            )
            return 1
        print(f"coverage {result['coverage']:.3f} >= "
              f"{args.assert_coverage}: OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        # `... | head` closed the pipe: normal CLI usage, not an error.
        raise SystemExit(0)
