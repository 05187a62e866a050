"""Exporters: Chrome trace-event JSON, Prometheus text, report snapshot.

Three consumers, three formats, one source of truth (a ``Tracer`` and a
``MetricsRegistry``):

  Chrome trace-event JSON — load the file in Perfetto / chrome://tracing.
      Spans become "X" (complete) events laid out in one *lane* (tid) per
      subsystem — queries, scheduler rounds, store loads, kernel eval — so
      a query's decomposition reads top to bottom.  Decision records
      become "i" (instant) events carrying their full payload in
      ``args``; span and parent ids ride in ``args`` too, so
      ``tools/trace_report.py`` can rebuild the tree exactly.

  Prometheus text exposition — ``# HELP``/``# TYPE`` + samples,
      histograms with cumulative ``le`` buckets, written to a file for
      scrape-less collection (``launch/serve.py --metrics-out``).

  observability snapshot — the JSON-safe dict ``launch/serve.py`` merges
      into its report under ``"observability"`` (metrics snapshot, span
      totals and decision counts).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry
from .trace import Tracer

# span-name prefix → Chrome lane (tid).  Order = top-to-bottom layout.
LANES = (
    ("query", "queries"),
    ("frontend.", "frontend admission"),
    ("scheduler.", "scheduler rounds"),
    ("opat.", "scheduler rounds"),
    ("engine.", "scheduler rounds"),
    ("store.", "store loads"),
    ("kernel.", "kernel eval"),
    ("deltas.", "compaction"),
)
_LANE_ORDER = ["queries", "frontend admission", "scheduler rounds",
               "store loads", "kernel eval", "compaction", "other"]


def _lane(name: str) -> str:
    for prefix, lane in LANES:
        if name == prefix or name.startswith(prefix):
            return lane
    return "other"


def _decision_lane(kind: str) -> str:
    return "frontend admission" if kind.startswith("frontend.") \
        else "scheduler rounds"


def _json_safe(v: Any) -> Any:
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (str, int, bool, float)) or v is None:
        return v
    if hasattr(v, "item"):           # numpy / torch scalars
        try:
            return _json_safe(v.item())
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(v)


def to_chrome_trace(tracer: Tracer, pid: int = 1) -> Dict[str, Any]:
    """Render a tracer's spans + decisions as a Chrome trace-event object
    (``{"traceEvents": [...]}``) loadable in Perfetto.  Timestamps are
    microseconds relative to the tracer's epoch."""
    epoch = tracer.t_epoch
    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}

    def tid_for(lane: str) -> int:
        if lane not in tids:
            try:
                tids[lane] = _LANE_ORDER.index(lane) + 1
            except ValueError:
                tids[lane] = len(_LANE_ORDER) + len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[lane], "args": {"name": lane}})
            events.append({"ph": "M", "name": "thread_sort_index",
                           "pid": pid, "tid": tids[lane],
                           "args": {"sort_index": tids[lane]}})
        return tids[lane]

    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "tid": 0, "args": {"name": "repro_torch serve"}})

    for sp in tracer.spans:
        t1 = sp.t1 if sp.t1 is not None else sp.t0
        args = {"span_id": sp.span_id, "parent_id": sp.parent_id,
                "thread": sp.thread}
        args.update(_json_safe(sp.attrs))
        events.append({
            "ph": "X", "name": sp.name, "cat": _lane(sp.name),
            "pid": pid, "tid": tid_for(_lane(sp.name)),
            "ts": round((sp.t0 - epoch) * 1e6, 3),
            "dur": round(max(t1 - sp.t0, 0.0) * 1e6, 3),
            "args": args,
        })

    for rec in tracer.decisions:
        kind = rec.get("kind", "decision")
        args = _json_safe({k: v for k, v in rec.items()
                           if k not in ("kind", "ts")})
        events.append({
            "ph": "i", "name": kind, "cat": "decision", "s": "t",
            "pid": pid, "tid": tid_for(_decision_lane(kind)),
            "ts": round((rec["ts"] - epoch) * 1e6, 3),
            "args": args,
        })

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f)


def to_prometheus_text(reg: MetricsRegistry) -> str:
    """Prometheus text exposition (0.0.4): HELP/TYPE headers once per
    metric name, histograms with cumulative ``le`` buckets + +Inf."""
    lines: List[str] = []
    seen_header: set = set()

    def fmt_labels(labels: Dict[str, str], extra: Optional[Dict] = None
                   ) -> str:
        items = dict(labels)
        if extra:
            items.update(extra)
        if not items:
            return ""
        body = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
        return "{" + body + "}"

    def fmt_val(v: float) -> str:
        return str(int(v)) if float(v).is_integer() else repr(float(v))

    for m, labels in reg.collect():
        if m.name not in seen_header:
            seen_header.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind == "histogram":
            acc = 0
            for b, c in zip(m.buckets, m.counts):
                acc += c
                lines.append(
                    f"{m.name}_bucket"
                    f"{fmt_labels(labels, {'le': fmt_val(b)})} {acc}")
            lines.append(
                f"{m.name}_bucket{fmt_labels(labels, {'le': '+Inf'})} "
                f"{m.count}")
            lines.append(f"{m.name}_sum{fmt_labels(labels)} "
                         f"{fmt_val(m.sum)}")
            lines.append(f"{m.name}_count{fmt_labels(labels)} {m.count}")
        else:
            lines.append(f"{m.name}{fmt_labels(labels)} "
                         f"{fmt_val(m.value)}")
    return "\n".join(lines) + "\n"


def write_prometheus(reg: MetricsRegistry, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_prometheus_text(reg))


def observability_snapshot(tracer: Optional[Tracer] = None,
                           registry: Optional[MetricsRegistry] = None
                           ) -> Dict[str, Any]:
    """The ``"observability"`` block of serve's JSON report: always
    present (schema_version 2), with ``enabled`` telling a parser
    whether span data exists or only ingested metrics."""
    enabled = bool(tracer is not None and tracer.enabled)
    block: Dict[str, Any] = {"enabled": enabled}
    if registry is not None:
        block["metrics"] = registry.snapshot()
    if enabled:
        decisions: Dict[str, int] = {}
        for rec in tracer.decisions:
            k = rec.get("kind", "decision")
            decisions[k] = decisions.get(k, 0) + 1
        block["spans"] = {
            name: {"count": int(agg["count"]),
                   "total_s": round(agg["total_s"], 6)}
            for name, agg in sorted(tracer.span_totals().items())}
        block["decisions"] = decisions
    return block
