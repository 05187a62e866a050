#!/usr/bin/env python
"""One traced run of a benchmark cell, with what its result line leaves out.

    cd <checkout> && python <this file> --workload <cell> --seed <n> \\
        --seconds 51 --out chiprun_out/<name>.json

Runs ``graphbench.run.run_cell`` with ``--trace 1`` on the card, in
process, from the checkout in the working directory (its ``graphbench/``
and ``src/``), keeps the spans and the profiled slice the metric readers
get, and adds:

  clock      the clock check: every ``frontier_step_kernel`` must lie
             inside the mapped interval of some ``kernel.eval`` span,
             within 100 us; step kernels outside and the worst overhang,
             once with the recorder's single offset and once with the
             program's ``clock.anchor`` events, and the drift between the
             window's first and last anchor; and each step kernel's start
             less its launch's host time (``lag_us``: min, median, max on
             each mapping), which a sound mapping keeps at or above 0
  spans      spans recorded in the window per completed query
  self_s     each span name's host self time over the window (its spans'
             durations less what their child spans cover), and count
  qps        completed queries over the window's seconds
  named_idle the idle time the breakdown names ``graphbench.serve``,
             ``query`` or ``frontend.serve``, as a share of the window's
             idle time
  appends    the window's ``kernel.eval`` spans' ``landed`` rows and
             ``candidates`` ranked, summed, and their ratio: how sparse
             the evaluator's appends are
  rounds     ``round_ms`` split by the tier of each round's load
             (``scheduler.round``'s ``tier``: cold, prefetch or warm):
             the mean round in ms and the number of rounds of each

It writes the result, with these, to ``--out`` and prints a summary.
Needs a CUDA device; the benchmark's own command does not use it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path.cwd()
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np
import torch

from graphbench import bench, run, spans
from graphbench.tracing import STEP_KERNEL

COARSE = ("graphbench.serve", "query", "frontend.serve")


def self_times(sp: list, t0: float, t1: float) -> dict:
    inside = [s for s in sp if s.t1 is not None and t0 <= s.t0 and s.t1 <= t1]
    kids = {}
    for s in inside:
        kids.setdefault(s.parent_id, []).append(s)
    out = {}
    for s in inside:
        got = out.setdefault(s.name, [0.0, 0])
        got[0] += spans.self_time(s, kids.get(s.span_id, []))
        got[1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def rounds_by_tier(sp: list, t0: float, t1: float) -> dict:
    """The mean ``scheduler.round`` in ms and the count, by the tier of the
    round's load; empty for a program whose rounds carry no ``tier``."""
    got = {}
    for s in sp:
        if s.name == "scheduler.round" and s.t1 is not None and t0 <= s.t0 \
                and s.t1 <= t1 and "tier" in s.attrs:
            g = got.setdefault(s.attrs["tier"], [0.0, 0])
            g[0] += s.t1 - s.t0
            g[1] += 1
    return {k: {"round_ms": 1e3 * v[0] / v[1], "rounds": v[1]} for k, v in sorted(got.items())}


def launch_times() -> list:
    """Record the host time of every frontier step launch from here on."""
    from repro_torch.kernels import ops
    real, times = ops.frontier_step, []

    def timed(*args):
        times.append(time.perf_counter())
        return real(*args)
    ops.frontier_step = timed
    return times


def lags(sl: dict, launched: list, clock) -> Optional[list]:
    """Min, median and max of each step kernel's device start less its
    host launch on ``clock``, in us; None unless the counts pair up."""
    host = [t for t in launched if sl["t0"] <= t <= sl["t1"]]
    dev = sorted(s for name, s, _, _ in sl["events"] if STEP_KERNEL in name)
    if not dev or len(dev) != len(host):
        return None
    lag = np.sort(np.asarray(dev, dtype=np.int64) - clock(np.asarray(host))) / 1e3
    return [float(lag[0]), float(lag[len(lag) // 2]), float(lag[-1])]


def extras(res: dict, ctx: dict, launched: list) -> dict:
    sl, sp, served = ctx["slice"], ctx["spans"], ctx["served"]
    clock = {"offset": spans.step_overhang(sl, sp, spans.offset_clock(sl))}
    clock["offset"]["lag_us"] = lags(sl, launched, spans.offset_clock(sl))
    anchored = spans.anchor_clock(sp)
    clock["anchors"] = spans.step_overhang(sl, sp, anchored) if anchored else None
    if anchored:
        clock["anchors"]["lag_us"] = lags(sl, launched, anchored)
    clock["drift_ns"] = spans.drift_ns(sp, served.t0, served.t1)
    seconds = served.t1 - served.t0
    in_window = sum(1 for s in sp if served.t0 <= s.t0 <= served.t1)
    evals = [s.attrs for s in sp if s.name == "kernel.eval"
             and served.t0 <= s.t0 <= served.t1 and "candidates" in s.attrs]
    landed = sum(a["landed"] for a in evals)
    candidates = sum(a["candidates"] for a in evals)
    out = {"clock": clock, "qps": served.completed / seconds,
           "spans_per_query": in_window / served.completed if served.completed else None,
           "self_s": self_times(sp, served.t0, served.t1),
           "appends": {"landed": landed, "candidates": candidates,
                       "landed_share": landed / candidates if candidates else None},
           "rounds": rounds_by_tier(sp, served.t0, served.t1)}
    dev, gaps = res["device"], res.get("breakdown", {}).get("idle_gaps", [])
    if "busy_s" in dev:
        idle = dev["window_s"] - dev["busy_s"]
        named = sum(v for k, v in gaps if k in COARSE)
        out["named_idle"] = {"seconds": named, "share_of_idle": named / idle}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("graphbench_trace: needs a CUDA device", file=sys.stderr)
        return 3
    b = bench.load_benchmark()
    cell = bench.find_cell(b, args.workload)
    got = {}
    real = bench.metric_reader

    def keeping(name):
        read = real(name)

        def reading(ctx):
            got["ctx"] = ctx
            return read(ctx)
        return reading
    bench.metric_reader = keeping
    device = torch.device("cuda", 0)
    info = run.card_info(device)
    launched = launch_times()
    res = run.run_cell(bench.load_config(cell["config"]), bench.load_traffic(cell["traffic"]),
                       args.seed, args.seconds, True, device, b, args.workload)
    res.update(extras(res, got["ctx"], launched), card=info, workload=args.workload,
               seed=args.seed)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print("trace " + json.dumps({k: res[k] for k in ("workload", "seed", "correct", "qps",
                                                      "spans_per_query", "clock", "metrics",
                                                      "appends", "rounds")}
                                | {"named_idle": res.get("named_idle")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
