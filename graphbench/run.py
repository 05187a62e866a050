"""Run one cell of ``BENCHMARK.json`` once.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: make the graph and the requests from the
seed, build the port's session on the card and warm it up (``setup_s``),
serve the window, then judge every request due in it against the plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; the numbers compared come last,
under ``checks``, and again as the last lines of standard error.  The
line before it (``setup {...}``) splits set-up into its stages, with the
host's peak RSS and the card's name and power limit.

A tool that the benchmark's own runs do not use:

    --control 1       put the control (``graphbench.check``) in the
                      program's place over the same requests; it has to
                      come out not correct (needs no card)

With no card, or fewer cards than the cell asks for, it prints no
result and exits non-zero.  So it does when ``sys.modules`` holds JAX,
the JAX package, its CPU benchmark or the card smoke script just before
the result line: after the window, the reference and every metric
reader have run.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from graphbench import bench, check, datasets, serve, traffic, tracing  # noqa: E402


def card_info(device: torch.device) -> dict:
    info = {"kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    smi = shutil.which("nvidia-smi")
    if device.type == "cuda" and smi:
        try:
            got = subprocess.run(
                [smi, "-i", str(device.index or 0), "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
            info["nvidia_smi"] = got.stdout.strip()
        except (OSError, subprocess.SubprocessError) as exc:
            info["nvidia_smi"] = f"unavailable: {exc}"
    return info


def percentile(vals, q: float) -> float:
    return float(np.percentile(np.asarray(vals, dtype=np.float64), q))


def end_to_end(served: serve.Served, setup_s: float, peak: int) -> dict:
    lat = served.latencies()
    values = {"setup_s": setup_s, "peak_device_gib": peak / 2 ** 30}
    if lat:
        values["query_p50_s"] = percentile(lat, 50)
        values["query_p95_s"] = percentile(lat, 95)
    wall = served.t1 - served.t0
    if wall > 0 and served.completed:
        values["queries_per_s"] = served.completed / wall
    return values


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, bench_json: dict, cell: str) -> dict:
    """One run; returns the result dict (and prints the set-up line)."""
    times = {}
    gen = datasets.generator(cfg["generator"])
    t = time.perf_counter()
    g = gen.make(cfg, seed)
    times["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    graph = serve.port_graph(g)
    times["graph_s"] = time.perf_counter() - t
    tracer = None
    if trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    if device.type == "cuda":
        torch.cuda.init()   # the allocator's statistics exist once CUDA is up
        torch.cuda.reset_peak_memory_stats(device)
    session = serve.build_session(cfg, graph, device, tracer=tracer, times=times)
    t = time.perf_counter()
    front = serve.Frontend(session, cfg, float(mix["replay_speed"]))
    times["frontend_s"] = time.perf_counter() - t
    t = time.perf_counter()
    front.serve(traffic.warmup_requests(mix, cfg, gen, g, seed), serve.Served())
    serve.sync(device)
    times["warmup_s"] = time.perf_counter() - t

    if mix["arrivals"] == "batch":
        feed = traffic.batches(mix, cfg, gen, g, seed)
        reqs, make_batch = None, lambda: next(feed)
    else:
        reqs, make_batch = traffic.poisson_requests(mix, cfg, gen, g, seed, seconds), None
    setup_s = time.perf_counter() - T_START
    recorder = tracing.WindowRecorder(device) if trace else None
    if recorder is not None:
        recorder.start()
    try:
        served = serve.window(front, mix, make_batch, reqs, seconds)
    finally:
        if recorder is not None:
            recorder.stop()
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    spans = tracer.spans if tracer is not None else []
    times["setup_s"] = setup_s
    times["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print("setup " + json.dumps(times), flush=True)

    # the program's state goes before the reference runs
    del front, session, graph
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    counts = check.judge(check.Judge(check.Matcher(g)), served.requests, served.answers)
    ref_s = time.perf_counter() - t

    result = {"correct": check.passed(counts), "attempted": len(served.requests),
              "failed": check.failed(counts)}
    if trace:
        ctx = {"served": served, "spans": spans, "slice": recorder.result, "cfg": cfg}
        metrics = {}
        for m in bench.cell_metrics(bench_json, cell, "per_layer"):
            v = bench.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = end_to_end(served, setup_s, peak)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in bench.cell_metrics(bench_json, cell, "end_to_end")
                   if m["name"] in values}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        sl = recorder.result
        busy = tracing.busy_s(sl)
        if busy is not None:
            dev["busy_s"] = busy
            dev["window_s"] = sl["t1"] - sl["t0"]
        got = tracing.breakdown(sl, spans)
        if got is not None:
            result["breakdown"] = got
    result["device"] = dev
    calls = sorted(served.calls)
    result["window"] = {"seconds": served.t1 - served.t0, "completed": served.completed,
                        "calls": len(calls), "call_s_min_median_max":
                        [calls[0], calls[len(calls) // 2], calls[-1]] if calls else None,
                        "reference_s": ref_s}
    result["checks"] = check.verdict(counts)
    return result


def control(cfg: dict, mix: dict, seed: int, seconds: float, batches: int) -> dict:
    """The control in the program's place over a run's requests."""
    gen = datasets.generator(cfg["generator"])
    g = gen.make(cfg, seed)
    if mix["arrivals"] == "batch":
        feed = traffic.batches(mix, cfg, gen, g, seed)
        reqs = [r for _ in range(batches) for r in next(feed)]
    else:
        reqs = traffic.poisson_requests(mix, cfg, gen, g, seed, seconds)
    ctl = check.Judge(check.control_matcher(g, cfg["control"], seed))
    counts = check.judge(check.Judge(check.Matcher(g)), reqs,
                         check.control_answers(ctl, reqs))
    return {"control": cfg["control"]["kind"], "correct": check.passed(counts),
            "attempted": len(reqs), "failed": check.failed(counts),
            "checks": check.verdict(counts)}


def emit(res: dict) -> int:
    """Print the result, unless something forbidden has been loaded in
    this process by then; the exit code."""
    bad = bench.loaded_forbidden()
    if bad:
        print(f"graphbench: modules loaded in the run's process: {bad}", file=sys.stderr)
        return 4
    for name, c in res["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control-batches", type=int, default=10)
    args = ap.parse_args(argv)
    try:
        bench_json = bench.load_benchmark()
        cell = bench.find_cell(bench_json, args.workload)
        cfg = bench.load_config(cell["config"])
        mix = bench.load_traffic(cell["traffic"])
    except (OSError, KeyError, ValueError, TypeError) as exc:
        print(f"graphbench: {exc}", file=sys.stderr)
        return 2
    if args.control:
        return emit(control(cfg, mix, args.seed, args.seconds, args.control_batches))
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"graphbench: the cell needs {cell['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    print("card " + json.dumps(card_info(device)), flush=True)
    return emit(run_cell(cfg, mix, args.seed, args.seconds, bool(args.trace), device,
                         bench_json, args.workload))


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
