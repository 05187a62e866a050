#!/usr/bin/env python
"""What is live on the card at the peak of one benchmark run.

    cd <checkout> && python <this file> --workload <cell> --seed <n> \\
        --seconds 10 --out chiprun_out/<name>.json

Runs ``graphbench.run.run_cell`` untraced on the card, in process, from
the checkout in the working directory (its ``graphbench/`` and ``src/``),
with the CUDA caching allocator's history on (Python stacks).  With
``--drain`` each batch goes through ``GraphSession.submit_many`` instead
of the front end: one scheduler run drains the batch over several load
rounds, where the front end pumps one round a run.  Then it
replays the history: each ``alloc`` adds its block, each
``free_requested`` takes it away (the allocator's ``allocated_bytes``
falls there, so the replay's peak is ``max_memory_allocated``'s), and at
the replay's peak it groups the live blocks by the first frames of the
port or the benchmark that allocated them.  It writes, and prints:

  peak_bytes        ``torch.cuda.max_memory_allocated()`` over the run
  replay_peak       the replay's peak (equal to it unless the history
                    dropped entries) and the event it fell at
  partition_bytes   each partition's bundle (``PartitionStore.host_nbytes``)
  at_peak           the live bytes at the peak by allocating site, largest
                    first, with the number of blocks
  blocks            the live blocks of at least 256 MiB at the peak

Needs a CUDA device; the benchmark's own command does not use it.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np
import torch

from graphbench import bench, run, serve

BIG = 256 * 2 ** 20


def site(entry: dict) -> str:
    """The first three frames of the port or the benchmark on a block's
    allocating stack."""
    mine = [f for f in entry.get("frames") or []
            if "repro_torch" in f["filename"] or "graphbench" in f["filename"]]
    return " <- ".join(f"{Path(f['filename']).name}:{f['line']}:{f['name']}" for f in mine[:3])


def replay(trace: list) -> dict:
    """The live blocks at the trace's peak of allocated bytes."""
    cur = best = 0
    best_i = -1
    sizes = {}
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            sizes[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > best:
                best, best_i = cur, i
        elif e["action"] == "free_requested" and e["addr"] in sizes:
            cur -= sizes.pop(e["addr"])
    live = {}
    for e in trace[:best_i + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    by = collections.defaultdict(lambda: [0, 0])
    for e in live.values():
        got = by[site(e)]
        got[0] += e["size"]
        got[1] += 1
    return {"replay_peak": best, "peak_event": best_i, "events": len(trace),
            "peak_site": site(trace[best_i]) if best_i >= 0 else None,
            "at_peak": sorted(([k, v[0], v[1]] for k, v in by.items()), key=lambda x: -x[1]),
            "blocks": sorted(([e["size"], site(e)] for e in live.values() if e["size"] >= BIG),
                             key=lambda x: -x[0])}


def drain(heuristic: str):
    """``serve.Frontend.serve`` through ``GraphSession.submit_many``: the
    batch's requests as one scheduler run, stamped done when it returns."""
    from repro_torch.core.query import DisjunctiveQuery

    def serve_batch(self, reqs, out):
        t0 = time.perf_counter()
        rep = self.session.submit_many(
            [DisjunctiveQuery.from_json_dict(r["query"]) for r in reqs],
            max_answers=[r["max_answers"] for r in reqs], heuristic=heuristic)
        t1 = time.perf_counter()
        out.calls.append(t1 - t0)
        for r, res in zip(reqs, rep.results):
            out.requests.append(r)
            out.due.append(t0)
            out.finished.append(t1)
            out.answers.append(np.asarray(res.answers))
    return serve_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--max-entries", type=int, default=4_000_000)
    ap.add_argument("--drain", action="store_true",
                    help="serve each batch through GraphSession.submit_many")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("alloc_peak: needs a CUDA device", file=sys.stderr)
        return 3
    b = bench.load_benchmark()
    cell = bench.find_cell(b, args.workload)
    device = torch.device("cuda", 0)
    parts = {}
    real = serve.build_session

    def build(*a, **kw):
        session = real(*a, **kw)
        parts["bytes"] = [session.store.host_nbytes(p) for p in range(session.pg.k)]
        return session
    serve.build_session = build
    cfg = bench.load_config(cell["config"])
    if args.drain:
        serve.Frontend.serve = drain(cfg["shared_heuristic"])
    torch.cuda.init()
    torch.cuda.memory._record_memory_history(max_entries=args.max_entries, stacks="python")
    res = run.run_cell(cfg, bench.load_traffic(cell["traffic"]), args.seed, args.seconds,
                       False, device, b, args.workload)
    trace = torch.cuda.memory._snapshot()["device_traces"][device.index]
    torch.cuda.memory._record_memory_history(enabled=None)
    out = {"workload": args.workload, "seed": args.seed, "drain": args.drain,
           "card": run.card_info(device),
           "correct": res["correct"], "completed": res["window"]["completed"],
           "peak_bytes": res["device"]["memory_peak_bytes"],
           "partition_bytes": parts.get("bytes"), **replay(trace)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print("alloc_peak " + json.dumps({k: v for k, v in out.items() if k != "at_peak"}
                                     | {"at_peak": out["at_peak"][:8]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
