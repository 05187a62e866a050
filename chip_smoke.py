#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py [--scale 200] [--seed 0]

Phases, each printing one JSON line:

  device       the card's name, power limit and top SM clock (nvidia-smi)
               and SM count, beside the resource profiler's roofline
               peaks; no card -> exit 2
  build        nvcc builds every kernel under src/repro_torch/kernels/csrc
               (one process per source, all at once), with ptxas registers
               and spills
  graph        the main path's graph and its partitions, built once: the
               synthetic graph at the paper's size (``--scale 200``:
               440,000 nodes, 1,240,000 edges), k=4, kway_shem
  kernels      each kernel against its plain PyTorch version on the card
               (bit-equal), on the test sweep, an empty frontier, NaN values
               and the main path's shapes (the frontier step at one lane, at
               two lanes over stacked partitions, and at MapReduceMP's four
               lanes over the path's work-buffer length; frontier_expand at W on
               each side of a warp; label_histogram on misaligned views,
               n % 4 tails, two streams at once and a replayed CUDA graph);
               each timed three ways (CUDA-graph replay, per call through
               the wrapper, the plain version) beside its byte bound and the
               card's launch floor, the step's device time over 256
               selections of distinct table rows; then the evaluator's
               append kernel bit-equal to its plain version and timed the
               same three ways beside its bytes, at the shared scheduler's
               32 lanes of 512 x 20 and of 512 x 5,140 (IMDB's width), with
               mixed and with sparse flags
  small        a small graph served on the card and on the CPU (plain
               versions): identical answers, loads and iterations for OPAT
               and TraditionalMP submits and for submit_many on both; for
               MapReduceMP identical answers, iterations and yield
               counters, exhaustive, under K=5 and gated to m_limit=2
               under MAX-YIELD
  path         the main path: one in-RAM GraphSession with the OPAT engine,
               the three subgen queries and Q4 again under an answer budget,
               each checked against the whole-graph oracle; fused_frontier
               launches must equal the evaluator's summed iterations, and
               frontier_append launches those plus the evaluator calls
               (a pre-classify a call)
  sni          the SNI seed and the match on the path's own data:
               label_histogram on every partition for every query's start
               predicate equals PartitionedGraph.start_label_counts, and
               frontier_expand on real partition tables and a real binding
               batch equals the fused kernel's ok/dg
  traditional  GraphSession(engine="traditional", processors=2) on the same
               queries, checked against the oracle answers of the path
               phase; launches equal the lane evaluator's loop count, and
               frontier_append launches the loops plus the calls
  shared       submit_many of the same queries on the OPAT and the
               TraditionalMP session: answers equal the per-query results;
               loads per query against the isolated total; launches equal
               the batched loop count, frontier_append launches the loops
               plus the calls
  mapreduce    GraphSession(engine="mapreduce") on the path's graph (one
               lane per partition): the same queries and Q4 again warm,
               checked against the oracle answers of the path phase;
               fused_frontier launches equal the summed iterations (one
               launch a iteration for all four lanes) and no
               frontier_append runs (its appends are its own); each lane's FAA
               fill against cap; Q5 gated to m_limit=2 under MAX-YIELD;
               submit_many of the four queries (the sequential drain)
               equal to the per-query results
  mesh         MapReduceMP on multi-shard part meshes of the same graph:
               four one-mapper shards on cuda:0, two shards of two on
               cuda:0, and the mappers spread over distinct cards when
               there are two or more (``meshes_run`` names those that
               ran); each serves the path's runs and the gated Q5 on a
               fresh session, equal to the mapreduce phase's one-shard
               session on answers, iterations, yield counters and loads,
               and to the oracle; fused_frontier launches equal iterations
               x shards; warm Q5 on the mesh and on one shard in turns
               (median of 5), the shuffle's bytes per iteration between
               shards and between cards, peak memory per device and
               whether each pair of cards has peer access
  cli          ``python -m repro_torch.launch.serve`` in-process at
               ``--scale 20`` with ``--verify``, for the mapreduce and opat
               engines (opat with ``--metrics-out`` and ``--trace-out``:
               both files written, the Prometheus file parses,
               ``tools/trace_report.py --check`` accepts the trace); then
               opat with ``--save-graph`` and ``--profile-json``,
               ``--graph-dir`` with ``--host-cache-parts 1`` on opat and
               mapreduce, and ``--repartition-from``: every query MATCH,
               return code 0
  profile      Q5 on the OPAT, TraditionalMP and MapReduceMP sessions: 12
               rounds of warm runs on the host clock, rotating which engine
               goes first (each latency's spread, the rounds each engine
               beat OPAT, evaluator loops per query), then one run each
               under torch.profiler: device busy/idle share, device time by
               kernel name, host time by op, host kernel launches per
               evaluator loop; and the peak device memory of an
               unprofiled warm run (every session's resident data in it)
  metrics      resource profiling and the metrics registry on the path's
               graph: profiled OPAT, TraditionalMP and MapReduceMP sessions
               (one Tracer) serve the path's runs and submit_many, with the
               answers, loads and iterations of the unprofiled runs above;
               every kernel.eval span carries its kernel key, predicted
               cost, step launches and the store's live bytes, and no
               cost_error; the span launches sum to the step's launches;
               ``tools/trace_report.py --check`` accepts the trace and its
               ``--cost`` table is printed; each session's peak device
               bytes within ``torch.cuda.max_memory_allocated``; each
               session's Prometheus file parses; warm Q5 with profiling on
               against off, 12 rounds in turns
  ooc          out of core at full scale: the path's session saved as a
               graph directory; one cold partition load split into disk
               read, checksum, pin and host-to-device copy; a host tier of
               one partition evicting a bundle under its in-flight side-
               stream copy, and a read-ahead pinned on its worker thread,
               both bit-equal to the shard; GraphSession.open(cache_parts=1,
               host_cache_parts=2) on OPAT, TraditionalMP (processors=2)
               and MapReduceMP, the path's runs and Q5 again, each checked
               against the path phase's oracle answers, with disk reads,
               read-ahead hits (OPAT), validate_run_residency on every OPAT
               run, step launches equal to the loop counts and the host
               tier's peak bytes within two partitions; cold and warm Q5
               opened (unbounded tiers) against in RAM; peak device memory
  frontend     the SLO front end (before ooc) on the path's OPAT, the
               traditional and the mapreduce sessions: with no classes it
               equals submit_many; under the default classes with instant
               replay the path's runs x 4, classes round-robin, every
               served answer checked against the oracle under its
               effective budget, every shed with a reason, the counters
               summing to the arrivals; then OPAT under real-time replay
               (48 arrivals 20 ms apart, three in four batch): per class
               p50/p95/p99, deadline attainment, burn rate, and the cost
               model's calibrated seconds per unit beside the reference's
               2e-4 prior
  repartition  GraphSession.repartition on the path phase's OPAT session
               with the profile it served: cut before and after, host
               seconds, device memory before and after the rebind, then Q4
               and Q5 again against the oracle
  mutation     the ooc phase's graph directory opened mutable (OPAT,
               cache_parts=1, host_cache_parts=2): three bursts of updates
               (a clone of a vertex bound in Q4's answers with its edges,
               so an answer binds a vertex added in the session; twelve
               updates of all four kinds; edges that widen the ELL width),
               each followed by a query checked against the oracle over
               its own overlay graph, and one step launch under the view
               against its plain version; a scheduler pinned to that
               generation while compact_hot publishes the next (its answer
               the pinned graph's, its files kept until close()); cold Q5
               on the stale view against after compact_all; TraditionalMP
               and MapReduceMP on the final generation; host seconds per
               update, overlay rebuild and compaction seconds, peak device
               memory
  examples     the four ``examples/torch_*.py`` run in this process on the
               card through their ``main`` (quickstart, the serving demo
               with its demo flags, the MapReduceMP demo over every card
               up to four, and the training demo at ``--steps 20`` with
               its checkpoints under build/): each returns 0, the three
               graph examples' oracle checks all MATCH and the step kernel
               launches under each of them; each example's seconds, the
               phase within 30 s

  cost         the dry run (``repro_torch.launch.dryrun.run_cell``: the
               ATen ops on the meta device, no card) of the calls the lm
               and train phases time, at their shapes: Qwen2-1.5B's bf16
               prefill of 8 x 2,048, its decode step over 2,081 cached
               positions, its train step of 4 x 2,048 (remat + flash_cv)
               and xLSTM-125M's train step of 8 x 128; counted one after
               another in this process, between the graph phases and lm;
               each cell's bound (H100 SXM peaks), ATen ops, useful-FLOP
               ratio and argument + temp bytes (the temp peak extrapolated
               over the layer stack, a lower bound, where
               ``temp_peak_exact`` is false), and the seconds the phase
               added; after them, one at a time in one spawned
               process, the mesh records of Qwen2-1.5B's
               train_4k at full width and depth (rank 0 of (16, 16) and
               of (2, 16, 16), 256 and 512 H100s, counted in a counting
               world on torch's fake backend): their dominant term, collective term (> 0;
               over ``pod`` all-reduces only) and argument + temp bytes a
               card, the argument bytes equal to rank 0's blocks under
               the resolver's specs; within 60 s more
  lm           the language-model serving stack (no hand-written kernel
               on its path; the reference computes it outside Pallas), TF32
               off: all ten reduced configs in float32 on the card against
               the CPU (forward, prefill, decode_step on grown caches, every
               logit and cache leaf); Qwen2-1.5B at full width and depth in
               float32 (B=4, 511-token prompts: prefill against forward,
               decode at 511 against forward over 512, cache shapes and
               dtypes kept); Qwen2-1.5B in bf16 serving 8 prompts of 2,048
               tokens, then 32 greedy tokens (prefill seconds, decode ms per
               token, peak memory, one step under torch.profiler: host
               launches and the device's idle share; beside each time and
               peak the cost phase's record: bound, useful-FLOP ratio,
               ATen ops, argument + temp bytes); and the nine other
               configs at published width with depth cut (``LM_CUTS``),
               each prefilled and decoding 8 tokens; the graph kernels
               must not launch
  train        language-model training (no hand-written kernel on its
               path either), TF32 off: all ten reduced configs in float32,
               one train_step on the card against the CPU (remat; flash_cv
               on the attention configs; attn_remat on qwen2_1_5b), the
               loss terms and every leaf of m and v; flash_attention_cv's
               gradients at Qwen2-1.5B's attention shape, card against
               CPU; Qwen2-1.5B at full width in float32, 8 layers (B=1 x
               1,024, wq and wk at fan-in d): every gradient leaf equal
               across remat, no remat, flash_cv and attn_remat; Qwen2-1.5B
               in bf16 at full depth, 3 steps of 4 x 2,048 tokens (step
               time, tokens/s, peak
               memory, one profiled step, beside the cost phase's
               record); and the train CLI on xLSTM-125M at its published
               size, run uninterrupted (beside its record) and killed after
               its first commit and resumed (the same losses, the same
               checkpoint layout)
  lm_mesh      the language models' mesh (no hand-written kernel on its
               path): in a one-rank NCCL group made in this process,
               Qwen2-1.5B at published width with depth cut to 2 layers
               (wq and wk at fan-in d, as in train), 3 bf16 train steps
               of 4 x 2,048 on make_test_mesh((1, 1)) (distributed.fsdp's
               step: FSDP over data, tensor parallel over model) against
               make_train_step unsharded, and a prefill of 4 x 2,048 with
               8 greedy decode steps through distributed.tp on (1, 1)
               against serving.decode (both bit-equal: a one-rank mesh
               cuts no leaf), and deepseek-moe-16b at published width (2
               layers: the dense head layer and one MoE layer) forward
               on 2 x 2,048 with make_tp_moe_fn over the one-rank model
               group against the dense moe_ffn; peak memory, resident
               parameter and optimizer bytes and step seconds of each;
               within 60 s.  With two or more cards, one NCCL process per
               card (up to four): the Qwen2 step on (D, 1) and deepseek's
               moe_fn on (1, D) (64 / D experts a card) against one card
               (the Qwen2 step also at the raw init, its first step
               held); then dense tensor parallelism on (1, D): Qwen2-1.5B
               (3 bf16 steps of 4 x 2,048; a prefill of 4 x 2,048 and 8
               greedy steps with the S-sharded cache of 2,064) and
               recurrentgemma-9b at published width, 3 layers (r, r,
               local: 2 steps of 2 x 2,048, a prefill of 2 x 2,048 and 8
               steps), each against one card within MESH_TOL, greedy
               tokens equal, every cut leaf, cache and logit
               block 1/D of one card's bytes; with four cards Qwen2 on
               (2, 2) too; and rank 0's warm (1, D) Qwen2 step counted
               under OpCostMode over NCCL, its collective bytes per kind
               and per axis equal to the dry run's count of the same call
               (a counting world of D ranks in a spawned process, run
               before the ranks start), both
               ATen op counts, the record's argument + temp bytes beside
               the card's resident and peak bytes

Each serving phase sets the launch counts to 0 just before it and reads
them just after; it fails if a kernel of its path never launched.  The
graph directories live under build/ and are removed at the end.  Then a
``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit line, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result.  The full record is also
written to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import os
import re
import resource
import shutil
import subprocess
import tempfile
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RECORD: dict = {}
T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """Record and print one phase's line, stamped with the seconds since
    the script started (``at_s``)."""
    kw["at_s"] = time.perf_counter() - T0
    RECORD[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_time_ms(fn, reps: int = 200, replays: int = 10) -> float:
    """Device time per call: ``reps`` calls captured into one CUDA graph
    and replayed, so host-side launch overhead drops out.  The capture runs
    on the stream the warm-up ran on, so per-stream scratch a kernel makes
    at its first call (label_histogram's) exists before the capture and no
    zero-fill enters the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


# ---------------------------------------------------------------------------
# kernels: each against its plain version
# ---------------------------------------------------------------------------

def engine_case(rng, EB, W, Q, Np, V, *, empty=False, dev="cuda"):
    """Random engine-level inputs for one frontier_expand match: a random
    plan, six ELL tables (~20% NaN destination values) over V global ids,
    binding rows, steps drawn past n_steps, and (``empty``) an all-inactive
    frontier."""
    from repro_torch.core.engine import plan_to_device
    from repro_torch.core.plan import PlanArrays

    S = 6
    plan = PlanArrays(
        n_slots=Q, n_steps=S, start_slot=np.int32(0), start_label=np.int32(0),
        start_value_op=np.int32(0), start_value=np.float32(0),
        src_slot=rng.integers(0, Q, S).astype(np.int32),
        dst_slot=rng.integers(0, Q, S).astype(np.int32),
        edge_label=rng.integers(-1, 3, S).astype(np.int32),
        direction=rng.integers(0, 3, S).astype(np.int32),
        dst_label=rng.integers(-1, 3, S).astype(np.int32),
        dst_value_op=rng.integers(0, 7, S).astype(np.int32),
        dst_value=rng.normal(size=S).astype(np.float32),
        closes_cycle=rng.integers(0, 2, S).astype(np.int32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    dst = rng.integers(-1, Np, size=(Np, W)).astype(np.int32)
    dval = rng.normal(size=(Np, W)).astype(np.float32)
    dval[rng.random((Np, W)) < 0.2] = np.nan
    tables = [t(dst),
              t(rng.integers(-2, 3, size=(Np, W)).astype(np.int32)),
              t(rng.integers(0, 3, size=(Np, W)).astype(np.int32)),
              t(rng.integers(-2, 3, size=(Np, W)).astype(np.int32)),
              t(dval),
              t(np.where(dst >= 0, rng.integers(0, V, size=(Np, W)), -1).astype(np.int32))]
    return dict(
        plan=plan_to_device(plan, dev), n_steps=5, tables=tables,
        rows=t(rng.integers(-1, V, size=(EB, Q)).astype(np.int32)),
        step=t(rng.integers(0, S + 2, size=EB).astype(np.int32)),
        lidx=t(rng.integers(0, Np, size=EB).astype(np.int32)),
        m=t(np.zeros(EB, bool) if empty else rng.random(EB) < 0.8))


def expand_args(c) -> tuple:
    """frontier_expand's kernel-level inputs, packed as ops.frontier_expand
    packs them."""
    from repro_torch.kernels import ops
    pint, pflt = ops._expand_params(c["step"], c["m"], c["plan"], c["n_steps"])
    return (c["lidx"], pint, pflt, c["rows"], *c["tables"])


def step_case(rng, L, EB, W, Q, Np, *, P=1, V=None, N=None, empty=False,
              dev="cuda"):
    """Random loop state for the frontier step, packed as the evaluators
    pack it: P stacked partitions of random ELL tables (~20% NaN
    destination values), their g2l rows over V global ids (most work-row
    ids absent), owner, one random plan per lane (cycle-closing steps
    included) with n_steps drawn per lane, work buffers of N rows with
    steps past n_steps, and a selection of EB work rows per lane whose
    lane stride is N, as the evaluators slice it.  ``lidx`` picks distinct
    table rows when N <= Np.  ``empty`` makes every lane's frontier
    inactive.  Returns (invariants, (wr, ws, lidx, sel, m))."""
    from repro_torch.kernels import ops
    V = V or max(1000, 2 * Np)
    N = N or EB + 7
    S = 6
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    R = P * Np
    dst = rng.integers(-1, Np, size=(R, W)).astype(np.int32)
    dval = rng.normal(size=(R, W)).astype(np.float32)
    dval[rng.random((R, W)) < 0.2] = np.nan
    tables = [t(dst),
              t(rng.integers(-2, 3, size=(R, W)).astype(np.int32)),
              t(rng.integers(0, 3, size=(R, W)).astype(np.int32)),
              t(rng.integers(-2, 3, size=(R, W)).astype(np.int32)),
              t(dval),
              t(np.where(dst >= 0, rng.integers(0, V, size=(R, W)), -1).astype(np.int32))]
    g2l = np.full((P, V), -1, np.int32)
    for p in range(P):
        present = rng.choice(V, size=min(Np, V), replace=False)
        g2l[p, present] = rng.permutation(len(present)).astype(np.int32)
    plan = {f: t(rng.integers(lo, hi, size=(L, S)).astype(np.int32))
            for f, lo, hi in (("src_slot", 0, Q), ("dst_slot", 0, Q),
                              ("edge_label", -1, 3), ("direction", 0, 3),
                              ("dst_label", -1, 3), ("dst_value_op", 0, 7),
                              ("closes_cycle", 0, 2))}
    plan["dst_value"] = t(rng.normal(size=(L, S)).astype(np.float32))
    lane_part = rng.integers(0, P, L)
    n_core = rng.integers(1, Np + 1, P)[lane_part]
    inv = ops.step_invariants([x.view(P, Np, W) for x in tables], t(g2l), t(rng.integers(0, 4, V).astype(np.int32)),
                              types.SimpleNamespace(**plan), t(lane_part), t(n_core),
                              t(rng.integers(3, S + 1, L)))
    lidx = (np.stack([rng.permutation(Np)[:N] for _ in range(L)]) if N <= Np
            else rng.integers(-2, Np + 2, size=(L, N)))
    sel = np.stack([rng.permutation(N) for _ in range(L)])
    m = np.zeros((L, EB), bool) if empty else rng.random((L, EB)) < 0.8
    return inv, (t(rng.integers(-1, V, size=(L, N + 1, Q)).astype(np.int32)),
                 t(rng.integers(0, S + 2, size=(L, N + 1)).astype(np.int32)),
                 t(lidx.astype(np.int32)), t(sel)[:, :EB], t(m))


def compare_step(got, want) -> dict:
    """Every output bit-equal (masks, dg, dest, nr, ns); done/keep/out
    disjoint and covering ok.  Returns the error record."""
    ok, done, keep, out = got[0], got[2], got[3], got[4]
    mism = sum(int((a != b).sum()) for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    disjoint = not bool((done & keep).any() | (done & out).any() | (keep & out).any())
    covers = bool(torch.equal(done | keep | out, ok))
    return {"mismatches": mism, "max_abs_err": err, "disjoint": disjoint,
            "covers_ok": covers, "n_ok": int(ok.sum()), "n_done": int(done.sum()),
            "n_keep": int(keep.sum()), "n_out": int(out.sum())}


def compare_expand(got, want, args) -> dict:
    """ok bit-equal, dg where an edge exists."""
    ok, dg = got
    wok, wdg = want
    edge = args[4][args[0].long()] >= 0
    err = int((dg - wdg).abs()[edge].max()) if bool(edge.any()) else 0
    return {"mask_mismatches": int((ok != wok).sum()), "max_abs_err": err,
            "n_ok": int(ok.sum())}


def frontier_bytes_ops(args, n_tables: int, out_bytes_per_slot: int,
                       ops_per_slot: int) -> tuple:
    """Bytes a frontier call must move (each input read once — only the
    table rows this run's lidx selects — each output written once) and its
    elementwise integer operations."""
    lidx, pint, pflt, rows = args[:4]
    EB, Q = rows.shape
    W = args[4].shape[1]
    rows_read = int(torch.unique(lidx).numel())
    table_bytes = sum(rows_read * W * t.element_size() for t in args[4:4 + n_tables])
    scalar_bytes = sum(x.numel() * x.element_size() for x in (lidx, pint, pflt, rows))
    return (table_bytes + scalar_bytes + EB * W * out_bytes_per_slot,
            EB * W * (ops_per_slot + 2 * Q))


def timing_record(fn, plain, nbytes: int, nops: int, worst: int,
                  call_reps: int) -> dict:
    """The kernel's own device time (CUDA-graph replay), the time per call
    through the Python wrapper (back to back, as a caller pays it), the
    plain version's time, and the bound."""
    from repro_torch.launch.cost_analysis import H100_F32_FLOPS_PER_S, HBM_BW
    ms = graph_time_ms(fn)
    call_ms = cuda_time_ms(fn, reps=call_reps, warmup=100)
    plain_ms = cuda_time_ms(plain, reps=300)
    bound_bytes_ms = nbytes / HBM_BW * 1e3
    bound_ops_ms = nops / H100_F32_FLOPS_PER_S * 1e3
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bytes": nbytes,
            "ops": nops, "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": None, "max_abs_err": worst}


def launch_floor_ms() -> float:
    """The shortest a captured launch takes on this card: graph replay of a
    one-element fill_.  A yardstick only; no path of the port calls it."""
    one = torch.zeros(1, device="cuda")
    return graph_time_ms(lambda: one.fill_(1.0))


# frontier_expand beside the warp width: (EB, W, Q, Np)
EXPAND_WARP_CASES = [(16, 31, 8, 32), (16, 32, 1, 32), (16, 33, 8, 32),
                     (16, 31, 1, 32), (8, 130, 8, 16), (8, 130, 1, 16)]


def frontier_cases(Np: int) -> list:
    return [("sweep", (4, 4, 4, 8), {}), ("sweep", (16, 7, 6, 32), {}),
            ("sweep", (32, 128, 8, 64), {}), ("sweep", (8, 130, 5, 16), {}),
            ("sweep", (1, 1, 1, 1), {}),
            ("empty", (8, 16, 4, 8), {"empty": True}),
            ("paper_empty", (512, 20, 8, Np), {"empty": True}),
            ("paper", (512, 20, 8, Np), {})]


def check_frontier(name, rec, kw) -> None:
    if kw.get("empty"):
        check(rec["n_ok"] == 0, f"{name}: empty frontier matched something: {rec}")
    if rec["case"] in ("paper", "mapreduce"):
        check(rec["n_ok"] > 0, f"{name}: paper-shape case matched nothing")


MR_CAP = 16384      # EngineConfig(cap=...) of the mapreduce phase


def step_cases(Np: int) -> list:
    """The sweep (Q = 1, 5, 6, 8; W up to 130) and the main path's shape,
    each at L = 1 and at L = 2 lanes over two stacked partitions; then
    MapReduceMP's shape: four lanes over four partitions, each lane's
    selection drawn from a work buffer of MR_CAP + Np rows."""
    out = []
    for L, P in ((1, 1), (2, 2)):
        out += [(name, (L, EB, W, Q, n), dict(kw, P=P))
                for name, (EB, W, Q, n), kw in frontier_cases(Np)]
        out.append(("sweep", (L, 8, 9, 1, 24), {"P": P}))
    out.append(("mapreduce", (4, 512, 20, 8, Np), {"P": 4, "N": MR_CAP + Np}))
    return out


STEP_SETS = 256     # rotating selections for the device-time run


def kernel_fused_frontier(rng, Np: int) -> tuple:
    """The frontier step bit-equal to its plain version on every case; at
    the main path's shape (L = 1) timed over STEP_SETS selections of
    distinct table rows (about the 50 MB L2 in all), and over one."""
    from repro_torch.kernels import fused_frontier as ff
    from repro_torch.kernels.ops import step_bytes_ops, step_cost
    results, worst = [], 0
    for name, (L, EB, W, Q, n), kw in step_cases(Np):
        timed = name == "paper" and L == 1
        V = 440_000 if name in ("paper", "paper_empty", "mapreduce") else max(1000, 2 * n)
        kw = dict(kw)
        N = STEP_SETS * EB if timed else kw.pop("N", None)
        inv, args = step_case(rng, L, EB, W, Q, n, V=V, N=N, **kw)
        out = ff.step_outputs(L, EB, W, Q, "cuda")
        got = ff.frontier_step_cuda(inv, *args, out)
        torch.cuda.synchronize()
        rec = compare_step(got, ff.frontier_step_plain(inv, *args))
        rec.update(case=name, L=L, EB=EB, W=W, Q=Q, Np=n)
        results.append(rec)
        check(rec["mismatches"] == 0 and rec["max_abs_err"] == 0
              and rec["disjoint"] and rec["covers_ok"],
              f"fused_frontier disagrees with its plain version: {rec}")
        check_frontier("fused_frontier", rec, kw)
        worst = max(worst, rec["max_abs_err"])
        if timed:
            paper = (inv, args, out)
        if name == "mapreduce":
            # the step at MapReduceMP's shape: device time beside its bound
            from repro_torch.launch.cost_analysis import H100_F32_FLOPS_PER_S, HBM_BW
            nbytes, _, nops = step_bytes_ops(inv, args, got)
            lanes4 = {"ms": graph_time_ms(lambda: ff.frontier_step_cuda(inv, *args, out)),
                      "bytes": nbytes, "bound_ms": max(nbytes / HBM_BW,
                                                       nops / H100_F32_FLOPS_PER_S) * 1e3}
            del inv, args, out, got
    inv, args, out = paper
    nbytes, parts, nops = step_bytes_ops(inv, args, out)
    wr, ws, lidx, sel, m = args
    sets = [(torch.arange(k * 512, (k + 1) * 512, device="cuda")[None],
             torch.from_numpy(rng.random((1, 512)) < 0.8).cuda())
            for k in range(STEP_SETS)]
    cycle = itertools.cycle(sets)

    def rotating():
        s, mm = next(cycle)
        ff.frontier_step_cuda(inv, wr, ws, lidx, s, mm, out)

    timing = timing_record(rotating, lambda: ff.frontier_step_plain(inv, *args),
                           nbytes, nops, worst, call_reps=5000)
    timing["ms_one_set"] = graph_time_ms(lambda: ff.frontier_step_cuda(inv, *args, out))
    timing["bytes_by_part"] = parts
    # the profiler's shape-only upper bound at the same shapes
    L, EB = sel.shape
    timing["step_cost"] = dict(zip(("ops", "bytes"), step_cost(
        L, EB, inv.tables[0].shape[1], wr.shape[2], inv.plan_int.shape[1],
        inv.node_pad, inv.owner.shape[0])))
    timing["sets"] = STEP_SETS
    timing["mapreduce_four_lanes"] = lanes4
    return results, timing


def kernel_frontier_expand(rng, Np: int) -> tuple:
    from repro_torch.kernels import frontier_expand as fe
    results, worst = [], 0
    cases = [("warp", shape, {}) for shape in EXPAND_WARP_CASES] + frontier_cases(Np)
    for name, (EB, W, Q, n), kw in cases:
        args = expand_args(engine_case(rng, EB, W, Q, n, V=max(1000, 2 * n), **kw))
        got = fe.frontier_expand_cuda(*args)
        torch.cuda.synchronize()
        rec = compare_expand(got, fe.frontier_expand_plain(*args), args)
        rec.update(case=name, EB=EB, W=W, Q=Q, Np=n)
        results.append(rec)
        check(rec["mask_mismatches"] == 0 and rec["max_abs_err"] == 0,
              f"frontier_expand disagrees with its plain version: {rec}")
        check_frontier("frontier_expand", rec, kw)
        worst = max(worst, rec["max_abs_err"])
        paper = args
    nbytes, nops = frontier_bytes_ops(paper, 6, 1 + 4, 30)
    timing = timing_record(lambda: fe.frontier_expand_cuda(*paper),
                           lambda: fe.frontier_expand_plain(*paper),
                           nbytes, nops, worst, call_reps=5000)
    return results, timing


def histogram_case(rng, n: int, dev="cuda") -> tuple:
    lab = rng.integers(0, 4, n).astype(np.int32)
    val = rng.normal(size=n).astype(np.float32)
    val[rng.random(n) < 0.2] = np.nan
    core = (rng.random(n) < 0.7).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (lab, val, core))


def histogram_views(rng, n: int) -> list:
    """(offset, tail, inputs): views at offsets 0-3 into longer arrays, of
    n + tail nodes for each tail 0-3.  An offset other than 0 makes every
    pointer of a non-empty view miss 16-byte alignment (the kernel's
    scalar path); the tail gives each n % 4."""
    out = []
    for tail in range(4):
        base = histogram_case(rng, n + tail + 3)
        out += [(off, tail, tuple(a[off:off + n + tail] for a in base))
                for off in range(4)]
    return out


HISTOGRAM_PROBES = ((-1, 0, 0.0), (1, 5, 0.1), (2, 3, -0.2), (9, 0, 0.0))


def histogram_two_streams(cases):
    """label_histogram on two streams at once.  Both streams first wait
    behind a spin kernel (about 10 ms), so the host queues 20 launches on
    each before either runs and the two queues then drain side by side.
    ``cases`` gives each stream its (inputs, label, op, value).  Returns
    [(stream, got, want)] with got and want as ints."""
    from repro_torch.kernels import label_histogram as lh
    calls, sleep_cycles = 20, 20_000_000
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    pending = []
    for st, (args, label, op, value) in zip(streams, cases):
        st.wait_stream(main)
        with torch.cuda.stream(st):
            lh.label_histogram_cuda(*args, label, op, value)  # makes the scratch
            torch.cuda._sleep(sleep_cycles)
    for _ in range(calls):
        for k, (st, (args, label, op, value)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                pending.append((k, lh.label_histogram_cuda(*args, label, op, value)))
    for st in streams:
        main.wait_stream(st)
    torch.cuda.synchronize()
    want = [int(lh.label_histogram_plain(*a, lb, op, v)) for a, lb, op, v in cases]
    return [(k, int(got), want[k]) for k, got in pending]


def histogram_graph_replay(cases):
    """label_histogram captured into one CUDA graph, one call per case, and
    replayed 5 times; then the same calls eagerly on the capture stream.
    The capture stream's scratch is dropped first, so it is made (and its
    one zero-fill captured) inside the capture.  Returns [(replay or -1
    for eager, case index, got, want)]."""
    from repro_torch.kernels import label_histogram as lh
    replays = 5
    st = torch.cuda.Stream()
    lh._SCRATCH.pop((torch.cuda.current_device(), st.cuda_stream), None)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=st):
        outs = [lh.label_histogram_cuda(*a, lb, op, v) for a, lb, op, v in cases]
    want = [int(lh.label_histogram_plain(*a, lb, op, v)) for a, lb, op, v in cases]
    res = []
    for r in range(replays):
        for o in outs:
            o.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        res += [(r, k, int(o), want[k]) for k, o in enumerate(outs)]
    with torch.cuda.stream(st):
        eager = [lh.label_histogram_cuda(*a, lb, op, v) for a, lb, op, v in cases]
    torch.cuda.synchronize()
    res += [(-1, k, int(o), want[k]) for k, o in enumerate(eager)]
    return res


def kernel_label_histogram(rng, pg) -> tuple:
    """The sweep (the 1024-node block edge, every label kind and op, NaN
    values), offset views and n % 4 tails, two streams at once, CUDA-graph
    replay, one partition of the path, and the whole graph."""
    from repro_torch.kernels import label_histogram as lh
    results = []

    def one(case, args, label, op, value):
        got = lh.label_histogram_cuda(*args, label, op, value)
        torch.cuda.synchronize()
        want = lh.label_histogram_plain(*args, label, op, value)
        rec = {"case": case, "n": int(args[0].shape[0]), "label": label, "op": op,
               "count": int(got), "max_abs_err": abs(int(got) - int(want)),
               "vector_loads": lh.use_vector_loads(*args)}
        check(rec["max_abs_err"] == 0,
              f"label_histogram disagrees with its plain version: {rec}")
        return rec

    for n in (1, 1023, 1024, 1025, 3000):
        args = histogram_case(rng, n)
        for label in (-1, 2, 9):
            results += [one("sweep", args, label, op, 0.1) for op in range(7)]
    for n in (0, 3000, pg.node_pad):
        for off, tail, args in histogram_views(rng, n):
            check(lh.use_vector_loads(*args) == (off == 0 or n + tail == 0),
                  f"offset {off}: vector path chosen wrongly")
            results += [one(f"view{off}_tail{tail}", args, *p) for p in HISTOGRAM_PROBES]
    # one input a misaligned view (the scalar path), one aligned
    mis = tuple(a[1:] for a in histogram_case(rng, pg.node_pad + 1))
    big = histogram_case(rng, pg.node_pad)
    streamed = histogram_two_streams([(mis, 1, 5, 0.1), (big, -1, 0, 0.0)])
    check(all(g == w for _, g, w in streamed),
          f"label_histogram on two streams: {[x for x in streamed if x[1] != x[2]][:4]}")
    replayed = histogram_graph_replay([(mis, 1, 5, 0.1), (big, 2, 3, -0.2),
                                       (histogram_case(rng, 1025), -1, 0, 0.0)])
    check(all(g == w for _, _, g, w in replayed),
          f"label_histogram in a CUDA graph: {[x for x in replayed if x[2] != x[3]][:4]}")
    results.append({"case": "two_streams", "calls": len(streamed), "max_abs_err": 0})
    results.append({"case": "graph_replay", "calls": len(replayed), "max_abs_err": 0})
    part = pg.parts[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    core = (np.arange(pg.node_pad) < part.n_core).astype(np.int32)
    paper = (t(part.node_label), t(part.node_value), t(core))
    g = pg.graph
    whole = (t(g.node_label), t(g.node_value),
             t(np.ones(g.n_nodes, np.int32)))
    for case, args in (("partition", paper), ("graph", whole)):
        results += [one(case, args, -1, 0, 0.0), one(case, args, 1, 5, 0.5),
                    one(case, args, 0, 2, float("nan"))]
    n = paper[0].shape[0]
    timing = timing_record(lambda: lh.label_histogram_cuda(*paper, 1, 5, 0.5),
                           lambda: lh.label_histogram_plain(*paper, 1, 5, 0.5),
                           3 * 4 * n + 4, 12 * n, 0, call_reps=2000)
    whole_timing = {"ms": graph_time_ms(lambda: lh.label_histogram_cuda(*whole, 1, 5, 0.5)),
                    "bytes": 3 * 4 * whole[0].shape[0] + 4}
    return results, timing, whole_timing


def append_case(seed: int, L: int, EB: int, W: int, Q: int, *, cap: int = 4096,
                WT: int = None, density: float = 0.05, keep: bool = True,
                mixed: bool = True, dev="cuda") -> tuple:
    """Random inputs for one frontier_append over L lanes of N = EB * W
    candidates, drawn on ``dev`` from ``seed``.  With ``mixed``, lane l's
    flags depend on l % 4: drawn at ``density``, none (a frozen lane), all
    (every mask true: past cap and past the free slots), half; without,
    every lane's are drawn at ``density``.  Odd lanes start with
    comp_n and out_n 3 under cap; lanes 3 mod 4 have a nearly full work
    buffer of WT slots (default cap + 13).  The buffers start filled with
    random rows, so a stray write shows.  ``keep=False`` is the
    pre-classify's form: no keep, and rows and steps read through a
    strided view of a longer buffer.  Returns (state, the op's arguments
    after the state)."""
    from repro_torch.kernels import frontier_append as fa
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    N = EB * W
    WT = WT or cap + 13
    i32 = torch.int32

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=i32)

    def rb(p, *shape):
        return torch.rand(shape, generator=g, device=dev) < p

    lane = torch.arange(L, device=dev)
    dens = (torch.tensor([density, 0.0, 1.0, 0.5], device=dev)[lane % 4] if mixed
            else torch.full((L,), density, device=dev))[:, None]
    done, outm, kp = (torch.rand((L, N), generator=g, device=dev) < dens
                      for _ in range(3))
    if keep:
        rows, step = ri(-1, 1000, L, N, Q), ri(0, 12, L, N)
    else:
        rows, step = ri(-1, 1000, L, N + 5, Q)[:, :N], ri(0, 12, L, N + 5)[:, :N]
    dest = ri(-1, 4, L, N)
    st = fa.append_state(L, cap, Q, max(N, WT), dev)
    for buf, hi in ((st.comp_rows, 1000), (st.out_rows, 1000), (st.out_step, 12),
                    (st.out_dest, 4)):
        buf.copy_(ri(-1, hi, *buf.shape))
    odd = (lane % 2 == 1)
    for n in (st.comp_n, st.out_n):
        n.copy_(torch.where(odd, cap - 3, ri(0, cap // 2 + 1, L).long()))
    if not keep:
        return st, (rows, step, dest, done, outm, None, None, None)
    full = torch.where(lane % 4 == 3, 0.999, 0.5)[:, None]
    wv = torch.rand((L, WT + 1), generator=g, device=dev) < full
    wv[:, WT] = False
    work = (ri(-1, 1000, L, WT + 1, Q), ri(0, 12, L, WT + 1), wv)
    free = torch.sort((~wv[:, :WT]).to(torch.uint8), dim=1, descending=True,
                      stable=True)[1][:, :min(N, WT)]
    return st, (rows, step, dest, done, outm, kp, work, free)


def clone_append(st, args) -> tuple:
    """Copies of what frontier_append writes (the state, the work buffers),
    the read-only inputs shared."""
    from repro_torch.kernels.frontier_append import AppendState
    work = args[6]
    return (AppendState(*(t.clone() for t in st)),
            (*args[:6], None if work is None else tuple(t.clone() for t in work),
             args[7]))


def compare_append(a, b) -> dict:
    """Mismatches between two appends' results, (state, args) each, on
    every output but the trash rows and the kernel's scratch, and what
    landed: rows, counts, overflow lanes."""
    (sa, xa), (sb, xb) = a, b
    cap = sa.comp_rows.shape[1] - 1
    pairs = [(sa.comp_rows[:, :cap], sb.comp_rows[:, :cap]), (sa.comp_n, sb.comp_n),
             (sa.out_rows[:, :cap], sb.out_rows[:, :cap]),
             (sa.out_step[:, :cap], sb.out_step[:, :cap]),
             (sa.out_dest[:, :cap], sb.out_dest[:, :cap]), (sa.out_n, sb.out_n),
             (sa.overflow, sb.overflow), (sa.landed, sb.landed)]
    if xa[6] is not None:
        WT = xa[6][2].shape[1] - 1
        pairs += [(u[:, :WT], v[:, :WT]) for u, v in zip(xa[6], xb[6])]
    return {"mismatches": sum(int((u != v).sum()) for u, v in pairs),
            "landed": int(sa.landed.sum()), "comp_n": int(sa.comp_n.sum()),
            "out_n": int(sa.out_n.sum()), "overflow_lanes": int(sa.overflow.sum())}


def append_bytes(L: int, N: int, Q: int, kinds: int, n_done: int, n_out: int,
                 n_keep: int) -> int:
    """Bytes one append must move: each candidate's flag bytes read once;
    each landed row read and written (4 Q bytes each way), an outgoing
    row's step and destination read and written, a kept row's step read
    and written, its free-slot index read and its valid byte read and
    written; each lane's two counts read and written, its overflow byte
    and landed counter written."""
    return (kinds * L * N + n_done * 8 * Q + n_out * (8 * Q + 16)
            + n_keep * (8 * Q + 8 + 8 + 2) + L * (16 + 1 + 8))


# frontier_append's timed shapes: (name, (L, EB, W, Q), case keywords): the
# shared scheduler's 32 lanes on Subgen's W = 20 (work buffer cap + the
# path's node_pad) and on IMDB's W = 5,140, each with the mixed lanes of
# the card test (empty, full and half flags among them) and with every
# lane's flags sparse, as the serving cells see them: 3 % at W = 20 over
# 26 lanes, 2e-5 at W = 5,140
APPEND_SHAPES = [("main", (32, 512, 20, 8), dict(cap=16384, WT=16384 + 110_080)),
                 ("main_sparse", (26, 512, 20, 8),
                  dict(cap=16384, WT=16384 + 110_080, density=0.03, mixed=False)),
                 ("imdb_wide", (32, 512, 5140, 8),
                  dict(cap=16384, WT=16384 + 18_560, density=2e-5)),
                 ("imdb_sparse", (32, 512, 5140, 8),
                  dict(cap=16384, WT=16384 + 18_560, density=2e-5, mixed=False))]


def kernel_frontier_append(seed: int) -> dict:
    """The append kernel bit-equal to its plain version at the timed
    shapes, then its device time (CUDA-graph replay of a launch after
    resetting the two counts, less the reset alone) beside its bytes, the
    time per call through the wrapper and the plain version's time."""
    from repro_torch.kernels import frontier_append as fa
    from repro_torch.launch.cost_analysis import HBM_BW
    out = {}
    for name, (L, EB, W, Q), kw in APPEND_SHAPES:
        st, args = append_case(seed, L, EB, W, Q, **kw)
        c0 = (st.comp_n.clone(), st.out_n.clone())
        got, want = clone_append(st, args), clone_append(st, args)
        fa.frontier_append_cuda(got[0], *got[1])
        fa.frontier_append_plain(want[0], *want[1])
        torch.cuda.synchronize()
        rec = compare_append(got, want)
        check(rec["mismatches"] == 0,
              f"frontier_append disagrees with its plain version at {name}: {rec}")
        dn = int((got[0].comp_n - c0[0]).sum())
        on = int((got[0].out_n - c0[1]).sum())
        nbytes = append_bytes(L, EB * W, Q, 3, dn, on, rec["landed"] - dn - on)
        del got, want

        def reset():
            st.comp_n.copy_(c0[0])
            st.out_n.copy_(c0[1])

        def launch():
            reset()
            fa.frontier_append_cuda(st, *args)

        reset_ms = graph_time_ms(reset, reps=50)
        ms = graph_time_ms(launch, reps=50) - reset_ms
        call_ms = cuda_time_ms(launch, reps=50, warmup=5) - reset_ms
        plain_ms = cuda_time_ms(lambda: fa.frontier_append_plain(st, *args),
                                reps=5, warmup=1)
        out[name] = {"L": L, "EB": EB, "W": W, "Q": Q, "ms": ms, "call_ms": call_ms,
                     "reset_ms": reset_ms, "plain_ms": plain_ms, "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BW * 1e3, **rec}
        del st, args
        torch.cuda.empty_cache()
    return out


def phase_kernels(seed: int, pg) -> dict:
    rng = np.random.default_rng(seed)
    Np = pg.node_pad
    ff_cases, ff_t = kernel_fused_frontier(rng, Np)
    fe_cases, fe_t = kernel_frontier_expand(rng, Np)
    lh_cases, lh_t, lh_whole = kernel_label_histogram(rng, pg)
    fa_t = kernel_frontier_append(seed)
    floor = launch_floor_ms()
    emit("kernels", node_pad=Np, launch_floor_ms=floor,
         fused_frontier_cases=ff_cases, frontier_expand_cases=fe_cases,
         label_histogram_cases=[c for c in lh_cases
                                if c["case"] in ("partition", "graph", "two_streams",
                                                 "graph_replay")],
         label_histogram_cases_checked=len(lh_cases),
         fused_frontier=ff_t, frontier_expand=fe_t, label_histogram=lh_t,
         label_histogram_whole_graph=lh_whole, frontier_append=fa_t)
    return {"fused_frontier": ff_t, "frontier_expand": fe_t, "label_histogram": lh_t,
            "frontier_append": fa_t}


# ---------------------------------------------------------------------------
# serving: small CPU-vs-card parity, then the paths at full size
# ---------------------------------------------------------------------------

def same_results(a, b) -> bool:
    """Two QueryResults agree: answers, and per disjunct loads and
    iterations."""
    return (np.array_equal(a.answers, b.answers)
            and [r.stats.loads for r in a.reports] == [r.stats.loads for r in b.reports]
            and [r.stats.iterations for r in a.reports]
            == [r.stats.iterations for r in b.reports])


def mapreduce_small(g, qs, dev: str) -> list:
    """MapReduceMP on ``g`` (k=4) on one device: each query exhaustive and
    under K=5 through the session's engine (MAX-SN, every lane expands),
    then gated to m_limit=2 under MAX-YIELD.  Returns one (run, query,
    answers, n_iterations, completed_from, spawned_from) per run."""
    from repro_torch.core import (EngineConfig, GraphSession, MapReduceMPEngine,
                                  generate_plan)
    sess = GraphSession(g, engine="mapreduce", config=EngineConfig(cap=16384),
                        device=dev)
    gated = MapReduceMPEngine(sess.pg, sess.config, m_limit=2,
                              heuristic="max-yield", store=sess.store)
    out = []
    for dq in qs:
        plan = generate_plan(dq.disjuncts[0], g, sess.catalog)
        for run, eng, K in (("all", sess.engine, None), ("K5", sess.engine, 5),
                            ("m2_max-yield", gated, None)):
            r = eng.run(plan, max_answers=K)
            out.append((run, dq.name, r.answers, r.n_iterations,
                        r.completed_from.tolist(), r.spawned_from.tolist()))
    return out


def same_mapreduce(a, b) -> bool:
    """Two ``mapreduce_small`` runs agree on every field, answers bit for bit."""
    return len(a) == len(b) and all(
        x[:2] == y[:2] and np.array_equal(x[2], y[2]) and x[3:] == y[3:]
        for x, y in zip(a, b))


def phase_small(seed: int, workdir: Path) -> None:
    from repro_torch.core import EngineConfig, GraphSession
    from repro_torch.data.generators import subgen_like_graph, subgen_queries
    g = subgen_like_graph(n_nodes=2000, n_edges=6000, n_embed=50, seed=seed)
    qs = subgen_queries(g)
    budgets = [None, 3, None]
    runs = {}
    for dev in ("cuda", "cpu"):
        for engine in ("opat", "traditional"):
            sess = GraphSession(g, engine=engine, processors=2,
                                config=EngineConfig(cap=16384), device=dev)
            single = [sess.submit(dq) for dq in qs]
            report = sess.submit_many(qs, max_answers=budgets)
            runs[dev, engine] = (single, report)
    out = []
    for engine in ("opat", "traditional"):
        (a1, ar), (b1, br) = runs["cuda", engine], runs["cpu", engine]
        for a, b in zip(a1, b1):
            check(same_results(a, b), f"{engine} {a.name}: card and CPU runs differ")
            out.append({"engine": engine, "query": a.name, "n_answers": a.n_answers,
                        "n_loads": a.n_loads})
        check(ar.loads == br.loads and ar.batch_sizes == br.batch_sizes
              and all(same_results(a, b) for a, b in zip(ar.results, br.results)),
              f"{engine} submit_many: card and CPU runs differ")
        out.append({"engine": engine, "submit_many_loads": ar.loads,
                    "batch_sizes": ar.batch_sizes})
    mr = {dev: mapreduce_small(g, qs, dev) for dev in ("cuda", "cpu")}
    check(same_mapreduce(mr["cuda"], mr["cpu"]), "mapreduce: card and CPU runs differ")
    out += [{"engine": "mapreduce", "run": run, "query": name,
             "n_answers": int(ans.shape[0]), "n_iterations": it,
             "completed_from": comp, "spawned_from": spawn}
            for run, name, ans, it, comp, spawn in mr["cuda"]]
    # the same graph saved and served out of core, on the card and the CPU
    gdir = workdir / "small-graph"
    GraphSession(g, device="cpu").save(str(gdir))
    ooc = {dev: opened_small(gdir, dev) for dev in ("cuda", "cpu")}
    check(same_opened(ooc["cuda"], ooc["cpu"]), "opened opat: card and CPU runs differ")
    out += [{"engine": "opat_opened", "query": name, "n_answers": int(ans.shape[0]),
             "loads": loads, "iterations": it, "disk_reads": ls["disk_reads"],
             "read_ahead_hits": ls["read_ahead_hits"]}
            for name, ans, loads, it, ls in ooc["cuda"]]
    emit("small", nodes=g.n_nodes, edges=g.n_edges, queries=out)


def phase_graph(scale: float, seed: int):
    """The main path's graph and partitions, built once for every phase."""
    from repro_torch.core import build_partitions, partition_graph
    from repro_torch.data.generators import subgen_like_graph
    t0 = time.perf_counter()
    g = subgen_like_graph(n_nodes=int(2000 * scale), n_edges=int(6000 * scale),
                          n_embed=max(5, int(50 * scale)), seed=seed)
    t_graph = time.perf_counter() - t0
    pg = build_partitions(g, partition_graph(g, 4, "kway_shem", seed=seed), 4,
                          scheme="kway_shem")
    emit("graph", scale=scale, nodes=g.n_nodes, edges=g.n_edges, k=pg.k,
         node_pad=pg.node_pad, ell_width=pg.ell_width, host_graph_s=t_graph,
         host_partition_s=time.perf_counter() - t0 - t_graph)
    return pg


def serve(sess, runs) -> list:
    """Submit each (query, budget) with a synchronised host clock around it."""
    served = []
    for dq, budget in runs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = sess.submit(dq, max_answers=budget)
        torch.cuda.synchronize()
        served.append((dq, budget, res, time.perf_counter() - t1))
    return served


def verify(res, want, budget) -> bool:
    """Exhaustive answers equal the oracle's; budgeted ones are a subset of
    the right size."""
    if budget is None:
        return np.array_equal(res.answers, want)
    wset = {tuple(r) for r in want}
    return (res.n_answers == min(budget, len(wset))
            and all(tuple(r) in wset for r in res.answers))


def query_record(dq, budget, res, lat, want) -> dict:
    st = res.reports[0].stats
    rec = {"query": dq.name, "max_answers": budget, "n_answers": res.n_answers,
           "oracle_answers": int(want.shape[0]), "verified": True,
           "latency_s": lat, "loads": st.loads, "iterations": st.iterations,
           "cold_loads": res.load_stats.cold_loads,
           "warm_loads": res.load_stats.warm_loads,
           "prefetch_hits": res.load_stats.prefetch_hits,
           "bytes_cold": res.load_stats.bytes_cold,
           "bytes_prefetched": res.load_stats.bytes_prefetched}
    ppi = res.reports[0].extra.get("partitions_per_iteration")
    if ppi is not None:
        rec["partitions_per_iteration"] = ppi
    return rec


def path_runs(pg):
    from repro_torch.data.generators import subgen_queries
    dqs = subgen_queries(pg.graph)
    return dqs, [(dq, None) for dq in dqs] + [(dqs[0], 5)]


class EvaluatorCalls:
    """Counts evaluator calls of either form while active: each makes its
    append buffers once (``kernels.ops.append_state``), so an evaluator
    that ran ``loops`` loops over ``calls`` calls launched the append
    kernel ``loops + calls`` times (a pre-classify a call, one a loop)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls, self._real = 0, ops.append_state

        def counted(*args, **kwargs):
            self.calls += 1
            return self._real(*args, **kwargs)
        ops.append_state = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.append_state = self._real


def check_appends(what: str, loops: int, calls: int) -> int:
    """The append kernel's launches since the last ``LAUNCHES.clear()``,
    checked against ``loops`` + ``calls`` (``EvaluatorCalls``)."""
    from repro_torch.kernels import build
    n = build.LAUNCHES["frontier_append"]
    check(calls > 0 and n == loops + calls,
          f"{what}: frontier_append launches {n} != loops {loops} + evaluator "
          f"calls {calls}")
    return n


def phase_path(pg) -> tuple:
    from repro_torch.core import EngineConfig, GraphSession
    from repro_torch.core.oracle import match_disjunctive
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    t0 = time.perf_counter()
    sess = GraphSession(pg=pg, engine="opat", heuristic="max-sn",
                        config=EngineConfig(cap=16384), device="cuda")
    t_setup = time.perf_counter() - t0
    dqs, runs = path_runs(pg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    sess.engine.inner_iters = 0
    with EvaluatorCalls() as ev:
        served = serve(sess, runs)
    launches = build.LAUNCHES[NAME]
    inner = sess.engine.inner_iters
    appends = check_appends("path", inner, ev.calls)
    peak = torch.cuda.max_memory_allocated()

    t2 = time.perf_counter()
    oracle = {dq.name: match_disjunctive(pg.graph, dq, q_pad=8) for dq in dqs}
    t_oracle = time.perf_counter() - t2
    queries = []
    for dq, budget, res, lat in served:
        check(verify(res, oracle[dq.name], budget),
              f"{dq.name} (budget {budget}) disagrees with the oracle")
        queries.append(query_record(dq, budget, res, lat, oracle[dq.name]))
    check(launches > 0, "the main path launched no fused_frontier kernel")
    check(launches == inner,
          f"fused_frontier launches {launches} != summed EvalResult.n_iters {inner}")
    emit("path", nodes=pg.graph.n_nodes, edges=pg.graph.n_edges,
         node_pad=pg.node_pad, ell_width=pg.ell_width, host_setup_s=t_setup,
         oracle_s=t_oracle, max_memory_allocated=peak,
         host_peak_rss_kib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
         fused_frontier_launches=launches, eval_inner_iters=inner,
         frontier_append_launches=appends, evaluator_calls=ev.calls,
         queries=queries)
    return launches, sess, oracle, served


def phase_sni(pg, sess) -> dict:
    """label_histogram and frontier_expand on the path's own data: every
    partition's SNI seed for every query's start predicate, and one real
    binding batch per (query, partition) — the partition's fresh start
    bindings — matched by frontier_expand and by the fused kernel."""
    from repro_torch.core import build_catalog, generate_plan
    from repro_torch.core.engine import plan_to_device
    from repro_torch.core.plan import PlanArrays
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import value_pred

    dqs, _ = path_runs(pg)
    cat = build_catalog(pg.graph)
    plans = [generate_plan(dq.disjuncts[0], pg.graph, cat) for dq in dqs]
    store, owner = sess.store, sess.store.owner
    entries = [store.get(p) for p in range(pg.k)]
    cores = [(torch.arange(pg.node_pad, device="cuda") < e.part["n_core"]).int()
             for e in entries]
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    counts, matches = [], []
    for dq, plan in zip(dqs, plans):
        pa = plan_to_device(PlanArrays.from_plan(plan, pad_steps=12), "cuda")
        got = torch.stack([
            ops.label_histogram(e.part["node_label"], e.part["node_value"], core,
                                plan.start_label, plan.start_value_op,
                                plan.start_value)
            for e, core in zip(entries, cores)]).tolist()
        want = pg.start_label_counts(plan.start_label, plan.start_value_op,
                                     plan.start_value).tolist()
        check(got == want, f"{dq.name}: SNI seeds {got} != start_label_counts {want}")
        counts.append({"query": dq.name, "sni": got})
        for e, core in zip(entries, cores):
            # the partition's fresh start bindings, as the evaluator seeds them
            part = e.part
            start = (core.bool()
                     & ((pa.start_label == -1) | (part["node_label"] == pa.start_label))
                     & value_pred(pa.start_value_op, part["node_value"], pa.start_value))
            idx = torch.nonzero(start)[:, 0][:512]
            if idx.numel() == 0:
                continue
            EB = idx.numel()
            rows = torch.full((EB, 8), -1, dtype=torch.int32, device="cuda")
            rows[:, plan.start_slot] = part["node_gid"][idx]
            step = torch.zeros(EB, dtype=torch.int32, device="cuda")
            m = torch.ones(EB, dtype=torch.bool, device="cuda")
            fg = rows[:, int(pa.src_slot[0])]      # step 0's frontier vertex
            lidx = torch.where(fg >= 0, e.g2l[fg.clamp(min=0).long()], -1)
            tables = [part[k] for k in ("ell_dst", "ell_label", "ell_dir",
                                        "ell_dlab", "ell_dval", "ell_dgid")]
            ok, dg = ops.frontier_expand(rows, step, lidx, m, *tables, pa,
                                         plan.n_steps)
            fok, fdg, *_ = ops.fused_frontier(rows, step, lidx, m, *tables,
                                              e.g2l, owner, part["n_core"], pa,
                                              plan.n_steps)
            check(torch.equal(ok, fok) and torch.equal(dg, fdg),
                  f"{dq.name} pid {part['pid']}: frontier_expand != fused ok/dg")
            matches.append({"query": dq.name, "pid": part["pid"], "EB": EB,
                            "n_ok": int(ok.sum())})
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("label_histogram", "frontier_expand",
                                               "fused_frontier")}
    check(launches["label_histogram"] > 0 and launches["frontier_expand"] > 0,
          f"the sni phase launched no new kernel: {launches}")
    check(any(r["n_ok"] for r in matches), "no real binding matched an edge")
    emit("sni", seeds=counts, matches=matches, launches=launches)
    return launches


def phase_traditional(pg, oracle) -> tuple:
    from repro_torch.core import EngineConfig, GraphSession
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    sess = GraphSession(pg=pg, engine="traditional", processors=2,
                        heuristic="max-sn", config=EngineConfig(cap=16384),
                        device="cuda")
    _, runs = path_runs(pg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    with EvaluatorCalls() as ev:
        served = serve(sess, runs)
    launches = build.LAUNCHES[NAME]
    loops = sess.engine.batched_iters
    appends = check_appends("traditional", loops, ev.calls)
    queries = []
    for dq, budget, res, lat in served:
        check(verify(res, oracle[dq.name], budget),
              f"traditional {dq.name} (budget {budget}) disagrees with the oracle")
        queries.append(query_record(dq, budget, res, lat, oracle[dq.name]))
    check(launches > 0, "the traditional path launched no fused_frontier kernel")
    check(launches == loops,
          f"traditional: fused_frontier launches {launches} != batched loops {loops}")
    emit("traditional", processors=2, fused_frontier_launches=launches,
         batched_iters=loops, frontier_append_launches=appends,
         evaluator_calls=ev.calls, max_memory_allocated=torch.cuda.max_memory_allocated(),
         queries=queries)
    return sess, served


def phase_shared(sessions, oracle, isolated) -> None:
    """submit_many of the path's queries on each session; answers must equal
    the per-query results and the oracle."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    out = {}
    for name, sess in sessions.items():
        dqs = [dq for dq, _, _, _ in isolated[name]]
        budgets = [b for _, b, _, _ in isolated[name]]
        loops0 = sess.engine.batched_iters
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with EvaluatorCalls() as ev:
            report = sess.submit_many(dqs, max_answers=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = build.LAUNCHES[NAME]
        loops = sess.engine.batched_iters - loops0
        appends = check_appends(f"shared {name}", loops, ev.calls)
        for res, (dq, budget, single, _) in zip(report.results, isolated[name]):
            check(verify(res, oracle[dq.name], budget),
                  f"shared {name} {dq.name} disagrees with the oracle")
            if budget is None:
                check(np.array_equal(res.answers, single.answers),
                      f"shared {name} {dq.name} differs from its submit")
        check(launches > 0 and launches == loops,
              f"shared {name}: fused_frontier launches {launches} != batched loops {loops}")
        n_isolated = sum(single.n_loads for _, _, single, _ in isolated[name])
        out[name] = {"wall_s": wall, "loads": report.loads,
                     "batch_sizes": report.batch_sizes,
                     "loads_per_query": report.loads_per_query,
                     "isolated_loads": n_isolated,
                     "isolated_loads_per_query": n_isolated / len(dqs),
                     "isolated_latency_sum_s": sum(lat for *_, lat in isolated[name]),
                     "cold_loads": report.load_stats.cold_loads,
                     "warm_loads": report.load_stats.warm_loads,
                     "fused_frontier_launches": launches, "batched_iters": loops,
                     "frontier_append_launches": appends, "evaluator_calls": ev.calls,
                     "queries": [{"query": r.name, "n_answers": r.n_answers,
                                  "latency_s": r.latency_s, "n_loads": r.n_loads}
                                 for r in report.results]}
    emit("shared", **out)


def phase_mapreduce(pg, oracle) -> tuple:
    """MapReduceMP on the path's graph: the path's runs and Q4 again
    (warm), the gated Q5 and the sequential drain, every answer checked
    against the path phase's oracle."""
    from repro_torch.core import (EngineConfig, GraphSession, MapReduceMPEngine,
                                  generate_plan)
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    cfg = EngineConfig(cap=MR_CAP)
    sess = GraphSession(pg=pg, engine="mapreduce", heuristic="max-sn",
                        config=cfg, device="cuda")
    dqs, runs = path_runs(pg)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()    # the earlier sessions' data
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    it0 = sess.engine.batched_iters
    served = serve(sess, runs + [(dqs[0], None)])
    launches = build.LAUNCHES[NAME]
    iters = sum(res.reports[0].extra["n_iterations"] for _, _, res, _ in served)
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "the mapreduce path launched no fused_frontier kernel")
    check(iters == sess.engine.batched_iters - it0,
          f"mapreduce: summed n_iterations {iters} != engine count")
    # one launch per shard an iteration: the default mesh is one shard of
    # four lanes on one card
    shards = len(sess.engine.mesh.shards)
    check(launches == iters * shards,
          f"mapreduce: fused_frontier launches {launches} != summed iterations "
          f"{iters} x {shards} shards")
    # MapReduceMP keeps its own appends (append_faa, place)
    check(build.LAUNCHES["frontier_append"] == 0,
          "mapreduce launched frontier_append")
    queries = []
    for dq, budget, res, lat in served:
        check(verify(res, oracle[dq.name], budget),
              f"mapreduce {dq.name} (budget {budget}) disagrees with the oracle")
        extra = res.reports[0].extra
        rec = query_record(dq, budget, res, lat, oracle[dq.name])
        # with no overflow each lane's completed rows are its FAA fill
        rec.update(faa_fill=extra["completed_from"].tolist(), faa_cap=cfg.cap,
                   spawned_from=extra["spawned_from"].tolist())
        queries.append(rec)

    # Q5 with two of the four mappers expanding per iteration, MAX-YIELD
    q5 = dqs[1]
    gated = MapReduceMPEngine(pg, cfg, m_limit=2, heuristic="max-yield",
                              store=sess.store)
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gated.run(generate_plan(q5.disjuncts[0], pg.graph, sess.catalog))
    torch.cuda.synchronize()
    gated_rec = {"query": q5.name, "m_limit": 2, "heuristic": "max-yield",
                 "latency_s": time.perf_counter() - t0,
                 "n_iterations": res.n_iterations, "n_answers": int(res.answers.shape[0]),
                 "completed_from": res.completed_from.tolist(),
                 "spawned_from": res.spawned_from.tolist(),
                 "loads": mesh_loads(res.stats),
                 "fused_frontier_launches": build.LAUNCHES[NAME]}
    check(np.array_equal(res.answers, oracle[q5.name]),
          "mapreduce m_limit=2 max-yield Q5 disagrees with the oracle")
    check(gated_rec["fused_frontier_launches"] == res.n_iterations * shards,
          f"gated mapreduce: launches != iterations x shards: {gated_rec}")

    # submit_many drains the same runs one query at a time
    budgets = [b for _, b in runs]
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    report = sess.submit_many([dq for dq, _ in runs], max_answers=budgets)
    torch.cuda.synchronize()
    drain_wall = time.perf_counter() - t0
    drain_iters = sum(r.reports[0].extra["n_iterations"] for r in report.results)
    for r, (dq, budget, single, _) in zip(report.results, served):
        check(np.array_equal(r.answers, single.answers)
              and r.reports[0].extra["n_iterations"]
              == single.reports[0].extra["n_iterations"],
              f"mapreduce submit_many {dq.name} differs from its submit")
    check(build.LAUNCHES[NAME] == drain_iters * shards,
          f"mapreduce submit_many: launches {build.LAUNCHES[NAME]} != iterations "
          f"{drain_iters} x {shards} shards")
    emit("mapreduce", P=pg.k, cap=cfg.cap, quota=sess.engine.quota,
         mesh=str(sess.engine.mesh),
         fused_frontier_launches=launches, iterations=iters,
         cold_latency_s=served[0][3], warm_latency_s=served[-1][3],
         max_memory_allocated=peak, resident_before_bytes=resident,
         queries=queries, gated=gated_rec,
         submit_many={"wall_s": drain_wall, "shared": report.shared,
                      "iterations": drain_iters,
                      "fused_frontier_launches": build.LAUNCHES[NAME],
                      "cold_loads": report.load_stats.cold_loads,
                      "warm_loads": report.load_stats.warm_loads})
    return launches, sess, served, (res, gated_rec)


MESH_ROUNDS = 5     # warm Q5 rounds per mesh in the mesh phase


def mesh_loads(st) -> list:
    """A MapReduceMP run's load counts: cold, warm, bytes staged cold."""
    return [st.cold_loads, st.warm_loads, st.bytes_cold]


def mesh_record(res) -> tuple:
    """What the mesh phase holds equal across meshes: answers, iterations,
    yield counters and loads of one served query."""
    x = res.reports[0].extra
    return (res.answers.tobytes(), x["n_iterations"], x["completed_from"].tolist(),
            x["spawned_from"].tolist(), mesh_loads(res.reports[0].stats))


def sync_all() -> None:
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def phase_mesh(pg, oracle, one, served, gated) -> int:
    """MapReduceMP on multi-shard part meshes: four one-mapper shards on
    cuda:0, two shards of two on cuda:0, and the mappers spread over
    distinct cards when there are two or more.  Each serves the path's
    runs and the gated m_limit=2 MAX-YIELD Q5 on a fresh session, held to
    the mapreduce phase's session on the default mesh (``one``,
    ``served``, ``gated``; one shard on one card) on every field and to
    the oracle; then warm Q5 on the mesh and on ``one`` in turns.
    Returns the step's launches."""
    from repro_torch.core import (GraphSession, MapReduceMPEngine, generate_plan,
                                  make_part_mesh)
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    t_phase = time.perf_counter()
    cfg = one.config
    dqs, runs = path_runs(pg)
    q5 = dqs[1]
    meshes = {"4x1": make_part_mesh(4, devices=["cuda:0"] * 4),
              "2x2": make_part_mesh(4, devices=["cuda:0"] * 2)}
    if torch.cuda.device_count() >= 2:
        meshes["cards"] = make_part_mesh(4)
    gated_res, gated_rec = gated
    total, out = 0, {}
    for name, mesh in meshes.items():
        sync_all()
        for d in mesh.devices:
            torch.cuda.reset_peak_memory_stats(d)
        sess = GraphSession(pg=pg, engine="mapreduce", heuristic="max-sn",
                            config=cfg, device="cuda", mesh=mesh)
        build.LAUNCHES.clear()
        got = serve(sess, runs)
        sync_all()
        launches = build.LAUNCHES[NAME]
        iters = sum(res.reports[0].extra["n_iterations"] for _, _, res, _ in got)
        shards = len(mesh.shards)
        check(launches == iters * shards > 0,
              f"mesh {name}: fused_frontier launches {launches} != "
              f"{iters} iterations x {shards} shards")
        for (dq, budget, res, _), (_, _, want, _) in zip(got, served):
            check(verify(res, oracle[dq.name], budget),
                  f"mesh {name} {dq.name} (budget {budget}) disagrees with the oracle")
            check(mesh_record(res) == mesh_record(want),
                  f"mesh {name} {dq.name} (budget {budget}) differs from one shard")
        gated_eng = MapReduceMPEngine(pg, cfg, m_limit=2, heuristic="max-yield",
                                      store=sess.store, mesh=mesh)
        build.LAUNCHES.clear()
        gres = gated_eng.run(generate_plan(q5.disjuncts[0], pg.graph, sess.catalog))
        sync_all()
        check(np.array_equal(gres.answers, oracle[q5.name])
              and np.array_equal(gres.answers, gated_res.answers)
              and gres.n_iterations == gated_rec["n_iterations"]
              and gres.completed_from.tolist() == gated_rec["completed_from"]
              and gres.spawned_from.tolist() == gated_rec["spawned_from"]
              and mesh_loads(gres.stats) == gated_rec["loads"],
              f"mesh {name}: gated max-yield Q5 differs from one shard")
        check(build.LAUNCHES[NAME] == gres.n_iterations * shards,
              f"mesh {name}: gated launches {build.LAUNCHES[NAME]} != iterations x shards")
        launches += build.LAUNCHES[NAME]
        peaks = {str(d): torch.cuda.max_memory_allocated(d) for d in mesh.devices}
        # warm Q5 on the default mesh (one shard on one card) and on the
        # mesh, in turns
        warm = warm_rounds({"default": one, "mesh": sess}, q5, MESH_ROUNDS)
        total += launches
        out[name] = {"mesh": str(mesh), "shards": shards, "lanes": list(mesh.lanes),
                     "devices": [str(d) for d in mesh.devices],
                     "peer_access": mesh.peer_access(),
                     "iterations": iters, "fused_frontier_launches": launches,
                     "gated_iterations": gres.n_iterations,
                     "shuffle_bytes_per_iteration": sess.engine.shuffle_bytes(),
                     "warm_q5_s": warm["mesh"]["median_s"],
                     "warm_q5_default_s": warm["default"]["median_s"],
                     "warm_q5": warm,
                     "max_memory_allocated": peaks,
                     "queries": [{"query": dq.name, "max_answers": b,
                                  "iterations": res.reports[0].extra["n_iterations"],
                                  "latency_s": t} for dq, b, res, t in got]}
        del sess, gated_eng
        gc.collect()
        torch.cuda.empty_cache()
    emit("mesh", device_count=torch.cuda.device_count(), meshes_run=list(meshes),
         default_mesh=str(one.engine.mesh),
         distinct_cards=len(meshes) > 2, meshes=out,
         added_s=time.perf_counter() - t_phase)
    return total



def mesh_alone(scale: float = 200.0, seed: int = 0) -> None:
    """The build, the path's graph and oracle, then the mapreduce and mesh
    phases alone: ``python -c "import chip_smoke as c; c.mesh_alone()"``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.oracle import match_disjunctive
    from repro_torch.kernels import build
    build.build_all()
    pg = phase_graph(scale, seed)
    dqs, _ = path_runs(pg)
    oracle = {dq.name: match_disjunctive(pg.graph, dq, q_pad=8) for dq in dqs}
    _, sess, served, gated = phase_mapreduce(pg, oracle)
    phase_mesh(pg, oracle, sess, served, gated)

def phase_cli(workdir: Path) -> None:
    """The port's serving CLI in this process, as a user runs it: in RAM on
    two engines, then a save, out-of-core serving from it on two engines,
    and a repartition from a saved profile."""
    import contextlib
    import io
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME
    from repro_torch.launch import serve as cli

    gdir, profile = workdir / "cli-graph", workdir / "cli-profile.json"
    prom, trace = workdir / "cli-metrics.prom", workdir / "cli-trace.json"
    base = ["--dataset", "synthetic", "--scale", "20", "--verify"]
    runs = [("mapreduce", ["--engine", "mapreduce"]),
            ("opat", ["--engine", "opat", "--metrics-out", str(prom),
                      "--trace-out", str(trace)]),
            ("opat_save", ["--engine", "opat", "--save-graph", str(gdir),
                           "--profile-json", str(profile)]),
            ("opat_graph_dir", ["--engine", "opat", "--graph-dir", str(gdir),
                                "--host-cache-parts", "1"]),
            ("mapreduce_graph_dir", ["--engine", "mapreduce", "--graph-dir", str(gdir),
                                     "--host-cache-parts", "1"]),
            ("opat_repartition", ["--engine", "opat", "--repartition-from",
                                  str(profile)])]
    out = {}
    for name, argv in runs:
        text = io.StringIO()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = cli.main(base + argv)
        lines = text.getvalue().splitlines()
        verdicts = [ln.split()[-1] for ln in lines if "oracle:" in ln]
        check(rc == 0 and len(verdicts) == 3 and set(verdicts) == {"MATCH"},
              f"cli {name}: rc {rc}, verdicts {verdicts}: {lines[-8:]}")
        check(build.LAUNCHES[NAME] > 0, f"cli {name} launched no kernel")
        if "--graph-dir" in argv:
            check(any(ln.startswith("[serve] disk tier:") for ln in lines),
                  f"cli {name}: no disk tier line")
        if "--repartition-from" in argv:
            check(any("repartitioned from" in ln for ln in lines),
                  f"cli {name}: no repartition line")
        if "--metrics-out" in argv:
            check(prom.is_file() and trace.is_file(),
                  f"cli {name}: --metrics-out / --trace-out wrote no file")
            check(not prom_problems(prom.read_text()), f"cli {name}: bad Prometheus file")
            checked = trace_report(trace, "--check")
            check(checked.returncode == 0, f"cli {name}: trace_report --check: "
                                           f"{checked.stderr[-2000:]}")
        out[name] = {"rc": rc, "argv": argv, "verdicts": verdicts,
                     "seconds": time.perf_counter() - t0,
                     "fused_frontier_launches": build.LAUNCHES[NAME],
                     "output": lines}
    emit("cli", scale=20, **out)


def engine_loops(engine) -> int:
    """Step launches the engine has made: its single-partition and batched
    evaluator loops, or MapReduceMP's iterations x shards (the iterations
    on one card)."""
    return getattr(engine, "inner_iters", 0) + getattr(engine, "step_launches",
                                                       engine.batched_iters)


def warm_rounds(sessions, dq, rounds: int = 12) -> dict:
    """Warm latency of one query on each session, on the host clock, in
    ``rounds`` rounds that rotate which session goes first (the spread of
    each, and how many rounds each later session beat the first)."""
    names = list(sessions)
    lat = {n: [] for n in names}
    loops0 = {n: engine_loops(s.engine) for n, s in sessions.items()}
    for r in range(rounds):
        k = r % len(names)
        for n in names[k:] + names[:k]:
            lat[n] += [t for *_, t in serve(sessions[n], [(dq, None)])]
    out = {n: {"warm_latency_s": v, "median_s": float(np.median(v)),
               "quartiles_s": [float(q) for q in np.percentile(v, [25, 75])],
               "loops_per_query": (engine_loops(sessions[n].engine) - loops0[n]) // rounds}
           for n, v in lat.items()}
    first = names[0]
    for n in names[1:]:
        out[f"rounds_{n}_faster"] = sum(b < a for a, b in zip(lat[first], lat[n]))
    out["rounds"] = rounds
    return out


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def device_events(events) -> list:
    """The device's kernels, copies and sets in a Chrome trace."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_ms(dev) -> float:
    """Milliseconds in which at least one of the device events ran."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (busy_us + hi - lo) / 1e3


def profile_query(sess, dq, engine: str) -> dict:
    """One warm query under torch.profiler: the device's busy and idle
    share of the query's wall time, device time by kernel name (read from
    the exported Chrome trace), host time by op, and the host's kernel
    launches per evaluator loop; before it, one unprofiled warm run gives
    the query's peak device memory."""
    from torch.profiler import ProfilerActivity, profile
    out = ROOT / "chiprun_out" / f"profile_{engine}_{dq.name}.json"
    out.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sess.submit(dq)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    loops0 = engine_loops(sess.engine)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.submit(dq)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    loops = engine_loops(sess.engine) - loops0
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    dev = device_events(events)
    check(bool(dev), "the profiler recorded no device activity")
    by_name: dict = {}
    for e in dev:
        d = by_name.setdefault(e["name"][:90], [0.0, 0])
        d[0] += e["dur"] / 1e3
        d[1] += 1
    # device time of the kernels inside each annotated range of the loop
    # (MapReduceMP's "mapreduce.map" and "mapreduce.shuffle")
    ranges: dict = {}
    for a in events:
        if a.get("cat") == "gpu_user_annotation" and a.get("ph") == "X":
            r = ranges.setdefault(a["name"], {"calls": 0, "device_ms": 0.0})
            r["calls"] += 1
            r["device_ms"] += sum(e["dur"] for e in dev if a["ts"] <= e["ts"]
                                  and e["ts"] + e["dur"] <= a["ts"] + a["dur"]) / 1e3
    busy_us = busy_ms(dev) * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    ours = [v for n, v in by_name.items() if "frontier_step" in n]
    averages = prof.key_averages()
    launches = sum(e.count for e in averages if e.key in LAUNCH_CALLS)
    kernels = sum(e.get("cat") == "kernel" for e in dev)
    host = sorted(averages, key=lambda e: -e.self_cpu_time_total)[:10]
    return dict(query=dq.name, wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
         device_idle_share=1.0 - busy_us / 1e3 / wall_ms, device_events=len(dev),
         loops=loops, host_kernel_launches=launches,
         host_launches_per_loop=launches / max(loops, 1),
         device_kernels=kernels, device_kernels_per_loop=kernels / max(loops, 1),
         max_memory_allocated=peak, resident_before_bytes=resident,
         device_ms_by_range=ranges,
         fused_frontier_ms=sum(v[0] for v in ours),
         fused_frontier_count=sum(v[1] for v in ours),
         kernels_by_device_time=[{"name": n, "ms": v[0], "count": v[1]}
                                 for n, v in top],
         host_ops_by_self_cpu_time=[{"name": e.key, "ms": e.self_cpu_time_total / 1e3,
                                     "count": e.count} for e in host])


def phase_profile(sessions, dq) -> None:
    emit("profile", warm=warm_rounds(sessions, dq),
         **{name: profile_query(sess, dq, name) for name, sess in sessions.items()})


# ---------------------------------------------------------------------------
# metrics: the resource profiler and the metrics registry on the path
# ---------------------------------------------------------------------------

PROM_SAMPLE = re.compile(r"[A-Za-z_:][A-Za-z0-9_:]*(\{[^{}]*\})? \S+")
COST_ATTRS = ("kernel_key", "cost_flops", "cost_bytes", "cost_t_bound_us",
              "cost_dominant", "launches", "device_live_bytes")


def prom_problems(text: str) -> list:
    """The lines of a Prometheus text file, comments aside, that do not
    parse as ``name{labels} value``."""
    bad = []
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        try:
            float(ln.rsplit(" ", 1)[1])
        except (ValueError, IndexError):
            bad.append(ln)
            continue
        if not PROM_SAMPLE.fullmatch(ln):
            bad.append(ln)
    return bad


def trace_report(path: Path, flag: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(ROOT / "tools" / "trace_report.py"),
                           str(path), flag], capture_output=True, text=True,
                          timeout=300)


def same_run(a, b) -> bool:
    """Two runs of one query: equal answers, loads and iterations."""
    return (np.array_equal(a.answers, b.answers)
            and [s.loads for s in a.stats] == [s.loads for s in b.stats]
            and [s.iterations for s in a.stats] == [s.iterations for s in b.stats])


def cost_by_key(spans) -> dict:
    """Per kernel key, over its kernel.eval spans: calls, step launches,
    summed wall time and summed predicted bound, and their ratio (the
    step's roofline share of the calls' wall time), all calls and the
    calls after each key's first."""
    out: dict = {}
    for sp in spans:
        a = sp.attrs
        r = out.setdefault(a["kernel_key"], {
            "calls": 0, "launches": 0, "wall_us": 0.0, "bound_us": 0.0,
            "steady_calls": 0, "steady_wall_us": 0.0, "steady_bound_us": 0.0,
            "dominant": a["cost_dominant"]})
        wall = (sp.t1 - sp.t0) * 1e6
        r["calls"] += 1
        r["launches"] += a["launches"]
        r["wall_us"] += wall
        r["bound_us"] += a["cost_t_bound_us"]
        if not a.get("first_call"):
            r["steady_calls"] += 1
            r["steady_wall_us"] += wall
            r["steady_bound_us"] += a["cost_t_bound_us"]
    for r in out.values():
        r["roofline_share"] = r["bound_us"] / r["wall_us"]
        r["steady_roofline_share"] = (r["steady_bound_us"] / r["steady_wall_us"]
                                      if r["steady_calls"] else None)
    return out


def phase_metrics(pg, sessions, served, workdir: Path) -> int:
    """Profiling changes no result, costs every span, and exports: one
    Tracer over profiled OPAT, TraditionalMP and MapReduceMP sessions on
    the path's graph, each serving the path's runs and then submit_many,
    held to the unprofiled sessions of the earlier phases; every
    kernel.eval span costed; the trace accepted by tools/trace_report.py
    (its --cost table printed); peak device bytes against the allocator's;
    each session's Prometheus file parsed; warm Q5 with profiling on
    against off.  Returns the step's launches in the profiled runs."""
    from repro_torch.core import GraphSession
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME
    from repro_torch.obs import (MetricsRegistry, Tracer, ingest_schedule,
                                 ingest_session, resource_profile_snapshot,
                                 to_prometheus_text, write_chrome_trace)

    tracer = Tracer()
    prof = {name: GraphSession(pg=pg, engine=name, heuristic="max-sn", processors=2,
                               config=s.config, catalog=s.catalog, device="cuda",
                               tracer=tracer)
            for name, s in sessions.items()}
    _, runs = path_runs(pg)
    budgets = [b for _, b in runs]
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    reports = {}
    for name, sess in prof.items():
        for (dq, budget, res, _), (_, _, want, _) in zip(serve(sess, runs), served[name]):
            check(same_run(res, want),
                  f"profiled {name} {dq.name} (budget {budget}) differs from unprofiled")
        report = sess.submit_many([dq for dq, _ in runs], max_answers=budgets)
        for res, (dq, budget, want, _) in zip(report.results, served[name]):
            check(budget is not None or np.array_equal(res.answers, want.answers),
                  f"profiled {name} submit_many {dq.name} differs from its submit")
        if name in RECORD["shared"]:
            shared = RECORD["shared"][name]
            check(report.loads == shared["loads"]
                  and report.batch_sizes == shared["batch_sizes"],
                  f"profiled {name} submit_many loads differ from the shared phase")
        reports[name] = report
    torch.cuda.synchronize()
    launches = build.LAUNCHES[NAME]
    allocator_peak = torch.cuda.max_memory_allocated()

    loops = sum(engine_loops(s.engine) for s in prof.values())
    stamped = sum(sp.attrs.get("launches", 0) for sp in tracer.spans
                  if sp.name == "kernel.eval")
    check(stamped == loops, f"metrics: the spans stamp {stamped} step launches, "
                            f"the evaluators ran {loops} loops")
    check(launches == loops > 0,
          f"metrics: fused_frontier launches {launches} != evaluator loops {loops}")
    peaks = {name: s.profiler.peak_device_bytes for name, s in prof.items()}
    check(all(0 < p <= allocator_peak for p in peaks.values()),
          f"peak device bytes {peaks} against max_memory_allocated {allocator_peak}")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prom = {}
    for name, sess in prof.items():
        reg = MetricsRegistry()
        ingest_session(reg, sess)
        ingest_schedule(reg, reports[name].loads, reports[name].batch_sizes)
        text = to_prometheus_text(reg)
        (out_dir / f"metrics_{name}.prom").write_text(text)
        bad = prom_problems(text)
        check(not bad, f"{name}: Prometheus lines that do not parse: {bad[:5]}")
        prom[name] = {"lines": len(text.splitlines()),
                      "samples": sum(not ln.startswith("#") for ln in text.splitlines())}

    # warm Q5 on OPAT, profiling off (the path's session) against on, in
    # turns: off, on, on, off, ...
    q5 = runs[1]
    lat = {"off": [], "on": []}
    for r in range(12):
        for which in (("off", "on") if r % 2 == 0 else ("on", "off")):
            sess = sessions["opat"] if which == "off" else prof["opat"]
            lat[which] += [t for *_, t in serve(sess, [q5])]
    overhead = {k: {"median_s": float(np.median(v)), "latency_s": v} for k, v in lat.items()}
    overhead["on_over_off"] = overhead["on"]["median_s"] / overhead["off"]["median_s"]

    spans = [sp for sp in tracer.spans if sp.name == "kernel.eval"]
    for sp in spans:
        missing = [k for k in COST_ATTRS if k not in sp.attrs]
        check(not missing and "cost_error" not in sp.attrs,
              f"kernel.eval span not costed: missing {missing}, {sp.attrs}")
    trace_path = workdir / "metrics_trace.json"
    write_chrome_trace(tracer, str(trace_path))
    checked = trace_report(trace_path, "--check")
    check(checked.returncode == 0,
          f"trace_report --check failed: {checked.stdout} {checked.stderr[-2000:]}")
    table = trace_report(trace_path, "--cost")
    check(table.returncode == 0 and "attribution failed" not in table.stdout,
          f"trace_report --cost: {table.stdout} {table.stderr[-2000:]}")
    print(table.stdout, end="", flush=True)
    emit("metrics", fused_frontier_launches=launches, kernel_eval_spans=len(spans),
         spans=len(tracer.spans), cost_by_key=cost_by_key(spans),
         trace_report_check=checked.stdout.strip(),
         trace_report_cost=table.stdout.splitlines(),
         peak_device_bytes=peaks, max_memory_allocated=allocator_peak,
         memory_allocated=torch.cuda.memory_allocated(),
         profile={name: resource_profile_snapshot(s) for name, s in prof.items()},
         prometheus=prom, warm_q5_profiling=overhead)
    return launches


# ---------------------------------------------------------------------------
# out of core: the disk tier under the store, and repartitioning
# ---------------------------------------------------------------------------

def same_entry(entry, shard) -> bool:
    """A device StoreEntry equals a shard's (part, g2l) numpy bundle byte
    for byte (NaN payloads included)."""
    part, g2l = shard
    for k, v in part.items():
        got = entry.part[k]
        if isinstance(got, int):
            if got != int(v):
                return False
        elif got.cpu().numpy().tobytes() != np.ascontiguousarray(v).tobytes():
            return False
    return entry.g2l.cpu().numpy().tobytes() == np.ascontiguousarray(g2l).tobytes()


def opened_store(gdir, host_parts: int, dev: str = "cuda"):
    from repro_torch.core import PartitionStore
    from repro_torch.storage import DiskCatalog, OutOfCorePartitionedGraph
    cat = DiskCatalog(str(gdir))
    return cat, PartitionStore(OutOfCorePartitionedGraph(cat), backing=cat,
                               host_cache_parts=host_parts, device=dev)


def evict_under_copy(gdir, a: int, b: int, sleep_cycles: int) -> dict:
    """A host tier of one partition: ``prefetch(a)`` copies a's pinned
    bundle on the store's side stream, queued behind a spin kernel;
    ``get(b)`` at once evicts a's bundle (its pinned memory freed while the
    copy has not run) and reads and pins b's; ``get(a)`` must still equal
    a's shard, and b's entry b's."""
    cat, store = opened_store(gdir, 1)
    store.host_tier.get(a)
    with torch.cuda.stream(store._copy_stream):
        torch.cuda._sleep(sleep_cycles)
    issued = store.prefetch(a)
    eb = store.get(b)
    in_flight = not store._cache[a].ready.query()
    evicted = not store.host_tier.resident(a)
    ea = store.get(a)
    torch.cuda.synchronize()
    return {"prefetch_issued": issued, "a_evicted": evicted,
            "copy_in_flight_at_eviction": in_flight,
            "a_equal": same_entry(ea, cat.read_part(a)),
            "b_equal": same_entry(eb, cat.read_part(b)),
            "prefetch_hits": store.stats.prefetch_hits}


def read_ahead_pinned(gdir, pid: int) -> dict:
    """``prefetch(pid)`` of a partition not in host RAM issues a read-ahead
    whose worker thread reads, verifies and pins the shard; the ``get``
    that joins it copies on the current stream, bit-equal to the shard."""
    cat, store = opened_store(gdir, 2)
    issued = store.prefetch(pid)
    slot = store.host_tier._cache[pid]
    slot.thread.join()
    b = slot.bundle
    pinned = all(t.is_pinned() for t in (*[v for v in b.part.values()
                                             if isinstance(v, torch.Tensor)], b.g2l))
    entry = store.get(pid)
    torch.cuda.synchronize()
    return {"read_ahead_issued": issued, "worker": slot.thread.name,
            "pinned_on_worker": pinned, "equal": same_entry(entry, cat.read_part(pid)),
            "read_ahead_hits": store.stats.read_ahead_hits,
            "device_copy_on_prefetch": store.stats.prefetch_issued}


def opened_small(gdir, dev: str) -> list:
    """An opened OPAT session (device and host tiers of one partition) on
    the subgen queries and Q4 under K=5: per run (query, answers, loads,
    iterations, LoadStats), and every run's residency validated."""
    from repro_torch.core import EngineConfig, GraphSession, validate_run_residency
    from repro_torch.data.generators import subgen_queries
    sess = GraphSession.open(str(gdir), engine="opat", cache_parts=1,
                             host_cache_parts=1, config=EngineConfig(cap=16384),
                             device=dev)
    qs = subgen_queries(sess.graph)
    out = []
    for dq, budget in [(dq, None) for dq in qs] + [(qs[0], 5)]:
        res = sess.submit(dq, max_answers=budget)
        st = res.reports[0].stats
        check(validate_run_residency(st) is not None, f"{dq.name}: no residency")
        out.append((dq.name, res.answers, st.loads, st.iterations,
                    res.load_stats.to_dict()))
    return out


def same_opened(a, b) -> bool:
    return len(a) == len(b) and all(
        x[0] == y[0] and np.array_equal(x[1], y[1]) and x[2:] == y[2:]
        for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# mutable graphs: generation views, the owner table per view, compaction
# ---------------------------------------------------------------------------

def edges_at(g, x: int) -> list:
    """(u, v, label, directed) of every edge at vertex ``x``."""
    src, dst = np.asarray(g.edge_src), np.asarray(g.edge_dst)
    lab, dr = np.asarray(g.edge_label), np.asarray(g.edge_directed)
    return [(int(src[i]), int(dst[i]), g.edge_vocab.str_of(int(lab[i])), bool(dr[i]))
            for i in np.flatnonzero((src == x) | (dst == x))]


def clone_ops(g, assignment, answers) -> list:
    """Updates that add a clone of a vertex bound in ``answers[0]`` (its
    label, value, partition and every edge it has): wherever the original
    answers, so does the clone, whose gid is the graph's next one."""
    V = int(g.n_nodes)
    x = int(answers[0][answers[0] >= 0][-1])
    ops = [{"op": "vertex_add", "label": g.node_vocab.str_of(int(g.node_label[x])),
            "value": float(g.node_value[x]), "pid": int(assignment[x])}]
    for u, v, lab, d in edges_at(g, x):
        ops.append({"op": "edge_add", "u": V if u == x else u,
                    "v": V if v == x else v, "label": lab, "directed": d})
    return ops


def widen_ops(g, ell_width: int) -> list:
    """Edges at the highest-degree vertex until its degree is
    ``ell_width`` (the current width) plus two, so the next view's width
    grows past it."""
    deg = g.degree_view()
    hub = int(np.argmax(deg))
    lab = g.edge_vocab.str_of(0)
    others = [v for v in range(int(g.n_nodes)) if v != hub][:ell_width - int(deg[hub]) + 2]
    return [{"op": "edge_add", "u": hub, "v": int(v), "label": lab} for v in others]


def mixed_ops(g, rng, n: int) -> list:
    """``n`` updates cycling through edge_add, edge_del, vertex_add and
    vertex_del, drawn from ``g`` so that every one applies in order (no
    edge touches a vertex the batch deletes)."""
    from repro_torch.storage.deltas import DELETED_LABEL
    del_id = g.node_vocab.get(DELETED_LABEL, -10)
    alive = np.flatnonzero(np.asarray(g.node_label) != del_id)
    victims = [int(v) for v in rng.choice(alive, size=n // 4 + 1, replace=False)]
    keep = np.setdiff1d(alive, victims)
    src, dst, elab = (np.asarray(a) for a in (g.edge_src, g.edge_dst, g.edge_label))
    ops = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            u, v = rng.choice(keep, size=2, replace=False)
            lab = g.edge_vocab.str_of(int(elab[int(rng.integers(0, g.n_edges))]))
            ops.append({"op": "edge_add", "u": int(u), "v": int(v), "label": lab})
        elif kind == 1:
            e = int(rng.integers(0, g.n_edges))
            ops.append({"op": "edge_del", "u": int(src[e]), "v": int(dst[e]),
                        "label": g.edge_vocab.str_of(int(elab[e]))})
        elif kind == 2:
            s = int(rng.choice(keep))
            ops.append({"op": "vertex_add", "label": g.node_vocab.str_of(int(g.node_label[s])),
                        "value": float(g.node_value[s])})
        else:
            ops.append({"op": "vertex_del", "u": victims.pop()})
    return ops


def view_step_check(sess, gid: int, answers, EB: int = 512) -> dict:
    """One frontier-step launch under the session's view, against the plain
    version on the same inputs.  The bindings are Q4's answers that bind
    ``gid`` (a vertex added in the session), each cut back to the plan
    step that binds ``gid`` (its slots bound before that step, its
    frontier vertex core in one partition); so the step must match the
    edge to ``gid`` and look up the view's [V] g2l row and owner table at
    ``gid``, past the opened V.  Rows of that partition's other answers
    fill the batch."""
    from repro_torch.core import generate_plan
    from repro_torch.core.engine import _ELL_TABLES, plan_to_device
    from repro_torch.core.plan import PlanArrays
    from repro_torch.data.generators import subgen_queries
    from repro_torch.kernels import fused_frontier as ff, ops
    store, cfg, view = sess.store, sess.config, sess.current_view
    dev = store.device
    plan = generate_plan(subgen_queries(sess.graph)[0].disjuncts[0], sess.graph,
                         sess.catalog)
    src = [st.src_slot for st in plan.steps]
    dst = [st.dst_slot for st in plan.steps]

    def cut(r):
        """(partial row, step, frontier vertex) binding r's first new slot
        that holds gid, else its last step."""
        hit = [t for t in range(len(dst)) if r[dst[t]] == gid]
        t = hit[0] if hit else len(dst) - 1
        bound = {plan.start_slot, *dst[:t]}
        row = np.where(np.isin(np.arange(len(r)), list(bound)), r, -1)
        return row, t, int(r[src[t]])

    cuts = [cut(r) for r in answers]
    with_gid = [c for c, r in zip(cuts, answers) if (r == gid).any()]
    check(bool(with_gid), f"no answer binds the added vertex {gid}")
    pid = int(view.assignment[with_gid[0][2]])
    chosen = [c for c in with_gid if int(view.assignment[c[2]]) == pid]
    chosen += [c for c in cuts if int(view.assignment[c[2]]) == pid
               and not any(np.array_equal(c[0], x[0]) for x in chosen)]
    chosen = chosen[:EB]
    with store.viewing(view):
        entry, owner = store.get(pid), store.owner
    part = entry.part
    pa = plan_to_device(PlanArrays.from_plan(plan, pad_steps=cfg.s_pad), dev)
    n = len(chosen)
    rows = np.full((1, n + 1, cfg.q_pad), -1, np.int32)
    rows[0, :n, :answers.shape[1]] = np.stack([c[0] for c in chosen])
    steps = np.zeros((1, n + 1), np.int32)
    steps[0, :n] = [c[1] for c in chosen]
    fg = torch.tensor([c[2] for c in chosen], device=dev).long()
    lidx = entry.g2l[fg][None].int().contiguous()
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    sel = torch.arange(n, device=dev)[None]
    m = torch.ones((1, n), dtype=torch.bool, device=dev)
    inv = ops.step_invariants([part[k] for k in _ELL_TABLES], entry.g2l, owner, pa,
                              0, int(part["n_core"]), plan.n_steps)
    out = ff.step_outputs(1, n, part["ell_dst"].shape[1], cfg.q_pad, dev)
    got = ff.frontier_step(inv, t(rows), t(steps), lidx, sel, m, out)
    want = ff.frontier_step_plain(inv, t(rows), t(steps), lidx, sel, m)
    rec = compare_step(got, want)
    rec.update(pid=pid, gid=gid, bindings=n, bindings_reaching_gid=len(with_gid),
               V=int(owner.shape[0]), g2l_len=int(entry.g2l.shape[0]),
               view_nodes=int(sess.graph.n_nodes),
               ell_width=int(part["ell_dst"].shape[1]),
               matched_added=int((got.dg[got.ok] == gid).sum()),
               owner_of_added=int(owner[gid]))
    return rec


def mutated_small(gdir, dev: str) -> dict:
    """A copy of a small graph directory opened on ``dev`` (OPAT, device
    and host tiers of one and two partitions): clone a vertex bound in
    Q4's answers, widen the ELL width, serve the queries on the stale
    view, then on the compacted one, and check the step kernel under the
    view.  Every answer equals the oracle over the view's overlay graph."""
    from repro_torch.core import EngineConfig, GraphSession
    from repro_torch.core.oracle import match_disjunctive
    from repro_torch.data.generators import subgen_queries
    work = Path(str(gdir) + f"-mutated-{dev}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(gdir, work)
    sess = GraphSession.open(str(work), engine="opat", cache_parts=1,
                             host_cache_parts=2, config=EngineConfig(cap=16384),
                             device=dev)
    # read-aheads land at once, so the card and the CPU count the same:
    # whether a stale bundle is still in flight at its get decides whether
    # the get counts a delta overlay again, in both packages
    tier = sess.store.host_tier
    issue = tier.read_ahead

    def landed(*args, **kwargs):
        issued = issue(*args, **kwargs)
        for t in list(tier._workers):
            t.join()
        return issued
    tier.read_ahead = landed
    V0, W0 = sess.graph.n_nodes, sess.pg.ell_width
    qs = subgen_queries(sess.graph)
    want = match_disjunctive(sess.graph, qs[0], q_pad=8)
    sess.mutate(clone_ops(sess.graph, sess.pg.assignment, want)
                + widen_ops(sess.graph, W0))
    runs = []
    for stage in ("stale", "compacted"):
        for dq in qs:
            res = sess.submit(dq)
            check(np.array_equal(res.answers, match_disjunctive(sess.graph, dq, q_pad=8)),
                  f"mutated {dev} {stage} {dq.name} disagrees with the oracle")
            st = res.reports[0].stats
            runs.append((stage, dq.name, res.answers, st.loads, st.iterations,
                         res.load_stats.to_dict(), res.generation))
        if stage == "stale":
            step = view_step_check(sess, V0, match_disjunctive(sess.graph, qs[0], q_pad=8))
            sess.compact_all()
    shutil.rmtree(work, ignore_errors=True)
    return {"runs": runs, "V0": V0, "W0": W0, "W": sess.pg.ell_width, "step": step}


def same_mutated(a, b) -> bool:
    return len(a["runs"]) == len(b["runs"]) and all(
        x[:2] == y[:2] and np.array_equal(x[2], y[2]) and x[3:] == y[3:]
        for x, y in zip(a["runs"], b["runs"]))


def two_generations(gdir, dev: str) -> dict:
    """A scheduler pinned to generation G admits Q4; the session then adds
    a vertex that answers Q4 and compacts its partition (G+1).  Both
    generations of that partition are then device-resident at once, and
    each view answers as the oracle over its own graph."""
    from repro_torch.core import EngineConfig, GraphSession
    from repro_torch.core.oracle import match_disjunctive
    from repro_torch.data.generators import subgen_queries
    work = Path(str(gdir) + f"-generations-{dev}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(gdir, work)
    sess = GraphSession.open(str(work), engine="opat", config=EngineConfig(cap=16384),
                             device=dev)
    q4 = subgen_queries(sess.graph)[0]
    sched = sess.scheduler()
    sched.admit(q4)
    old_graph = sched.view.graph
    first = sess.submit(q4)                    # G resident
    ops = clone_ops(sess.graph, sess.pg.assignment, first.answers)
    pid = ops[0]["pid"]
    sess.mutate(ops)
    sess.compact(pid)
    new = sess.submit(q4)
    old = sched.run().results[0]
    sched.close()
    out = {"old_generation": old.generation, "new_generation": new.generation,
           "resident_stagings": len(sess.store._cache_keys_for(pid)),
           "old_equal": bool(np.array_equal(old.answers,
                                            match_disjunctive(old_graph, q4, q_pad=8))),
           "new_equal": bool(np.array_equal(new.answers,
                                            match_disjunctive(sess.graph, q4, q_pad=8))),
           "answers_differ": not np.array_equal(old.answers, new.answers),
           "old": old.answers, "new": new.answers}
    shutil.rmtree(work, ignore_errors=True)
    return out


def cold_load_split(gdir, pid: int) -> dict:
    """One partition's cold load, step by step as the store's disk tier
    takes it: the shard's pages dropped from the page cache (fsync, then
    POSIX_FADV_DONTNEED), the read (np.load), the sha256 of every array
    against the manifest, the pin into page-locked tensors, and the copy to
    the card (CUDA events).  The read is timed again with the pages hot."""
    from repro_torch.storage import DiskCatalog, array_checksum
    from repro_torch.storage.host_cache import host_bundle
    cat = DiskCatalog(str(gdir), verify_checksums=False)
    path = cat.shard_path(pid)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    t0 = time.perf_counter()
    part, g2l = cat.read_part(pid)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cat.part_meta(pid)["checksums"]
    ok = all(array_checksum(a) == want[k] for k, a in {**part, "g2l": g2l}.items())
    t_sum = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = host_bundle(part, g2l, pin=True)
    t_pin = time.perf_counter() - t0
    tensors = [v for v in bundle.part.values() if isinstance(v, torch.Tensor)] + [bundle.g2l]
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    dev = [t.to("cuda", non_blocking=True) for t in tensors]
    e1.record()
    torch.cuda.synchronize()
    copy_ms = e0.elapsed_time(e1)
    check(ok and all(torch.equal(d.cpu().view(torch.uint8), t.view(torch.uint8))
                     for d, t in zip(dev, tensors)), "cold load: checksum or copy differs")
    t0 = time.perf_counter()
    cat.read_part(pid)
    t_hot = time.perf_counter() - t0
    return {"pid": pid, "file_bytes": os.path.getsize(path), "bundle_bytes": bundle.nbytes,
            "read_s": t_read, "read_hot_s": t_hot, "checksum_s": t_sum, "pin_s": t_pin,
            "copy_ms": copy_ms, "copy_gb_s": bundle.nbytes / copy_ms / 1e6,
            "total_s": t_read + t_sum + t_pin + copy_ms / 1e3}


def cold_warm(sess, dq) -> dict:
    """Q5 twice on a fresh session: its first (cold) and second latency."""
    served = serve(sess, [(dq, None), (dq, None)])
    return {"cold_s": served[0][3], "warm_s": served[1][3],
            "cold_loads": served[0][2].load_stats.to_dict(),
            "warm_loads": served[1][2].load_stats.to_dict()}


def phase_ooc(pg, sess, oracle, workdir: Path) -> int:
    """The path's graph served out of core on all three engines."""
    from repro_torch.core import EngineConfig, GraphSession, validate_run_residency
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    gdir = workdir / "ooc-graph"
    t0 = time.perf_counter()
    manifest = sess.save(str(gdir))
    t_save = time.perf_counter() - t0
    part_bytes = [p["nbytes"] for p in manifest["partitions"]]
    split = cold_load_split(gdir, 0)
    evict = evict_under_copy(gdir, 0, 1, sleep_cycles=3_000_000_000)
    check(evict["prefetch_issued"] and evict["a_evicted"] and evict["a_equal"]
          and evict["b_equal"] and evict["prefetch_hits"] == 1,
          f"evict under an in-flight copy: {evict}")
    ahead = read_ahead_pinned(gdir, 2)
    check(ahead["read_ahead_issued"] and ahead["pinned_on_worker"] and ahead["equal"]
          and ahead["read_ahead_hits"] == 1 and ahead["device_copy_on_prefetch"] == 0,
          f"read-ahead pinned on its worker: {ahead}")
    gc.collect()

    dqs, runs = path_runs(pg)
    runs = runs + [(dqs[1], None)]
    cfg = EngineConfig(cap=16384)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    engines, launches = {}, 0
    for engine in ("opat", "traditional", "mapreduce"):
        t0 = time.perf_counter()
        osess = GraphSession.open(str(gdir), engine=engine, processors=2,
                                  heuristic="max-sn", cache_parts=1,
                                  host_cache_parts=2, config=cfg, device="cuda")
        t_open = time.perf_counter() - t0
        check(osess.out_of_core and osess.generation == manifest["generation"],
              f"{engine}: not opened out of core")
        n0 = build.LAUNCHES[NAME]
        served = serve(osess, runs)
        n = build.LAUNCHES[NAME] - n0
        loops = engine_loops(osess.engine)
        queries = []
        for dq, budget, res, lat in served:
            check(verify(res, oracle[dq.name], budget),
                  f"ooc {engine} {dq.name} (budget {budget}) disagrees with the oracle")
            if engine == "opat":
                validate_run_residency(res.reports[0].stats)
            rec = query_record(dq, budget, res, lat, oracle[dq.name])
            rec.update(disk_reads=res.load_stats.disk_reads,
                       read_ahead_hits=res.load_stats.read_ahead_hits,
                       bytes_disk=res.load_stats.bytes_disk,
                       host_evictions=res.load_stats.host_evictions)
            queries.append(rec)
        st = osess.load_stats
        peak_host = osess.store.host_tier.peak_nbytes
        check(n > 0 and n == loops,
              f"ooc {engine}: fused_frontier launches {n} != evaluator loops {loops}")
        check(st.disk_reads > 0, f"ooc {engine}: no disk read")
        check(engine != "opat" or st.read_ahead_hits > 0, "ooc opat: no read-ahead hit")
        check(peak_host <= 2 * max(part_bytes),
              f"ooc {engine}: host tier held {peak_host} B > two partitions")
        engines[engine] = {"open_s": t_open, "fused_frontier_launches": n,
                           "evaluator_loops": loops, "cache": st.to_dict(),
                           "host_tier_peak_bytes": peak_host, "queries": queries}
        launches += n
        osess.store.close()
        del osess, served
        gc.collect()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # cold and warm Q5: opened with unbounded tiers, against in RAM
    from repro_torch.core import GraphSession as Session
    build.LAUNCHES.clear()
    q5 = dqs[1]
    fresh = {"in_ram": Session(pg=pg, engine="opat", config=cfg, device="cuda"),
             "opened": Session.open(str(gdir), engine="opat", config=cfg, device="cuda")}
    latency = {name: cold_warm(s, q5) for name, s in fresh.items()}
    launches += build.LAUNCHES[NAME]
    for s in fresh.values():
        s.store.close()
    del fresh
    gc.collect()
    emit("ooc", graph_dir_bytes=sum(f.stat().st_size for f in gdir.iterdir()),
         partition_bytes=part_bytes, save_s=t_save, cold_load_split=split,
         evict_under_copy=evict, read_ahead_pinned=ahead, engines=engines,
         q5_cold_warm=latency, resident_before_bytes=resident,
         max_memory_allocated=peak, fused_frontier_launches=launches)
    return launches


def phase_repartition(pg, sess, oracle) -> int:
    """Repartition the path phase's OPAT session with the profile it has
    served, then Q4 and Q5 again on the new layout."""
    from repro_torch.core import partition_quality
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    profile = sess.workload_profile()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    info = sess.repartition(profile)
    t_host = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    q = partition_quality(sess.graph, sess.pg.assignment, sess.k)
    dqs, _ = path_runs(sess.pg)
    build.LAUNCHES.clear()
    sess.engine.inner_iters = 0
    served = serve(sess, [(dqs[0], None), (dqs[1], None)])
    n = build.LAUNCHES[NAME]
    queries = []
    for dq, budget, res, lat in served:
        check(verify(res, oracle[dq.name], budget),
              f"repartitioned {dq.name} disagrees with the oracle")
        queries.append(query_record(dq, budget, res, lat, oracle[dq.name]))
    check(n > 0 and n == sess.engine.inner_iters,
          f"repartition: launches {n} != loops {sess.engine.inner_iters}")
    emit("repartition", profile_queries=profile["queries_served"], summary=info,
         sizes=q["sizes"], host_s=t_host, memory_allocated_before=before,
         memory_allocated_after_rebind=after, fused_frontier_launches=n,
         queries=queries)
    return n


def frontend_requests(serving, runs, repeats: int) -> list:
    """The path's runs ``repeats`` times over, classes round-robin over
    interactive / batch / exhaustive, every arrival at once."""
    classes = ("interactive", "batch", "exhaustive")
    return [serving.Request(dq, slo_class=classes[i % 3], max_answers=budget)
            for i, (dq, budget) in enumerate(runs * repeats)]


def check_outcomes(rep, oracle, tag: str) -> None:
    """Every served answer is the oracle's under its effective budget,
    every shed carries a reason, and the counters sum to the arrivals."""
    c = rep.counters
    check(c["served"] + c.get("shed", 0) == c["arrived"] == len(rep.outcomes),
          f"frontend {tag}: counters {c} do not sum to {len(rep.outcomes)}")
    for o in rep.outcomes:
        if o.status == "shed":
            check(bool(o.shed_reason), f"frontend {tag}: {o.name} shed without a reason")
        else:
            check(verify(o.result, oracle[o.name], o.max_answers),
                  f"frontend {tag} {o.name} (budget {o.max_answers}) disagrees "
                  f"with the oracle")


def phase_frontend(sessions, oracle, pg) -> int:
    """The SLO front end on the in-RAM sessions of the path (OPAT),
    traditional and mapreduce phases: with no classes it equals
    submit_many; under the default classes with instant replay every
    decision is checked against the oracle; then OPAT under real-time
    replay with the batch class overloaded, per class latency, deadline
    attainment and burn rate, and the cost model's rates on this card."""
    from repro_torch import serving
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    _, runs = path_runs(pg)
    dqs, budgets = [dq for dq, _ in runs], [b for _, b in runs]
    out, launches = {}, 0
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    loops0 = {n: engine_loops(s.engine) for n, s in sessions.items()}
    for name, sess in sessions.items():
        plain = sess.frontend(slo_classes=[]).serve(
            [serving.Request(dq, max_answers=b) for dq, b in runs])
        many = sess.submit_many(dqs, max_answers=budgets)
        for o, r in zip(plain.outcomes, many.results):
            check(np.array_equal(o.result.answers, r.answers),
                  f"frontend {name}: no-SLO {o.name} differs from submit_many")
        check(plain.schedule.loads == many.loads,
              f"frontend {name}: no-SLO loads differ from submit_many")
        t0 = time.perf_counter()
        fe = sess.frontend(replay_speed=0.0)
        rep = fe.serve(frontend_requests(serving, runs, 4))
        torch.cuda.synchronize()
        check_outcomes(rep, oracle, f"{name} instant")
        out[name] = {"no_slo_loads": many.loads, "instant": {
            "wall_s": time.perf_counter() - t0, "counters": rep.counters,
            "shed_by_reason": rep.shed_by_reason, "rounds": rep.rounds,
            "outcomes": [{"query": o.name, "class": o.slo_class, "status": o.status,
                          "degraded": o.degraded, "deferred": o.deferred,
                          "max_answers": o.max_answers, "shed_reason": o.shed_reason,
                          "predicted_s": o.predicted_latency_s, "latency_s": o.latency_s}
                         for o in rep.outcomes],
            "cost_model": fe.cost_model.snapshot()}}
    torch.cuda.synchronize()
    loops = sum(engine_loops(s.engine) - loops0[n] for n, s in sessions.items())
    launches = build.LAUNCHES[NAME]
    check(launches > 0 and launches == loops,
          f"frontend: fused_frontier launches {launches} != evaluator loops {loops}")

    # real-time replay on OPAT, warm and calibrated by the instant run:
    # 48 arrivals 20 ms apart, three of every four in the batch class
    sess = sessions["opat"]
    calibrated = sess.frontend(replay_speed=0.0)
    calibrated.serve(frontend_requests(serving, runs, 2))
    classes = ("interactive", "batch", "batch", "batch")
    reqs = [serving.Request(dq, slo_class=classes[i % 4], max_answers=b,
                            arrival_s=0.02 * i)
            for i, (dq, b) in enumerate(runs * 12)]
    fe = sess.frontend(cost_model=calibrated.cost_model, replay_speed=1.0)
    build.LAUNCHES.clear()
    loops0 = engine_loops(sess.engine)
    t0 = time.perf_counter()
    rep = fe.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_outcomes(rep, oracle, "opat replay")
    n = build.LAUNCHES[NAME]
    check(n > 0 and n == engine_loops(sess.engine) - loops0,
          f"frontend replay: launches {n} != evaluator loops")
    launches += n
    met = {}
    for o in rep.served:
        if o.deadline_met is not None:
            met.setdefault(o.slo_class, []).append(o.deadline_met)
    out["replay"] = {
        "speed": 1.0, "arrivals": len(reqs), "spacing_s": 0.02, "wall_s": wall,
        "counters": rep.counters, "shed_by_reason": rep.shed_by_reason,
        "rounds": rep.rounds, "per_class": rep.per_class,
        "deadline_attainment": {c: sum(v) / len(v) for c, v in met.items()},
        "slo_burn": rep.slo_burn, "cost_model": fe.cost_model.snapshot(),
        "reference_prior_s_per_unit": serving.CostModel(pg).default_rate_s,
        "serving_profile": sess.workload_profile()["serving"]}
    emit("frontend", fused_frontier_launches=launches, **out)
    return launches


def phase_mutation(pg, workdir: Path) -> int:
    """The ooc phase's graph directory opened mutable (OPAT, one device and
    two host partitions): a soak of updates in three bursts (a clone of a
    vertex bound in Q4's answers with its edges; all four kinds of update;
    edges that widen the ELL width), each followed by a query checked
    against the oracle over its own overlay graph; a scheduler pinned to
    that generation while compact_hot publishes the next, its answers the
    pinned graph's; Q5 on the stale view against after compact_all;
    TraditionalMP and MapReduceMP on the final generation."""
    from repro_torch.core import EngineConfig, GraphSession
    from repro_torch.core.oracle import match_disjunctive
    from repro_torch.data.generators import subgen_queries
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME
    from repro_torch.storage import deltas

    gdir = workdir / "ooc-graph"
    cfg = EngineConfig(cap=16384)
    # time every overlay rebuild (build_partitions over the overlay graph)
    rebuilds = []
    build_partitions = deltas.build_partitions

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        got = build_partitions(*a, **kw)
        rebuilds.append(time.perf_counter() - t0)
        return got
    deltas.build_partitions = timed_build
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    compare_launches = 0
    try:
        t0 = time.perf_counter()
        sess = GraphSession.open(str(gdir), engine="opat", heuristic="max-sn",
                                 cache_parts=1, host_cache_parts=2, config=cfg,
                                 device="cuda")
        t_open = time.perf_counter() - t0
        V0, W0, gen0 = sess.graph.n_nodes, sess.pg.ell_width, sess.generation
        dqs = subgen_queries(sess.graph)
        oracle0 = match_disjunctive(sess.graph, dqs[0], q_pad=8)
        rng = np.random.default_rng(0)
        bursts = []

        def burst(name, ops, dq):
            t1 = time.perf_counter()
            sess.mutate(ops)
            t_mutate = time.perf_counter() - t1
            served = serve(sess, [(dq, None)])[0]
            t2 = time.perf_counter()
            want = match_disjunctive(sess.graph, dq, q_pad=8)
            t_oracle = time.perf_counter() - t2
            res = served[2]
            check(np.array_equal(res.answers, want),
                  f"mutation {name}: {dq.name} disagrees with the oracle of its view")
            rec = {"burst": name, "deltas": len(ops),
                   "kinds": sorted({d["op"] for d in ops}), "mutate_s": t_mutate,
                   "host_s_per_delta": t_mutate / len(ops), "query": dq.name,
                   "latency_s": served[3], "n_answers": res.n_answers,
                   "generation": res.generation, "loads": res.reports[0].stats.loads,
                   "delta_overlays": res.load_stats.delta_overlays,
                   "disk_reads": res.load_stats.disk_reads, "oracle_s": t_oracle,
                   "stale_pids": sorted(sess.current_view.stale_pids),
                   "ell_width": sess.pg.ell_width, "node_pad": sess.pg.node_pad}
            bursts.append(rec)
            return res, want

        res, _ = burst("clone", clone_ops(sess.graph, sess.pg.assignment, oracle0), dqs[0])
        check(bool((res.answers >= V0).any()),
              "no oracle-checked answer binds the vertex added in the session")
        added_rows = int((res.answers >= V0).any(axis=1).sum())
        n0 = build.LAUNCHES[NAME]
        step = view_step_check(sess, V0, res.answers)
        compare_launches += build.LAUNCHES[NAME] - n0
        check(step["mismatches"] == 0 and step["max_abs_err"] == 0
              and step["V"] == step["view_nodes"] == step["g2l_len"] > V0
              and step["matched_added"] > 0, f"step under the view: {step}")
        burst("mixed", mixed_ops(sess.graph, rng, 12), dqs[2])
        _, want_q5 = burst("widen", widen_ops(sess.graph, sess.pg.ell_width), dqs[1])
        check(sess.pg.ell_width > W0,
              f"ELL width {sess.pg.ell_width} did not grow past the manifest's {W0}")
        n_deltas = sum(b["deltas"] for b in bursts)
        kinds = set().union(*(b["kinds"] for b in bursts))
        check(n_deltas >= 16 and len(kinds) == 4, f"soak: {n_deltas} deltas, {kinds}")

        # Q5 on the stale view (its stale partitions rebuilt from the
        # overlay), a scheduler pinned to this generation, then compact_hot
        q5 = dqs[1]
        want = {q5.name: want_q5,
                dqs[0].name: match_disjunctive(sess.graph, dqs[0], q_pad=8)}
        sess.store.close()                     # both tiers cold
        stale = serve(sess, [(q5, None)])[0]
        check(np.array_equal(stale[2].answers, want[q5.name]), "stale Q5 disagrees")
        sched = sess.scheduler()
        sched.admit(dqs[0])
        pinned_gen, pinned_files = sched.view.generation, sched.view.files()
        pending = int(sess._mdir.pending_counts().sum())
        t1 = time.perf_counter()
        hot = sess.compact_hot()
        t_hot = time.perf_counter() - t1
        check(hot and sess.generation > pinned_gen, f"compact_hot published nothing: {hot}")
        check(all((gdir / f).exists() for f in pinned_files),
              "a pinned generation's file was collected")
        old = sched.run().results[0]
        check(old.generation == pinned_gen and np.array_equal(old.answers, want[dqs[0].name]),
              "the pinned scheduler's Q4 disagrees with its generation's oracle")
        live = sess._mdir.catalog
        superseded = pinned_files - ({p["shard"] for p in live.manifest["partitions"]}
                                     | {live.graph_file})
        sched.close()
        sess._mdir.gc()
        check(superseded and not any((gdir / f).exists() for f in superseded),
              "superseded files survived after the pin was released")
        t1 = time.perf_counter()
        sess.compact_all()
        t_all = time.perf_counter() - t1
        sess.store.close()
        compacted = serve(sess, [(q5, None), (q5, None)])
        for r in compacted:
            check(np.array_equal(r[2].answers, want[q5.name]), "compacted Q5 disagrees")
        opat_loops = engine_loops(sess.engine)
        final_gen = sess.generation
        sess.store.close()
        del sess, sched
        gc.collect()

        # TraditionalMP and MapReduceMP on the final generation
        others = {}
        for engine in ("traditional", "mapreduce"):
            osess = GraphSession.open(str(gdir), engine=engine, processors=2,
                                      heuristic="max-sn", cache_parts=1,
                                      host_cache_parts=2, config=cfg, device="cuda")
            check(osess.generation == final_gen, f"{engine}: generation {osess.generation}")
            r = serve(osess, [(dqs[0], None)])[0]
            check(np.array_equal(r[2].answers, want[dqs[0].name]), f"{engine} Q4 disagrees")
            others[engine] = {"latency_s": r[3], "n_answers": r[2].n_answers,
                              "loops": engine_loops(osess.engine),
                              "disk_reads": r[2].load_stats.disk_reads}
            osess.store.close()
            del osess
            gc.collect()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        deltas.build_partitions = build_partitions
    launches = build.LAUNCHES[NAME] - compare_launches
    loops = opat_loops + sum(o["loops"] for o in others.values())
    check(launches > 0 and launches == loops,
          f"mutation: fused_frontier launches {launches} != evaluator loops {loops}")
    emit("mutation", open_s=t_open, V0=V0, ell_width0=W0, generation0=gen0,
         bursts=bursts, deltas=n_deltas, answers_binding_added=added_rows,
         step_under_view=step, overlay_rebuild_s=rebuilds,
         stale_q5={"latency_s": stale[3], "loads": stale[2].reports[0].stats.loads,
                   "delta_overlays": stale[2].load_stats.delta_overlays},
         pinned={"generation": pinned_gen, "pending": pending,
                 "superseded_files": sorted(superseded)},
         compact_hot={"pids": hot, "seconds": t_hot,
                      "s_per_partition": t_hot / len(hot)},
         compact_all_s=t_all, final_generation=final_gen,
         compacted_q5={"cold_s": compacted[0][3], "warm_s": compacted[1][3],
                       "loads": compacted[0][2].reports[0].stats.loads},
         others=others, resident_before_bytes=resident, max_memory_allocated=peak,
         peak_over_resident_bytes=peak - resident,
         fused_frontier_launches=launches, evaluator_loops=loops,
         compare_launches=compare_launches)
    return launches


# ---------------------------------------------------------------------------
# lm: the language-model serving stack (prefill and decode), which reaches
# no hand-written kernel: the reference computes it outside Pallas
# ---------------------------------------------------------------------------

# Card against CPU, float32 with TF32 off: cuBLAS and the CPU's BLAS sum
# in different orders, and the reduced configs' sharp random-init
# attention (see lm_qwen2_consistency) amplifies that through the layers
# (9.9e-5 of the largest logit on recurrentgemma's seven layers, NVIDIA
# H100 80GB HBM3 at 700 W), so a tensor agrees to LM_RTOL and LM_ATOL
# times its largest magnitude; the conv states are rounded to bf16 in
# both, so they may move one bf16 ulp (2^-8 relative).
LM_RTOL, LM_ATOL, LM_CONV_RTOL = 1e-4, 1e-3, 2.0 ** -7
# Qwen2-1.5B at full depth, float32 on the card: prefill against forward
# and decode against forward differ in chunking and summation order only,
# so with wq and wk at fan-in d (see lm_qwen2_consistency) the relations
# hold to LM_CONSIST of the largest logit.
LM_CONSIST = 1e-4
# every other published config, at its published width: (layers kept,
# batch, prompt length).  The layers are the fewest that hold each of the
# config's block kinds.
LM_CUTS = {
    "qwen1_5_110b": (2, 4, 1024),
    "qwen3_4b": (2, 4, 1024),
    "granite_3_2b": (2, 4, 1024),
    "deepseek_moe_16b": (2, 4, 1024),         # the dense head layer + one MoE layer
    "granite_moe_1b_a400m": (2, 4, 1024),
    "musicgen_medium": (2, 4, 1024),          # frame embeddings
    "llava_next_mistral_7b": (2, 4, 1024),    # 512 image positions
    "xlstm_125m": (12, 4, 512),               # whole: m, m, m, s x 3
    "recurrentgemma_9b": (3, 2, 4096),        # one period r, r, local; past the window
}
LM_DECODE = 8
# Qwen2-1.5B's bf16 serving: batch, prompt length, greedy tokens
LM_SERVE = (8, 2048, 32)


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def lm_err(got, want) -> float:
    """max |got - want| over want's largest magnitude (finite entries)."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    fin = torch.isfinite(w)
    check(torch.equal(fin, torch.isfinite(g)), "a non-finite entry moved")
    if not fin.any():
        return 0.0
    scale = max(float(w[fin].abs().max()), 1e-30)
    return float((g[fin] - w[fin]).abs().max()) / scale


def lm_close(got, want, rtol: float, atol: float) -> bool:
    """|got - want| <= atol * max|want| + rtol * |want|, where finite."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    fin = torch.isfinite(w)
    if not torch.equal(fin, torch.isfinite(g)):
        return False
    scale = float(w[fin].abs().max()) if fin.any() else 0.0
    return bool(((g[fin] - w[fin]).abs() <= atol * scale + rtol * w[fin].abs()).all())


def lm_next_input(cfg, B: int, seed: int, dev):
    """One decode input: a token, or a frame embedding for the audio family."""
    from repro_torch.configs.registry import ShapeSpec, concrete_batch
    return concrete_batch(cfg, ShapeSpec("next", "decode", 1, B), seed, device=dev)


def lm_extend(cfg, batch: dict, nxt: dict) -> dict:
    """The prompt with the decode input appended."""
    if "frame_embeds" in nxt:
        return {"frame_embeds": torch.cat([batch["frame_embeds"],
                                           nxt["frame_embeds"][:, None]], dim=1)}
    return dict(batch, tokens=torch.cat([batch["tokens"], nxt["token"][:, None]], dim=1))


def lm_card_against_cpu(aid: str, seed: int, S: int = 64, B: int = 2) -> dict:
    """A reduced config (float32) on the card and on the CPU from the same
    weights and inputs: ``forward`` over the prompt extended by one
    position, ``prefill``, and ``decode_step`` on the CPU's prefill caches
    grown by one.  Every logit and every cache leaf agrees within LM_RTOL
    and LM_ATOL."""
    import copy
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.registry import ShapeSpec, concrete_batch
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.serving import decode_step, prefill
    from repro_torch.serving.decode import grow_caches
    cfg = reduced(ARCHS[aid])
    cpu = init_params(cfg, seed, device="cpu")
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}
    batch = concrete_batch(cfg, ShapeSpec("lm", "prefill", S, B), seed, device="cpu")
    nxt = lm_next_input(cfg, B, seed + 1, "cpu")
    ext = lm_extend(cfg, batch, nxt)
    out = {}
    for dev, model in models.items():
        logits, aux = forward(model, cfg, {k: v.to(dev) for k, v in ext.items()})
        last, caches = prefill(model, cfg, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = {"logits": logits, "aux": aux, "last": last, "caches": caches}
    # decode on both from the CPU's prefill caches grown by one (a conv
    # state one bf16 ulp apart would otherwise carry into the decode)
    grown = grow_caches(cfg, out["cpu"]["caches"], 1)
    for dev, model in models.items():
        caches = [{k: v.to(dev, copy=True) for k, v in c.items()} for c in grown]
        out[dev]["dlogits"], out[dev]["dcaches"] = decode_step(
            model, cfg, caches, {k: v.to(dev) for k, v in nxt.items()}, S)
    errs, bad = {}, []
    for key in ("logits", "aux", "last", "dlogits"):
        g, w = out["cuda"][key], out["cpu"][key]
        errs[key] = lm_err(g, w)
        if not lm_close(g, w, LM_RTOL, LM_ATOL):
            bad.append(key)
    for key in ("caches", "dcaches"):
        worst = 0.0
        for li, (gc_, wc) in enumerate(zip(out["cuda"][key], out["cpu"][key])):
            for name, w in wc.items():
                g = gc_[name]
                if g.shape != w.shape or g.dtype != w.dtype:
                    bad.append(f"{key}[{li}].{name} {tuple(g.shape)} {g.dtype}")
                    continue
                worst = max(worst, lm_err(g, w))
                rtol = LM_CONV_RTOL if name == "conv" else LM_RTOL
                if not lm_close(g, w, rtol, LM_ATOL):
                    bad.append(f"{key}[{li}].{name}")
        errs[key] = worst
    check(not bad, f"lm {aid}: card and CPU disagree on {bad} ({errs})")
    del models, out
    free_cuda()
    return errs


def lm_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def lm_cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches for t in c.values())


def lm_profile_step(step, name: str) -> dict:
    """One decode step under torch.profiler: host kernel launches, device
    kernels, and the device's busy and idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    out = ROOT / "chiprun_out" / f"profile_lm_{name}.json"
    out.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(out))
    dev = device_events(json.loads(out.read_text())["traceEvents"])
    check(bool(dev), "the profiler recorded no device activity")
    busy = busy_ms(dev)
    launches = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
    return {"wall_ms": wall_ms, "host_kernel_launches": launches,
            "device_kernels": sum(e.get("cat") == "kernel" for e in dev),
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms}


def lm_relations(model, cfg, toks) -> dict:
    """prefill's last logits against forward's last position over the
    511-token prompts; decode_step at pos 511 on the caches grown by one
    against forward over the 512 tokens; cache shapes and dtypes before and
    after the decode.  Errors are over the largest forward logit."""
    from repro_torch.models.transformer import forward
    from repro_torch.serving import decode_step, prefill
    from repro_torch.serving.decode import grow_caches
    prompt = {"tokens": toks[:, :511]}
    f511 = forward(model, cfg, prompt)[0][:, -1]
    last, caches = prefill(model, cfg, prompt)
    f512 = forward(model, cfg, {"tokens": toks})[0][:, -1]
    caches = grow_caches(cfg, caches, 1)
    before = [{k: (tuple(v.shape), v.dtype) for k, v in c.items()} for c in caches]
    dl, caches = decode_step(model, cfg, caches, {"token": toks[:, 511]}, 511)
    after = [{k: (tuple(v.shape), v.dtype) for k, v in c.items()} for c in caches]
    check(before == after, "qwen2: the decode changed a cache's shape or dtype")
    check(bool(torch.isfinite(dl).all() and torch.isfinite(last).all()), "qwen2: non-finite")
    return {"prefill_vs_forward": lm_err(last, f511), "decode_vs_forward": lm_err(dl, f512),
            "max_abs_logit": float(f512.abs().max()),
            "argmax_equal_decode": int((dl.argmax(-1) == f512.argmax(-1)).sum())}


def lm_qwen2_consistency(seed: int) -> dict:
    """Qwen2-1.5B, the published config at full depth in float32, B = 4
    prompts of 511 tokens from the token pipeline: ``lm_relations`` on
    init_params' weights (recorded), then with every wq and wk rescaled
    from the reference's fan-in to fan-in d (checked to LM_CONSIST).  The
    reference's ``_dense`` draws wq [d, H, hd] with s = 1/sqrt(H), which
    makes random-init attention nearly one-hot; float32 rounding
    differences then grow about 2x a layer, and over 28 layers the
    reference's own decode differs from its forward by 0.13 of the largest
    logit (reduced width, on the CPU).  At fan-in d it is 5e-7."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(ARCHS["qwen2_1_5b"], param_dtype="float32",
                              compute_dtype="float32")
    model = init_params(cfg, seed, device="cuda")
    toks = torch.from_numpy(TokenPipeline(vocab=cfg.vocab, batch=4, seq=512,
                                          seed=seed).batch_at(0)["tokens"]).to("cuda")
    rec = {"n_params": sum(p.numel() for p in model.parameters()),
           "param_bytes": lm_bytes(model), "layers": cfg.n_layers, "batch": 4,
           "prompt": 511, "tolerance": LM_CONSIST,
           "reference_init": lm_relations(model, cfg, toks)}
    check(rec["n_params"] == cfg.n_params(), "qwen2: parameter count")
    qk_fan_in_d(cfg, model)
    rec["qk_fan_in_d"] = soft = lm_relations(model, cfg, toks)
    check(soft["prefill_vs_forward"] <= LM_CONSIST, f"qwen2: prefill against forward {rec}")
    check(soft["decode_vs_forward"] <= LM_CONSIST, f"qwen2: decode against forward {rec}")
    del model
    free_cuda()
    return rec


def qk_fan_in_d(cfg, model) -> None:
    """Rescale every wq and wk from the reference's ``_dense`` fan-in (H,
    Hkv) to fan-in d, in place (see lm_qwen2_consistency)."""
    with torch.no_grad():
        for blk in model.layers:
            if hasattr(blk, "wq"):
                blk.wq.mul_((cfg.n_heads / cfg.d_model) ** 0.5)
                blk.wk.mul_((cfg.n_kv_heads / cfg.d_model) ** 0.5)


def lm_serve(aid: str, cfg, B: int, S: int, new: int, seed: int, *,
             warm: bool = False, profile_name: str = "") -> dict:
    """A config in bf16 on the card: prefill B prompts of S positions, grow
    the caches, greedy-decode ``new`` tokens (frames for the audio
    family); every logit finite, every token in range.  Host-clock times
    around work that ends in a synchronize; peak device memory.  With
    ``profile_name``, one more step under torch.profiler."""
    from repro_torch.data.tokens import TokenPipeline, frontend_batch
    from repro_torch.models.config import FAMILY_AUDIO
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import decode_step, prefill
    from repro_torch.serving.decode import grow_caches
    free_cuda()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in frontend_batch(cfg, B, S, seed).items()}
    if cfg.family != FAMILY_AUDIO:
        batch["tokens"] = torch.from_numpy(TokenPipeline(
            vocab=cfg.vocab, batch=B, seq=S, seed=seed).batch_at(0)["tokens"]).to("cuda")
    rec = {"layers": cfg.n_layers, "batch": B, "prompt": S,
           "decoded": new, "n_params": sum(p.numel() for p in model.parameters()),
           "param_bytes": lm_bytes(model), "resident_before_bytes": resident}
    if warm:     # the first call pays cuBLAS and allocator set-up
        w = {k: v[:, :min(S, 512)] if k == "tokens" else v for k, v in batch.items()}
        prefill(model, cfg, w)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches = prefill(model, cfg, batch)
    torch.cuda.synchronize()
    rec["prefill_s"] = time.perf_counter() - t0
    rec["prefill_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["prefill_tokens_per_s"] = B * S / rec["prefill_s"]
    caches = grow_caches(cfg, caches, new + bool(profile_name))
    rec["cache_bytes"] = lm_cache_bytes(caches)
    rec["decode_cache_positions"] = S + new + bool(profile_name)
    torch.cuda.reset_peak_memory_stats()
    audio = cfg.family == FAMILY_AUDIO
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nxt = lambda lg: ({"frame_embeds": torch.randn(B, cfg.frontend_dim(), generator=gen,
                                                   device="cuda")} if audio else
                      {"token": lg.argmax(-1).to(torch.int32)})
    inp, finite, tokens, times = nxt(last), torch.isfinite(last).all(), [], []
    for i in range(new):
        t0 = time.perf_counter()
        logits, caches = decode_step(model, cfg, caches, inp, S + i)
        inp = nxt(logits)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        finite &= torch.isfinite(logits).all()
        if not audio:
            tokens.append(inp["token"])
    check(bool(finite), f"lm {aid}: a non-finite logit")
    if tokens:
        t = torch.stack(tokens)
        check(bool(((t >= 0) & (t < cfg.vocab)).all()), f"lm {aid}: a token out of range")
        rec["first_tokens"] = t[:4, 0].tolist()
    rec["decode_ms"] = times
    rec["decode_ms_median"] = float(np.median(times))
    rec["decode_ms_quartiles"] = [float(q) for q in np.percentile(times, [25, 75])]
    rec["decode_ms_min_max"] = [min(times), max(times)]
    rec["decode_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["max_memory_allocated"] = max(rec["prefill_max_memory_allocated"],
                                      rec["decode_max_memory_allocated"])
    if profile_name:
        step = lambda: decode_step(model, cfg, caches, inp, S + new)
        rec["profiled_step"] = lm_profile_step(step, profile_name)
    del model, caches, last, batch
    free_cuda()
    return rec


def against_record(cell: dict, measured_s: float, peak_bytes: int) -> dict:
    """A measured time and peak beside the dry run's record of the same
    call (``phase_cost``): its bound (H100 SXM peaks), the share of it the
    card reached, the useful-FLOP ratio, and argument + temp bytes against
    ``torch.cuda.max_memory_allocated`` (recorded, not gated)."""
    r, i = cell["roofline"], cell["info"]
    return {"measured_s": measured_s, "bound_s": r["t_bound_s"],
            "bound_by": "operations" if r["dominant"] == "compute" else "bytes",
            "share_of_bound": r["t_bound_s"] / measured_s,
            "useful_flops_ratio": cell["useful_flops_ratio"], "aten_ops": i["aten_ops"],
            "argument_plus_temp_bytes": i["argument_size_in_bytes"] + i["temp_size_in_bytes"],
            "max_memory_allocated": peak_bytes}


def phase_lm(seed: int, cost: dict) -> None:
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_cuda()
    launches0 = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    reduced_errs = {aid: lm_card_against_cpu(aid, seed) for aid in sorted(ARCHS)}
    t_reduced = time.perf_counter() - t0
    consistency = lm_qwen2_consistency(seed)
    cfg = ARCHS["qwen2_1_5b"]
    serving = lm_serve("qwen2_1_5b", cfg, *LM_SERVE, seed, warm=True,
                       profile_name="qwen2_1_5b")
    serving["published_layers"] = cfg.n_layers
    serving["against_dry_run"] = {
        "prefill": against_record(cost["qwen2_prefill"], serving["prefill_s"],
                                  serving["prefill_max_memory_allocated"]),
        "decode": against_record(cost["qwen2_decode"], serving["decode_ms_median"] / 1e3,
                                 serving["decode_max_memory_allocated"])}
    published = {}
    for aid, (layers, B, S) in LM_CUTS.items():
        cut = dataclasses.replace(ARCHS[aid], n_layers=layers)
        published[aid] = lm_serve(aid, cut, B, S, LM_DECODE, seed)
        published[aid]["published_layers"] = ARCHS[aid].n_layers
    launched = {k: build.LAUNCHES[k] - launches0.get(k, 0) for k in build.LAUNCHES}
    check(not any(launched.values()), f"lm: a graph kernel launched {launched}")
    emit("lm", tolerances={"card_vs_cpu_rtol": LM_RTOL, "card_vs_cpu_atol": LM_ATOL,
                           "conv_rtol": LM_CONV_RTOL, "consistency": LM_CONSIST},
         reduced_card_vs_cpu=reduced_errs, reduced_s=t_reduced,
         qwen2_f32_consistency=consistency, qwen2_serving=serving,
         published=published, graph_kernel_launches=launched,
         seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# train: language-model training (loss, backward, AdamW, remat,
# flash_attention_cv's backward, checkpoints, the train CLI), which reaches
# no hand-written kernel: the reference computes it outside Pallas
# ---------------------------------------------------------------------------

# Card against CPU, float32 with TF32 off, one train_step from the same
# weights and batch: the loss terms to TRAIN_LOSS_RTOL; the global norm,
# and m (0.1 x the clipped gradient) leaf by leaf, to TRAIN_RTOL of the
# leaf's largest magnitude; v (0.05 x its square) to twice that.  A leaf
# whose exact gradient is 0 (the mLSTM's b_i: the stabilizer absorbs a
# shift of every input-gate logit) holds rounding noise, so a leaf's scale
# is at least TRAIN_FLOOR of the largest over all leaves (its square for v).
TRAIN_LOSS_RTOL, TRAIN_RTOL, TRAIN_FLOOR = 1e-4, 1e-3, 1e-6
# Qwen2-1.5B at full width in float32, depth cut to TRAIN_CONSIST_LAYERS
# (the script's time limit), wq and wk at fan-in d: every gradient leaf of each variant (remat off, flash_cv,
# attn_remat) against remat on, to TRAIN_CONSIST of the leaf's largest
# magnitude (floored as above).  The variants change the summation order
# (flash_cv's backward) or recompute the same ops; none changes the math.
TRAIN_CONSIST = 1e-3
TRAIN_CONSIST_LAYERS = 8
# xLSTM-125M's train CLI killed after its first commit and resumed: the
# logged losses of the steps both runs took agree to TRAIN_RESUME (absolute;
# the log prints four decimals).  The CLI's default batch and length; a
# step takes 5.6-6.1 s on the card (the mLSTM is a sequential scan in
# every config, about 160,000 host-dispatched ops a step), so 6 steps with
# a commit every 3, not 30 with one every 10, which took 385 s.
TRAIN_RESUME = 1e-3
TRAIN_CLI_STEPS, TRAIN_CLI_EVERY = 6, 3
# Qwen2-1.5B's bf16 steps: batch, sequence length; how many steps
TRAIN_BF16 = (4, 2048)
TRAIN_BF16_STEPS = 3
TRAIN_CLI = ["--arch", "xlstm-125m", "--steps", str(TRAIN_CLI_STEPS), "--batch", "8",
             "--seq", "128", "--ckpt-every", str(TRAIN_CLI_EVERY), "--log-every", "1"]


def leaf_errs(got: dict, want: dict, floor: float) -> dict:
    """{name: max |got - want| / scale}: scale is the leaf's largest
    magnitude (of ``want``), at least ``floor`` of the largest over all
    leaves.  ``want`` may live on the host."""
    tops = {n: float(w.abs().max()) for n, w in want.items()}
    top = max(tops.values())
    out = {}
    for n, w in want.items():
        g = got[n]
        check(tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype, f"train: leaf {n}")
        check(bool(torch.isfinite(g).all()), f"train: non-finite {n}")
        diff = float((g.float() - w.to(g.device).float()).abs().max())
        out[n] = diff / max(tops[n], floor * top, 1e-30)
    return out


def worst(errs: dict) -> list:
    n = max(errs, key=errs.get)
    return [n, errs[n]]


def train_card_against_cpu(aid: str, seed: int) -> dict:
    """A reduced config (float32) on the card and on the CPU from the same
    weights and batch: one ``train_step`` with ``TrainConfig(remat=True)``,
    again with ``flash_cv`` (configs with global attention; 8-position
    chunks, so the tiles and the masked ones are several), and with
    ``attn_remat`` for qwen2_1_5b.  The loss terms, grad norm and lr, and
    every leaf of m and v."""
    import copy
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.registry import ShapeSpec, concrete_batch
    from repro_torch.models.config import BLOCK_ATTN
    from repro_torch.models.transformer import init_params
    from repro_torch.train import OptConfig, TrainConfig, init_opt_state, make_train_step
    cfg = reduced(ARCHS[aid])
    variants = {"remat": TrainConfig(remat=True)}
    chunked = dict(remat=True, q_chunk=8, kv_chunk=8)
    if any(cfg.block_kind(i) == BLOCK_ATTN for i in range(cfg.n_layers)):
        variants["flash_cv"] = TrainConfig(flash_cv=True, **chunked)
    if aid == "qwen2_1_5b":
        variants["attn_remat"] = TrainConfig(attn_remat=True, **chunked)
    batch = concrete_batch(cfg, ShapeSpec("t", "train", 32, 2), seed, device="cpu")
    cpu = init_params(cfg, seed, device="cpu")
    out = {}
    for name, tcfg in variants.items():
        res = {}
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(cpu).to(dev)
            state = init_opt_state(model, device=dev)
            metrics = make_train_step(cfg, tcfg)(model, state,
                                                 {k: v.to(dev) for k, v in batch.items()})
            check(int(state["step"]) == 1, f"train {aid}: step")
            res[dev] = ({k: float(v) for k, v in metrics.items()}, state)
        (mc, sc), (mg, sg) = res["cpu"], res["cuda"]
        rel = lambda k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
        rec = {k: rel(k) for k in mc}
        rec["aux_abs"] = abs(mg["aux"] - mc["aux"])
        rec["m"] = worst(leaf_errs(sg["m"], sc["m"], TRAIN_FLOOR))
        rec["v"] = worst(leaf_errs(sg["v"], sc["v"], TRAIN_FLOOR ** 2))
        ok = (rec["loss"] <= TRAIN_LOSS_RTOL and rec["nll"] <= TRAIN_LOSS_RTOL
              and (rec["aux"] <= TRAIN_LOSS_RTOL or rec["aux_abs"] <= 1e-6)
              and rec["grad_norm"] <= TRAIN_RTOL and rec["lr"] <= 1e-6
              and rec["m"][1] <= TRAIN_RTOL and rec["v"][1] <= 2 * TRAIN_RTOL)
        check(ok, f"train {aid} {name}: card and CPU disagree {rec}")
        out[name] = rec
    free_cuda()
    return out


def flash_cv_card_against_cpu(seed: int, B: int = 1, S: int = 1024) -> dict:
    """``flash_attention_cv`` at Qwen2-1.5B's attention shape (H 12, Hkv 2,
    hd 128, 512-position chunks), float32: the output and the gradients of
    sum(out^2) on the card against the CPU, each to TRAIN_RTOL of its
    largest magnitude."""
    from repro_torch.models.layers import flash_attention_cv
    gen = torch.Generator().manual_seed(seed)
    arrays = [torch.randn(B, S, h, 128, generator=gen) for h in (12, 2, 2)]
    res = {}
    for dev in ("cpu", "cuda"):
        ts = [a.to(dev, copy=True).requires_grad_(True) for a in arrays]
        out = flash_attention_cv(*ts, 512, 512)
        (out ** 2).sum().backward()
        res[dev] = {"out": out.detach(), **{f"d{n}": t.grad for n, t in zip("qkv", ts)}}
    errs = leaf_errs(res["cuda"], res["cpu"], 0.0)
    check(max(errs.values()) <= TRAIN_RTOL, f"flash_cv: card and CPU disagree {errs}")
    free_cuda()
    return errs


def train_qwen2_consistency(seed: int, S: int = 1024) -> dict:
    """Gradients of Qwen2-1.5B (float32, full width, TRAIN_CONSIST_LAYERS
    layers, wq and wk at fan-in d, B=1 x S) under four variants of the same
    loss: remat on (kept on the host), remat off, flash_cv, attn_remat.
    Every leaf to TRAIN_CONSIST."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import init_params
    from repro_torch.train.step import TrainConfig, value_and_grad
    cfg = dataclasses.replace(ARCHS["qwen2_1_5b"], n_layers=TRAIN_CONSIST_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    model = init_params(cfg, seed, device="cuda")
    qk_fan_in_d(cfg, model)
    b = TokenPipeline(vocab=cfg.vocab, batch=1, seq=S, seed=seed).batch_at(0)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
    variants = {"remat": TrainConfig(remat=True), "no_remat": TrainConfig(remat=False),
                "flash_cv": TrainConfig(remat=True, flash_cv=True),
                "attn_remat": TrainConfig(remat=True, attn_remat=True)}
    rec, base, base_loss = {"layers": cfg.n_layers, "batch": 1, "seq": S,
                            "tolerance": TRAIN_CONSIST}, None, None
    for name, tcfg in variants.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        total, parts, grads = value_and_grad(model, cfg, batch, tcfg)
        torch.cuda.synchronize()
        r = {"loss": float(total), "nll": float(parts["nll"]),
             "s": time.perf_counter() - t0,
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
        check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
              f"qwen2 train {name}: a non-finite gradient")
        if base is None:
            base, base_loss = {n: g.cpu() for n, g in grads.items()}, r["loss"]
        else:
            r["loss_rel"] = abs(r["loss"] - base_loss) / abs(base_loss)
            r["worst"] = worst(leaf_errs(grads, base, TRAIN_FLOOR))
            check(r["worst"][1] <= TRAIN_CONSIST and r["loss_rel"] <= TRAIN_LOSS_RTOL,
                  f"qwen2 train {name} against remat: {r}")
        rec[name] = r
        del grads
        free_cuda()
    del model, base
    free_cuda()
    return rec


def profile_train_step(step, name: str) -> dict:
    """One train step under torch.profiler: host kernel launches, device
    kernels, and the device's busy and idle share of the step's wall time.
    The trace (tens of MB) is read from a scratch file under build/."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / f"profile_{name}.json"
        prof.export_chrome_trace(str(path))
        dev = device_events(json.loads(path.read_text())["traceEvents"])
    check(bool(dev), "the profiler recorded no device activity")
    busy = busy_ms(dev)
    by_name: dict = {}
    for e in dev:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"] / 1e3
    launches = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
    return {"wall_ms": wall_ms, "host_kernel_launches": launches,
            "device_kernels": sum(e.get("cat") == "kernel" for e in dev),
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
            "kernels_by_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def train_qwen2_bf16(seed: int, B: int = TRAIN_BF16[0], S: int = TRAIN_BF16[1],
                     steps: int = TRAIN_BF16_STEPS) -> dict:
    """Qwen2-1.5B, the published config at full depth in bf16: ``steps``
    train steps of B x S tokens from the token pipeline with
    ``TrainConfig(remat=True, flash_cv=True)``; the loss, grad norm and every
    parameter finite, ``step == steps``, the parameters moved.  Step times
    (host clock, the loss's ``.item()`` as the barrier), peak memory and
    one more step under torch.profiler.

    The reference's init at full depth (sharp attention, see
    lm_qwen2_consistency) gives gradients of 1e17 to 5e18, whose squares
    overflow float32 in ``global_norm`` (the reference's too), so the norm
    is inf and the clip zeroes the step.  One backward on those weights is
    recorded; the steps run with wq and wk at fan-in d."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import init_params
    from repro_torch.train import TrainConfig, init_opt_state, make_train_step
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.step import value_and_grad
    cfg = ARCHS["qwen2_1_5b"]
    free_cuda()
    resident = torch.cuda.memory_allocated()
    model = init_params(cfg, seed, device="cuda")
    tcfg = TrainConfig(remat=True, flash_cv=True)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=seed)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(i).items()}
               for i in range(steps + 1)]
    _, _, grads = value_and_grad(model, cfg, batches[0], tcfg)
    raw = {"grad_abs_max": max(float(g.float().abs().max()) for g in grads.values()),
           "grad_norm": float(global_norm(grads.values()))}
    del grads
    qk_fan_in_d(cfg, model)
    before = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    state = init_opt_state(model, device="cuda")
    step_fn = make_train_step(cfg, tcfg)
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step_fn(model, state, batches[i])
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"qwen2 bf16 train: non-finite {losses} {norms}")
    check(int(state["step"]) == steps, "qwen2 bf16 train: optimizer step")
    moved, changed = [], {}
    for n, p in model.named_parameters():
        check(bool(torch.isfinite(p).all()), f"qwen2 bf16 train: non-finite {n}")
        diff = p.detach().cpu() != before[n]
        if bool(diff.any()):
            moved.append(n)
        d = changed.setdefault(str(p.dtype).split(".")[-1], [0, 0])
        d[0] += int(diff.sum())
        d[1] += diff.numel()
    n_leaves = len(before)
    check(len(moved) == n_leaves, f"qwen2 bf16 train: {n_leaves - len(moved)} leaves did not move")
    del before
    prof = profile_train_step(lambda: step_fn(model, state, batches[steps]), "qwen2_train")
    warm = times[1:]
    n_params = sum(p.numel() for p in model.parameters())
    rec = {"layers": cfg.n_layers, "batch": B, "seq": S, "tokens_per_step": B * S,
           "n_params": n_params, "reference_init": raw, "qk_fan_in_d": True,
           "losses": losses, "grad_norms": norms,
           "step_ms": times, "step_ms_median_warm": float(np.median(warm)),
           "step_ms_min_max_warm": [min(warm), max(warm)],
           "tokens_per_s": B * S / (float(np.median(warm)) / 1e3),
           "max_memory_allocated": peak, "resident_before_bytes": resident,
           "leaves_moved": len(moved), "leaves": n_leaves,
           "elements_changed_by_dtype": changed, "profiled_step": prof}
    del model, state, batches
    free_cuda()
    return rec


def parse_train_log(text: str) -> dict:
    steps = {}
    for line in text.splitlines():
        m = re.match(r"\[train\] step +(\d+) loss +(\S+)", line)
        if m:
            steps[int(m.group(1))] = float(m.group(2))
    done = [l for l in text.splitlines() if l.startswith("[train] done.")]
    check(len(done) == 1, f"train CLI: no final line in {text[-400:]}")
    med = re.search(r"median step ([\d.]+) ms; straggler steps (\d+)", done[0])
    return {"losses": steps, "median_step_ms": float(med.group(1)),
            "straggler_steps": int(med.group(2)),
            "resumed": re.findall(r"resumed from step (\d+)", text)}


def run_train_cli(argv: list) -> str:
    """``repro_torch.launch.train.main`` in this process; its output."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(train.main(argv) == 0, f"train CLI {argv}")
    free_cuda()
    return buf.getvalue()


def train_cli(workdir: Path) -> dict:
    """xLSTM-125M at its published size (the reference CLI's default arch)
    through ``python -m repro_torch.launch.train``: run A uninterrupted;
    run B in a subprocess SIGKILLed once its first checkpoint commits, then
    relaunched with the same flags, which must resume from the last commit.
    The losses of the steps both took agree to TRAIN_RESUME, and the final
    checkpoints have the same npz keys, shapes and dtypes."""
    a, b = workdir / "ckpt_a", workdir / "ckpt_b"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_a = parse_train_log(run_train_cli(TRAIN_CLI + ["--ckpt-dir", str(a)]))
    t_a = time.perf_counter() - t0
    peak_a = torch.cuda.max_memory_allocated()
    n, every = TRAIN_CLI_STEPS, TRAIN_CLI_EVERY
    check(not out_a["resumed"] and len(out_a["losses"]) == n, "train CLI: run A")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = workdir / "run_b.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
                                 "--ckpt-dir", str(b)], stdout=f, stderr=subprocess.STDOUT,
                                cwd=ROOT, env=env)
        try:
            while not (b / f"step_{every:08d}" / "done").exists():
                check(proc.poll() is None, f"train CLI: run B ended early: {log.read_text()[-2000:]}")
                time.sleep(0.05)
        finally:
            proc.kill()       # SIGKILL
            proc.wait(timeout=60)
    t_kill = time.perf_counter() - t0
    committed = sorted(p.name for p in b.iterdir() if (p / "done").exists())
    t0 = time.perf_counter()
    out_b = parse_train_log(run_train_cli(TRAIN_CLI + ["--ckpt-dir", str(b)]))
    t_b = time.perf_counter() - t0
    last = int(committed[-1].split("_")[1])
    check(out_b["resumed"] == [str(last)] and 0 < last < n and last % every == 0,
          f"train CLI: resumed {out_b['resumed']}, committed {committed}")
    common = sorted(set(out_b["losses"]) & set(out_a["losses"]))
    check(common == list(range(last, n)), f"train CLI: logged steps {common}")
    diffs = [abs(out_b["losses"][s] - out_a["losses"][s]) for s in common]
    check(max(diffs) <= TRAIN_RESUME, f"train CLI: resumed losses differ {diffs}")
    files = {}
    for side, d in (("a", a), ("b", b)):
        with np.load(d / f"step_{n:08d}" / "host0000.npz") as z:
            files[side] = {k: (z[k].shape, str(z[k].dtype)) for k in z.files}
    check(files["a"] == files["b"], "train CLI: final checkpoints differ in keys, shapes or dtypes")
    check(any(dt == "|V2" for _, dt in files["a"].values()), "train CLI: no bf16 leaf stored")
    return {"argv": TRAIN_CLI, "run_a_s": t_a, "run_a_max_memory_allocated": peak_a,
            "run_b_killed_after_s": t_kill,
            "run_b_resume_s": t_b, "committed_at_kill": committed, "resumed_from": last,
            "max_loss_diff": max(diffs), "steps_compared": len(common),
            "losses_a": out_a["losses"], "median_step_ms_a": out_a["median_step_ms"],
            "straggler_steps_a": out_a["straggler_steps"],
            "median_step_ms_b": out_b["median_step_ms"],
            "straggler_steps_b": out_b["straggler_steps"], "npz_leaves": len(files["a"])}


def phase_train(seed: int, cost: dict) -> None:
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_cuda()
    launches0 = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    reduced_errs = {aid: train_card_against_cpu(aid, seed) for aid in sorted(ARCHS)}
    t_reduced = time.perf_counter() - t0
    flash_cv = flash_cv_card_against_cpu(seed)
    consistency = train_qwen2_consistency(seed)
    bf16 = train_qwen2_bf16(seed)
    bf16["against_dry_run"] = against_record(
        cost["qwen2_train"], bf16["step_ms_median_warm"] / 1e3, bf16["max_memory_allocated"])
    (ROOT / "build").mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-train-", dir=ROOT / "build"))
    try:
        cli = train_cli(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cli["against_dry_run"] = against_record(
        cost["xlstm_train"], cli["median_step_ms_a"] / 1e3, cli["run_a_max_memory_allocated"])
    launched = {k: build.LAUNCHES[k] - launches0.get(k, 0) for k in build.LAUNCHES}
    check(not any(launched.values()), f"train: a graph kernel launched {launched}")
    emit("train", tolerances={"loss_rtol": TRAIN_LOSS_RTOL, "rtol": TRAIN_RTOL,
                              "floor": TRAIN_FLOOR, "consistency": TRAIN_CONSIST,
                              "resume_abs": TRAIN_RESUME},
         reduced_card_vs_cpu=reduced_errs, reduced_s=t_reduced,
         flash_cv_card_vs_cpu=flash_cv, qwen2_f32_consistency=consistency,
         qwen2_bf16=bf16, cli=cli, graph_kernel_launches=launched,
         seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# lm_mesh: the language models' mesh (launch.{mesh,sharding},
# distributed.fsdp, layers.make_tp_moe_fn); no graph kernel on its path
# ---------------------------------------------------------------------------

MESH_LAYERS = 2            # Qwen2's and deepseek's depth cut; every width published
MESH_TRAIN = (4, 2048, 3)  # Qwen2-1.5B: batch, sequence, bf16 train steps
MESH_MOE = (2, 2048)       # deepseek-moe-16b: batch, sequence (forward)
MESH_SERVE = (4, 2048, 8, 2064)  # Qwen2-1.5B: batch, prompt, greedy steps, s_max
MESH_RG = (3, 2, 2048, 2)  # recurrentgemma-9b: layers (r, r, local), batch,
                           # sequence, bf16 train steps; served at MESH_SERVE's
                           # greedy steps and s_max
# Where the sharded step is not bit-equal to the unsharded one (wq and wk
# at fan-in d), its losses and grad norms must agree to these (readings on
# two and four H100s: losses 2.1e-6 and 7.5e-6, grad norms 6.1e-5 and
# 1.3e-5), every leaf of m (float32: 0.1 x the clipped gradients, summed
# over the steps) within m_rel of the leaf's largest, floored at 1e-6 of
# the model's largest, and every parameter element within 2 x the summed
# learning rates (Adam's first step is a sign, so a gradient at rounding
# level moves a weight by +-lr) plus three bf16 ulps of itself.  At the
# raw init only the first step's loss and grad norm are held, to
# raw_step0_rtol (readings 7.8e-8 and 1.7e-6 on two and four H100s): its
# near one-hot attention grows rounding over the later steps.  The
# expert-parallel forward's logits (over their largest magnitude) and aux
# loss to logit_rel and aux_rtol (its combine sums float32 partials with
# index_add_, whose order on the card varies); so are the sharded prefill
# and decode logits, whose greedy tokens must equal one card's.  A
# tensor-parallel step rounds each row-parallel product's bf16 partial
# sums before adding them, where one card rounds the whole sum once: its
# grad norm is held to tp_grad_norm_rtol and m to tp_m_rel (readings on
# "NVIDIA H100 80GB HBM3, 700.00 W": grad norms 2.1e-4 at (1, 2), 3.1e-4
# and 3.1e-4 at (1, 4) for Qwen2-1.5B and recurrentgemma-9b, 3.0e-4 at
# (2, 2); m 4.4e-2, 2.8e-2, 3.2e-2 and 1.5e-2, in w_gate and ln2), its
# loss and parameters as above (losses 2.7e-5 at most).
MESH_TOL = {"loss_rtol": 5e-5, "grad_norm_rtol": 3e-4, "m_rel": 2e-2, "param_ulps": 3,
            "raw_step0_rtol": 1e-5, "logit_rel": 2e-2, "aux_rtol": 1e-3,
            "tp_grad_norm_rtol": 1e-3, "tp_m_rel": 8e-2}
MESH_BUDGET_S = 60.0
MESH_TCFG = {"remat": True, "flash_cv": True}     # the mesh steps' TrainConfig


def mesh_cfgs() -> tuple:
    from repro_torch.configs import ARCHS
    return (dataclasses.replace(ARCHS["qwen2_1_5b"], n_layers=MESH_LAYERS),
            dataclasses.replace(ARCHS["deepseek_moe_16b"], n_layers=MESH_LAYERS),
            dataclasses.replace(ARCHS["recurrentgemma_9b"], n_layers=MESH_RG[0]))


def tensor_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def mesh_batches(cfg, B: int, S: int, n: int, seed: int, dev) -> list:
    from repro_torch.data.tokens import TokenPipeline
    pipe = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=seed)
    return [{k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(i).items()}
            for i in range(n)]


def mesh_model(cfg, seed: int, dev, fan_in_d: bool = True):
    from repro_torch.models.transformer import init_params
    model = init_params(cfg, seed, device=dev)
    if fan_in_d:
        qk_fan_in_d(cfg, model)
    return model


def spec_parts(spec, mesh) -> int:
    """Into how many blocks a spec cuts a leaf on ``mesh``."""
    from repro_torch.launch.sharding import spec_axes
    n = 1
    for e in spec:
        for a in spec_axes(e):
            n *= mesh.shape[a]
    return n


def cut_bytes(model) -> tuple:
    """(this rank's bytes of the parameters the mesh cuts, the same leaves'
    whole bytes, how many leaves are cut)."""
    from repro_torch.distributed import fsdp
    plan = fsdp.plan_of(model)
    cut = [(n, p) for n, p in model.named_parameters() if spec_parts(plan.specs[n], plan.mesh) > 1]
    return (tensor_bytes(p for _, p in cut),
            sum(tensor_bytes([p]) * spec_parts(plan.specs[n], plan.mesh) for n, p in cut), len(cut))


def gather_logits(logits, cfg, mesh, B: int):
    """This rank's [B_local, V/M] logits -> the whole [B, V]."""
    from repro_torch.distributed import comm, tp
    from repro_torch.launch.sharding import _batch_dim_spec
    lg = tp.whole_logits(logits, mesh, cfg.vocab)
    if _batch_dim_spec(mesh, B) is not None:
        with torch.no_grad():
            lg = comm.all_gather(lg, 0, mesh.group("data"))
    return lg


def mesh_train(cfg, batches: list, seed: int, dev, mesh=None, *,
               fan_in_d: bool = True) -> tuple:
    """``len(batches)`` bf16 train steps from ``init_params(seed)``, wq and
    wk at fan-in d unless ``fan_in_d`` is off (see lm_qwen2_consistency:
    the raw init's near one-hot attention turns rounding into gradient
    differences): sharded over ``mesh`` by its specs (FSDP over data,
    tensor parallel over model; each rank fed its rows) or, with no mesh,
    ``train.make_train_step`` on the card.  (record, {"params", "m"}:
    whole leaves)."""
    from repro_torch.distributed import fsdp
    from repro_torch.train import TrainConfig, init_opt_state, make_train_step
    tcfg = TrainConfig(**MESH_TCFG)
    model = mesh_model(cfg, seed, dev, fan_in_d)
    B = batches[0]["tokens"].shape[0]
    if mesh is None:
        step_fn, feed = make_train_step(cfg, tcfg), batches
    else:
        fsdp.shard_model(model, mesh)
        step_fn = fsdp.make_train_step(cfg, tcfg, mesh, B)
        feed = [fsdp.local_batch(b, mesh) for b in batches]
    opt = init_opt_state(model, device=dev)
    rec = {"resident_bytes": torch.cuda.memory_allocated(dev),   # model + opt placed
           "param_bytes": tensor_bytes(model.parameters()),
           "opt_bytes": tensor_bytes([*opt["m"].values(), *opt["v"].values()]),
           "losses": [], "grad_norms": [], "lrs": [], "step_s": []}
    if mesh is not None:
        rec["mesh"] = [mesh.shape["data"], mesh.shape["model"]]
        rec["sharded_param_bytes"], rec["sharded_whole_bytes"], rec["sharded_leaves"] = \
            cut_bytes(model)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for b in feed:
        t0 = time.perf_counter()
        m = step_fn(model, opt, b)
        rec["losses"].append(m["loss"].item())
        rec["step_s"].append(time.perf_counter() - t0)
        rec["grad_norms"].append(float(m["grad_norm"]))
        rec["lrs"].append(float(m["lr"]))
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(rec["losses"] + rec["grad_norms"])), f"lm_mesh: non-finite {rec}")
    if mesh is None:
        return rec, {"params": {n: p.detach() for n, p in model.named_parameters()},
                     "m": opt["m"]}
    return rec, {"params": fsdp.full_leaves(model), "m": fsdp.full_leaves(model, opt["m"])}


def mesh_same_train(got: dict, want: dict, got_state: dict, want_state: dict, *,
                    raw_init: bool = False, tp: bool = False, tol: dict = MESH_TOL) -> dict:
    """Bit-equal, or each difference against ``tol`` (``ok``; its tp_
    entries for a tensor-parallel step); at the raw init the first step's
    loss and grad norm only.  ``m_rel`` is the
    largest leaf's error over its scale, ``param_excess`` the largest
    amount by which a parameter element passes its bound (<= 0; the ulps
    are the parameters' dtype's)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    gp, wp, gm, wm = (got_state["params"], want_state["params"], got_state["m"],
                      want_state["m"])
    bitwise = (got["losses"] == want["losses"] and got["grad_norms"] == want["grad_norms"]
               and all(torch.equal(gp[n], w) for n, w in wp.items())
               and all(torch.equal(gm[n], w) for n, w in wm.items()))
    lrs = 2 * sum(want["lrs"])
    ulp = lambda w: tol["param_ulps"] * torch.finfo(w.dtype).eps
    diff = lambda n, w: (gp[n].float() - w.float()).abs()
    top = max(float(w.abs().max()) for w in wm.values())
    m_rel = {n: float((gm[n] - w).abs().max()) / max(float(w.abs().max()), 1e-6 * top, 1e-30)
             for n, w in wm.items()}
    worst = max(m_rel, key=m_rel.get)
    out = {"bitwise": bitwise,
           "loss_rel": max(rel(a, b) for a, b in zip(got["losses"], want["losses"])),
           "grad_norm_rel": max(rel(a, b) for a, b in zip(got["grad_norms"],
                                                          want["grad_norms"])),
           "step0_loss_rel": rel(got["losses"][0], want["losses"][0]),
           "step0_grad_norm_rel": rel(got["grad_norms"][0], want["grad_norms"][0]),
           "m_rel": m_rel[worst], "m_rel_leaf": worst,
           "param_abs_max": max(float(diff(n, w).max()) for n, w in wp.items()),
           "param_excess": max(float((diff(n, w) - lrs - ulp(w) * w.float().abs()).max())
                               for n, w in wp.items())}
    if raw_init:
        ok = max(out["step0_loss_rel"], out["step0_grad_norm_rel"]) <= tol["raw_step0_rtol"]
    else:
        pre = "tp_" if tp else ""
        ok = bitwise or (out["loss_rel"] <= tol["loss_rtol"]
                         and out["grad_norm_rel"] <= tol[pre + "grad_norm_rtol"]
                         and out["m_rel"] <= tol[pre + "m_rel"] and out["param_excess"] <= 0)
    out["ok"] = bool(ok)
    return out


def mesh_serve(cfg, seed: int, dev, B: int, S: int, new: int, s_max: int, mesh=None,
               tokens=None) -> tuple:
    """A prefill of B x S prompt tokens and ``new`` decode steps of the bf16
    model (wq and wk at fan-in d): unsharded (``serving.decode``, the
    caches grown to ``s_max``) or on ``mesh`` (``distributed.tp``'s
    programs, each rank its rows and blocks).  Each step feeds ``tokens``
    (one card's greedy choices, teacher-forced so that a tie broken the
    other way does not fork the run) when given, else its own argmax.
    (record, {"logits": the whole [B, V] of the prefill and each step, on
    the host, "tokens": the argmax of each})."""
    from repro_torch.distributed import fsdp, tp
    from repro_torch.serving.decode import decode_step, grow_caches, prefill
    model = mesh_model(cfg, seed, dev)
    batch = {"tokens": mesh_batches(cfg, B, S, 1, seed, dev)[0]["tokens"]}
    if mesh is None:
        run_prefill = lambda: prefill(model, cfg, batch)
        step = lambda caches, tok, pos: decode_step(model, cfg, caches, {"token": tok}, pos)
    else:
        fsdp.shard_model(model, mesh)
        local = fsdp.local_batch(batch, mesh)
        pre, dec = tp.make_prefill(cfg, mesh, B, s_max), tp.make_decode_step(cfg, mesh, B, s_max)
        run_prefill = lambda: pre(model, local)
        step = lambda caches, tok, pos: dec(model, caches,
                                            fsdp.local_batch({"token": tok}, mesh), pos)
    rec = {"batch": B, "prompt": S, "new": new, "s_max": s_max,
           "param_bytes": tensor_bytes(model.parameters())}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        last, caches = run_prefill()
        torch.cuda.synchronize(dev)
        rec["prefill_s"] = time.perf_counter() - t0
        if mesh is None:
            caches = grow_caches(cfg, caches, s_max - S)
        rec["cache_bytes"] = tensor_bytes(t for c in caches for t in c.values())
        rec["logit_bytes"] = tensor_bytes([last])
        if mesh is not None:
            from repro_torch.launch.sharding import cache_shardings
            specs = cache_shardings(cfg, mesh, B, s_max)
            rec["cache_whole_bytes"] = sum(tensor_bytes([t]) * spec_parts(specs[i][k], mesh)
                                           for i, c in enumerate(caches) for k, t in c.items())
            rec["logit_whole_bytes"] = tensor_bytes([last]) * spec_parts(
                tp.logits_spec(mesh, B, cfg.vocab), mesh)
        out = {"logits": [], "tokens": []}
        step_s = []
        for i in range(new + 1):
            lg = last if mesh is None else gather_logits(last, cfg, mesh, B)
            out["logits"].append(lg.float().cpu())
            out["tokens"].append(lg.argmax(-1).cpu())
            if i == new:
                break
            tok = (tokens[i] if tokens is not None else out["tokens"][i]).to(dev)
            t1 = time.perf_counter()
            last, caches = step(caches, tok, S + i)
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t1)
    rec["decode_token_s"] = step_s
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    check(all(bool(torch.isfinite(l).all()) for l in out["logits"]),
          "lm_mesh: non-finite serving logits")
    return rec, out


def mesh_same_serve(got: dict, want: dict, tol: dict = MESH_TOL) -> dict:
    """A sharded serving run against one card's (``ok``): every step's
    whole logits within ``tol``'s logit_rel and its greedy tokens equal
    one card's."""
    out = {"bitwise": all(torch.equal(g, w) for g, w in zip(got["logits"], want["logits"])),
           "logit_rel": [lm_err(g, w) for g, w in zip(got["logits"], want["logits"])],
           "tokens_differing": sum(int((g != w).sum()) for g, w in
                                   zip(got["tokens"], want["tokens"]))}
    out["tokens_equal"] = out["tokens_differing"] == 0
    out["ok"] = max(out["logit_rel"]) <= tol["logit_rel"] and out["tokens_equal"]
    return out


def mesh_moe(cfg, mesh, seed: int, dev, *, dense: bool) -> dict:
    """deepseek-moe-16b's forward with ``make_tp_moe_fn`` over the mesh's
    model axis (64 / n experts computed on each card), and with
    ``dense`` also the dense ``moe_ffn`` forward on this card: logits and
    aux against each other."""
    from repro_torch.launch.sharding import _batch_dim_spec
    from repro_torch.models.layers import make_tp_moe_fn
    from repro_torch.models.transformer import forward, init_params
    B, S = MESH_MOE
    model = init_params(cfg, seed, device=dev)
    batch = {"tokens": mesh_batches(cfg, B, S, 1, seed, dev)[0]["tokens"]}
    moe_fn = make_tp_moe_fn(mesh, _batch_dim_spec(mesh, B), cfg)
    rec = {"experts_per_card": cfg.n_experts // mesh.shape["model"]}
    with torch.no_grad():
        for key in ("moe_fn_first_s", "moe_fn_s"):      # the first sets up NCCL
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            lt, at = forward(model, cfg, batch, remat=False, moe_fn=moe_fn)
            torch.cuda.synchronize(dev)
            rec[key] = time.perf_counter() - t0
        check(bool(torch.isfinite(lt).all()) and tuple(lt.shape) == (B, S, cfg.vocab),
              f"lm_mesh: moe_fn logits {tuple(lt.shape)}")
        if dense:
            t0 = time.perf_counter()
            ld, ad = forward(model, cfg, batch, remat=False)
            torch.cuda.synchronize(dev)
            rec.update(dense_s=time.perf_counter() - t0, bitwise=bool(torch.equal(lt, ld)),
                       logit_rel=lm_err(lt, ld), aux=[float(at), float(ad)],
                       aux_rel=abs(float(at) - float(ad)) / max(abs(float(ad)), 1e-30))
            check(rec["logit_rel"] <= MESH_TOL["logit_rel"]
                  and rec["aux_rel"] <= MESH_TOL["aux_rtol"], f"lm_mesh: moe_fn differs {rec}")
    return rec


def mesh_on_cards(cfg, seed: int, dev, mesh, rank: int, *, train: tuple, serve: tuple,
                  one: dict, tol: dict = MESH_TOL) -> dict:
    """One config tensor parallel on ``mesh`` (every rank calls): its
    train steps and its serving run, each against one card's within
    ``tol`` (computed by rank 0 into ``one`` first, once per config; the
    one card's greedy tokens are broadcast and teacher-forced, so that a
    differing token shows at its step alone).  Rank 0 checks and records
    the comparisons."""
    B, S, steps = train
    batches = mesh_batches(cfg, B, S, steps, seed, dev)
    if rank == 0 and "train" not in one:
        one["train"], one["state"] = mesh_train(cfg, batches, seed, dev)
        one["serve"], one["served"] = mesh_serve(cfg, seed, dev, *serve)
        free_cuda()
    torch.distributed.barrier()
    rec = {}
    rec["train"], full = mesh_train(cfg, batches, seed, dev, mesh)
    if rank == 0:
        rec["train_vs_one_card"] = mesh_same_train(rec["train"], one["train"], full, one["state"],
                                                   tp=True, tol=tol)
    del full
    free_cuda()
    tokens = torch.stack(one["served"]["tokens"]).to(dev) if rank == 0 else \
        torch.zeros((serve[2] + 1, serve[0]), dtype=torch.int64, device=dev)
    torch.distributed.broadcast(tokens, src=0)
    rec["serve"], got = mesh_serve(cfg, seed, dev, *serve, mesh=mesh, tokens=tokens.cpu())
    if rank == 0:
        rec["serve_vs_one_card"] = mesh_same_serve(got, one["served"], tol)
    free_cuda()
    torch.distributed.barrier()
    return rec


def mesh_count_step(cfg, seed: int, dev, mesh) -> dict:
    """Rank 0's warm tensor-parallel train step of ``cfg`` (MESH_TRAIN's
    shape) on ``mesh`` counted under ``OpCostMode`` on the card (every rank
    calls): a sharded model, one step, then one step under the mode.  Its
    counts, and the bytes its arguments hold on the card before the steps
    and at their peak over the first (both above what the card held
    before: rank 0 also keeps one card's run)."""
    from repro_torch.distributed import fsdp
    from repro_torch.launch.op_cost import OpCostMode
    from repro_torch.train import TrainConfig, init_opt_state
    B, S, _ = MESH_TRAIN
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    model = fsdp.shard_model(mesh_model(cfg, seed, dev), mesh)
    opt = init_opt_state(model, device=dev)
    step_fn = fsdp.make_train_step(cfg, TrainConfig(**MESH_TCFG), mesh, B)
    feed = [fsdp.local_batch(b, mesh) for b in mesh_batches(cfg, B, S, 2, seed, dev)]
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn(model, opt, feed[0])
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    mode = OpCostMode((model, opt, feed[1]), mesh.axis_labels())
    with mode:
        out = step_fn(model, opt, feed[1])
    torch.cuda.synchronize(dev)
    return {"counts": mode.finish(out).as_dict(), "resident_bytes": resident,
            "peak_bytes": peak}


def dry_mesh_step(n: int) -> dict:
    """The dry run's record of ``mesh_count_step``'s call on (1, n): rank 0
    of a counting world of n on ``meta`` (run in a process of its own)."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import cost_analysis, dryrun
    from repro_torch.launch.mesh import counting_world, make_test_mesh
    from repro_torch.train import TrainConfig
    B, S, _ = MESH_TRAIN
    t0 = time.perf_counter()
    with counting_world(n):
        mesh = make_test_mesh((1, n), device="cpu")
        counts, _, links = dryrun.count_mesh(mesh_cfgs()[0], ShapeSpec("lm_mesh", "train", S, B),
                                             TrainConfig(**MESH_TCFG), mesh)
    info = cost_analysis.info_from_counts(counts, links)
    return {"info": info, "roofline": cost_analysis.roofline_from_info(info).as_dict(),
            "count_s": time.perf_counter() - t0}


def mesh_rank(rank: int, world: int, workdir: str, seed: int) -> None:
    """One card of the multi-card ``lm_mesh`` run (a spawned process):
    Qwen2-1.5B's step on (world, 1), deepseek's moe_fn on (1, world), then
    tensor parallelism on (1, world): Qwen2-1.5B and recurrentgemma-9b
    trained and served; with four cards Qwen2's step on (2, 2) too.  Rank
    0 also runs each on its own card alone and writes the record.  The
    (world, 1) Qwen2 step runs twice: wq and wk at fan-in d (every step,
    m and the parameters checked against one card) and at the raw init (its
    first step checked: its near one-hot attention makes the later
    gradients depend on the rows' split, as on one card)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    from repro_torch.launch.mesh import close_world, init_world, make_test_mesh
    dev = init_world("cuda", init_method=f"file://{workdir}/store")
    qwen, deepseek, rg = mesh_cfgs()
    B, S, steps = MESH_TRAIN
    batches = mesh_batches(qwen, B, S, steps, seed, dev)
    rec = {"rank": rank, "device": str(dev)}
    mesh = make_test_mesh((world, 1), device=dev)
    for key, fan in (("train", True), ("raw_init", False)):
        rec[key], full = mesh_train(qwen, batches, seed, dev, mesh, fan_in_d=fan)
        torch.distributed.barrier()
        if rank == 0:
            one, want = mesh_train(qwen, batches, seed, dev, fan_in_d=fan)
            rec[f"{key}_one_card"] = one
            rec[f"{key}_vs_one_card"] = mesh_same_train(rec[key], one, full, want,
                                                        raw_init=not fan)
            del want
        del full
        free_cuda()
        torch.distributed.barrier()
    tp_mesh = make_test_mesh((1, world), device=dev)
    rec["moe"] = mesh_moe(deepseek, tp_mesh, seed, dev, dense=rank == 0)
    free_cuda()
    t0 = time.perf_counter()
    one_qwen, one_rg = {}, {}
    rec["tp_qwen2"] = mesh_on_cards(qwen, seed, dev, tp_mesh, rank, train=MESH_TRAIN,
                                    serve=MESH_SERVE, one=one_qwen)
    free_cuda()
    rec["count_qwen2"] = mesh_count_step(qwen, seed, dev, tp_mesh)
    free_cuda()
    rg_serve = (MESH_RG[1], MESH_RG[2], MESH_SERVE[2], MESH_SERVE[3])
    rec["tp_recurrentgemma"] = mesh_on_cards(rg, seed, dev, tp_mesh, rank, train=MESH_RG[1:],
                                             serve=rg_serve, one=one_rg)
    one_rg.pop("state", None)
    free_cuda()
    if world == 4:
        m22 = make_test_mesh((2, 2), device=dev)
        rec["tp_qwen2_2x2"] = mesh_on_cards(qwen, seed, dev, m22, rank, train=MESH_TRAIN,
                                            serve=MESH_SERVE, one=one_qwen)
    if rank == 0:
        rec["tp_one_card"] = {"qwen2": {k: one_qwen[k] for k in ("train", "serve")},
                              "recurrentgemma": {k: one_rg[k] for k in ("train", "serve")}}
    rec["tp_s"] = time.perf_counter() - t0
    del one_qwen, one_rg
    free_cuda()
    Path(workdir, f"rank{rank}.json").write_text(json.dumps(rec))
    close_world()


def phase_lm_mesh(seed: int) -> None:
    """The LM mesh on one card in a one-rank NCCL group made in this
    process: Qwen2-1.5B at published width (2 layers; wq and wk at fan-in
    d) for MESH_TRAIN's bf16 steps on ``make_test_mesh((1, 1))`` (the
    FSDP / tensor-parallel step) against ``make_train_step`` unsharded,
    and its prefill and greedy decode through ``distributed.tp`` on
    (1, 1) against ``serving.decode`` (bit-equal: a one-rank mesh cuts no
    leaf); deepseek-moe-16b at published width (2 layers: the dense head
    layer and one MoE layer) forward with ``make_tp_moe_fn`` over a
    one-rank model group against the dense ``moe_ffn``.  With two or more
    cards, one NCCL process per card (up to four): the Qwen2 step on
    (D, 1), deepseek on (1, D), and tensor parallelism on (1, D) for
    Qwen2-1.5B and recurrentgemma-9b (3 layers), each against one card;
    with four, Qwen2 on (2, 2) too."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import close_world, init_world, make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check("RANK" not in os.environ, "lm_mesh: run chip_smoke.py alone, not under a launcher")
    free_cuda()
    launches0 = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    qwen, deepseek, rg = mesh_cfgs()
    B, S, steps = MESH_TRAIN
    dev = init_world("cuda")
    try:
        mesh = make_test_mesh((1, 1), device=dev)
        batches = mesh_batches(qwen, B, S, steps, seed, dev)
        plain, want = mesh_train(qwen, batches, seed, dev)
        free_cuda()
        sharded, got = mesh_train(qwen, batches, seed, dev, mesh)
        same = mesh_same_train(sharded, plain, got, want)
        check(same["ok"], f"lm_mesh: the sharded step differs {same}")
        del want, got
        free_cuda()
        serve_plain, served = mesh_serve(qwen, seed, dev, *MESH_SERVE)
        free_cuda()
        serve_1x1, got = mesh_serve(qwen, seed, dev, *MESH_SERVE, mesh=mesh)
        serve_same = mesh_same_serve(got, served)
        check(serve_same["bitwise"] and serve_same["tokens_equal"],
              f"lm_mesh: (1, 1) serving is not the unsharded serving {serve_same}")
        del served, got
        free_cuda()
        moe = mesh_moe(deepseek, mesh, seed, dev, dense=True)
        free_cuda()
    finally:
        close_world()
    one_card_s = time.perf_counter() - t0
    check(one_card_s <= MESH_BUDGET_S, f"lm_mesh: {one_card_s:.1f} s on one card")
    n = min(torch.cuda.device_count(), 4)
    multi = {"cards": n, "ran": n >= 2}
    if n >= 2:
        import concurrent.futures as cf
        import torch.multiprocessing as mp
        (ROOT / "build").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="chip-smoke-mesh-", dir=ROOT / "build"))
        try:
            # the dry-run count first, alone: the ranks' times are not read
            # beside a busy host process
            t1 = time.perf_counter()
            with cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
                multi["dry_run"] = pool.submit(dry_mesh_step, n).result()
            multi["dry_run_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            mp.spawn(mesh_rank, args=(n, str(work), seed), nprocs=n)
            multi["seconds"] = time.perf_counter() - t1
            multi["ranks"] = [json.loads((work / f"rank{r}.json").read_text())
                              for r in range(n)]
        finally:
            shutil.rmtree(work, ignore_errors=True)
        got, want = multi["ranks"][0]["count_qwen2"], multi["dry_run"]
        c, i = got["counts"], want["info"]
        multi["count_vs_dry_run"] = {
            "collective_bytes": [c["collective_bytes"], {k: v for k, v in
                                                         i["collective_bytes"].items()
                                                         if k != "total"}],
            "collective_bytes_by_axis": [c["collective_bytes_by_axis"],
                                         i["collective_bytes_by_axis"]],
            "collective_op_executions": [c["collective_op_executions"],
                                         i["collective_op_executions"]],
            "aten_ops": [c["aten_ops"], i["aten_ops"]],
            "argument_plus_temp_bytes": i["argument_size_in_bytes"] + i["temp_size_in_bytes"],
            "resident_bytes": got["resident_bytes"], "peak_bytes": got["peak_bytes"],
            "t_collective_s": want["roofline"]["t_collective_s"]}
    launched = {k: build.LAUNCHES[k] - launches0.get(k, 0) for k in build.LAUNCHES}
    emit("lm_mesh", layers=MESH_LAYERS, train_shape=MESH_TRAIN, moe_shape=MESH_MOE,
         serve_shape=MESH_SERVE, recurrentgemma_shape=MESH_RG,
         tolerances=MESH_TOL, qwen2_unsharded=plain, qwen2_sharded_1x1=sharded,
         qwen2_sharded_vs_unsharded=same, qwen2_serve_unsharded=serve_plain,
         qwen2_serve_1x1=serve_1x1, qwen2_serve_1x1_vs_unsharded=serve_same,
         deepseek_moe_fn_vs_dense=moe, one_card_s=one_card_s, multi_card=multi,
         graph_kernel_launches=launched, seconds=time.perf_counter() - t0)
    check(not any(launched.values()), f"lm_mesh: a graph kernel launched {launched}")
    if n >= 2:          # checked after the line is printed, so a failure shows its numbers
        devices = {r["device"] for r in multi["ranks"]}
        check(len(devices) == n, f"lm_mesh: ranks on {devices}")
        r0 = multi["ranks"][0]
        for key, cmp in [(k, r0[k]) for k in ("train_vs_one_card", "raw_init_vs_one_card")] + [
                (f"{k}.{c}", r0[k][c]) for k in ("tp_qwen2", "tp_recurrentgemma", "tp_qwen2_2x2")
                if k in r0 for c in ("train_vs_one_card", "serve_vs_one_card")]:
            check(cmp["ok"], f"lm_mesh: {key} differs from one card {cmp}")
        cmp = multi["count_vs_dry_run"]
        for key in ("collective_bytes", "collective_bytes_by_axis", "collective_op_executions"):
            check(cmp[key][0] == cmp[key][1],
                  f"lm_mesh: rank 0's counted {key} differs from the dry run's {cmp[key]}")
        for r in multi["ranks"]:
            check(r["moe"]["experts_per_card"] == deepseek.n_experts // n,
                  f"lm_mesh: rank {r['rank']} computed {r['moe']['experts_per_card']} experts")
            for key in ("tp_qwen2", "tp_recurrentgemma"):       # (1, D): 1/D a card
                t, s = r[key]["train"], r[key]["serve"]
                check(t["sharded_param_bytes"] * n == t["sharded_whole_bytes"]
                      and s["cache_bytes"] * n == s["cache_whole_bytes"]
                      and s["logit_bytes"] * n == s["logit_whole_bytes"],
                      f"lm_mesh: rank {r['rank']} {key} holds other than 1/{n}")


# ---------------------------------------------------------------------------
# cost: the dry run (repro_torch.launch.dryrun) of the calls the lm and
# train phases time, at their shapes, on the meta device (no card)
# ---------------------------------------------------------------------------

# name -> (arch, (kind, seq, batch), TrainConfig fields): Qwen2-1.5B's bf16
# prefill and decode step (the caches grown past the prompt by the greedy
# tokens and the profiled step), its bf16 train step, and the train CLI's
# xLSTM-125M step
COST_CELLS = {
    "qwen2_prefill": ("qwen2_1_5b", ("prefill", LM_SERVE[1], LM_SERVE[0]), {}),
    "qwen2_decode": ("qwen2_1_5b", ("decode", LM_SERVE[1] + LM_SERVE[2] + 1, LM_SERVE[0]),
                     {}),
    "qwen2_train": ("qwen2_1_5b", ("train", TRAIN_BF16[1], TRAIN_BF16[0]),
                    {"remat": True, "flash_cv": True}),
    "xlstm_train": ("xlstm_125m", ("train", int(TRAIN_CLI[TRAIN_CLI.index("--seq") + 1]),
                                   int(TRAIN_CLI[TRAIN_CLI.index("--batch") + 1])),
                    {"remat": True}),
}


def cost_args(name: str) -> tuple:
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.train.step import TrainConfig
    arch, shape, kw = COST_CELLS[name]
    return arch, ShapeSpec(name, *shape), TrainConfig(**kw)


# name -> (arch, shape, --mesh): the production meshes' records of
# Qwen2-1.5B's train_4k, each counted in a spawned process
COST_MESH_CELLS = {"qwen2_train_4k_single": ("qwen2_1_5b", "train_4k", "single"),
                   "qwen2_train_4k_multi": ("qwen2_1_5b", "train_4k", "multi")}
COST_MESH_BUDGET_S = 60.0


def mesh_arg_bytes(arch: str, shape: str, mesh: str) -> int:
    """Rank 0's argument bytes of a train cell from the resolver's specs
    alone: its blocks of the parameters (``param_shardings``), of m and v
    (``opt_shardings``, float32) and the step, and its rows of the batch
    (``batch_shardings``)."""
    from repro_torch.configs import SHAPES, get_config, input_specs
    from repro_torch.launch.sharding import batch_shardings, opt_shardings, param_shardings
    from repro_torch.models.transformer import abstract_params
    cfg = get_config(arch)
    sizes = {"single": {"data": 16, "model": 16},
             "multi": {"pod": 2, "data": 16, "model": 16}}[mesh]
    m = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    full = dict(abstract_params(cfg).named_parameters())
    p, o = param_shardings(cfg, m), opt_shardings(cfg, m)
    total = sum(t.numel() // spec_parts(p[n], m) * t.element_size() for n, t in full.items())
    total += sum(t.numel() // spec_parts(o[k][n], m) * 4 for k in ("m", "v")
                 for n, t in full.items()) + 4
    batch = input_specs(cfg, SHAPES[shape])
    specs = batch_shardings(m, {k: v.shape for k, v in batch.items()})
    return total + sum(int(np.prod(v.shape)) // spec_parts(specs[k], m)
                       * torch.empty((), dtype=v.dtype).element_size()
                       for k, v in batch.items())


EXAMPLES = ("torch_quickstart", "torch_serve_queries", "torch_mapreduce_demo",
            "torch_train_lm")
EXAMPLES_BUDGET_S = 30.0


def example_matches(name: str, lines: list) -> int:
    """The oracle checks an example printed, all MATCH (raises on any
    other verdict): their number."""
    if name == "torch_quickstart":
        verdicts = [l.split()[-1] for l in lines if l.startswith("oracle check:")]
    elif name == "torch_serve_queries":
        verdicts = [l.split()[-1] for l in lines if l.strip().startswith("oracle:")]
    else:
        verdicts = [l.split()[-3] for l in lines if l.endswith(" vs oracle")]
    check(verdicts and set(verdicts) == {"MATCH"}, f"examples: {name} printed {verdicts}")
    return len(verdicts)


def phase_examples(workdir: Path) -> int:
    """The four examples in process on the card: each ``main`` loaded from
    its file and called with the card as its device (``torch_train_lm`` at
    20 steps, its checkpoints under ``workdir``), its output captured.
    Each returns 0; the graph examples' oracle checks all MATCH and the
    step kernel launches under each (counted from 0 just before it, read
    just after); the training demo prints its done line and launches no
    graph kernel.  Returns the step launches of the three."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    rec, total = {}, 0
    t_phase = time.perf_counter()
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = ([] if name != "torch_train_lm" else
                ["--steps", "20", "--ckpt-dir", str(workdir / "train_lm")])
        out = io.StringIO()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main(argv)
        seconds = time.perf_counter() - t0
        n = build.LAUNCHES[NAME]
        lines = out.getvalue().splitlines()
        check(rc == 0, f"examples: {name} returned {rc}")
        if name == "torch_train_lm":
            check(n == 0 and lines[-1].startswith("[train] done. final loss"),
                  f"examples: {name} ended {lines[-1:]} with {n} step launches")
            rec[name] = {"seconds": seconds, "last_line": lines[-1]}
        else:
            check(n > 0, f"examples: {name} launched no {NAME}")
            rec[name] = {"seconds": seconds, "matches": example_matches(name, lines),
                         "fused_frontier_launches": n, "first_line": lines[0]}
            total += n
    phase_s = time.perf_counter() - t_phase
    check(phase_s <= EXAMPLES_BUDGET_S, f"examples: {phase_s:.1f} s")
    emit("examples", seconds=phase_s, examples=rec, fused_frontier_launches=total)
    return total


def phase_cost() -> dict:
    """The dry-run record of every COST_CELLS cell, counted here on the
    host (no card): each cell's bound, ATen ops, useful-FLOP ratio and
    argument + temp bytes; then the COST_MESH_CELLS records, checked, one
    after another in one spawned process (so no count_s is read beside
    another count, and the process's imports are paid once).  ``added_s``
    is the time this phase added to the script, ``mesh_added_s`` the part
    of it the mesh records took."""
    import concurrent.futures as cf
    import multiprocessing as mp
    from repro_torch.launch.dryrun import run_cell
    t0 = time.perf_counter()
    cells = {n: run_cell(*cost_args(n)) for n in COST_CELLS}
    t1 = time.perf_counter()
    with cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        mesh_cells = {n: pool.submit(run_cell, a, s, mesh=m).result()
                      for n, (a, s, m) in COST_MESH_CELLS.items()}
    added = time.perf_counter() - t0
    mesh_added = time.perf_counter() - t1
    out = {}
    for n, c in cells.items():
        check(c["status"] == "ok" and c["roofline"]["t_bound_s"] > 0, f"cost {n}: {c}")
        i = c["info"]
        out[n] = {"arch": c["arch"], "kind": c["kind"], "batch": c["batch"], "seq": c["seq"],
                  **{k: c["roofline"][k] for k in ("t_bound_s", "t_compute_s", "t_memory_s",
                                                   "dominant")},
                  "flops_by_class": i["flops_by_class"], "bytes": i["bytes_accessed"],
                  "aten_ops": i["aten_ops"], "useful_flops_ratio": c["useful_flops_ratio"],
                  "argument_plus_temp_bytes": (i["argument_size_in_bytes"]
                                               + i["temp_size_in_bytes"]),
                  "temp_peak_exact": c["depth"]["temp_peak_exact"],
                  "fits": c["fits"], "count_s": c["count_s"]}
    mesh_out = {}
    for n, c in mesh_cells.items():
        arch, shape, mesh = COST_MESH_CELLS[n]
        check(c["status"] == "ok", f"cost {n}: {c}")
        i, r = c["info"], c["roofline"]
        mesh_out[n] = {"mesh": c["mesh"], "n_chips": c["n_chips"], "rank": c["rank"],
                       **{k: r[k] for k in ("dominant", "t_bound_s", "t_compute_s",
                                            "t_memory_s", "t_collective_s")},
                       "collective_bytes_by_axis": i["collective_bytes_by_axis"],
                       "links": {a: l["link"] for a, l in i["interconnect"]["axes"].items()},
                       "argument_bytes": i["argument_size_in_bytes"],
                       "argument_bytes_from_specs": mesh_arg_bytes(arch, shape, mesh),
                       "argument_plus_temp_bytes": (i["argument_size_in_bytes"]
                                                    + i["temp_size_in_bytes"]),
                       "useful_flops_ratio": c["useful_flops_ratio"], "fits": c["fits"],
                       "count_s": c["count_s"]}
    emit("cost", cells=out, mesh_cells=mesh_out, added_s=added, mesh_added_s=mesh_added)
    for n, c in mesh_out.items():   # checked after the line is printed
        check(c["n_chips"] == {"16x16": 256, "2x16x16": 512}[c["mesh"]]
              and c["t_collective_s"] > 0, f"cost {n}: {c}")
        check(c["argument_bytes"] == c["argument_bytes_from_specs"],
              f"cost {n}: argument bytes {c['argument_bytes']} against the specs' "
              f"{c['argument_bytes_from_specs']}")
        pod = c["collective_bytes_by_axis"].get("pod", {})
        check({k for k, v in pod.items() if v} <= {"all-reduce"},
              f"cost {n}: the pod axis carries {pod}")
    check("pod" in mesh_out["qwen2_train_4k_multi"]["collective_bytes_by_axis"],
          "cost: the multi record has no pod collective")
    check(mesh_added <= COST_MESH_BUDGET_S, f"cost: the mesh records added {mesh_added:.1f} s")
    return cells


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=200.0,
                    help="synthetic dataset scale (200 = the paper's 400K/1200K)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    # the card's SM count and top SM clock beside the peaks the resource
    # profiler's roofline assumes (obs/profile.py)
    from repro_torch.launch import cost_analysis
    from repro_torch.obs import profile
    props = torch.cuda.get_device_properties(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         sms=props.multi_processor_count, capability=[props.major, props.minor],
         clocks_max_sm=smi_line("clocks.max.sm"),
         roofline={"sms": profile.H100_SMS, "max_sm_clock_hz": profile.H100_MAX_SM_CLOCK_HZ,
                   "int32_ops_per_s": profile.H100_INT32_OPS_PER_S,
                   "hbm_bytes_per_s": profile.H100_HBM_BYTES_PER_S,
                   "dry_run_flops_per_s": cost_analysis.PEAK_FLOPS},
         total_memory=props.total_memory)

    t0 = time.perf_counter()
    info = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: {k: v for k, v in d.items() if k != "log"} for n, d in info.items()})

    (ROOT / "build").mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip-smoke-", dir=ROOT / "build"))
    try:
        pg = phase_graph(args.scale, args.seed)
        timing = phase_kernels(args.seed, pg)
        phase_small(args.seed, workdir)
        launches, sess, oracle, served = phase_path(pg)
        sni = phase_sni(pg, sess)
        tsess, tserved = phase_traditional(pg, oracle)
        sessions = {"opat": sess, "traditional": tsess}
        phase_shared(sessions, oracle, {"opat": served, "traditional": tserved})
        mlaunches, msess, mserved, mgated = phase_mapreduce(pg, oracle)
        xlaunches = phase_mesh(pg, oracle, msess, mserved, mgated)
        phase_cli(workdir)
        phase_profile({**sessions, "mapreduce": msess}, served[1][0])
        plaunches = phase_metrics(pg, {**sessions, "mapreduce": msess},
                                  {"opat": served, "traditional": tserved,
                                   "mapreduce": mserved}, workdir)
        flaunches = phase_frontend({**sessions, "mapreduce": msess}, oracle, pg)
        olaunches = phase_ooc(pg, sess, oracle, workdir)
        rlaunches = phase_repartition(pg, sess, oracle)
        ulaunches = phase_mutation(pg, workdir)
        elaunches = phase_examples(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del pg, sess, tsess, msess, sessions, oracle, served, tserved, mserved, mgated
    cost = phase_cost()
    phase_lm(args.seed, cost)
    phase_train(args.seed, cost)
    phase_lm_mesh(args.seed)

    # the step's launches on each engine's serving path (path, traditional,
    # mapreduce, its meshes, the profiled sessions, the front end, the three
    # engines out of core, the repartitioned OPAT session, the mutable
    # sessions, the graph examples), each counted from 0 in its own phase
    step_launches = (launches + RECORD["traditional"]["fused_frontier_launches"]
                     + mlaunches + xlaunches + plaunches + flaunches + olaunches
                     + rlaunches + ulaunches + elaunches)
    sources = {
        "fused_frontier": ("src/repro/kernels/fused_frontier.py:61", step_launches),
        "frontier_expand": ("src/repro/kernels/frontier_expand.py:47",
                            sni["frontier_expand"]),
        "label_histogram": ("src/repro/kernels/label_histogram.py:23",
                            sni["label_histogram"])}
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": timing[name]["max_abs_err"],
                "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
                "bound_ms": timing[name]["bound_ms"],
                "bound_by": timing[name]["bound_by"],
                "library_ms": timing[name]["library_ms"]}
               for name, (replaces, n) in sources.items()]
    RECORD["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
