"""Dry run on one NVIDIA H100: count every (arch x shape) cell op by op on
the ``meta`` device and record its roofline.  The port's counterpart of
the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out results/dryrun --tag baseline

The reference lowers and compiles each cell for a 256- or 512-chip mesh
and reads its HLO.  Here each cell is built from ``abstract_params``,
``abstract_opt_state``, ``abstract_caches`` and ``input_specs`` on
``meta``, and the port's ``make_train_step``, ``prefill`` or
``decode_step`` (by the shape's kind) runs under ``op_cost.OpCostMode``,
through ``analyze_stack``.  Nothing is allocated or computed, so no card
is needed; the roofline is one H100's (``cost_analysis``).

One JSON per cell is written to ``--out``
(``{arch}__{shape}__single__{tag}.json``, the names
``benchmarks/roofline.py`` reads); existing files are skipped unless
``--force``, so a killed sweep resumes where it stopped.  Several cells
are counted at once, one spawned process each, up to the CPU count.  The
reference's mesh flags (``--mesh multi``, ``--tp-act``,
``--embed-replicated``, ``--moe-tp``) count a sharded program on a
256- or 512-rank mesh; they wait for the slice after dense tensor
parallelism over the ``model`` axis and are rejected.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional, Union

import torch

from ..configs import (ARCHS, SHAPES, get_config, input_specs, reduced,
                       shape_applicable)
from ..configs.registry import ShapeSpec
from ..models.config import ModelConfig
from ..models.transformer import abstract_params
from ..serving.decode import abstract_caches, decode_step, prefill
from ..train.optimizer import abstract_opt_state
from ..train.step import TrainConfig, make_train_step
from . import cost_analysis
from .op_cost import analyze_stack

MESH = "1xH100"
TOP_K = 20          # top_contributors kept in a record


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode), N = active params."""
    n = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch


def meta_inputs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """``input_specs`` as empty tensors on ``meta``."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in input_specs(cfg, shape).items()}


def build_call(cfg: ModelConfig, shape: ShapeSpec, tcfg: TrainConfig):
    """(fn, args, kwargs) of one cell on ``meta``: the train step (params,
    optimizer state, batch), prefill (params, batch) or one decode step
    at the cache's last position (params, caches, the new token)."""
    params = abstract_params(cfg)
    batch = meta_inputs(cfg, shape)
    if shape.kind == "train":
        return make_train_step(cfg, tcfg), (params, abstract_opt_state(params), batch), {}
    if shape.kind == "prefill":
        return (lambda p, b: prefill(p, cfg, b, q_chunk=tcfg.q_chunk),
                (params, batch), {})
    caches = abstract_caches(cfg, shape.batch, shape.seq)
    return (lambda p, c, b: decode_step(p, cfg, c, b, shape.seq - 1),
            (params, caches, batch), {})


def run_cell(arch: str, shape: Union[str, ShapeSpec],
             tcfg: Optional[TrainConfig] = None, *, mlstm_chunk: int = 0,
             smoke: bool = False) -> Dict:
    """One cell's record, with the reference's keys (``mesh`` is
    ``"1xH100"``), ``count_s`` in place of ``lower_s``/``compile_s``,
    ``fits`` (argument + temp bytes within the card's memory; the temp
    peak is a lower bound where ``depth["temp_peak_exact"]`` is False, see
    ``op_cost``) and the ``top_contributors`` of the byte floor.  ``shape``
    is a name in ``SHAPES`` or a ``ShapeSpec``; ``smoke`` counts the
    reduced config."""
    cfg = get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    if mlstm_chunk:
        cfg = dataclasses.replace(cfg, mlstm_chunk=mlstm_chunk)
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    rec: Dict = {"arch": arch, "shape": spec.name, "mesh": MESH, "kind": spec.kind,
                 "batch": spec.batch, "seq": spec.seq}
    ok, why = shape_applicable(cfg, spec)
    if not ok:
        rec["status"] = "skipped"
        rec["skip_reason"] = why
        return rec
    tcfg = tcfg or TrainConfig()
    t0 = time.perf_counter()
    counts, depth = analyze_stack(cfg, lambda c: build_call(c, spec, tcfg))
    count_s = time.perf_counter() - t0
    info = cost_analysis.info_from_counts(counts)
    terms = cost_analysis.roofline_from_info(info)
    mf = model_flops(cfg, spec.kind, spec.batch, spec.seq)
    total = terms.device_flops
    mem = info["argument_size_in_bytes"] + info["temp_size_in_bytes"]
    rec.update({
        "status": "ok",
        "n_chips": 1,
        "count_s": round(count_s, 2),
        "depth": depth,
        "info": info,
        "roofline": terms.as_dict(),
        "model_flops_total": mf,
        "hlo_flops_total": total,
        "useful_flops_ratio": (mf / total) if total else None,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "fits": mem <= cost_analysis.H100_MEMORY_BYTES,
        "top_contributors": [list(r) for r in counts.top_contributors(TOP_K)],
    })
    return rec


REJECTED = {"tp_act": "--tp-act", "embed_replicated": "--embed-replicated",
            "moe_tp": "--moe-tp"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="dry-run cost records on one H100")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"],
                    help="single only: the multi-chip mesh's cost records "
                         "wait for the slice after dense tensor parallelism")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="count the reduced (CPU-sized) configs")
    ap.add_argument("--tag", default="baseline",
                    help="experiment tag appended to output filenames")
    ap.add_argument("--causal-skip", action="store_true",
                    help="bound each query chunk's key loop at its causal horizon")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--kv-chunk", type=int, default=512)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--mlstm-chunk", type=int, default=0,
                    help="chunkwise-parallel mLSTM chunk size")
    ap.add_argument("--attn-remat", action="store_true",
                    help="recompute attention tiles in backward")
    ap.add_argument("--flash-cv", action="store_true",
                    help="flash_attention_cv's hand-written backward")
    for flag in REJECTED.values():
        ap.add_argument(flag, action="store_true",
                        help="rejected: waits for the slice after dense tensor "
                             "parallelism")
    return ap


def cells(arch: str, shape: str) -> List[tuple]:
    archs = list(ARCHS) if arch == "all" else [
        a.replace("-", "_").replace(".", "_") for a in arch.split(",")]
    shapes = list(SHAPES) if shape == "all" else shape.split(",")
    return [(a, s) for a in archs for s in shapes]


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.mesh != "single":
        ap.error(f"--mesh {args.mesh} (the reference's multi-chip mesh) waits for "
                 "the slice after dense tensor parallelism")
    for attr, flag in REJECTED.items():
        if getattr(args, attr):
            ap.error(f"{flag} costs a sharded program; it waits for the slice after "
                     "dense tensor parallelism")
    tcfg = TrainConfig(remat=not args.no_remat, causal_skip=args.causal_skip,
                       q_chunk=args.q_chunk, kv_chunk=args.kv_chunk,
                       attn_remat=args.attn_remat, flash_cv=args.flash_cv)
    os.makedirs(args.out, exist_ok=True)
    todo = []
    for arch, shape in cells(args.arch, args.shape):
        path = os.path.join(args.out, f"{arch}__{shape}__single__{args.tag}.json")
        if os.path.exists(path) and not args.force:
            print(f"[skip existing] {path}")
        else:
            todo.append((arch, shape, path))
    jobs = [(arch, shape, path, tcfg, args.mlstm_chunk, args.smoke)
            for arch, shape, path in todo]
    n_workers = min(len(jobs), os.cpu_count() or 1)
    if n_workers > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        with cf.ProcessPoolExecutor(n_workers, mp_context=mp.get_context("spawn")) as pool:
            for f in cf.as_completed([pool.submit(write_cell, *job) for job in jobs]):
                report(f.result())
    else:
        for job in jobs:
            print(f"[cell] {job[0]} x {job[1]} x single ...", flush=True)
            report(write_cell(*job))
    return 0


def write_cell(arch: str, shape: str, path: str, tcfg: TrainConfig,
               mlstm_chunk: int, smoke: bool) -> Dict:
    """One cell's record, written to ``path`` (an error is recorded too)."""
    try:
        rec = run_cell(arch, shape, tcfg, mlstm_chunk=mlstm_chunk, smoke=smoke)
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": MESH, "status": "error",
               "error": repr(e), "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return rec


def report(rec: Dict) -> None:
    status = rec.get("status")
    head = f"  {rec['arch']} x {rec['shape']}"
    if status == "ok":
        r = rec["roofline"]
        print(f"{head} ok: dominant={r['dominant']} "
              f"t_comp={r['t_compute_s']:.4f}s "
              f"t_mem={r['t_memory_s']:.4f}s "
              f"t_bound={r['t_bound_s']:.4f}s "
              f"useful={rec['useful_flops_ratio']:.3f} fits={rec['fits']} "
              f"(count {rec['count_s']}s)", flush=True)
    elif status == "skipped":
        print(f"{head} skipped: {rec['skip_reason']}", flush=True)
    else:
        print(f"{head} ERROR: {rec.get('error')}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
