"""Dry run on NVIDIA H100s: count every (arch x shape) cell op by op on
the ``meta`` device and record its roofline, on one card or as one rank's
share of the production meshes.  The port's counterpart of the JAX
package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out results/dryrun --tag baseline

The reference lowers and compiles each cell for a 256- or 512-chip mesh
and reads its HLO.  Here each cell is built from ``abstract_params``,
``abstract_opt_state``, ``abstract_caches`` and ``input_specs`` on
``meta``, and the port's program (by the shape's kind) runs under
``op_cost.OpCostMode``, through ``analyze_stack``.  Nothing is allocated
or computed, so no card is needed.

``--mesh`` picks the cells' mesh:
  card    (the default) one H100 running the one-process
          ``make_train_step``, ``prefill`` or ``decode_step``; ``"mesh":
          "1xH100"``, file tag ``__card__``
  single  rank 0 of the (16, 16) ("data", "model") mesh, 256 H100s;
          ``"mesh": "16x16"``, file tag ``__single__``
  multi   rank 0 of the (2, 16, 16) mesh with "pod", 512 H100s;
          ``"mesh": "2x16x16"``, file tag ``__multi__``
  both    single and multi, as in the reference
A mesh cell runs in a ``counting_world`` of 256 or 512 ranks on torch's
``fake`` backend: ``build_call`` cuts the parameters and optimizer state
(``fsdp.shard_model`` / ``shard_opt_state``), the batch
(``fsdp.local_batch``) and the caches (``cache_shardings``) to rank 0's
blocks on ``meta`` and runs ``fsdp.make_train_step``, ``tp.make_prefill``
or ``tp.make_decode_step``, whose collectives the counter keys by mesh
axis; ``cost_analysis`` puts them on NVLink or the network.  The record's
numbers are rank 0's (``"rank": 0``; ``fits`` is per card) but
``hlo_flops_total``, rank 0's FLOPs times the ranks, as the reference's.
``--tp-act``, ``--embed-replicated`` and ``--moe-tp`` are the reference's
variants of the mesh cells; they shard, so ``--mesh card`` rejects them.

One JSON per cell is written to ``--out``
(``{arch}__{shape}__{mesh}__{tag}.json``, the names
``benchmarks/roofline.py`` reads); an existing file that holds a record
of its cell's mesh is skipped unless ``--force``, so a killed sweep
resumes where it stopped.  Cells are counted at once, one spawned
process each, up to the CPU count; a mesh cell always in a spawned
process, since the process group belongs to the whole process.
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
# --mesh name -> (the record's "mesh", the production mesh's multi_pod);
# "card" counts one H100 and no mesh
MESHES = {"card": (MESH, None), "single": ("16x16", False), "multi": ("2x16x16", True)}
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


def build_call(cfg: ModelConfig, shape: ShapeSpec, tcfg: TrainConfig, mesh=None, *,
               embed_vocab_shard: bool = True, moe_tp: bool = False):
    """(fn, args, kwargs) of one cell on ``meta``: the train step (params,
    optimizer state, batch), prefill (params, batch) or one decode step
    at the cache's last position (params, caches, the new token).  With a
    ``mesh`` (``launch.mesh.Mesh``, of any shape) the counterpart of the
    reference's ``build_cell``: this rank's blocks of every argument and
    the sharded program (``fsdp.make_train_step``, ``tp.make_prefill``,
    ``tp.make_decode_step``), ``tcfg.tp_act`` cutting the residual
    stream, ``embed_vocab_shard=False`` keeping the embedding's vocab
    whole, ``moe_tp`` routing MoE layers through ``make_tp_moe_fn``."""
    batch = meta_inputs(cfg, shape)
    if mesh is None:
        params = abstract_params(cfg)
        if shape.kind == "train":
            return (make_train_step(cfg, tcfg), (params, abstract_opt_state(params), batch),
                    {})
        if shape.kind == "prefill":
            return (lambda p, b: prefill(p, cfg, b, q_chunk=tcfg.q_chunk),
                    (params, batch), {})
        caches = abstract_caches(cfg, shape.batch, shape.seq)
        return (lambda p, c, b: decode_step(p, cfg, c, b, shape.seq - 1),
                (params, caches, batch), {})
    from ..distributed import fsdp, tp
    from ..models.layers import make_tp_moe_fn
    from .sharding import NamedSharding, _batch_dim_spec, cache_shardings
    B = shape.batch
    model = fsdp.shard_model(abstract_params(cfg), mesh, embed_vocab_shard=embed_vocab_shard)
    # this rank's rows in storages of their own (a slice keeps the batch's)
    local = {k: v.clone() for k, v in fsdp.local_batch(batch, mesh).items()}
    moe_fn = (make_tp_moe_fn(mesh, _batch_dim_spec(mesh, B), cfg)
              if moe_tp and cfg.is_moe else None)
    if shape.kind == "train":
        opt = fsdp.shard_opt_state(abstract_opt_state(abstract_params(cfg)), model, mesh)
        return fsdp.make_train_step(cfg, tcfg, mesh, B, moe_fn), (model, opt, local), {}
    if shape.kind == "prefill":
        return (tp.make_prefill(cfg, mesh, B, shape.seq, tp_act=tcfg.tp_act, moe_fn=moe_fn,
                                q_chunk=tcfg.q_chunk), (model, local), {})
    specs = cache_shardings(cfg, mesh, B, shape.seq)
    caches = [{k: NamedSharding(mesh, sp[k]).shard(t) for k, t in c.items()}
              for c, sp in zip(abstract_caches(cfg, B, shape.seq), specs)]
    step = tp.make_decode_step(cfg, mesh, B, shape.seq)
    return (lambda m, c, b: step(m, c, b, shape.seq - 1), (model, caches, local), {})


def count_mesh(cfg: ModelConfig, shape: ShapeSpec, tcfg: TrainConfig, mesh, **variant):
    """(counts, depth, links) of this rank's share of one cell on ``mesh``
    (``build_call``'s ``variant`` keywords), its collectives keyed by the
    mesh's group labels; ``links`` is ``cost_analysis.axis_links`` of
    them."""
    groups = mesh.axis_labels()
    counts, depth = analyze_stack(cfg, lambda c: build_call(c, shape, tcfg, mesh, **variant),
                                  groups)
    links = cost_analysis.axis_links(mesh.shape, sorted(set(groups.values())))
    return counts, depth, links


def run_cell(arch: str, shape: Union[str, ShapeSpec],
             tcfg: Optional[TrainConfig] = None, *, mlstm_chunk: int = 0,
             smoke: bool = False, mesh: str = "card", embed_vocab_shard: bool = True,
             moe_tp: bool = False) -> Dict:
    """One cell's record, with the reference's keys, ``count_s`` in place
    of ``lower_s``/``compile_s``, ``fits`` (argument + temp bytes within
    one card's memory; the temp peak is a lower bound where
    ``depth["temp_peak_exact"]`` is False, see ``op_cost``) and the
    ``top_contributors`` of the byte floor.  ``shape`` is a name in
    ``SHAPES`` or a ``ShapeSpec``; ``smoke`` counts the reduced config.
    ``mesh`` is a key of ``MESHES``: on "single" or "multi" the record is
    rank 0's share (``"rank": 0``, the bytes per group label under
    ``info["collective_bytes_by_axis"]`` and the links under
    ``info["interconnect"]``), counted in a ``counting_world`` made here
    (this process must have no process group)."""
    cfg = get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    if mlstm_chunk:
        cfg = dataclasses.replace(cfg, mlstm_chunk=mlstm_chunk)
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    name, multi_pod = MESHES[mesh]
    rec: Dict = {"arch": arch, "shape": spec.name, "mesh": name, "kind": spec.kind,
                 "batch": spec.batch, "seq": spec.seq}
    ok, why = shape_applicable(cfg, spec)
    if not ok:
        rec["status"] = "skipped"
        rec["skip_reason"] = why
        return rec
    tcfg = tcfg or TrainConfig()
    t0 = time.perf_counter()
    if multi_pod is None:
        if tcfg.tp_act or not embed_vocab_shard or moe_tp:
            raise ValueError("tp_act, embed_vocab_shard=False and moe_tp shard: count "
                             "them on a mesh")
        counts, depth = analyze_stack(cfg, lambda c: build_call(c, spec, tcfg))
        n_chips, links = 1, None
    else:
        from .mesh import counting_world, make_production_mesh
        n_chips = 512 if multi_pod else 256
        with counting_world(n_chips):
            m = make_production_mesh(multi_pod=multi_pod, device="cpu")
            counts, depth, links = count_mesh(cfg, spec, tcfg, m,
                                              embed_vocab_shard=embed_vocab_shard,
                                              moe_tp=moe_tp)
    count_s = time.perf_counter() - t0
    info = cost_analysis.info_from_counts(counts, links)
    terms = cost_analysis.roofline_from_info(info)
    mf = model_flops(cfg, spec.kind, spec.batch, spec.seq)
    total = terms.device_flops * n_chips
    mem = info["argument_size_in_bytes"] + info["temp_size_in_bytes"]
    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        **({} if links is None else {"rank": 0}),
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


# the mesh variants: args attribute -> flag
VARIANTS = {"tp_act": "--tp-act", "embed_replicated": "--embed-replicated",
            "moe_tp": "--moe-tp"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="dry-run cost records on H100s")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card", choices=["card", "single", "multi", "both"],
                    help="card: one H100; single: rank 0 of (16, 16), 256 H100s; "
                         "multi: rank 0 of (2, 16, 16), 512 H100s; both: single and multi")
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
    ap.add_argument("--tp-act", action="store_true",
                    help="shard [B,S,d] activations over the model axis (a mesh only)")
    ap.add_argument("--embed-replicated", action="store_true",
                    help="vocab-replicated embedding table (a mesh only)")
    ap.add_argument("--moe-tp", action="store_true",
                    help="expert-parallel MoE dispatch over model (a mesh only)")
    return ap


def cells(arch: str, shape: str) -> List[tuple]:
    archs = list(ARCHS) if arch == "all" else [
        a.replace("-", "_").replace(".", "_") for a in arch.split(",")]
    shapes = list(SHAPES) if shape == "all" else shape.split(",")
    return [(a, s) for a in archs for s in shapes]


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.mesh == "card":
        for attr, flag in VARIANTS.items():
            if getattr(args, attr):
                ap.error(f"{flag} shards the program: it needs --mesh single, multi or both")
    tcfg = TrainConfig(remat=not args.no_remat, causal_skip=args.causal_skip,
                       q_chunk=args.q_chunk, kv_chunk=args.kv_chunk, tp_act=args.tp_act,
                       attn_remat=args.attn_remat, flash_cv=args.flash_cv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    jobs = []
    for arch, shape in cells(args.arch, args.shape):
        for mesh in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mesh}__{args.tag}.json")
            if not args.force and holds_record(path, mesh):
                print(f"[skip existing] {path}")
            else:
                jobs.append((arch, shape, path, tcfg, args.mlstm_chunk, args.smoke, mesh,
                             not args.embed_replicated, args.moe_tp))
    n_workers = min(len(jobs), os.cpu_count() or 1)
    if n_workers > 1 or (jobs and args.mesh != "card"):
        import concurrent.futures as cf
        import multiprocessing as mp
        with cf.ProcessPoolExecutor(n_workers, mp_context=mp.get_context("spawn")) as pool:
            for f in cf.as_completed([pool.submit(write_cell, *job) for job in jobs]):
                report(f.result())
    else:
        for job in jobs:
            print(f"[cell] {job[0]} x {job[1]} x {job[6]} ...", flush=True)
            report(write_cell(*job))
    return 0


def holds_record(path: str, mesh: str) -> bool:
    """Whether ``path`` holds a record of ``mesh`` (a key of ``MESHES``).
    A rerun keeps only such a file: one of another mesh under the same
    name, as a one-card record written under the ``single`` tag, is
    counted again."""
    try:
        with open(path) as f:
            return json.load(f).get("mesh") == MESHES[mesh][0]
    except (OSError, ValueError):
        return False


def write_cell(arch: str, shape: str, path: str, tcfg: TrainConfig, mlstm_chunk: int,
               smoke: bool, mesh: str = "card", embed_vocab_shard: bool = True,
               moe_tp: bool = False) -> Dict:
    """One cell's record, written to ``path`` (an error is recorded too)."""
    try:
        rec = run_cell(arch, shape, tcfg, mlstm_chunk=mlstm_chunk, smoke=smoke, mesh=mesh,
                       embed_vocab_shard=embed_vocab_shard, moe_tp=moe_tp)
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": MESHES[mesh][0], "status": "error",
               "error": repr(e), "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return rec


def report(rec: Dict) -> None:
    status = rec.get("status")
    head = f"  {rec['arch']} x {rec['shape']} x {rec['mesh']}"
    if status == "ok":
        r = rec["roofline"]
        print(f"{head} ok: dominant={r['dominant']} "
              f"t_comp={r['t_compute_s']:.4f}s "
              f"t_mem={r['t_memory_s']:.4f}s "
              f"t_coll={r['t_collective_s']:.4f}s "
              f"t_bound={r['t_bound_s']:.4f}s "
              f"useful={rec['useful_flops_ratio']:.3f} fits={rec['fits']} "
              f"(count {rec['count_s']}s)", flush=True)
    elif status == "skipped":
        print(f"{head} skipped: {rec['skip_reason']}", flush=True)
    else:
        print(f"{head} ERROR: {rec.get('error')}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
