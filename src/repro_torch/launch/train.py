"""End-to-end LM training, data parallel with FSDP over every rank (the
fault-tolerance harness).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2-1.5b ...

What it runs: AdamW train steps on the mesh ``make_test_mesh((N, 1))`` of
the N launched ranks (the reference's ``(jax.device_count(), 1)``; alone,
N = 1): each leaf FSDP-sharded over ``data`` by its resolved spec, each
rank fed its rows of the same ``TokenPipeline`` batch
(``distributed.fsdp``), only rank 0 printing.  Checkpoint and restart
(kill it mid-run and relaunch: it resumes from the last committed step
with the same data order, on any N), the straggler watchdog, and loss
logging.  ``--device cuda`` (the default; one card per rank, raises with
no card) or ``--device cpu`` (gloo); ``--smoke`` runs the reduced config.
Checkpoints have the JAX package's layout, so either package can resume
the other's.  ``--production`` trains on the (16, 16) mesh, which needs 256
ranks: FSDP over its data axis and dense tensor parallelism over its model
axis (heads, mlp, vocab, lru; ``distributed.tp``).  Inside
``launch.mesh.counting_world(256)`` this process runs rank 0's share of
that step on torch's ``fake`` backend (the collectives move nothing, so
the printed values are meaningless); ``main`` keeps a group it finds and
closes only one it opened.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.distributed as dist

from ..configs import get_config, reduced
from ..data.tokens import TokenPipeline, frontend_batch
from ..distributed import CheckpointManager, StepWatchdog, fsdp
from ..models.config import FAMILY_AUDIO
from ..models.transformer import init_params
from ..train.optimizer import OptConfig, init_opt_state
from ..train.step import TrainConfig
from .mesh import close_world, init_world, make_production_mesh, make_test_mesh


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LM training, data parallel over the ranks")
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced (CPU-sized) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--production", action="store_true",
                    help="use the production (16,16) mesh: 256 ranks, and "
                         "dense tensor parallelism over its model axis")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default; a card per rank, raises with "
                         "no card) or cpu (gloo)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    owned = not dist.is_initialized()
    dev = init_world(args.device)
    try:
        return _train(args, dev)
    finally:
        if owned:
            close_world()


def _train(args, dev: torch.device) -> int:
    mesh = (make_production_mesh(device=dev) if args.production
            else make_test_mesh((dist.get_world_size(), 1), device=dev))
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=args.lr, total_steps=args.steps),
                       remat=True)
    step_fn = fsdp.make_train_step(cfg, tcfg, mesh, args.batch)

    model = fsdp.shard_model(init_params(cfg, args.seed, device=dev), mesh)
    opt = init_opt_state(model, device=dev)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        restored = mgr.restore_or_none(fsdp.checkpoint_state(cfg, model, opt), device=dev,
                                       shardings=fsdp.state_shardings(cfg, model))
        if restored is not None:
            start, state, meta = restored
            fsdp.load_state(cfg, model, opt, state)
            pipe.load_state_dict(meta)
            say(f"[train] resumed from step {start}")

    wd = StepWatchdog()
    extra = frontend_batch(cfg, args.batch, args.seq, seed=args.seed)
    loss = None
    for step in range(start, args.steps):
        batch = dict(pipe.batch_at(step))
        batch.update(extra)
        if cfg.family == FAMILY_AUDIO:
            batch.pop("tokens", None)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in fsdp.local_batch(batch, mesh).items()}
        wd.start()
        metrics = step_fn(model, opt, batch)
        loss = metrics["loss"].item()   # blocks; doubles as step barrier
        dt = wd.stop()
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"[train] step {step:5d} loss {loss:8.4f} "
                f"nll {float(metrics['nll']):8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"{dt*1000:7.1f} ms"
                + (" [STRAGGLER]" if wd.is_straggler(dt) else ""),
                flush=True)
        if mgr is not None and mgr.due(step + 1):
            mgr.maybe_save(step + 1, fsdp.checkpoint_state(cfg, model, opt),
                           extra_meta=pipe.state_dict())
    if mgr is not None and mgr.due(args.steps):
        mgr.maybe_save(args.steps, fsdp.checkpoint_state(cfg, model, opt),
                       extra_meta=pipe.state_dict())
    # a resumed run with no steps left has no loss to print
    final = "" if loss is None else f" final loss {loss:.4f};"
    say(f"[train] done.{final} "
        f"median step {wd.median*1000:.1f} ms; "
        f"straggler steps {wd.slow_steps}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
