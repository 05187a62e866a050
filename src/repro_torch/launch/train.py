"""End-to-end LM training on one device (the fault-tolerance harness).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

What it runs: AdamW train steps, checkpoint and restart (kill it mid-run
and relaunch: it resumes from the last committed step with the same data
order), the straggler watchdog, and loss logging.  ``--device cuda`` (the
default; raises with no card) or ``--device cpu``; ``--smoke`` runs the
reduced config.  Checkpoints have the JAX package's layout, so either
package can resume the other's.  The TPU fleet's ``--production`` mesh
has no counterpart on one card and is rejected.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..configs import get_config, reduced
from ..convert import (lm_opt_state_from_tree, lm_params_from_tree,
                       lm_tree_from_opt_state, lm_tree_from_params)
from ..core.engine import resolve_device
from ..data.tokens import TokenPipeline, frontend_batch
from ..distributed import CheckpointManager, StepWatchdog
from ..models.config import FAMILY_AUDIO
from ..models.transformer import init_params
from ..train.optimizer import OptConfig, init_opt_state
from ..train.step import TrainConfig, make_train_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LM training on one device")
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
                    help="rejected: the TPU fleet's (16,16) mesh has no "
                         "counterpart on one card")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default; raises with no card) or cpu")
    return ap


def _state(cfg, model, opt):
    return {"params": lm_tree_from_params(cfg, model),
            "opt": lm_tree_from_opt_state(cfg, opt)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.production:
        ap.error("--production (the TPU fleet's (16,16) mesh) has no "
                 "counterpart on one card")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=args.lr, total_steps=args.steps),
                       remat=True)
    step_fn = make_train_step(cfg, tcfg)

    model = init_params(cfg, args.seed, device=dev)
    opt = init_opt_state(model, device=dev)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        restored = mgr.restore_or_none(_state(cfg, model, opt))
        if restored is not None:
            start, state, meta = restored
            model = lm_params_from_tree(cfg, state["params"], device=dev)
            opt = lm_opt_state_from_tree(cfg, state["opt"], model, device=dev)
            pipe.load_state_dict(meta)
            print(f"[train] resumed from step {start}")

    wd = StepWatchdog()
    extra = frontend_batch(cfg, args.batch, args.seq, seed=args.seed)
    loss = None
    for step in range(start, args.steps):
        batch = dict(pipe.batch_at(step))
        batch.update(extra)
        if cfg.family == FAMILY_AUDIO:
            batch.pop("tokens", None)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        wd.start()
        metrics = step_fn(model, opt, batch)
        loss = metrics["loss"].item()   # blocks; doubles as step barrier
        dt = wd.stop()
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"nll {float(metrics['nll']):8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1000:7.1f} ms"
                  + (" [STRAGGLER]" if wd.is_straggler(dt) else ""),
                  flush=True)
        if mgr is not None:
            mgr.maybe_save(step + 1, _state(cfg, model, opt),
                           extra_meta=pipe.state_dict())
    if mgr is not None:
        mgr.maybe_save(args.steps, _state(cfg, model, opt),
                       extra_meta=pipe.state_dict())
    # a resumed run with no steps left has no loss to print
    final = "" if loss is None else f" final loss {loss:.4f};"
    print(f"[train] done.{final} "
          f"median step {wd.median*1000:.1f} ms; "
          f"straggler steps {wd.slow_steps}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
