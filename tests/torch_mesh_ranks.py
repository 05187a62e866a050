"""Rank bodies for the port's mesh tests (``tests/test_torch_moe_tp.py``,
``tests/test_torch_train_mesh.py``, ``tests/test_torch_cuda.py``).

``torch.multiprocessing.spawn`` starts each rank in a fresh interpreter
that imports the function's module, so the bodies live here rather than
in a test file.  Each rank joins a gloo (``cpu``) or NCCL (``cuda``) group
through a file store in the test's directory, reads its inputs from
there, and rank 0 writes the results back as ``.npz`` / ``.json`` files.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch


def join(rank: int, world: int, workdir: str, device: str = "cpu") -> torch.device:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_world
    return init_world(device, init_method=f"file://{workdir}/store")


def t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def gather_rows(t: torch.Tensor, mesh, batch: int) -> torch.Tensor:
    """The whole [batch, ...] tensor from each data rank's rows."""
    from repro_torch.distributed import comm
    from repro_torch.launch.sharding import _batch_dim_spec
    if _batch_dim_spec(mesh, batch) is None:
        return t
    with torch.no_grad():
        return comm.all_gather(t, 0, mesh.group("data"))


def _template(cfg):
    from repro_torch import convert as cv
    from repro_torch.models.transformer import abstract_params
    return {"params": cv.lm_tree_from_params(cfg, abstract_params(cfg))}


def load_params(cfg, path: str, device: str = "cpu"):
    """A model from a ``{"params": tree}`` checkpoint (step 0)."""
    from repro_torch import convert as cv
    from repro_torch.distributed.checkpoint import load_checkpoint
    _, state, _ = load_checkpoint(path, _template(cfg))
    return cv.lm_params_from_tree(cfg, state["params"], device=device)


# ---------------------------------------------------------------------------
# moe_fn over the model axis (test_torch_moe_tp.py)
# ---------------------------------------------------------------------------

def moe_tp(rank: int, world: int, workdir: str, device: str = "cpu") -> None:
    """For each (capacity factor, mesh) case: ``forward`` with
    ``make_tp_moe_fn`` on this rank's rows and the whole weights, the
    scalar ``sum(logits * R) / R.size + aux`` and its backward.  The
    gradients are summed over ``data`` (each data rank's rows) and each
    expert leaf over ``model`` (each rank's block, zero elsewhere); rank 0
    writes the whole logits, aux and gradients.  With the whole batch on
    each rank, also ``moe_fn_hooks``; with the batch over ``data`` alone,
    ``prefill`` of the rank's rows with ``act_shard`` and ``moe_fn``."""
    from repro_torch import configs
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import close_world, make_test_mesh
    from repro_torch.launch.sharding import _batch_dim_spec, act_constraint
    from repro_torch.models.layers import make_tp_moe_fn
    from repro_torch.models.transformer import forward
    from repro_torch.serving.decode import prefill
    from repro_torch.train.step import grads_of
    dev = join(rank, world, workdir, device)
    work = Path(workdir)
    spec = json.loads((work / "moe_cases.json").read_text())
    inputs = dict(np.load(work / "moe_inputs.npz"))
    base = configs.reduced(configs.ARCHS[spec["arch"]])
    out = {}
    for cf in spec["capacity_factors"]:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        for shape in spec["meshes"]:
            mesh = make_test_mesh(tuple(shape), device=dev)
            B = inputs["tokens"].shape[0]
            local = fsdp.local_batch({k: torch.from_numpy(v).to(dev) for k, v in inputs.items()},
                                     mesh)
            model = load_params(cfg, str(work / "moe_params"), device=str(dev))
            moe_fn = make_tp_moe_fn(mesh, _batch_dim_spec(mesh, B), cfg)
            keep = {}

            def loss():
                logits, aux = forward(model, cfg, {"tokens": local["tokens"]}, remat=False,
                                      moe_fn=moe_fn)
                keep.update(logits=logits.detach(), aux=aux.detach())
                return (logits * local["R"]).sum() / inputs["R"].size + aux, {}

            _, _, grads = grads_of(dict(model.named_parameters()), loss)
            sharded = _batch_dim_spec(mesh, B) is not None
            for n, g in grads.items():
                if sharded:
                    torch.distributed.all_reduce(g, group=mesh.group("data"))
                if n.rsplit(".", 1)[-1] in ("e_gate", "e_up", "e_down"):
                    torch.distributed.all_reduce(g, group=mesh.group("model"))
            logits = gather_rows(keep["logits"], mesh, B)
            tag = f"cf{cf}_{shape[0]}x{shape[1]}"
            out[f"{tag}/logits"] = t2np(logits)
            out[f"{tag}/aux"] = t2np(keep["aux"])
            out.update({f"{tag}/grad/{n}": t2np(g) for n, g in grads.items()})
            if not sharded:
                out.update(moe_fn_hooks(model, cfg, local, moe_fn, mesh, tag))
            elif mesh.shape["model"] == 1:
                with torch.no_grad():
                    last, _ = prefill(model, cfg, {"tokens": local["tokens"]},
                                      act_shard=act_constraint(mesh, B), moe_fn=moe_fn)
                out[f"{tag}/prefill/logits"] = t2np(gather_rows(last, mesh, B))
    if rank == 0:
        np.savez(work / "moe_port.npz", **out)
    close_world()


def moe_fn_hooks(model, cfg, batch, moe_fn, mesh, tag: str) -> dict:
    """``prefill(moe_fn=)`` and ``train.step.value_and_grad(moe_fn=)`` on
    the whole batch: the last position's logits, the caches, the loss
    terms and the gradients (each expert leaf summed over ``model``)."""
    from repro_torch.serving.decode import prefill
    from repro_torch.train.step import TrainConfig, value_and_grad
    with torch.no_grad():
        last, caches = prefill(model, cfg, {"tokens": batch["tokens"]}, moe_fn=moe_fn)
    out = {f"{tag}/prefill/logits": t2np(last)}
    out.update({f"{tag}/prefill/cache/{i}/{k}": t2np(v)
                for i, c in enumerate(caches) for k, v in c.items()})
    total, parts, grads = value_and_grad(
        model, cfg, {"tokens": batch["tokens"], "labels": batch["labels"]},
        TrainConfig(remat=False), moe_fn=moe_fn)
    for n, g in grads.items():
        if n.rsplit(".", 1)[-1] in ("e_gate", "e_up", "e_down"):
            torch.distributed.all_reduce(g, group=mesh.group("model"))
    out.update({f"{tag}/loss/{k}": t2np(v) for k, v in {"total": total, **parts}.items()})
    out.update({f"{tag}/loss_grad/{n}": t2np(g) for n, g in grads.items()})
    return out


# ---------------------------------------------------------------------------
# the data-parallel train step (test_torch_train_mesh.py)
# ---------------------------------------------------------------------------

def train_cfg(spec: dict, arch: str):
    from repro_torch import configs
    cfg = configs.reduced(configs.ARCHS[arch])
    cf = spec.get("capacity", {}).get(arch)
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def batches_of(work: Path, name: str, dev) -> list:
    z = np.load(work / f"batches_{name}.npz")
    n = len({k.split("/")[0] for k in z.files})
    return [{k.split("/")[1]: torch.from_numpy(z[k]).to(dev) for k in z.files
             if k.startswith(f"{i}/")} for i in range(n)]


def run_sharded(cfg, model, batches, mesh, tcfg, *, steps, save=None):
    """``steps`` sharded train steps from ``batches`` (whole batches, cut to
    this rank's rows): the metrics of each, the whole parameters and ``m``
    after (``shard_opt_state`` cuts the whole ``m`` back to this rank's
    blocks).  ``save=(directory, after)`` writes a checkpoint after that
    many steps (every rank calls)."""
    from repro_torch.distributed import fsdp, save_checkpoint
    from repro_torch.train.optimizer import init_opt_state
    B = batches[0]["tokens"].shape[0]
    opt = init_opt_state(model, device=model.final_norm.device)
    step_fn = fsdp.make_train_step(cfg, tcfg, mesh, B)
    metrics = []
    for i in range(steps):
        m = step_fn(model, opt, fsdp.local_batch(batches[i], mesh))
        metrics.append({k: float(v) for k, v in m.items()})
        if save is not None and save[1] == i + 1:
            save_checkpoint(save[0], i + 1, fsdp.checkpoint_state(cfg, model, opt))
    m = fsdp.full_leaves(model, opt["m"])
    back = fsdp.shard_opt_state({"step": opt["step"], "m": m, "v": m}, model, mesh)
    assert all(torch.equal(back["m"][n], t) for n, t in opt["m"].items())
    return metrics, fsdp.full_leaves(model), m


def resume_sharded(cfg, ckpt: str, batches, mesh, tcfg, dev, seed_model):
    """Restore a checkpoint onto ``mesh`` (each leaf cut by its spec) and run
    the next step: its metrics."""
    from repro_torch.distributed import fsdp, load_checkpoint
    from repro_torch.train.optimizer import init_opt_state
    model = fsdp.shard_model(seed_model, mesh)
    opt = init_opt_state(model, device=dev)
    step, state, _ = load_checkpoint(ckpt, fsdp.checkpoint_state(cfg, model, opt),
                                     device=dev, shardings=fsdp.state_shardings(cfg, model))
    fsdp.load_state(cfg, model, opt, state)
    B = batches[0]["tokens"].shape[0]
    m = fsdp.make_train_step(cfg, tcfg, mesh, B)(model, opt,
                                                 fsdp.local_batch(batches[step], mesh))
    return step, {k: float(v) for k, v in m.items()}


def train_mesh(rank: int, world: int, workdir: str, device: str = "cpu") -> None:
    """Every case of ``train_spec.json`` on a (world, 1) mesh: the sharded
    steps' metrics, the whole parameters and ``m`` after, this rank's
    parameter shapes, a checkpoint written after ``save_after`` steps, and
    a resume from the one-process checkpoint.  Rank 0 writes the results,
    and each rank its shapes."""
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import close_world, make_test_mesh
    from repro_torch.train.step import TrainConfig
    dev = join(rank, world, workdir, device)
    work = Path(workdir)
    spec = json.loads((work / "train_spec.json").read_text())
    tcfg = TrainConfig()
    mesh = make_test_mesh((world, 1), device=dev)
    arrays, meta = {}, {"shapes": {}, "metrics": {}}
    for case in spec["cases"]:
        name, arch = case["name"], case["arch"]
        cfg = train_cfg(spec, arch)
        batches = batches_of(work, name, dev)
        model = fsdp.shard_model(load_params(cfg, str(work / f"init_{arch}"), str(dev)), mesh)
        meta["shapes"][name] = {n: list(p.shape) for n, p in model.named_parameters()}
        save = None
        if case.get("save_after"):
            save = (str(work / f"ckpt_{world}rank_{name}"), case["save_after"])
        metrics, params, m = run_sharded(cfg, model, batches, mesh, tcfg,
                                         steps=spec["steps"], save=save)
        meta["metrics"][name] = metrics
        arrays.update({f"{name}/params/{n}": t2np(t) for n, t in params.items()})
        arrays.update({f"{name}/m/{n}": t2np(t) for n, t in m.items()})
        if case.get("resume_from"):
            step, m = resume_sharded(cfg, str(work / case["resume_from"]), batches, mesh,
                                     tcfg, dev, load_params(cfg, str(work / f"init_{arch}"),
                                                            str(dev)))
            meta["metrics"][f"{name}/resumed"] = {"step": step, **m}
    (work / f"train_shapes_{world}_{rank}.json").write_text(json.dumps(meta["shapes"]))
    if rank == 0:
        np.savez(work / f"train_port_{world}.npz", **arrays)
        (work / f"train_port_{world}.json").write_text(json.dumps(meta["metrics"]))
    close_world()
