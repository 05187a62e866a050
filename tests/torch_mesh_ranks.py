"""Rank bodies for the port's mesh tests (``tests/test_torch_moe_tp.py``,
``tests/test_torch_train_mesh.py``, ``tests/test_torch_tp.py``,
``tests/test_torch_dryrun_mesh.py``, ``tests/test_torch_cuda.py``).

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
    """A float32 copy (a CPU float32 tensor's ``numpy()`` shares its
    memory, which a later in-place step would change)."""
    return t.detach().float().cpu().numpy().copy()


def gather_rows(t: torch.Tensor, mesh, batch: int) -> torch.Tensor:
    """The whole [batch, ...] tensor from each dp rank's rows."""
    from repro_torch.distributed import comm
    from repro_torch.launch.sharding import batch_axes
    axes, group, _ = batch_axes(mesh, batch)
    if not axes:
        return t
    with torch.no_grad():
        return comm.all_gather(t, 0, group)


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


# ---------------------------------------------------------------------------
# dense tensor parallelism over the model axis (test_torch_tp.py)
# ---------------------------------------------------------------------------

def whole_blocks(t: torch.Tensor, spec, mesh, batch: int) -> torch.Tensor:
    """The whole tensor from this rank's block under ``spec`` (its model dim
    gathered, then its batch rows)."""
    from repro_torch.distributed import tp
    t = tp.whole_of(t, spec, mesh)
    return gather_rows(t, mesh, batch) if spec and spec[0] is not None else t


def tp_inputs(work: Path, arch: str, dev) -> tuple:
    """(train batches, prefill batch, decode inputs per step) of one arch."""
    z = np.load(work / f"tp_inputs_{arch}.npz")
    steps = len({k.split("/")[1] for k in z.files if k.startswith("train/")})
    train = [{k.split("/")[2]: torch.from_numpy(z[k]).to(dev) for k in z.files
              if k.startswith(f"train/{i}/")} for i in range(steps)]
    pre = {k.split("/")[1]: torch.from_numpy(z[k]).to(dev) for k in z.files
           if k.startswith("prefill/")}
    n = len({k.split("/")[1] for k in z.files if k.startswith("decode/")})
    dec = [{k.split("/")[2]: torch.from_numpy(z[k]).to(dev) for k in z.files
            if k.startswith(f"decode/{i}/")} for i in range(n)]
    return train, pre, dec


def tp_case(cfg, case: dict, spec: dict, model, mesh, work: Path, dev) -> tuple:
    """One case on ``mesh``: forward, value_and_grad, prefill and decode on
    the initial weights, then the train steps (``case["steps"]``; a
    checkpoint after ``save_after``).  (whole arrays, this rank's shapes,
    this rank's blocks where ``case["blocks"]``)."""
    from repro_torch.distributed import fsdp, save_checkpoint
    from repro_torch.distributed import tp
    from repro_torch.launch.sharding import _batch_dim_spec, cache_shardings
    from repro_torch.models.layers import make_tp_moe_fn
    from repro_torch.models.transformer import forward
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import TrainConfig
    name = case["name"]
    train, pre, dec = tp_inputs(work, case["arch"], dev)
    B, S = pre[next(iter(pre))].shape[:2]
    s_max = spec["s_max"]
    tcfg = TrainConfig(tp_act=case.get("tp_act", False))
    ax = tp.model_axis(mesh, cfg, tp_act=tcfg.tp_act)
    moe_fn = None
    if case.get("moe_fn"):
        moe_fn = make_tp_moe_fn(mesh, _batch_dim_spec(mesh, B), cfg)
    out, shapes, blocks = {}, {}, {}
    bspec = _batch_dim_spec(mesh, B)
    logit3 = lambda t: (bspec, None, "model" if t.shape[-1] != cfg.vocab else None)
    if not case.get("moe_fn"):
        view = fsdp._Gathered(model, fsdp.plan_of(model), "", False)
        with torch.no_grad():
            logits, _ = forward(view, cfg, fsdp.local_batch(train[0], mesh), remat=False,
                                moe_fn=tp.whole_batch_moe(cfg, mesh, B), tp=ax)
        shapes["logits"] = list(logits.shape)
        out[f"{name}/forward"] = t2np(whole_blocks(logits, logit3(logits), mesh, B))
        total, parts, grads = fsdp.make_value_and_grad(cfg, tcfg, mesh, B)(
            model, fsdp.local_batch(train[0], mesh))
        out.update({f"{name}/loss/{k}": t2np(v) for k, v in {"total": total, **parts}.items()})
        out.update({f"{name}/grad/{n}": t2np(g) for n, g in fsdp.full_leaves(model, grads).items()})
        last, caches = tp.make_prefill(cfg, mesh, B, s_max, tp_act=tcfg.tp_act)(
            model, fsdp.local_batch(pre, mesh))
        lspec = tp.logits_spec(mesh, B, cfg.vocab)
        out[f"{name}/prefill/logits"] = t2np(whole_blocks(last, lspec, mesh, B))
        cspecs = cache_shardings(cfg, mesh, B, s_max)
        shapes["prefill_logits"] = list(last.shape)
        shapes["caches"] = [{k: list(t.shape) for k, t in c.items()} for c in caches]
        if case.get("blocks"):
            blocks["prefill_logits"] = t2np(last)
            blocks.update({f"cache/{i}/{k}": t2np(t) for i, c in enumerate(caches)
                           for k, t in c.items()})
        out.update({f"{name}/prefill/cache/{i}/{k}": t2np(whole_blocks(t, cspecs[i][k], mesh, B))
                    for i, c in enumerate(caches) for k, t in c.items()})
        step = tp.make_decode_step(cfg, mesh, B, s_max)
        for i, inp in enumerate(dec):
            lg, caches = step(model, caches, fsdp.local_batch(inp, mesh), S + i)
            out[f"{name}/decode/{i}"] = t2np(whole_blocks(lg, lspec, mesh, B))
        out.update({f"{name}/decode/cache/{i}/{k}": t2np(whole_blocks(t, cspecs[i][k], mesh, B))
                    for i, c in enumerate(caches) for k, t in c.items()})
    opt = init_opt_state(model, device=dev)
    step_fn = fsdp.make_train_step(cfg, tcfg, mesh, B, moe_fn=moe_fn)
    metrics = []
    for i in range(case["steps"]):
        m = step_fn(model, opt, fsdp.local_batch(train[i], mesh))
        metrics.append({k: float(v) for k, v in m.items()})
        if i + 1 in (1, case["steps"]):
            at = f"{name}/step{i + 1}"
            out.update({f"{at}/params/{n}": t2np(t) for n, t in fsdp.full_leaves(model).items()})
            out.update({f"{at}/m/{n}": t2np(t)
                        for n, t in fsdp.full_leaves(model, opt["m"]).items()})
        if case.get("save_after") == i + 1:
            save_checkpoint(str(work / f"ckpt_{name}"), i + 1,
                            fsdp.checkpoint_state(cfg, model, opt))
    shapes["params"] = {n: list(p.shape) for n, p in model.named_parameters()}
    shapes["m"] = {n: list(t.shape) for n, t in opt["m"].items()}
    shapes["v"] = {n: list(t.shape) for n, t in opt["v"].items()}
    out[f"{name}/metrics"] = np.array(json.dumps(metrics))
    return out, shapes, blocks


def tp_short(spec: dict, mesh, work: Path, dev) -> dict:
    """``spec["short"]``'s prompt, shorter than the ring's window, served
    on ``mesh``: ``tp.make_prefill`` at s_max = S + ``grow``, then a
    decode step per row of ``tp_short.npz``'s ``decode``.  {"prefill",
    "decode/i", "cache/i/name": whole arrays}."""
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tp
    from repro_torch.launch.sharding import cache_shardings
    arch = spec["short"]["arch"]
    cfg = train_cfg(spec, arch)
    model = fsdp.shard_model(load_params(cfg, str(work / f"init_{arch}"), str(dev)), mesh)
    z = np.load(work / "tp_short.npz")
    B, S = z["tokens"].shape
    s_max = S + spec["short"]["grow"]
    lspec = tp.logits_spec(mesh, B, cfg.vocab)
    cspecs = cache_shardings(cfg, mesh, B, s_max)
    local = lambda d: fsdp.local_batch({k: torch.from_numpy(v).to(dev) for k, v in d.items()},
                                       mesh)
    last, caches = tp.make_prefill(cfg, mesh, B, s_max)(model, local({"tokens": z["tokens"]}))
    out = {"prefill": t2np(whole_blocks(last, lspec, mesh, B))}
    step = tp.make_decode_step(cfg, mesh, B, s_max)
    for i, tok in enumerate(z["decode"]):
        lg, caches = step(model, caches, local({"token": tok}), S + i)
        out[f"decode/{i}"] = t2np(whole_blocks(lg, lspec, mesh, B))
    out.update({f"cache/{i}/{k}": t2np(whole_blocks(t, cspecs[i][k], mesh, B))
                for i, c in enumerate(caches) for k, t in c.items()})
    return out


def tp_mesh(rank: int, world: int, workdir: str, device: str = "cpu") -> None:
    """Every case of ``tp_spec.json`` on its (D, M) mesh (``tp_case``), the
    short prompt on each mesh of ``short`` (``tp_short``), then the
    checkpoints named in ``restore`` resumed on (world, 1): the next
    step's metrics.  Rank 0 writes the whole arrays; each rank its shapes
    and blocks."""
    from repro_torch.distributed import fsdp, load_checkpoint
    from repro_torch.launch.mesh import close_world, make_test_mesh
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import TrainConfig
    dev = join(rank, world, workdir, device)
    work = Path(workdir)
    spec = json.loads((work / "tp_spec.json").read_text())
    meshes = {}
    out, shapes, blocks = {}, {}, {}
    for case in spec["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_test_mesh(shape, device=dev)
        mesh = meshes[shape]
        cfg = train_cfg(spec, case["arch"])
        model = fsdp.shard_model(load_params(cfg, str(work / f"init_{case['arch']}"), str(dev)),
                                 mesh)
        o, s, b = tp_case(cfg, case, spec, model, mesh, work, dev)
        out.update(o)
        shapes[case["name"]] = s
        blocks.update({f"{case['name']}/{k}": v for k, v in b.items()})
    for shape in map(tuple, spec["short"]["meshes"]):
        tag = "x".join(map(str, shape))
        out.update({f"short/{tag}/{k}": v
                    for k, v in tp_short(spec, meshes[shape], work, dev).items()})
    for r in spec.get("restore", []):
        shape = tuple(r["mesh"])
        if shape not in meshes:
            meshes[shape] = make_test_mesh(shape, device=dev)
        mesh = meshes[shape]
        cfg = train_cfg(spec, r["arch"])
        model = fsdp.shard_model(load_params(cfg, str(work / f"init_{r['arch']}"), str(dev)),
                                 mesh)
        opt = init_opt_state(model, device=dev)
        step, state, _ = load_checkpoint(str(work / r["ckpt"]),
                                         fsdp.checkpoint_state(cfg, model, opt), device=dev,
                                         shardings=fsdp.state_shardings(cfg, model))
        fsdp.load_state(cfg, model, opt, state)
        train, _, _ = tp_inputs(work, r["arch"], dev)
        B = train[0]["labels"].shape[0]
        m = fsdp.make_train_step(cfg, TrainConfig(), mesh, B)(
            model, opt, fsdp.local_batch(train[step], mesh))
        out[f"restore/{r['name']}"] = np.array(json.dumps(
            {"step": step, **{k: float(v) for k, v in m.items()}}))
    (work / f"tp_shapes_{rank}.json").write_text(json.dumps(shapes))
    np.savez(work / f"tp_blocks_{rank}.npz", **blocks)
    if rank == 0:
        np.savez(work / "tp_port.npz", **out)
    close_world()


# Float32 (TF32 off) bounds for ``tp_cards``, test_torch_train_mesh.py's:
# loss terms to 1e-5 (LOSS_RTOL), the grad norm to 2e-4 (GRAD_RTOL), m
# to 4e-4 of a leaf's largest (2 x GRAD_RTOL), parameters within Adam's
# sign step plus three float32 ulps; logits to test_torch_tp.py's
# LOGIT_RTOL, 5e-5.
TP_CARDS_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 2e-4, "m_rel": 4e-4, "param_ulps": 3,
                "raw_step0_rtol": 1e-5, "logit_rel": 5e-5, "aux_rtol": 1e-5,
                "tp_grad_norm_rtol": 2e-4, "tp_m_rel": 4e-4}


def tp_cards(rank: int, world: int, workdir: str) -> None:
    """Reduced Qwen2 (float32, TF32 off) tensor parallel on (1, world) NCCL
    ranks, one a card: ``chip_smoke.mesh_on_cards``' train steps and
    prefill + greedy decode against one card within TP_CARDS_TOL; rank 0
    writes the record (test_torch_cuda.py)."""
    import chip_smoke
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch.mesh import close_world, make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = join(rank, world, workdir, "cuda")
    mesh = make_test_mesh((1, world), device=dev)
    rec = chip_smoke.mesh_on_cards(reduced(ARCHS["qwen2_1_5b"]), 0, dev, mesh, rank,
                                   train=(4, 64, 2), serve=(4, 64, 3, 68), one={},
                                   tol=TP_CARDS_TOL)
    if rank == 0:
        Path(workdir, "tp_cards.json").write_text(json.dumps(rec))
    close_world()


# ---------------------------------------------------------------------------
# the dry run on a mesh (test_torch_dryrun_mesh.py)
# ---------------------------------------------------------------------------

def count_cfg(arch: str):
    from repro_torch import configs
    return configs.reduced(configs.ARCHS[arch])


def count_args(case: dict, mesh):
    """``dryrun.build_call``'s (fn, args, kwargs) of one count case on
    ``mesh``: this rank's blocks on ``meta``."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.train.step import TrainConfig
    spec = ShapeSpec("t", case["kind"], case["seq"], case["batch"])
    return dryrun.build_call(count_cfg(case["arch"]), spec,
                             TrainConfig(tp_act=case.get("tp_act", False)), mesh,
                             embed_vocab_shard=case.get("embed_vocab_shard", True),
                             moe_tp=case.get("moe_tp", False))


def materialize(obj, vocab: int, gen: torch.Generator):
    """``build_call``'s meta arguments as CPU tensors of the same layouts
    (a module's parameters and buffers in place): floating leaves uniform
    in [0, 0.02), integer leaves (tokens, labels, the step) in [0, vocab)."""
    def real(t):
        if t.is_floating_point():
            return (torch.rand(t.shape, generator=gen) * 0.02).to(t.dtype)
        return torch.randint(0, vocab, t.shape, generator=gen, dtype=t.dtype)
    if isinstance(obj, torch.Tensor):
        return real(obj)
    if isinstance(obj, torch.nn.Module):
        obj.to_empty(device="cpu")
        with torch.no_grad():
            for t in [*obj.parameters(), *obj.buffers()]:
                t.copy_(real(t))
        return obj
    if isinstance(obj, dict):
        return {k: materialize(v, vocab, gen) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(materialize(v, vocab, gen) for v in obj)
    return obj


def pod_serve(cfg, model, mesh, pre: dict, s_max: int, steps: int) -> list:
    """Prefill and ``steps`` greedy decode steps on ``mesh``: the tokens
    (the argmax of the whole last-position logits), the same on every
    rank."""
    from repro_torch.distributed import fsdp, tp
    B = next(iter(pre.values())).shape[0]
    S = next(iter(pre.values())).shape[1]
    lspec = tp.logits_spec(mesh, B, cfg.vocab)

    def token(logits):
        return whole_blocks(logits, lspec, mesh, B).argmax(-1).to(torch.int32)

    last, caches = tp.make_prefill(cfg, mesh, B, s_max)(model, fsdp.local_batch(pre, mesh))
    toks = [token(last)]
    step = tp.make_decode_step(cfg, mesh, B, s_max)
    for i in range(steps):
        last, caches = step(model, caches, fsdp.local_batch({"token": toks[-1]}, mesh), S + i)
        toks.append(token(last))
    return [t.tolist() for t in toks]


def dryrun_mesh(rank: int, world: int, workdir: str, device: str = "cpu") -> None:
    """``dryrun_spec.json``'s count cases: each ``build_call`` run on CPU
    tensors (``materialize``) under ``OpCostMode`` over this gloo group,
    rank 0 writing its counts; then the pod cases: the train
    steps on a (P, D, M) mesh, or with a vocab-replicated embedding
    (metrics, and the whole parameters and m after the first and the last
    step) and prefill + greedy decode tokens."""
    from repro_torch.distributed import fsdp
    from repro_torch.launch.mesh import close_world, make_test_mesh
    from repro_torch.launch.op_cost import count_call
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import TrainConfig
    dev = join(rank, world, workdir, device)
    work = Path(workdir)
    spec = json.loads((work / "dryrun_spec.json").read_text())
    meshes = {}

    def mesh_of(shape, axes):
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = make_test_mesh(*key, device=dev)
        return meshes[key]
    counts = {}
    for i, case in enumerate(spec["counts"]):
        mesh = mesh_of(case["mesh"], case["axes"])
        fn, args, kwargs = count_args(case, mesh)
        args = materialize(args, count_cfg(case["arch"]).vocab,
                           torch.Generator().manual_seed(i))
        counts[case["name"]] = count_call(fn, *args, groups=mesh.axis_labels(),
                                          **kwargs).as_dict()
    out, metrics = {}, {}
    for case in spec["pod"]:
        name, arch = case["name"], case["arch"]
        mesh = mesh_of(case["mesh"], case["axes"])
        cfg = train_cfg(spec, arch)
        train, pre, _ = tp_inputs(work, arch, dev)
        B = train[0]["labels"].shape[0]
        model = fsdp.shard_model(load_params(cfg, str(work / f"init_{arch}"), str(dev)), mesh,
                                 embed_vocab_shard=case.get("embed_vocab_shard", True))
        out[f"{name}/tokens"] = np.array(pod_serve(cfg, model, mesh, pre, spec["s_max"],
                                                   spec["decode"]))
        opt = init_opt_state(model, device=dev)
        step_fn = fsdp.make_train_step(cfg, TrainConfig(), mesh, B)
        metrics[name] = []
        for i in range(case["steps"]):
            m = step_fn(model, opt, fsdp.local_batch(train[i], mesh))
            metrics[name].append({k: float(v) for k, v in m.items()})
            if i + 1 in (1, case["steps"]):
                at = f"{name}/step{i + 1}"
                out.update({f"{at}/params/{n}": t2np(t)
                            for n, t in fsdp.full_leaves(model).items()})
                out.update({f"{at}/m/{n}": t2np(t)
                            for n, t in fsdp.full_leaves(model, opt["m"]).items()})
    if rank == 0:
        (work / "dryrun_real.json").write_text(json.dumps({"counts": counts,
                                                           "metrics": metrics}))
        np.savez(work / "dryrun_pod.npz", **out)
    close_world()
