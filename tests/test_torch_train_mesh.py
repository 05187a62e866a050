"""The port's data-parallel train step on a (2, 1) mesh
(``repro_torch.distributed.fsdp``, ``launch.{mesh,sharding}``) against its
one-process step and the JAX package's jitted step on a forced 2-device
(2, 1) mesh, on the CPU.

Four reduced configs (qwen2-1.5b; deepseek-moe-16b with the dense
``moe_ffn`` at capacity factor 0.5, so drops bind; xlstm-125m;
recurrentgemma-9b), three steps of B=4 x S=32 with a ``loss_mask`` whose
count differs between the two ranks' rows, and B=3 (not divisible by 2:
the batch is replicated).  The weights are the port's ``init_params``,
carried to the reference through a checkpoint.  Checkpoints cross between
one and two ranks, and the two CLIs (``torch.distributed.run`` with two
gloo ranks, the reference on two forced devices) print the same step
lines from one step-0 checkpoint.

One reference subprocess, the port's CLI and the two gloo ranks
(``tests/torch_mesh_ranks.py``) run at the same time.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch import convert as cv
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import fsdp, save_checkpoint
from repro_torch.distributed.checkpoint import _unflatten_like
from repro_torch.launch.mesh import close_world, init_world, make_test_mesh
from repro_torch.launch.sharding import (_batch_dim_spec, act_constraint, logit_constraint,
                                         param_shardings)
from repro_torch.models.layers import make_tp_moe_fn
from repro_torch.models.transformer import abstract_params, init_params
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import TrainConfig, make_train_step

import torch_mesh_ranks as ranks

ARCHS = ["qwen2_1_5b", "deepseek_moe_16b", "xlstm_125m", "recurrentgemma_9b"]
STEPS, B, S = 3, 4, 32
SPEC = {
    "steps": STEPS,
    "capacity": {"deepseek_moe_16b": 0.5},
    "cases": [{"name": a, "arch": a, "batch": B, "reference": True} for a in ARCHS] + [
        {"name": "qwen2_1_5b_b3", "arch": "qwen2_1_5b", "batch": 3, "reference": True},
        {"name": "deepseek_moe_16b_b3", "arch": "deepseek_moe_16b", "batch": 3}],
}
SPEC["cases"][0].update(save_after=2, resume_from="ckpt_1rank_qwen2_1_5b")
CASES = [c["name"] for c in SPEC["cases"]]
HOOK_CASES = ["qwen2_1_5b", "deepseek_moe_16b"]
REF_CASES = [c["name"] for c in SPEC["cases"] if c.get("reference")]
CLI = ["--smoke", "--arch", "qwen2_1_5b", "--steps", "3", "--batch", "4", "--seq", "32",
       "--log-every", "1", "--ckpt-every", "3"]
# float32, as tests/test_torch_train.py: loss terms to LOSS_RTOL; the
# gradient norm and each leaf of m (0.1 x the clipped gradient, summed over
# the steps) to GRAD_RTOL of the leaf's largest, floored at GRAD_FLOOR of
# the model's largest; a parameter within 2 x the summed learning rates
# (Adam's first step is a sign) plus 1e-6 of itself.  Two ranks against
# one process: m within 2 x GRAD_RTOL (8.8e-5 measured, recurrentgemma).
# Against the reference, m drifts over three steps in the one-process port
# too (4.2e-4 of recurrentgemma's layer-3 w_down, 4.1e-4 on two ranks), so
# it is held to REF_M_RTOL.
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 2e-4, 1e-6
REF_M_RTOL = 1e-3

REF = textwrap.dedent("""
    import contextlib, dataclasses, io, json, sys
    import numpy as np
    import jax
    from repro.configs import ARCHS, reduced
    from repro.distributed.checkpoint import _flatten, load_checkpoint
    from repro.launch.mesh import make_test_mesh
    from repro.launch.sharding import (act_constraint, logit_constraint, opt_shardings,
                                       param_shardings)
    from repro.models.transformer import abstract_params
    from repro.train.optimizer import init_opt_state
    from repro.train.step import TrainConfig, make_train_step
    work = sys.argv[1]
    spec = json.load(open(f"{work}/train_spec.json"))
    mesh = make_test_mesh((2, 1))
    out, metrics = {}, {}
    for case in spec["cases"]:
        if not case.get("reference"):
            continue
        name, arch = case["name"], case["arch"]
        cfg = reduced(ARCHS[arch])
        if arch in spec["capacity"]:
            cfg = dataclasses.replace(cfg, capacity_factor=spec["capacity"][arch])
        _, st, _ = load_checkpoint(f"{work}/init_{arch}", {"params": abstract_params(cfg)})
        z = np.load(f"{work}/batches_{name}.npz")
        batches = [{k.split("/")[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                   for i in range(spec["steps"])]
        b = batches[0]["tokens"].shape[0]
        step = make_train_step(cfg, TrainConfig(remat=False),
                               act_shard=act_constraint(mesh, b),
                               logit_shard=logit_constraint(mesh, b, cfg.vocab))
        p_sh, o_sh = param_shardings(cfg, mesh), opt_shardings(cfg, mesh)
        with mesh:
            params = jax.device_put(st["params"], p_sh)
            opt = jax.device_put(init_opt_state(params), o_sh)
            jstep = jax.jit(step, in_shardings=(p_sh, o_sh, None),
                            out_shardings=(p_sh, o_sh, None))
            ms = []
            for batch in batches:
                params, opt, m = jstep(params, opt, batch)
                ms.append({k: float(v) for k, v in m.items()})
        metrics[name] = ms
        out.update({f"{name}/params/{k}": np.asarray(v) for k, v in _flatten(params)})
        out.update({f"{name}/m/{k}": np.asarray(v) for k, v in _flatten(opt["m"])})
    np.savez(f"{work}/train_ref.npz", **out)
    json.dump(metrics, open(f"{work}/train_ref.json", "w"))
    from repro.launch import train
    sys.argv = ["train"] + spec["cli"] + ["--ckpt-dir", f"{work}/cli_jax"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main()
    open(f"{work}/cli_jax.log", "w").write(buf.getvalue())
""")


def cfg_of(arch):
    return ranks.train_cfg(SPEC, arch)


def make_batches(name, arch, b, seed):
    """Three steps of tokens, labels and a loss mask denser on the first
    half of the rows than on the second (uneven counts across ranks)."""
    rng = np.random.default_rng(seed)
    vocab = cfg_of(arch).vocab
    out = {}
    for i in range(STEPS):
        dens = np.where(np.arange(b) < b // 2, 0.9, 0.35)[:, None]
        out[f"{i}/tokens"] = rng.integers(0, vocab, (b, S)).astype(np.int32)
        out[f"{i}/labels"] = rng.integers(0, vocab, (b, S)).astype(np.int32)
        out[f"{i}/loss_mask"] = (rng.random((b, S)) < dens).astype(np.float32)
    return out


def one_process(cfg, model, batches, *, save=None, hooks=()):
    """The port's one-process steps: metrics, parameters and m after.
    ``hooks`` are ``make_train_step``'s (act_shard, logit_shard, moe_fn)."""
    opt = init_opt_state(model, device="cpu")
    step_fn = make_train_step(cfg, TrainConfig(), *hooks)
    metrics = []
    for i, b in enumerate(batches):
        metrics.append({k: float(v) for k, v in step_fn(model, opt, b).items()})
        if save is not None and save[1] == i + 1:
            save_checkpoint(save[0], i + 1, {"params": cv.lm_tree_from_params(cfg, model),
                                             "opt": cv.lm_tree_from_opt_state(cfg, opt)})
    return metrics, {n: p.detach().numpy().copy() for n, p in model.named_parameters()}, \
        {n: t.numpy().copy() for n, t in opt["m"].items()}


def named(cfg, flat, prefix):
    """{parameter name: leaf} from checkpoint-style path keys."""
    template = cv.lm_tree_from_params(cfg, abstract_params(cfg))
    tree = _unflatten_like(template, {k[len(prefix):]: v for k, v in flat.items()
                                      if k.startswith(prefix)})
    return {k: np.asarray(v, np.float32) for k, v in cv.lm_named_from_tree(cfg, tree).items()}


def one_rank_mesh(work, one):
    """On a one-rank mesh in this process: every case's sharded steps
    (against the one-process step, bit for bit), the one-process step with
    the mesh's hooks, and the two-rank checkpoint resumed."""
    out = {}
    init_world("cpu")
    try:
        mesh = make_test_mesh((1, 1), device="cpu")
        for case in SPEC["cases"]:
            name, cfg = case["name"], cfg_of(case["arch"])
            model = fsdp.shard_model(ranks.load_params(cfg, str(work / f"init_{case['arch']}")),
                                     mesh)
            batches = ranks.batches_of(work, name, "cpu")
            out[name] = ranks.run_sharded(cfg, model, batches, mesh, TrainConfig(),
                                          steps=STEPS)
            if name in HOOK_CASES:
                b = case["batch"]
                moe = make_tp_moe_fn(mesh, _batch_dim_spec(mesh, b), cfg) if cfg.is_moe else None
                hooks = (act_constraint(mesh, b), logit_constraint(mesh, b, cfg.vocab), moe)
                out[f"{name}/hooks"] = one_process(
                    cfg, ranks.load_params(cfg, str(work / f"init_{case['arch']}")), batches,
                    hooks=hooks)
        cfg = cfg_of("qwen2_1_5b")
        out["resumed"] = ranks.resume_sharded(
            cfg, str(work / "ckpt_2rank_qwen2_1_5b"), ranks.batches_of(work, "qwen2_1_5b", "cpu"),
            mesh, TrainConfig(), "cpu", ranks.load_params(cfg, str(work / "init_qwen2_1_5b")))
    finally:
        close_world()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_mesh")
    SPEC["cli"] = CLI
    (work / "train_spec.json").write_text(json.dumps(SPEC))
    for arch in ARCHS:
        model = init_params(cfg_of(arch), 0, device="cpu")
        save_checkpoint(str(work / f"init_{arch}"), 0,
                        {"params": cv.lm_tree_from_params(cfg_of(arch), model)})
    for seed, case in enumerate(SPEC["cases"]):
        np.savez(work / f"batches_{case['name']}.npz",
                 **make_batches(case["name"], case["arch"], case["batch"], seed))
    # the two CLIs resume from one step-0 checkpoint: the same weights
    cfg = cfg_of("qwen2_1_5b")
    model = init_params(cfg, 0, device="cpu")
    save_checkpoint(str(work / "cli_jax"), 0,
                    {"params": cv.lm_tree_from_params(cfg, model),
                     "opt": cv.lm_tree_from_opt_state(cfg, init_opt_state(model, device="cpu"))},
                    extra_meta=TokenPipeline(vocab=cfg.vocab, batch=4, seq=32).state_dict())
    shutil.copytree(work / "cli_jax", work / "cli_port")

    one = {}
    for case in SPEC["cases"]:
        name, cfg = case["name"], cfg_of(case["arch"])
        save = (str(work / "ckpt_1rank_qwen2_1_5b"), 2) if name == "qwen2_1_5b" else None
        one[name] = one_process(cfg, ranks.load_params(cfg, str(work / f"init_{case['arch']}")),
                                ranks.batches_of(work, name, "cpu"), save=save)

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(work)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cli = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
                            "--device", "cpu", *CLI, "--ckpt-dir", str(work / "cli_port")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(ranks.train_mesh, args=(2, str(work)), nprocs=2)
    finally:
        cli_out, cli_err = cli.communicate(timeout=600)
        _, ref_err = ref.communicate(timeout=600)
    assert ref.returncode == 0, ref_err[-3000:]
    assert cli.returncode == 0, cli_err[-3000:]
    return {"work": work, "one": one, "mesh1": one_rank_mesh(work, one),
            "two": (json.loads((work / "train_port_2.json").read_text()),
                    dict(np.load(work / "train_port_2.npz"))),
            "ref": (json.loads((work / "train_ref.json").read_text()),
                    dict(np.load(work / "train_ref.npz"))),
            "cli": (cli_out, (work / "cli_jax.log").read_text())}


def case_cfg(name):
    return cfg_of(next(c["arch"] for c in SPEC["cases"] if c["name"] == name))


def assert_run_matches(got_metrics, got_params, got_m, want_metrics, want_params, want_m,
                       m_rtol=2 * GRAD_RTOL):
    assert len(got_metrics) == len(want_metrics) == STEPS
    for g, w in zip(got_metrics, want_metrics):
        for k in ("loss", "nll", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(g["aux"], w["aux"], rtol=LOSS_RTOL, atol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=GRAD_RTOL)
    top = max(float(np.abs(v).max()) for v in want_m.values())
    for n, w in want_m.items():
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top, 1e-30)
        assert float(np.abs(got_m[n] - w).max()) / scale <= m_rtol, n
    lrs = sum(m["lr"] for m in want_metrics)
    for n, w in want_params.items():
        assert (np.abs(got_params[n] - w) <= 2 * lrs + 1e-6 * np.abs(w) + 1e-7).all(), n


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_matches_one_process(runs, name):
    """Two gloo ranks on (2, 1) against the port's one-process step."""
    metrics, flat = runs["two"]
    params = {k[len(f"{name}/params/"):]: v for k, v in flat.items()
              if k.startswith(f"{name}/params/")}
    m = {k[len(f"{name}/m/"):]: v for k, v in flat.items() if k.startswith(f"{name}/m/")}
    assert_run_matches(metrics[name], params, m, *runs["one"][name])


@pytest.mark.parametrize("name", REF_CASES)
def test_sharded_step_matches_reference(runs, name):
    """Two gloo ranks on (2, 1) against the JAX package's step jitted with
    ``param_shardings`` / ``opt_shardings`` on two forced devices."""
    metrics, flat = runs["two"]
    ref_metrics, ref_flat = runs["ref"]
    cfg = case_cfg(name)
    params = {k[len(f"{name}/params/"):]: v for k, v in flat.items()
              if k.startswith(f"{name}/params/")}
    m = {k[len(f"{name}/m/"):]: v for k, v in flat.items() if k.startswith(f"{name}/m/")}
    assert_run_matches(metrics[name], params, m, ref_metrics[name],
                       named(cfg, ref_flat, f"{name}/params/"), named(cfg, ref_flat, f"{name}/m/"),
                       m_rtol=REF_M_RTOL)


@pytest.mark.parametrize("name", CASES)
def test_one_rank_mesh_is_the_one_process_step(runs, name):
    """A (1, 1) mesh replicates every leaf: its step is the one-process
    step, bit for bit (metrics, parameters and m)."""
    metrics, params, m = runs["mesh1"][name]
    want_metrics, want_params, want_m = runs["one"][name]
    assert metrics == want_metrics
    for n, w in want_params.items():
        assert np.array_equal(params[n].numpy(), w), n
    for n, w in want_m.items():
        assert np.array_equal(m[n].numpy(), w), n


@pytest.mark.parametrize("name", HOOK_CASES)
def test_train_step_hooks_on_one_rank(runs, name):
    """``train.step.make_train_step`` with ``act_shard`` and
    ``logit_shard`` (``act_constraint`` / ``logit_constraint``) and, for
    the MoE, ``moe_fn`` (``make_tp_moe_fn``) on a (1, 1) mesh: the steps
    equal the step without hooks, bit for bit (metrics, parameters and m)."""
    metrics, params, m = runs["mesh1"][f"{name}/hooks"]
    want_metrics, want_params, want_m = runs["one"][name]
    assert metrics == want_metrics
    for n, w in want_params.items():
        assert np.array_equal(params[n], w), n
    for n, w in want_m.items():
        assert np.array_equal(m[n], w), n


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", ["qwen2_1_5b", "deepseek_moe_16b", "xlstm_125m",
                                  "recurrentgemma_9b"])
def test_each_rank_holds_its_spec_block(runs, name, rank):
    """Each rank's parameter shapes are the spec's blocks on (2, 1): the
    leaf's ``data`` dim halved, the rest whole; some leaves are cut."""
    class Mesh21:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 1}

    cfg = case_cfg(name)
    got = json.loads((runs["work"] / f"train_shapes_2_{rank}.json").read_text())[name]
    specs = param_shardings(cfg, Mesh21())
    full = {n: list(p.shape) for n, p in abstract_params(cfg).named_parameters()}
    cut = 0
    for n, shape in full.items():
        want = [d // 2 if i < len(specs[n]) and specs[n][i] == "data" else d
                for i, d in enumerate(shape)]
        cut += want != shape
        assert got[n] == want, n
    assert cut and "embed" in [n for n in full if got[n] != full[n]]


def test_setup_binds_masks_and_capacity(runs):
    """The cases test what they claim: the two ranks' rows hold different
    mask counts, and deepseek's capacity factor 0.5 drops tokens (its loss
    differs from the no-drop factor's)."""
    z = np.load(runs["work"] / "batches_qwen2_1_5b.npz")
    mask = z["0/loss_mask"]
    assert mask[:2].sum() != mask[2:].sum()
    cfg = case_cfg("deepseek_moe_16b")
    nodrop = dataclasses.replace(cfg, capacity_factor=configs.reduced(
        configs.ARCHS["deepseek_moe_16b"]).capacity_factor)
    batches = ranks.batches_of(runs["work"], "deepseek_moe_16b", "cpu")
    init = str(runs["work"] / "init_deepseek_moe_16b")
    loss = lambda c: one_process(c, ranks.load_params(c, init), batches[:1])[0][0]["loss"]
    assert abs(loss(cfg) - loss(nodrop)) > 1e-4


def test_checkpoints_cross_rank_counts(runs):
    """Written on two ranks (after two steps) and resumed on one, and
    written by the one-process step and resumed on two: the next step's
    loss is the uninterrupted runs' (the layout is the same either way)."""
    two = runs["two"][0]
    one = runs["one"]["qwen2_1_5b"][0]
    step, m = runs["mesh1"]["resumed"]
    assert step == 2
    np.testing.assert_allclose(m["loss"], two["qwen2_1_5b"][2]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["loss"], one[2]["loss"], rtol=LOSS_RTOL)
    r = two["qwen2_1_5b/resumed"]
    assert r["step"] == 2
    np.testing.assert_allclose(r["loss"], one[2]["loss"], rtol=LOSS_RTOL)
    work = runs["work"]
    layouts = []
    for d in ("ckpt_2rank_qwen2_1_5b", "ckpt_1rank_qwen2_1_5b"):
        with np.load(work / d / "step_00000002" / "host0000.npz") as z:
            layouts.append({k: (z[k].shape, z[k].dtype) for k in z.files})
    assert layouts[0] == layouts[1]


def test_cli_on_two_ranks_matches_reference_cli(runs):
    """``torch.distributed.run --nproc-per-node 2`` of the port's train CLI
    against the JAX package's CLI on two forced devices, both resuming one
    step-0 checkpoint: every step line's loss, nll and gnorm, to the
    printed digits; only rank 0 prints."""
    port, ref = runs["cli"]
    lines = lambda out: [l.split()[2:9] for l in out.splitlines() if l.startswith("[train] step")]
    assert len(lines(ref)) == 3
    assert lines(port) == lines(ref)
    assert port.count("[train] done.") == 1 and "resumed from step 0" in port
