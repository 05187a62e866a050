"""The port's dense tensor parallelism over the LM mesh's ``model`` axis
(``repro_torch.distributed.{tp,fsdp}``: heads, kv_heads, mlp, vocab, lru,
experts; the S-sharded KV cache; ``tp_act``) on four gloo ranks, on the CPU.

All ten reduced configs (float32) on (1, 4) and (2, 2), with ``tp_act``
also for qwen2 and recurrentgemma: the forward's logits, the loss terms
and every gradient leaf, a train step's parameters and m, prefill's
last-position logits and every cache leaf, and three decode steps (their
logits and the caches after) against the port's one-process calls; for
qwen2, deepseek (dense MoE at capacity factor 0.5, so drops bind),
recurrentgemma and xlstm also three train steps, prefill and decode
against the JAX package's programs jitted with ``build_cell``'s
``in_shardings`` / ``out_shardings`` on four forced devices.  Each rank's
parameters, m, v, caches and logits are its spec's blocks; a checkpoint
written on (2, 2) resumes on (4, 1) and (1, 1); ``make_tp_moe_fn`` through
``fsdp.make_train_step`` on (2, 2) against the reference's step with its
``moe_fn``; a prompt shorter than recurrentgemma's ring window served on
(1, 1) and (1, 4) against the one-process prefill, ``grow_caches`` and
decode.  The weights are the port's ``init_params`` with wq and wk
rescaled to fan-in d (the raw init's near one-hot attention turns a
rounding-level change of the weights into gradient changes of 4.3e-4 of a
leaf in reduced recurrentgemma, 3.5e-6 at fan-in d), carried to the
reference through a checkpoint.

One spawn of four gloo ranks (``tests/torch_mesh_ranks.py``), the
one-process calls and two reference subprocesses (one per mesh) run at
the same time.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch import convert as cv
from repro_torch.distributed import save_checkpoint
from repro_torch.launch.mesh import close_world, init_world, make_test_mesh
from repro_torch.launch.sharding import (NamedSharding, cache_shardings, opt_shardings,
                                         param_shardings)
from repro_torch.distributed import tp as tpm
from repro_torch.models.transformer import forward, init_params
from repro_torch.serving.decode import decode_step, grow_caches, prefill
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import TrainConfig, make_train_step, value_and_grad

import torch_mesh_ranks as ranks
from test_torch_train_mesh import GRAD_FLOOR, GRAD_RTOL, LOSS_RTOL, REF_M_RTOL, named

ARCHS = sorted(configs.ARCHS)
REF_ARCHS = ["qwen2_1_5b", "deepseek_moe_16b", "recurrentgemma_9b", "xlstm_125m"]
TP_ACT = ["qwen2_1_5b", "recurrentgemma_9b"]
MESHES = [(1, 4), (2, 2)]
B, S, S_MAX, DECODE = 4, 32, 36, 3
REF_STEPS = 3
# the short prompt: 16 positions under recurrentgemma's window of 32, the
# caches grown by 24 (the ring to min(32, 40) slots), 8 decode steps
SHORT_S, SHORT_GROW, SHORT_STEPS = 16, 24, 8
# float32.  The sharded programs sum in other orders than the one-process
# ones (partial products over a cut dim, the log-sum-exp over vocab
# blocks, flash-decode's combine): logits, caches and the loss terms are
# held to LOGIT_RTOL of their largest magnitude (LOSS_RTOL for the loss);
# gradients, m and parameters by test_torch_train_mesh's rule (GRAD_RTOL
# of a leaf's largest, floored at GRAD_FLOOR of the model's largest; a
# parameter within 2 x the summed learning rates plus 1e-6 of itself).
# Against the reference, its GSPMD orders differ again: logits to
# REF_LOGIT_RTOL, m after three steps to REF_M_RTOL.  The conv states,
# rounded to bfloat16, to one bfloat16 ulp of their largest magnitude
# (BF16_RTOL): a float32 difference at rounding level flips a rounding;
# after the decode steps, which read them, the recurrent blocks' whole
# states too (1.9e-4 measured on recurrentgemma's last h against the
# reference).
LOGIT_RTOL = 5e-5
REF_LOGIT_RTOL = 1e-4
BF16_RTOL = 2.0 ** -8
SPEC = {
    "s_max": S_MAX,
    "capacity": {"deepseek_moe_16b": 0.5},
    "cases": [],
    "restore": [{"name": "qwen2_2x2_to_4x1", "arch": "qwen2_1_5b", "mesh": [4, 1],
                 "ckpt": "ckpt_qwen2_1_5b_2x2"}],
    "short": {"arch": "recurrentgemma_9b", "grow": SHORT_GROW, "meshes": [[1, 4]]},
}
for _a in ARCHS:
    for _m in MESHES:
        _tag = f"{_a}_{_m[0]}x{_m[1]}"
        SPEC["cases"].append({"name": _tag, "arch": _a, "mesh": list(_m),
                              "steps": REF_STEPS if _a in REF_ARCHS else 1,
                              "blocks": _a in ("qwen2_1_5b", "recurrentgemma_9b")})
        if _a in TP_ACT:
            SPEC["cases"].append({"name": _tag + "_tp_act", "arch": _a, "mesh": list(_m),
                                  "steps": 1, "tp_act": True})
next(c for c in SPEC["cases"] if c["name"] == "qwen2_1_5b_2x2")["save_after"] = 2
SPEC["cases"].append({"name": "deepseek_moe_16b_2x2_moe_fn", "arch": "deepseek_moe_16b",
                      "mesh": [2, 2], "steps": 1, "moe_fn": True})
CASES = [c["name"] for c in SPEC["cases"] if not c.get("moe_fn")]
REF_CASES = [f"{a}_{m[0]}x{m[1]}" for a in REF_ARCHS for m in MESHES]

REF = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import ARCHS, reduced
    from repro.distributed.checkpoint import _flatten, load_checkpoint
    from repro.launch.mesh import make_test_mesh
    from repro.launch.sharding import (ShardingRules, _batch_dim_spec, act_constraint,
                                       batch_shardings, cache_shardings, logit_constraint,
                                       opt_shardings, param_shardings)
    from repro.models.layers import make_tp_moe_fn
    from repro.models.transformer import abstract_params
    from repro.serving.decode import decode_step, init_caches, prefill
    from repro.train.optimizer import init_opt_state
    from repro.train.step import TrainConfig, make_train_step
    work, part = sys.argv[1], sys.argv[2]
    spec = json.load(open(f"{work}/tp_spec.json"))
    out, metrics = {}, {}
    tcfg = TrainConfig(remat=False)
    for case in spec["ref_cases"]:
        name, arch = case["name"], case["arch"]
        if "x".join(map(str, case["mesh"])) != part:
            continue
        cfg = reduced(ARCHS[arch])
        if arch in spec["capacity"]:
            cfg = dataclasses.replace(cfg, capacity_factor=spec["capacity"][arch])
        _, st, _ = load_checkpoint(f"{work}/init_{arch}", {"params": abstract_params(cfg)})
        z = np.load(f"{work}/tp_inputs_{arch}.npz")
        train = [{k.split("/")[2]: z[k] for k in z.files if k.startswith(f"train/{i}/")}
                 for i in range(case["steps"])]
        pre = {k.split("/")[1]: z[k] for k in z.files if k.startswith("prefill/")}
        dec = [{k.split("/")[2]: z[k] for k in z.files if k.startswith(f"decode/{i}/")}
               for i in range(spec["decode"])]
        b, S, s_max = train[0]["labels"].shape[0], train[0]["labels"].shape[1], spec["s_max"]
        mesh = make_test_mesh(tuple(case["mesh"]))
        rules = ShardingRules(mesh)
        p_sh, o_sh = param_shardings(cfg, mesh), opt_shardings(cfg, mesh)
        act = act_constraint(mesh, b)
        moe_fn = (make_tp_moe_fn(mesh, _batch_dim_spec(mesh, b), cfg)
                  if case.get("moe_fn") else None)
        step = make_train_step(cfg, tcfg, act_shard=act,
                               logit_shard=logit_constraint(mesh, b, cfg.vocab), moe_fn=moe_fn)
        logits_sh = rules.named(rules.resolve((b, cfg.vocab), (None, "vocab")))
        with mesh:
            params = jax.device_put(st["params"], p_sh)
            if not case.get("moe_fn"):
                c_pre = cache_shardings(cfg, mesh, b, S)
                fpre = jax.jit(lambda p, x: prefill(p, cfg, x, q_chunk=tcfg.q_chunk,
                                                    act_shard=act),
                               in_shardings=(p_sh, batch_shardings(mesh, pre)),
                               out_shardings=(logits_sh, c_pre))
                last, caches = fpre(params, pre)
                out[f"{name}/prefill/logits"] = np.asarray(last)
                out.update({f"{name}/prefill/cache/{k}": np.asarray(v)
                            for k, v in _flatten(caches)})
                grown = jax.tree.map(
                    lambda a, z: a if a.shape == z.shape else jnp.pad(
                        a, [(0, zs - s) for s, zs in zip(a.shape, z.shape)]),
                    caches, init_caches(cfg, b, s_max))
                c_dec = cache_shardings(cfg, mesh, b, s_max)
                fdec = jax.jit(lambda p, c, x, pos: decode_step(p, cfg, c, x, pos),
                               in_shardings=(p_sh, c_dec, batch_shardings(mesh, dec[0]), None),
                               out_shardings=(logits_sh, c_dec))
                caches = jax.device_put(grown, c_dec)
                for i, inp in enumerate(dec):
                    lg, caches = fdec(params, caches, inp, jnp.int32(S + i))
                    out[f"{name}/decode/{i}"] = np.asarray(lg)
                out.update({f"{name}/decode/cache/{k}": np.asarray(v)
                            for k, v in _flatten(caches)})
            opt = jax.device_put(init_opt_state(params), o_sh)
            jstep = jax.jit(step, in_shardings=(p_sh, o_sh, batch_shardings(mesh, train[0])),
                            out_shardings=(p_sh, o_sh, None))
            ms = []
            for batch in train:
                params, opt, m = jstep(params, opt, batch)
                ms.append({k: float(v) for k, v in m.items()})
        metrics[name] = ms
        out.update({f"{name}/params/{k}": np.asarray(v) for k, v in _flatten(params)})
        out.update({f"{name}/m/{k}": np.asarray(v) for k, v in _flatten(opt["m"])})
    np.savez(f"{work}/tp_ref_{part}.npz", **out)
    json.dump(metrics, open(f"{work}/tp_ref_{part}.json", "w"))
""")


def cfg_of(arch):
    return ranks.train_cfg(SPEC, arch)


def qk_fan_in_d(cfg, model):
    """wq and wk from the reference's ``_dense`` fan-in (H, Hkv) to d."""
    with torch.no_grad():
        for blk in model.layers:
            if hasattr(blk, "wq"):
                blk.wq.mul_((cfg.n_heads / cfg.d_model) ** 0.5)
                blk.wk.mul_((cfg.n_kv_heads / cfg.d_model) ** 0.5)


def make_inputs(arch, seed):
    """Three train batches (a loss mask denser on the first half of the
    rows), a prefill batch and three decode steps' inputs."""
    cfg = cfg_of(arch)
    rng = np.random.default_rng(seed)
    audio, vlm = cfg.family == "audio", cfg.family == "vlm"

    def batch():
        if audio:
            out = {"frame_embeds": rng.standard_normal((B, S, cfg.frontend_dim()))
                   .astype(np.float32)}
        else:
            out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
            if vlm:
                out["image_embeds"] = rng.standard_normal(
                    (B, cfg.frontend_tokens, cfg.frontend_dim())).astype(np.float32)
        return out

    out = {}
    for i in range(REF_STEPS):
        dens = np.where(np.arange(B) < B // 2, 0.9, 0.35)[:, None]
        t = {**batch(), "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "loss_mask": (rng.random((B, S)) < dens).astype(np.float32)}
        out.update({f"train/{i}/{k}": v for k, v in t.items()})
    out.update({f"prefill/{k}": v for k, v in batch().items()})
    for i in range(DECODE):
        if audio:
            out[f"decode/{i}/frame_embeds"] = rng.standard_normal(
                (B, cfg.frontend_dim())).astype(np.float32)
        else:
            out[f"decode/{i}/token"] = rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
    return out


def one_process(arch, work):
    """The port's one-process calls on the same weights and inputs: the
    forward's logits, value_and_grad, prefill, decode (the caches grown to
    S_MAX) and the train steps (parameters and m after the first; metrics
    of each): REF_STEPS for qwen2 (the checkpoint test resumes at its
    third), one for the others."""
    cfg = cfg_of(arch)
    train, pre, dec = ranks.tp_inputs(work, arch, "cpu")
    load = lambda: ranks.load_params(cfg, str(work / f"init_{arch}"))
    model = load()
    out = {}
    with torch.no_grad():
        out["forward"] = forward(model, cfg, train[0], remat=False)[0].numpy()
    total, parts, grads = value_and_grad(model, cfg, train[0], TrainConfig())
    out["loss"] = {k: float(v) for k, v in {"total": total, **parts}.items()}
    out["grad"] = {n: g.numpy() for n, g in grads.items()}
    with torch.no_grad():
        last, caches = prefill(model, cfg, pre)
        out["prefill/logits"] = last.numpy()
        out["prefill/cache"] = [{k: v.float().numpy().copy() for k, v in c.items()}
                                for c in caches]
        # the recurrent blocks round their conv state to bfloat16 in every
        # config (float32 storage in the reduced ones); a decode step reads
        # it, so after decoding the block's whole state inherits its rounding
        out["bf16"] = {f"{i}/conv" for i, c in enumerate(caches) if "conv" in c}
        out["bf16_decode"] = {f"{i}/{k}" for i, c in enumerate(caches) if "conv" in c
                              for k in c}
        caches = grow_caches(cfg, caches, S_MAX - S)
        out["decode"] = []
        for i, inp in enumerate(dec):
            lg, caches = decode_step(model, cfg, caches, inp, S + i)
            out["decode"].append(lg.numpy())
        out["decode/cache"] = [{k: v.float().numpy() for k, v in c.items()} for c in caches]
    opt = init_opt_state(model, device="cpu")
    step_fn = make_train_step(cfg, TrainConfig())
    out["metrics"], out["steps"] = [], {}
    for i, b in enumerate(train[:REF_STEPS if arch == "qwen2_1_5b" else 1]):
        out["metrics"].append({k: float(v) for k, v in step_fn(model, opt, b).items()})
        out["steps"][i + 1] = ({n: p.detach().numpy().copy() for n, p in model.named_parameters()},
                               {n: t.numpy().copy() for n, t in opt["m"].items()})
    return out


def short_one_process(work):
    """The short prompt (``ranks.tp_short``'s case) through the one-process
    ``prefill``, ``grow_caches`` and ``decode_step``."""
    arch = SPEC["short"]["arch"]
    cfg = cfg_of(arch)
    model = ranks.load_params(cfg, str(work / f"init_{arch}"))
    z = np.load(work / "tp_short.npz")
    with torch.no_grad():
        last, caches = prefill(model, cfg, {"tokens": torch.from_numpy(z["tokens"])})
        caches = grow_caches(cfg, caches, SHORT_GROW)
        out = {"prefill": last.numpy()}
        for i, tok in enumerate(z["decode"]):
            lg, caches = decode_step(model, cfg, caches, {"token": torch.from_numpy(tok)},
                                     SHORT_S + i)
            out[f"decode/{i}"] = lg.numpy()
    out.update({f"cache/{i}/{k}": t.float().numpy() for i, c in enumerate(caches)
                for k, t in c.items()})
    return out


def one_rank(work):
    """On a one-rank mesh in this process: the (2, 2) checkpoint resumed
    (the next step's metrics), and the short prompt served on (1, 1) and
    in one process, at the same thread count."""
    from repro_torch.distributed import fsdp, load_checkpoint
    cfg = cfg_of("qwen2_1_5b")
    init_world("cpu")
    try:
        mesh = make_test_mesh((1, 1), device="cpu")
        short = {"1x1": ranks.tp_short(SPEC, mesh, work, "cpu"),
                 "one": short_one_process(work)}
        model = fsdp.shard_model(ranks.load_params(cfg, str(work / "init_qwen2_1_5b")), mesh)
        opt = init_opt_state(model, device="cpu")
        step, state, _ = load_checkpoint(str(work / "ckpt_qwen2_1_5b_2x2"),
                                         fsdp.checkpoint_state(cfg, model, opt), device="cpu",
                                         shardings=fsdp.state_shardings(cfg, model))
        fsdp.load_state(cfg, model, opt, state)
        train, _, _ = ranks.tp_inputs(work, "qwen2_1_5b", "cpu")
        m = fsdp.make_train_step(cfg, TrainConfig(), mesh, B)(model, opt, train[step])
        return {"step": step, **{k: float(v) for k, v in m.items()}}, short
    finally:
        close_world()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    SPEC["decode"] = DECODE
    SPEC["ref_cases"] = [c for c in SPEC["cases"]
                         if c["name"] in REF_CASES or c.get("moe_fn")]
    (work / "tp_spec.json").write_text(json.dumps(SPEC))
    for seed, arch in enumerate(ARCHS):
        model = init_params(cfg_of(arch), 0, device="cpu")
        qk_fan_in_d(cfg_of(arch), model)
        save_checkpoint(str(work / f"init_{arch}"), 0,
                        {"params": cv.lm_tree_from_params(cfg_of(arch), model)})
        np.savez(work / f"tp_inputs_{arch}.npz", **make_inputs(arch, seed))
    rng = np.random.default_rng(len(ARCHS))
    vocab = cfg_of(SPEC["short"]["arch"]).vocab
    np.savez(work / "tp_short.npz",
             tokens=rng.integers(0, vocab, (B, SHORT_S)).astype(np.int32),
             decode=rng.integers(0, vocab, (SHORT_STEPS, B)).astype(np.int32))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    parts = [f"{m[0]}x{m[1]}" for m in MESHES]
    refs = [subprocess.Popen([sys.executable, "-c", REF, str(work), p], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for p in parts]
    try:
        spawned = mp.spawn(ranks.tp_mesh, args=(4, str(work)), nprocs=4, join=False)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)          # the ranks and the references share the cores
        try:
            one = {a: one_process(a, work) for a in ARCHS}
        finally:
            torch.set_num_threads(threads)
            while not spawned.join():
                pass
        restored, short = one_rank(work)
    finally:
        errs = [r.communicate(timeout=900)[1] for r in refs]
    for r, err in zip(refs, errs):
        assert r.returncode == 0, err[-3000:]
    ref_metrics, ref_arrays = {}, {}
    for p in parts:
        ref_metrics.update(json.loads((work / f"tp_ref_{p}.json").read_text()))
        ref_arrays.update(np.load(work / f"tp_ref_{p}.npz"))
    port = dict(np.load(work / "tp_port.npz"))
    short["1x4"] = of(port, "short/1x4/")
    return {"work": work, "port": port, "one": one, "restored": restored, "short": short,
            "ref": (ref_metrics, ref_arrays),
            "shapes": [json.loads((work / f"tp_shapes_{r}.json").read_text()) for r in range(4)],
            "blocks": [dict(np.load(work / f"tp_blocks_{r}.npz")) for r in range(4)]}


def arch_of(name):
    return next(c["arch"] for c in SPEC["cases"] if c["name"] == name)


def rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def of(port, prefix):
    return {k[len(prefix):]: v for k, v in port.items() if k.startswith(prefix)}


def assert_leaves(got, want, rtol=GRAD_RTOL):
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top, 1e-30)
        assert float(np.abs(got[n] - w).max()) / scale <= rtol, n


def assert_params(got, want, metrics):
    lrs = sum(m["lr"] for m in metrics)
    for n, w in want.items():
        assert (np.abs(got[n] - w) <= 2 * lrs + 1e-6 * np.abs(w) + 1e-7).all(), n


def grown(cfg, caches):
    """Prefill's caches with the full attention's grown to S_MAX positions
    (the mesh programs' layout; ``grow_caches``)."""
    pad = [(0, 0), (0, S_MAX - S), (0, 0), (0, 0)]
    return [{k: np.pad(v, pad) for k, v in c.items()} if cfg.block_kind(i) == "attn" else c
            for i, c in enumerate(caches)]


def assert_caches(got, want, rtol, bf16):
    """{"i/name": array} against a list of cache dicts; the ``bf16`` leaves
    to BF16_RTOL."""
    flat = {f"{i}/{k}": v for i, c in enumerate(want) for k, v in c.items()}
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        tol = BF16_RTOL if k in bf16 else rtol
        assert got[k].shape == v.shape, k
        assert float(np.abs(got[k] - v).max()) <= tol * max(float(np.abs(v).max()), 1e-30), k


@pytest.mark.parametrize("name", CASES)
def test_forward_and_gradients_match_one_process(runs, name):
    """The forward's logits gathered whole, the loss terms and every
    gradient leaf on the (D, M) mesh against the one-process calls."""
    port, want = runs["port"], runs["one"][arch_of(name)]
    assert rel(port[f"{name}/forward"], want["forward"]) <= LOGIT_RTOL
    for k, v in want["loss"].items():
        np.testing.assert_allclose(port[f"{name}/loss/{k}"], v, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    assert_leaves(of(port, f"{name}/grad/"), want["grad"])


@pytest.mark.parametrize("name", CASES)
def test_train_step_matches_one_process(runs, name):
    """One train step's metrics, parameters and m (and every step's
    metrics for the reference configs) against the one-process step."""
    port, want = runs["port"], runs["one"][arch_of(name)]
    metrics = json.loads(str(port[f"{name}/metrics"]))
    for g, w in zip(metrics, want["metrics"]):
        for k in ("loss", "nll", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(g["aux"], w["aux"], rtol=LOSS_RTOL, atol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=GRAD_RTOL)
    params, m = want["steps"][1]
    assert_leaves(of(port, f"{name}/step1/m/"), m, 2 * GRAD_RTOL)
    assert_params(of(port, f"{name}/step1/params/"), params, want["metrics"][:1])


@pytest.mark.parametrize("name", CASES)
def test_prefill_and_decode_match_one_process(runs, name):
    """Prefill's last-position logits and every cache leaf (laid out whole
    again), three decode steps' logits and the caches after, against the
    one-process prefill, ``grow_caches`` and ``decode_step``."""
    port, want = runs["port"], runs["one"][arch_of(name)]
    assert rel(port[f"{name}/prefill/logits"], want["prefill/logits"]) <= LOGIT_RTOL
    assert_caches(of(port, f"{name}/prefill/cache/"),
                  grown(cfg_of(arch_of(name)), want["prefill/cache"]), LOGIT_RTOL, want["bf16"])
    for i, w in enumerate(want["decode"]):
        assert rel(port[f"{name}/decode/{i}"], w) <= LOGIT_RTOL, i
    assert_caches(of(port, f"{name}/decode/cache/"), want["decode/cache"], LOGIT_RTOL,
                  want["bf16_decode"])


@pytest.mark.parametrize("mesh", ["1x1", "1x4"])
def test_short_prompt_ring_matches_one_process(runs, mesh):
    """A prompt shorter than the ring's window: ``tp.make_prefill`` lays the
    ring at min(window, s_max) slots, and so does ``grow_caches`` for the
    one-process decode, so decoding past the prompt evicts nothing still
    in the window on either path.  Prefill's and 8 decode steps' logits
    and the caches after: bit-equal on (1, 1), within LOGIT_RTOL on
    (1, 4) (the recurrent states to one bfloat16 ulp)."""
    cfg = cfg_of(SPEC["short"]["arch"])
    got, want = runs["short"][mesh], runs["short"]["one"]
    ring = [i for i in range(cfg.n_layers) if cfg.block_kind(i) == "local"]
    assert ring and all(want[f"cache/{i}/k"].shape[1] == cfg.local_window for i in ring)
    assert sorted(got) == sorted(want)
    if mesh == "1x1":
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        return
    for k in ["prefill"] + [f"decode/{i}" for i in range(SHORT_STEPS)]:
        assert rel(got[k], want[k]) <= LOGIT_RTOL, k
    n = cfg.n_layers
    caches = [{k.split("/")[2]: v for k, v in want.items() if k.startswith(f"cache/{i}/")}
              for i in range(n)]
    bf16 = {f"{i}/{k}" for i in range(n) if cfg.block_kind(i) == "rglru" for k in caches[i]}
    assert_caches(of(got, "cache/"), caches, LOGIT_RTOL, bf16)


def ref_caches(cfg, flat, prefix):
    from repro_torch.distributed.checkpoint import _unflatten_like
    from repro_torch.serving.decode import abstract_caches
    template = cv.lm_tree_from_caches(cfg, abstract_caches(cfg, 1, 1))
    tree = _unflatten_like(template, of(flat, prefix))
    return [{k: np.asarray(v, np.float32) for k, v in c.items()}
            for c in cv.lm_caches_from_tree(cfg, tree, device="cpu")]


@pytest.mark.parametrize("name", REF_CASES)
def test_sharded_programs_match_reference(runs, name):
    """Three train steps (metrics, parameters and m after), prefill and
    three decode steps on the (D, M) mesh against the reference's jitted
    sharded programs on four forced devices."""
    port = runs["port"]
    ref_metrics, ref = runs["ref"]
    cfg = cfg_of(arch_of(name))
    metrics = json.loads(str(port[f"{name}/metrics"]))
    assert len(metrics) == len(ref_metrics[name]) == REF_STEPS
    for g, w in zip(metrics, ref_metrics[name]):
        for k in ("loss", "nll", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(g["aux"], w["aux"], rtol=LOSS_RTOL, atol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=GRAD_RTOL)
    assert_leaves(of(port, f"{name}/step{REF_STEPS}/m/"), named(cfg, ref, f"{name}/m/"),
                  REF_M_RTOL)
    assert_params(of(port, f"{name}/step{REF_STEPS}/params/"),
                  named(cfg, ref, f"{name}/params/"), ref_metrics[name])
    assert rel(port[f"{name}/prefill/logits"], ref[f"{name}/prefill/logits"]) <= REF_LOGIT_RTOL
    one = runs["one"][arch_of(name)]
    assert_caches(of(port, f"{name}/prefill/cache/"),
                  grown(cfg, ref_caches(cfg, ref, f"{name}/prefill/cache/")), REF_LOGIT_RTOL,
                  one["bf16"])
    for i in range(DECODE):
        assert rel(port[f"{name}/decode/{i}"], ref[f"{name}/decode/{i}"]) <= REF_LOGIT_RTOL, i
    assert_caches(of(port, f"{name}/decode/cache/"),
                  ref_caches(cfg, ref, f"{name}/decode/cache/"), REF_LOGIT_RTOL,
                  one["bf16_decode"])


def test_moe_fn_step_matches_reference(runs):
    """``fsdp.make_train_step(moe_fn=make_tp_moe_fn(...))`` on (2, 2):
    capacity and aux per data shard, as the reference's step with its
    ``moe_fn``; the dense whole-batch step's aux differs."""
    name = "deepseek_moe_16b_2x2_moe_fn"
    port = runs["port"]
    ref_metrics, ref = runs["ref"]
    cfg = cfg_of("deepseek_moe_16b")
    got = json.loads(str(port[f"{name}/metrics"]))[0]
    want = ref_metrics[name][0]
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GRAD_RTOL)
    assert_leaves(of(port, f"{name}/step1/m/"), named(cfg, ref, f"{name}/m/"), REF_M_RTOL)
    dense = json.loads(str(port["deepseek_moe_16b_2x2/metrics"]))[0]
    assert abs(dense["aux"] - got["aux"]) > 1e-4 * abs(dense["aux"])


class FakeMesh:
    def __init__(self, shape, coords):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self._coords = dict(zip(self.axis_names, coords))

    def index(self, axis):
        return self._coords[axis]


def coords(shape, rank):
    return (rank // shape[1], rank % shape[1])


def block_shape(full, spec, mesh):
    return [n // int(np.prod([mesh.shape[a] for a in
                              ((e,) if isinstance(e, str) else e or ())]))
            for n, e in zip(full, list(spec) + [None] * (len(full) - len(spec)))]


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("name", [f"{a}_{m[0]}x{m[1]}" for a in
                                  ("qwen2_1_5b", "deepseek_moe_16b", "recurrentgemma_9b",
                                   "xlstm_125m", "musicgen_medium") for m in MESHES])
def test_each_rank_holds_its_spec_blocks(runs, name, rank):
    """Each rank's parameters, m, v, caches and logits have its spec's
    block shapes (some leaves cut over each axis of the mesh); for qwen2
    and recurrentgemma its cache and logit blocks are the one-process
    values cut by the spec."""
    arch = arch_of(name)
    cfg = cfg_of(arch)
    shape = tuple(next(c["mesh"] for c in SPEC["cases"] if c["name"] == name))
    mesh = FakeMesh(shape, coords(shape, rank))
    got = runs["shapes"][rank][name]
    specs = param_shardings(cfg, mesh)
    from repro_torch.models.transformer import abstract_params
    full = {n: list(p.shape) for n, p in abstract_params(cfg).named_parameters()}
    for key in ("params", "m", "v"):
        assert got[key] == {n: block_shape(full[n], specs[n], mesh) for n in full}, key
    assert opt_shardings(cfg, mesh)["m"] == specs
    axes = {a for s in specs.values() for e in s if e for a in ((e,) if isinstance(e, str) else e)}
    assert axes == {a for a, n in mesh.shape.items() if n > 1}
    cspecs = cache_shardings(cfg, mesh, B, S_MAX)
    want = runs["one"][arch]
    full_caches = [{k: list(v.shape) for k, v in c.items()} for c in want["decode/cache"]]
    assert got["caches"] == [{k: block_shape(s, cspecs[i][k], mesh) for k, s in c.items()}
                             for i, c in enumerate(full_caches)]
    lspec = tpm.logits_spec(mesh, B, cfg.vocab)
    assert got["prefill_logits"] == block_shape([B, cfg.vocab], lspec, mesh)
    assert got["logits"] == block_shape([B, S, cfg.vocab], (lspec[0], None, lspec[1]), mesh)
    if arch in ("qwen2_1_5b", "recurrentgemma_9b"):
        blocks = runs["blocks"][rank]
        cut = lambda a, spec: NamedSharding(mesh, tuple(spec)).shard(torch.from_numpy(a)).numpy()
        assert rel(blocks[f"{name}/prefill_logits"],
                   cut(want["prefill/logits"], lspec)) <= LOGIT_RTOL
        for i, c in enumerate(grown(cfg, want["prefill/cache"])):
            for k, v in c.items():
                b = blocks[f"{name}/cache/{i}/{k}"]
                tol = BF16_RTOL if f"{i}/{k}" in want["bf16"] else LOGIT_RTOL
                assert float(np.abs(b - cut(v, cspecs[i][k])).max()) <= \
                    tol * max(float(np.abs(v).max()), 1e-30), (i, k)


def test_checkpoint_crosses_meshes(runs):
    """Written on (2, 2) after two steps and resumed on (4, 1) and on
    (1, 1): the third step's loss is the uninterrupted runs'."""
    port, one = runs["port"], runs["one"]["qwen2_1_5b"]
    two = json.loads(str(port["qwen2_1_5b_2x2/metrics"]))
    four = json.loads(str(port["restore/qwen2_2x2_to_4x1"]))
    for r in (four, runs["restored"]):
        assert r["step"] == 2
        np.testing.assert_allclose(r["loss"], two[2]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["loss"], one["metrics"][2]["loss"], rtol=LOSS_RTOL)


def test_cases_exercise_the_layouts():
    """The cases cut what they claim: on (1, 4) reduced qwen2's two kv
    heads stay whole under cut q heads, recurrentgemma's one kv head too,
    xlstm's sLSTM heads and mLSTM width are cut, and every S of the caches
    (S_MAX, the ring's window) divides over both model axes."""
    m14 = FakeMesh((1, 4), (0, 0))
    q = param_shardings(cfg_of("qwen2_1_5b"), m14)
    assert q["layers.0.wq"] == (None, "model") and q["layers.0.wk"] == ()
    r = param_shardings(cfg_of("recurrentgemma_9b"), m14)
    assert r["layers.2.wk"] == () and r["layers.0.w_rgate"] == ("model",)
    x = param_shardings(cfg_of("xlstm_125m"), m14)
    assert x["layers.3.r_h"] == ("model",) and x["layers.0.w_up"] == (None, "model")
    for M in (2, 4):
        assert S_MAX % M == 0 and min(cfg_of("recurrentgemma_9b").local_window, S_MAX) % M == 0
