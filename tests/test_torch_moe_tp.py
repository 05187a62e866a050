"""The port's expert-parallel MoE (``layers.moe_ffn_tp`` /
``make_tp_moe_fn``) against the JAX package's, on the CPU.

Reduced deepseek-moe-16b (4 experts, top-2), B=4 x S=16, the same weights
(the port's ``init_params``, carried to the reference through a
checkpoint) and tokens in both packages.  ``forward(..., moe_fn=...)`` and
the gradient of ``sum(logits * R) / R.size + aux`` for a fixed numpy R, on
the meshes (1, 4), (2, 2) and (4, 1), at the reduced config's capacity
factor (no drops) and at 0.5 (tokens drop).  At (1, 4) the ranks also
run ``prefill`` and the train loss's ``value_and_grad`` with ``moe_fn``,
and at (4, 1) ``prefill`` with ``act_shard`` too, against the port's dense
calls.  The reference runs once, in
one subprocess with four forced host devices; the port runs four gloo
ranks (``tests/torch_mesh_ranks.py``) at the same time.
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
from repro_torch.distributed.checkpoint import _unflatten_like
from repro_torch.models.transformer import abstract_params, forward, init_params
from repro_torch.serving.decode import prefill
from repro_torch.train.step import TrainConfig, value_and_grad

import torch_mesh_ranks

ARCH = "deepseek_moe_16b"
B, S = 4, 16
MESHES = [(1, 4), (2, 2), (4, 1)]
BASE = configs.reduced(configs.ARCHS[ARCH])
CAPACITY = [BASE.capacity_factor, 0.5]
# float32.  The packages sum in different orders: the logits differ by up
# to 2.0e-5 of their largest magnitude (0.63) while the port's (1, 4)
# forward equals its own dense forward, so the logits are held to
# LOGIT_RTOL (2.5x that) of their largest; the aux loss agrees to 1.2e-7
# and is held to AUX_RTOL.  Every gradient leaf within 2e-4 of its
# largest, floored at 1e-6 of the model's largest (the train tests' rule;
# 8e-5 measured).  The port's (1, 4) forward and prefill equal its dense
# ones (0 measured) within AUX_RTOL of the logits' largest; its
# value_and_grad's loss terms equal the dense ones (0 measured) within
# AUX_RTOL and its gradients are held to the train tests' rule (4.1e-7
# measured).
LOGIT_RTOL = 5e-5
AUX_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 2e-4, 1e-6

REF = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import ARCHS, reduced
    from repro.distributed.checkpoint import _flatten, load_checkpoint
    from repro.launch.mesh import make_test_mesh
    from repro.launch.sharding import _batch_dim_spec
    from repro.models.layers import make_tp_moe_fn
    from repro.models.transformer import abstract_params, forward
    work = sys.argv[1]
    spec = json.load(open(f"{work}/moe_cases.json"))
    inputs = dict(np.load(f"{work}/moe_inputs.npz"))
    base = reduced(ARCHS[spec["arch"]])
    _, state, _ = load_checkpoint(f"{work}/moe_params", {"params": abstract_params(base)})
    params = jax.tree.map(jnp.asarray, state["params"])
    tokens, R = jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["R"])
    out = {}
    for cf in spec["capacity_factors"]:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        for shape in spec["meshes"]:
            mesh = make_test_mesh(tuple(shape))
            with mesh:
                moe_fn = make_tp_moe_fn(mesh, _batch_dim_spec(mesh, tokens.shape[0]), cfg)
                def f(p):
                    logits, aux = forward(p, cfg, {"tokens": tokens}, remat=False,
                                          moe_fn=moe_fn)
                    return (logits * R).sum() / R.size + aux, (logits, aux)
                (_, (logits, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
            tag = f"cf{cf}_{shape[0]}x{shape[1]}"
            out[f"{tag}/logits"] = np.asarray(logits)
            out[f"{tag}/aux"] = np.asarray(aux)
            out.update({f"{tag}/grad/{k}": np.asarray(v) for k, v in _flatten(g)})
    np.savez(f"{work}/moe_ref.npz", **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port) results by case tag, and the port's inputs."""
    work = tmp_path_factory.mktemp("moe_tp")
    model = init_params(BASE, 0, device="cpu")
    save_checkpoint(str(work / "moe_params"), 0, {"params": cv.lm_tree_from_params(BASE, model)})
    rng = np.random.default_rng(5)
    inputs = {"tokens": rng.integers(0, BASE.vocab, (B, S)).astype(np.int32),
              "R": rng.standard_normal((B, S, BASE.vocab)).astype(np.float32)}
    inputs["labels"] = rng.integers(0, BASE.vocab, (B, S)).astype(np.int32)
    np.savez(work / "moe_inputs.npz", **inputs)
    (work / "moe_cases.json").write_text(json.dumps(
        {"arch": ARCH, "capacity_factors": CAPACITY, "meshes": MESHES}))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(work)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(torch_mesh_ranks.moe_tp, args=(4, str(work)), nprocs=4)
    finally:
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    want, got = dict(np.load(work / "moe_ref.npz")), dict(np.load(work / "moe_port.npz"))
    return want, got, model, inputs


def grads_by_name(cfg, flat: dict, tag: str, port: bool) -> dict:
    """{parameter name: gradient} of one case."""
    pre = f"{tag}/grad/"
    if port:
        return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}
    template = cv.lm_tree_from_params(cfg, abstract_params(cfg))
    tree = _unflatten_like(template, {k[len(pre):]: v for k, v in flat.items()
                                      if k.startswith(pre)})
    return {k: np.asarray(v, np.float32) for k, v in cv.lm_named_from_tree(cfg, tree).items()}


def leaf_errors(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    return {n: float(np.abs(got[n] - w).max()) / max(float(np.abs(w).max()),
                                                     GRAD_FLOOR * top, 1e-30)
            for n, w in want.items()}


CASES = [(cf, shape) for cf in CAPACITY for shape in MESHES]
IDS = [f"cf{cf}-{shape[0]}x{shape[1]}" for cf, shape in CASES]


@pytest.mark.parametrize("cf,shape", CASES, ids=IDS)
def test_moe_fn_matches_reference(runs, cf, shape):
    """Logits, aux and every gradient leaf of the port's ``moe_fn`` on four
    gloo ranks against the reference's ``shard_map`` on four devices."""
    want, got, _, _ = runs
    tag = f"cf{cf}_{shape[0]}x{shape[1]}"
    cfg = dataclasses.replace(BASE, capacity_factor=cf)
    ref = want[f"{tag}/logits"]
    err = float(np.abs(got[f"{tag}/logits"] - ref).max())
    assert err <= LOGIT_RTOL * float(np.abs(ref).max()), err
    np.testing.assert_allclose(got[f"{tag}/aux"], want[f"{tag}/aux"], rtol=AUX_RTOL)
    errs = leaf_errors(grads_by_name(cfg, got, tag, True), grads_by_name(cfg, want, tag, False))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("cf", CAPACITY)
def test_moe_fn_on_the_model_axis_equals_dense(runs, cf):
    """At (1, 4) every rank sees the whole batch, so the expert-parallel
    forward routes, drops and combines as the dense ``moe_ffn`` does: the
    port's four-rank logits and aux equal its one-process forward's."""
    _, got, model, inputs = runs
    cfg = dataclasses.replace(BASE, capacity_factor=cf)
    with torch.no_grad():
        logits, aux = forward(model, cfg, {"tokens": torch.from_numpy(inputs["tokens"])},
                              remat=False)
    tag = f"cf{cf}_1x4"
    want = logits.numpy()
    assert float(np.abs(got[f"{tag}/logits"] - want).max()) <= AUX_RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got[f"{tag}/aux"], float(aux), rtol=AUX_RTOL)


@pytest.mark.parametrize("cf", CAPACITY)
def test_prefill_and_train_loss_take_moe_fn(runs, cf):
    """The hooks of ``serving.decode.prefill`` and ``train.step.value_and_grad``:
    with ``moe_fn`` on the (1, 4) ranks, the last position's logits, the
    caches, the loss terms and every gradient leaf equal the port's dense
    one-process calls."""
    _, got, model, inputs = runs
    cfg = dataclasses.replace(BASE, capacity_factor=cf)
    tag = f"cf{cf}_1x4"
    tokens, labels = (torch.from_numpy(inputs[k]) for k in ("tokens", "labels"))
    with torch.no_grad():
        last, caches = prefill(model, cfg, {"tokens": tokens})
    want = last.numpy()
    assert float(np.abs(got[f"{tag}/prefill/logits"] - want).max()) <= \
        AUX_RTOL * float(np.abs(want).max())
    cache = {f"{i}/{k}": v.float().numpy() for i, c in enumerate(caches) for k, v in c.items()}
    pre = f"{tag}/prefill/cache/"
    assert sorted(cache) == sorted(k[len(pre):] for k in got if k.startswith(pre))
    for k, v in cache.items():
        assert float(np.abs(got[pre + k] - v).max()) <= AUX_RTOL * float(np.abs(v).max()), k
    total, parts, grads = value_and_grad(model, cfg, {"tokens": tokens, "labels": labels},
                                         TrainConfig(remat=False))
    for k, v in {"total": total, **parts}.items():
        np.testing.assert_allclose(got[f"{tag}/loss/{k}"], float(v), rtol=AUX_RTOL, err_msg=k)
    pre = f"{tag}/loss_grad/"
    errs = leaf_errors({k[len(pre):]: v for k, v in got.items() if k.startswith(pre)},
                       {n: g.numpy() for n, g in grads.items()})
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


def test_prefill_takes_act_shard_on_the_data_axis(runs):
    """``prefill`` with ``act_shard`` (``act_constraint``) and ``moe_fn`` on
    (4, 1), each rank its row: at the no-drop factor the gathered
    last-position logits equal the dense one-process prefill's (routing
    per shard drops nothing there)."""
    _, got, model, inputs = runs
    with torch.no_grad():
        last, _ = prefill(model, BASE, {"tokens": torch.from_numpy(inputs["tokens"])})
    want = last.numpy()
    err = float(np.abs(got[f"cf{BASE.capacity_factor}_4x1/prefill/logits"] - want).max())
    assert err <= AUX_RTOL * float(np.abs(want).max()), err


def test_capacity_binds_at_the_small_factor(runs):
    """The small factor drops tokens: its logits differ from the
    no-drop factor's."""
    _, got, _, _ = runs
    a, b = (got[f"cf{cf}_1x4/logits"] for cf in CAPACITY)
    assert float(np.abs(a - b).max()) > 1e-3


def test_moe_fn_aux_is_per_data_shard(runs):
    """Deliberate, as in the reference: ``moe_fn`` routes and counts each
    data shard's tokens on their own and averages the shards' aux losses,
    so with the batch over ``data`` its aux differs from the dense
    ``moe_ffn``'s over the whole batch, and without (1, 4) it is the same."""
    want, got, model, inputs = runs
    with torch.no_grad():
        _, dense = forward(model, BASE, {"tokens": torch.from_numpy(inputs["tokens"])},
                           remat=False)
    for shape in ("2x2", "4x1"):
        tag = f"cf{BASE.capacity_factor}_{shape}"
        assert abs(float(got[f"{tag}/aux"]) - float(dense)) > 1e-4 * float(dense), shape
        assert abs(float(want[f"{tag}/aux"]) - float(dense)) > 1e-4 * float(dense), shape
    assert float(got[f"cf{BASE.capacity_factor}_1x4/aux"]) == float(dense)
