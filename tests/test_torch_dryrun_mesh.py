"""The port's dry run on a mesh (``repro_torch.launch.{mesh,op_cost,
cost_analysis,dryrun}``, ``distributed.{fsdp,tp}`` with ``pod``) on the CPU.

Meta against real: rank 0's count of ``dryrun.build_call``'s program on
``meta`` tensors in a ``counting_world`` of four ranks (torch's ``fake``
backend) against ``OpCostMode`` on rank 0 of four gloo ranks running the
same program on CPU tensors, for the train step, prefill and decode of
reduced qwen2 (GQA), deepseek (MoE, with and without ``moe_tp``) and
recurrentgemma on (1, 4), (2, 2) and (2, 1, 2), qwen2's train step with
``tp_act`` and with a vocab-replicated embedding on (2, 2), and the train
steps of qwen2 and deepseek on (2, 2, 1), where the batch's rows span the
"pod+data" group.

Against the reference: ``repro.launch.dryrun.build_cell`` lowered and
compiled on four forced devices (one subprocess): per-device argument
bytes (``memory_analysis``) and product FLOPs (``hlo_cost`` on the
partitioned HLO, products only), and the ratio of the collective bytes.

The pod axis: the train step on (2, 1, 2) and (2, 2, 1), two steps,
against the one-process step and (qwen2 on (2, 1, 2)) the reference's
jitted step (a second subprocess); prefill and three greedy decode steps
give the one-process tokens.  The same for qwen2 (tied) on (2, 2) with a
vocab-replicated embedding, whose logits ``unembed`` cuts to the rank's
vocab block.  Weights as in ``tests/test_torch_tp.py``
(wq and wk at fan-in d, deepseek at capacity factor 0.5 so drops bind).

The gloo ranks (one thread each), the two reference subprocesses and
this process's meta counts and one-process calls run at the same time.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert as cv
from repro_torch.distributed import save_checkpoint
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch.mesh import (close_world, counting_world, init_world,
                                     make_test_mesh)
from repro_torch.launch.op_cost import COLLECTIVES, OpCostMode, count_call
from repro_torch.models.transformer import init_params
from repro_torch.serving.decode import decode_step, grow_caches, prefill
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import TrainConfig, make_train_step

import torch_mesh_ranks as ranks
from test_torch_tp import (DECODE, S_MAX, assert_leaves, assert_params, make_inputs, of,
                           qk_fan_in_d)
from test_torch_train_mesh import GRAD_RTOL, LOSS_RTOL, REF_M_RTOL, named

B, S = 4, 32
DM, PDM = ("data", "model"), ("pod", "data", "model")
MESHES = {"1x4": ((1, 4), DM), "2x2": ((2, 2), DM), "2x1x2": ((2, 1, 2), PDM),
          "2x2x1": ((2, 2, 1), PDM)}


def count_case(arch, kind, mesh, **variant):
    tag = "".join(f"_{k}" for k in variant if k != "embed_vocab_shard")
    tag += "_embed_replicated" if "embed_vocab_shard" in variant else ""
    shape, axes = MESHES[mesh]
    return {"name": f"{arch}{tag}_{kind}_{mesh}", "arch": arch, "kind": kind,
            "mesh": list(shape), "axes": list(axes), "batch": B, "seq": S, **variant}


COUNT_CASES = [count_case(a, k, m, **v)
               for a, v in [("qwen2_1_5b", {}), ("deepseek_moe_16b", {}),
                            ("deepseek_moe_16b", {"moe_tp": True}), ("recurrentgemma_9b", {})]
               for k in ("train", "prefill", "decode") for m in ("1x4", "2x2", "2x1x2")]
COUNT_CASES += [count_case("qwen2_1_5b", "train", "2x2", tp_act=True),
                count_case("qwen2_1_5b", "train", "2x2", embed_vocab_shard=False),
                count_case("qwen2_1_5b", "train", "2x2x1"),
                count_case("deepseek_moe_16b", "train", "2x2x1")]
COUNT_NAMES = [c["name"] for c in COUNT_CASES]
REF_COUNT = ([f"{a}_{k}_2x2" for a in ("qwen2_1_5b", "deepseek_moe_16b")
              for k in ("train", "prefill", "decode")]
             + ["qwen2_1_5b_train_2x1x2", "qwen2_1_5b_tp_act_train_2x2",
                "qwen2_1_5b_embed_replicated_train_2x2"])

POD_ARCHS = ["qwen2_1_5b", "deepseek_moe_16b"]
POD_STEPS = 2
POD_CASES = [{"name": f"{a}_{m}", "arch": a, "mesh": list(MESHES[m][0]),
              "axes": list(MESHES[m][1]), "steps": POD_STEPS}
             for a in POD_ARCHS for m in ("2x1x2", "2x2x1")]
POD_CASES.append({"name": "qwen2_1_5b_2x2_embed_replicated", "arch": "qwen2_1_5b",
                  "mesh": [2, 2], "axes": list(DM), "steps": POD_STEPS,
                  "embed_vocab_shard": False})
REF_POD = ["qwen2_1_5b_2x1x2"]
SPEC = {"counts": COUNT_CASES, "pod": POD_CASES, "s_max": S_MAX, "decode": DECODE,
        "capacity": {"deepseek_moe_16b": 0.5},
        "ref_count": [c for c in COUNT_CASES if c["name"] in REF_COUNT],
        "ref_pod": [c for c in POD_CASES if c["name"] in REF_POD]}

REF_COUNTS = textwrap.dedent("""
    import json, sys
    import jax
    assert len(jax.devices()) == 4          # before the module below sets XLA_FLAGS
    from repro.launch import dryrun as ref
    from repro.configs import ARCHS, reduced
    from repro.configs.registry import ShapeSpec
    from repro.launch import hlo_cost
    from repro.launch.mesh import make_test_mesh
    from repro.train.step import TrainConfig

    class DotCost(hlo_cost.HloCostModel):
        KEEP = {"dot", "convolution", "while", "fusion", "call", "conditional",
                "custom-call", "async-start"}

        def _instr_cost(self, comp, ins, mult):
            c = super()._instr_cost(comp, ins, mult)
            if ins.opcode not in self.KEEP:
                c.flops = 0.0
            return c

    work = sys.argv[1]
    out = {}
    for case in json.load(open(f"{work}/dryrun_spec.json"))["ref_count"]:
        mesh = make_test_mesh(tuple(case["mesh"]), tuple(case["axes"]))
        with mesh:
            fn, args = ref.build_cell(
                reduced(ARCHS[case["arch"]]),
                ShapeSpec("t", case["kind"], case["seq"], case["batch"]), mesh,
                TrainConfig(tp_act=case.get("tp_act", False)),
                embed_vocab_shard=case.get("embed_vocab_shard", True),
                moe_tp=case.get("moe_tp", False))
            compiled = fn.lower(*args).compile()
        text = compiled.as_text()
        out[case["name"]] = {
            "argument_bytes": int(compiled.memory_analysis().argument_size_in_bytes),
            "dot_flops": DotCost(text).cost().flops,
            "collective_bytes": hlo_cost.analyze_hlo_text(text)["collective_bytes"]}
    json.dump(out, open(f"{work}/ref_counts.json", "w"))
""")

REF_STEPS = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax
    from repro.configs import ARCHS, reduced
    from repro.distributed.checkpoint import _flatten, load_checkpoint
    from repro.launch.mesh import make_test_mesh
    from repro.launch.sharding import (act_constraint, batch_shardings, logit_constraint,
                                       opt_shardings, param_shardings)
    from repro.models.transformer import abstract_params
    from repro.train.optimizer import init_opt_state
    from repro.train.step import TrainConfig, make_train_step
    work = sys.argv[1]
    spec = json.load(open(f"{work}/dryrun_spec.json"))
    out, metrics = {}, {}
    for case in spec["ref_pod"]:
        name, arch = case["name"], case["arch"]
        cfg = reduced(ARCHS[arch])
        if arch in spec["capacity"]:
            cfg = dataclasses.replace(cfg, capacity_factor=spec["capacity"][arch])
        _, st, _ = load_checkpoint(f"{work}/init_{arch}", {"params": abstract_params(cfg)})
        z = np.load(f"{work}/tp_inputs_{arch}.npz")
        train = [{k.split("/")[2]: z[k] for k in z.files if k.startswith(f"train/{i}/")}
                 for i in range(case["steps"])]
        b = train[0]["labels"].shape[0]
        mesh = make_test_mesh(tuple(case["mesh"]), tuple(case["axes"]))
        p_sh, o_sh = param_shardings(cfg, mesh), opt_shardings(cfg, mesh)
        step = make_train_step(cfg, TrainConfig(), act_shard=act_constraint(mesh, b),
                               logit_shard=logit_constraint(mesh, b, cfg.vocab))
        with mesh:
            params = jax.device_put(st["params"], p_sh)
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
    np.savez(f"{work}/ref_pod.npz", **out)
    json.dump(metrics, open(f"{work}/ref_pod.json", "w"))
""")


def pod_cfg(arch):
    return ranks.train_cfg(SPEC, arch)


def meta_counts():
    """Every count case on ``meta`` as rank 0 of a counting world of four."""
    out = {}
    with counting_world(4):
        meshes = {}
        for case in COUNT_CASES:
            key = (tuple(case["mesh"]), tuple(case["axes"]))
            if key not in meshes:
                meshes[key] = make_test_mesh(*key, device="cpu")
            mesh = meshes[key]
            fn, args, kwargs = ranks.count_args(case, mesh)
            out[case["name"]] = count_call(fn, *args, groups=mesh.axis_labels(),
                                           **kwargs).as_dict()
    return json.loads(json.dumps(out))


def one_process(arch, work):
    """The one-process train steps (metrics; parameters and m after each)
    and prefill + greedy decode tokens, on the pod cases' weights."""
    cfg = pod_cfg(arch)
    train, pre, _ = ranks.tp_inputs(work, arch, "cpu")
    model = ranks.load_params(cfg, str(work / f"init_{arch}"))
    with torch.no_grad():
        last, caches = prefill(model, cfg, pre)
        caches = grow_caches(cfg, caches, S_MAX - S)
        toks = [last.argmax(-1).to(torch.int32)]
        for i in range(DECODE):
            last, caches = decode_step(model, cfg, caches, {"token": toks[-1]}, S + i)
            toks.append(last.argmax(-1).to(torch.int32))
    out = {"tokens": [t.tolist() for t in toks], "metrics": [], "steps": {}}
    opt = init_opt_state(model, device="cpu")
    step_fn = make_train_step(cfg, TrainConfig())
    for i, b in enumerate(train[:POD_STEPS]):
        out["metrics"].append({k: float(v) for k, v in step_fn(model, opt, b).items()})
        out["steps"][i + 1] = ({n: p.detach().numpy().copy() for n, p in model.named_parameters()},
                               {n: t.numpy().copy() for n, t in opt["m"].items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun_mesh")
    (work / "dryrun_spec.json").write_text(json.dumps(SPEC))
    for seed, arch in enumerate(POD_ARCHS):
        model = init_params(pod_cfg(arch), 0, device="cpu")
        qk_fan_in_d(pod_cfg(arch), model)
        save_checkpoint(str(work / f"init_{arch}"), 0,
                        {"params": cv.lm_tree_from_params(pod_cfg(arch), model)})
        np.savez(work / f"tp_inputs_{arch}.npz", **make_inputs(arch, seed))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    refs = [subprocess.Popen([sys.executable, "-c", src, str(work)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src in (REF_COUNTS, REF_STEPS)]
    try:
        spawned = mp.spawn(ranks.dryrun_mesh, args=(4, str(work)), nprocs=4, join=False)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            meta = meta_counts()
            one = {a: one_process(a, work) for a in POD_ARCHS}
        finally:
            torch.set_num_threads(threads)
            while not spawned.join():
                pass
    finally:
        errs = [r.communicate(timeout=900)[1] for r in refs]
    for r, err in zip(refs, errs):
        assert r.returncode == 0, err[-3000:]
    real = json.loads((work / "dryrun_real.json").read_text())
    return {"meta": meta, "real": real["counts"], "metrics": real["metrics"],
            "pod": dict(np.load(work / "dryrun_pod.npz")), "one": one,
            "ref": json.loads((work / "ref_counts.json").read_text()),
            "ref_metrics": json.loads((work / "ref_pod.json").read_text()),
            "ref_pod": dict(np.load(work / "ref_pod.npz"))}


# ---------------------------------------------------------------------------
# meta against real
# ---------------------------------------------------------------------------

EXACT = ("flops_by_class", "bytes", "collective_bytes", "collective_bytes_total",
         "collective_bytes_by_axis", "collective_op_executions", "collective_ops",
         "argument_bytes", "output_bytes")


@pytest.mark.parametrize("name", COUNT_NAMES)
def test_meta_count_equals_gloo_count(runs, name):
    """Rank 0 on ``meta`` in a counting world against rank 0 of four gloo
    ranks on CPU tensors: FLOPs by class, the byte floor, the collectives
    (bytes per kind and per axis, executions) and the argument and output
    bytes are equal.  Gloo adds work of its own: its reduce-scatter copies
    rank 0's block out of a whole-size result after the collective (one
    ``copy_`` of the block each: an ATen op, and in the XLA convention the
    block three times, as its destination, its source and its result), and its threads may hold a buffer past the
    collective, so the real temp peak is at least the meta one."""
    meta, real = runs["meta"][name], runs["real"][name]
    for k in EXACT:
        assert real[k] == meta[k], k
    case = next(c for c in COUNT_CASES if c["name"] == name)
    size = dict(zip(case["axes"], case["mesh"]))
    rs_blocks = sum(kinds["reduce-scatter"] / np.prod([size[a] for a in label.split("+")])
                    for label, kinds in meta["collective_bytes_by_axis"].items())
    assert real["aten_ops"] - meta["aten_ops"] == meta["collective_ops"]["reduce-scatter"]
    assert real["bytes_xla_convention"] - meta["bytes_xla_convention"] == 3 * rs_blocks
    assert real["temp_peak_bytes"] >= meta["temp_peak_bytes"]


def test_count_cases_reach_every_collective_and_axis(runs):
    """The cases issue all-reduces, all-gathers and reduce-scatters, over
    data, model and pod and over the "pod+data" group.  The pod axis
    carries only all-reduces (the gradient and loss sums) but in a config
    with routed experts, whose dense MoE (decode's, and train and prefill's
    without ``moe_tp``) gathers the batch's tokens over the axes that cut
    its rows (``tp.whole_batch_moe``)."""
    meta = runs["meta"]
    kinds = {k for c in meta.values() for k, v in c["collective_bytes"].items() if v}
    assert kinds == {"all-reduce", "all-gather", "reduce-scatter"}
    labels = {a for c in meta.values() for a in c["collective_bytes_by_axis"]}
    assert labels == {"data", "model", "pod", "pod+data"}
    moe = {c["name"] for c in COUNT_CASES if c["arch"] == "deepseek_moe_16b"}
    for name, c in meta.items():
        pod = c["collective_bytes_by_axis"].get("pod")
        if pod and name not in moe:
            assert {k for k, v in pod.items() if v} == {"all-reduce"}, name


# ---------------------------------------------------------------------------
# against the reference's compiled cells
# ---------------------------------------------------------------------------

# bytes that only the reference passes: decode's int32 position argument
REF_ONLY_ARGS = {"decode": {"pos": 4}}
# port / reference product FLOPs where they differ (pinned to 1e-6).  The
# dense MoE keeps its whole-batch routing on a mesh (``tp.whole_batch_moe``):
# each data rank gathers the whole batch's tokens and runs the router and
# its experts' products on all of them, where the reference's GSPMD splits
# the capacity slots over ``data``; on (2, 2) the routed products are
# counted twice.  With ``moe_tp`` (capacity per data shard) there is no gap.
DOT_RATIO = {"deepseek_moe_16b_train_2x2": 54394880 / 38371328,
             "deepseek_moe_16b_prefill_2x2": 13910016 / 9912320,
             "deepseek_moe_16b_decode_2x2": 450560 / 324608}
# port / reference collective bytes (totals), pinned to 1e-6; side by side
# per kind in PERF.md (``python tests/test_torch_dryrun_mesh.py``)
COLL_RATIO = {"qwen2_1_5b_train_2x2": 988472 / 1299880,
              "qwen2_1_5b_prefill_2x2": 425984 / 584720,
              "qwen2_1_5b_decode_2x2": 255232 / 130844,
              "deepseek_moe_16b_train_2x2": 2067960 / 3549960,
              "deepseek_moe_16b_prefill_2x2": 915456 / 1473296,
              "deepseek_moe_16b_decode_2x2": 437120 / 131100,
              "qwen2_1_5b_train_2x1x2": 726208 / 955496,
              "qwen2_1_5b_tp_act_train_2x2": 1103160 / 1629120,
              "qwen2_1_5b_embed_replicated_train_2x2": 1070384 / 1332648}


@pytest.mark.parametrize("name", REF_COUNT)
def test_arguments_and_products_against_reference(runs, name):
    """Per-device argument bytes equal the reference's compiled
    ``memory_analysis`` but for REF_ONLY_ARGS; product FLOPs equal its
    partitioned HLO's but for DOT_RATIO."""
    port, ref = runs["meta"][name], runs["ref"][name]
    kind = next(c["kind"] for c in COUNT_CASES if c["name"] == name)
    only = sum(REF_ONLY_ARGS.get(kind, {}).values())
    assert port["argument_bytes"] + only == ref["argument_bytes"]
    dots = port["flops_by_class"]["dot_bf16"] + port["flops_by_class"]["dot_f32"]
    assert dots / ref["dot_flops"] == pytest.approx(DOT_RATIO.get(name, 1.0), rel=1e-6)


@pytest.mark.parametrize("name", REF_COUNT)
def test_collective_bytes_against_reference(runs, name):
    """The ratio of the collective bytes to the reference's (its HLO's
    ring accounting): the two programs issue other collectives (GSPMD
    picks all-to-alls and permutes where the port all-gathers or
    reduce-scatters), so the ratio is pinned, not held to 1."""
    port = runs["meta"][name]["collective_bytes_total"]
    ref = sum(runs["ref"][name]["collective_bytes"].values())
    assert port / ref == pytest.approx(COLL_RATIO[name], rel=1e-6)


# ---------------------------------------------------------------------------
# the pod axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c["name"] for c in POD_CASES])
def test_pod_train_steps_match_one_process(runs, name):
    """Two steps on (2, 1, 2) and (2, 2, 1) (and on (2, 2) with a
    vocab-replicated embedding): the metrics of each, and the parameters
    and m after the first, against the one-process step
    (tests/test_torch_tp.py's bounds)."""
    arch = next(c["arch"] for c in POD_CASES if c["name"] == name)
    got, want = runs["metrics"][name], runs["one"][arch]
    for g, w in zip(got, want["metrics"]):
        for k in ("loss", "nll", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(g["aux"], w["aux"], rtol=LOSS_RTOL, atol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=GRAD_RTOL)
    params, m = want["steps"][1]
    assert_leaves(of(runs["pod"], f"{name}/step1/m/"), m, 2 * GRAD_RTOL)
    assert_params(of(runs["pod"], f"{name}/step1/params/"), params, want["metrics"][:1])


@pytest.mark.parametrize("name", [c["name"] for c in POD_CASES])
def test_pod_prefill_and_greedy_decode_tokens(runs, name):
    """Prefill and three greedy decode steps on the pod mesh give the
    one-process tokens."""
    arch = next(c["arch"] for c in POD_CASES if c["name"] == name)
    assert runs["pod"][f"{name}/tokens"].tolist() == runs["one"][arch]["tokens"]


@pytest.mark.parametrize("name", REF_POD)
def test_pod_train_steps_match_reference(runs, name):
    """The (2, 1, 2) steps against the reference's step jitted with
    ``param_shardings`` / ``opt_shardings`` / ``batch_shardings`` on that
    mesh: metrics, m (REF_M_RTOL) and the parameters after both steps."""
    arch = next(c["arch"] for c in POD_CASES if c["name"] == name)
    cfg = pod_cfg(arch)
    got, want = runs["metrics"][name], runs["ref_metrics"][name]
    assert len(got) == len(want) == POD_STEPS
    for g, w in zip(got, want):
        for k in ("loss", "nll", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=GRAD_RTOL)
    ref = runs["ref_pod"]
    assert_leaves(of(runs["pod"], f"{name}/step{POD_STEPS}/m/"), named(cfg, ref, f"{name}/m/"),
                  REF_M_RTOL)
    assert_params(of(runs["pod"], f"{name}/step{POD_STEPS}/params/"),
                  named(cfg, ref, f"{name}/params/"), want)


# ---------------------------------------------------------------------------
# the counting world, the links and the collectives' rules
# ---------------------------------------------------------------------------

def test_axis_links_follow_the_node_layout():
    """Ranks row-major over the mesh, 8 a node: on (16, 16) and (2, 16,
    16) every axis spans nodes; on (1, 4) and (2, 2) every group lies in
    one node; on (2, 8) the model axis does and data does not."""
    net, nv = cost_analysis.NETWORK_BYTES_PER_S, cost_analysis.NVLINK_BYTES_PER_S
    links = cost_analysis.axis_links({"pod": 2, "data": 16, "model": 16},
                                     ["pod", "data", "model", "pod+data"])
    assert {a: (l["ranks"], l["bytes_per_s"]) for a, l in links.items()} == {
        "pod": (2, net), "data": (16, net), "model": (16, net), "pod+data": (32, net)}
    assert {a: l["link"] for a, l in cost_analysis.axis_links(
        {"data": 2, "model": 2}, ["data", "model"]).items()} == {"data": "nvlink",
                                                                 "model": "nvlink"}
    links = cost_analysis.axis_links({"data": 2, "model": 8}, ["data", "model"])
    assert (links["data"]["bytes_per_s"], links["model"]["bytes_per_s"]) == (net, nv)
    t = cost_analysis.RooflineTerms(0.0, 0.0, 3e9, coll_bytes_by_axis={"data": 1e9,
                                                                       "model": 2e9},
                                    axis_bytes_per_s={"data": net, "model": nv})
    assert t.t_collective == pytest.approx(1e9 / net + 2e9 / nv)


def test_collectives_are_counted_by_the_ring_rule():
    """On meta in a counting world of 8 over (2, 4): an all-reduce is
    charged twice its operand, an all-gather its result, a reduce-scatter
    its operand, each keyed by its group's axes and charged operand plus
    result in the byte floor (no argument: nothing else is charged); a
    collective of another kind raises."""
    from repro_torch.distributed import comm
    with counting_world(8):
        mesh = make_test_mesh((2, 4), device="cpu")
        x = torch.empty(6, 16, device="meta")
        mode = OpCostMode((), mesh.axis_labels())
        with mode:
            comm.reduce_sum(x, mesh.group("model"))
            comm.all_gather(x, 0, mesh.group("data"))
            comm.reduce_scatter(torch.empty(8, 16, device="meta"), 0, mesh.group("model"))
        c = mode.counts
        n = 6 * 16 * 4
        assert c.collective_bytes == {"all-reduce": 2 * n, "all-gather": 2 * n,
                                      "reduce-scatter": 8 * 16 * 4, "all-to-all": 0,
                                      "collective-permute": 0}
        assert c.collective_bytes_by_axis["data"]["all-gather"] == 2 * n
        assert c.collective_bytes_by_axis["model"]["all-reduce"] == 2 * n
        assert c.collective_op_executions == 3
        assert c.bytes == 2 * n + 3 * n + (8 * 16 * 4 + 2 * 16 * 4)
        with pytest.raises(NotImplementedError), OpCostMode():
            dist.broadcast(x, src=0, group=mesh.group("model"))


def test_a_mesh_cell_needs_a_process_of_its_own():
    """``run_cell`` on a mesh raises where this process has a group (a
    counting world is never quietly replaced by one card)."""
    init_world("cpu")
    try:
        with pytest.raises(RuntimeError, match="already has a process group"):
            dryrun.run_cell("qwen2_1_5b", "decode_32k", smoke=True, mesh="single")
    finally:
        close_world()


def test_one_card_rejects_the_mesh_variants():
    with pytest.raises(ValueError, match="count them on a mesh"):
        dryrun.run_cell("deepseek_moe_16b", "decode_32k", smoke=True, moe_tp=True)


if __name__ == "__main__":      # the reference-against-port table in PERF.md
    import tempfile
    from pathlib import Path
    work = Path(tempfile.mkdtemp())
    (work / "dryrun_spec.json").write_text(json.dumps(SPEC))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", REF_COUNTS, str(work)], env=env, check=True)
    ref = json.loads((work / "ref_counts.json").read_text())
    meta = meta_counts()
    print("| cell | " + " | ".join(COLLECTIVES[:4]) + " | total | ratio |")
    print("| --- " * 7 + "|")
    for name in REF_COUNT:
        p, r = meta[name]["collective_bytes"], ref[name]["collective_bytes"]
        cols = [f"{int(p[k]):,} / {int(r[k]):,}" for k in COLLECTIVES]
        tp, tr = sum(p.values()), sum(r.values())
        print(f"| {name} | " + " | ".join(cols[:4]) + f" | {int(tp):,} / {int(tr):,} | "
              f"{tp / tr:.4f} |" + (f" permute {int(r['collective-permute']):,}"
                                    if r["collective-permute"] else ""))
