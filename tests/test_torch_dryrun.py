"""The port's dry run (``repro_torch.launch.{op_cost,cost_analysis,dryrun}``)
against the JAX package's (``repro.launch.{hlo_cost,dryrun}``), on the CPU.

The reference's FLOPs come from its *lowered* HLO
(``jax.jit(f).lower(...).as_text(dialect="hlo")``), never compiled: the
compiled text of the ``flash_cv`` train step merges some products.  Its
dot-only count is ``hlo_cost.HloCostModel`` with every instruction's FLOPs
zeroed except the products' and the computations that call others.  Each
configuration's lowering is made once and shared across the file.
"""
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.configs import registry as ref_registry
from repro.launch import hlo_cost
from repro.models import transformer as ref_tf
from repro.serving import decode as ref_decode
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step

from benchmarks.roofline import load_cells, rows_for
from repro_torch import configs
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import cost_analysis, dryrun, op_cost
from repro_torch.models.config import BLOCK_SLSTM
from repro_torch.train.step import TrainConfig

ALL_ARCHS = sorted(ref_configs.ARCHS)
KINDS = ("prefill", "decode", "train")
B, S = 2, 32
# flash_cv at several [8, 8] tiles a sequence
FLASH_CV = dict(flash_cv=True, q_chunk=8, kv_chunk=8)


def _ref_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS to a 512-device host platform
    when imported; restore the variable so that this process and its
    children keep theirs."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


class DotCost(hlo_cost.HloCostModel):
    """The reference's cost model with FLOPs on products only (and on the
    instructions that carry a called computation's cost up)."""
    KEEP = {"dot", "convolution", "while", "fusion", "call", "conditional",
            "custom-call", "async-start"}

    def _instr_cost(self, comp, ins, mult):
        c = super()._instr_cost(comp, ins, mult)
        if ins.opcode not in self.KEEP:
            c.flops = 0.0
        return c


@functools.lru_cache(maxsize=None)
def ref_dot_flops(aid: str, kind: str, flash_cv: bool) -> float:
    rcfg = ref_configs.reduced(ref_configs.ARCHS[aid])
    tcfg = ref_step.TrainConfig(**(FLASH_CV if flash_cv else {}))
    params = ref_tf.abstract_params(rcfg)
    batch = ref_registry.input_specs(rcfg, ref_registry.ShapeSpec("t", kind, S, B))
    if kind == "train":
        fn = ref_step.make_train_step(rcfg, tcfg)
        args = (params, ref_opt.abstract_opt_state(params), batch)
    elif kind == "prefill":
        fn = lambda p, b: ref_decode.prefill(p, rcfg, b, q_chunk=tcfg.q_chunk)
        args = (params, batch)
    else:
        fn = lambda p, c, b, pos: ref_decode.decode_step(p, rcfg, c, b, pos)
        args = (params, ref_decode.abstract_caches(rcfg, B, S), batch,
                jax.ShapeDtypeStruct((), jnp.int32))
    text = jax.jit(fn).lower(*args).as_text(dialect="hlo")
    return DotCost(text).cost().flops


@functools.lru_cache(maxsize=None)
def port_counts(aid: str, kind: str, flash_cv: bool) -> op_cost.Counts:
    cfg = configs.reduced(configs.ARCHS[aid])
    tcfg = TrainConfig(**(FLASH_CV if flash_cv else {}))
    fn, args, kwargs = dryrun.build_call(cfg, ShapeSpec("t", kind, S, B), tcfg)
    return op_cost.count_call(fn, *args, **kwargs)


# ---------------------------------------------------------------------------
# (a) model_flops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aid,shape", ref_registry.applicable_cells())
def test_model_flops_equal_reference(aid, shape):
    ref = _ref_dryrun()
    assert configs.applicable_cells() == ref_registry.applicable_cells()
    sh = configs.SHAPES[shape]
    want = ref.model_flops(ref_configs.ARCHS[aid], sh.kind, sh.batch, sh.seq)
    assert dryrun.model_flops(configs.ARCHS[aid], sh.kind, sh.batch, sh.seq) == want


def test_thirty_two_applicable_cells():
    assert len(configs.applicable_cells()) == 32


# ---------------------------------------------------------------------------
# (b) dot FLOPs against the reference's lowered HLO
# ---------------------------------------------------------------------------

def slstm_initial_carry_flops(cfg) -> int:
    """The reference's scan transposes its sLSTM body uniformly, so its
    backward also takes the recurrent product's gradient with respect to
    the initial hidden state h_0, a zero constant: one [B,H,hd] x
    [H,hd,4hd] product per sLSTM layer that nothing reads.  The port's
    autograd skips it (h_0 does not require grad)."""
    hd = cfg.d_model // cfg.n_heads
    n_slstm = sum(cfg.block_kind(i) == BLOCK_SLSTM for i in range(cfg.n_layers))
    return n_slstm * 2 * B * cfg.n_heads * hd * 4 * hd


CASES = [(a, k, False) for a in ALL_ARCHS for k in KINDS] + [("qwen2_1_5b", "train", True)]


@pytest.mark.parametrize("aid,kind,flash_cv", CASES)
def test_dot_flops_equal_reference(aid, kind, flash_cv):
    cfg = configs.reduced(configs.ARCHS[aid])
    c = port_counts(aid, kind, flash_cv)
    got = c.flops_by_class["dot_bf16"] + c.flops_by_class["dot_f32"]
    want = ref_dot_flops(aid, kind, flash_cv)
    if kind == "train":
        # exact, but for the reference's unread product (xLSTM only)
        want -= slstm_initial_carry_flops(cfg)
    assert got == want
    assert c.flops_by_class["dot_f32"] == got       # the reduced configs are float32


def test_the_xlstm_gap_is_the_initial_carry():
    cfg = configs.reduced(configs.ARCHS["xlstm_125m"])
    gap = slstm_initial_carry_flops(cfg)
    assert gap == 2 * 2 * B * 4 * 16 * 64           # two sLSTM layers
    got = port_counts("xlstm_125m", "train", False).flops_by_class["dot_f32"]
    assert ref_dot_flops("xlstm_125m", "train", False) - got == gap


# ---------------------------------------------------------------------------
# (c) the period extrapolation against a whole-depth count
# ---------------------------------------------------------------------------

def deeper(cfg, periods: int = 4):
    """The reduced config with ``periods`` body periods (and its tail)."""
    import dataclasses
    from repro_torch.models.transformer import stack_segments
    head, body, tail = stack_segments(cfg)
    return dataclasses.replace(
        cfg, n_layers=len(head) + periods * len(body[0]) + len(tail))


STREAMS = ("flops_by_class", "bytes", "bytes_xla_convention", "aten_ops",
           "argument_bytes", "output_bytes", "temp_peak_bytes")


@pytest.mark.parametrize("aid", ALL_ARCHS)
def test_stack_extrapolation_equals_whole_depth(aid):
    cfg = deeper(configs.reduced(configs.ARCHS[aid]))
    for kind in KINDS:
        s = 4 if aid == "xlstm_125m" else 16
        build = lambda c: dryrun.build_call(c, ShapeSpec("t", kind, s, B), TrainConfig())
        got, depth = op_cost.analyze_stack(cfg, build)
        assert depth["periods"] == 4 and not depth["temp_peak_exact"]
        fn, args, kwargs = build(cfg)
        want = op_cost.count_call(fn, *args, **kwargs)
        for f in STREAMS:
            assert getattr(got, f) == getattr(want, f), (kind, f)
        assert got.contributors == {k: v for k, v in want.contributors.items() if v}


def test_three_periods_are_counted_whole():
    cfg = deeper(configs.reduced(configs.ARCHS["qwen2_1_5b"]), 3)
    build = lambda c: dryrun.build_call(c, ShapeSpec("t", "prefill", 16, B), TrainConfig())
    got, depth = op_cost.analyze_stack(cfg, build)
    assert depth == {"periods": 3, "layers_counted": cfg.n_layers, "temp_peak_exact": True}
    fn, args, kwargs = build(cfg)
    assert got.as_dict() == op_cost.count_call(fn, *args, **kwargs).as_dict()


# ---------------------------------------------------------------------------
# (d) OpCostMode on known programs
# ---------------------------------------------------------------------------

def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_and_bytes_exact():
    a, b = meta(256, 512, dtype=torch.bfloat16), meta(512, 1024, dtype=torch.bfloat16)
    r = op_cost.analyze_call(lambda a, b: a @ b, a, b)
    assert r["flops"] == r["flops_by_class"]["dot_bf16"] == 2 * 256 * 512 * 1024
    assert r["bytes"] == 2 * (256 * 512 + 512 * 1024 + 256 * 1024)
    assert r["argument_bytes"] == 2 * (256 * 512 + 512 * 1024)
    assert r["output_bytes"] == r["temp_peak_bytes"] == 2 * 256 * 1024
    assert r["collective_bytes_total"] == 0 and r["collective_op_executions"] == 0


def test_batched_einsum_is_a_float32_product():
    x, y = meta(4, 8, 16, 32), meta(4, 32, 64)
    r = op_cost.analyze_call(lambda x, y: torch.einsum("bhsd,bde->bhse", x, y), x, y)
    assert r["flops_by_class"] == {"dot_bf16": 0, "dot_f32": 2 * 4 * 8 * 16 * 32 * 64,
                                   "other": 0}
    assert r["bytes"] == 4 * (4 * 8 * 16 * 32 + 4 * 32 * 64 + 4 * 8 * 16 * 64)


def test_gather_charges_the_rows_read():
    table, idx = meta(1000, 64), torch.empty(7, dtype=torch.long, device="meta")
    r = op_cost.analyze_call(lambda t, i: t[i] * 2.0, table, idx)
    rows = 7 * 64 * 4
    # the rows and the indices in; the product out; the gathered rows free
    assert r["bytes"] == rows + 7 * 8 + rows
    assert r["flops_by_class"]["other"] == 7 * 64
    assert r["bytes_xla_convention"] == (1000 * 64 * 4 + 7 * 8 + rows) + 2 * rows


def test_in_place_cache_write_charges_the_update():
    cache, new = meta(2, 4096, 4, 32, dtype=torch.bfloat16), meta(2, 4, 32)

    def write(c, n):
        c[:, 17] = n.to(c.dtype)
        return c

    r = op_cost.analyze_call(write, cache, new)
    # the float32 update read, its bf16 slice written; the cache is not
    # read, and returning it charges nothing more
    assert r["bytes"] == 2 * 4 * 32 * 4 + 2 * 4 * 32 * 2
    assert r["output_bytes"] == 2 * 4096 * 4 * 32 * 2


def test_argument_changed_in_place_is_an_output_once():
    m, g = meta(1024), meta(1024)

    def step(m, g):
        m.mul_(0.9).add_(0.1 * g)
        m.mul_(2.0)

    r = op_cost.analyze_call(step, m, g)
    # m read by each of three ops, g by one, m written once at the end
    assert r["bytes"] == 4 * 1024 * (3 + 1 + 1)
    assert r["output_bytes"] == 4 * 1024
    assert r["aten_ops"] == 4


def test_temp_peak_sees_saved_tensors_and_frees():
    x = meta(1024, 1024)

    def chain(x):
        y = (x * 2.0).exp()
        del_me = y * 3.0
        return del_me.sum()

    r = op_cost.analyze_call(chain, x)
    # x*2, its exp and the product are alive at once at most pairwise
    assert r["temp_peak_bytes"] == 2 * 4 * 1024 * 1024 + 4
    w = meta(1024, 1024).requires_grad_(True)

    def fwd_bwd(w):
        (w * 2.0).exp().sum().backward()

    r = op_cost.analyze_call(fwd_bwd, w)
    assert r["temp_peak_bytes"] >= 2 * 4 * 1024 * 1024


def test_roofline_terms_split_by_class():
    t = cost_analysis.RooflineTerms(
        device_flops=3e12, device_bytes=3.35e9, device_coll_bytes=0.0,
        flops_by_class={"dot_bf16": 989e9, "dot_f32": 67e9, "other": 1944e9})
    assert t.t_compute == pytest.approx(1e-3 + 1e-3 + 1944e9 / 67e12)
    assert t.t_memory == pytest.approx(1e-3)
    assert t.t_collective == 0.0 and t.dominant == "compute"
    assert set(t.as_dict()) == {"device_flops", "device_bytes", "device_coll_bytes",
                                "t_compute_s", "t_memory_s", "t_collective_s",
                                "t_bound_s", "dominant"}


# ---------------------------------------------------------------------------
# (e) records through benchmarks/roofline.py
# ---------------------------------------------------------------------------

CARD_KEYS = {"arch", "shape", "mesh", "kind", "batch", "seq", "status", "n_chips", "count_s",
             "depth", "info", "roofline", "model_flops_total", "hlo_flops_total",
             "useful_flops_ratio", "n_params", "n_active_params", "fits", "top_contributors"}
CARD_INFO = {"flops", "flops_by_class", "bytes_accessed", "bytes_xla_convention",
             "collective_bytes", "collective_op_executions", "collective_ops", "aten_ops",
             "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"}


def test_run_cell_record_goes_through_rows_for():
    """The one-card record: its keys (no mesh keys), no collective."""
    rec = dryrun.run_cell("qwen2_1_5b", ShapeSpec("t", "train", S, B), smoke=True)
    assert rec["status"] == "ok" and rec["mesh"] == "1xH100" and rec["n_chips"] == 1
    assert set(rec) == CARD_KEYS and set(rec["info"]) == CARD_INFO
    assert rec["roofline"]["t_collective_s"] == 0.0
    assert rec["info"]["collective_bytes"]["total"] == 0.0
    assert rec["hlo_flops_total"] == rec["info"]["flops"] == rec["roofline"]["device_flops"]
    assert rec["useful_flops_ratio"] == rec["model_flops_total"] / rec["hlo_flops_total"]
    assert rec["fits"] is True and rec["count_s"] >= 0
    assert rec["top_contributors"]
    json.dumps(rec)
    (row,) = rows_for([rec])
    assert row[:4] == ["qwen2_1_5b", "t", "1xH100", rec["roofline"]["dominant"]]


@pytest.mark.parametrize("mesh,n", [("single", 256), ("multi", 512)])
def test_mesh_record_goes_through_rows_for(mesh, n):
    """Rank 0's share of the reduced qwen2 train step on the production
    mesh (16, 16) or (2, 16, 16), counted in a counting world made in this
    process: the mesh keys, the collective term over the network (every
    axis spans nodes), all-reduces only over ``pod``, and the totals as
    the reference's (rank 0's FLOPs times the ranks)."""
    rec = dryrun.run_cell("qwen2_1_5b", "train_4k", smoke=True, mesh=mesh)
    name = {"single": "16x16", "multi": "2x16x16"}[mesh]
    assert rec["status"] == "ok" and rec["mesh"] == name and rec["n_chips"] == n
    assert set(rec) == CARD_KEYS | {"rank"} and rec["rank"] == 0
    info, r = rec["info"], rec["roofline"]
    assert set(info) == CARD_INFO | {"collective_bytes_by_axis", "interconnect"}
    axes = info["interconnect"]["axes"]
    assert {l["link"] for l in axes.values()} == {"network"}
    assert r["t_collective_s"] == pytest.approx(sum(
        sum(kinds.values()) / axes[a]["bytes_per_s"]
        for a, kinds in info["collective_bytes_by_axis"].items()), rel=1e-12)
    assert r["t_collective_s"] > 0
    assert info["collective_bytes"]["total"] == sum(
        v for kinds in info["collective_bytes_by_axis"].values() for v in kinds.values())
    if mesh == "multi":
        pod = info["collective_bytes_by_axis"]["pod"]
        assert {k for k, v in pod.items() if v} == {"all-reduce"}
    assert rec["hlo_flops_total"] == info["flops"] * n
    assert rec["useful_flops_ratio"] == rec["model_flops_total"] / rec["hlo_flops_total"]
    json.dumps(rec)
    (row,) = rows_for([rec])
    assert row[:4] == ["qwen2_1_5b", "train_4k", name, r["dominant"]]


def test_cli_writes_resumable_records(tmp_path, capsys):
    argv = ["--smoke", "--arch", "qwen2-1.5b,xlstm-125m",
            "--shape", "decode_32k,long_500k", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == [f"{a}__{s}__card__baseline.json"
                     for a in ("qwen2_1_5b", "xlstm_125m") for s in ("decode_32k", "long_500k")]
    cells = load_cells(str(tmp_path))
    status = {(c["arch"], c["shape"]): c["status"] for c in cells}
    assert status[("qwen2_1_5b", "long_500k")] == "skipped"
    assert all(v == "ok" for k, v in status.items() if k != ("qwen2_1_5b", "long_500k"))
    rows = rows_for(cells)
    assert [r[3] for r in rows].count("SKIP") == 1
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    assert capsys.readouterr().out.count("[skip existing]") == 4


def test_cli_jobs_write_the_same_records(tmp_path):
    """Two cells are counted in two spawned workers: the records
    ``run_cell`` gives in this process."""
    archs = ("granite_3_2b", "musicgen_medium")
    assert dryrun.main(["--smoke", "--arch", ",".join(archs), "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    drop = lambda c: {k: v for k, v in json.loads(json.dumps(c)).items() if k != "count_s"}
    want = [drop(dryrun.run_cell(a, "decode_32k", smoke=True)) for a in archs]
    assert [drop(c) for c in load_cells(str(tmp_path))] == want


# ---------------------------------------------------------------------------
# (f) the meshes and the reference's mesh flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--moe-tp"], ["--tp-act"], ["--embed-replicated"],
                                   ["--mesh", "card", "--tp-act"]])
def test_cli_rejects_mesh_flags(flags, tmp_path):
    """The variants shard the program: one card (the default) rejects them."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(flags + ["--out", str(tmp_path)])
    assert e.value.code == 2
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags", [["--mesh", "single", "--tp-act"],
                                   ["--mesh", "multi", "--embed-replicated"],
                                   ["--mesh", "single", "--moe-tp"]])
def test_cli_accepts_mesh_flags(flags, tmp_path):
    """On a mesh each variant counts (in a spawned worker; ``--moe-tp``
    leaves a config without routed experts as it is: the reduced MoE
    configs' four experts do not divide a model axis of 16)."""
    argv = ["--smoke", "--arch", "qwen2-1.5b", "--shape", "decode_32k", "--out", str(tmp_path)]
    assert dryrun.main(argv + flags) == 0
    (cell,) = load_cells(str(tmp_path))
    assert cell["status"] == "ok" and cell["n_chips"] == (512 if "multi" in flags else 256)


def test_cli_mesh_both_writes_resumable_records(tmp_path, capsys):
    """``--mesh both`` writes the single and the multi record of each cell
    (a skipped cell's too), and a rerun skips them.  A one-card record
    under a mesh's file name is counted again, not kept."""
    argv = ["--smoke", "--arch", "qwen2-1.5b", "--shape", "decode_32k,long_500k",
            "--mesh", "both", "--out", str(tmp_path)]
    card = dryrun.run_cell("qwen2_1_5b", "decode_32k", smoke=True)
    (tmp_path / "qwen2_1_5b__decode_32k__single__baseline.json").write_text(json.dumps(card))
    assert dryrun.main(argv) == 0
    assert sorted(os.listdir(tmp_path)) == [f"qwen2_1_5b__{s}__{m}__baseline.json"
                                            for s in ("decode_32k", "long_500k")
                                            for m in ("multi", "single")]
    status = {(c["shape"], c["mesh"]): c["status"] for c in load_cells(str(tmp_path))}
    assert status == {("decode_32k", "16x16"): "ok", ("decode_32k", "2x16x16"): "ok",
                      ("long_500k", "16x16"): "skipped", ("long_500k", "2x16x16"): "skipped"}
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    assert capsys.readouterr().out.count("[skip existing]") == 4


def test_memo_keys_scalars_by_type():
    """``x ** 2`` and ``x ** 2.0`` share an equal key if a scalar is keyed
    by value alone, and the float result would get the int64 layout."""
    def powers(x):
        return x ** 2, x ** 2.0, x + 1, x + 1.0, x.clamp(min=0), x.clamp(min=0.0)

    x = meta(64, 32, dtype=torch.int64)
    mode = op_cost.OpCostMode((x,))
    with mode:
        outs = powers(x)
    assert [o.dtype for o in outs] == [torch.int64, torch.float32] * 3
    got = mode.finish(outs)
    real = op_cost.count_call(powers, torch.zeros(64, 32, dtype=torch.int64))
    for f in STREAMS:
        assert getattr(got, f) == getattr(real, f), f


def test_one_card_decode_step_op_count():
    """On one card the decode step's positions come from ``arange`` with no
    offset added: no ``aten.add`` takes an ``arange``'s output, and each
    full-attention layer of reduced qwen2 adds 11 ``aten.add.Tensor``
    (the difference between two and three layers, which holds across
    torch versions where the totals need not)."""
    import dataclasses
    from repro_torch.models.transformer import abstract_params
    from repro_torch.serving.decode import abstract_caches, decode_step

    class PerOp(op_cost.OpCostMode):
        def __init__(self, args):
            super().__init__(args)
            self.adds, self.ranges, self.offset = 0, [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if func.overloadpacket is torch.ops.aten.add:
                self.adds += func is torch.ops.aten.add.Tensor
                self.offset += any(a is r for a in args for r in self.ranges)
            elif func.overloadpacket is torch.ops.aten.arange:
                self.ranges.append(out)
            return out

    def count(n_layers):
        cfg = dataclasses.replace(configs.reduced(configs.ARCHS["qwen2_1_5b"]),
                                  n_layers=n_layers)
        params, caches = abstract_params(cfg), abstract_caches(cfg, B, S)
        inputs = {"token": meta(B, dtype=torch.int32)}
        mode = PerOp((params, caches, inputs))
        with mode:
            decode_step(params, cfg, caches, inputs, S - 1)
        assert mode.ranges and mode.offset == 0
        return mode.adds

    assert count(3) - count(2) == 11


@pytest.mark.parametrize("aid,kind", [("xlstm_125m", "prefill"), ("qwen2_1_5b", "train"),
                                      ("deepseek_moe_16b", "decode")])
def test_meta_count_equals_a_count_on_real_tensors(aid, kind):
    """On meta tensors a repeated functional op gets fresh outputs of the
    remembered layout without running; on CPU tensors every op runs.  The
    streams agree."""
    from repro_torch.configs.registry import concrete_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.decode import init_caches
    from repro_torch.train.optimizer import init_opt_state
    cfg = configs.reduced(configs.ARCHS[aid])
    spec = ShapeSpec("t", kind, 8, B)
    fn, args, kwargs = dryrun.build_call(cfg, spec, TrainConfig())
    want = op_cost.count_call(fn, *args, **kwargs)
    model = init_params(cfg, 0, device="cpu")
    batch = {k: v if k != "token" else v.clamp(0, cfg.vocab - 1)
             for k, v in concrete_batch(cfg, spec, 1, device="cpu").items()}
    real = {"train": (model, init_opt_state(model, device="cpu"), batch),
            "prefill": (model, batch),
            "decode": (model, init_caches(cfg, B, 8, device="cpu"), batch)}[kind]
    got = op_cost.count_call(fn, *real)
    for f in STREAMS:
        assert getattr(got, f) == getattr(want, f), f
