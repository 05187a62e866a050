"""Whole runs: the command refuses to run without a card, the control
and every fault a cell can have come out not correct, and a clean run
comes out correct.  The faults and clean runs drive ``run_cell`` on the
CPU at small sizes (the plain versions of the kernels), skipping only
the command's look for a card."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from graphbench import bench, check, run

from .conftest import ROOT

CPU = torch.device("cpu")


def command(args, cwd, env=None):
    return subprocess.run([sys.executable, "graphbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and lines[-1].startswith("{"))


def test_no_card_no_result():
    proc = command(["--workload", "subgen-400k-k4.batch32", "--seed", "2147483659",
                    "--seconds", "1", "--trace", "0"], ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert no_result(proc), proc.stdout[-500:]
    assert "CUDA device" in proc.stderr


def test_paths_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and graphbench/ (no program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "graphbench", tmp_path / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {"PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}
    proc = command(["--workload", "imdb-74k-k4.batch32", "--seed", "5", "--seconds", "1",
                    "--trace", "0"], tmp_path, env)
    assert no_result(proc)


CELLS = ["subgen-400k-k4.batch32", "imdb-74k-k4.batch32"]
OPEN_LOOP = {"arrivals": "poisson", "rate_qps": 12.0, "budget_share": 0.25, "budget": 5,
             "replay_speed": 1.0}


def run_small(small_config, cell, seed=2**31 + 11, seconds=0.5, trace=False, mix=None):
    b = bench.load_benchmark()
    w = bench.find_cell(b, cell)
    return run.run_cell(small_config(w["config"]), mix or bench.load_traffic(w["traffic"]),
                        seed, seconds, trace, CPU, b, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small_config, cell):
    """The control on three seeds at a test's size; on the chip it runs at
    the cell's own size (``run.py --control 1``)."""
    b = bench.load_benchmark()
    w = bench.find_cell(b, cell)
    cfg, mix = small_config(w["config"]), bench.load_traffic(w["traffic"])
    for seed in (1, 2**32 + 3, 77):
        res = run.control(cfg, mix, seed, 30.0, 3)
        assert res["correct"] is False and res["checks"]["wrong_answer_sets"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_clean_runs_are_correct(small_config, capsys, cell):
    res = run_small(small_config, cell, trace=True)
    assert res["correct"] and res["attempted"] % 32 == 0, res["checks"]
    # on the CPU only the host's per-layer metrics can be read
    assert set(res["metrics"]) == {"loads_per_query.batch", "round_ms.batch"}
    assert list(res)[-1] == "checks"
    res = run_small(small_config, cell)
    assert res["correct"] and {"queries_per_s", "setup_s", "peak_device_gib"} == set(res["metrics"])
    assert capsys.readouterr().out.startswith("setup {")


def test_open_loop_mix_is_correct(small_config):
    """The open-loop generator's path (no cell uses it yet): requests due
    over the window through the front end at replay speed 1."""
    res = run_small(small_config, "imdb-74k-k4.batch32", seconds=2.0, mix=OPEN_LOOP)
    assert res["correct"] and res["attempted"] == 24


def test_late_forbidden_load_gives_no_result(small_config, monkeypatch, capsys):
    """A metric reader that loads JAX after the window (as an importlib or
    a transitive import could) leaves the run with no result line."""
    real = bench.metric_reader

    def reader(name):
        read = real(name)

        def loading(ctx):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return read(ctx)
        return loading
    monkeypatch.setattr(bench, "metric_reader", reader)
    res = run_small(small_config, "subgen-400k-k4.batch32", trace=True)
    capsys.readouterr()
    assert run.emit(res) != 0
    out = capsys.readouterr()
    assert not out.out.strip() and "jax" in out.err


@pytest.mark.parametrize("late", [None, "jax", "repro"])
def test_control_command_checks_modules_last(small_config, monkeypatch, capsys, late):
    """``--control 1`` prints its result only where nothing forbidden was
    loaded by the time it prints."""
    cfg = small_config("imdb-74k-k4")
    monkeypatch.setattr(bench, "load_config", lambda name: cfg)
    real = check.control_answers

    def answers(*args):
        if late:
            monkeypatch.setitem(sys.modules, late, types.ModuleType(late))
        return real(*args)
    monkeypatch.setattr(check, "control_answers", answers)
    rc = run.main(["--workload", "imdb-74k-k4.batch32", "--seed", "9", "--seconds", "30",
                   "--control", "1", "--control-batches", "2"])
    out = capsys.readouterr()
    if late is None:
        assert rc == 0 and json.loads(out.out.strip().splitlines()[-1])["correct"] is False
    else:
        assert rc != 0 and not out.out.strip() and late in out.err


def _alter_answer(monkeypatch):
    import repro_torch.core.scheduler as sch
    real = sch.truncate_answers

    def altered(answers, k):
        out = real(answers, k).copy()
        if out.shape[0]:
            out[0, 0] = (out[0, 0] + 1) % 100
        return out
    monkeypatch.setattr(sch, "truncate_answers", altered)


def _step_unchanged(monkeypatch):
    from repro_torch.kernels import ops
    real = ops.frontier_step

    def unchanged(inv, wr, ws, lidx, sel, m, out):
        got = real(inv, wr, ws, lidx, sel, m, out)
        for mask in (got.ok, got.done, got.keep, got.outm):
            mask.zero_()
        return got
    monkeypatch.setattr(ops, "frontier_step", unchanged)


def _half_batch(monkeypatch):
    import repro_torch.core.scheduler as sch
    real, calls = sch.absorb_eval_outputs, [0]

    def half(st, pid, k, *rest):
        calls[0] += 1
        if calls[0] % 2:
            real(st, pid, k, *rest)
    monkeypatch.setattr(sch, "absorb_eval_outputs", half)


def _no_exchange(monkeypatch):
    import repro_torch.core.scheduler as sch
    real = sch.absorb_eval_outputs

    def local_only(st, pid, k, comp_rows, comp_n, out_rows, out_step, out_dest, out_n):
        real(st, pid, k, comp_rows, comp_n, out_rows[:0], out_step[:0], out_dest[:0], 0)
    monkeypatch.setattr(sch, "absorb_eval_outputs", local_only)


@pytest.mark.parametrize("fault", [_alter_answer, _step_unchanged, _half_batch, _no_exchange])
def test_faults_are_not_correct(small_config, monkeypatch, fault):
    """An answer altered where it is produced; a step that leaves the
    state unchanged; half of each batch's lanes left out; the exchange
    between partitions (the only one a one-card cell has) left out."""
    fault(monkeypatch)
    res = run_small(small_config, "subgen-400k-k4.batch32")
    assert res["correct"] is False
    assert res["checks"]["wrong_answer_sets"]["value"] > 0


@pytest.mark.cuda
def test_traced_cell_on_card(small_config):
    """On the card: a traced run at a small size reads every per-layer
    metric, and the roofline share stays at or under 100 %."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = bench.load_benchmark()
    cell = "subgen-400k-k4.batch32"
    w = bench.find_cell(b, cell)
    res = run.run_cell(small_config(w["config"]), bench.load_traffic(w["traffic"]),
                       2**31 + 1, 2.0, True, torch.device("cuda", 0), b, cell)
    assert res["correct"]
    names = {m["name"] for m in bench.cell_metrics(b, cell, "per_layer")}
    assert set(res["metrics"]) == names
    assert 0 < res["metrics"]["fused_frontier_roofline.batch"]["value"] <= 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
