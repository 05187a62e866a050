"""The PyTorch port's serving CLI (``python -m repro_torch.launch.serve``)
on the CPU: the ``--verify`` gate for every engine, the ``--json`` report
against the JAX package's CLI, the workload round trip, and the refusal of
flags whose modules are not ported yet."""
import json
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as ref_serve

from repro_torch.launch import serve

SMALL = ["--dataset", "synthetic", "--scale", "0.5", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the suite
    runs several test processes at once, and idle worker threads would
    only contend with them.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _verify_lines(out: str):
    return [ln.split()[-1] for ln in out.splitlines() if "oracle:" in ln]


@pytest.mark.parametrize("budget", [None, 5])
@pytest.mark.parametrize("engine", ["opat", "traditional", "mapreduce"])
def test_verify_prints_only_match(capsys, engine, budget):
    argv = SMALL + ["--engine", engine, "--verify"]
    if budget is not None:
        argv += ["--max-answers", str(budget)]
    assert serve.main(argv) == 0
    verdicts = _verify_lines(capsys.readouterr().out)
    assert len(verdicts) == 3 and set(verdicts) == {"MATCH"}


@pytest.mark.parametrize("engine", ["opat", "traditional"])
def test_json_report_matches_reference_cli(tmp_path, monkeypatch, capsys, engine):
    args = ["--dataset", "synthetic", "--scale", "0.5", "--engine", engine,
            "--max-answers", "5"]
    ref_out, out = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["serve", *args, "--json", str(ref_out)])
    ref_serve.main()
    assert serve.main(args + ["--device", "cpu", "--json", str(out)]) == 0
    capsys.readouterr()
    want, got = json.loads(ref_out.read_text()), json.loads(out.read_text())
    assert set(got) == set(want)
    keys = ("query", "answers", "loads", "l_ideal", "iterations", "cold_loads",
            "warm_loads", "prefetch_hits", "generation")
    assert [{k: r[k] for k in keys} for r in got["queries"]] == \
        [{k: r[k] for k in keys} for r in want["queries"]]
    for k in ("cold_loads", "warm_loads", "evictions", "bytes_cold"):
        assert got["cache"][k] == want["cache"][k], k
    assert got["workload_profile"] == want["workload_profile"]


def test_workload_round_trip_and_batch_serving(tmp_path, capsys):
    first, again = tmp_path / "w.jsonl", tmp_path / "w2.jsonl"
    assert serve.main(SMALL + ["--emit-workload", str(first), "--emit-repeat", "2",
                               "--emit-slo-classes", "a,b"]) == 0
    lines = [json.loads(ln) for ln in first.read_text().splitlines()]
    assert len(lines) == 6 and [d["slo_class"] for d in lines[:2]] == ["a", "b"]
    assert serve.main(SMALL + ["--workload", str(first),
                               "--emit-workload", str(again)]) == 0
    assert again.read_text() == first.read_text()
    report = tmp_path / "r.json"
    assert serve.main(SMALL + ["--engine", "mapreduce", "--workload", str(first),
                               "--verify", "--json", str(report)]) == 0
    assert set(_verify_lines(capsys.readouterr().out)) == {"MATCH"}
    rep = json.loads(report.read_text())
    assert rep["throughput"]["n_queries"] == 6
    assert rep["throughput"]["shared"] is False
    assert rep["workload_profile"]["partition_counters_observed"] is False


@pytest.mark.parametrize("dest,item", sorted(serve.UNPORTED_FLAGS.items()))
def test_unported_flag_exits_2_naming_its_item(capsys, dest, item):
    flag = "--" + dest.replace("_", "-")
    value = [] if dest == "no_read_ahead" else ["1"]
    with pytest.raises(SystemExit) as exc:
        serve.main(SMALL + [flag, *value])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and f"ROADMAP.md {item}" in err
