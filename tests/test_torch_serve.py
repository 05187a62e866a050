"""The PyTorch port's serving CLI (``python -m repro_torch.launch.serve``)
on the CPU: the ``--verify`` gate for every engine, the ``--json`` report
against the JAX package's CLI (in RAM, and out of core for each of the
graph-directory, repartitioning, SLO and mutation flags), the workload
round trip, the mutation soak's ``--verify``, and ``--metrics-out`` and
the ``--trace-out`` profile block against the JAX package's CLI."""
import json
import os
import shutil
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as ref_serve
from repro.storage import HostShardCache as RefHostShardCache

from repro_torch.launch import serve
from repro_torch.storage import HostShardCache

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


def _prom_samples(path):
    """A Prometheus file's lines, less the process's peak RSS (it differs
    between the two packages' processes)."""
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("repro_session_peak_rss_bytes")]


@pytest.mark.parametrize("engine,extra", [("opat", []),
                                          ("traditional", ["--workload"])])
def test_metrics_out_matches_reference_cli(tmp_path, monkeypatch, capsys,
                                           engine, extra):
    """--metrics-out writes the reference CLI's Prometheus file, line for
    line (profiled with --trace-out; with --workload the scheduler's load
    counter and batch-occupancy histogram too)."""
    args = ["--dataset", "synthetic", "--scale", "0.5", "--engine", engine,
            "--max-answers", "5"]
    if extra:
        wl = tmp_path / "w.jsonl"
        assert serve.main(SMALL + ["--emit-workload", str(wl), "--emit-repeat", "2"]) == 0
        args += [extra[0], str(wl)]
    outs = {}
    for tag in ("ref", "port"):
        outs[tag] = (tmp_path / f"{tag}.prom", tmp_path / f"{tag}.trace.json")
        argv = args + ["--metrics-out", str(outs[tag][0]),
                       "--trace-out", str(outs[tag][1])]
        if tag == "ref":
            monkeypatch.setattr(sys, "argv", ["serve", *argv])
            ref_serve.main()
        else:
            assert serve.main(argv + ["--device", "cpu"]) == 0
    capsys.readouterr()
    got, want = _prom_samples(outs["port"][0]), _prom_samples(outs["ref"][0])
    assert any(ln.startswith("repro_session_peak_device_bytes ") for ln in got)
    if extra:
        assert any(ln.startswith("repro_scheduler_batch_occupancy_bucket") for ln in got)
    assert got == want


def test_trace_out_enables_the_profile_block(tmp_path, monkeypatch, capsys):
    """With --trace-out the --json report's "profile" block is enabled and
    names the reference's kernel keys, peak device bytes and byte flows;
    without it the block reads {"enabled": false} in both."""
    args = ["--dataset", "synthetic", "--scale", "0.5", "--engine", "opat",
            "--max-answers", "5"]
    want, got = _both_reports(tmp_path, monkeypatch, capsys,
                              args + ["--trace-out", str(tmp_path / "t.json")], "on")
    prof, ref = got["profile"], want["profile"]
    assert prof["enabled"] is True and ref["enabled"] is True
    assert set(prof["kernel_costs"]) == set(ref["kernel_costs"]) == {"opat:eval"}
    assert prof["peak_device_bytes"] == ref["peak_device_bytes"] > 0
    assert prof["bytes"] == ref["bytes"]
    cost = prof["kernel_costs"]["opat:eval"]
    assert cost["dominant"] in ("memory", "compute") and cost["t_bound_us"] > 0
    metrics = [{k: v for k, v in r["observability"]["metrics"].items()
                if k != "repro_session_peak_rss_bytes"} for r in (got, want)]
    assert metrics[0] == metrics[1]
    want, got = _both_reports(tmp_path, monkeypatch, capsys, args, "off")
    assert got["profile"] == want["profile"] == {"enabled": False}


# --json record keys both CLIs must agree on (latency is wall-clock)
RECORD_KEYS = ("query", "answers", "loads", "l_ideal", "iterations", "cold_loads",
               "warm_loads", "prefetch_hits", "disk_reads", "read_ahead_hits",
               "generation")


def _both_reports(tmp_path, monkeypatch, capsys, args, tag):
    """Run the reference CLI and then the port's with ``args``; return
    their --json reports."""
    ref_out, out = tmp_path / f"{tag}-ref.json", tmp_path / f"{tag}-port.json"
    monkeypatch.setattr(sys, "argv", ["serve", *args, "--json", str(ref_out)])
    ref_serve.main()
    assert serve.main(args + ["--device", "cpu", "--json", str(out)]) == 0
    capsys.readouterr()
    return json.loads(ref_out.read_text()), json.loads(out.read_text())


# the SLO keys of a --json record, and of a shed one (no answers)
SLO_KEYS = ("status", "slo_class", "degraded", "deferred", "deadline_s",
            "predicted_latency_s", "effective_max_answers", "shed_reason")


def _assert_same_reports(got, want):
    keys = RECORD_KEYS + SLO_KEYS
    assert [{k: r[k] for k in keys if k in r} for r in got["queries"]] == \
        [{k: r[k] for k in keys if k in r} for r in want["queries"]]
    assert got["cache"] == want["cache"]


@pytest.fixture(scope="module")
def ref_graph_dir(tmp_path_factory):
    """A graph directory written by the reference CLI's --save-graph."""
    gdir = tmp_path_factory.mktemp("cli") / "graph"
    argv = sys.argv
    sys.argv = ["serve", "--dataset", "synthetic", "--scale", "0.5",
                "--max-answers", "1", "--save-graph", str(gdir)]
    try:
        ref_serve.main()
    finally:
        sys.argv = argv
    return str(gdir)


OOC = ["--dataset", "synthetic", "--max-answers", "5", "--cache-parts", "1"]


def _joined(read_ahead, workers):
    def issue_and_join(self, *args, **kwargs):
        issued = read_ahead(self, *args, **kwargs)
        for t in workers(self):
            t.join(timeout=60)
        return issued
    return issue_and_join


def _ref_workers(tier):
    with tier._lock:
        return list(tier._pending.values())


SLO_WORKLOAD = ["--emit-repeat", "2", "--emit-slo-classes",
                "interactive,batch,exhaustive"]
# each SLO flag's run: the decisions come from the cost model under
# instant replay, so they must equal the reference's
SLO_RUNS = {
    "slo": ["--slo", "interactive=0.5,batch=5,exhaustive=inf"],
    "shed_policy": ["--slo", "interactive=60,batch=0.0001,exhaustive=inf",
                    "--shed-policy", "deadline"],
    "arrival_replay": ["--slo", "interactive=0.5,batch=0.001,exhaustive=inf",
                       "--arrival-replay", "0"],
    "default_slo": ["--slo", "interactive=0.5,batch=0.0001", "--default-slo",
                    "batch", "--max-answers", "1000"],
}
MUTATE_RUNS = {
    "mutate_workload": ["--mutate-workload", "12"],
    "mutate_compact_every": ["--mutate-workload", "12", "--mutate-compact-every", "5"],
    "mutate_seed": ["--mutate-workload", "12", "--mutate-seed", "3",
                    "--mutate-compact-every", "4", "--engine", "traditional"],
}


@pytest.mark.parametrize("flag", ["save_graph", "graph_dir", "host_cache_parts",
                                  "no_read_ahead", "repartition_from",
                                  *SLO_RUNS, *MUTATE_RUNS])
def test_served_flag_matches_reference_cli(tmp_path, monkeypatch, capsys,
                                           ref_graph_dir, flag):
    """Each flag that used to exit 2 is served: the port's --json report
    equals the reference CLI's in answers, loads and the cache block (disk
    counters included).  --save-graph writes the reference's files; the
    graph-directory flags open the reference's directory.  Both packages'
    read-aheads join their worker before returning, so neither side's
    counters follow thread timing (see tests/test_torch_storage.py)."""
    monkeypatch.setattr(RefHostShardCache, "read_ahead",
                        _joined(RefHostShardCache.read_ahead, _ref_workers))
    monkeypatch.setattr(HostShardCache, "read_ahead",
                        _joined(HostShardCache.read_ahead, lambda t: list(t._workers)))
    if flag == "save_graph":
        gdir = tmp_path / "saved"
        want, got = _both_reports(
            tmp_path, monkeypatch, capsys,
            ["--dataset", "synthetic", "--scale", "0.5", "--max-answers", "1",
             "--save-graph", str(gdir)], flag)
        # the reference saved first and the port saved over it: the same
        # content-addressed files, under the manifest's next generation
        assert sorted(os.listdir(gdir)) == sorted(os.listdir(ref_graph_dir))
        manifest = json.loads((gdir / "manifest.json").read_text())
        assert manifest.pop("generation") == 1
        first = json.loads(open(os.path.join(ref_graph_dir, "manifest.json")).read())
        assert first.pop("generation") == 0 and manifest == first
        assert got["workload_profile"] == want["workload_profile"]
    elif flag in SLO_RUNS:
        base = ["--dataset", "synthetic", "--scale", "0.5"]
        argv = base + SLO_RUNS[flag]
        if flag != "default_slo":
            workload = tmp_path / "w.jsonl"
            assert serve.main(SMALL + ["--emit-workload", str(workload)]
                              + SLO_WORKLOAD) == 0
            argv += ["--workload", str(workload)]
        want, got = _both_reports(tmp_path, monkeypatch, capsys, argv, flag)
        slo, ref_slo = got["throughput"]["slo"], want["throughput"]["slo"]
        for k in ("counters", "shed_by_reason", "rounds", "shed_policy"):
            assert slo[k] == ref_slo[k], k
        assert slo["cost_model"]["default_rate_s"] == 2e-4
        c = slo["counters"]
        assert c["served"] + c["shed"] == c["arrived"] == len(got["queries"])
        assert all(r["shed_reason"] for r in got["queries"] if r["status"] == "shed")
        if flag != "slo":
            assert c["shed"] > 0
        assert got["workload_profile"]["serving"]["counters"] == \
            want["workload_profile"]["serving"]["counters"]
    elif flag in MUTATE_RUNS:
        ref_dir, port_dir = tmp_path / "ref-dir", tmp_path / "port-dir"
        shutil.copytree(ref_graph_dir, ref_dir)
        shutil.copytree(ref_graph_dir, port_dir)
        args = ["--dataset", "synthetic", "--cache-parts", "1", "--host-cache-parts",
                "2"] + MUTATE_RUNS[flag]
        ref_out, out = tmp_path / "ref.json", tmp_path / "port.json"
        monkeypatch.setattr(sys, "argv", ["serve", *args, "--graph-dir", str(ref_dir),
                                          "--json", str(ref_out)])
        ref_serve.main()
        assert serve.main(args + ["--graph-dir", str(port_dir), "--device", "cpu",
                                  "--json", str(out)]) == 0
        capsys.readouterr()
        want, got = json.loads(ref_out.read_text()), json.loads(out.read_text())
        assert got["generations"] == want["generations"]
        if "--mutate-compact-every" in args:
            assert got["generations"]["end"] > 0
        assert got["workload_profile"] == want["workload_profile"]
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    elif flag == "repartition_from":
        profile = tmp_path / "profile.json"
        assert serve.main(SMALL + ["--max-answers", "5", "--profile-json",
                                   str(profile)]) == 0
        want, got = _both_reports(
            tmp_path, monkeypatch, capsys,
            ["--dataset", "synthetic", "--scale", "0.5", "--max-answers", "5",
             "--repartition-from", str(profile)], flag)
        assert got["workload_profile"]["scheme"] == "waw"
        assert got["workload_profile"] == want["workload_profile"]
    else:
        extra = {"graph_dir": [],
                 "host_cache_parts": ["--host-cache-parts", "1"],
                 "no_read_ahead": ["--host-cache-parts", "2", "--no-read-ahead"]}[flag]
        want, got = _both_reports(tmp_path, monkeypatch, capsys,
                                  OOC + ["--graph-dir", ref_graph_dir] + extra, flag)
        assert got["workload_profile"]["out_of_core"] is True
        cache = got["cache"]
        assert cache["disk_reads"] > 0 and cache["bytes_disk"] > 0
        if flag == "no_read_ahead":
            assert cache["read_ahead_issued"] == 0
        elif flag == "host_cache_parts":
            assert cache["host_evictions"] > 0 and cache["read_ahead_hits"] > 0
    _assert_same_reports(got, want)


@pytest.mark.parametrize("engine", ["opat", "traditional", "mapreduce"])
def test_mutation_soak_verify_prints_only_match(tmp_path, capsys, ref_graph_dir, engine):
    """The mutation soak: 30 updates compacted every 10, each query
    verified against the oracle over its own pinned overlay graph."""
    gdir = tmp_path / "soak"
    shutil.copytree(ref_graph_dir, gdir)
    report = tmp_path / "soak.json"
    assert serve.main(["--dataset", "synthetic", "--device", "cpu", "--engine", engine,
                       "--graph-dir", str(gdir), "--mutate-workload", "30",
                       "--mutate-compact-every", "10", "--verify",
                       "--json", str(report)]) == 0
    out = capsys.readouterr().out
    verdicts = _verify_lines(out)
    assert verdicts and set(verdicts) == {"MATCH"}
    assert "[serve] soak done: 30 deltas" in out
    rep = json.loads(report.read_text())
    assert rep["generations"]["start"] == 0 and rep["generations"]["end"] > 0
    assert [r["generation"] for r in rep["queries"]] == \
        sorted(r["generation"] for r in rep["queries"])


@pytest.mark.parametrize("engine", ["opat", "traditional", "mapreduce"])
def test_graph_dir_verify_prints_only_match(capsys, ref_graph_dir, engine):
    """Every engine served from the reference's graph directory through a
    one-partition host tier: every query MATCHes the oracle."""
    assert serve.main(["--dataset", "synthetic", "--device", "cpu", "--engine", engine,
                       "--graph-dir", ref_graph_dir, "--host-cache-parts", "1",
                       "--verify"]) == 0
    out = capsys.readouterr().out
    verdicts = _verify_lines(out)
    assert len(verdicts) == 3 and set(verdicts) == {"MATCH"}
    assert "[serve] disk tier:" in out
