"""The port's four examples (``examples/torch_*.py``) run in process on the
CPU through their ``main``: the quickstart and the MapReduceMP demo print
the JAX examples' lines (the JAX examples run beside them in two
subprocesses; timings and device names aside), the serving demo verifies
every query against the oracle with its demo flags, the training demo
resumes from its checkpoint, and each raises with no card when
``--device`` is not given.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_serve_queries", "torch_mapreduce_demo",
            "torch_train_lm")


def load(name):
    """The example ``examples/<name>.py`` as a module (its ``main``)."""
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    """The JAX package's quickstart and MapReduceMP demo, run as their
    scripts (the demo forces its four host devices), started together:
    {name: stdout lines}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO / "src"),
                                                        os.environ.get("PYTHONPATH")])))
    env.pop("XLA_FLAGS", None)
    procs = {n: subprocess.Popen([sys.executable, f"examples/{n}.py"], cwd=REPO, env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for n in ("quickstart", "mapreduce_demo")}
    out = {}
    for n, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out[n] = stdout.splitlines()
    return out


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' tiny ops run at one intra-op thread: at the default
    (every core) they oversubscribe the cores that the suite's other
    workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run(name, argv, capsys):
    rc = load(name).main(argv)
    return rc, capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_lines(reference, capsys):
    rc, lines = run("torch_quickstart", ["--device", "cpu"], capsys)
    assert rc == 0
    want = reference["quickstart"]
    assert len(lines) == len(want) == 9, lines
    for got, w in zip(lines, want):
        if w.startswith("session:"):
            assert got == w + "; device cpu"
        elif w.startswith("warm repeat:"):
            assert got.split(" (latency")[0] == w.split(" (latency")[0] == \
                "warm repeat: cold=0 warm=1"
        else:
            assert got == w
    assert "oracle check: MATCH" in lines
    assert " 1 disk reads" in lines[-1]


def test_mapreduce_demo_prints_the_reference_lines(reference, capsys):
    rc, lines = run("torch_mapreduce_demo", ["--device", "cpu"], capsys)
    assert rc == 0
    want = reference["mapreduce_demo"]
    assert lines[0] == want[0] + " (cpu, cpu, cpu, cpu)"
    assert lines[1:] == want[1:]
    assert [l.split(":")[0] for l in lines[1:]] == ["Q4", "Q5", "Q6"]
    assert all(l.endswith("— MATCH vs oracle") for l in lines[1:])


def test_serve_queries_demo_verifies_every_query(capsys):
    rc, lines = run("torch_serve_queries", ["--device", "cpu"], capsys)
    assert rc == 0
    assert any("engine=opat device=cpu" in l and "k=4 scheme=ecosocial" in l for l in lines)
    verdicts = [l.split()[-1] for l in lines if l.strip().startswith("oracle:")]
    assert verdicts == ["MATCH"] * 3, lines


def test_train_lm_demo_resumes(tmp_path, capsys):
    """Three steps with a checkpoint after the third, then a relaunch to
    four steps that resumes there and runs the fourth."""
    flags = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "3"]
    rc, lines = run("torch_train_lm", flags + ["--steps", "3", "--log-every", "1"], capsys)
    assert rc == 0
    assert [l.split()[2] for l in lines if l.startswith("[train] step")] == ["0", "1", "2"]
    assert lines[-1].startswith("[train] done. final loss")
    rc, lines = run("torch_train_lm", flags + ["--steps", "4"], capsys)
    assert rc == 0
    assert lines[0] == "[train] resumed from step 3"
    assert [l.split()[2] for l in lines if l.startswith("[train] step")] == ["3"]
    assert lines[-1].startswith("[train] done. final loss")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, monkeypatch, capsys):
    """With no ``--device``, each example runs on the card, and raises
    where there is none, before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        load(name).main([])
    assert capsys.readouterr().out == ""
