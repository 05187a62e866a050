"""The port's checkpoints, straggler watchdog and training CLI
(``repro_torch.distributed``, ``repro_torch.launch.train``) on the CPU: the
JAX package's checkpoint cases, directories written by one package and
restored by the other (bf16 included), the watchdog against the
reference's on the same step times, and a killed and resumed CLI run
against an uninterrupted one.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import distributed as ref_dist
from repro.distributed import watchdog as ref_watchdog

from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import (CheckpointManager, StepWatchdog, latest_step,
                                     load_checkpoint, save_checkpoint)
from repro_torch.distributed import watchdog
from repro_torch.launch import train as cli


def make_state(x=1.0):
    return {"params": {"w": torch.full((4, 4), x), "layers": [
        {"a": torch.arange(3, dtype=torch.float32) * x}]},
        "opt": {"step": torch.tensor(int(7 * x), dtype=torch.int32)}}


# ---------------------------------------------------------------------------
# The reference's cases (tests/test_checkpoint.py), on tensors
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    d = str(tmp_path)
    state = make_state(2.0)
    save_checkpoint(d, 10, state)
    step, restored, meta = load_checkpoint(d, make_state(0.0))
    assert step == 10 and meta["step"] == 10
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert torch.equal(restored["params"]["layers"][0]["a"], state["params"]["layers"][0]["a"])
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 14


def test_latest_and_prune(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, make_state(float(s)), keep=2)
    assert latest_step(d) == 5
    kept = sorted(int(n.split("_")[1]) for n in os.listdir(d) if n.startswith("step_"))
    assert kept == [4, 5]


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, make_state())
    # a torn write: a step directory without the done marker, and a .tmp one
    torn = os.path.join(d, "step_00000009")
    os.makedirs(torn)
    with open(os.path.join(torn, "meta.json"), "w") as f:
        json.dump({"step": 9}, f)
    os.makedirs(os.path.join(d, "step_00000011.tmp"))
    assert latest_step(d) == 3
    assert load_checkpoint(d, make_state(0.0))[0] == 3


def test_manager_every(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=5)
    assert mgr.restore_or_none(make_state(0.0)) is None
    st = make_state()
    assert mgr.maybe_save(3, st) is None
    assert mgr.maybe_save(0, st) is None
    assert mgr.maybe_save(5, st) is not None
    assert mgr.restore_or_none(make_state(0.0))[0] == 5


def test_pipeline_state_restart():
    p1 = TokenPipeline(vocab=64, batch=2, seq=16, seed=9)
    batches = [p1.next_batch() for _ in range(5)]
    state = p1.state_dict()
    p2 = TokenPipeline(vocab=64, batch=2, seq=16, seed=9)
    p2.load_state_dict(state)
    np.testing.assert_array_equal(p1.next_batch()["tokens"], p2.next_batch()["tokens"])
    # determinism: batch i is a pure function of (seed, i)
    np.testing.assert_array_equal(
        batches[2]["tokens"],
        TokenPipeline(vocab=64, batch=2, seq=16, seed=9).batch_at(2)["tokens"])
    # labels are next-token targets
    np.testing.assert_array_equal(batches[0]["tokens"][:, 1:], batches[0]["labels"][:, :-1])


# ---------------------------------------------------------------------------
# Across packages (hazard: bf16 checkpoints)
# ---------------------------------------------------------------------------

def mixed_state(rng):
    """A state with float32, bf16 and int32 leaves, as numpy (bf16 as
    float32 values that bf16 holds exactly)."""
    bf = lambda *s: rng.normal(size=s).astype(np.float32).astype(jnp.bfloat16)
    return {"params": {"body": [{"wq": bf(2, 4, 3), "ln1": rng.normal(size=(2, 4)).astype(np.float32)}],
                       "embed": bf(8, 4)},
            "opt": {"m": {"embed": rng.normal(size=(8, 4)).astype(np.float32)},
                    "step": np.int32(12)}}


def bits(t) -> np.ndarray:
    """The raw bits of a tensor or array (bf16 as int16)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy().view(np.uint8)
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(np.uint8)


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    """The JAX package writes float32, bf16 (as ``|V2``) and int32 leaves;
    the port restores each with its dtype and the same bits."""
    state = mixed_state(np.random.default_rng(0))
    jstate = {"params": {"body": [{k: jnp.asarray(v) for k, v in state["params"]["body"][0].items()}],
                         "embed": jnp.asarray(state["params"]["embed"])},
              "opt": {"m": {"embed": jnp.asarray(state["opt"]["m"]["embed"])},
                      "step": jnp.int32(12)}}
    ref_dist.save_checkpoint(str(tmp_path), 4, jstate)
    with np.load(tmp_path / "step_00000004" / "host0000.npz") as z:
        assert z["params/embed"].dtype == np.dtype("V2")
    step, got, meta = load_checkpoint(str(tmp_path), state)
    assert step == 4 and meta["leaves"]["params/embed"]["dtype"] == "bfloat16"
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["params"]["body"][0]["wq"].dtype == torch.bfloat16
    assert got["params"]["body"][0]["ln1"].dtype == torch.float32
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 12
    for path in (("params", "embed"), ("opt", "m", "embed")):
        g, w = got, state
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_array_equal(bits(g), bits(w))
    for k in ("wq", "ln1"):
        np.testing.assert_array_equal(bits(got["params"]["body"][0][k]),
                                      bits(state["params"]["body"][0][k]))


def test_port_checkpoint_matches_reference_layout_and_loads_there(tmp_path):
    """The port's files: the same npz keys and dtypes (bf16 as ``|V2``) and
    the same ``meta.json`` leaves as the reference writes for the same
    state; the reference restores a float32 and int32 state bit for bit."""
    state = mixed_state(np.random.default_rng(1))
    as_torch = lambda a: (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                          if np.asarray(a).dtype.name == "bfloat16" else torch.from_numpy(np.asarray(a)))
    tstate = {"params": {"body": [{k: as_torch(v) for k, v in state["params"]["body"][0].items()}],
                         "embed": as_torch(state["params"]["embed"])},
              "opt": {"m": {"embed": as_torch(state["opt"]["m"]["embed"])},
                      "step": torch.tensor(12, dtype=torch.int32)}}
    jstate = {"params": {"body": [{k: jnp.asarray(v) for k, v in state["params"]["body"][0].items()}],
                         "embed": jnp.asarray(state["params"]["embed"])},
              "opt": {"m": {"embed": jnp.asarray(state["opt"]["m"]["embed"])},
                      "step": jnp.int32(12)}}
    save_checkpoint(str(tmp_path / "port"), 3, tstate, extra_meta={"pipeline_step": 0})
    ref_dist.save_checkpoint(str(tmp_path / "ref"), 3, jstate, extra_meta={"pipeline_step": 0})
    files = {}
    for side in ("port", "ref"):
        d = tmp_path / side / "step_00000003"
        assert sorted(os.listdir(d)) == ["done", "host0000.npz", "meta.json"]
        with np.load(d / "host0000.npz") as z:
            files[side] = {k: z[k] for k in z.files}
        meta = json.loads((d / "meta.json").read_text())
        meta.pop("time")
        files[side + "_meta"] = meta
    assert list(files["port"]) == list(files["ref"])
    for k, w in files["ref"].items():
        g = files["port"][k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
    assert files["port_meta"] == files["ref_meta"]
    # float32 / int32 written by the port load in the reference
    f32 = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7},
           "opt": {"step": torch.tensor(5, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path / "f32"), 1, f32)
    template = {"params": {"w": np.zeros((2, 3), np.float32)}, "opt": {"step": np.int32(0)}}
    step, got, _ = ref_dist.load_checkpoint(str(tmp_path / "f32"), template)
    assert step == 1
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]), f32["params"]["w"].numpy())
    assert int(got["opt"]["step"]) == 5


def test_restore_reads_two_byte_records_by_meta_dtype(tmp_path):
    """A bf16 leaf restores from a ``<i2`` record as well as a ``|V2`` one:
    the ``meta.json`` dtype decides."""
    t = torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"x": t})
    d = tmp_path / "step_00000001"
    np.savez(d / "host0000.npz", x=t.view(torch.int16).numpy())
    _, got, _ = load_checkpoint(str(tmp_path), {"x": None})
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], t)


# ---------------------------------------------------------------------------
# Straggler watchdog
# ---------------------------------------------------------------------------

def test_watchdog_matches_reference(monkeypatch):
    """The same step durations through both watchdogs (``time.time``
    patched): flags, slow-step count and median agree at every step."""
    durations = [1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 1.0, 0.95, 3.5, 1.0, 9.0, 1.2]
    clock = {"t": 0.0}
    fake = type("T", (), {"time": staticmethod(lambda: clock["t"])})
    monkeypatch.setattr(watchdog, "time", fake)
    monkeypatch.setattr(ref_watchdog, "time", fake)
    ours, theirs = StepWatchdog(), ref_watchdog.StepWatchdog()
    for i, dt in enumerate(durations):
        flags = []
        for wd in (ours, theirs):
            clock["t"] = 100.0 * i
            wd.start()
            clock["t"] += dt
            flags.append((wd.stop(), wd.is_straggler(dt), wd.slow_steps, wd.median))
        assert flags[0] == flags[1]
    assert ours.slow_steps == theirs.slow_steps == 3     # 5.0, 3.5 and 9.0


# ---------------------------------------------------------------------------
# The CLI (in process, on the CPU)
# ---------------------------------------------------------------------------

FLAGS = ["--device", "cpu", "--smoke", "--arch", "qwen2_1_5b", "--steps", "6",
         "--batch", "2", "--seq", "32", "--ckpt-every", "2", "--log-every", "1"]


def read_checkpoint(d):
    with np.load(os.path.join(d, "host0000.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(open(os.path.join(d, "meta.json")).read())
    return arrays, meta


def test_cli_resumes_bitwise_after_a_crash(tmp_path, capsys):
    """An uninterrupted run, then a crash after the first commit: a copy of
    its checkpoints with every step after ``step_00000002`` deleted.  The
    same flags on the copy resume from step 2 and end with a checkpoint
    bitwise equal to the uninterrupted run's (the CPU is deterministic)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli.main(FLAGS + ["--ckpt-dir", a]) == 0
    out_a = capsys.readouterr().out
    assert "resumed" not in out_a
    assert sorted(os.listdir(a)) == ["step_00000002", "step_00000004", "step_00000006"]
    shutil.copytree(a, b)
    for s in ("step_00000004", "step_00000006"):
        shutil.rmtree(os.path.join(b, s))
    assert cli.main(FLAGS + ["--ckpt-dir", b]) == 0
    out_b = capsys.readouterr().out
    assert "[train] resumed from step 2" in out_b
    # each step line's tokens without its time ("<t> ms") and any
    # "[STRAGGLER]": the time is right-aligned, so its padding varies
    logged = lambda out: [[t for t in l.split() if t != "[STRAGGLER]"][:-2]
                          for l in out.splitlines() if l.startswith("[train] step")]
    assert logged(out_b) == logged(out_a)[2:]
    assert "final loss" in out_b.splitlines()[-1]
    want, wmeta = read_checkpoint(os.path.join(a, "step_00000006"))
    got, gmeta = read_checkpoint(os.path.join(b, "step_00000006"))
    assert list(got) == list(want)
    assert any(k.startswith("params/body/0/") for k in want)
    assert {"params/embed", "opt/m/embed", "opt/v/embed", "opt/step"} <= set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    for m in (wmeta, gmeta):
        m.pop("time")
    assert gmeta == wmeta and wmeta["step"] == 6 and int(want["opt/step"]) == 6
    # nothing left to run: the last line has no loss
    assert cli.main(FLAGS + ["--ckpt-dir", a]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 6" in out
    assert out.splitlines()[-1].startswith("[train] done. median step")


def test_cli_rejects_production(capsys):
    """``--production`` builds the (16, 16) mesh, which needs 256 ranks:
    below that it raises the reference's ``RuntimeError``."""
    with pytest.raises(RuntimeError, match=r"need 256 devices for mesh \(16, 16\), have 1"):
        cli.main(FLAGS + ["--production"])
    assert "[train]" not in capsys.readouterr().out


def test_cli_production_step_as_rank_0_of_256(capsys):
    """``--production`` inside ``counting_world(256)``: the CLI joins the
    group there, builds the (16, 16) mesh and runs one FSDP + tensor
    parallel step of reduced qwen2 as rank 0, and leaves the group it did
    not open.  The ``fake`` backend's collectives move nothing, so only
    the printed lines are checked."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import counting_world
    with counting_world(256):
        assert cli.main(["--arch", "qwen2-1.5b", "--smoke", "--production", "--steps", "1",
                         "--batch", "16", "--seq", "32", "--device", "cpu"]) == 0
        assert dist.is_initialized() and dist.get_world_size() == 256
    assert not dist.is_initialized()
    lines = capsys.readouterr().out.splitlines()
    assert [l.split()[:3] for l in lines if l.startswith("[train] step")] == \
        [["[train]", "step", "0"]], lines
    assert any(l.startswith("[train] done.") for l in lines), lines
