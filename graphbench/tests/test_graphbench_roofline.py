"""The roofline's count against a hand-worked launch, and the recorder's
count of a launch's work on the CPU."""
from types import SimpleNamespace

import torch

from graphbench import roofline
from graphbench.tracing import WindowRecorder, breakdown, busy_s, union_intervals


def test_hand_worked_launch():
    # one lane, three active bindings whose vertices have degrees 3, 1
    # and 2: six adjacency entries; q_pad 8, s_pad 12
    assert roofline.entry_bytes(8) == 24 + 8 + (32 + 12 + 4)          # 80
    assert roofline.binding_bytes(8) == 32 + 4 + 4 + 8 + 1 + 8        # 57
    assert roofline.lane_bytes(12) == 12 * 36 + 12                     # 444
    assert roofline.step_bytes(6, 3, 1, 8, 12) == 6 * 80 + 3 * 57 + 444
    assert abs(roofline.bound_s(3.35e12) - 1.0) < 1e-12


def test_recorder_counts_real_entries():
    """The recorder counts each selected active binding's real adjacency
    entries (its degree), not the padded width."""
    ell_dst = torch.tensor([[5, 6, 7], [8, -1, -1], [-1, -1, -1], [1, 2, -1],
                            [3, -1, -1], [-1, -1, -1], [-1, -1, -1], [-1, -1, -1]],
                           dtype=torch.int32)
    # two partitions of four rows; lane 0 reads partition 0, lane 1 partition 1
    inv = SimpleNamespace(tables=(ell_dst,), node_pad=4,
                          lane=torch.tensor([[0, 4, 2], [1, 4, 2]], dtype=torch.int32))
    lidx = torch.tensor([[0, 1, 2, 3], [0, 1, 2, 3]], dtype=torch.int32)
    sel = torch.tensor([[0, 1, 3, 2], [0, 3, 1, 2]], dtype=torch.int64)
    m = torch.tensor([[True, True, True, False], [True, False, False, False]])
    rec = WindowRecorder(torch.device("cpu"))
    rec._start()
    rec._count(inv, lidx, sel, m)
    rec._count(inv, lidx, sel, m)
    rec._stop()
    r = rec.result
    # lane 0: rows 0, 1, 3 (degrees 3, 1, 2); lane 1: row 4 (degree 1)
    assert (r["entries"], r["bindings"], r["lanes"], r["recorded_launches"]) == (14, 8, 4, 2)
    assert r["device"] is False and busy_s(r) is None and breakdown(r, []) is None


def test_union_and_breakdown():
    ev = [("k1", 0, 10, 7), ("k2", 5, 10, 7), ("memcpy", 30, 5, 8), ("k1", 50, 10, 7)]
    assert union_intervals(ev, 0, 100) == [[0, 15], [30, 35], [50, 60]]
    sl = {"device": True, "side_stream": 9, "events": ev, "t0_ns": 0, "t1_ns": 100,
          "t0": 0.0, "t1": 1e-7, "wall_off_ns": 0}
    assert abs(busy_s(sl) - 30e-9) < 1e-15
    span = SimpleNamespace(name="scheduler.round", t0=20e-9, t1=45e-9)
    got = breakdown(sl, [span])
    assert got["device_ops"][0] == ["k1", 20e-9]
    idle = dict(got["idle_gaps"])
    # gaps 15-30 and 35-50 lie in the round; 60-100 outside any span
    assert abs(idle["scheduler.round"] - 30e-9) < 1e-15
    assert abs(idle["outside spans"] - 40e-9) < 1e-15
