"""The readers of the program's own spans (``frontend_ms``,
``sched_self_ms``, ``eval_loop_us``, ``lanes_per_launch``,
``frontend_idle_pct``) on a hand-built window with known values, the
anchors' interpolation under a planted drift, the clock check, and what they read from a program without the spans: the
parent of the change that added them, or a run on the CPU."""
import dataclasses
from typing import Optional

import numpy as np
import pytest

from graphbench import bench, spans

CELLS = ["subgen-400k-k4.batch32", "imdb-74k-k4.batch32"]
NEW = ["frontend_ms.batch", "sched_self_ms.batch", "eval_loop_us.batch",
       "lanes_per_launch.batch", "frontend_idle_pct.batch"]
BASE = 1_760_000_000 * 10**9
DRIFT = 0.05          # the wall clock gains 50 ms a second on perf_counter


@dataclasses.dataclass
class Sp:
    name: str
    span_id: int
    parent_id: Optional[int]
    t0: float
    t1: float
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Served:
    t0: float
    t1: float
    completed: int


def wall(t: float) -> int:
    return BASE + round((t + DRIFT * (t - 100.0)) * 1e9)


def anchor(i, t, parent=None):
    return Sp("clock.anchor", i, parent, t, t, {"perf_ns": round(t * 1e9), "wall_ns": wall(t)})


def window():
    """Two front-end calls in a window of [100, 110] s, 4 queries.

    frontend.serve [101, 105]: admission [101, 101.5] with scheduler.admit
    [101.2, 101.5]; scheduler.run [102, 104] (retire [102, 102.2], one
    round [102.5, 103.5] with kernel.eval [102.6, 103.4], 4 loops of 3
    lanes); drain [104, 104.5].  frontend.serve [106, 108]: scheduler.run
    [106, 107] with one round [106.2, 106.6] and kernel.eval [106.3,
    106.5], 6 loops of 1 lane.  One more call after the window."""
    s = [Sp("frontend.serve", 1, None, 101.0, 105.0), anchor(20, 101.0, 1),
         Sp("frontend.admit", 2, 1, 101.0, 101.5),
         Sp("scheduler.admit", 3, 2, 101.2, 101.5),
         Sp("scheduler.run", 4, 1, 102.0, 104.0),
         Sp("scheduler.round", 5, 4, 102.5, 103.5),
         Sp("kernel.eval", 6, 5, 102.6, 103.4, {"loops": 4, "lanes": 3}),
         Sp("scheduler.retire", 7, 4, 102.0, 102.2),
         Sp("frontend.drain", 8, 1, 104.0, 104.5),
         Sp("session.absorb", 13, 8, 104.1, 104.4),
         Sp("frontend.serve", 9, None, 106.0, 108.0), anchor(21, 106.0, 9),
         Sp("scheduler.run", 10, 9, 106.0, 107.0),
         Sp("scheduler.round", 11, 10, 106.2, 106.6),
         Sp("kernel.eval", 12, 11, 106.3, 106.5, {"loops": 6, "lanes": 1}),
         Sp("frontend.serve", 14, None, 111.0, 112.0), anchor(22, 111.0, 14),
         Sp("scheduler.run", 15, 14, 111.0, 111.5), anchor(23, 90.0)]
    # the card: busy over the whole of [104, 105] and the two evaluator calls
    events = [("frontier_step_kernel", wall(a), wall(b) - wall(a), 7)
              for a, b in ((102.6, 103.4), (106.3, 106.5))]
    events.append(("index_elementwise_kernel", wall(104.0), wall(105.0) - wall(104.0), 7))
    sl = {"device": True, "side_stream": 9, "t0": 100.0, "t1": 110.0,
          "wall_off_ns": wall(100.0) - round(100.0 * 1e9), "events": events}
    return {"served": Served(100.0, 110.0, 4), "spans": s, "slice": sl, "cfg": {}}


@pytest.mark.parametrize("name, want", [
    # 4 - (0.3 + 2) and 2 - 1 s of front end alone, over 4 queries
    ("frontend_ms.batch", 1e3 * (1.7 + 1.0) / 4),
    # 2 - 1 and 1 - 0.4 s of scheduler.run outside rounds, over 2 rounds
    ("sched_self_ms.batch", 1e3 * (1.0 + 0.6) / 2),
    # 0.8 + 0.2 s over 10 loops
    ("eval_loop_us.batch", 1e6 * 1.0 / 10),
    ("lanes_per_launch.batch", (3 * 4 + 1 * 6) / 10),
    # front end alone: [101, 101.2], [101.5, 102], [104, 105], [107, 108]
    # = 2.7 s, the card busy over [104, 105]: 1.7 s idle of 10
    ("frontend_idle_pct.batch", 17.0),
])
def test_reader_on_known_window(name, want):
    assert bench.metric_reader(name)(window()) == pytest.approx(want, rel=1e-6)


def test_idle_needs_the_anchors():
    """The single offset would misplace the front end's spans by up to
    0.5 s under this drift; without anchors the metric is left out."""
    ctx = window()
    ctx["spans"] = [sp for sp in ctx["spans"] if sp.name != "clock.anchor"]
    assert bench.metric_reader("frontend_idle_pct.batch")(ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_parent_program_and_cpu_read_nothing(name):
    """A program without the new spans, counters and anchors (only the
    spans the earlier readers need), and a run on the CPU, leave each new
    metric out without raising."""
    old = window()
    old["spans"] = [Sp("scheduler.round", 5, None, 102.5, 103.5),
                    Sp("kernel.eval", 6, 5, 102.6, 103.4, {"pid": 0, "batch": 3}),
                    Sp("query", 30, None, 101.0, 105.0)]
    assert bench.metric_reader(name)(old) is None
    cpu = window()
    cpu["slice"] = dict(cpu["slice"], device=False)
    assert bench.metric_reader(name)(cpu) is None


def test_new_metrics_in_both_cells():
    b = bench.load_benchmark()
    for cell in CELLS:
        names = [m["name"] for m in bench.cell_metrics(b, cell, "per_layer")]
        assert set(NEW) <= set(names) and len(names) == 10


def test_clock_check_counts_overhang():
    """Each step kernel lies inside its evaluator call on the anchors'
    clock; on the single offset the drift pushes the later call's kernel
    out by 0.325 s; a kernel 150 us past its call's end counts outside."""
    ctx = window()
    sl, sp = ctx["slice"], ctx["spans"]
    got = spans.step_overhang(sl, sp, spans.anchor_clock(sp))
    assert got["steps"] == 2 and got["outside"] == 0 and got["worst_us"] < 0.01
    got = spans.step_overhang(sl, sp, spans.offset_clock(sl))
    # the later call ends at 106.5 s: 0.325 s late on the wall clock
    assert got["outside"] == 2 and got["worst_us"] == pytest.approx(0.325e6, abs=0.01)
    sl["events"].append(("frontier_step_kernel", wall(106.5) + 150_000, 1_000, 7))
    got = spans.step_overhang(sl, sp, spans.anchor_clock(sp))
    assert got["outside"] == 1 and got["worst_us"] == pytest.approx(151.0, abs=0.01)
    assert spans.drift_ns(sp, 100.0, 112.0) == wall(111.0) - wall(101.0) - 10 * 10**9


def test_anchor_interpolation_under_drift():
    """Under a planted drift of the wall clock against ``perf_counter``
    (a slewed 0.4 s over 40 s, then a step back), spans between anchors
    map to the true wall time within a nanosecond, where the recorder's
    single offset is off by the drift; outside the anchors the nearest
    anchor's offset holds."""
    base = 1_760_000_000 * 10**9

    def wall(t):      # true wall ns at perf second t
        drift = 0.01 * (t - 100.0) if t <= 140.0 else 0.4 - 0.02 * (t - 140.0)
        return base + round((t + drift) * 1e9)
    perf = [100.0, 120.0, 140.0, 150.0]
    sps = [Sp("clock.anchor", i + 1, None, t, t,
              {"perf_ns": round(t * 1e9), "wall_ns": wall(t)})
           for i, t in enumerate(perf)]
    sps.append(Sp("kernel.eval", 9, None, 110.0, 111.0))
    clock = spans.anchor_clock(sps)
    ts = [100.0, 105.25, 119.999, 133.3, 140.0, 145.5, 150.0]
    np.testing.assert_allclose(clock(ts), [wall(t) for t in ts], atol=1, rtol=0)
    assert int(clock(90.0)) == wall(100.0) - round(10 * 1e9)
    assert int(clock(160.0)) == wall(150.0) + round(10 * 1e9)
    single = spans.offset_clock({"wall_off_ns": wall(100.0) - round(100.0 * 1e9)})
    assert abs(int(single(133.3)) - wall(133.3)) > 3 * 10**8
    assert spans.drift_ns(sps, 100.0, 140.0) == wall(140.0) - wall(100.0) - 40 * 10**9
    assert spans.drift_ns(sps, 95.0, 105.0) is None
    assert spans.anchor_clock(sps[4:]) is None


def test_subtract_intervals():
    assert spans.subtract([[0, 10], [20, 30]], [[2, 3], [2.5, 4], [9, 21], [25, 40]]) == \
        [[0, 2], [4, 9], [21, 25]]
    assert spans.subtract([[0, 10]], []) == [[0, 10]]
