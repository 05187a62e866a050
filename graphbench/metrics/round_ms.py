"""round_ms: the mean length of the program's ``scheduler.round`` spans
(one a partition round of the shared scheduler) in the window, in ms."""


def read(ctx):
    t0, t1 = ctx["served"].t0, ctx["served"].t1
    rounds = [sp.t1 - sp.t0 for sp in ctx["spans"]
              if sp.name == "scheduler.round" and sp.t1 is not None
              and t0 <= sp.t0 and sp.t1 <= t1]
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
