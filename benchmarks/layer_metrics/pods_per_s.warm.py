"""The solve as a whole in the warm cell: pods given a decision over all
solves of the traced window, over its seconds.  In that cell the rate
spreads between runs by more than a bound may hold, so it is read here and
not as an end-to-end metric."""


def read(run):
    solves = run.of("solve")
    return sum(c["work"] for c in solves) / run.window_s if solves else None
