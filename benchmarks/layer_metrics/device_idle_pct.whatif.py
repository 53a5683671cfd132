"""The device: the share of the traced window in which no kernel or copy
ran, in the what-if cell."""


def read(run):
    return run.idle_pct() if run.of("removals", "population") else None
