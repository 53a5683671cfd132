"""The device: the share of the traced window in which no kernel or copy
ran (one minus the union of their intervals), in the solve cells."""


def read(run):
    return run.idle_pct() if run.of("solve") else None
