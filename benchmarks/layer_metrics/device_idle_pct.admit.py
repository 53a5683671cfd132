"""The device: the share of the traced window in which no kernel or copy
ran, in the admission cell."""


def read(run):
    return run.idle_pct() if run.of("admit") else None
