"""The host runtime: the garbage collector's pauses over the window (the
harness's ``gc.callbacks``), summed, ms a solve."""


def read(run):
    solves = run.of("solve")
    return 1e3 * sum(run.gc_pauses) / len(solves) if solves else None
