"""ops/resident.py: the fast path's resident refresh (the program's
``delta`` phase), mean ms an attempt."""


def read(run):
    return run.mean_phase_ms(("admit",), ("delta",))
