"""ops/resident.py: the resident state's delta and refresh (the program's
``delta`` phase), mean ms a solve."""


def read(run):
    return run.mean_phase_ms(("solve",), ("delta",))
