"""ops/tensorize.py: the host compile of a solve (the program's
``partition`` and ``compile`` phases), mean ms a solve."""


def read(run):
    return run.mean_phase_ms(("solve",), ("partition", "compile"))
