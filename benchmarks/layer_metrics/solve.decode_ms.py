"""scheduling/solver.py: the decode of the pack's outputs into nodes and
placements (the program's ``decode`` phase), mean ms a solve."""


def read(run):
    return run.mean_phase_ms(("solve",), ("decode",))
