"""scheduling/solver.py: the compile cache's fingerprint and lookup and the
rest of the solve's own host work (the program's ``other`` phase), mean ms
a solve."""


def read(run):
    return run.mean_phase_ms(("solve",), ("other",))
