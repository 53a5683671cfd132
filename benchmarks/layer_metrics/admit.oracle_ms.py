"""scheduling/fastpath.py: the host's re-derivation of the score (the
program's ``oracle`` phase), mean ms an attempt."""


def read(run):
    return run.mean_phase_ms(("admit",), ("oracle",))
