"""ops/resident.py: the removal base's resident delta after the cluster
changed (the program's ``delta`` phase), mean ms a what-if call."""


def read(run):
    return run.mean_phase_ms(("removals", "population"), ("delta",))
