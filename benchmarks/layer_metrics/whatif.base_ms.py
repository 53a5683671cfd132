"""The consolidation what-ifs' removal base: its fingerprint, cache lookup
and compile (the program's ``other`` and ``partition`` phases), mean ms a
what-if call."""


def read(run):
    return run.mean_phase_ms(("removals", "population"), ("other", "partition"))
