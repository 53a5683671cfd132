"""The link: the wait for the card and the fetch of the verdict rows (the
program's ``device_block`` phase), mean ms a what-if call."""


def read(run):
    return run.mean_phase_ms(("removals", "population"), ("device_block",))
