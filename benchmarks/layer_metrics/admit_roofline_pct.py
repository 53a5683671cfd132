"""The kernels: ``admit_kernel``'s least time (roofline/admit_kernel.py)
over its device time in the trace, over the attempts the check re-derived
that launched it."""


def read(run):
    return run.roofline_pct("admit_kernel", lambda name: "admit_kernel" in name)
