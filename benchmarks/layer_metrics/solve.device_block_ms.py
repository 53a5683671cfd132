"""The link: the wait for the card and the fetch of the pack's outputs
(the program's ``device_block`` phase), mean ms a solve."""


def read(run):
    return run.mean_phase_ms(("solve",), ("device_block",))
