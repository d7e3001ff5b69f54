"""``step_ms``: the window's host time, from the device sync after warm-up
to the device sync after the last step, over the steps issued in it."""


def read(stats):
    return stats.step_ms
