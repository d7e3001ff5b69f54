"""``device_idle_pct``: the share of the traced window in which no kernel,
copy or fill ran on the device (the union of their intervals)."""


def read(stats):
    t = stats.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
