"""``qg_step_roofline_pct``: the least time of ``qg_step`` (its bytes,
``yardstick.qg_step_bytes``, over the card's HBM bandwidth) over the
device time in which it ran (the union of its launches' intervals), a
traced step; none where no ``qg_step`` ran."""

from perfbench.yardstick import H100_HBM_BYTES_PER_S, qg_step_bytes


def read(stats):
    t = stats.trace
    if t is None:
        return None
    launches = [k for k in t.kernels if "qg_step" in k[0]]
    if not launches:
        return None
    least_s = qg_step_bytes(stats.elements) / H100_HBM_BYTES_PER_S
    return 100.0 * least_s * t.steps / t.busy_s(launches)
