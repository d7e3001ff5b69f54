"""``mfu_pct``: the model's FLOPs a step (counted from the configuration's
shapes by its ``reference/<family>.py``) over ``step_ms`` of the same
run's untraced window, against the card's fp32 peak (TF32 is off in the
port)."""

from perfbench.yardstick import H100_FP32_FLOPS


def read(stats):
    if not stats.flops_per_step:
        return None
    return 100.0 * stats.flops_per_step / (stats.step_ms / 1e3) \
        / H100_FP32_FLOPS
