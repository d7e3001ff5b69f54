"""``model_device_ms``: device time a traced step in which a kernel other
than the optimizer's ``qg_step`` ran (the union of their intervals),
copies and fills left out: the model's forward and backward, the loss,
and the step's metric reductions."""


def read(stats):
    t = stats.trace
    if t is None:
        return None
    kept = [k for k in t.kernels if "qg_step" not in k[0]]
    return t.busy_s(kept) * 1e3 / t.steps if kept else None
