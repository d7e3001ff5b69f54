"""``setup_s``: process start to the first timed step: imports, the
kernels' build or load, the trainer, the weights, the batches, the three
checked steps and the warm-up."""


def read(stats):
    return stats.setup_s
