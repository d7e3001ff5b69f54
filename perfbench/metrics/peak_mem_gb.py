"""``peak_mem_gb``: ``torch.cuda.max_memory_allocated()`` over the window,
the peak statistics reset when it opens, in 1e9 bytes."""


def read(stats):
    return stats.peak_bytes / 1e9 if stats.peak_bytes else None
