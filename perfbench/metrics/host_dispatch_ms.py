"""``host_dispatch_ms``: the host's time inside ``trainer.step`` a step of
the untraced window, by the host clock: what it costs the host to issue
one decentralized step (the eager, vmapped model and the optimizer's
launches). ``put_batch`` is left out: its copy from pageable memory waits
for the device."""


def read(stats):
    return stats.dispatch_s * 1e3 / stats.steps
