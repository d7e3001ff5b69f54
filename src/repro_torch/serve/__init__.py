"""Consensus serving stack: export -> continuous-batching inference.

Port of ``repro/serve``: :func:`export_consensus` collapses a node-stacked
training run (an ``api.Result`` with its final state, a state or a
checkpoint) into the single consensus model, and
:class:`ServeEngine` serves it with continuous request batching over a
paged KV cache, on the card through the paged-decode kernel with
``use_pallas=True``.

    from repro_torch import serve
    params, cfg = serve.load_serving_checkpoint("model.npz")  # on cuda
    eng = serve.ServeEngine(params, cfg, n_slots=8, use_pallas=True)
    outs = eng.run([serve.Request(id=0, prompt=(1, 2, 3), max_new=16)])

CLI: ``python -m repro_torch.serve --help``.
"""
from .engine import Completion, Request, ServeEngine, sequential_generate
from .export import (config_from_dict, config_to_dict, consensus_params,
                     export_consensus, load_serving_checkpoint,
                     params_from_train_checkpoint, resolve_config,
                     save_serving_checkpoint)
from .kvcache import PagedKVCache

__all__ = [
    "Completion", "Request", "ServeEngine", "sequential_generate",
    "PagedKVCache",
    "consensus_params", "export_consensus", "params_from_train_checkpoint",
    "resolve_config", "save_serving_checkpoint", "load_serving_checkpoint",
    "config_to_dict", "config_from_dict",
]
