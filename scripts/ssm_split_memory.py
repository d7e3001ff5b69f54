#!/usr/bin/env python3
"""A rank's memory and wire for zamba2-7b's blocks under the compute split
over 'model', on the reference's (16, 16) production mesh (``meta``
tensors, no card).

    PYTHONPATH=src python3 scripts/ssm_split_memory.py

With ``megatron_attn``, ``shard_activations`` and ``pin_moe_dispatch``,
one period and the tail at the published widths, it traces
(``launch/dryrun.trace_step``):

* ``prefill_32k`` with the shared attention block, without it, and with
  the block's 512-key chunks or ``skip_masked_chunks``: which part sets
  the prefill's peak;
* ``train_4k`` and ``prefill_32k`` of the Mamba layers alone (no shared
  block) by two routes for ``in_proj``'s stored column blocks, which do
  not line up with the SSM heads: the port's (``Split.regroup``, one
  all-to-all into the rank's z, x and dt, B and C summed whole) and the
  projection made whole for a moment by an all-gather and cut.

Prints one JSON line a trace: its temp bytes a rank and its wire bytes by
collective kind.  About a minute on 8 CPU cores.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KNOBS = dict(megatron_attn=True, shard_activations=True,
             pin_moe_dispatch=True)


def _whole_route(params, x, cfg, split, state, key):
    """``ssm._rank_proj``'s alternative: the projection all-gathered whole
    for the rank's own use, then cut to its z, x and dt and the whole B
    and C."""
    import torch
    m, r = split.size, split.index
    d_model = split.cfg.d_model
    di, nh, n = cfg.d_inner(d_model), cfg.n_heads(d_model), cfg.d_state
    y, ys = split.linear(x, state, params["in_proj"], key + ("in_proj",))
    parts = split.enter(y, ys).split(
        [di // m] * (2 * m) + [n, n] + [nh // m] * m, dim=-1)
    w = split.copy(params["conv_w"]).split([di // m] * m + [n, n], dim=-1)
    return (parts[r].contiguous(),
            torch.cat([parts[m + r], parts[2 * m], parts[2 * m + 1]], -1),
            parts[2 * m + 2 + r], torch.cat([w[r], w[m], w[m + 1]], -1))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun, sharding, steps
    from repro_torch.models import ssm

    mesh = dryrun.MESHES["production"]
    cfg = dryrun.probe_cfg(get_config("zamba2-7b"), 1)
    mambas = dataclasses.replace(cfg, shared_attn_every=0)
    regroup = ssm._rank_proj

    def trace(label, cfg, shape_name, route=regroup, **kw):
        shape = INPUT_SHAPES[shape_name]
        nodes = 16 if shape.kind == "train" else 1
        sc = steps.StepConfig(cfg=cfg, shape=shape, n_nodes=nodes,
                              ssd_chunk=256 if nodes > 1 else 2048,
                              **KNOBS, **kw)
        ssm._rank_proj = route
        try:
            rec = dryrun.trace_step(sc, sharding.make_plan(mesh,
                                                           n_nodes=nodes))
        finally:
            ssm._rank_proj = regroup
        print(json.dumps({"trace": label, "shape": shape_name,
                          "temp": rec["temp"], "wire": rec["wire"]}),
              flush=True)

    trace("with the shared block", cfg, "prefill_32k")
    trace("without the shared block", mambas, "prefill_32k")
    trace("shared block, 512-key chunks", cfg, "prefill_32k", chunk=512)
    trace("shared block, skip_masked_chunks", cfg, "prefill_32k",
          skip_masked_chunks=True)
    for shape_name in ("train_4k", "prefill_32k"):
        trace("mamba layers, all-to-all route", mambas, shape_name)
        trace("mamba layers, whole-projection route", mambas, shape_name,
              route=_whole_route)
    return 0


if __name__ == "__main__":
    sys.exit(main())
