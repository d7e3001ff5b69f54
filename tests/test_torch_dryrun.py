"""The port's dry run, roofline, rebuild and report
(``repro_torch.launch.dryrun`` / ``roofline`` / ``rebuild`` / ``report``) on
the CPU, against the JAX package's modules of the same names where the two
compute the same thing.

* ``model_flops``, ``extrapolate``, ``roofline_terms`` and ``summarize``
  under ``roofline.V5E`` equal the reference's (exactly) for every arch and
  input shape, on the same probe costs.
* The probe extrapolation equals the full-depth count on ``meta`` exactly
  for a dense arch (the port runs every period in turn, so each trace
  counts them all).
* ``run_combo`` on ``meta`` for reduced TinyLlama, granite-moe and zamba2
  train steps and a gemma2 decode step: the reference's record keys,
  nonzero flops, nonzero wire bytes where nodes gossip, per-rank memory
  with ``fits``, the ignored knobs.
* On the production mesh with the split knobs: granite-moe-3b's,
  musicgen-medium's and arctic-480b's attention heads split though 16
  does not divide them, with no attention weight gathered along 'model';
  zamba2's SSM heads split
  with no ``in_proj`` / ``out_proj`` byte gathered, mamba2-130m's block
  named whole (its 24 SSM heads do not divide 16); their pinned decodes
  gather ``in_proj`` / ``out_proj`` over 'data' alone and no ``conv_w``.
* ``rebuild`` round-trips a record, and on a record without a hardware key
  gives the reference's ``rebuild``.
* The report's four tables equal the reference's markdown on the same
  records and bench files; the port's per-rank ``memory_table``; the
  dry-run and report CLIs.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun.py``.
"""
from __future__ import annotations

import dataclasses
import json
import shutil

import pytest
import torch

from repro.configs import INPUT_SHAPES as JSHAPES, get_config as jget_config
from repro.launch import rebuild as jrebuild
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, rebuild, report, roofline, \
    sharding, steps
from repro_torch.launch.mesh import MeshShape
from repro_torch.tree import tree_leaves, tree_paths

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: the keys of the reference's records (src/repro/launch/dryrun.py)
REFERENCE_KEYS = {"arch", "shape", "mesh", "n_chips", "n_nodes", "node_axis",
                  "kind", "gossip", "variant", "overrides", "timestamp",
                  "ssd_chunk", "full_compile_s", "memory_analysis",
                  "probe1_compile_s", "probe2_compile_s", "costs_per_chip",
                  "roofline", "model_flops", "useful_flops_ratio", "probe1",
                  "probe2"}

MESH4 = MeshShape((("data", 4),))


def _probe_pair(module, seed: int):
    """Two probe costs of ``module``'s ``ProbeCost`` with every field set
    (the 2-period one larger in some kinds and smaller in another, so the
    clamp at zero is exercised)."""
    out = []
    for k in (1, 2):
        per_kind = {kind: float(seed * (i + 1) * (3 if k == 2 else 2)
                                - (5 * k if kind == "all-to-all" else 0))
                    for i, kind in enumerate(KINDS)}
        detail = {"per_kind_bytes": per_kind,
                  "counts": {kind: k for kind in KINDS},
                  "total_link_bytes": sum(per_kind.values())}
        out.append(module.ProbeCost(
            flops=1.5e12 * seed * k + 7.0, bytes_accessed=3e9 * (k + seed),
            collective_bytes=detail["total_link_bytes"],
            collective_detail=detail))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_roofline_arithmetic_equals_reference_under_v5e(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert set(INPUT_SHAPES) == set(JSHAPES)
    for i, name in enumerate(sorted(INPUT_SHAPES)):
        shape, jshape = INPUT_SHAPES[name], JSHAPES[name]
        for n_chips in (1, 16, 256):
            assert roofline.model_flops(cfg, shape, n_chips=n_chips) == \
                jroofline.model_flops(jcfg, jshape, n_chips=n_chips)
        p1, p2 = _probe_pair(roofline, i + 1)
        j1, j2 = _probe_pair(jroofline, i + 1)
        costs = roofline.extrapolate(p1, p2, cfg.n_periods)
        assert costs == jroofline.extrapolate(j1, j2, cfg.n_periods)
        assert roofline.roofline_terms(costs, hw=roofline.V5E) == \
            jroofline.roofline_terms(costs)
        extra = {"probe1": dataclasses.asdict(p1)}
        got = roofline.summarize(cfg, shape, n_chips=256, probe1=p1,
                                 probe2=p2, n_periods=cfg.n_periods,
                                 memory_analysis="m", extra=extra,
                                 hw=roofline.V5E)
        want = jroofline.summarize(jcfg, jshape, n_chips=256, probe1=j1,
                                   probe2=j2, n_periods=jcfg.n_periods,
                                   memory_analysis="m", extra=extra)
        assert got == want, (arch, name)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == \
        (jroofline.PEAK_FLOPS, jroofline.HBM_BW, jroofline.ICI_BW)


def test_h100_terms_take_the_dtype_peak():
    costs = {"flops": 989e12, "bytes_accessed": 3.35e12,
             "collective_bytes": 45e9}
    bf16 = roofline.roofline_terms(costs, dtype=torch.bfloat16)
    assert bf16["compute_s"] == 1.0 and bf16["memory_s"] == 1.0
    assert bf16["collective_s"] == 0.1
    fp32 = roofline.roofline_terms(costs, hw=roofline.H100,
                                   dtype=torch.float32)
    assert fp32["compute_s"] == 989e12 / 67e12
    assert fp32["bottleneck"] == "compute"
    assert roofline.H100.peak("tf32") == 495e12
    assert roofline.wire_bytes("dense", n=1, node_bytes=8.0, sites=1) == {}
    assert roofline.wire_bytes("dense", n=4, node_bytes=8.0, sites=1) == \
        {"all-gather": 8.0}
    assert roofline.wire_bytes("sparse", n=4, node_bytes=8.0, sites=1,
                               messages_per_step=8.0) == \
        {"collective-permute": 16.0}


def _sc(arch: str, n: int, n_layers: int | None = None, kind="train"):
    cfg = get_config(arch, reduced=True)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return steps.StepConfig(cfg=cfg, shape=InputShape("tiny", 32, 2 * n,
                                                      kind),
                            n_nodes=n, chunk=16, ssd_chunk=16)


def test_probe_extrapolation_is_exact_for_a_dense_arch():
    """probe1 + (T-1)(probe2 - probe1) equals the full-depth trace's flops
    and bytes exactly (TinyLlama cut to 5 layers, 2 nodes)."""
    sc = _sc("tinyllama-1.1b", 2, n_layers=5)
    plan = sharding.make_plan(MeshShape((("data", 2),)), n_nodes=2)
    full = dryrun.trace_step(sc, plan)
    probes = []
    for k in (1, 2):
        c = dryrun.trace_step(dataclasses.replace(
            sc, cfg=dryrun.probe_cfg(sc.cfg, k)), plan, memory=False)
        detail = roofline.collective_detail(c["wire"])
        probes.append(roofline.ProbeCost(c["flops"], c["bytes_accessed"],
                                         detail["total_link_bytes"],
                                         detail))
    ext = roofline.extrapolate(*probes, sc.cfg.n_periods)
    assert ext["flops"] == full["flops"] > 0
    assert ext["bytes_accessed"] == full["bytes_accessed"] > 0
    assert ext["collective_bytes"] == sum(full["wire"].values()) > 0


@pytest.mark.parametrize("arch,kind", [
    ("tinyllama-1.1b", "train"), ("granite-moe-3b-a800m", "train"),
    ("zamba2-7b", "train"), ("gemma2-27b", "decode")])
def test_run_combo_on_meta(arch, kind, tmp_path):
    cfg = get_config(arch, reduced=True)
    shape = InputShape(f"tiny_{kind}", 64 if kind == "train" else 256, 8,
                       kind)
    rec = dryrun.run_combo(arch, shape.name, "tiny", out_dir=str(tmp_path),
                           cfg=cfg, shape=shape, mesh=MESH4,
                           overrides={"chunk": 32, "ssd_chunk": 32})
    assert REFERENCE_KEYS <= set(rec)
    assert rec["ignored"] == list(steps.IGNORED_KNOBS) == ["unroll"]
    assert rec["n_chips"] == 4 and rec["hardware"] == "h100-sxm5"
    want_nodes = 4 if kind == "train" else 1
    assert rec["n_nodes"] == want_nodes
    assert rec["node_axis"] == ("data" if want_nodes > 1 else None)
    assert rec["costs_per_chip"]["flops"] > 0
    assert rec["costs_per_chip"]["bytes_accessed"] > 0
    # train: the gossip; decode (one node, FSDP over 'data'): the gathers
    # of the weights and the caches
    wire = rec["costs_per_chip"]["collective_bytes"]
    assert wire > 0
    mem = rec["memory"]
    assert rec["fits"] is True and mem["fits"] is True
    assert mem["total"] == mem["argument"] + mem["temp"]
    assert mem["temp"] > 0 and "fits=yes" in rec["memory_analysis"]
    sc = steps.StepConfig(cfg=cfg, shape=shape, n_nodes=want_nodes,
                          chunk=32, ssd_chunk=32)
    layout = steps.Layout.make(sc, MESH4, kind=kind)
    plan = layout.plan
    assert plan == sharding.make_plan(MESH4, n_nodes=want_nodes)
    held = [(layout.shapes[w], layout.specs[w]) for w in layout.specs]
    if kind == "train":
        per_node = sum(l.numel() * l.element_size() for l in tree_leaves(
            steps.params_shape(sc, node_stacked=False)))
        assert rec["probe1"]["collective_detail"]["per_kind_bytes"][
            "all-gather"] > 0
        assert wire == per_node   # one bf16 tree a step, dense gossip
    else:
        # the token's rows are in the layout's batch (a rank's 2 of 8)
        assert layout.specs["batch"] == {"token": ("data", None)}
        held.append(((steps.decode_specs(sc)["pos"],), ((),)))
        assert layout.placement is not None
    assert mem["argument"] == sum(sharding.bytes_per_rank(plan, t, s)
                                  for t, s in held)
    with open(tmp_path / f"{arch}__{shape.name}__tiny.json") as fh:
        assert json.load(fh)["memory_analysis"] == rec["memory_analysis"]


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_split_ssm_blocks_on_the_production_mesh(arch, tmp_path):
    """The reference's (16, 16) mesh with the three knobs, one period and
    the tail at published widths: zamba2's 112 SSM heads split 16 ways
    and a rank gathers no byte of ``in_proj`` / ``out_proj``; mamba2-130m's
    24 do not divide 16, so the record names its mamba block whole and the
    mixer's weights are gathered on use."""
    cfg = dryrun.probe_cfg(get_config(arch), 1)
    shape = InputShape("tiny_train", 256, 16, "train")
    rec = dryrun.run_combo(
        arch, shape.name, "production", out_dir=str(tmp_path), cfg=cfg,
        shape=shape, mesh=dryrun.MESHES["production"], full_only=True,
        overrides={"chunk": 128, "ssd_chunk": 64, "megatron_attn": True,
                   "shard_activations": True, "pin_moe_dispatch": True})
    assert rec["n_nodes"] == 16 and rec["node_axis"] == "data"
    split, gathered = rec["split"], rec["gathered"]
    assert split["features"] and split["vocab"] and not split["experts"]
    if arch == "zamba2-7b":
        assert split["heads"] and split["ssm"] and split["whole"] == []
        assert gathered.get("in_proj", 0) == gathered.get("out_proj", 0) == 0
        assert gathered["conv_w"] > 0
    else:
        assert not split["heads"] and not split["ssm"]
        assert split["whole"] == ["mamba: 24 SSM heads over 'model' 16"]
        assert gathered["in_proj"] > 0 and gathered["out_proj"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "musicgen-medium",
                                  "arctic-480b"])
def test_split_uneven_heads_on_the_production_mesh(arch, kind, tmp_path):
    """The (16, 16) mesh with the three knobs, one period at published
    widths: 24 (granite, musicgen) or 56 (arctic) heads do not divide 16,
    and the split takes them as GSPMD pads them (``Split.head_range``; the
    trace is rank 0's, with the most heads): ``heads`` on, no block named
    whole, and no byte of ``wq`` / ``wk`` / ``wv`` / ``wo`` gathered along
    'model' (a train step's nodes ride 'data', so nothing is gathered; a
    prefill's one node gathers its blocks over the FSDP axis 'data', at
    most 1/16 of their bytes)."""
    cfg = dryrun.probe_cfg(get_config(arch), 1)
    shape = InputShape(f"tiny_{kind}", 256, 16, kind)
    mesh = dryrun.MESHES["production"]
    knobs = {"chunk": 128, "megatron_attn": True, "shard_activations": True,
             "pin_moe_dispatch": True}
    rec = dryrun.run_combo(
        arch, shape.name, "production", out_dir=str(tmp_path), cfg=cfg,
        shape=shape, mesh=mesh, full_only=True, overrides=knobs)
    split, gathered = rec["split"], rec["gathered"]
    assert cfg.n_heads % 16
    assert split["heads"] and split["features"] and split["whole"] == []
    sc = steps.StepConfig(cfg=cfg, shape=shape, n_nodes=rec["n_nodes"],
                          **knobs)
    params = steps.Layout.make(sc, mesh, kind=kind).shapes["params"]
    whole = {}
    for path, leaf in zip(tree_paths(params), tree_leaves(params)):
        whole[path[-1]] = whole.get(path[-1], 0) + \
            leaf.numel() * leaf.element_size()
    for name in ("wq", "wk", "wv", "wo"):
        if kind == "train":
            assert gathered.get(name, 0) == 0, name
        else:
            assert gathered.get(name, 0) <= whole[name] / 16, name


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_split_ssm_decode_on_the_production_mesh(arch, tmp_path):
    """The same cut's pinned decode (``pin_decode_cache``) with the three
    knobs: the decode split takes both archs' mixers (a one-token state is
    cut by the cache's layout, not by heads), so a rank gathers
    ``in_proj`` / ``out_proj`` over 'data' alone (at most 1/16 of their
    bytes: zamba2's; mamba2-130m's ``in_proj`` is stored by 'model' alone,
    so nothing) and no ``conv_w`` byte ('model' stores it and the conv
    cache by the same channel block)."""
    cfg = dryrun.probe_cfg(get_config(arch), 1)
    shape = InputShape("tiny_decode", 256, 16, "decode")
    mesh = dryrun.MESHES["production"]
    knobs = {"megatron_attn": True, "shard_activations": True,
             "pin_moe_dispatch": True, "pin_decode_cache": True}
    rec = dryrun.run_combo(
        arch, shape.name, "production", out_dir=str(tmp_path), cfg=cfg,
        shape=shape, mesh=mesh, full_only=True, overrides=knobs)
    split, gathered = rec["split"], rec["gathered"]
    assert split["ssm"] and split["features"] and split["whole"] == []
    sc = steps.StepConfig(cfg=cfg, shape=shape, n_nodes=1, **knobs)
    params = steps.Layout.make(sc, mesh, kind="decode").shapes["params"]
    whole = {}
    for path, leaf in zip(tree_paths(params), tree_leaves(params)):
        whole[path[-1]] = whole.get(path[-1], 0) + \
            leaf.numel() * leaf.element_size()
    assert gathered.get("conv_w", 0) == 0
    if arch == "zamba2-7b":
        for name in ("in_proj", "out_proj"):
            assert 0 < gathered[name] <= whole[name] / 16, name
    else:
        assert gathered.get("in_proj", 0) == 0
        assert 0 < gathered["out_proj"] <= whole["out_proj"] / 16


def test_a_model_that_does_not_fit_gets_a_record(tmp_path):
    """arctic-480b's decode at the published size on one rank: a
    ``fits: false`` record, not an exception (full-only: the probes add
    nothing to the memory)."""
    rec = dryrun.run_combo("arctic-480b", "decode_32k", "single",
                           out_dir=str(tmp_path), full_only=True)
    assert rec["fits"] is False and "fits=no" in rec["memory_analysis"]
    assert rec["memory"]["argument"] > steps.H100_HBM_BYTES


def test_rebuild_round_trips_and_matches_reference(tmp_path):
    rec = dryrun.run_combo("tinyllama-1.1b", "train_4k", "single",
                           out_dir=str(tmp_path), probes_only=True)
    path = tmp_path / "tinyllama-1.1b__train_4k__single.json"
    before = path.read_text()
    assert rebuild.rebuild(str(path))
    after = json.loads(path.read_text())
    assert after == json.loads(before) == json.loads(json.dumps(
        rec, default=str))
    # a record of the reference's (no hardware key): V5E, as its rebuild
    ref = {k: v for k, v in after.items() if k not in ("hardware", "dtype")}
    for name in ("port.json", "ref.json"):
        with open(tmp_path / name, "w") as fh:
            json.dump(ref, fh)
    assert rebuild.rebuild(str(tmp_path / "port.json"))
    assert jrebuild.rebuild(str(tmp_path / "ref.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())
    (tmp_path / "no_probe.json").write_text("{}")
    assert not rebuild.rebuild(str(tmp_path / "no_probe.json"))


def _bench_files(tmp_path):
    serve = [{"name": "serve/engine", "tokens_per_s": 812.5,
              "p50_token_ms": 1.25, "p95_token_ms": 2.5,
              "peak_cache_bytes": 1 << 20, "mismatches": 0},
             {"name": "serve/sequential", "tokens_per_s": 301.0,
              "p50_token_ms": 3.5, "p95_token_ms": 4.0}]
    kernels = [{"name": "kernels/fused", "us_per_call": 12.5,
                "bytes_moved_per_step": 1000, "mismatches": 0},
               {"name": "kernels/unfused", "us_per_call": 30.0,
                "bytes_moved_per_step": 4000, "jnp_ref_us": 31.5},
               {"name": "other/row", "us_per_call": 1.0}]
    for name, rows in (("serve.json", serve), ("kernels.json", kernels)):
        with open(tmp_path / name, "w") as fh:
            json.dump(rows, fh)
    return str(tmp_path / "serve.json"), str(tmp_path / "kernels.json")


def test_report_tables_equal_reference_and_clis(tmp_path, capsys):
    out = tmp_path / "dr"
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k,long_500k",
                 "--mesh", "both", "--out", str(out)])
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                 "--probes-only", "--out", str(out), "--gossip",
                 "sparse_ppermute"])
    shutil.copy(out / "mamba2-130m__decode_32k__single.json",
                out / "mamba2-130m__decode_32k__single__v1.json")
    with open(out / "mamba2-130m__decode_32k__single__v1.json") as fh:
        rec = json.load(fh)
    rec["variant"] = "v1"
    with open(out / "mamba2-130m__decode_32k__single__v1.json", "w") as fh:
        json.dump(rec, fh)
    recs, jrecs = report.load(str(out)), jreport.load(str(out))
    assert recs == jrecs and len(recs) == 6
    for mesh in ("single", "multi"):
        for gossip in (None, "sparse_ppermute"):
            assert report.roofline_table(recs, mesh, gossip) == \
                jreport.roofline_table(jrecs, mesh, gossip)
    table = report.dryrun_table(recs)
    assert table == jreport.dryrun_table(jrecs)
    assert "fits=yes" in table and "argument=" in table
    serve, kernels = _bench_files(tmp_path)
    for path in (serve, str(tmp_path / "absent.json")):
        assert report.serve_table(path) == jreport.serve_table(path)
    for path in (kernels, str(tmp_path / "absent.json")):
        assert report.kernels_table(path) == jreport.kernels_table(path)
    capsys.readouterr()
    report.main(["--dir", str(out), "--what", "all", "--bench-serve", serve,
                 "--bench-kernels", kernels])
    got = capsys.readouterr().out
    jreport.main(["--dir", str(out), "--what", "all", "--bench-serve",
                  serve, "--bench-kernels", kernels])
    assert got == capsys.readouterr().out
    report.main(["--dir", str(out), "--what", "both", "--out",
                 str(tmp_path / "r.md")])
    assert (tmp_path / "r.md").read_text().startswith("| arch |")
    # the port's own per-rank table: single / multi side by side, the
    # baseline dense records with a memory entry only
    rows = report.memory_table(recs).splitlines()[2:]
    assert [r.split(" | ")[:2] for r in rows] == [
        ["| mamba2-130m", "decode_32k"], ["| mamba2-130m", "long_500k"]]
    assert all(" yes / yes " in r for r in rows)
    dec = next(r for r in recs if r["shape"] == "decode_32k"
               and r["mesh"] == "single" and r["variant"] == "baseline")
    assert f"{dec['memory']['argument'] / 1e9:.1f} / " in rows[0]
