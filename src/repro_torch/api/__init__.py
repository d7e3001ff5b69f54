"""Declarative experiment API of the port.

    from repro_torch import api

    spec = api.presets.get("quickstart_ring16_alpha0.1_qg")
    result = api.run(spec)                      # on the CUDA device
    result = api.run(spec, device="cpu")        # on the CPU
    print(result.final["acc"], result.device)

The spec is the reference's (``repro.api``), so its JSON loads unchanged.
``api.run(spec, mesh=node_mesh)`` runs it on the sharded or hybrid runtime
over a ``torch.distributed`` node axis (``repro_torch.launch.mesh``).
"""
from . import data, models, presets, spec
from .build import Experiment, Result, build, run, wire_stats
from .models import MODELS, ModelBundle, register_model
from .spec import (CommSpec, DataSpec, EvalSpec, ExperimentSpec, GossipSpec,
                   LoopSpec, ModelSpec, OptimSpec, ScenarioSpec,
                   TelemetrySpec, TopologySpec, apply_overrides)

__all__ = [
    "ExperimentSpec", "DataSpec", "TopologySpec", "OptimSpec", "CommSpec",
    "GossipSpec", "LoopSpec", "EvalSpec", "ModelSpec", "TelemetrySpec",
    "ScenarioSpec", "apply_overrides", "build", "run", "wire_stats",
    "Experiment", "Result", "MODELS", "ModelBundle", "register_model",
    "presets", "spec", "models", "data",
]
