"""Telemetry: so far :class:`~repro_torch.telemetry.trace.StepTimer`, the
serving engine's per-phase host timer."""
