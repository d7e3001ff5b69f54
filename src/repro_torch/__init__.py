"""PyTorch/CUDA port of the decentralized quasi-global momentum system.

This package mirrors ``src/repro`` (the JAX package, which stays the
reference) module for module: ``repro_torch/core/transforms.py`` stands
against ``repro/core/transforms.py`` and so on.  It imports ``torch`` and
``numpy`` only, never ``jax`` nor anything of ``repro``.

Ported so far: slice 1, the main path -- the quickstart presets end to end:
synthetic classification data with a Dirichlet split, the ring topology,
dense gossip, the DSGD/DSGDm/QG-DSGDm chains with the fused optimizer
passes as hand-written CUDA kernels (``kernels/csrc/qg_update.cu``), the
MLP, the vmap trainer and the spec/preset/``run`` API; and slice 3,
compressed gossip (``comm/``: CHOCO and error feedback with top-k,
random-k, sign+norm and QSGD), whose three passes are CUDA kernels too
(``kernels/csrc/compress.cu``); and slice 7, continuous-batching serving
(``serve/``, ``launch/serve.py``) over the attention-only decoder LM
(``configs/``, ``models/``), whose flash and paged-decode attention are
CUDA kernels (``kernels/csrc/attention.cu``); and slice 6b-i, the Mamba-2
mixer (``models/ssm.py``) with its prefill through the SSD scan as a CUDA
kernel (``kernels/csrc/ssd_scan.cu``) and its O(1)-state decode; and
slice 2, the rest of the optimizer zoo (all 20 registry entries and the
``OptimSpec.stages`` chains), the social, exponential, torus, star and
complete topologies with the ``social32``/``exp16`` presets, and the
gradient-free consensus experiments (``core/consensus.py``); and slices 4
and 5, ResNet-20 and the CV protocol, telemetry and checkpoints; and slice
6b-ii, decentralized LM training (the ``lm_domains`` data, the
``transformer`` plugin, the ``lm100m_ring8_alpha0.1_qg`` preset) with the
run's consensus model exported for serving; and slice 8a, the thousand-node
scenario engine (``scenario/``: generated graphs, client sampling, churn
and stragglers with masks bit-equal to the reference's, the masked dense
gossip and the ``n1024_*`` presets); and slice 8b, the sparse and block
gossip schedules (``core/gossip.py``), the sharded and hybrid runtimes
over a ``torch.distributed`` node axis (``runtime/``, ``launch/mesh.py``,
``launch/distributed.py``) and the delayed gossip
(``runtime/overlap.py``).

Entry points (``api.build``, ``api.run``, ``python -m repro_torch.api``
with ``--export-consensus``, ``python -m repro_torch.serve``, ``python -m
repro_torch.launch.train`` and ``python -m repro_torch.launch.serve``) run
on the CUDA device unless the caller passes ``device="cpu"``; there the
kernels' plain PyTorch versions serve the CPU tensors.
"""
