"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): the
decentralized training step, timed on the card and checked against a plain
reference. ``python3 perfbench/run.py --help`` runs one cell."""
