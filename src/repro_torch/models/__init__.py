"""Model code of the port: the shared layers, attention and the
attention-only decoder LM (``transformer.py``)."""
