"""Launchers of the port: ``launch/serve.py`` and ``launch/train.py``, and
the multi-rank set-up (``distributed.py``, ``mesh.py``)."""
