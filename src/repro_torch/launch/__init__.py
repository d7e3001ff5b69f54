"""Launchers of the port (``launch/serve.py``, ``launch/train.py``), the
multi-rank set-up (``distributed.py``, ``mesh.py``) and the launch tooling:
step builders (``steps.py``), the node axis's layout (``sharding.py``),
the dry run, its roofline and tables (``dryrun.py``, ``roofline.py``,
``rebuild.py``, ``report.py``)."""
