"""Launchers of the port: so far ``launch/serve.py``."""
