"""Topology, dense gossip, the transform algebra and the optimizers."""
