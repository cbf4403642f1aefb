"""Distributed training surface of the port (``fleet.utils.recompute`` so
far)."""
