"""Mixture-of-experts gates and layers of the port.

Counterpart of ``paddle_tpu/incubate/distributed/models/moe``, with the
same exports: the gates (``gate.py``) and the layers (``moe_layer.py``).
Expert parallelism waits for ``ROADMAP.md`` queue A item 4: the layers
take ``moe_group=None`` only.
"""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import ExpertsFFN, FusedMoELayer, MoELayer  # noqa: F401

__all__ = [
    "MoELayer", "FusedMoELayer", "ExpertsFFN",
    "BaseGate", "NaiveGate", "GShardGate", "SwitchGate",
]
