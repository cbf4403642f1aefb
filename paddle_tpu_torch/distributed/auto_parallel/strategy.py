"""The auto-parallel ``Strategy``: sharding, amp, recompute, pipeline,
gradient-merge and fused-pass sub-configs read by ``DistModel`` and
``Engine``.

Counterpart of ``paddle_tpu/distributed/auto_parallel/strategy.py`` (a
copy: it is pure Python).
"""
from __future__ import annotations

__all__ = ["Strategy"]


class _Config:
    def __init__(self, **defaults):
        self.__dict__.update(defaults)

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class ShardingConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, stage=1, degree=8,
                         overlap_grad_comm=False)


class AmpConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, dtype="bfloat16", level="O1",
                         init_loss_scaling=32768.0, use_master_weights=True)


class RecomputeConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, refined_ops_patterns=[])


class PipelineConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, schedule_mode="1F1B",
                         micro_batch_size=1, accumulate_steps=1,
                         vpp_degree=1)


class GradientMergeConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, k_steps=1, avg=True)


class FusedPassesConfig(_Config):
    def __init__(self):
        super().__init__(enable=False, fused_passes_list=[])


class Strategy:
    """Reference: auto_parallel/strategy.py Strategy — a bag of feature
    sub-configs read by DistModel/Engine."""

    def __init__(self, config=None):
        self.sharding = ShardingConfig()
        self.amp = AmpConfig()
        self.recompute = RecomputeConfig()
        self.pipeline = PipelineConfig()
        self.gradient_merge = GradientMergeConfig()
        self.fused_passes = FusedPassesConfig()
        if config:
            for section, values in dict(config).items():
                target = getattr(self, section, None)
                if target is not None and isinstance(values, dict):
                    target.__dict__.update(values)

    def __repr__(self):
        return (f"Strategy(sharding={self.sharding}, amp={self.amp}, "
                f"recompute={self.recompute}, pipeline={self.pipeline})")
