"""paddle_tpu_torch.serve — continuous-batching LLM serving engine.

Counterpart of ``paddle_tpu/serve``: ``engine.py`` (admission, eviction,
prefix cache, decode bursts over the paged KV pool and the paged decode
kernel), ``load.py`` (Poisson load generator and the serving setup),
``pool.py`` and ``prefix.py`` (block bookkeeping).
"""
from .engine import Request, ServeEngine
from .load import LoadResult, default_serving_setup, run_load, warm_engine
from .pool import BlockPool, PoolExhaustedError
from .prefix import PrefixCache

__all__ = ["ServeEngine", "Request", "BlockPool", "PoolExhaustedError",
           "PrefixCache", "run_load", "LoadResult", "default_serving_setup",
           "warm_engine"]
