"""The port's search engine (counterpart of ``repro.engine``)."""
from repro_torch.engine.engine import (EngineConfig, QueryStats, SearchEngine,
                                       SearchResult)
from repro_torch.engine.graphs import fused_cache_size
from repro_torch.engine.sharded import ShardedEngine

__all__ = ["EngineConfig", "QueryStats", "SearchEngine", "SearchResult",
           "ShardedEngine", "fused_cache_size"]
