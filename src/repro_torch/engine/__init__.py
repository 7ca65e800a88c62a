"""The port's search engine (counterpart of ``repro.engine``)."""
from repro_torch.engine.engine import (EngineConfig, QueryStats, SearchEngine,
                                       SearchResult)

__all__ = ["EngineConfig", "QueryStats", "SearchEngine", "SearchResult"]
