"""The paper's five exact mechanisms behind one engine, and n-simplex retrieval."""

from repro_torch.search.engine import MECHANISMS, ExactSearchEngine, SearchReport
from repro_torch.search.retrieval import NSimplexRetriever

__all__ = ["ExactSearchEngine", "MECHANISMS", "SearchReport", "NSimplexRetriever"]
