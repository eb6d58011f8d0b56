from repro_torch.index.hyperplane_tree import HyperplaneTree
from repro_torch.index.knn import knn_refine, knn_refine_candidates, knn_select
from repro_torch.index.laesa import LaesaIndex
from repro_torch.index.nsimplex_index import NSimplexIndex
from repro_torch.index.stats import QueryStats

__all__ = [
    "HyperplaneTree",
    "LaesaIndex",
    "NSimplexIndex",
    "QueryStats",
    "knn_refine",
    "knn_refine_candidates",
    "knn_select",
]
