from repro_torch.data.graph_sampler import NeighborSampler
from repro_torch.data.pipeline import ShardedBatchPipeline
from repro_torch.data.synthetic import (
    colors_like,
    cora_like,
    criteo_like_batch,
    default_vocab_sizes,
    load_or_generate_colors,
    molecule_batch,
    random_graph,
    token_stream,
    uniform_cube,
    user_history_batch,
)

__all__ = [
    "colors_like",
    "uniform_cube",
    "load_or_generate_colors",
    "token_stream",
    "criteo_like_batch",
    "default_vocab_sizes",
    "user_history_batch",
    "random_graph",
    "cora_like",
    "molecule_batch",
    "NeighborSampler",
    "ShardedBatchPipeline",
]
