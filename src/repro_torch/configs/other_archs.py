"""GNN + RecSys assigned architectures, plus the paper's own serving config."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchSpec, gnn_shapes, recsys_shapes, register
from repro_torch.models.gcn import GCNConfig
from repro_torch.models.recsys import RecsysConfig


@register("gcn-cora")
def gcn_cora() -> ArchSpec:
    cfg = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, aggregator="mean")
    smoke = GCNConfig(name="gcn-cora-smoke", n_layers=2, d_hidden=8, d_feat=32, n_classes=4)
    return ArchSpec(
        "gcn-cora",
        "gnn",
        "[arXiv:1609.02907; paper]",
        cfg,
        gnn_shapes(),
        smoke,
    )


@register("fm")
def fm() -> ArchSpec:
    cfg = RecsysConfig(name="fm", interaction="fm-2way", n_sparse=39, embed_dim=10)
    smoke = dataclasses.replace(
        cfg, name="fm-smoke", n_sparse=6, vocab_sizes=(50, 40, 30, 20, 10, 8)
    )
    return ArchSpec(
        "fm", "recsys", "[ICDM'10 (Rendle); paper]", cfg, recsys_shapes(), smoke
    )


@register("xdeepfm")
def xdeepfm() -> ArchSpec:
    cfg = RecsysConfig(
        name="xdeepfm",
        interaction="cin",
        n_sparse=39,
        embed_dim=10,
        cin_layers=(200, 200, 200),
        mlp_dims=(400, 400),
    )
    smoke = dataclasses.replace(
        cfg,
        name="xdeepfm-smoke",
        n_sparse=6,
        vocab_sizes=(50, 40, 30, 20, 10, 8),
        cin_layers=(8, 8),
        mlp_dims=(16,),
    )
    return ArchSpec(
        "xdeepfm", "recsys", "[arXiv:1803.05170; paper]", cfg, recsys_shapes(), smoke
    )


@register("mind")
def mind() -> ArchSpec:
    cfg = RecsysConfig(
        name="mind",
        interaction="multi-interest",
        embed_dim=64,
        n_interests=4,
        capsule_iters=3,
        seq_len=50,
        n_items=1_000_000,
    )
    smoke = dataclasses.replace(
        cfg, name="mind-smoke", embed_dim=16, n_items=500, seq_len=12
    )
    return ArchSpec(
        "mind", "recsys", "[arXiv:1904.08030; unverified]", cfg, recsys_shapes(), smoke
    )


@register("sasrec")
def sasrec() -> ArchSpec:
    cfg = RecsysConfig(
        name="sasrec",
        interaction="self-attn-seq",
        embed_dim=50,
        n_blocks=2,
        n_heads=1,
        seq_len=50,
        n_items=1_000_000,
    )
    smoke = dataclasses.replace(
        cfg, name="sasrec-smoke", embed_dim=16, n_items=500, seq_len=12
    )
    return ArchSpec(
        "sasrec", "recsys", "[arXiv:1808.09781; paper]", cfg, recsys_shapes(), smoke
    )


# -- the paper's own configuration (metric-search serving) ---------------------

@dataclasses.dataclass(frozen=True)
class NSimplexServeConfig:
    name: str = "nsimplex-colors"
    n_objects: int = 1_000_000
    dim: int = 112
    n_pivots: int = 32
    query_batch: int = 1024
    metric: str = "jensen_shannon"   # the expensive-metric case the paper targets
    max_candidates: int = 128
    dtype: str = "float32"


@register("nsimplex-colors")
def nsimplex_colors() -> ArchSpec:
    from repro_torch.configs.base import ShapeSpec

    cfg = NSimplexServeConfig()
    smoke = NSimplexServeConfig(
        name="nsimplex-colors-smoke", n_objects=2000, n_pivots=8, query_batch=16
    )
    shapes = {
        "serve_1m": ShapeSpec(
            "serve_1m",
            "search_serve",
            {"n_objects": cfg.n_objects, "query_batch": cfg.query_batch, "n_pivots": cfg.n_pivots},
        ),
    }
    return ArchSpec(
        "nsimplex-colors",
        "metricsearch",
        "this paper (SISAP colors scaled to 1M)",
        cfg,
        shapes,
        smoke,
    )
