"""Config system: ArchSpec (model config + its shape set + reduced smoke
config) and the registry behind ``--arch``, the JAX package's registry
field for field (its model configs are the port's ``repro_torch.models``
configs).

Shape kinds name the step a cell runs:
  train          -> train_step (grad accumulation included)
  prefill        -> serve prefill (full forward, build KV cache)
  decode         -> serve decode (1 new token against a seq_len KV cache)
  serve          -> batched forward scoring (recsys)
  retrieval      -> 1 query x n_candidates scoring (recsys)
  search_serve   -> distributed n-simplex filter (paper's own config)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str
    sizes: Dict[str, int]
    skip: Optional[str] = None      # reason string when inapplicable (noted, not run)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # lm | gnn | recsys | metricsearch
    source: str                     # public provenance note
    model_cfg: Any
    shapes: Dict[str, ShapeSpec]
    smoke_cfg: Any                  # reduced config for CPU smoke tests


_REGISTRY: Dict[str, Callable[[], ArchSpec]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_arch(arch_id: str) -> ArchSpec:
    # import config modules lazily so the registry is populated
    import repro_torch.configs  # noqa: F401
    try:
        return _REGISTRY[arch_id]()
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}") from None


def list_archs():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


# -- shared shape sets ---------------------------------------------------------

def lm_shapes(*, full_attention: bool) -> Dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        "prefill_32k": ShapeSpec(
            "prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}
        ),
        "decode_32k": ShapeSpec(
            "decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}
        ),
        "long_500k": ShapeSpec(
            "long_500k",
            "decode",
            {"seq_len": 524288, "global_batch": 1},
            skip=(
                "pure full-attention arch: 512k-token decode needs sub-quadratic "
                "attention (DESIGN.md §4)"
                if full_attention
                else None
            ),
        ),
    }


def recsys_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
        "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}
        ),
    }


def gnn_shapes() -> Dict[str, ShapeSpec]:
    return {
        "full_graph_sm": ShapeSpec(
            "full_graph_sm",
            "train",
            {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7},
        ),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg",
            "train",
            {
                "n_nodes": 232_965,
                "n_edges": 114_615_892,
                "batch_nodes": 1024,
                "fanout1": 15,
                "fanout2": 10,
                "d_feat": 602,
                "n_classes": 41,
            },
        ),
        "ogb_products": ShapeSpec(
            "ogb_products",
            "train",
            {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100, "n_classes": 47},
        ),
        "molecule": ShapeSpec(
            "molecule",
            "train",
            {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16, "n_classes": 2},
        ),
    }
