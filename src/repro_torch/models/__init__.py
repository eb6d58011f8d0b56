"""The model half of the port: the LM, GNN and RecSys forwards, prefill
and KV-cache decode, and the bridge that carries the JAX package's
parameters across (``repro_torch.models.convert``)."""

from repro_torch.models.gcn import GCNConfig
from repro_torch.models.layers import AttnConfig, MoEConfig
from repro_torch.models.params import Params
from repro_torch.models.recsys import RecsysConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = [
    "TransformerConfig",
    "GCNConfig",
    "RecsysConfig",
    "MoEConfig",
    "AttnConfig",
    "Params",
]
