"""GCN (Kipf & Welling, arXiv:1609.02907) by gather and scatter-add.

Message passing gathers source features along the edge list, scales them
by the symmetric normalisation 1/sqrt(deg_s·deg_d) and scatter-adds them
into destinations (``index_add_``, the JAX package's ``segment_sum``; on
the card it adds with atomics, so a node's summation order, and its last
bits, vary between runs).  Self-loops are added explicitly.

Execution shapes:
  * full-batch  (cora, ogb_products): one graph, all nodes.
  * sampled     (minibatch_lg): fanout-sampled block batches from
    ``repro_torch.data.NeighborSampler`` — SAGE-style mean per hop.
  * batched     (molecule): (B, N, F) padded small graphs, run as one
    disjoint graph of B·N nodes.

On a ``ProcessMesh`` the full-batch forward takes ``ep``, the edge axes'
``layers.TensorParallel``: each rank holds a slice of the edge list, its
partial degrees and partial aggregates are summed over the edge axes
(the aggregate with the conjugate pair: ``ep.copy`` where the replicated
features enter the edge slice, ``ep.reduce`` where the sums leave it), so
every rank computes the whole graph's layers and loss, and its gradients
are the whole graph's.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.params import Params, generator_for, model_device, normal

__all__ = [
    "GCNConfig",
    "forward_full",
    "forward_molecule",
    "forward_sampled",
    "gcn_conv",
    "init_params",
    "loss_full",
    "loss_molecule",
    "loss_sampled",
]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 16
    n_classes: int = 7
    d_feat: int = 1433
    aggregator: str = "mean"
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        dims = [self.d_feat] + [self.d_hidden] * (self.n_layers - 1) + [self.n_classes]
        return sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))


def init_params(cfg: GCNConfig, generator=None, device="cuda") -> Params:
    dev = model_device(device)
    g = generator_for(generator, dev)
    dt = cfg.torch_dtype
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return Params(**{
        f"layer_{i}": Params(
            w=normal(g, (dims[i], dims[i + 1]), dt, dims[i] ** -0.5, dev),
            b=torch.zeros((dims[i + 1],), dtype=dt, device=dev),
        )
        for i in range(len(dims) - 1)
    })


def _sym_norm_coeff(src, dst, n_nodes, edge_weight=None, ep=None):
    w = torch.ones(src.shape, dtype=torch.float32, device=src.device) if edge_weight is None else edge_weight
    deg = w.new_zeros((n_nodes,)).index_add_(0, dst, w)
    if ep is not None:
        deg = ep.all_reduce(deg)                                # the edge slices' degrees
    deg = deg + 1.0                                             # + self-loop
    inv_sqrt = torch.rsqrt(torch.clamp_min(deg, 1.0))
    return inv_sqrt[src] * inv_sqrt[dst] * w, inv_sqrt


def gcn_conv(x, src, dst, n_nodes, coeff, self_coeff, ep=None):
    """One Ã·X propagation: gather src rows, scale, scatter-add to dst
    (with ``ep``: this rank's edges, the aggregate summed over its group)."""
    msgs = (x if ep is None else ep.copy(x))[src] * coeff[:, None]
    agg = msgs.new_zeros((n_nodes, msgs.shape[1])).index_add_(0, dst, msgs)
    if ep is not None:
        agg = ep.reduce(agg)
    return agg + x * (self_coeff**2)[:, None]  # self-loop term


def _propagate(params, cfg: GCNConfig, x, src, dst, n, edge_weight=None, ep=None):
    coeff, inv_sqrt = _sym_norm_coeff(src, dst, n, edge_weight, ep)
    for i in range(cfg.n_layers):
        p = params[f"layer_{i}"]
        x = gcn_conv(x, src, dst, n, coeff, inv_sqrt, ep) @ p["w"] + p["b"]
        if i < cfg.n_layers - 1:
            x = F.relu(x)
    return x


def forward_full(params, cfg: GCNConfig, feats, edge_index, edge_weight=None, ep=None):
    """Full-batch forward: feats (N, F), edge_index (2, E) -> logits (N, C).

    ``edge_weight`` (E,) supports padded edge lists (0.0 = padding edge).
    ``ep``: edge_index and edge_weight are this rank's slice (the module).
    """
    src, dst = edge_index[0].long(), edge_index[1].long()
    return _propagate(params, cfg, feats, src, dst, feats.shape[0], edge_weight, ep)


def _nll(logits, labels):
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, labels[:, None].long())[:, 0]


def loss_full(params, cfg: GCNConfig, feats, edge_index, labels, mask, edge_weight=None, ep=None):
    ll = _nll(forward_full(params, cfg, feats, edge_index, edge_weight, ep), labels)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    return -torch.sum(ll * mask) / denom


def forward_sampled(params, cfg: GCNConfig, seed_feats, hop_feats):
    """Fanout-sampled block forward (minibatch_lg).

    seed_feats: (B, F); hop_feats: list per hop h of (B*prod(fanouts[:h+1]), F)
    laid out so reshape(B, fanout, F).mean(1) aggregates into the parent hop.
    """
    levels = [seed_feats] + list(hop_feats)
    for i in range(cfg.n_layers):
        p = params[f"layer_{i}"]
        new_levels = []
        for lvl in range(len(levels) - 1):
            parent, child = levels[lvl], levels[lvl + 1]
            fan = child.shape[0] // parent.shape[0]
            agg = child.reshape(parent.shape[0], fan, -1).mean(dim=1)
            h = (parent + agg) @ p["w"] + p["b"]
            if i < cfg.n_layers - 1:
                h = F.relu(h)
            new_levels.append(h)
        levels = new_levels
    return levels[0]


def loss_sampled(params, cfg: GCNConfig, seed_feats, hop_feats, labels):
    return -torch.mean(_nll(forward_sampled(params, cfg, seed_feats, hop_feats), labels))


def forward_molecule(params, cfg: GCNConfig, feats, src, dst):
    """Batched padded small graphs: feats (B, N, F), src/dst (B, E) ->
    (B, n_classes), the mean over each graph's nodes.  The B graphs run as
    one disjoint graph (graph b's nodes offset by b·N), which gives every
    node the same sums as one graph at a time."""
    B, N, Fd = feats.shape
    offset = (torch.arange(B, device=feats.device) * N)[:, None]
    s = (src.long() + offset).reshape(-1)
    d = (dst.long() + offset).reshape(-1)
    x = _propagate(params, cfg, feats.reshape(B * N, Fd), s, d, B * N)
    return x.reshape(B, N, -1).mean(dim=1)  # graph readout


def loss_molecule(params, cfg: GCNConfig, feats, src, dst, labels):
    return -torch.mean(_nll(forward_molecule(params, cfg, feats, src, dst), labels))
