"""RecSys architectures in PyTorch: FM, xDeepFM (CIN), MIND (multi-interest
capsules), SASRec (self-attentive sequential).  Embeddings via the unified
table in ``embeddings.py``.

Every model exposes:
  init(cfg, generator, device)          -> Params
  forward(params, cfg, batch)           -> logits / user encodings
  loss(params, cfg, batch)              -> scalar (forward value)
  score_candidates(item_table, user_emb, cand_ids)  — the retrieval cell

On a rank of a ``ProcessMesh`` (``recsys_param_specs``: the tables' rows
over ``model``, the interaction weights replicated) every function takes
``tp``, the ``model`` group's ``layers.TensorParallel``: each table read
goes through ``embeddings.rank_lookup`` (the rows this rank owns, summed
over ``model``).  The sequence models' losses take ``in_batch``, the batch
axes' ``TensorParallel`` where the batch splits over ranks: the in-batch
negatives are the whole batch's targets, all-gathered (the gradient of a
rank's targets summed back from every rank's loss).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.data.synthetic import default_vocab_sizes
from repro_torch.models.embeddings import EmbeddingSpec, embedding_init, lookup, padded_rows, rank_lookup
from repro_torch.models.params import Params, generator_for, model_device, normal

__all__ = [
    "RecsysConfig",
    "bce_loss",
    "fm_forward",
    "fm_init",
    "fm_user_embedding",
    "get_model_fns",
    "mind_encode",
    "mind_init",
    "mind_loss",
    "mind_user_embedding",
    "sasrec_encode",
    "sasrec_init",
    "sasrec_loss",
    "score_candidates",
    "xdeepfm_forward",
    "xdeepfm_init",
]


# ---------------------------------------------------------------------------
# shared config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str                 # fm-2way | cin | multi-interest | self-attn-seq
    embed_dim: int
    n_sparse: int = 39
    n_dense: int = 13
    vocab_sizes: Optional[tuple] = None
    # xDeepFM
    cin_layers: tuple = ()
    mlp_dims: tuple = ()
    # MIND
    n_interests: int = 4
    capsule_iters: int = 3
    # SASRec / MIND sequence
    seq_len: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    n_items: int = 1_000_000
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def spec(self) -> EmbeddingSpec:
        sizes = self.vocab_sizes or tuple(default_vocab_sizes(self.n_sparse).tolist())
        return EmbeddingSpec(vocab_sizes=tuple(sizes), dim=self.embed_dim)

    def param_count(self) -> int:
        if self.interaction in ("fm-2way", "cin"):
            n = self.spec.total_rows * self.embed_dim + self.spec.total_rows  # + linear
            if self.interaction == "cin":
                prev, f0 = self.n_sparse, self.n_sparse
                for h in self.cin_layers:
                    n += prev * f0 * h
                    prev = h
                dims = (self.n_sparse * self.embed_dim + self.n_dense,) + tuple(self.mlp_dims) + (1,)
                n += sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
            return n
        # sequence models: item table + blocks
        n = self.n_items * self.embed_dim + self.seq_len * self.embed_dim
        d = self.embed_dim
        n += self.n_blocks * (4 * d * d + 2 * d * 4 * d + 4 * d)
        if self.interaction == "multi-interest":
            n += d * d  # bilinear routing map
        return n


def _setup(cfg: RecsysConfig, generator, device):
    dev = model_device(device)
    return generator_for(generator, dev), dev, cfg.torch_dtype


def _gather_linear(params, spec: EmbeddingSpec, sparse, tp=None):
    """Σ over fields of the linear term's unified-table rows: (B,)."""
    offsets = torch.as_tensor(spec.offsets, dtype=sparse.dtype, device=sparse.device)
    return rank_lookup(params["linear"], sparse + offsets[None, :], tp).sum(-1)


# ---------------------------------------------------------------------------
# FM  (Rendle, ICDM'10)
# ---------------------------------------------------------------------------

def fm_init(cfg: RecsysConfig, generator=None, device="cuda") -> Params:
    g, dev, dt = _setup(cfg, generator, device)
    spec = cfg.spec
    return Params(
        table=embedding_init(g, spec, dt, device=dev),
        linear=normal(g, (padded_rows(spec),), dt, 0.01, dev),
        dense_w=normal(g, (cfg.n_dense,), dt, 0.01, dev),
        bias=torch.zeros((), dtype=dt, device=dev),
    )


def fm_forward(params, cfg: RecsysConfig, batch, tp=None):
    """batch: {dense (B, n_dense), sparse (B, n_sparse)} -> logits (B,)."""
    spec = cfg.spec
    v = lookup(params["table"], spec, batch["sparse"], tp)      # (B, F, D)
    lin = _gather_linear(params, spec, batch["sparse"], tp)
    s = v.sum(dim=1)                                            # Σ v_i
    pair = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=-1)       # O(nk) trick
    return params["bias"] + lin + batch["dense"] @ params["dense_w"] + pair


def fm_user_embedding(params, cfg: RecsysConfig, batch, tp=None):
    """Σ v_i over the user's fields — the FM dot-product retrieval form."""
    return lookup(params["table"], cfg.spec, batch["sparse"], tp).sum(dim=1)


# ---------------------------------------------------------------------------
# xDeepFM / CIN  (arXiv:1803.05170)
# ---------------------------------------------------------------------------

def xdeepfm_init(cfg: RecsysConfig, generator=None, device="cuda") -> Params:
    g, dev, dt = _setup(cfg, generator, device)
    spec = cfg.spec
    p = {
        "table": embedding_init(g, spec, dt, device=dev),
        "linear": normal(g, (padded_rows(spec),), dt, 0.01, dev),
        "dense_w": normal(g, (cfg.n_dense,), dt, 0.01, dev),
        "bias": torch.zeros((), dtype=dt, device=dev),
    }
    prev, f0 = cfg.n_sparse, cfg.n_sparse
    for li, h in enumerate(cfg.cin_layers):
        p[f"cin_{li}"] = normal(g, (prev * f0, h), dt, (prev * f0) ** -0.5, dev)
        prev = h
    dims = (cfg.n_sparse * cfg.embed_dim + cfg.n_dense,) + tuple(cfg.mlp_dims) + (1,)
    for i in range(len(dims) - 1):
        p[f"mlp_{i}"] = Params(
            w=normal(g, (dims[i], dims[i + 1]), dt, dims[i] ** -0.5, dev),
            b=torch.zeros((dims[i + 1],), dtype=dt, device=dev),
        )
    p["cin_out"] = normal(g, (sum(cfg.cin_layers),), dt, 0.01, dev)
    return Params(**p)


def xdeepfm_forward(params, cfg: RecsysConfig, batch, tp=None):
    spec = cfg.spec
    x0 = lookup(params["table"], spec, batch["sparse"], tp)      # (B, F0, D)
    lin = _gather_linear(params, spec, batch["sparse"], tp)

    # CIN: x_{k+1} = conv1x1(outer(x_k, x_0))
    xk = x0
    pooled = []
    for li in range(len(cfg.cin_layers)):
        z = torch.einsum("bhd,bfd->bhfd", xk, x0)                # (B, Hk, F0, D)
        B, Hk, F0, D = z.shape
        xk = torch.einsum("bqd,qh->bhd", z.reshape(B, Hk * F0, D), params[f"cin_{li}"])
        pooled.append(xk.sum(dim=-1))                            # (B, H_{k+1})
    cin_term = torch.cat(pooled, dim=-1) @ params["cin_out"]

    h = torch.cat([x0.reshape(x0.shape[0], -1), batch["dense"]], dim=-1)
    i = 0
    while f"mlp_{i}" in params:
        p = params[f"mlp_{i}"]
        h = h @ p["w"] + p["b"]
        if f"mlp_{i + 1}" in params:
            h = F.relu(h)
        i += 1
    return params["bias"] + lin + batch["dense"] @ params["dense_w"] + cin_term + h[:, 0]


# ---------------------------------------------------------------------------
# shared CTR loss
# ---------------------------------------------------------------------------

def bce_loss(logits, labels):
    logits = logits.to(torch.float32)
    return torch.mean(
        torch.clamp_min(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    )


# ---------------------------------------------------------------------------
# sequence models: item table + positional encoding
# ---------------------------------------------------------------------------

def _seq_table(cfg: RecsysConfig, g, dev, dt) -> dict:
    n_rows = ((cfg.n_items + 1023) // 1024) * 1024
    return {
        "items": normal(g, (n_rows, cfg.embed_dim), dt, 0.05, dev),
        "pos": normal(g, (cfg.seq_len, cfg.embed_dim), dt, 0.05, dev),
    }


# ---- SASRec (arXiv:1808.09781) --------------------------------------------

def sasrec_init(cfg: RecsysConfig, generator=None, device="cuda") -> Params:
    g, dev, dt = _setup(cfg, generator, device)
    p = _seq_table(cfg, g, dev, dt)
    d = cfg.embed_dim
    for i in range(cfg.n_blocks):
        p[f"block_{i}"] = Params(
            wq=normal(g, (d, d), dt, d**-0.5, dev),
            wk=normal(g, (d, d), dt, d**-0.5, dev),
            wv=normal(g, (d, d), dt, d**-0.5, dev),
            w1=normal(g, (d, 4 * d), dt, d**-0.5, dev),
            w2=normal(g, (4 * d, d), dt, (4 * d) ** -0.5, dev),
            ln1=torch.ones((d,), dtype=dt, device=dev),
            ln2=torch.ones((d,), dtype=dt, device=dev),
        )
    return Params(**p)


def _ln(x, w):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * w


def sasrec_encode(params, cfg: RecsysConfig, seqs, tp=None):
    """seqs: (B, S) item ids (0 = pad) -> (B, D) user embedding."""
    B, S = seqs.shape
    x = rank_lookup(params["items"], seqs, tp) + params["pos"][None, :, :]
    pad = seqs == 0
    i = torch.arange(S, device=seqs.device)[:, None]
    j = torch.arange(S, device=seqs.device)[None, :]
    mask = (j <= i)[None] & ~pad[:, None, :]
    for bi in range(cfg.n_blocks):
        p = params[f"block_{bi}"]
        z = _ln(x, p["ln1"])
        q, k, v = z @ p["wq"], z @ p["wk"], z @ p["wv"]
        scores = torch.einsum("bsd,btd->bst", q, k).to(torch.float32) * (cfg.embed_dim**-0.5)
        scores = torch.where(mask, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        x = x + torch.einsum("bst,btd->bsd", w, v)
        z = _ln(x, p["ln2"])
        x = x + F.relu(z @ p["w1"]) @ p["w2"]
    x = torch.where(pad[..., None], 0.0, x)
    return x[:, -1]  # last position = user state


def _in_batch_softmax_loss(logits, first: int = 0):
    """-mean log p(target i | row i) over an in-batch (B, B) logit block,
    or this rank's rows of it, (B_local, B), the first row ``first``."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.diagonal(logp, offset=first))


def _in_batch_targets(params, batch, tp, in_batch):
    """(this rank's targets' rows (B_local, D), every target's (B, D), the
    first row of this rank's slice of the batch)."""
    pos = rank_lookup(params["items"], batch["targets"], tp)
    if in_batch is None:
        return pos, pos, 0
    return pos, in_batch.gather(pos, 0), in_batch.rank * pos.shape[0]


def sasrec_loss(params, cfg: RecsysConfig, batch, tp=None, in_batch=None):
    """In-batch sampled softmax: positives = targets, negatives = other rows."""
    u = sasrec_encode(params, cfg, batch["seqs"], tp)           # (B, D)
    _, every, first = _in_batch_targets(params, batch, tp, in_batch)
    return _in_batch_softmax_loss(u @ every.T, first)


# ---- MIND (arXiv:1904.08030) -----------------------------------------------

def mind_init(cfg: RecsysConfig, generator=None, device="cuda") -> Params:
    g, dev, dt = _setup(cfg, generator, device)
    p = _seq_table(cfg, g, dev, dt)
    d = cfg.embed_dim
    p["routing_map"] = normal(g, (d, d), dt, d**-0.5, dev)
    return Params(**p)


def _squash(v, dim=-1):
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * v * torch.rsqrt(torch.clamp_min(n2, 1e-9))


def mind_encode(params, cfg: RecsysConfig, seqs, tp=None):
    """Dynamic-routing multi-interest extraction: (B, S) -> (B, K, D)."""
    B, S = seqs.shape
    K = cfg.n_interests
    x = rank_lookup(params["items"], seqs, tp)                  # (B, S, D)
    valid = (seqs != 0).to(torch.float32)
    xm = x @ params["routing_map"]                              # behaviour caps
    logits = torch.zeros((B, K, S), dtype=torch.float32, device=seqs.device)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=1) * valid[:, None, :]
        caps = _squash(torch.einsum("bks,bsd->bkd", w, xm))
        logits = logits + torch.einsum("bkd,bsd->bks", caps, xm)
    w = torch.softmax(logits, dim=1) * valid[:, None, :]
    return _squash(torch.einsum("bks,bsd->bkd", w, xm))        # (B, K, D)


def mind_loss(params, cfg: RecsysConfig, batch, tp=None, in_batch=None):
    """Label-aware attention (p=2) + in-batch softmax."""
    interests = mind_encode(params, cfg, batch["seqs"], tp)     # (B, K, D)
    _, pos, first = _in_batch_targets(params, batch, tp, in_batch)   # (C, D)
    att = torch.softmax((torch.einsum("bkd,cd->bkc", interests, pos) ** 2).to(torch.float32), dim=1)
    u = torch.einsum("bkc,bkd->bcd", att, interests)            # (B, C, D) per-candidate user vec
    return _in_batch_softmax_loss(torch.einsum("bcd,cd->bc", u, pos), first)


def mind_user_embedding(params, cfg: RecsysConfig, batch, tp=None):
    """Serving form: the user's interests concatenated, (B, K·D)."""
    interests = mind_encode(params, cfg, batch["seqs"], tp)
    return interests.reshape(interests.shape[0], -1)


# ---------------------------------------------------------------------------
# retrieval scoring (retrieval_cand cells) — batched dot, no loop
# ---------------------------------------------------------------------------

def score_candidates(item_table, user_emb, cand_ids, tp=None):
    """user_emb (D,) or (K, D); cand_ids (N,) -> scores (N,), the max over
    interests.  With ``tp`` each rank scores the candidates whose rows it
    owns (0 for the others) and the (N,) scores are summed over
    ``model``."""
    cands = rank_lookup(item_table, cand_ids, tp, reduce=False)  # (N, D)
    ue = torch.atleast_2d(user_emb)
    scores = torch.amax(ue @ cands.T, dim=0)
    return scores if tp is None else tp.reduce(scores)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def get_model_fns(cfg: RecsysConfig):
    """(init, forward, loss) of ``cfg.interaction``; forward takes ``tp``,
    loss ``tp`` and ``in_batch`` (the module's)."""
    if cfg.interaction == "fm-2way":
        return fm_init, fm_forward, lambda p, c, b, tp=None, in_batch=None: bce_loss(fm_forward(p, c, b, tp),
                                                                                     b["labels"])
    if cfg.interaction == "cin":
        return (
            xdeepfm_init,
            xdeepfm_forward,
            lambda p, c, b, tp=None, in_batch=None: bce_loss(xdeepfm_forward(p, c, b, tp), b["labels"]),
        )
    if cfg.interaction == "multi-interest":
        return mind_init, mind_encode, mind_loss
    if cfg.interaction == "self-attn-seq":
        return sasrec_init, sasrec_encode, sasrec_loss
    raise KeyError(cfg.interaction)
