"""Transformer building blocks in PyTorch: RMSNorm, RoPE, GQA attention
(causal / sliding-window / KV-cache decode, naive and chunked), SwiGLU MLP,
and capacity-based top-k MoE (GShard capacity rule, optional parallel
dense residual for Arctic).

Every function keeps the JAX package's arithmetic order where it decides
results: RMSNorm normalises in f32 and casts back before the weight; RoPE
rotates split halves with f32 angles; attention masks with ``-1e30`` and
takes its softmax in f32, casting to the activations' dtype before the PV
product.  Parameters are ``Params`` modules holding the reference's names;
initialisers take an explicit ``torch.Generator``.

Tensor parallelism (``tp``, a ``TensorParallel``: this rank's place in
the ``model`` group of a ``ProcessMesh``): each weight is this rank's
shard under ``lm_param_specs`` (gathered over ``data`` by the step), and
the layers compute in that layout with the conjugate collectives of the
``model`` group: ``tp.copy`` (identity forward, sum backward) where a
replicated activation enters a split region and ``tp.reduce`` (sum
forward, identity backward) where partial sums leave it.  Attention runs
this rank's heads (q, and k / v when ``n_kv`` divides ``|model|``; else
k / v come from the weights gathered over ``model``, whose gradient the
gather's backward sums and cuts), RoPE on whole heads, then ``wo``'s row
shard; SwiGLU splits ``d_ff``; MoE runs this rank's experts on every token
when ``n_experts >= |model|``, else every expert's ``d_ff`` slice.
``tp=None`` is the one-process path, unchanged.

Where ``|model|`` does not divide ``n_heads`` (qwen2-1.5b's 12 heads over
8 ranks) the weights stay in their column split, which cuts a head, and
the compute takes GSPMD's padded split of the heads: ceil(H / |model|)
heads a rank in rank order (2 on ranks 0-5, none on 6-7), cut from
``wq`` and ``wo`` gathered over ``model``; a rank without heads runs the
same collectives on empty slices.  Decode gathers every head's q from
the ranks' column chunks and hands ``wo`` this rank's columns of the
output, whatever the split.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.params import Params, generator_for, model_device, normal
from repro_torch.sharding.rules import gather_dim, scatter_dim

__all__ = [
    "AttnConfig",
    "MoEConfig",
    "TensorParallel",
    "apply_rope",
    "attention",
    "attn_init",
    "cache_heads",
    "chunked_attention",
    "decode_attention",
    "mlp_init",
    "moe_ffn",
    "moe_init",
    "rms_norm",
    "rope_freqs",
    "swiglu_mlp",
]


# ---------------------------------------------------------------------------
# Norm + rotary
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight


def _inv_freqs(d_head: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head))


def rope_freqs(d_head: int, theta: float = 10000.0, device="cuda"):
    return _inv_freqs(d_head, theta, resolve_device(device))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, Dh); positions: (B, S) integer."""
    d_head = x.shape[-1]
    inv = _inv_freqs(d_head, theta, x.device)                  # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * inv         # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ---------------------------------------------------------------------------
# Tensor parallelism over the ``model`` group
# ---------------------------------------------------------------------------

class TensorParallel:
    """This rank's place in the ``model`` group: ``group``, ``size`` ranks,
    this one's index ``rank``.  ``moved`` counts the bytes of each
    collective's result on this rank, by kind (``"all_reduce"``,
    ``"all_gather"``, ``"reduce_scatter"``), forward and backward."""

    def __init__(self, group, size: int, rank: int):
        self._group, self.size, self.rank = group, int(size), int(rank)
        self.moved = collections.Counter()

    @property
    def group(self):
        return self._group() if callable(self._group) else self._group

    @classmethod
    def of(cls, mesh, axes=("model",)) -> Optional["TensorParallel"]:
        """The group of ``axes`` (those of them on the mesh; the ``model``
        axis by default) of a ``ProcessMesh``, looked up at the first
        collective, so that a plan builds on a stand-in mesh; None when it
        has one rank (the one-process layers)."""
        axes = tuple(a for a in mesh.axis_names if a in tuple(axes))
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if size == 1:
            return None
        return cls(lambda: mesh.group(axes), size, mesh.axis_index(axes))

    def chunk(self, n: int) -> tuple:
        """[start, stop) of this rank's chunk of ``n`` split ``size`` ways."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def copy(self, x):
        """Identity forward; the gradient summed over the group."""
        return _CopyToModel.apply(x, self)

    def reduce(self, x):
        """The group's sum forward; the gradient passed through."""
        return _ReduceFromModel.apply(x, self)

    def gather(self, x, dim: int):
        """The group's ``x`` concatenated along ``dim`` forward; the
        gradient summed over the group and cut to this rank's chunk."""
        return _GatherFromModel.apply(x, dim, self)

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        """In place, outside autograd."""
        self.moved["all_reduce"] += x.numel() * x.element_size()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def all_gather(self, x, dim: int):
        """The group's ``x`` concatenated along ``dim``, outside autograd."""
        out = gather_dim(x.contiguous(), dim, self.group, self.size)
        self.moved["all_gather"] += out.numel() * out.element_size()
        return out

    def _scatter(self, x, dim):
        out = scatter_dim(x, dim, self.group, self.size)
        self.moved["reduce_scatter"] += out.numel() * out.element_size()
        return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.all_gather(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._scatter(g, ctx.dim).contiguous(), None, None


def _local_heads(cfg, tp) -> tuple:
    """[start, stop) of this rank's query heads (all of them without tp):
    ceil(H / |model|) heads a rank in rank order, the last ranks' share cut
    at H (GSPMD's padding; the weights' column chunk where |model| divides
    H)."""
    if tp is None:
        return 0, cfg.n_heads
    if (cfg.n_heads * cfg.d_head) % tp.size:
        raise ValueError(
            f"a model axis of {tp.size} divides neither {cfg.n_heads} heads nor their "
            f"{cfg.n_heads * cfg.d_head} columns: the weights' column split has no place to cut")
    per = -(-cfg.n_heads // tp.size)
    h0 = min(tp.rank * per, cfg.n_heads)
    return h0, min(h0 + per, cfg.n_heads)


def _heads_split(cfg, tp) -> bool:
    """Whether this rank's column chunk of ``wq`` (and row chunk of ``wo``)
    is its heads: |model| divides ``n_heads``."""
    return cfg.n_heads % tp.size == 0


def _kv_split(cfg, tp) -> bool:
    """Whether k / v run on this rank's kv heads (else on all of them, from
    the weights gathered over ``model``)."""
    return tp is not None and cfg.n_kv % tp.size == 0


# ---------------------------------------------------------------------------
# Attention (GQA, causal, optional sliding window, KV cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    qkv_bias: bool = False
    window: Optional[int] = None     # sliding-window size (Mistral/Mixtral)
    rope_theta: float = 10000.0


def attn_init(generator, cfg: AttnConfig, dtype=torch.float32, device="cuda") -> Params:
    device = model_device(device)
    generator = generator_for(generator, device)
    D, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    s = D**-0.5
    p = {
        "wq": normal(generator, (D, H * Dh), dtype, s, device),
        "wk": normal(generator, (D, Hk * Dh), dtype, s, device),
        "wv": normal(generator, (D, Hk * Dh), dtype, s, device),
        "wo": normal(generator, (H * Dh, D), dtype, s, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * Dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hk * Dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hk * Dh,), dtype=dtype, device=device)
    return Params(**p)


def _qkv(params, x, cfg: AttnConfig, tp=None, heads: bool = True):
    """q, k, v of shape (B, S, heads, Dh): every head without ``tp``; with
    it this rank's query heads (``_local_heads``: from ``wq`` gathered over
    ``model`` where its column chunk cuts a head), and its kv heads or
    (``_kv_split`` false) every kv head from ``wk`` / ``wv`` gathered over
    ``model``.  ``heads=False``: q is this rank's column chunk of
    ``x @ wq``, (B, S, H·Dh / |model|), whatever the split."""
    B, S, _ = x.shape
    Dh = cfg.d_head
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    bq, bk, bv = (params["bq"], params["bk"], params["bv"]) if cfg.qkv_bias else (None, None, None)
    if tp is not None:
        h0, h1 = _local_heads(cfg, tp)
        x = tp.copy(x)
        if heads and not _heads_split(cfg, tp):
            wq = tp.gather(wq, 1)[:, h0 * Dh:h1 * Dh]
            if cfg.qkv_bias:
                bq = tp.gather(bq, 0)[h0 * Dh:h1 * Dh]
        if not _kv_split(cfg, tp):
            wk, wv = tp.gather(wk, 1), tp.gather(wv, 1)
            if cfg.qkv_bias:
                bk, bv = tp.gather(bk, 0), tp.gather(bv, 0)
    q = x @ wq
    k = x @ wk
    v = x @ wv
    if cfg.qkv_bias:
        q = q + bq
        k = k + bk
        v = v + bv
    return q.reshape(B, S, -1, Dh) if heads else q, k.reshape(B, S, -1, Dh), v.reshape(B, S, -1, Dh)


def _kv_for_heads(k, v, cfg: AttnConfig, tp):
    """k and v for this rank's query heads: as they are where they hold the
    rank's kv heads (or every head, one process); else each local query
    head's kv head picked from every head (one kv head per query head)."""
    if tp is None or _kv_split(cfg, tp):
        return k, v
    h0, h1 = _local_heads(cfg, tp)
    idx = torch.arange(h0, h1, device=k.device) // (cfg.n_heads // cfg.n_kv)
    return k[:, :, idx], v[:, :, idx]


def _out_proj(params, out, cfg: AttnConfig, tp, heads: bool = True):
    """(B, S, heads · Dh) attention output through ``wo`` (with ``tp``: the
    rows of this rank's heads, from ``wo`` gathered over ``model`` where
    its row chunk cuts a head, and the ``model`` sum).  ``heads=False``:
    ``out`` is this rank's column chunk of every head's output, which
    meets ``wo``'s own row chunk."""
    wo = params["wo"]
    if tp is not None and heads and not _heads_split(cfg, tp):
        h0, h1 = _local_heads(cfg, tp)
        wo = tp.gather(wo, 0)[h0 * cfg.d_head:h1 * cfg.d_head]
    h = out @ wo
    return h if tp is None else tp.reduce(h)


def _groups(H: int, Hk: int) -> int:
    """Query heads per kv head (1 for a rank without heads)."""
    return H // Hk if Hk else 1


def _gqa_scores(q, k):
    """q: (B, S, H, Dh), k: (B, T, Hk, Dh) -> (B, H, S, T) with GQA grouping."""
    B, S, H, Dh = q.shape
    Hk = k.shape[2]
    G = _groups(H, Hk)
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, Hk, G, Dh), k)
    return s.reshape(B, Hk * G, S, k.shape[1])


def _gqa_out(w, v):
    """w: (B, H, S, T), v: (B, T, Hk, Dh) -> (B, S, H, Dh)."""
    B, H, S, T = w.shape
    Hk = v.shape[2]
    G = _groups(H, Hk)
    o = torch.einsum("bkgst,btkd->bskgd", w.reshape(B, Hk, G, S, T), v)
    return o.reshape(B, S, H, v.shape[3])


def attention(params, x, cfg: AttnConfig, positions=None, tp=None):
    """Full (training / prefill) self-attention. x: (B, S, D) ->
    (out (B, S, D), (k, v) after RoPE: the heads ``_qkv`` gives)."""
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    q, k, v = _qkv(params, x, cfg, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kq, vq = _kv_for_heads(k, v, cfg, tp)
    scores = _gqa_scores(q, kq).to(torch.float32) * (cfg.d_head**-0.5)
    i = torch.arange(S, device=x.device)[:, None]
    j = torch.arange(S, device=x.device)[None, :]
    mask = j <= i
    if cfg.window is not None:
        mask = mask & (j > i - cfg.window)
    scores = torch.where(mask[None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(w, vq)
    return _out_proj(params, out.reshape(B, S, -1), cfg, tp), (k, v)


def chunked_attention(params, x, cfg: AttnConfig, positions=None, *, chunk_kv: int = 1024, tp=None):
    """Flash-style training/prefill attention: online softmax over KV chunks.

    Never materialises the (B, H, S, S) score matrix: per chunk only
    (B, H, S, chunk_kv) exists.  K and V pad to a multiple of the chunk;
    the running max starts at ``-inf`` and masked entries are ``-1e30``, so
    a chunk that is all padding adds exp(-1e30 - m) = 0 and stays finite.
    Equal to ``attention`` within f32 rounding (tested).
    """
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    q, k, v = _qkv(params, x, cfg, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kq, vq = _kv_for_heads(k, v, cfg, tp)
    H, Dh, Hk = q.shape[2], cfg.d_head, kq.shape[2]
    G = _groups(H, Hk)
    scale = Dh**-0.5
    n_chunks = (S + chunk_kv - 1) // chunk_kv
    Sp = n_chunks * chunk_kv
    kp = F.pad(kq, (0, 0, 0, 0, 0, Sp - S))
    vp = F.pad(vq, (0, 0, 0, 0, 0, Sp - S))
    qg = q.reshape(B, S, Hk, G, Dh)
    i_pos = torch.arange(S, device=x.device)

    m = torch.full((B, Hk, G, S), -torch.inf, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, Hk, G, S), dtype=torch.float32, device=x.device)
    acc = torch.zeros((B, Hk, G, S, Dh), dtype=torch.float32, device=x.device)
    for ci in range(n_chunks):
        k_i = kp[:, ci * chunk_kv:(ci + 1) * chunk_kv]
        v_i = vp[:, ci * chunk_kv:(ci + 1) * chunk_kv]
        j_pos = ci * chunk_kv + torch.arange(chunk_kv, device=x.device)
        s = torch.einsum("bskgd,btkd->bkgst", qg, k_i).to(torch.float32) * scale
        mask = (j_pos[None, :] <= i_pos[:, None]) & (j_pos[None, :] < S)
        if cfg.window is not None:
            mask = mask & (j_pos[None, :] > i_pos[:, None] - cfg.window)
        s = torch.where(mask[None, None, None], s, -1e30)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(x.dtype), v_i
        ).to(torch.float32)
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(x.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * Dh)
    return _out_proj(params, out, cfg, tp), (k, v)


def cache_heads(k, cfg: AttnConfig, tp):
    """k (or v) of every kv head in the cache's ``d_head`` layout from the
    heads ``_qkv`` gave: with ``tp``, this rank's kv heads are all-gathered
    over ``model`` (outside autograd) and the ``d_head`` dim cut to this
    rank's chunk when it splits (``kv_cache_specs``: head_dim over
    ``model``).  The exchange between the weights' head split and the
    cache's ``d_head`` split."""
    if tp is None:
        return k
    if _kv_split(cfg, tp):
        k = tp.all_gather(k, 2)
    if cfg.d_head % tp.size == 0:
        d0, d1 = tp.chunk(cfg.d_head)
        k = k[..., d0:d1]
    return k.contiguous()


def decode_attention(params, x, cfg: AttnConfig, cache_k, cache_v, cache_pos, pos, tp=None):
    """One-token decode with a KV cache.

    x: (B, 1, D); cache_k/v: (B, C, Hk, Dh); cache_pos: (B, C) absolute
    positions of cached entries (-1 = empty); pos: (B,) current position.
    The cache is a ring (slot = pos % C); for sliding-window configs
    C == window.  The new entry is written into the given cache tensors in
    place, and they are returned.

    With ``tp`` the cache is this rank's ``d_head`` chunk of every kv head
    (``cache_heads``): every head's q is all-gathered over ``model`` from
    the ranks' column chunks of ``x @ wq`` (RoPE after, on whole heads),
    the scores of every head summed over the ranks' ``d_head`` chunks (an
    all-reduce of (B, H, 1, C) f32), the ranks' chunks of the output
    all-gathered, and this rank's columns of it go through ``wo``'s row
    chunk.
    """
    B = x.shape[0]
    C = cache_k.shape[1]
    q, k, v = _qkv(params, x, cfg, tp, heads=tp is None)
    if tp is not None:
        q = tp.all_gather(q, 2).reshape(B, 1, cfg.n_heads, cfg.d_head)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    k, v = cache_heads(k, cfg, tp), cache_heads(v, cfg, tp)
    slot = (pos % C).long()
    b = torch.arange(B, device=x.device)
    cache_k[b, slot] = k[:, 0]
    cache_v[b, slot] = v[:, 0]
    cache_pos[b, slot] = pos.to(cache_pos.dtype)

    dh_split = tp is not None and cfg.d_head % tp.size == 0
    if dh_split:
        d0, d1 = tp.chunk(cfg.d_head)
        q = q[..., d0:d1]
    scores = _gqa_scores(q, cache_k).to(torch.float32)
    if dh_split:
        scores = tp.all_reduce(scores.contiguous())
    scores = scores * (cfg.d_head**-0.5)
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if cfg.window is not None:
        valid = valid & (cache_pos > pos[:, None] - cfg.window)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(w, cache_v)
    if dh_split:
        out = tp.all_gather(out, 3)
    out = out.reshape(B, 1, -1)
    if tp is not None:
        c0, c1 = tp.chunk(out.shape[-1])
        out = out[..., c0:c1]
    out = _out_proj(params, out, cfg, tp, heads=False)
    return out, (cache_k, cache_v, cache_pos)


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(generator, d_model: int, d_ff: int, dtype=torch.float32, device="cuda") -> Params:
    device = model_device(device)
    generator = generator_for(generator, device)
    s_in, s_out = d_model**-0.5, d_ff**-0.5
    return Params(
        w_gate=normal(generator, (d_model, d_ff), dtype, s_in, device),
        w_up=normal(generator, (d_model, d_ff), dtype, s_in, device),
        w_down=normal(generator, (d_ff, d_model), dtype, s_out, device),
    )


def swiglu_mlp(params, x, tp=None):
    """With ``tp``: this rank's ``d_ff`` columns of ``w_gate`` / ``w_up`` and
    rows of ``w_down``, summed over ``model``."""
    if tp is None:
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    x = tp.copy(x)
    return tp.reduce((F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"])


def _rank_offsets(totals: torch.Tensor, group) -> torch.Tensor:
    """(1, E) per-expert token counts of the ranks of ``group`` before this
    one, from this rank's (1, E) ``totals``."""
    R = dist.get_world_size(group)
    every = gather_dim(totals.contiguous(), 0, group, R)
    return every.reshape((R,) + tuple(totals.shape))[: dist.get_rank(group)].sum(dim=0)


# ---------------------------------------------------------------------------
# MoE (top-k, capacity-based dispatch; GShard/Mixtral style)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    d_ff: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False      # Arctic: dense FFN in parallel with MoE
    #: "einsum" = global-capacity dispatch (baseline); "local" = per-shard
    #: capacity: tokens reshape to (n_batch_shards, T_local, ...) and each
    #: shard routes its own tokens with its own capacity
    dispatch: str = "einsum"
    #: mesh axes carrying the batch sharding (the JAX package's sharding
    #: hint in local mode; one process has no such constraint, so the
    #: port keeps the field for config equality and reads only the count)
    batch_axes: tuple = ()
    n_batch_shards: int = 1


def moe_init(generator, d_model: int, cfg: MoEConfig, dtype=torch.float32, device="cuda") -> Params:
    device = model_device(device)
    generator = generator_for(generator, device)
    E, Ff = cfg.n_experts, cfg.d_ff
    s_in, s_out = d_model**-0.5, Ff**-0.5
    return Params(
        w_router=normal(generator, (d_model, E), torch.float32, s_in, device),
        w_gate=normal(generator, (E, d_model, Ff), dtype, s_in, device),
        w_up=normal(generator, (E, d_model, Ff), dtype, s_in, device),
        w_down=normal(generator, (E, Ff, d_model), dtype, s_out, device),
    )


def _dispatch_shards(cfg: MoEConfig, T: int, R: int) -> tuple:
    """(S, Tl, C, global_slots) of ``moe_ffn`` for T tokens on a rank of a
    batch group of R ranks (R = 1: one process): S shards of Tl tokens each
    with capacity C; ``global_slots``: capacity and slots are the whole
    batch's (the ranks' tokens in rank order).  Local dispatch splits the
    whole batch into ``n_batch_shards`` shards, ``n_batch_shards / R`` of
    them on each rank; where they do not divide the rank's tokens, the
    reference's fallback to one shard is the whole batch's global
    dispatch."""
    E, K = cfg.n_experts, cfg.top_k
    if cfg.dispatch == "local":
        if cfg.n_batch_shards % R:
            raise ValueError(f"moe_ffn: local dispatch over a batch group of {R} ranks needs n_batch_shards "
                             f"({cfg.n_batch_shards}) a multiple of {R}")
        S = cfg.n_batch_shards // R
        if T % S == 0:
            Tl = T // S
            return S, Tl, min(max(4, int(Tl * K / E * cfg.capacity_factor)), Tl), False
    C = max(4, int(T * R * K / E * cfg.capacity_factor))
    return 1, T, min(C, T * R), R > 1


def moe_ffn(params, x, cfg: MoEConfig, group=None, tp=None):
    """x: (T, D) -> (y: (T, D), aux: load-balance loss).

    Per expert the first C tokens (in token order, per shard) are kept;
    overflow tokens get no contribution from that expert.  The reference
    dispatches with one-hot (S, T, E, C) einsums; the port writes each
    token into its (expert, slot) row of an (S, E, C + 1, D) buffer, whose
    row C takes every dropped token, runs the experts on the first C rows
    and gathers each token's row back, masked by ``pos < C``: the same
    single term of each of those sums, with no data-dependent shape (so no
    host sync on the card).  Ties in the router's top-k take the lower
    expert index first, as ``jax.lax.top_k`` does (a stable descending
    sort).

    dispatch="local": tokens reshape to (S, T/S, D) with S = n_batch_shards
    and each shard has its own capacity (S falls back to 1 when it does not
    divide T).

    ``group`` (a ``torch.distributed`` process group): x is this rank's
    slice of the batch's tokens, the slices of the group's ranks in rank
    order, as a sharded step runs it.  Global dispatch: the capacity is the
    whole batch's, a token's slot counts the earlier ranks' tokens of its
    expert (an all-gather of per-expert counts).  Local dispatch: this
    rank's ``n_batch_shards / |group|`` shards with their own capacity
    (``_dispatch_shards``).  Either way the load-balance means are the
    batch's (an all-reduce that carries gradients: its backward sums the
    ranks' gradients, which the step's mean over ranks turns back into the
    batch's).

    ``tp``: the router runs on every rank (its input is replicated over
    ``model``); the experts are this rank's (``n_experts >= |model|``:
    tokens routed elsewhere add nothing here) or every expert's ``d_ff``
    slice, and the partial outputs are summed over ``model``.
    """
    T, D = x.shape
    R = 1 if group is None else dist.get_world_size(group)
    S, Tl, C, global_slots = _dispatch_shards(cfg, T, R)
    E, K = cfg.n_experts, cfg.top_k

    xs = x.reshape(S, Tl, D)
    logits = xs.to(torch.float32) @ params["w_router"]          # (S, Tl, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[..., :K], order.indices[..., :K]   # (S, Tl, K)
    gate_vals = gate_vals / torch.clamp_min(torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    if group is None:
        me = torch.mean(probs, dim=(0, 1))
        ce = torch.mean(torch.sum(F.one_hot(gate_idx, E).to(torch.float32), dim=2), dim=(0, 1)) / K
    else:
        import torch.distributed.nn.functional as dfn

        me = dfn.all_reduce(torch.sum(probs, dim=(0, 1)), group=group) / (T * R)
        ce = torch.sum(F.one_hot(gate_idx, E).to(torch.float32), dim=(0, 1, 2))
        dist.all_reduce(ce, group=group)
        ce = ce / (T * R) / K
    aux = E * torch.sum(me * ce)

    e0, E_loc = 0, E
    if tp is not None:
        xs, gate_vals = tp.copy(xs), tp.copy(gate_vals)
        if E >= tp.size:
            e0, E_loc = tp.chunk(E)[0], E // tp.size
    y = torch.zeros_like(xs)
    s_i = torch.arange(S, device=x.device)[:, None]                        # (S, 1)
    for slot in range(K):
        e_idx = gate_idx[..., slot]                                        # (S, Tl)
        g = gate_vals[..., slot]
        # each token's position among its expert's tokens, in token order
        counts = torch.cumsum(F.one_hot(e_idx, E), dim=1)                  # (S, Tl, E)
        pos = torch.gather(counts, 2, e_idx[..., None])[..., 0] - 1
        if global_slots:
            pos = pos + _rank_offsets(counts[:, -1], group)[0][e_idx]
        keep = pos < C
        if E_loc < E:   # this rank's experts only
            keep = keep & (e_idx >= e0) & (e_idx < e0 + E_loc)
            e_idx = torch.clamp(e_idx - e0, 0, E_loc - 1)
            pos = torch.where(keep, pos, C)
        expert_in = xs.new_zeros((S, E_loc, C + 1, D))
        expert_in[s_i, e_idx, torch.clamp_max(pos, C)] = xs               # row C: dropped tokens
        expert_in = expert_in[:, :, :C]
        h = F.silu(torch.einsum("secd,edf->secf", expert_in, params["w_gate"])) * torch.einsum(
            "secd,edf->secf", expert_in, params["w_up"]
        )
        expert_out = torch.einsum("secf,efd->secd", h, params["w_down"])
        picked = expert_out[s_i, e_idx, torch.clamp_max(pos, C - 1)]     # (S, Tl, D)
        y = y + (g * keep).to(x.dtype)[..., None] * picked
    if tp is not None:
        y = tp.reduce(y)
    return y.reshape(T, D), aux
