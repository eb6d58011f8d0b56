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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.params import Params, generator_for, model_device, normal

__all__ = [
    "AttnConfig",
    "MoEConfig",
    "apply_rope",
    "attention",
    "attn_init",
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


def _qkv(params, x, cfg: AttnConfig):
    B, S, _ = x.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q.reshape(B, S, H, Dh), k.reshape(B, S, Hk, Dh), v.reshape(B, S, Hk, Dh)


def _gqa_scores(q, k):
    """q: (B, S, H, Dh), k: (B, T, Hk, Dh) -> (B, H, S, T) with GQA grouping."""
    B, S, H, Dh = q.shape
    Hk = k.shape[2]
    G = H // Hk
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, Hk, G, Dh), k)
    return s.reshape(B, Hk * G, S, k.shape[1])


def _gqa_out(w, v):
    """w: (B, H, S, T), v: (B, T, Hk, Dh) -> (B, S, H, Dh)."""
    B, H, S, T = w.shape
    Hk = v.shape[2]
    G = H // Hk
    o = torch.einsum("bkgst,btkd->bskgd", w.reshape(B, Hk, G, S, T), v)
    return o.reshape(B, S, H, v.shape[3])


def attention(params, x, cfg: AttnConfig, positions=None):
    """Full (training / prefill) self-attention. x: (B, S, D) ->
    (out (B, S, D), (k, v) after RoPE)."""
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, x.device)
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scores = _gqa_scores(q, k).to(torch.float32) * (cfg.d_head**-0.5)
    i = torch.arange(S, device=x.device)[:, None]
    j = torch.arange(S, device=x.device)[None, :]
    mask = j <= i
    if cfg.window is not None:
        mask = mask & (j > i - cfg.window)
    scores = torch.where(mask[None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(w, v)
    return out.reshape(B, S, -1) @ params["wo"], (k, v)


def chunked_attention(params, x, cfg: AttnConfig, positions=None, *, chunk_kv: int = 1024):
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
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    H, Dh, Hk = cfg.n_heads, cfg.d_head, cfg.n_kv
    G = H // Hk
    scale = Dh**-0.5
    n_chunks = (S + chunk_kv - 1) // chunk_kv
    Sp = n_chunks * chunk_kv
    kp = F.pad(k, (0, 0, 0, 0, 0, Sp - S))
    vp = F.pad(v, (0, 0, 0, 0, 0, Sp - S))
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
    return out @ params["wo"], (k, v)


def decode_attention(params, x, cfg: AttnConfig, cache_k, cache_v, cache_pos, pos):
    """One-token decode with a KV cache.

    x: (B, 1, D); cache_k/v: (B, C, Hk, Dh); cache_pos: (B, C) absolute
    positions of cached entries (-1 = empty); pos: (B,) current position.
    The cache is a ring (slot = pos % C); for sliding-window configs
    C == window.  The new entry is written into the given cache tensors in
    place, and they are returned.
    """
    B = x.shape[0]
    C = cache_k.shape[1]
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    slot = (pos % C).long()
    b = torch.arange(B, device=x.device)
    cache_k[b, slot] = k[:, 0]
    cache_v[b, slot] = v[:, 0]
    cache_pos[b, slot] = pos.to(cache_pos.dtype)

    scores = _gqa_scores(q, cache_k).to(torch.float32) * (cfg.d_head**-0.5)
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if cfg.window is not None:
        valid = valid & (cache_pos > pos[:, None] - cfg.window)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(w, cache_v)
    out = out.reshape(B, 1, -1) @ params["wo"]
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


def swiglu_mlp(params, x):
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


def _rank_offsets(totals: torch.Tensor, group) -> torch.Tensor:
    """(1, E) per-expert token counts of the ranks of ``group`` before this
    one, from this rank's (1, E) ``totals``."""
    R = dist.get_world_size(group)
    every = totals.new_empty((R * totals.shape[0],) + tuple(totals.shape[1:]))
    dist.all_gather_into_tensor(every, totals.contiguous(), group=group)
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


def moe_ffn(params, x, cfg: MoEConfig, group=None):
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

    ``group`` (a ``torch.distributed`` process group; global dispatch only):
    x is this rank's slice of the batch's tokens, the slices of the group's
    ranks in rank order, as a sharded train step runs it; the capacity is
    the whole batch's, a token's slot counts the earlier ranks'
    tokens of its expert (an all-gather of per-expert counts), and the
    load-balance means are the batch's (an all-reduce that carries
    gradients: its backward sums the ranks' gradients, which the step's
    mean over ranks turns back into the batch's).
    """
    T, D = x.shape
    if group is not None and cfg.dispatch == "local":
        raise ValueError("moe_ffn: a batch group takes global dispatch only")
    S = cfg.n_batch_shards if cfg.dispatch == "local" else 1
    if T % S:
        S = 1
    Tl = T // S
    E, K = cfg.n_experts, cfg.top_k
    R = 1 if group is None else dist.get_world_size(group)
    C = max(4, int(Tl * R * K / E * cfg.capacity_factor))
    C = min(C, Tl * R)

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

    y = torch.zeros_like(xs)
    s_i = torch.arange(S, device=x.device)[:, None]                        # (S, 1)
    for slot in range(K):
        e_idx = gate_idx[..., slot]                                        # (S, Tl)
        g = gate_vals[..., slot]
        # each token's position among its expert's tokens, in token order
        counts = torch.cumsum(F.one_hot(e_idx, E), dim=1)                  # (S, Tl, E)
        pos = torch.gather(counts, 2, e_idx[..., None])[..., 0] - 1
        if group is not None:
            pos = pos + _rank_offsets(counts[:, -1], group)[0][e_idx]
        keep = pos < C
        expert_in = xs.new_zeros((S, E, C + 1, D))
        expert_in[s_i, e_idx, torch.clamp_max(pos, C)] = xs               # row C: dropped tokens
        expert_in = expert_in[:, :, :C]
        h = F.silu(torch.einsum("secd,edf->secf", expert_in, params["w_gate"])) * torch.einsum(
            "secd,edf->secf", expert_in, params["w_up"]
        )
        expert_out = torch.einsum("secf,efd->secd", h, params["w_down"])
        picked = expert_out[s_i, e_idx, torch.clamp_max(pos, C - 1)]     # (S, Tl, D)
        y = y + (g * keep).to(x.dtype)[..., None] * picked
    return y.reshape(T, D), aux
