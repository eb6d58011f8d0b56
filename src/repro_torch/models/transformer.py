"""Decoder-only Transformer LM (dense + MoE) in PyTorch.

Covers every LM architecture of the registry: GQA (all), QKV bias (qwen2),
sliding-window attention (mixtral), MoE top-2 (mixtral), MoE top-2 plus a
parallel dense residual FFN (arctic), tied or untied output head, RMSNorm,
RoPE, SwiGLU.

The JAX package stacks layer parameters along a leading (n_layers,) axis
and scans over them; the port keeps one ``Params`` per layer in
``params["layers"]`` (an ``nn.ModuleList``) and runs a plain Python loop.

Entry points:
  init_params(cfg, generator, device)        -> Params
  forward(params, cfg, tokens)               -> (hidden, aux)
  loss_fn(params, cfg, tokens, labels)       -> (loss, {"ce", "aux"})
  prefill(params, cfg, tokens)               -> (last_logits, cache)
  init_cache(cfg, batch, cache_len, device)  -> cache
  decode_step(params, cfg, token, pos, cache) -> (logits, cache)

Sharded (``tp``: a ``layers.TensorParallel``; ``group``: the batch
axes' process group): each rank holds its ``lm_param_specs`` shards
gathered over ``data``.  The embedding is a vocabulary-parallel lookup
(a masked local take summed over ``model``, the reference's
``sharded_lookup``), the head gives this rank's vocabulary slice of the
logits, the cross-entropy takes its max, sum of exponentials and gold
logit over ``model``, and prefill / decode keep the KV cache in its
``kv_cache_specs`` layout (``layers.cache_heads``), their logits whole.

Gradients: ``loss_fn`` is differentiable; the train path turns them on
for its own tree (``repro_torch.models.params.value_and_grad``).  With
``cfg.remat`` and grad mode on, each layer and each chunk of the chunked
CE runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` on its layer scan and CE scan): the backward recomputes
their activations instead of keeping them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.embeddings import rank_lookup
from repro_torch.models.layers import (
    AttnConfig,
    MoEConfig,
    attention,
    attn_init,
    cache_heads,
    chunked_attention,
    decode_attention,
    mlp_init,
    moe_ffn,
    moe_init,
    rms_norm,
    swiglu_mlp,
)
from repro_torch.models.params import Params, generator_for, model_device, normal

__all__ = [
    "TransformerConfig",
    "decode_step",
    "extend_cache",
    "forward",
    "init_cache",
    "init_params",
    "init_params_abstract",
    "logits_fn",
    "loss_fn",
    "prefill",
]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field.  ``remat`` recomputes each
    layer's and each CE chunk's activations in the backward (values
    unchanged).  ``scan_unroll`` and ``cache_shard_axes`` steer only XLA's
    layer scan and the KV cache's sharding inside it; the port keeps them
    so that registry configs compare equal, and neither changes a forward
    here."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qkv_bias: bool = False
    window: Optional[int] = None          # sliding-window attention
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    dtype: str = "float32"
    remat: bool = True
    aux_loss_weight: float = 0.01
    scan_unroll: bool = False
    #: "naive" materialises (B, H, S, S) scores; "chunked" = online softmax
    #: over KV chunks of ``attn_chunk``
    attn_impl: str = "naive"
    attn_chunk: int = 1024
    #: "naive" materialises (B, S, V) log-softmax; "chunked" = logsumexp-form
    #: CE over sequence chunks of ``loss_chunk``
    loss_impl: str = "naive"
    loss_chunk: int = 512
    cache_shard_axes: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv=self.n_kv,
            d_head=self.head_dim,
            qkv_bias=self.qkv_bias,
            window=self.window,
            rope_theta=self.rope_theta,
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Total parameters N (for the 6·N·D model-FLOPs term)."""
        D, F_, H, Hk, Dh = self.d_model, self.d_ff, self.n_heads, self.n_kv, self.head_dim
        attn = D * H * Dh + 2 * D * Hk * Dh + H * Dh * D
        if self.qkv_bias:
            attn += H * Dh + 2 * Hk * Dh
        per_layer = attn + 2 * D  # + norms
        if self.moe is not None:
            per_layer += D * self.moe.n_experts  # router
            per_layer += self.moe.n_experts * 3 * D * self.moe.d_ff
            if self.moe.dense_residual:
                per_layer += 3 * D * F_
        else:
            per_layer += 3 * D * F_
        emb = self.vocab * D
        head = 0 if self.tie_embeddings else self.vocab * D
        return self.n_layers * per_layer + emb + head + D

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        D = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * self.moe.n_experts * 3 * D * self.moe.d_ff
        active = self.n_layers * self.moe.top_k * 3 * D * self.moe.d_ff
        return full - all_experts + active


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(generator, cfg: TransformerConfig, device) -> Params:
    dt = cfg.torch_dtype
    p = {
        "attn": attn_init(generator, cfg.attn, dt, device),
        "ln_attn": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "ln_mlp": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if cfg.moe is not None:
        p["moe"] = moe_init(generator, cfg.d_model, cfg.moe, dt, device)
        if cfg.moe.dense_residual:
            p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dt, device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dt, device)
    return Params(**p)


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None, device="cuda") -> Params:
    """Random parameters on ``device`` (the card by default) from
    ``generator`` (a fresh one seeded 0 on that device when None).  The
    draws do not reproduce ``jax.random``; ``repro_torch.models.convert``
    carries the JAX package's own parameters across."""
    dev = model_device(device)
    g = generator_for(generator, dev)
    dt = cfg.torch_dtype
    p = {
        "embed": normal(g, (cfg.vocab, cfg.d_model), dt, 0.02, dev),
        "layers": [_layer_init(g, cfg, dev) for _ in range(cfg.n_layers)],
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = normal(g, (cfg.d_model, cfg.vocab), dt, 0.02, dev)
    return Params(**p)


def init_params_abstract(cfg: TransformerConfig) -> Params:
    """Shape and dtype skeleton on the meta device, without memory (the
    reference's ``jax.eval_shape`` of ``init_params``)."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _attend(layer_p, z, cfg: TransformerConfig, positions, tp=None):
    if cfg.attn_impl == "chunked":
        return chunked_attention(layer_p["attn"], z, cfg.attn, positions, chunk_kv=cfg.attn_chunk, tp=tp)
    return attention(layer_p["attn"], z, cfg.attn, positions, tp=tp)


def _ffn(layer_p, z, cfg: TransformerConfig, group=None, tp=None):
    """The block's FFN on z (B, S, D): SwiGLU, or MoE (plus the dense
    residual for Arctic) over the B·S tokens, with ``group`` and ``tp`` as
    ``moe_ffn``'s.  Returns (y, aux)."""
    if cfg.moe is None:
        return swiglu_mlp(layer_p["mlp"], z, tp), torch.zeros((), dtype=torch.float32, device=z.device)
    B, S, D = z.shape
    y, aux = moe_ffn(layer_p["moe"], z.reshape(B * S, D), cfg.moe, group=group, tp=tp)
    y = y.reshape(B, S, D)
    if cfg.moe.dense_residual:
        y = y + swiglu_mlp(layer_p["mlp"], z, tp)
    return y, aux


def _block(layer_p, x, cfg: TransformerConfig, positions, group=None, tp=None):
    """One layer: returns (x, aux, (k, v))."""
    h, kv = _attend(layer_p, rms_norm(x, layer_p["ln_attn"]), cfg, positions, tp)
    x = x + h
    y, aux = _ffn(layer_p, rms_norm(x, layer_p["ln_mlp"]), cfg, group, tp)
    return x + y, aux, kv


def _remat(cfg: TransformerConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _embed(params, tokens, tp=None):
    """Rows of the embedding table; with ``tp`` this rank's vocabulary rows
    looked up where a token falls in them (zeros elsewhere), summed over
    ``model`` (``embeddings.rank_lookup``)."""
    return rank_lookup(params["embed"], tokens, tp)


def forward(params, cfg: TransformerConfig, tokens, positions=None, group=None, tp=None):
    """tokens: (B, S) integer -> hidden states (B, S, D) and total aux loss.

    ``group``: the process group of the batch axes when tokens are this
    rank's slice of a batch split over its ranks (a sharded step): MoE
    layers then take the whole batch's capacity and statistics
    (``moe_ffn``).  ``tp``: see the module."""
    x = _embed(params, tokens, tp)
    if positions is None:
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(cfg)
    for layer_p in params["layers"]:
        if remat:
            x, aux, _ = checkpoint(_block, layer_p, x, cfg, positions, group, tp, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            x, aux, _ = _block(layer_p, x, cfg, positions, group, tp)
        aux_total = aux_total + aux
    return rms_norm(x, params["ln_f"]), aux_total


def _head(params, cfg: TransformerConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def logits_fn(params, cfg: TransformerConfig, hidden, tp=None):
    """hidden @ head; with ``tp`` the ranks' vocabulary slices all-gathered
    (outside autograd: the serving paths' whole logits)."""
    logits = hidden @ _head(params, cfg)
    return logits if tp is None else tp.all_gather(logits, logits.ndim - 1)


def _ce_chunk(h, head, lab, tp=None):
    if tp is None:
        logits = (h @ head).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        return torch.sum(lse - gold)
    # vocabulary-parallel: this rank's slice of the logits, the max, the sum
    # of exponentials and the gold logit taken over ``model``
    logits = (tp.copy(h) @ head).to(torch.float32)
    Vl = logits.shape[-1]
    m = tp.all_reduce(torch.amax(logits.detach(), dim=-1).contiguous(), dist.ReduceOp.MAX)
    lse = m + torch.log(tp.reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1)))
    local = lab.long() - tp.rank * Vl
    mine = (local >= 0) & (local < Vl)
    gold = torch.gather(logits, -1, torch.clamp(local, 0, Vl - 1)[..., None])[..., 0]
    gold = tp.reduce(torch.where(mine, gold, torch.zeros((), dtype=gold.dtype, device=gold.device)))
    return torch.sum(lse - gold)


def _chunked_ce(params, cfg: TransformerConfig, hidden, labels, tp=None):
    """logsumexp-form CE over sequence chunks: never materialises the full
    (B, S, V) log-softmax; under ``remat`` the backward recomputes each
    chunk's logits."""
    head = _head(params, cfg)
    B, S, D = hidden.shape
    ck = min(cfg.loss_chunk, S)
    remat = _remat(cfg)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S, ck):
        h, lab = hidden[:, lo:lo + ck], labels[:, lo:lo + ck]
        if remat:
            total = total + checkpoint(_ce_chunk, h, head, lab, tp, use_reentrant=False, preserve_rng_state=False)
        else:
            total = total + _ce_chunk(h, head, lab, tp)
    return total / (B * S)


def loss_fn(params, cfg: TransformerConfig, tokens, labels, group=None, tp=None):
    """The LM loss: (CE + aux_loss_weight · aux, parts); ``group`` and
    ``tp`` as ``forward``'s (with ``tp`` the CE is vocabulary-parallel in
    both forms)."""
    hidden, aux = forward(params, cfg, tokens, group=group, tp=tp)
    if cfg.loss_impl == "chunked":
        loss = _chunked_ce(params, cfg, hidden, labels, tp)
        return loss + cfg.aux_loss_weight * aux, {"ce": loss, "aux": aux}
    if tp is not None:
        loss = _ce_chunk(hidden, _head(params, cfg), labels, tp) / labels.numel()
        return loss + cfg.aux_loss_weight * aux, {"ce": loss, "aux": aux}
    logits = logits_fn(params, cfg, hidden).to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    loss = -torch.mean(ll)
    return loss + cfg.aux_loss_weight * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, cache_len: int, device="cuda"):
    """Ring-buffer KV cache (L, B, C, Hk, Dh); for SWA configs cache_len
    should be the window.  ``pos`` -1 marks an empty entry."""
    dev = model_device(device)
    L, Hk, Dh = cfg.n_layers, cfg.n_kv, cfg.head_dim
    dt = cfg.torch_dtype
    return {
        "k": torch.zeros((L, batch, cache_len, Hk, Dh), dtype=dt, device=dev),
        "v": torch.zeros((L, batch, cache_len, Hk, Dh), dtype=dt, device=dev),
        "pos": torch.full((L, batch, cache_len), -1, dtype=torch.int32, device=dev),
    }


def prefill(params, cfg: TransformerConfig, tokens, group=None, tp=None):
    """Full-sequence forward; returns (last-position logits (B, V) f32,
    filled cache).  The cache holds the last min(S, window) positions (all
    S without a window) in ring layout, slot = pos % cache_len.  ``group``
    and ``tp`` as ``forward``'s: the cache is then this rank's
    ``kv_cache_specs`` shard, the logits whole."""
    B, S = tokens.shape
    x = _embed(params, tokens, tp)
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    cache_len = min(S, cfg.window) if cfg.window is not None else S
    shift = S % cache_len if cfg.window is not None else 0
    ks, vs = [], []
    for layer_p in params["layers"]:
        x, _, (k, v) = _block(layer_p, x, cfg, positions, group, tp)
        ks.append(cache_heads(torch.roll(k[:, -cache_len:], shift, dims=1), cfg.attn, tp))
        vs.append(cache_heads(torch.roll(v[:, -cache_len:], shift, dims=1), cfg.attn, tp))
    pos_tail = torch.roll(positions[:, -cache_len:], shift, dims=1)
    x = rms_norm(x, params["ln_f"])
    logits = logits_fn(params, cfg, x[:, -1:], tp).to(torch.float32)
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "pos": pos_tail.expand(cfg.n_layers, B, cache_len).contiguous(),
    }
    return logits[:, 0], cache


def extend_cache(cfg: TransformerConfig, cache, new_len: int):
    """Re-place a prefill cache into a larger ring (slot = pos % new_len),
    for decoding past the prefilled length on a full-attention config.
    Only filled entries (pos >= 0) move."""
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    L, B, C = pos.shape
    nk = k.new_zeros((L, B, new_len) + tuple(k.shape[3:]))
    nv = v.new_zeros((L, B, new_len) + tuple(v.shape[3:]))
    npos = torch.full((L, B, new_len), -1, dtype=pos.dtype, device=pos.device)
    l_i, b_i, c_i = torch.nonzero(pos >= 0, as_tuple=True)
    slots = (pos[l_i, b_i, c_i] % new_len).long()
    nk[l_i, b_i, slots] = k[l_i, b_i, c_i]
    nv[l_i, b_i, slots] = v[l_i, b_i, c_i]
    npos[l_i, b_i, slots] = pos[l_i, b_i, c_i]
    return {"k": nk, "v": nv, "pos": npos}


def decode_step(params, cfg: TransformerConfig, token, pos, cache, group=None, tp=None):
    """token: (B,) integer; pos: (B,) integer; cache from init_cache,
    prefill or extend_cache, updated in place and returned.  Returns
    (logits (B, V) f32, cache).  ``group`` and ``tp`` as ``prefill``'s."""
    B = token.shape[0]
    x = _embed(params, token[:, None], tp)
    for li, layer_p in enumerate(params["layers"]):
        h, _ = decode_attention(
            layer_p["attn"], rms_norm(x, layer_p["ln_attn"]), cfg.attn,
            cache["k"][li], cache["v"][li], cache["pos"][li], pos, tp=tp,
        )
        x = x + h
        z = rms_norm(x, layer_p["ln_mlp"])
        if cfg.moe is not None:
            y, _ = moe_ffn(layer_p["moe"], z.reshape(B, -1), cfg.moe, group=group, tp=tp)
            y = y.reshape(B, 1, -1)
            if cfg.moe.dense_residual:
                y = y + swiglu_mlp(layer_p["mlp"], z, tp)
        else:
            y = swiglu_mlp(layer_p["mlp"], z, tp)
        x = x + y
    x = rms_norm(x, params["ln_f"])
    logits = logits_fn(params, cfg, x, tp).to(torch.float32)
    return logits[:, 0], cache
