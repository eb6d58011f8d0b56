"""The five assigned LM-family architectures (exact public configs).

Smoke configs are same-family reductions: few layers, narrow width, small
vocab, few experts — enough to exercise every code path on CPU.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.layers import MoEConfig
from repro_torch.models.transformer import TransformerConfig


@register("minitron-4b")
def minitron_4b() -> ArchSpec:
    cfg = TransformerConfig(
        name="minitron-4b",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv=8,
        d_head=128,
        d_ff=9216,
        vocab=256_000,
        dtype="bfloat16",
    )
    smoke = TransformerConfig(
        name="minitron-4b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        dtype="float32",
    )
    return ArchSpec(
        "minitron-4b",
        "lm",
        "pruned nemotron [arXiv:2407.14679; hf]",
        cfg,
        lm_shapes(full_attention=True),
        smoke,
    )


@register("yi-6b")
def yi_6b() -> ArchSpec:
    cfg = TransformerConfig(
        name="yi-6b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=4,
        d_head=128,
        d_ff=11008,
        vocab=64_000,
        dtype="bfloat16",
    )
    smoke = TransformerConfig(
        name="yi-6b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=160,
        vocab=512,
        dtype="float32",
    )
    return ArchSpec(
        "yi-6b",
        "lm",
        "llama-arch GQA [arXiv:2403.04652; hf]",
        cfg,
        lm_shapes(full_attention=True),
        smoke,
    )


@register("qwen2-1.5b")
def qwen2_1_5b() -> ArchSpec:
    cfg = TransformerConfig(
        name="qwen2-1.5b",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv=2,
        d_head=128,
        d_ff=8960,
        vocab=151_936,
        qkv_bias=True,
        tie_embeddings=True,
        dtype="bfloat16",
    )
    smoke = TransformerConfig(
        name="qwen2-1.5b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        tie_embeddings=True,
        dtype="float32",
    )
    return ArchSpec(
        "qwen2-1.5b",
        "lm",
        "GQA, QKV bias [arXiv:2407.10671; hf]",
        cfg,
        lm_shapes(full_attention=True),
        smoke,
    )


@register("arctic-480b")
def arctic_480b() -> ArchSpec:
    cfg = TransformerConfig(
        name="arctic-480b",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv=8,
        d_head=128,
        d_ff=4864,
        vocab=32_000,
        moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, dense_residual=True),
        dtype="bfloat16",
    )
    smoke = TransformerConfig(
        name="arctic-480b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=96,
        vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=96, dense_residual=True),
        dtype="float32",
    )
    return ArchSpec(
        "arctic-480b",
        "lm",
        "128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]",
        cfg,
        lm_shapes(full_attention=True),
        smoke,
    )


@register("mixtral-8x7b")
def mixtral_8x7b() -> ArchSpec:
    cfg = TransformerConfig(
        name="mixtral-8x7b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        d_head=128,
        d_ff=14336,
        vocab=32_000,
        window=4096,  # sliding-window attention => long_500k runs (O(W) cache)
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336),
        dtype="bfloat16",
    )
    smoke = TransformerConfig(
        name="mixtral-8x7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        window=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128),
        dtype="float32",
    )
    return ArchSpec(
        "mixtral-8x7b",
        "lm",
        "8 experts top-2, SWA [arXiv:2401.04088]",
        cfg,
        lm_shapes(full_attention=False),
        smoke,
    )
