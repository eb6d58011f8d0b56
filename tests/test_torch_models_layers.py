"""The port's layer functions (``repro_torch.models.layers``,
``embeddings``) and the parameter bridge against the JAX package on the
CPU, each on random f32 inputs from a numpy seed.

Twin of ``tests/test_optimized_paths.py::TestChunkedAttention`` (chunked
against naive attention, port against JAX).  Tolerance 2e-5 (absolute and
relative) for one layer function in f32; bit-equality where the arithmetic
is a gather or a bf16 cast.  Gradients come with the optimiser (not in
this slice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models_bridge import LAYER_TOL, as_t, close, np_tree, rlayers_j

from repro.models import embeddings as remb, layers as rlayers
from repro_torch.models import embeddings as emb, layers
from repro_torch.models.convert import from_reference
from repro_torch.sharding import make_scaleout_mesh, place_rows

torch.set_num_threads(2)



def _attn(qkv_bias=False, window=None, seed=0):
    cfg = dict(d_model=32, n_heads=4, n_kv=2, d_head=8, qkv_bias=qkv_bias, window=window)
    rcfg, pcfg = rlayers.AttnConfig(**cfg), layers.AttnConfig(**cfg)
    rp = rlayers.attn_init(jax.random.PRNGKey(seed), rcfg)
    if qkv_bias:  # zero-initialised in both packages: give them values
        rng = np.random.default_rng(seed)
        rp = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1) if k[0] == "b" else v)
              for k, v in rp.items()}
    return rcfg, pcfg, rp, from_reference(pcfg, np_tree(rp), device="cpu")


def test_rms_norm():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    close(layers.rms_norm(as_t(x), as_t(w)), rlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)), LAYER_TOL)


@pytest.mark.parametrize("theta", [10000.0, 500.0])
def test_rope(theta):
    """Split-half rotation with f32 angles; positions up to 5,000 make
    angles of ~5e3 rad, whose f32 sin/cos differ by a few 1e-5 between
    libraries, hence 1e-4 here."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    close(layers.rope_freqs(16, theta, device="cpu"), rlayers.rope_freqs(16, theta), LAYER_TOL)
    pos = rng.integers(0, 5000, size=(2, 5)).astype(np.int32)
    close(layers.apply_rope(as_t(x), as_t(pos), theta), rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
          1e-4)


def test_rms_norm_casts_before_the_weight_in_bf16():
    """bf16: the normalised activations round to bf16 before the weight
    multiplies them, as in the reference."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = (1 + rng.normal(size=(64,)) * 0.3).astype(np.float32)
    got = layers.rms_norm(as_t(x).bfloat16(), as_t(w).bfloat16()).float().numpy()
    want = np.asarray(rlayers.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("window", [None, 8])
def test_attention(qkv_bias, window):
    rcfg, pcfg, rp, pp = _attn(qkv_bias, window)
    x = np.random.default_rng(3).normal(size=(2, 21, 32)).astype(np.float32)
    want, (rk, rv) = rlayers_j.attention(rp, jnp.asarray(x), rcfg)
    got, (k, v) = layers.attention(pp, as_t(x), pcfg)
    close(got, want, LAYER_TOL)
    close(k, rk, LAYER_TOL)
    close(v, rv, LAYER_TOL)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("S,chunk", [(16, 4), (33, 8), (64, 64), (40, 128)])
def test_chunked_attention_matches_naive(S, chunk, window):
    """Twin of ``TestChunkedAttention::test_matches_naive``: the port's
    chunked path against the reference's naive and chunked paths."""
    rcfg, pcfg, rp, pp = _attn(window=window)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, S, 32)))
    want, _ = rlayers_j.attention(rp, jnp.asarray(x), rcfg)
    want_c, _ = jax.jit(rlayers.chunked_attention, static_argnums=(2,), static_argnames=("chunk_kv",))(
        rp, jnp.asarray(x), rcfg, chunk_kv=chunk)
    got, _ = layers.chunked_attention(pp, as_t(x), pcfg, chunk_kv=chunk)
    naive, _ = layers.attention(pp, as_t(x), pcfg)
    close(got, want, 2e-5)
    close(got, want_c, 2e-5)
    close(got, naive, 2e-5)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_ring(window):
    """A cache of C = 6 slots, partly empty, then wrapped: every step's
    output and the written ring equal the reference's."""
    rcfg, pcfg, rp, pp = _attn(qkv_bias=True, window=window, seed=4)
    rng = np.random.default_rng(5)
    B, C = 2, 6
    rk = jnp.zeros((B, C, 2, 8))
    rv = jnp.zeros((B, C, 2, 8))
    rpos = jnp.full((B, C), -1, jnp.int32)
    k, v, cpos = torch.zeros((B, C, 2, 8)), torch.zeros((B, C, 2, 8)), torch.full((B, C), -1, dtype=torch.int32)
    for step in range(9):
        x = rng.normal(size=(B, 1, 32)).astype(np.float32)
        pos = np.array([step, step + 1], np.int32)
        want, (rk, rv, rpos) = rlayers_j.decode_attention(rp, jnp.asarray(x), rcfg, rk, rv, rpos, jnp.asarray(pos))
        got, (k, v, cpos) = layers.decode_attention(pp, as_t(x), pcfg, k, v, cpos, as_t(pos))
        close(got, want, LAYER_TOL)
        close(k, rk, LAYER_TOL)
        np.testing.assert_array_equal(cpos.numpy(), np.asarray(rpos))


def test_swiglu_mlp():
    rp = rlayers.mlp_init(jax.random.PRNGKey(6), 24, 40)
    pp = from_reference(None, np_tree(rp), device="cpu")
    x = np.random.default_rng(7).normal(size=(3, 5, 24)).astype(np.float32)
    close(layers.swiglu_mlp(pp, as_t(x)), rlayers.swiglu_mlp(rp, jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("case", [
    dict(n_experts=4, top_k=2, d_ff=32),                                   # capacity drops tokens
    dict(n_experts=4, top_k=2, d_ff=32, capacity_factor=32.0),             # drop-free
    dict(n_experts=8, top_k=2, d_ff=32, dispatch="local", n_batch_shards=4),
    dict(n_experts=8, top_k=2, d_ff=32, dispatch="local", n_batch_shards=5),  # does not divide: one shard
    dict(n_experts=6, top_k=1, d_ff=16),
])
def test_moe_ffn(case):
    rcfg, pcfg = rlayers.MoEConfig(**case), layers.MoEConfig(**case)
    rp = rlayers.moe_init(jax.random.PRNGKey(8), 16, rcfg)
    pp = from_reference(None, np_tree(rp), device="cpu")
    x = np.random.default_rng(9).normal(size=(32, 16)).astype(np.float32)
    want, raux = rlayers_j.moe_ffn(rp, jnp.asarray(x), rcfg)
    got, aux = layers.moe_ffn(pp, as_t(x), pcfg)
    close(got, want, LAYER_TOL)
    close(aux, raux, LAYER_TOL)


def test_moe_top_k_ties_take_the_lower_expert():
    """A router whose probabilities tie: the lower expert index wins, as in
    ``jax.lax.top_k``, and capacity keeps the first tokens in token order."""
    cfg = dict(n_experts=4, top_k=2, d_ff=8)
    rcfg, pcfg = rlayers.MoEConfig(**cfg), layers.MoEConfig(**cfg)
    rp = dict(rlayers.moe_init(jax.random.PRNGKey(10), 8, rcfg))
    rp["w_router"] = jnp.zeros((8, 4))                     # every expert ties
    pp = from_reference(None, np_tree(rp), device="cpu")
    x = np.random.default_rng(11).normal(size=(12, 8)).astype(np.float32)
    want, _ = rlayers_j.moe_ffn(rp, jnp.asarray(x), rcfg)
    got, _ = layers.moe_ffn(pp, as_t(x), pcfg)
    close(got, want, LAYER_TOL)


def test_lookup_and_embedding_bag():
    spec_args = dict(vocab_sizes=(50, 40, 30), dim=6)
    rspec, pspec = remb.EmbeddingSpec(**spec_args), emb.EmbeddingSpec(**spec_args)
    assert emb.padded_rows(pspec) == remb.padded_rows(rspec) == emb.ROW_PAD
    table = np.asarray(remb.embedding_init(jax.random.PRNGKey(3), rspec))
    rng = np.random.default_rng(12)
    ids = np.stack([rng.integers(0, v, size=10) for v in (50, 40, 30)], axis=1).astype(np.int32)
    np.testing.assert_array_equal(emb.flat_ids(pspec, as_t(ids)).numpy(), np.asarray(remb.flat_ids(rspec, jnp.asarray(ids))))
    np.testing.assert_array_equal(emb.lookup(as_t(table), pspec, as_t(ids)).numpy(),
                                  np.asarray(remb.lookup(jnp.asarray(table), rspec, jnp.asarray(ids))))
    flat = rng.integers(0, 120, size=40).astype(np.int32)
    bags = np.sort(rng.integers(0, 7, size=40)).astype(np.int32)   # bag 7 stays empty
    for mode in ("sum", "mean"):
        want = remb.embedding_bag(jnp.asarray(table), rspec, jnp.asarray(flat), jnp.asarray(bags), 8, mode)
        got = emb.embedding_bag(as_t(table), pspec, as_t(flat), as_t(bags), 8, mode)
        close(got, want, LAYER_TOL)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_lookup_equals_lookup(n_dev):
    """The table's rows split over a grid of CPU devices (``place_rows``):
    a masked take per device, then a sum, equals the unsharded lookup."""
    spec = emb.EmbeddingSpec(vocab_sizes=(500, 300, 200, 24), dim=4)
    table = torch.randn(emb.padded_rows(spec), 4, generator=torch.Generator().manual_seed(0))
    ids = torch.as_tensor(np.stack([np.random.default_rng(13).integers(0, v, size=16)
                                    for v in spec.vocab_sizes], axis=1).astype(np.int32))
    shards = place_rows(make_scaleout_mesh(devices=[torch.device("cpu")] * n_dev), table)[0]
    assert len(shards) == n_dev
    np.testing.assert_array_equal(emb.sharded_lookup(shards, spec, ids).numpy(), emb.lookup(table, spec, ids).numpy())
