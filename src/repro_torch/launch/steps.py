"""Cell plans: one (arch x shape x mesh) -> a step function, its
arguments as meta-device tensors (shapes and dtypes without memory, the
counterpart of the reference's ``ShapeDtypeStruct``s) and explicit in/out
``PartitionSpec`` trees.  The JAX package's ``launch/steps.py`` cell for
cell: the same kinds, notes, skips, model FLOPs and spec trees.

Conventions:
  * train steps take (params, opt_state, batch...) and return (params,
    opt_state, metrics); the LM cells (and the RecSys sequence models at a
    large batch) accumulate microbatch gradients over ``accum`` in a Python
    loop, in the parameter dtype, and divide by ``accum`` before the one
    optimizer update.  ``apply_updates`` updates in place.
  * decode steps take (params, token, pos, cache) -> (logits, cache).
  * a step runs eagerly on real tensors of the shapes in ``args`` (the
    tests run reduced cells on the CPU); it reads the devices of its
    inputs and needs none of the mesh's.
  * the paper's own cell runs ``build_serve_step`` (K4 and K3 on the card
    with ``opt=True``) over the mesh's devices as the search half's
    ``(replica, data)`` grid, or on a ``ProcessMesh`` on each rank over its
    row slice of the table.

The port's transformer parameters keep one tree per layer, so each layer
spec is the reference's without its leading (n_layers,) entry.

Sharded execution runs one process per rank on a ``ProcessMesh``
(``repro_torch.launch.mesh.make_process_mesh``) for the LM train,
prefill and decode cells, ``opt`` or not: parameters, moments and caches
stay in the spec's layout at rest, each rank takes its slice of the batch
over ``pod``/``data`` (the whole batch where it does not divide),
gathers the parameters over the batch axes only (FSDP) and computes in
the tensor-parallel layout over ``model`` (``models.layers``: heads,
``d_ff``, experts and vocabulary split, the conjugate collectives of the
``model`` group), which reproduces the reference's GSPMD numbers in its
layout.  Gradients are averaged over the batch axes and reduce-scattered
to the moments' shards; under ``moe_local`` (the ``opt`` cells) the
expert weights replicate over ``data`` while their moments stay sharded
over it, and AdamW all-gathers each update into the replicated weight.
A head count that ``|model|`` does not divide takes GSPMD's padded split
of the heads (``models.layers``).

The other families run on a ``ProcessMesh`` too.  RecSys: the tables'
rows split over ``model`` and every read is a masked take of this rank's
rows summed over ``model`` (``embeddings.rank_lookup``), the interaction
weights replicate, the batch (and the retrieval cell's candidates) split
over the batch axes, and the sequence models' in-batch negatives are the
whole batch's targets, all-gathered.  GCN: the weights replicate; the full
graphs' edge list splits over the batch axes, each rank's partial degrees
and aggregates summed over them, the sampled and molecule batches split
over them.  Their gradients are averaged over the batch axes.  The search
serve cell: each rank projects the replicated query block and filters its
row slice of the table (``search.distributed.build_process_filter``: the
histograms all-reduced, the candidate slots all-gathered).  A mesh of
several distinct devices in one process still refuses
(``to_named_shardings``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models import gcn as gcn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.embeddings import rank_lookup
from repro_torch.models.layers import TensorParallel
from repro_torch.models.params import tree_leaves, tree_map, value_and_grad
from repro_torch.sharding.rules import (
    NamedSharding,
    PartitionSpec as P,
    ProcessMesh,
    batch_spec,
    gcn_param_specs,
    kv_cache_specs,
    lm_param_specs,
    recsys_param_specs,
    to_named_shardings,
)
from repro_torch.train.optimizer import AdamWConfig, apply_updates

__all__ = ["CellPlan", "all_cells", "build_cell", "lm_cell_cfg", "lm_decode_step", "lm_prefill_step",
           "lm_step_specs", "lm_train_step"]


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: tuple                 # meta-device tensors (or real tensors for runs)
    in_specs: tuple             # PartitionSpec trees matching args
    out_specs: Any
    model_flops: float          # analytic "useful" FLOPs (6ND / 2ND etc.)
    note: str = ""
    skip: Optional[str] = None


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _replicated(tree):
    return tree_map(lambda l: P(*([None] * len(l.shape))), tree)


def _batch_shards(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def _batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _opt_cfg() -> AdamWConfig:
    return AdamWConfig(moment_dtype="bfloat16")


def _opt_state_abstract(params_abs):
    return {
        "step": _sds((), torch.int32),
        "m": tree_map(lambda l: _sds(l.shape, torch.bfloat16), params_abs),
        "v": tree_map(lambda l: _sds(l.shape, torch.bfloat16), params_abs),
    }


def _opt_state_specs(param_specs):
    return {"step": P(), "m": param_specs, "v": param_specs}


def _accumulated_grads(params, loss_of, microbatches):
    """Σ over ``microbatches`` of d loss_of(params, mb) / d params, added in
    the parameter dtype, divided by their count; and the mean loss."""
    grads = tree_map(lambda l: torch.zeros(l.shape, dtype=l.dtype, device=l.device), params)
    losses = []
    for mb in microbatches:
        loss, g = value_and_grad(lambda p: loss_of(p, mb), params)
        for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
            acc.add_(gi)
        del g                       # before the next microbatch's gradients exist
        losses.append(loss)
    for acc in tree_leaves(grads):
        acc.div_(len(losses))
    return grads, torch.mean(torch.stack(losses))


def _sharded_update(opt_cfg, mesh, params, grads, opt_state, loss, shardings, mshardings):
    """A rank's AdamW update of its shards: each gradient (this rank's
    chunk over ``model``) averaged over the batch axes and reduce-scattered
    to the moments' shards (``mshardings``), the loss averaged over the
    batch axes."""
    batch = _batch_axes(mesh)
    grads = tree_map(lambda g, s: s.reduce_scatter(g, batch, local=("model",)), grads, mshardings)
    if batch:
        dist.all_reduce(loss, group=mesh.group(batch))
        loss = loss / mesh.axis_size(batch)
    params, opt_state, om = apply_updates(opt_cfg, params, grads, opt_state, shardings, mshardings)
    return params, opt_state, {"loss": loss, **om}


# ===========================================================================
# LM cells
# ===========================================================================

def _moe_local(cfg) -> bool:
    return cfg.moe is not None and cfg.moe.dispatch == "local"


def lm_step_specs(cfg, mesh, param_specs=None, moment_specs=None):
    """(parameter specs, moment specs): ``lm_param_specs``, the parameters'
    with ``moe_local`` for a local-dispatch config (expert weights
    replicated over ``data``), the moments' without it (ZeRO-sharded)."""
    abstract = tf_mod.init_params_abstract(cfg)
    if param_specs is None:
        param_specs = lm_param_specs(abstract, mesh, n_experts=_n_experts(cfg), moe_local=_moe_local(cfg))
    if moment_specs is None:
        moment_specs = lm_param_specs(abstract, mesh, n_experts=_n_experts(cfg))
    return param_specs, moment_specs


def _compute_params(params, shardings, batch):
    """This rank's parameters in the layout the step computes in: gathered
    over the batch axes (FSDP), this rank's chunk over ``model``."""
    return tree_map(lambda p, s: s.gather(p, batch), params, shardings)


def lm_train_step(cfg, opt_cfg: AdamWConfig, mesh: Optional[ProcessMesh] = None, param_specs=None,
                  moment_specs=None):
    """The LM train cell's step ``(params, opt_state, tokens, labels) ->
    (params, opt_state, {"loss", "grad_norm", "lr"})`` for tokens and labels
    of shape (accum, B, S): microbatch gradients summed in the parameter
    dtype and divided by ``accum``, then one AdamW update in place.

    ``mesh``: a ``ProcessMesh``; ``param_specs`` / ``moment_specs``: the
    spec trees of the parameters and of the moments (``lm_step_specs``).  Then
    params and opt_state are this rank's shards, tokens and labels its
    (accum, B / batch shards, S) slice, and per step the parameters are
    all-gathered over the batch axes, each microbatch's loss runs
    tensor-parallel over ``model`` with the batch axes' group (MoE capacity
    and statistics of the whole batch), gradients (this rank's ``model``
    chunks) are averaged over the batch axes and reduce-scattered to the
    moments' shards, and the loss is the batch's mean.  The step's
    ``tensor_parallel`` attribute is its ``TensorParallel`` (None without
    a split ``model`` axis)."""
    loss_of = lambda p, mb: tf_mod.loss_fn(p, cfg, *mb)[0]  # noqa: E731
    if mesh is None:
        def step(params, opt_state, tokens, labels):
            grads, loss = _accumulated_grads(params, loss_of, zip(tokens, labels))
            params, opt_state, om = apply_updates(opt_cfg, params, grads, opt_state)
            return params, opt_state, {"loss": loss, **om}

        return step
    param_specs, moment_specs = lm_step_specs(cfg, mesh, param_specs, moment_specs)
    shardings = to_named_shardings(param_specs, mesh)
    mshardings = to_named_shardings(moment_specs, mesh)
    batch = _batch_axes(mesh)
    tp = TensorParallel.of(mesh)

    def step(params, opt_state, tokens, labels):
        group = mesh.group(batch) if batch else None
        full = _compute_params(params, shardings, batch)
        grads, loss = _accumulated_grads(
            full, lambda p, mb: tf_mod.loss_fn(p, cfg, *mb, group=group, tp=tp)[0], zip(tokens, labels))
        del full
        return _sharded_update(opt_cfg, mesh, params, grads, opt_state, loss, shardings, mshardings)

    step.tensor_parallel = tp
    return step


def _batch_group(mesh, B: int):
    """The batch axes' process group when a batch of B splits over them,
    else None (every batch rank then runs the whole batch)."""
    batch = _batch_axes(mesh)
    return mesh.group(batch) if batch and B % _batch_shards(mesh) == 0 and B >= _batch_shards(mesh) else None


def lm_prefill_step(cfg, mesh: Optional[ProcessMesh] = None, batch: int = 1, param_specs=None):
    """The LM prefill cell's step ``(params, tokens) -> (logits, cache)``.
    On a ``ProcessMesh``: params are this rank's shards, tokens its slice of
    a batch of ``batch`` over the batch axes (the whole batch where it does
    not divide), the logits whole over the vocabulary and the cache this
    rank's ``kv_cache_specs`` shard; ``tensor_parallel`` as
    ``lm_train_step``'s."""
    if mesh is None:
        return lambda params, tokens: tf_mod.prefill(params, cfg, tokens)
    shardings = to_named_shardings(lm_step_specs(cfg, mesh, param_specs)[0], mesh)
    axes, tp = _batch_axes(mesh), TensorParallel.of(mesh)

    def step(params, tokens):
        return tf_mod.prefill(_compute_params(params, shardings, axes), cfg, tokens, group=_batch_group(mesh, batch),
                              tp=tp)

    step.tensor_parallel = tp
    return step


def lm_decode_step(cfg, mesh: Optional[ProcessMesh] = None, batch: int = 1, param_specs=None):
    """The LM decode cell's step ``(params, token, pos, cache) -> (logits,
    cache)``; on a ``ProcessMesh`` as ``lm_prefill_step``'s (token and pos
    this rank's batch slice, the cache its shard, updated in place)."""
    if mesh is None:
        return lambda params, token, pos, cache: tf_mod.decode_step(params, cfg, token, pos, cache)
    shardings = to_named_shardings(lm_step_specs(cfg, mesh, param_specs)[0], mesh)
    axes, tp = _batch_axes(mesh), TensorParallel.of(mesh)

    def step(params, token, pos, cache):
        return tf_mod.decode_step(_compute_params(params, shardings, axes), cfg, token, pos, cache,
                                  group=_batch_group(mesh, batch), tp=tp)

    step.tensor_parallel = tp
    return step


def _lm_opt_cfg(cfg, mesh):
    """§Perf levers: chunked attention + chunked CE + local MoE dispatch."""
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg,
            moe=dataclasses.replace(
                cfg.moe, dispatch="local", batch_axes=_batch_axes(mesh), n_batch_shards=_batch_shards(mesh),
            ),
        )
    return dataclasses.replace(cfg, attn_impl="chunked", attn_chunk=1024, loss_impl="chunked", loss_chunk=512)


def _n_experts(cfg):
    return cfg.moe.n_experts if cfg.moe else None


def lm_cell_cfg(cfg, kind: str, mesh, *, opt: bool = False, batch: int = 1, seq: int = 1):
    """The config an LM cell of ``kind`` (train, prefill or decode) computes
    with for a batch of ``batch`` x ``seq`` tokens: ``cfg`` itself, or under
    ``opt`` the §Perf levers (``_lm_opt_cfg``), which a prefill extends with
    the cache's batch axes and MoE dispatch in 4,096-token blocks (capacity
    per block).  Decode is single-token: chunked attention and CE do not
    apply."""
    if not opt or kind == "decode":
        return cfg
    cfg = _lm_opt_cfg(cfg, mesh)
    if kind == "prefill":
        shards = _batch_shards(mesh)
        cfg = dataclasses.replace(
            cfg, cache_shard_axes=_batch_axes(mesh) if batch % shards == 0 and batch >= shards else ())
        if cfg.moe is not None:
            sub = max(1, (batch * seq) // shards // 4096)
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, n_batch_shards=cfg.moe.n_batch_shards * sub))
    return cfg


def _lm_train(arch: ArchSpec, shape: ShapeSpec, mesh, *, n_layers=None, accum_override=None, unroll=False,
              opt=False, opt_cfg=None) -> CellPlan:
    cfg = lm_cell_cfg(arch.model_cfg, "train", mesh, opt=opt)
    if n_layers is not None or unroll:
        cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, scan_unroll=unroll)
    S = shape.sizes["seq_len"]
    GB = shape.sizes["global_batch"]
    micro = _batch_shards(mesh)          # 1 sequence per batch shard per microstep
    accum = accum_override or max(1, GB // micro)

    params_abs = tf_mod.init_params_abstract(cfg)
    pspecs = lm_param_specs(params_abs, mesh, n_experts=_n_experts(cfg), moe_local=opt)
    opt_abs = _opt_state_abstract(params_abs)
    # moments stay ZeRO-sharded over data even when params go moe-local
    ospecs = _opt_state_specs(lm_param_specs(params_abs, mesh, n_experts=_n_experts(cfg)))
    opt_cfg = opt_cfg or _opt_cfg()

    tokens = _sds((accum, micro, S), torch.int32)
    labels = _sds((accum, micro, S), torch.int32)
    dspec = P(None, _batch_axes(mesh), None)

    process = mesh if isinstance(mesh, ProcessMesh) else None
    step = lm_train_step(cfg, opt_cfg, process, pspecs, ospecs["m"])

    return CellPlan(
        arch.arch_id, shape.name, "train", step,
        (params_abs, opt_abs, tokens, labels),
        (pspecs, ospecs, dspec, dspec),
        (pspecs, ospecs, P()),
        6.0 * cfg.active_param_count() * GB * S,
        note=f"accum={accum} micro={micro}",
        skip=shape.skip,
    )


def _lm_prefill(arch: ArchSpec, shape: ShapeSpec, mesh, *, n_layers=None, unroll=False, opt=False) -> CellPlan:
    cfg = lm_cell_cfg(arch.model_cfg, "prefill", mesh, opt=opt, batch=shape.sizes["global_batch"],
                      seq=shape.sizes["seq_len"])
    if n_layers is not None or unroll:
        cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, scan_unroll=unroll)
    S = shape.sizes["seq_len"]
    B = shape.sizes["global_batch"]
    params_abs = tf_mod.init_params_abstract(cfg)
    pspecs = lm_param_specs(params_abs, mesh, n_experts=_n_experts(cfg))
    tokens = _sds((B, S), torch.int32)

    step = lm_prefill_step(cfg, mesh if isinstance(mesh, ProcessMesh) else None, B, pspecs)
    cache_len = min(S, cfg.window) if cfg.window else S
    cspecs = kv_cache_specs(tf_mod.init_cache(cfg, B, cache_len, device="meta"), mesh, batch=B)
    return CellPlan(
        arch.arch_id, shape.name, "prefill", step,
        (params_abs, tokens),
        (pspecs, batch_spec(mesh, extra_dims=1)),
        (batch_spec(mesh, 1), cspecs),
        2.0 * cfg.active_param_count() * B * S,
        skip=shape.skip,
    )


def _lm_decode(arch: ArchSpec, shape: ShapeSpec, mesh, *, n_layers=None, unroll=False, opt=False) -> CellPlan:
    cfg = lm_cell_cfg(arch.model_cfg, "decode", mesh, opt=opt)
    if n_layers is not None or unroll:
        cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, scan_unroll=unroll)
    S = shape.sizes["seq_len"]
    B = shape.sizes["global_batch"]
    cache_len = min(S, cfg.window) if cfg.window else S
    params_abs = tf_mod.init_params_abstract(cfg)
    pspecs = lm_param_specs(params_abs, mesh, n_experts=_n_experts(cfg))
    cache_abs = tf_mod.init_cache(cfg, B, cache_len, device="meta")
    cspecs = kv_cache_specs(cache_abs, mesh, batch=B)
    shards = _batch_shards(mesh)
    split = B % shards == 0 and B >= shards
    bspec = batch_spec(mesh, 0) if split else P(None)
    token = _sds((B,), torch.int32)
    pos = _sds((B,), torch.int32)

    step = lm_decode_step(cfg, mesh if isinstance(mesh, ProcessMesh) else None, B, pspecs)
    return CellPlan(
        arch.arch_id, shape.name, "decode", step,
        (params_abs, token, pos, cache_abs),
        (pspecs, bspec, bspec, cspecs),
        (P(_batch_axes(mesh), None) if split else P(None, None), cspecs),
        2.0 * cfg.active_param_count() * B,   # 2·N_active per token
        note=f"cache_len={cache_len}",
        skip=shape.skip,
    )


# ===========================================================================
# GNN cells
# ===========================================================================

def _process(mesh) -> Optional[ProcessMesh]:
    return mesh if isinstance(mesh, ProcessMesh) else None


def _train_step(opt_cfg, loss_of, microbatches=None, mesh: Optional[ProcessMesh] = None, param_specs=None):
    """(params, opt_state, *batch) -> (params, opt_state, metrics): the
    gradient of ``loss_of(params, *batch)`` (or, with ``microbatches``, a
    function of the batch giving each microbatch's arguments, their mean)
    and one AdamW update.  On ``mesh`` params and opt_state are this rank's
    shards under ``param_specs`` and the batch its slice: the gradients
    and the loss averaged over the batch axes (``_sharded_update``)."""
    if microbatches is None:
        microbatches = lambda *batch: [batch]  # noqa: E731
    shardings = None if mesh is None else to_named_shardings(param_specs, mesh)

    def step(params, opt_state, *batch):
        grads, loss = _accumulated_grads(params, lambda p, mb: loss_of(p, *mb), microbatches(*batch))
        if mesh is None:
            params, opt_state, om = apply_updates(opt_cfg, params, grads, opt_state)
            return params, opt_state, {"loss": loss, **om}
        return _sharded_update(opt_cfg, mesh, params, grads, opt_state, loss, shardings, shardings)

    return step


def _gcn_cell(arch: ArchSpec, shape: ShapeSpec, mesh, opt_cfg=None) -> CellPlan:
    base: gcn_mod.GCNConfig = arch.model_cfg
    s = shape.sizes
    edge_axes = _batch_axes(mesh)
    process = _process(mesh)
    note = ""

    if shape.name in ("full_graph_sm", "ogb_products"):
        cfg = dataclasses.replace(base, d_feat=s["d_feat"], n_classes=s["n_classes"])
        N, E = s["n_nodes"], s["n_edges"]
        E_pad = ((E + 511) // 512) * 512   # align edge shards to the mesh
        args = (_sds((N, cfg.d_feat), torch.float32), _sds((2, E_pad), torch.int32),
                _sds((E_pad,), torch.float32),  # 0.0 marks padding edges
                _sds((N,), torch.int32), _sds((N,), torch.float32))
        specs = (P(None, None), P(None, edge_axes), P(edge_axes), P(None), P(None))

        ep = TensorParallel.of(process, edge_axes) if process else None

        def loss_of(p, feats, edges, eweight, labels, mask):
            return gcn_mod.loss_full(p, cfg, feats, edges, labels, mask, eweight, ep)

        dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        flops = 3.0 * sum(2.0 * E * dims[i] + 2.0 * N * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    elif shape.name == "minibatch_lg":
        cfg = dataclasses.replace(base, d_feat=s["d_feat"], n_classes=s["n_classes"])
        B, f1, f2 = s["batch_nodes"], s["fanout1"], s["fanout2"]
        args = (_sds((B, cfg.d_feat), torch.float32), _sds((B * f1, cfg.d_feat), torch.float32),
                _sds((B * f1 * f2, cfg.d_feat), torch.float32), _sds((B,), torch.int32))
        bspec = batch_spec(mesh, 1)
        specs = (bspec, bspec, bspec, batch_spec(mesh, 0))

        def loss_of(p, seed_f, hop1, hop2, labels):
            return gcn_mod.loss_sampled(p, cfg, seed_f, [hop1, hop2], labels)

        flops = 3.0 * 2.0 * B * (1 + f1 + f1 * f2) * cfg.d_feat * cfg.d_hidden
        note = f"fanout={f1}x{f2} (sampler: repro.data.NeighborSampler)"
    elif shape.name == "molecule":
        cfg = dataclasses.replace(base, d_feat=s["d_feat"], n_classes=s["n_classes"])
        B, N, E = s["batch"], s["n_nodes"], s["n_edges"]
        args = (_sds((B, N, cfg.d_feat), torch.float32), _sds((B, E), torch.int32), _sds((B, E), torch.int32),
                _sds((B,), torch.int32))
        specs = (batch_spec(mesh, 2), batch_spec(mesh, 1), batch_spec(mesh, 1), batch_spec(mesh, 0))

        def loss_of(p, feats, src, dst, labels):
            return gcn_mod.loss_molecule(p, cfg, feats, src, dst, labels)

        flops = 3.0 * B * (2.0 * E * cfg.d_feat + 2.0 * N * cfg.d_feat * cfg.d_hidden)
    else:
        raise KeyError(shape.name)
    params_abs = gcn_mod.init_params(cfg, device="meta")
    pspecs = gcn_param_specs(params_abs, mesh)
    ospecs = _opt_state_specs(pspecs)
    return CellPlan(
        arch.arch_id, shape.name, "train", _train_step(opt_cfg or _opt_cfg(), loss_of, mesh=process,
                                                       param_specs=pspecs),
        (params_abs, _opt_state_abstract(params_abs)) + args,
        (pspecs, ospecs) + specs,
        (pspecs, ospecs, P()),
        flops,
        note=note,
    )


# ===========================================================================
# RecSys cells
# ===========================================================================

def _recsys_batch_abstract(cfg: rec_mod.RecsysConfig, B: int) -> dict:
    if cfg.interaction in ("fm-2way", "cin"):
        return {
            "dense": _sds((B, cfg.n_dense), torch.float32),
            "sparse": _sds((B, cfg.n_sparse), torch.int32),
            "labels": _sds((B,), torch.float32),
        }
    return {"seqs": _sds((B, cfg.seq_len), torch.int32), "targets": _sds((B,), torch.int32)}


def _recsys_cell(arch: ArchSpec, shape: ShapeSpec, mesh, opt_cfg=None) -> CellPlan:
    cfg: rec_mod.RecsysConfig = arch.model_cfg
    init_fn, fwd_fn, loss_fn = rec_mod.get_model_fns(cfg)
    params_abs = init_fn(cfg, device="meta")
    pspecs = recsys_param_specs(params_abs, mesh)
    process = _process(mesh)
    tp = TensorParallel.of(process) if process else None
    opt_cfg = opt_cfg or _opt_cfg()
    s = shape.sizes
    flops_per_row = _recsys_flops_per_row(cfg)
    ctr = cfg.interaction in ("fm-2way", "cin")

    if shape.kind == "train":
        B = s["batch"]
        # sequence models materialise (B, S, S) attention / (B, K, S) routing:
        # accumulate microbatches so the 65536-row global batch fits memory
        accum = 16 if (cfg.interaction in ("multi-interest", "self-attn-seq") and B >= 32768) else 1
        batch_abs = _recsys_batch_abstract(cfg, B // accum)
        if accum > 1:
            batch_abs = {k: _sds((accum,) + tuple(v.shape), v.dtype) for k, v in batch_abs.items()}
            bspecs = tree_map(lambda l: P(None, *batch_spec(mesh, len(l.shape) - 2)), batch_abs)
        else:
            bspecs = tree_map(lambda l: batch_spec(mesh, len(l.shape) - 1), batch_abs)

        in_batch = TensorParallel.of(process, _batch_axes(mesh)) if process else None

        def micro(batch):
            return (({k: v[a] for k, v in batch.items()},) for a in range(accum)) if accum > 1 else [(batch,)]

        step = _train_step(opt_cfg, lambda p, mb: loss_fn(p, cfg, mb, tp=tp, in_batch=in_batch), micro,
                           process, pspecs)
        return CellPlan(
            arch.arch_id, shape.name, "train", step,
            (params_abs, _opt_state_abstract(params_abs), batch_abs),
            (pspecs, _opt_state_specs(pspecs), bspecs),
            (pspecs, _opt_state_specs(pspecs), P()),
            3.0 * B * flops_per_row,
            note=f"accum={accum}",
        )

    if shape.kind == "serve":
        B = s["batch"]
        batch_abs = _recsys_batch_abstract(cfg, B)
        batch_abs.pop("labels", None)
        bspecs = tree_map(lambda l: batch_spec(mesh, len(l.shape) - 1), batch_abs)

        def step(params, batch):
            return fwd_fn(params, cfg, batch, tp) if ctr else fwd_fn(params, cfg, batch["seqs"], tp)

        out_spec = batch_spec(mesh, 0) if ctr else (
            batch_spec(mesh, 1) if cfg.interaction == "self-attn-seq" else batch_spec(mesh, 2))
        return CellPlan(arch.arch_id, shape.name, "serve", step, (params_abs, batch_abs), (pspecs, bspecs),
                        out_spec, B * flops_per_row)

    if shape.kind == "retrieval":
        NC = s["n_candidates"]
        cand = _sds((NC,), torch.int32)
        cand_spec = batch_spec(mesh, 0)
        if cfg.interaction == "cin":
            # no factored form: CIN must run the full interaction per candidate
            batch_abs = {"dense": _sds((1, cfg.n_dense), torch.float32),
                         "sparse": _sds((1, cfg.n_sparse), torch.int32)}
            n_chunks = 250  # the CIN z-tensor is (B, 200, 39, 10) f32: 250 chunks of 4,000 rows
            CH = NC // n_chunks

            def step(params, batch, cand):
                scores = []
                for cand_c in cand.split(CH):      # a rank's candidates: its slice's chunks
                    n = cand_c.shape[0]
                    sparse = batch["sparse"].expand(n, cfg.n_sparse).clone()
                    sparse[:, 0] = cand_c
                    scores.append(rec_mod.xdeepfm_forward(
                        params, cfg, {"dense": batch["dense"].expand(n, cfg.n_dense), "sparse": sparse}, tp))
                return torch.cat(scores)

            return CellPlan(
                arch.arch_id, shape.name, "retrieval", step,
                (params_abs, batch_abs, cand), (pspecs, _replicated(batch_abs), cand_spec), cand_spec,
                NC * flops_per_row,
                note="CIN has no factored retrieval form: full forward per candidate "
                "(the case the n-simplex proxy index accelerates; see examples/)",
            )

        if cfg.interaction == "fm-2way":
            batch_abs = {"sparse": _sds((1, cfg.n_sparse), torch.int32)}

            def step(params, batch, cand):
                user = rec_mod.fm_user_embedding(params, cfg, batch, tp)[0]         # (D,)
                scores = rank_lookup(params["table"], cand, tp, reduce=False) @ user  # field-0 rows
                return scores if tp is None else tp.reduce(scores)

            return CellPlan(arch.arch_id, shape.name, "retrieval", step,
                            (params_abs, batch_abs, cand), (pspecs, _replicated(batch_abs), cand_spec), cand_spec,
                            2.0 * NC * cfg.embed_dim)

        # sequence models: encode once, batched dot against 1M candidates
        batch_abs = {"seqs": _sds((1, cfg.seq_len), torch.int32)}

        def step(params, batch, cand):
            if cfg.interaction == "multi-interest":
                u = rec_mod.mind_encode(params, cfg, batch["seqs"], tp)[0]     # (K, D)
            else:
                u = rec_mod.sasrec_encode(params, cfg, batch["seqs"], tp)      # (1, D)
            return rec_mod.score_candidates(params["items"], u, cand, tp)

        return CellPlan(arch.arch_id, shape.name, "retrieval", step,
                        (params_abs, batch_abs, cand), (pspecs, _replicated(batch_abs), cand_spec), cand_spec,
                        2.0 * NC * cfg.embed_dim)

    raise KeyError(shape.kind)


def _recsys_flops_per_row(cfg: rec_mod.RecsysConfig) -> float:
    D = cfg.embed_dim
    if cfg.interaction == "fm-2way":
        return 4.0 * cfg.n_sparse * D
    if cfg.interaction == "cin":
        f = 4.0 * cfg.n_sparse * D
        prev, f0 = cfg.n_sparse, cfg.n_sparse
        for h in cfg.cin_layers:
            f += 2.0 * prev * f0 * D + 2.0 * prev * f0 * h * D
            prev = h
        dims = (cfg.n_sparse * D + cfg.n_dense,) + tuple(cfg.mlp_dims) + (1,)
        f += sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return f
    S, d = cfg.seq_len, cfg.embed_dim
    if cfg.interaction == "multi-interest":
        return 2.0 * cfg.capsule_iters * cfg.n_interests * S * d + 2.0 * S * d * d
    return cfg.n_blocks * (8.0 * S * d * d + 4.0 * S * S * d)   # sasrec


# ===========================================================================
# paper's own config (metric-search serving)
# ===========================================================================

def _nsimplex_cell(arch: ArchSpec, shape: ShapeSpec, mesh, *, opt=False) -> CellPlan:
    from repro_torch.search.distributed import build_serve_step

    cfg = arch.model_cfg
    N, Q, n = shape.sizes["n_objects"], shape.sizes["query_batch"], shape.sizes["n_pivots"]
    # production tables pad to a shard multiple with sentinel rows
    # (altitude=+inf => lwb=+inf => always excluded)
    N = ((N + 8191) // 8192) * 8192
    args = (_sds((N, n), torch.float32), _sds((n - 1, n - 1), torch.float32), _sds((n - 1,), torch.float32),
            _sds((n, n - 1), torch.float32), _sds((Q, n), torch.float32), _sds((), torch.float32))
    if opt:
        # table rows over every mesh axis + K3's top-k selection + the GEMM
        # projection (K4)
        axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
        projection, selection = "gemm", "topk"
        note = "OPT: 2D-sharded table + lax.top_k(8) packing + GEMM projection"
    else:
        # baseline: the paper's sequential ApexAddition per query + full
        # argsort candidate ranking, table rows over the data axes only
        axes = _batch_axes(mesh)
        projection, selection = "paper", "sort"
        note = "BASELINE: Algorithm-2 loop projection + argsort packing"
    process = _process(mesh)
    serve = build_serve_step(
        process or mesh.scaleout_grid(axes), n_pivots=n, max_candidates=8 if opt else cfg.max_candidates,
        projection=projection, selection=selection, table_axes=axes if process else ("data",),
    )
    # filter flops: fused two-sided bounds = one l2 per (q, row) = 3n flops
    flops = 3.0 * n * float(N) * Q + 2.0 * Q * n * n
    return CellPlan(
        arch.arch_id, shape.name, "search_serve", serve, args,
        (P(axes, None), P(None, None), P(None), P(None, None), P(None, None), P()),
        (P(), P(), P()),
        flops,
        note=note,
    )


# ===========================================================================
# dispatch
# ===========================================================================

def build_cell(arch_id: str, shape_name: str, mesh, *, n_layers=None, accum_override=None, unroll=False,
               opt=False, opt_cfg: Optional[AdamWConfig] = None, model_cfg=None,
               sizes: Optional[dict] = None) -> CellPlan:
    """The plan of one cell on ``mesh`` (a ``repro_torch.launch.mesh``
    mesh, or anything with ``axis_names`` and a ``shape`` dict for every
    family but the paper's own, which needs the mesh's devices or a
    ``ProcessMesh``).  ``opt_cfg`` replaces a train cell's AdamW settings
    (the reference's are fixed: ``AdamWConfig(moment_dtype="bfloat16")``,
    whose 100 warmup steps leave a short run's bf16 weights where they
    are); ``model_cfg`` the arch's model config (a smoke config) and
    ``sizes`` entries of the cell's sizes (a cut cell)."""
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    if model_cfg is not None:
        arch = dataclasses.replace(arch, model_cfg=model_cfg)
    if sizes:
        shape = dataclasses.replace(shape, sizes={**shape.sizes, **sizes})
    if arch.family == "lm":
        if shape.kind == "train":
            return _lm_train(arch, shape, mesh, n_layers=n_layers, accum_override=accum_override, unroll=unroll,
                             opt=opt, opt_cfg=opt_cfg)
        if shape.kind == "prefill":
            return _lm_prefill(arch, shape, mesh, n_layers=n_layers, unroll=unroll, opt=opt)
        if shape.kind == "decode":
            return _lm_decode(arch, shape, mesh, n_layers=n_layers, unroll=unroll, opt=opt)
    if arch.family == "gnn":
        return _gcn_cell(arch, shape, mesh, opt_cfg)
    if arch.family == "recsys":
        return _recsys_cell(arch, shape, mesh, opt_cfg)
    if arch.family == "metricsearch":
        return _nsimplex_cell(arch, shape, mesh, opt=opt)
    raise KeyError((arch_id, shape_name))


def all_cells():
    """Every (arch, shape) pair in the registry (the paper's own included)."""
    return [(a, s) for a in list_archs() for s in get_arch(a).shapes]
