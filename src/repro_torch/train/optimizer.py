"""AdamW on tensor trees, the JAX package's optimizer step for step:

  * moments stored in a configurable dtype (bf16 halves the optimizer's
    memory),
  * global-norm gradient clipping,
  * linear-warmup + cosine decay schedule,
  * optional int8 gradient compression with error feedback (the residual
    buffer makes the quantisation unbiased over time).

The state is a dict ``{"step": int32 0-dim, "m", "v"[, "ef"]}`` whose
moment trees are shaped like the params (a ``Params`` tree gives
``Params`` moments).  The arithmetic is the reference's, in f32: the bias
corrections ``b1 ** step`` and the schedule are f32 tensors, each leaf is
updated through an f32 copy and cast back to its own dtype, and the
moments are cast to ``moment_dtype`` after the f32 update.

``apply_updates`` works in place, as ``torch.optim`` does: it rewrites the
parameter and moment tensors under ``torch.no_grad()`` and returns the
same trees with a new step counter.  It reads nothing back to the host:
the clip factor, the learning rate and the bias corrections stay on the
device.

On shards (``shardings``: a tree of ``NamedSharding``s over a
``ProcessMesh``, one per leaf) every elementwise step is the one-process
step on this rank's slice; the two statistics that span a leaf are taken
over the whole leaf: the clip's global norm counts each element once (a
shard's sum of squares over its leaf's replica count, summed over every
rank) and int8 compression scales by the leaf's global max.  Where the
moments' shardings split a leaf over axes the parameter's do not (the
``moe_local`` cells: expert weights replicated over ``data``, their
moments ZeRO-sharded over it) a rank updates its moment shard and the
matching slice of the parameter, and the updated slices are all-gathered
over those axes into the replicated parameter.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding.rules import NamedSharding, ProcessMesh

__all__ = [
    "AdamWConfig",
    "apply_updates",
    "compress_tree",
    "decompress_tree",
    "dequantize_int8",
    "init_state",
    "lr_at",
    "quantize_int8",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "bfloat16"
    compress_grads: bool = False     # int8 + error feedback


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The schedule at ``step`` (an integer tensor), as an f32 tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def init_state(cfg: AdamWConfig, params) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    state = {
        "step": torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }
    if cfg.compress_grads:
        state["ef"] = tree_map(zeros, params)  # error-feedback residual
    return state


def _shardings(shardings) -> list:
    return tree_leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))


def _sharded(shardings) -> bool:
    return shardings is not None and any(isinstance(s.mesh, ProcessMesh) for s in _shardings(shardings))


def _global_norm(tree, shardings=None) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not _sharded(shardings):
        return torch.sqrt(torch.sum(torch.stack([torch.sum(l.to(torch.float32) ** 2) for l in leaves])))
    total = torch.sum(torch.stack([torch.sum(l.to(torch.float32) ** 2) / s.replicas
                                   for l, s in zip(leaves, _shardings(shardings))]))
    dist.all_reduce(total)
    return torch.sqrt(total)


# -- int8 gradient compression with error feedback ---------------------------

def quantize_int8(x: torch.Tensor, amax: torch.Tensor = None):
    """(q int8, scale f32 0-dim): x ≈ q · scale, |q| <= 127; ``torch.round``
    rounds half to even, as ``jnp.round`` does.  ``amax``: the max |x| to
    scale by (a shard passes its whole leaf's); x's own by default."""
    amax = torch.clamp_min(torch.max(torch.abs(x)) if amax is None else amax, 1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, ef, shardings=None):
    """Returns (quantised tree of (q, scale), new error-feedback residual).
    With ``shardings`` over a ``ProcessMesh`` the leaves are shards and each
    scale is the whole leaf's (an all-reduce max over every rank)."""
    sharded = _sharded(shardings)

    def one(g, e):
        x = g.to(torch.float32) + e.to(torch.float32)
        amax = None
        if sharded:
            amax = torch.max(torch.abs(x))
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
        q, s = quantize_int8(x, amax)
        deq = dequantize_int8(q, s)
        return (q, s), (x - deq).to(e.dtype)

    pairs = tree_map(one, grads, ef)
    is_pair = lambda x: isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)  # noqa: E731
    qtree = tree_map(lambda t: t[0], pairs, is_leaf=is_pair)
    new_ef = tree_map(lambda t: t[1], pairs, is_leaf=is_pair)
    return qtree, new_ef


def decompress_tree(qtree):
    return tree_map(lambda qs: dequantize_int8(*qs), qtree,
                    is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2)


# -- update -------------------------------------------------------------------

def _moment_axes(ps: NamedSharding, ms: NamedSharding) -> tuple:
    """The axes the moment sharding ``ms`` splits a leaf over beyond the
    parameter sharding ``ps``'s, dim by dim (raises where the two disagree
    otherwise)."""
    extra = []
    for d, (pe, me) in enumerate(zip(ps.spec, ms.spec)):
        if pe == me:
            continue
        if pe is not None:
            raise NotImplementedError(f"dim {d}: moments {ms.spec} against parameters {ps.spec}")
        extra.extend(me if isinstance(me, tuple) else (me,))
    return tuple(a for a in ms.mesh.axis_names if a in extra)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: dict, shardings=None, moment_shardings=None):
    """One AdamW step, in place.  Returns (params, new_state, metrics) with
    metrics ``{"grad_norm", "lr"}`` as device tensors (the norm before
    clipping).  ``shardings``: the leaves' placements when params, grads
    and moments are this rank's shards (the norm is then the whole tree's);
    ``moment_shardings``: the moments' and the grads' placements where they
    differ from the parameters' (see the module)."""
    gnorm = _global_norm(grads, moment_shardings or shardings)
    clip = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        # the reference's expression, one rounding per operation, computed in
        # place so that at most three f32 copies of the leaf are alive:
        #   g32 = g·clip;  m32 = b1·m + (1 - b1)·g32;  v32 = b2·v + (1 - b2)·g32·g32
        #   delta = (m32 / bc1) / (sqrt(v32 / bc2) + eps) + wd·p;  p = p - lr·delta
        g32 = g.to(torch.float32, copy=True).mul_(clip)
        m32 = m.to(torch.float32, copy=True).mul_(b1).add_((1 - b1) * g32)
        v32 = v.to(torch.float32, copy=True).mul_(b2).add_(((1 - b2) * g32).mul_(g32))
        del g32
        m.copy_(m32)                                   # rounds to moment_dtype
        v.copy_(v32)
        delta = m32.div_(bc1).div_(v32.div_(bc2).sqrt_().add_(cfg.eps))
        del v32
        p32 = p.to(torch.float32, copy=True)
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32.sub_(delta.mul_(lr)))

    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))
    if moment_shardings is None:
        for p, g, m, v in leaves:
            upd(p, g, m, v)
    else:
        for (p, g, m, v), ps, ms in zip(leaves, _shardings(shardings), _shardings(moment_shardings)):
            axes = _moment_axes(ps, ms)
            if not axes:
                upd(p, g, m, v)
                continue
            part = ms.cut(p, axes)                     # the slice of p that this rank's moments cover
            upd(part, g, m, v)
            p.copy_(ms.gather(part, axes))
    new_state = dict(state, step=step)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
