"""n-simplex-accelerated candidate retrieval for a recsys tower
(the ``retrieval_cand`` integration).

    python -m repro_torch.examples.retrieval_recsys                # on the card
    python -m repro_torch.examples.retrieval_recsys --device cpu   # on the host

Trains a tiny SASRec for a few steps, takes its item embedding table as the
candidate corpus, and serves exact top-k retrieval through the n-simplex
filter — pruning most of the corpus before any exact scoring (the JAX
package's ``examples/retrieval_recsys.py``).  ``main`` draws the initial
parameters from a seeded ``torch.Generator``; ``run`` takes any parameters,
such as the JAX package's own carried across by
``repro_torch.models.convert.from_reference``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import user_history_batch
from repro_torch.examples.summary import parse, summary
from repro_torch.models import recsys as rec
from repro_torch.models.params import value_and_grad
from repro_torch.search import NSimplexRetriever
from repro_torch.train import AdamWConfig, apply_updates, init_state


def run(params, cfg, device) -> dict:
    """Ten AdamW steps from ``params``, then exact top-10 retrieval for five
    users over the trained item table; the walkthrough's summary."""
    _, encode_fn, loss_fn = rec.get_model_fns(cfg)

    # a few training steps so embeddings are not pure noise
    opt_cfg = AdamWConfig(lr=3e-3, moment_dtype="float32")
    opt = init_state(opt_cfg, params)

    def step(params, opt, batch):
        loss, g = value_and_grad(lambda p: loss_fn(p, cfg, batch), params)
        params, opt, _ = apply_updates(opt_cfg, params, g, opt)
        return params, opt, loss

    losses = []
    t0 = time.perf_counter()
    for i in range(10):
        seqs, targets = user_history_batch(64, cfg.seq_len, cfg.n_items, seed=i)
        params, opt, loss = step(
            params, opt, {"seqs": torch.as_tensor(seqs, device=device),
                          "targets": torch.as_tensor(targets, device=device)}
        )
        losses.append(float(loss))
    train_s = time.perf_counter() - t0
    print(f"trained 10 steps, final in-batch softmax loss {losses[-1]:.3f}")

    # candidate corpus = item embedding table (valid ids only)
    items = params["items"][1: cfg.n_items].detach().cpu().numpy()
    retriever = NSimplexRetriever(items, metric="euclidean", n_pivots=12, seed=0, device=device)

    seqs, _ = user_history_batch(5, cfg.seq_len, cfg.n_items, seed=99)
    with torch.no_grad():
        users = encode_fn(params, cfg, torch.as_tensor(seqs, device=device)).cpu().numpy()

    top, scored, pruned, ms = [], [], [], []
    for ui, u in enumerate(users):
        t0 = time.perf_counter()
        idx, d, stats = retriever.top_k(u, k=10)
        dt = (time.perf_counter() - t0) * 1e3
        bidx, bd = retriever.brute_force_top_k(u, k=10)
        assert np.allclose(d, bd, atol=1e-5), "retrieval must be exact"
        print(
            f"user {ui}: top-10 exact in {dt:.1f}ms — scored {stats.exact_scored}"
            f"/{len(items)} candidates ({100 * stats.pruned / len(items):.1f}% pruned by bounds)"
        )
        top.append(idx.tolist())
        scored.append(stats.exact_scored)
        pruned.append(stats.pruned)
        ms.append(dt)

    return summary(
        exact={"steps": len(losses), "candidates": len(items), "users": len(users)},
        close={"losses": losses, "top_ids": top},
        counts={"scored": scored, "pruned": pruned},
        seconds={"train": train_s, "top_k_ms": ms},
    )


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    cfg = get_arch("sasrec").smoke_cfg
    init_fn, _, _ = rec.get_model_fns(cfg)
    params = init_fn(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return run(params, cfg, dev)


if __name__ == "__main__":
    main()
