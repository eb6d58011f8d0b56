"""The JAX package's walkthroughs (``examples/``) on the port, one module
per script, under the script's name:

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu   # plain PyTorch on the host

Each module's ``main(argv=None)`` takes the reference script's flags plus
``--device`` (``cuda`` by default; without a card it raises unless
``--device cpu`` is passed), prints the reference script's lines under the
same labels, asserts what the reference script asserts, and returns a
summary (``repro_torch.examples.summary``): the values the algorithm fixes,
held to the reference run's in ``reference_summaries.json``, and the
timings, kept apart from them.  Nothing runs at import.
"""

#: the walkthroughs, from the surface every user meets first to the model half
WALKTHROUGHS = (
    "quickstart",
    "expensive_metric_search",
    "quality_tradeoff",
    "filtered_search",
    "kernel_tuning",
    "online_updates",
    "mesh_scaleout",
    "service_demo",
    "frontend_demo",
    "retrieval_recsys",
    "train_lm",
)

__all__ = ["WALKTHROUGHS"]
