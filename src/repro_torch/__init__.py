"""repro_torch — the n-simplex supermetric search system on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100: the same entry
points (``repro_torch.api.build_index`` / ``load_index`` / ``Query``,
``repro_torch.search.ExactSearchEngine`` over the paper's five mechanisms and
``repro_torch.launch.service.SearchService``), with the bound scans in
hand-written CUDA kernels for Hopper (``repro_torch.kernels``).  It imports
neither jax nor ``repro``.  Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``.
"""
