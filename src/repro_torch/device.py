"""Device policy of the port.

Every entry point (``build_index``, ``load_index``, ``NSimplexIndex(...)``,
``NSimplexIndex.from_state``, ``LaesaIndex(...)``, ``LaesaIndex.from_state``,
``NSimplexProjector(...)``, ``NSimplexProjector.from_fitted``,
``ExactSearchEngine(...)``, ``NSimplexRetriever(...)``) takes ``device=``
and defaults to ``"cuda"``.
With no card and no explicit ``device="cpu"`` it raises instead of quietly
running on the host: the CPU path exists for the parity tests, and a
silent fallback would make every speed figure a CPU figure.

Resolving a device also pins float32 matrix products to full IEEE
precision.  The soundness slack of the f32 bound scan
(``NSimplexIndex._kernel_err_sq``) assumes IEEE f32 products; TF32 keeps
about three decimal digits and would break the slack with no error raised.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["on_device", "pin_precision", "resolve_device"]


def pin_precision() -> None:
    """Full-precision float32 products everywhere (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on; raises when CUDA is
    asked for (the default) and no card is present."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device; got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the host"
        )
    pin_precision()
    return dev


def on_device(device):
    """A context making ``device`` the current CUDA device of this thread
    (kernel launches go to the current device); nothing for the CPU."""
    dev = torch.device(device)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
