"""What the table indexes share: operands moved to the index's device, row
masks, and the distance oracle their host refinement loops call."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import tracing

__all__ = ["DeviceRows", "device_rows", "row_mask"]


def device_rows(data, device: torch.device) -> torch.Tensor:
    """A corpus as a tensor on ``device``: host arrays are copied there, a
    tensor already there is used as it is (indexes never write into their
    rows, so sharing is safe)."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    return torch.tensor(np.asarray(data), device=device)


def row_mask(rowmask, n: int) -> Optional[np.ndarray]:
    """A ``rowmask`` (bool mask or array of allowed positions) as an (n,)
    bool numpy array, or None: masked rows neither appear in results nor
    influence radii or tie order among the allowed rows."""
    if rowmask is None:
        return None
    m = np.asarray(rowmask)
    if m.dtype == np.bool_:
        if m.shape[0] != n:
            raise ValueError(f"rowmask length {m.shape[0]} != table rows {n}")
        return m
    b = np.zeros(n, dtype=bool)
    b[m.astype(np.int64)] = True
    return b


class DeviceRows:
    """Mixin of an index holding ``device``, the corpus ``data`` (a tensor on
    it) and a ``metric``."""

    @property
    def n_rows(self) -> int:
        return int(self.data.shape[0])

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _mask_of(self, rowmask) -> Optional[np.ndarray]:
        return row_mask(rowmask, self.n_rows)

    def _device_mask(self, mask: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        """The host bool ``mask`` as the uint8 row mask the kernels read, on
        the index's device: made once per batch call and handed to each
        kernel launch, so no launch copies the mask again."""
        if mask is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(mask).view(np.uint8)).to(self.device)

    def _dist_fn(self, q: torch.Tensor):
        """rows (numpy ids) -> host distances from ``q``, evaluated on the
        device with the metric's own dtype rule, each call under a
        ``metric.refine`` span."""

        def dist(rows):
            with tracing.span("metric.refine", rows=len(rows)):
                idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)
                return self.metric.one_to_many(q, self.data[idx]).cpu().numpy()

        return dist
