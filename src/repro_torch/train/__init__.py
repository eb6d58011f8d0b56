"""Training on the port: AdamW on tensor trees, checkpoints in the JAX
package's on-disk layout, and the fault-tolerant loop."""

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import LoopConfig, LoopMetrics, TrainLoop
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state, lr_at

__all__ = [
    "AdamWConfig",
    "init_state",
    "apply_updates",
    "lr_at",
    "CheckpointManager",
    "TrainLoop",
    "LoopConfig",
    "LoopMetrics",
]
