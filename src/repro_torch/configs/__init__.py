"""Architecture registry: ``get_arch(<id>)`` / ``--arch <id>``.

Assigned pool (40 cells) + the paper's own config:
  LM     : minitron-4b, yi-6b, qwen2-1.5b, arctic-480b, mixtral-8x7b  (x4 shapes)
  GNN    : gcn-cora                                                   (x4 shapes)
  RecSys : fm, xdeepfm, mind, sasrec                                  (x4 shapes)
  Paper  : nsimplex-colors                                            (serve_1m)
"""

from repro_torch.configs.base import ArchSpec, ShapeSpec, get_arch, list_archs

# populate the registry
import repro_torch.configs.lm_archs  # noqa: F401
import repro_torch.configs.other_archs  # noqa: F401

__all__ = ["ArchSpec", "ShapeSpec", "get_arch", "list_archs"]
