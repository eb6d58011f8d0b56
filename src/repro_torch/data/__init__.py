from repro_torch.data.synthetic import colors_like

__all__ = ["colors_like"]
