from repro_torch.data.synthetic import colors_like, load_or_generate_colors

__all__ = ["colors_like", "load_or_generate_colors"]
