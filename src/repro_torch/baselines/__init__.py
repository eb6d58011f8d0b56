"""The paper's Fig. 2 baselines: PCA, JL random projection, Landmark MDS."""

from repro_torch.baselines.dimred import LandmarkMDS, jl_project, pca_project

__all__ = ["pca_project", "jl_project", "LandmarkMDS"]
