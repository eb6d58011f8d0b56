from repro_torch.metrics.supermetrics import (
    METRIC_REGISTRY,
    PARAMETRIC_METRICS,
    CosineMetric,
    EuclideanMetric,
    JensenShannonMetric,
    Metric,
    QuadraticFormMetric,
    TriangularMetric,
    get_metric,
    metric_from_config,
    metric_to_config,
)

__all__ = [
    "Metric",
    "EuclideanMetric",
    "CosineMetric",
    "JensenShannonMetric",
    "TriangularMetric",
    "QuadraticFormMetric",
    "get_metric",
    "metric_to_config",
    "metric_from_config",
    "METRIC_REGISTRY",
    "PARAMETRIC_METRICS",
]
