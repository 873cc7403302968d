"""Copy of `stablemtl_tpu/utils/metrics/__init__.py`: the port keeps its
own so that it imports nothing of the JAX package."""

from .tracker import MetricTracker
from . import depth as depth_metrics
from . import normal as normal_metrics
from .semantic import SemanticMetrics
from .flow import OpticalFlowMetrics, SceneFlowMetrics
from .albedo_shading import AlbedoAndShadingMetrics, match_scale, ssim

__all__ = [
    "MetricTracker",
    "depth_metrics",
    "normal_metrics",
    "SemanticMetrics",
    "OpticalFlowMetrics",
    "SceneFlowMetrics",
    "AlbedoAndShadingMetrics",
    "match_scale",
    "ssim",
]
