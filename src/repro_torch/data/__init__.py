# Port of src/repro/data/: the deterministic token pipeline and the
# serving tier's host-to-device input stage.
from .pipeline import DeviceStage, PipelineConfig, TokenPipeline

__all__ = ["DeviceStage", "PipelineConfig", "TokenPipeline"]
