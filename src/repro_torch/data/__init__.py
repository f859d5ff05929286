# Port of src/repro/data/: the serving tier's host-to-device input stage.
# TokenPipeline waits for the model stacks.
from .pipeline import DeviceStage

__all__ = ["DeviceStage"]
