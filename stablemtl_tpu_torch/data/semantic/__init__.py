from .encoding import (
    CityscapesEncoder,
    Encoder,
    VKitti2Encoder,
    IGNORE_INDEX,
)

__all__ = ["Encoder", "CityscapesEncoder", "VKitti2Encoder", "IGNORE_INDEX"]
