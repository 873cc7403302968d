from .encoding import Encoder, VKitti2Encoder

__all__ = ["Encoder", "VKitti2Encoder"]
