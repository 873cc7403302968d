from .unet import UNet2DConditionModel, UNetConfig  # noqa: F401
from .vae import AutoencoderKL, VAEConfig  # noqa: F401
