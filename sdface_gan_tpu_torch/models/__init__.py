from .generator import (
    Generator,
    GeneratorConfig,
    GeneratorOutput,
    generator_forward,
    map_style,
    mean_latent,
)
from .renderer import RendererConfig, RenderOutput, VolumeFeatureRenderer, render
from .siren import FiLMSiren, LinearLayer, SirenConfig, SirenGenerator
from .stylegan2 import (
    Decoder,
    DecoderConfig,
    ModulatedConv2d,
    StyledConv,
    ToRGB,
    apply_decoder,
    channel_table,
    make_decoder_latent,
)

__all__ = [
    "Generator",
    "GeneratorConfig",
    "GeneratorOutput",
    "generator_forward",
    "map_style",
    "mean_latent",
    "RendererConfig",
    "RenderOutput",
    "VolumeFeatureRenderer",
    "render",
    "FiLMSiren",
    "LinearLayer",
    "SirenConfig",
    "SirenGenerator",
    "Decoder",
    "DecoderConfig",
    "ModulatedConv2d",
    "StyledConv",
    "ToRGB",
    "apply_decoder",
    "channel_table",
    "make_decoder_latent",
]
