"""The GIRAFFE compositional-NeRF GAN family, port of ``sdface_gan_tpu/giraffe``
(serving: the generator, its render programs and mesh extraction; the
discriminators and the trainer are not ported yet, ROADMAP.md queue 1
item 7).  Camera math, NeRF decoders (positional, Gaussian and hash
encodings; the hash encode through the hand-written CUDA kernel on the
card), box transforms, density compositing and the 2D neural renderer."""

from .bbox import BBoxConfig, sample_transformations
from .camera import (
    arange_pixels,
    get_camera_mat,
    get_camera_pose,
    get_random_pose,
    get_rotation_matrix,
    image_points_to_world,
    origin_to_world,
)
from .decoder import DecoderConfig, GiraffeDecoder, SmallDecoder, SmallDecoderConfig
from .generator import GiraffeConfig, GiraffeGenerator, LatentCodes, giraffe_forward
from .neural_renderer import NeuralRenderer, NeuralRendererConfig

__all__ = [
    "get_camera_mat",
    "get_random_pose",
    "get_camera_pose",
    "get_rotation_matrix",
    "arange_pixels",
    "image_points_to_world",
    "origin_to_world",
    "DecoderConfig",
    "GiraffeDecoder",
    "SmallDecoderConfig",
    "SmallDecoder",
    "NeuralRendererConfig",
    "NeuralRenderer",
    "BBoxConfig",
    "sample_transformations",
    "GiraffeConfig",
    "GiraffeGenerator",
    "LatentCodes",
    "giraffe_forward",
]
