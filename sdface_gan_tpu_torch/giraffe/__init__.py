"""The GIRAFFE compositional-NeRF GAN family, port of ``sdface_gan_tpu/giraffe``:
serving (the generator, its render programs and mesh extraction) and
training (the DC and ResNet discriminators, the D, G and VAE-encoder
steps with R1, RMSprop and the EMA, and the loop behind ``train --sdf
0``).  Camera math, NeRF decoders (positional, Gaussian and hash
encodings; the hash encode and its table gradient through the
hand-written CUDA kernels on the card), box transforms, density
compositing and the 2D neural renderer."""

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
from .discriminator import DCDiscConfig, DCDiscriminator, ResnetDiscConfig, ResnetDiscriminator
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
    "DCDiscConfig",
    "DCDiscriminator",
    "ResnetDiscConfig",
    "ResnetDiscriminator",
]
