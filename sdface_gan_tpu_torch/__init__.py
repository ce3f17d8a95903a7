"""sdface_gan_tpu_torch — the PyTorch/CUDA port of ``sdface_gan_tpu``.

The JAX package stays the reference; this package re-implements its
serving path for an NVIDIA H100 and is held against it, on the same
weights and inputs, by ``tests/test_torch_port_*.py``.

Ported so far (the 256^2 SDF full-pipeline generator, inference only):

  ops/         fast_sin, fused_leaky_relu, upfirdn2d, and the FiLM-SIREN
               field with its hand-written CUDA kernel (``ops/csrc``)
  geometry/    camera sampling and ray generation
  models/      FiLM-SIREN network, volume renderer, StyleGAN2 decoder,
               the whole generator
  utils/       device selection, JAX parameter tree -> state_dict
  serving.py   ``SDFaceSampler``

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card and without that request they raise.
The package imports neither ``jax`` nor any module of ``sdface_gan_tpu``.
"""

__version__ = "0.1.0"
