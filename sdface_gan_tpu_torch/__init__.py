"""sdface_gan_tpu_torch — the PyTorch/CUDA port of ``sdface_gan_tpu``.

The JAX package stays the reference; this package re-implements its
serving path for an NVIDIA H100 and is held against it, on the same
weights and inputs, by ``tests/test_torch_port_*.py``.

Ported so far (the 256^2 full-pipeline generator with the SIREN, NGP and
FC fields, inference only):

  ops/         fast_sin, fused_leaky_relu, upfirdn2d, sh_encode, the
               FiLM-SIREN field, the hash-grid encode and the table gather,
               the last three with hand-written CUDA kernels (``ops/csrc``)
  geometry/    camera sampling and ray generation
  models/      SIREN, NGP and FC field networks, volume renderer,
               StyleGAN2 decoder, the whole generator
  utils/       device selection, JAX parameter tree -> state_dict
  configs.py   the NGP serving configurations of ``configs/``, by hand
  serving.py   ``SDFaceSampler``

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card and without that request they raise.
The package imports neither ``jax`` nor any module of ``sdface_gan_tpu``.
"""

__version__ = "0.1.0"
