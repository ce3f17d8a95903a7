"""sdface_gan_tpu_torch — the PyTorch/CUDA port of ``sdface_gan_tpu``.

The JAX package stays the reference; this package re-implements it for an
NVIDIA H100 and is held against it, on the same weights and inputs, by
``tests/test_torch_port_*.py``.

Ported so far: the 256^2 full-pipeline generator with the SIREN, NGP and
FC fields (inference), the SIREN and NGP SDF generators' training from the
command line (stages A, B and C), the evaluation and geometry tools, the
benches, the import of a JAX run's checkpoints, the GIRAFFE family
(its generator, render programs and mesh extraction, and its training with
the VAE encoder) and the gan2d baseline's training:

  ops/         fast_sin, fused_leaky_relu, upfirdn2d, sh_encode, the
               FiLM-SIREN field, the hash-grid encode (forward, backward,
               double backward) and the table gather, with hand-written
               CUDA kernels (``ops/csrc``)
  geometry/    camera sampling, ray generation, mesh extraction
  models/      SIREN, NGP and FC field networks, volume renderer,
               StyleGAN2 decoder, the whole generator, both
               discriminators, noise projection
  encoder/     stage C's VAE and pSp encoders, the ID and LPIPS losses
  giraffe/     the GIRAFFE generator (camera, boxes, NeRF / hash / small
               decoders, compositing, neural renderer), render programs,
               mesh extraction, the DC and ResNet discriminators, the
               trainer (R1, RMSprop, EMA, the VAE step) and its loop
  gan2d/       the 2D ResNet generator of the gan2d baseline, its steps
               and loop
  losses/      GAN and geometry losses
  training/    sphere init, stage A and stage B loops and steps, gradient
               accumulation, the optimizers (stage C's Ranger, optax's
               RMSprop)
  evaluation/  the FID InceptionV3, FID and KID, real-image readers
  native/      the record store, the PNG unfilter loop, marching cubes and
               the mesh rasterizer (C++, g++ at first use, ctypes)
  data/        PNG, JPEG and BMP decoders, PIL-exact resampling, datasets
               (the record store's; GIRAFFE's image folders), loader,
               prepare, the procedural heads (``synthetic``)
  config/      yaml subset reader, ``inherit_from``, SDF options, builders
  utils/       device selection, checkpoints, logging, images, converters
  configs.py   the ``configs/256res`` SDF configurations as dataclasses
  serving.py   ``SDFaceSampler``
  train.py, prepare_data.py, eval.py, calc_fid_stats.py, eval_files.py,
  probe_geometry.py, sdf_mesh.py, data/synthetic.py, bench.py,
  bench_ngp.py, import_jax_checkpoints.py, render.py,
  extract_mesh.py   ``python -m`` entry points

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card and without that request they raise.
The package imports neither ``jax`` nor any module of ``sdface_gan_tpu``,
nor PIL or PyYAML.
"""

__version__ = "0.1.0"
