#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdface_gan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printed as JSON lines (every line carries ``t_s``, the
script's seconds so far, and each phase ends with a ``wall`` line of its
wall seconds; a ``walls`` line sums them up before the ``kernels`` line);
any failure raises and exits non-zero with no ``ok`` line:

1. device  - nvidia-smi name and power limit, torch's device name and
             capability.  No CUDA: exit 2.  Run outside the repository
             (no ``sdface_gan_tpu_torch`` beside this file): exit 3.
2. build   - compile every CUDA source of the served paths
             (``csrc/siren_field.cu``, ``csrc/hash_grid.cu``) with one
             nvcc process each, all started together, unless a build for
             the source already exists; ptxas registers and spills.
   prepare - beside the build and kernel_check, on a thread (host work
             only, the card idle): the native library (g++), train_cli's
             images and store, evaluate's 48 procedural 256^2 heads, and the
             512^2 phases' 24 procedural 512^2 heads and their 64 + 512
             store (``data.synthetic --res 512``, ``prepare_data --size
             64,512``); awaited before serve.
3. kernel_check - each kernel against its plain PyTorch version on the card:
             * siren_field at full width (W=256, D=8, style 256, B=2,
               P=64*64*24) and at depth 3, P=700 (a partial tile), and at
               W=64 and W=512 (depth 3, P=700, partial tiles of 512 and 64
               points), and at the bench's shape (full width, B=32,
               P=64*64*24, one call), in f32 (the register-blocked FMA kernel, max abs
               error <= 1e-3) and bf16 (tensor-core kernel: mean error
               against f32 truth <= 1.2x the plain bf16 version's + 1e-4;
               max abs against the plain bf16 version reported); the f32
               kernel also at W=64, 192, 256, 320, 512 (each tile geometry
               class), depth 3, P=1 and 700 (ragged tiles), and at sdf_mesh's
               surface probe, full width, B=1, P=128^3=2,097,152;
             * table_gather at the Pallas probe's shapes ([512, 128] f32,
               [8, 128] int32, one column) and at the packed NGP encode's
               (bf16, 64-wide rows, [2, 786432] indices): bit-equal;
             * hash_encode on the tuned and the upstream grid, std-1 tables,
               786,432 points with some outside the box and some on cell
               faces, and a real request's 786,432 points in the renderer's
               order: f32 max abs <= 1e-5, bf16 within one bf16 ulp
               (|d| <= 8e-3 |ref| + 1e-6); the packed encode through both
               kernels against the plain unpacked encode, f32, <= 1e-5;
             * hash_encode_backward (K1: d x and d table, and d x alone) and
               hash_encode_double_backward (K2: d table and d g; and in the
               jvp eikonal's roles, d g alone without g, the encode's
               tangent, and d table alone, the tangent's table gradient) on
               the tuned, the upstream and a tiny (T = 2^7) grid, f32 and
               bf16 tables,
               2^17 uniform, out-of-box, cell-face and box-face points,
               the points that put a warp's lanes on one row (every point
               in one cell of level 0, rays of 24 sorted samples, warps
               mixing in-box, out-of-box and box-face points with tail
               lanes at n = 1, 31, 33, 700),
               then at the NGP stage-A G step's shapes on a request's points
               ((t) tuned, bf16, 786,432 and 32,768 points; (u) upstream,
               f32, 786,432, and its first 393,216 as bench_ngp's stage A
               at batch 4 gives them): ||kernel - plain|| <= 1e-5 of the
               plain norm for f32 outputs,
               8e-3 for bf16 ones (the atomics' order varies); zeros outside
               the box;
             * at bench_ngp's hash-grid shape (its 393,216 uniform points on
               the upstream grid, bound 1, std-1 f32 table): the forward it
               times (hash_encode, max abs <= 1e-5) and its table gradient
               through K1 (<= 1e-5 of the plain VJP's norm), then K1 and K2
               on those points as above.
4. serve   - the SIREN 256^2 generator (random weights from a seed) behind
             ``SDFaceSampler`` at batch 8, bf16 weights: warm up, zero the
             launch counts, answer two seed requests and one azim/elev
             request, read the counts (siren_field must have launched); a
             profiled request must show the bf16 tensor-core kernel
             (siren_field_mma_kernel) by name and not the f32 kernel
             (siren_field_f32_kernel);
             serve_compare: one f32 request with the fused field against the
             same request through the plain field (<= 2e-3), and the bf16
             request's mean error against that f32 plain image <= 1.2x the
             plain bf16 request's + 1e-4.
   serve_f32 - the same generator with f32 weights (the sampler's default
             for a state dict): three requests through the f32 kernel, a
             profiled one showing it by name and not the bf16 kernel,
             images/s.
5. serve_ngp - the same for the NGP generator of
             ``configs/256res/ffhq_256_sdf_ngp_tpu.yaml`` (tuned grid, tables
             packed at 64 MB): hash_encode and table_gather must each launch
             once per request and appear by name in the profile; then one
             request through the upstream grid (``ffhq_256_sdf_ngp.yaml``),
             which must launch hash_encode.  serve_ngp_compare: with the
             hash table redrawn with std 1, an f32 request with the kernels
             against the plain versions, and packed against unpacked
             (<= 2e-3 each).
6. timing  - at batch 8: each kernel's time (CUDA-event medians; the
             field's bf16 (mma) and f32 (FMA) kernels apart, with the sine
             epilogue's FP32-pipe time beside each bound; for the hash
             kernels, which are shorter than their wrappers' host work,
             the profiler's device time per launch, with the event time of a
             whole call beside it as ``call_ms``), its plain version's and,
             for table_gather, one PyTorch call's computing the same function,
             on the points of a real request; K1 and K2 at the NGP stage-A G
             step's shapes ((t) the render's table gradient and the
             subsampled eikonal, (u) the full eikonal's first pass, table
             gradient, both, and K2; and under eikonal_mode="jvp", K2 as
             the encode's tangent and as the tangent's table gradient),
             beside one index_add_ of the table gradient's pairs; sampler
             images/s of both
             generators, and the f32 SIREN request's profiled device ms and
             images/s; beside the card's name and power limit.
7. train    - the SIREN training path (``sdface_gan_tpu_torch.training``),
             which runs no kernel (the fused field has no backward):
             train_parity: a stage-A G step (eikonal, reverse mode, and
             again in forward mode, eikonal_mode="jvp"), a stage-A D step
             (R1), a stage-B regularized D step and a path step, loss and
             every parameter gradient on the card against the CPU, same
             weights and inputs, f32 (batch 2, 16^2 thumbs, depth 3, width
             64, 64^2 decoder; loss rel <= 1e-4, each gradient's difference
             <= 1e-3 of its norm + 1e-6, under ``masked_parity``'s rule
             for the leaky-ReLU kinks); train_eikonal_check: the f32
             subsampled eikonal term at full width at 64 points against
             central differences (h = 1e-7) of an f64 copy of the
             field (<= 1e-3 of the largest component; the f64 copy's own
             autograd term <= 1e-4); stage A of ``ffhq_256_sdf`` through
             ``train_volume_renderer``: 2 sphere-init steps and 3
             iterations under (a) the reference settings (f32, full
             eikonal, remat) and (b) ``ffhq_256_sdf_tpu`` (bf16 G
             parameters, 4096 eikonal points, no remat) and (a) without
             remat (what the checkpointing costs), one ``train`` line
             per logged step, D and G step medians after the first
             iteration, peak memory; stage B through ``train_full_pipeline``
             from (a)'s ``vol_renderer``: 3 iterations at 256^2, f32, the
             first with the regularized D and the path step, then both
             timed warm; train_profile: one stage-A G step and one D step
             profiled, the G step's top device operations.  Every loss is
             finite and siren_field never launches (counts and profiler).
   train_ngp - the NGP generator: train_ngp_parity, one stage-A G step
             under the full eikonal with remat, one under the subsampled
             eikonal and one under the full eikonal in forward mode with
             remat (K2 as the tangent and its table gradient), and one D
             step with R1, card against CPU as
             train_parity (the hash table's gradient included, every logged
             loss finite, g_smooth among them); stage A at batch 8, nothing
             cut, under (t) ffhq_256_sdf_ngp_tpu (bf16 G, 4096 eikonal
             points, no remat) and (u) ffhq_256_sdf_ngp with --ngp 1 (f32,
             full eikonal, remat): 2 sphere-init steps and 3 iterations,
             step medians, peak memory, the launches of hash_encode, K1 and
             K2 (each must launch) and no plain encode on the card; a warm G
             and D step of each counted and profiled (each hash kernel's
             device ms per step), and (u)'s G step again under
             eikonal_mode="jvp", timed, its peak memory, counted (K2 as the
             tangent, hash_encode_jvp, and as its table gradient) and
             profiled (K2 by name, no plain encode on the card); stage B
             under (t), 3 iterations.
8. train_cli - training from the command line, as a user runs it: 16
             procedural 320 x 288 PNG images and the committed image
             fixtures (JPEG, BMP, palette / interlaced / 16-bit PNG) through ``python -m
             sdface_gan_tpu_torch.prepare_data --size 256`` (records, store
             bytes, seconds; made in prepare); the loader's work for 20 batches of 8 (decode,
             flip, HAMMING thumb) and the prefetching DataLoader's time per
             batch, beside the stage-A step time; ``python -m
             sdface_gan_tpu_torch.train --config
             configs/256res/ffhq_256_sdf_tpu.yaml --sdf 1`` at batch 8 (2
             sphere-init steps, 3 stage-A and 3 stage-B iterations): exit 0,
             both artifacts, finite losses, d_ms/g_ms logged, stage medians
             and wall time, alone on the card; then together: the entry's
             command again (it trains nothing), ``python -m
             sdface_gan_tpu_torch.train --config
             configs/256res/ffhq_256_sdf_ngp_tpu.yaml --sdf 1`` (NGP by the
             yaml's type): exit 0, both artifacts, finite losses with
             g_smooth (its logged step ms taken beside the others,
             ``card_shared_with``), and evaluate's untimed tools (the
             heads' FID stats, both probe stages, sdf_mesh), with
             evaluate's untimed eval runs in this process.  In stage C's
             wave, at batch 2: a fresh experiment with ``--exit-after 1``
             that exits 3 leaving a ``models_*`` checkpoint, then the same
             command without it resuming at step + 1 and finishing
             (train_cli_flow).  Each
             command runs in one ``.chip_smoke_train_*`` directory with a
             ``configs`` symlink.
9. evaluate - the evaluation and geometry tools over train_cli's two
             artifacts, in its directory: 48 procedural 256^2 heads into a
             store (``python -m sdface_gan_tpu_torch.data.synthetic``, in
             prepare) and their FID stats (``calc_fid_stats``, in
             train_cli's wave); ``eval.main`` in this process, f32 with the
             PNG dump against the store (finite FID and KID), then bf16 and
             f32 with ``--no_dump`` against the stats (images/s: generation
             + Inception, host clock after a synchronise), then the NGP
             artifact: siren_field (or hash_encode and table_gather)
             launched once per batch, the plain field and the plain encode
             never on a CUDA tensor; the f32 dump run profiled whole and a
             short profiled bf16 run (both untimed, in this process while
             train_cli's wave runs) show each dtype's field kernel by name
             (f32: siren_field_f32_kernel, bf16: siren_field_mma_kernel) and
             not the other; each ``eval.main``'s seconds and its FID's
             ``sqrtm`` seconds; ``probe_geometry --stage a`` and ``--stage b
             --mesh`` (four identities and a verdict) and ``sdf_mesh
             --identities 2`` (32 view PNGs, a mesh or its failure line per
             identity), run in train_cli's wave, and ``eval_files`` on the
             dump in stage C's wave (evaluate_files), each exit 0;
             the FID Inception on the card against the CPU (TF32
             off, <= 1e-4 of max |activation|, 256^2 and 512^2) and its ms
             per batch of 8; sdf_mesh's surface probe at 128^3 timed, its
             volume's align_volume on the card against the CPU (<= 1e-6),
             the f32 field kernel alone at that shape beside its plain
             version and bound; marching cubes on a sphere made on the card
             at 128^3 (a closed mesh; host seconds); the phase's wall time.
10. train_stage_c - stage C over train_cli's artifacts, in its directory:
             train_stage_c_parity, one E step per encoder on the card against
             the CPU (the VAE at 64^2 with injected eps; pSp at 256^2 with
             the ID and LPIPS terms on random weights and injected mean
             styles; small generators, batch 2, f32; loss rel <= 1e-4, every
             encoder gradient <= 1e-3 of its norm, under ``masked_parity``'s
             rule with the encoders' ReLU / PReLU / leaky-ReLU kinks too);
             before it, alone on the card: the E-step ms (CUDA events,
             median after the first of 5), images/s and peak memory (<= 80
             GB) of each encoder at batch 8, 256^2, against train_cli's
             flagship generator (pSp with ID and LPIPS), one pSp step
             profiled (top device operations); one VAE E step against
             train_cli's NGP generator, counted and profiled:
             hash_encode_kernel and neither K1 nor K2 (the frozen renderer);
             after the parity, ``python -m sdface_gan_tpu_torch.train ...
             --vae 1`` and ``--psp 1`` (weight archives of random ID /
             LPIPS nets) and ``--vae 1`` under the NGP yaml, at once, 3
             iterations each: stages A and B skipped (artifacts untouched),
             ``encoder`` / ``encoder_psp`` written, every loss finite (their
             logged E-step ms share the card); a ``--vae 1`` run cut by
             ``--exit-after 1`` (exit 3) that the next run resumes at step +
             1 (its own experiment, holding copies of train_cli's two stage
             artifacts); and the rest of the script's untimed work, at once:
             giraffe_train's CLI runs, train_cli's cut pair (batch 2), the
             CLI runs of bridge_and_images (then eval_files) and of giraffe,
             and the staged 512^2 CLI (train_512, after the ``--psp 1`` run),
             so that no more than four 10-14 GB train processes share the
             card (its used memory sampled: the peak in GB), with
             train_512's card-vs-CPU parity in this process after stage C's
             parity.  The processes of a wave (and
             of train_cli's) run with two host threads each and the
             allocator's expandable segments.
11. bench   - ``python -m sdface_gan_tpu_torch.bench`` and ``... .bench_ngp`` at
             their defaults (the flagship at batch 32; the upstream hash grid,
             stage-A NGP at batch 4, three NGP serving grids at batch 8), one
             after the other: exit 0, finite positive values, the card named,
             each kernel launched in its timed loop; then the benches'
             calls in this process, counted and profiled (a profiler session
             that dropped a wanted kernel's records is run again, up to 3):
             the bench's sampler (batch 32) runs siren_field_mma_kernel<256>
             by name, the hash-grid bench's functions hash_encode and K1,
             the packed serving arm table_gather and hash_encode; no plain
             field or plain encode on the card.
12. train_64 - ``scripts/torch_convergence_run.py`` at 2 sphere-init steps and
             3 iterations per stage (a 64-image store, a 64-image eval): the
             64^2 configs' path (store, train, both probes, sdf_mesh, eval)
             on the card, every loss finite, both verdicts, a mesh, a finite
             FID.  Its processes run beside train_stage_c's parity and train
             processes (started after stage C's timed steps, awaited after
             its train processes); they time nothing.
13. bridge_and_images - inside train_cli's directory, after train_stage_c:
             every committed image of ``tests/fixtures/images/`` (JPEGs of
             178 x 218 in 4:2:0, 4:2:2, 4:4:4, grey and with restart
             markers, progressive (one block-smoothed), arithmetic-coded,
             lossless, CMYK, YCCK and sampled h1v2, h4v1, h4v2 and chroma
             above luma; palette, interlaced and 16-bit PNG; BMP, also
             RLE8, RLE4, bit-field and 16-bit; lossy, lossless, alpha,
             extended and animated WebP at 178 x 218, lossy WebP of
             libwebp's other encoder settings, lossy and lossless WebP at
             512^2) decoded by
             the port byte-equal to the PIL decode committed beside it, ms
             per decode (medians by kind); 48 JPEGs and 48 WebPs through
             ``prepare_data --size 256`` (images/s); the committed JAX run
             (``tests/fixtures/jax_run/``) imported: stage A's archive by
             ``python -m sdface_gan_tpu_torch.import_jax_checkpoints`` from
             its yaml (in
             stage C's wave, after its 32^2 store), stage B's by
             ``import_jax_run``; its ``full_pipeline`` served by
             ``SDFaceSampler.from_checkpoint`` in f32 through the field kernel
             (width 64) with JAX's z, angles and truncation pair, within 2e-3
             + IMAGE_TOL (rtol 2e-3, atol 2e-4) of JAX's images; its stage-B
             ``models_0000002`` resumed for two iterations (resumed at step
             3, finite losses, ``models_*`` written); ``train`` from JAX's
             ``sdf_init_models`` (2 + 2 iterations, in stage C's wave after
             the import); a VAE stage C (2
             iterations) against JAX's generator; and train_cli's flagship
             ``full_pipeline`` through ``from_checkpoint`` in bf16 at batch
             8, bit-equal to a sampler built from the same state dict.
14. giraffe - the GIRAFFE family's serving path, after bridge_and_images in
             train_cli's directory: ``configs/256res/ffhq_256.yaml`` at full
             width (z 256, decoder 8 x 128 with rgb_out 256, background 4 x
             64, neural renderer 256 -> 256^2, 64 samples on a 16^2 volume)
             on seeded port weights, one batch-4 ``giraffe_forward`` in eval
             mode (fixed codes, ``fixed_camera``, ``fixed_transformations``,
             f32) with the plain NeRF decoder, with the hash decoder of
             ``ffhq_256_vae_hash.yaml --i_embed 1`` (the upstream grid, T =
             2^19) and with ``--small_net 1``: each on the card against the
             CPU (<= 2e-3 max abs), ms per request, images/s, peak GB;
             hash_encode launched in the counted requests and the plain
             encode never on a CUDA tensor; the kernel against the plain
             encode on the hash request's own box-local points with the
             table redrawn at std 1 (<= 1e-5), their out-of-box share, the
             kernel's device ms there beside its bound (the rows those
             points touch); marching cubes on the plain model's density
             (64^3, faces on the card, alpha against the CPU's); the
             committed JAX GIRAFFE run (``tests/fixtures/jax_giraffe_run/``)
             imported by ``python -m sdface_gan_tpu_torch.import_jax_checkpoints
             --sdf 0 --i_embed 1 ...`` (in stage C's wave), JAX's codes, camera, transforms and
             background rotation rendered through the hash kernel within
             2e-3 + IMAGE_TOL of JAX's images; ``python -m
             sdface_gan_tpu_torch.render`` over the yaml's programs with
             ``--export_meshes 1``, ``render --vae 1`` (a port-saved VAE
             ``encoder.pt``, the committed image files) and ``extract_mesh
             --n_meshes 2`` after the import, and both entries on the
             surface model (the seeded plain generator, density x 20), in
             stage C's wave: PNG sheets and ``.ply`` files, seconds of each
             command.
15. giraffe_train - GIRAFFE's and gan2d's training, after giraffe in
             train_cli's directory (its CLI processes, below, run beside
             train_stage_c's train processes): the D, G and (``--vae 1``) E
             steps of ``ffhq_256.yaml`` (plain and ``--small_net 1``) and
             ``ffhq_256_vae_hash.yaml --i_embed 1`` at full width and the
             yamls' batch 32 on seeded weights (the hash tables at std 1)
             and procedural 256^2 heads: median event ms of 3 after a
             warm-up, peak GB, a profiled step's device ms over that median
             (``busy_over_ms``, unclamped) and 1 minus it, the hash
             kernels' launches per step kind (K1 in G steps only, never K2,
             no plain encode on the card; the hash G step's profile names
             hash_encode_kernel and hash_encode_backward_kernel); K1 against
             the plain VJP on that G step's own box-local points (<= 1e-5 of
             the norm), timed beside ``index_add_`` and its bound; one D, G
             and E step of the hash decoder at the fixture's cut width and
             one gan2d D and G step, the card against the CPU
             (``masked_parity``: loss rel 1e-4, gradients 1e-3 of their
             norm), all alone on the card; and the CLI runs' results:
             ``import_jax_checkpoints --sdf 0`` of the committed JAX GIRAFFE run with every tree and ``train --sdf 0``
             resuming it at it 5-6, a ``train --sdf 0 --exit-after 1`` run
             (exit 3) and its resume at it + 1 (exit 3 again), and a
             ``method: gan2d`` yaml at 64^2 for 3 iterations.
16. serve_512 - the 512^2 configuration
             (``configs/512res/ffhq_512_sdf_tpu.yaml``, resolved as
             ``bench_serving_512`` resolves it: the 8 x 256 SIREN field at
             64^2 x 24 samples under a decoder to 512^2, ``n_latent`` 8)
             behind ``SDFaceSampler`` at batch 8, bf16 weights: two seed
             requests and one azim/elev request counted (siren_field in
             every request, no plain field on the card), a profiled request
             showing siren_field_mma_kernel<256> by name and neither the f32
             kernel nor a plain field; one f32 request through the fused
             field against the plain field (<= 2e-3) and the bf16 request
             under the bf16 contract.
17. bench_512 - ``python -m sdface_gan_tpu_torch.bench_serving_512`` (batch
             4, 8, 16, 32) and ``... .bench_train_512`` (the D step with R1,
             the G step and the path step at batch 2, 4, 8; 3 timed calls
             per step kind, ``--iters 3``, where its default is 10) at their
             default batches, one after the other, alone on the card: every batch
             ``fits_hbm`` with its peak GB, finite values, the card named,
             the field kernel once per timed serving call; images/s, ms per
             batch, the step ms and ``it_per_s_combined``.
18. train_512 - what ran in stage C's wave: ``python -m
             sdface_gan_tpu_torch.train --config
             configs/512res/ffhq_512_sdf_tpu.yaml --sdf 1 --iters 20
             --sphere_init_iters 10`` over the 64 + 512 store (sphere init,
             stage A at 64^2 with the yaml's 4,096 eikonal points, no remat
             and bf16 G, the A -> B transfer, stage B at 512^2): exit 0,
             every logged loss finite, ``vol_renderer`` and
             ``full_pipeline``, a 512^2 sample grid; and train_512_parity:
             the stage-B D step (R1) and G step at 512^2 at the CPU tests'
             width cut, the card against the CPU under ``masked_parity``
             (loss rel 1e-4, gradients 1e-3 of their norm), the path step
             so in f64 and in f32 against the CPU's f64 no worse than the
             CPU's own f32 (x 1.2 + 1e-4).
19. ddp     - data parallelism (``sdface_gan_tpu_torch/parallel/``) on the
             one card.  ddp_nccl: train_cli's entry under
             ``python -m torch.distributed.run --standalone --nproc_per_node 1``
             (an NCCL group at world 1, its own experiment), chained after
             stage C's ``--vae 1`` in its wave with a plain rerun before it:
             exit 0, its logged losses against the entry's at the same seed
             within rel 1e-6 through stage A's first adversarial row (the
             first inside the data-parallel span), 1e-3 over stage A's later
             rows and stage B's first D loss, R1 and real score, and 0.25
             over the rest of stage B (the card's kernels are not
             bit-reproducible, and Adam turns that into drifts of a few %;
             the plain rerun's distances are reported beside), its D and G
             ms beside the entry's.  ddp, on a thread of this process beside
             train_cli's wave once 40 GB of the card are free (stage C's wave
             ran the card out of memory with it): two gloo ranks sharing
             cuda:0 (``tests/torch_parallel_ranks.py``'s card job; NCCL needs a
             card per rank) at global batch 8, seeded weights and live
             generators, f32 with TF32 off: stage B's D (R1, the minibatch
             stddev over both ranks), G and path steps at the flagship's
             widths, stage A's D (R1) and G steps under ``_tpu`` and a VAE E
             step at 256^2, each against rank 0's one-rank step at the same
             global batch (train_parity's bars: metrics rel 1e-4, every
             gradient 1e-3 of its norm; the StyleGAN steps under
             masked_parity's rule: rank 0's step also replays the ranks'
             leaky-ReLU masks and is held with them where a unit took the
             other slope), the parameters after an Adam step bit-equal across
             the ranks; the bf16 sampler's gathered batch
             within 2e-3 of one rank's with ``siren_field_mma_kernel<256>`` in
             rank 0's profile; the 128^3 probe through ``render_ray_sharded``
             (``siren_field_f32_kernel<256>`` at P = 1,048,576 per rank) within
             1e-5 of one rank's; no plain field call in either; each step's ms
             beside the one-rank step's and the gloo all-reduce's ms and bytes
             (diagnostics: two ranks share the card's SMs, gloo stages
             through the host, the wave shares the card).  evaluate times the
             f32 kernel alone at a rank's band (``field_at_rank_band``).
20. the ``kernels`` line (launches of every phase's counted runs: the
             bench processes and the ddp ranks report theirs; K2 in the
             forward-mode eikonal's roles counted from (u)'s jvp G step:
             as the encode's tangent its own row, ``hash_encode_jvp``, and
             as the tangent's table gradient in K2's row, its time there
             as ``jvp_table_gradient``), then the nvidia-smi line, then the
             ``ok`` line.
TF32 is off throughout, so every f32 reference really is f32: this process
turns it off, and the train entry turns it off in its own (train_cli checks
the line it prints).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import fnmatch
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense), used for each kernel's least time.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# f32 instructions per FiLM-sine evaluation in the field kernel's epilogue:
# bias add, FiLM fma, fast_sin (2 mul, rint, mul, sub, mul, 5 fma, mul), bf16 round
SINE_INSTRUCTIONS = 14
FIELD_DESIGN = {
    "bfloat16": "siren_field_mma_kernel<W>: mma.sync m16n8k16 bf16->f32 fed by ldmatrix, "
                "weights in a 2-stage cp.async ring of [64, W+8] K-chunks, 8 warps of "
                "64x64 output blocks per 128-point tile (W=256), bf16 activations in "
                "shared memory, FiLM-sine epilogue on the FP32 pipes",
    "float32": "siren_field_f32_kernel<W>: FMA pipes, f32 throughout; 8 warps, an 8-point x "
               "16-column register block (128 f32 accumulators) per thread over 128-point "
               "tiles (W=256), weights in a 2-stage cp.async ring of [32, W] f32 K-chunks, "
               "f32 activations in shared memory updated in place",
}

BATCH = 8
RES, SAMPLES, WIDTH, DEPTH, STYLE = 64, 24, 256, 8, 256
POINTS = RES * RES * SAMPLES
BENCH_BATCH = 32  # sdface_gan_tpu_torch.bench.BATCH
BENCH_STAGE_A_BATCH = 4  # bench_ngp.bench_stage_a_ngp's batch
SOURCES = ("siren_field", "hash_grid")
NGP_BOUND = 2.0  # NGPSirenConfig.bound


START = time.perf_counter()


def emit(**record) -> None:
    """One JSON line; ``t_s`` is the script's wall seconds when it was printed."""
    print(json.dumps({**record, "t_s": round(time.perf_counter() - START, 1)}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def full_config():
    from sdface_gan_tpu_torch.models import GeneratorConfig, RendererConfig

    return GeneratorConfig(
        size=256, style_dim=STYLE, full_pipeline=True,
        renderer=RendererConfig(type="sdf", out_im_res=RES, n_samples=SAMPLES,
                                style_dim=STYLE, width=WIDTH, depth=DEPTH),
    )


def ngp_configs() -> dict:
    """The repository's two NGP configurations, resolved from their yaml files."""
    from sdface_gan_tpu_torch import configs

    return {"tuned": configs.ffhq_256_sdf_ngp_tpu(), "upstream": configs.ffhq_256_sdf_ngp()}


def field_flops(depth: int, width: int) -> int:
    """Multiply-adds x 2 per point: 3->W, (D-1) WxW, W->1, (W+3)->W, W->3."""
    return 2 * (3 * width + (depth - 1) * width * width + width
                + (width + 3) * width + width * 3)


def field_bytes(pack, b: int, p: int) -> int:
    """Each input read once, each output written once."""
    weights = sum(t.numel() * t.element_size() for t in pack.tensors())
    inputs = 2 * b * p * 3 * 4 + 2 * b * (pack.depth + 1) * pack.width * 4
    outputs = b * p * (3 + 1) * 4 + b * p * pack.width * pack.w_first.element_size()
    return weights + inputs + outputs


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``iters`` event-timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernel named ``kernel`` over
    ``iters`` calls of ``fn``, from the profiler's trace
    (``bench.kernel_device_ms``: a session whose device records of the
    kernel the profiler dropped is run again)."""
    from sdface_gan_tpu_torch.bench import kernel_device_ms

    ms = kernel_device_ms(fn, kernel, iters)
    check(ms is not None, f"profiler kept no launch of {kernel} in 3 sessions of {iters} calls")
    return ms


def field_inputs(net, b: int, p: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.randn((b, p, 3), generator=g, device="cuda") * 0.5
    views = torch.nn.functional.normalize(
        torch.randn((b, p, 3), generator=g, device="cuda"), dim=-1)
    style = torch.randn((b, net.cfg.style_dim), generator=g, device="cuda")
    return pts, views, style


def check_field(depth: int, p: int, seed: int, width: int = WIDTH, bf16: bool = True,
                batch: int = 2) -> dict:
    """The field kernel against its plain version at one shape, f32 and
    (unless ``bf16`` is False) bf16."""
    import copy

    import torch

    from sdface_gan_tpu_torch.models.siren import SirenConfig, SirenGenerator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    net32 = SirenGenerator(SirenConfig(depth=depth, width=width, style_dim=STYLE),
                           generator=torch.Generator().manual_seed(seed)).cuda()
    pts, views, style = field_inputs(net32, batch, p, seed)

    def run(net, fn):
        pack = sk.pack_siren_field(net)
        gamma, beta = sk.film_coeffs(net, style)
        rgb, sdf, feat = fn(pack, pts, views, gamma, beta)
        torch.cuda.synchronize()
        return torch.cat([rgb, sdf, feat.float()], -1)

    truth = run(net32, sk.siren_field_reference)
    kern32 = run(net32, sk.siren_field_fused_parts)
    err32 = (kern32 - truth).abs().max().item()
    check(bool(torch.isfinite(kern32).all()), "f32 field kernel output finite")
    check(err32 <= 1e-3, f"f32 field kernel vs plain: max abs err {err32} <= 1e-3")
    if not bf16:
        return dict(depth=depth, width=width, style=STYLE, batch=batch, points=p,
                    f32_max_abs_err=err32)
    net16 = copy.deepcopy(net32).to(torch.bfloat16)
    plain16 = run(net16, sk.siren_field_reference)
    kern16 = run(net16, sk.siren_field_fused_parts)
    err16_kernel = (kern16 - truth).abs().mean().item()
    err16_plain = (plain16 - truth).abs().mean().item()
    rec = dict(depth=depth, width=width, style=STYLE, batch=batch, points=p,
               f32_max_abs_err=err32, bf16_mean_err_kernel=err16_kernel,
               bf16_mean_err_plain=err16_plain,
               bf16_max_abs_kernel_vs_plain=(kern16 - plain16).abs().max().item())
    check(bool(torch.isfinite(kern16).all()), "bf16 field kernel output finite")
    check(err16_kernel <= 1.2 * err16_plain + 1e-4,
          f"bf16 field quality {err16_kernel} <= 1.2 * {err16_plain} + 1e-4")
    return rec


def check_table_gather() -> list:
    """Bit-equality with the plain version at the probe's and the packed
    encode's shapes."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    g = torch.Generator(device="cuda").manual_seed(3)
    probe = torch.arange(512 * 128, dtype=torch.float32, device="cuda").reshape(512, 128)
    probe_idx = torch.randint(0, 512, (8, 128), generator=g, device="cuda", dtype=torch.int32)
    probe_idx[0, 0], probe_idx[-1, -1] = 0, 511
    rows = 73017  # the tuned grid's packed levels 0 and 1
    packed = torch.randn((rows, 64), generator=g, device="cuda").to(torch.bfloat16)
    packed_idx = torch.randint(0, rows, (2, BATCH * POINTS), generator=g, device="cuda",
                               dtype=torch.int32)
    recs = []
    for case, table, idx, ncols in (("probe", probe, probe_idx, 1),
                                    ("packed", packed, packed_idx, None)):
        got = hg.table_gather(table, idx, 0, ncols)
        want = hg.table_gather_reference(table, idx, 0, ncols)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        recs.append(dict(kernel="table_gather", case=case, table=list(table.shape),
                         dtype=str(table.dtype).split(".")[-1], idx=list(idx.shape),
                         out=list(got.shape), bit_equal=equal,
                         max_abs_err=(got.float() - want.float()).abs().max().item()))
        check(equal, f"table_gather {case}: bit-equal to the plain version")
    return recs


def grid_points(spec, n: int, seed: int):
    """n points: uniform a little beyond [-bound, bound] (some outside the
    box) and 64 per level on cell faces (x01 * scale + 0.5 integral)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    faces = []
    for lvl in range(spec.num_levels):
        scale = spec.level_scale(lvl)
        m = torch.randint(1, int(scale) + 1, (64, 3), generator=g, device="cuda").double()
        faces.append(((m - 0.5) / scale * 2.0 * NGP_BOUND - NGP_BOUND).float())
    k = n - 64 * spec.num_levels
    uniform = (torch.rand((k, 3), generator=g, device="cuda") * 2.0 - 1.0) * 1.1 * NGP_BOUND
    return torch.cat([uniform] + faces).contiguous()


def check_hash_encode() -> list:
    """Both grids, f32 and bf16 tables; the main path's level subset; the
    packed encode through both kernels.  Two point sets: uniform points with
    some outside the box and some on cell faces, and a real request's points
    in the renderer's order (the kernel's speed depends on their coherence,
    its result must not)."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    recs = []
    for name, cfg in ngp_configs().items():
        net = cfg.renderer.network_config()
        spec = net.grid
        g = torch.Generator(device="cuda").manual_seed(11)
        table32 = torch.randn((spec.table_size, spec.level_dim), generator=g, device="cuda")
        subsets = [None]
        if net.pack_plan is not None:  # the unpacked levels, as the served path encodes them
            subsets.append(tuple(l for l in range(spec.num_levels)
                                 if l not in net.pack_plan.packed_levels))
        point_sets = {"uniform_and_faces": grid_points(spec, BATCH * POINTS, seed=12),
                      "request": request_points(cfg.renderer, seed=13)}
        for kind, x in point_sets.items():
            oob = (x.abs() > NGP_BOUND).any(-1).float().mean().item()
            for dtype in (torch.float32, torch.bfloat16):
                table = table32.to(dtype)
                for levels in subsets:
                    got = hg.hash_encode(x, table, spec, NGP_BOUND, levels=levels)
                    want = hg.hash_encode_reference(x, table, spec, NGP_BOUND, levels=levels)
                    torch.cuda.synchronize()
                    diff = (got.float() - want.float()).abs()
                    rec = dict(kernel="hash_encode", grid=name, points_kind=kind,
                               dtype=str(dtype).split(".")[-1],
                               levels=list(levels) if levels else "all", points=x.shape[0],
                               oob_share=oob, out=list(got.shape),
                               max_abs_err=diff.max().item(),
                               finite=bool(torch.isfinite(got).all()))
                    recs.append(rec)
                    check(rec["finite"], f"hash_encode {name} {kind} output finite")
                    if dtype == torch.float32:
                        check(rec["max_abs_err"] <= 1e-5, f"hash_encode {name} {kind} f32: "
                              f"max abs {rec['max_abs_err']} <= 1e-5")
                    else:
                        ok = bool((diff <= 8e-3 * want.float().abs() + 1e-6).all())
                        check(ok, f"hash_encode {name} {kind} bf16: within one bf16 ulp")
            if net.pack_plan is not None:
                plan = net.pack_plan
                packed = hg.pack_hash_table(table32, plan, dtype=torch.float32)
                got = hg.hash_encode_packed(x, table32, packed, plan, bound=NGP_BOUND)
                want = hg.hash_encode_reference(x, table32, spec, NGP_BOUND)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                recs.append(dict(kernel="hash_encode_packed", grid=name, points_kind=kind,
                                 dtype="float32", packed_levels=list(plan.packed_levels),
                                 max_abs_err=err))
                check(err <= 1e-5, f"packed encode through both kernels vs plain unpacked "
                      f"({kind}): {err}")
        del table32, point_sets, x
        torch.cuda.empty_cache()
    return recs


# ||kernel - plain|| / ||plain|| of the encode's gradients: an f32 output differs in
# the order of the atomics and of the sums; a bf16 output by one bf16 rounding
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}
GRAD_CHECK_POINTS = 1 << 17
EIKONAL_SUBSAMPLE = 4096  # eikonal points per image of ffhq_256_sdf_ngp_tpu.yaml


def grad_grids() -> dict:
    """The tuned and the upstream grid, and a tiny one (T = 2^7 per level:
    every hashed level collides)."""
    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    grids = {name: cfg.renderer.network_config().grid for name, cfg in ngp_configs().items()}
    grids["tiny"] = hg.HashGridSpec.create(num_levels=4, level_dim=2, desired_resolution=64,
                                           log2_hashmap_size=7)
    return grids


def grad_points(spec, n: int, seed: int):
    """``grid_points`` (uniform, out-of-box and cell-face points) and 768
    points on the faces of the box (x01 exactly 0 or 1 on one axis)."""
    import torch

    k = 768
    g = torch.Generator(device="cuda").manual_seed(seed)
    faces = (torch.rand((k, 3), generator=g, device="cuda") * 2.0 - 1.0) * NGP_BOUND
    rows = torch.arange(k, device="cuda")
    faces[rows, rows % 3] = torch.where(rows % 2 == 0, -NGP_BOUND, NGP_BOUND)
    return torch.cat([grid_points(spec, n - k, seed + 1), faces]).contiguous()


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def hold_encode_grads(case: str, spec, x, dtypes, seed: int, bound: float = NGP_BOUND) -> list:
    """K1 (``hash_encode_backward``: d x and d table, together and d x
    alone as the eikonal's first pass asks) and K2
    (``hash_encode_double_backward``: d table and d g together; then in the
    forward-mode eikonal's roles, d g alone without g, the encode's tangent
    along v, and d table alone, the tangent's table gradient) against their
    plain versions on the points ``x`` in the box of half-width ``bound``,
    random table, cotangent g and v, one record per table dtype."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    recs = []
    oob = (x.abs() > bound).any(-1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table32 = torch.randn((spec.table_size, spec.level_dim), generator=gen, device="cuda")
    g32 = torch.randn((x.shape[0], spec.output_dim), generator=gen, device="cuda")
    v = torch.randn((x.shape[0], 3), generator=gen, device="cuda")
    for dtype in dtypes:
        dname = str(dtype).split(".")[-1]
        table, g = table32.to(dtype), g32.to(dtype)
        dx, dtable = hg.hash_encode_backward(x, table, g, spec, bound)
        dx_alone, _ = hg.hash_encode_backward(x, table, g, spec, bound, need_table=False)
        dd_table, dd_g = hg.hash_encode_double_backward(x, table, g, v, spec, bound)
        # K2's forward-mode roles: d g alone without g (the encode's tangent
        # along v), and d table alone (the tangent's table gradient for g)
        _, jvp = hg.hash_encode_double_backward(x, table, None, v, spec, bound,
                                                need_table=False)
        jvp_table, _ = hg.hash_encode_double_backward(x, table, g, v, spec, bound, need_g=False)
        torch.cuda.synchronize()
        want_dx, want_dtable = hg.hash_encode_backward_reference(x, table, g, spec, bound)
        want_dd_table, want_dd_g = hg.hash_encode_double_backward_reference(
            x, table, g, v, spec, bound)
        pairs = {"d_x": (dx, want_dx), "d_x_alone": (dx_alone, want_dx),
                 "d_table": (dtable, want_dtable), "dd_table": (dd_table, want_dd_table),
                 "dd_g": (dd_g, want_dd_g), "jvp": (jvp, want_dd_g),
                 "jvp_table": (jvp_table, want_dd_table)}
        rec = dict(kernel="hash_encode_backward/double_backward", case=case, dtype=dname,
                   points=x.shape[0], oob_share=oob.float().mean().item(),
                   box_face_points=int(((x.abs() == bound).any(-1) & ~oob).sum()),
                   rel_err={k: _rel_err(a, b) for k, (a, b) in pairs.items()},
                   max_abs_err={k: (a.float() - b.float()).abs().max().item()
                                for k, (a, b) in pairs.items()},
                   tolerance={k: GRAD_RTOL["float32" if k.startswith("d_x") else dname]
                              for k in pairs})
        recs.append(rec)
        for k, (a, _) in pairs.items():
            check(bool(torch.isfinite(a.float()).all()), f"{case} {dname} {k} finite")
            check(rec["rel_err"][k] <= rec["tolerance"][k],
                  f"{case} {dname} {k}: kernel vs plain {rec['rel_err'][k]} of the norm")
        check(bool((dx[oob] == 0).all()) and bool((dd_g[oob].float() == 0).all())
              and bool((jvp[oob].float() == 0).all()),
              f"{case} {dname}: out-of-box points give zero gradients")
        del pairs, dx, dtable, dx_alone, dd_table, dd_g, jvp, jvp_table, want_dx, want_dtable
        del want_dd_table, want_dd_g
    del table32, g32, v
    torch.cuda.empty_cache()
    return recs


CONTENTION_POINTS = (("one_cell", 4096), ("rays", 24 * 4096), ("mixed", 1), ("mixed", 31),
                     ("mixed", 33), ("mixed", 700))


def contention_points(spec, kind: str, n: int, seed: int):
    """Points that put many lanes of a warp on one table row, for the
    kernels' warp-level sums: ``one_cell`` (every point in one cell of level
    0: all 32 lanes on one row at every corner of that level), ``rays`` (24
    sorted samples per ray, neighbouring rays next to each other, as the
    renderer orders them: lanes share rows in runs) and ``mixed`` (in-box,
    out-of-box, box-face points and one point repeated, shuffled so that
    every warp mixes them; the first point in the box; n not a multiple of
    32 leaves tail lanes)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)

    if kind == "one_cell":
        scale = spec.level_scale(0)
        cell = torch.tensor([2.0, 3.0, 1.0], device="cuda", dtype=torch.float64)
        pos = cell + 0.1 + 0.8 * rand(n, 3)
        x = (pos - 0.5) / scale * 2.0 * NGP_BOUND - NGP_BOUND
    elif kind == "rays":
        rays = n // 24
        side = int(rays ** 0.5)
        i = torch.arange(rays, device="cuda", dtype=torch.float64)
        d = torch.stack([(i % side) / side - 0.5, (i // side) / side - 0.5,
                         torch.full_like(i, 2.0)], -1)
        d = d / d.norm(dim=-1, keepdim=True)
        t = torch.sort(0.5 + 1.8 * rand(rays, 24), dim=-1).values
        x = (torch.tensor([0.1, -0.2, -1.4 * NGP_BOUND], device="cuda", dtype=torch.float64)
             + t[..., None] * NGP_BOUND * d[:, None, :]).reshape(-1, 3)
    else:
        x = (rand(n, 3) * 2.0 - 1.0) * 1.1 * NGP_BOUND
        kinds = torch.randint(0, 4, (n,), generator=gen, device="cuda")
        axis = torch.randint(0, 3, (n,), generator=gen, device="cuda")
        face = kinds == 1
        x[face, axis[face]] = torch.where(rand(n)[face] < 0.5, -NGP_BOUND, NGP_BOUND).double()
        x[kinds == 2] = torch.tensor([0.11, -0.52, 0.93], device="cuda",
                                     dtype=torch.float64) * NGP_BOUND
        x[0] = torch.tensor([0.3, 0.2, -0.1], device="cuda", dtype=torch.float64) * NGP_BOUND
    return x.float().contiguous()


def check_encode_grads() -> list:
    """K1 and K2 against their plain versions: on three grids, f32 and bf16
    tables, 2^17 points of every kind (uniform, out-of-box, cell-face and
    box-face); on the same grids and tables, the points that put a warp's
    lanes on one row (``contention_points``: one cell of level 0, a ray's
    samples, and warps mixing in-box, out-of-box and box-face points with
    tail lanes at n = 1, 31, 33, 700); then at the NGP stage-A G step's
    shapes (``GRAD_CASES``), batch 8, on a real request's points: (t) the
    tuned grid, bf16, the render's 786,432 points and the subsampled
    eikonal's 32,768, (u) the upstream grid, f32, 786,432 points, and the
    first 393,216 of them (``bench_ngp``'s stage A at batch 4)."""
    import torch

    recs = []
    grids = grad_grids()
    for name, spec in grids.items():
        recs += hold_encode_grads(name, spec, grad_points(spec, GRAD_CHECK_POINTS, seed=31),
                                  (torch.float32, torch.bfloat16), seed=32)
        for i, (kind, n) in enumerate(CONTENTION_POINTS):
            x = contention_points(spec, kind, n, seed=51 + i)
            check(x.shape[0] == n, f"{kind}: {n} points")
            recs += hold_encode_grads(f"{name}_{kind}_{n}", spec, x,
                                      (torch.float32, torch.bfloat16), seed=52 + i)
    points = grad_case_points()
    recs += hold_encode_grads("t_render", grids["tuned"], points["render"], (torch.bfloat16,),
                              seed=41)
    recs += hold_encode_grads("t_eikonal", grids["tuned"], points["eikonal"], (torch.bfloat16,),
                              seed=41)
    recs += hold_encode_grads("u_render_and_eikonal", grids["upstream"], points["render"],
                              (torch.float32,), seed=41)
    # bench_ngp's stage A: the same grid and request, batch 4 (the first four images)
    recs += hold_encode_grads("u_bench_stage_a_batch4", grids["upstream"],
                              points["render"][:BENCH_STAGE_A_BATCH * POINTS], (torch.float32,),
                              seed=42)
    check(points["render"].shape[0] == BATCH * POINTS, "K1/K2 held at the G step's render points")
    return recs


def check_bench_hash() -> tuple:
    """``hash_encode`` and K1 at ``bench_ngp``'s hash-grid shape (its 393,216
    uniform points on the upstream grid, the bench's own draw, its bound 1;
    a std-1 table in place of the bench's 1e-4 one, so that the bars mean
    something): the forward and the table gradient of sum(encode^2) that the
    bench times, against the plain encode and the plain VJP; then K1 and K2
    on the same points by ``hold_encode_grads``.  Returns the encode's
    record and K1 / K2's."""
    import torch

    from sdface_gan_tpu_torch import bench_ngp
    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    spec = hg.HashGridSpec.create(desired_resolution=4096)
    x, table = bench_ngp.hash_inputs(spec, bench_ngp.HASH_POINTS, "cuda", std=1.0)
    fns = bench_ngp.hash_functions(x, table, spec)
    got, grad = fns["forward"](), fns["table_grad"]()
    want = hg.hash_encode_reference(x, table, spec)
    _, want_grad = hg.hash_encode_backward_reference(x, table, 2.0 * want, spec, need_x=False)
    torch.cuda.synchronize()
    rec = dict(kernel="hash_encode + hash_encode_backward", case="bench_ngp_hash",
               grid="upstream", dtype="float32", points=x.shape[0],
               max_abs_err=(got - want).abs().max().item(),
               table_grad_rel_err=_rel_err(grad, want_grad),
               tolerance=dict(forward_max_abs=1e-5, table_grad_rel=GRAD_RTOL["float32"]))
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(grad).all()),
          "bench_ngp hash grid: finite encode and table gradient")
    check(rec["max_abs_err"] <= 1e-5,
          f"bench_ngp hash grid: hash_encode vs plain, max abs {rec['max_abs_err']} <= 1e-5")
    check(rec["table_grad_rel_err"] <= GRAD_RTOL["float32"],
          f"bench_ngp hash grid: table gradient through K1 vs the plain VJP, "
          f"{rec['table_grad_rel_err']} of the norm")
    del fns, got, grad, want, want_grad
    grad_recs = hold_encode_grads("bench_ngp_hash", spec, x, (torch.float32,), seed=61,
                                  bound=1.0)
    del x, table
    torch.cuda.empty_cache()
    return rec, grad_recs


def drive(sampler, kernels) -> tuple:
    """Zero the counts, answer two seed requests and one azim/elev request,
    read the counts: each of ``kernels`` must have launched."""
    import torch

    from sdface_gan_tpu_torch.ops import _ext

    torch.cuda.synchronize()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [sampler.sample(seed=1), sampler.sample(seed=2),
            sampler.sample(azim=0.2, elev=-0.1)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_ext.LAUNCHES)
    for name in kernels:
        check(launches[name] >= len(outs),
              f"kernel {name} launched in every request ({launches[name]} in {len(outs)})")
    size = sampler.cfg.size
    for img in outs:
        check(tuple(img.shape) == (BATCH, size, size, 3), f"image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), "image finite")
    check(not torch.equal(outs[0], outs[1]), "two seeds give two batches")
    return outs, launches, dt


def profile_request(sampler, kernel_names, absent=()) -> dict:
    """Kernel device times of one profiled request; each of ``kernel_names``
    must appear in it by name, and none of ``absent``.  The profiler can
    drop some device records of a session, so a request that misses a
    named kernel is profiled again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sampler.sample(seed=3)
            torch.cuda.synchronize()
        device_us = {}  # kernels only: a CPU op's device time repeats its kernels'
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "device_time_total", None)
            device_us[ev.key] = us if us is not None else ev.cuda_time_total
        if all(any(kname in k for k in device_us) for kname in kernel_names):
            break
    total_us = sum(device_us.values())
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:12]
    named = {}
    for kname in kernel_names:
        named[kname] = sum(us for k, us in device_us.items() if kname in k) / 1e3
        check(named[kname] > 0, f"profiler shows {kname} inside a request")
    for kname in absent:
        check(not any(kname in k for k in device_us), f"profiler shows no {kname} in the request")
    return dict(device_events=len(device_us), device_ms_total=total_us / 1e3,
                kernel_ms=named, top=[(k[:90], us / 1e3) for k, us in top])


def images_per_s(sampler, n: int = 10) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        sampler.sample(seed=10 + i)
    torch.cuda.synchronize()
    return BATCH * n / (time.perf_counter() - t0)


def serve(results: dict) -> None:
    import torch

    from sdface_gan_tpu_torch.models import Generator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    cfg = full_config()
    model = Generator(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    sampler = SDFaceSampler(model, batch=BATCH)
    sampler.warmup()
    outs, launches, dt = drive(sampler, ["siren_field"])
    results["launches"] = launches
    emit(phase="serve", requests=3, batch=BATCH, dtype="bfloat16", launches=launches,
         seconds_three_requests=dt,
         image_range=[min(o.min().item() for o in outs), max(o.max().item() for o in outs)])

    mma = sk.kernel_name(torch.bfloat16)
    prof = profile_request(sampler, [mma], absent=[sk.kernel_name(torch.float32)])
    results["profile"] = prof
    emit(phase="profile", device_events=prof["device_events"],
         device_ms_total=prof["device_ms_total"], kernel=mma,
         siren_field_kernel_ms=prof["kernel_ms"][mma])

    # one request in f32: fused field against the plain field; the bf16
    # request (seed 1, fused) held to the bf16 contract against that f32 image
    plain16 = SDFaceSampler(model, batch=BATCH, use_fused_kernel=False).sample(seed=1)
    model32 = Generator(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    fused32 = SDFaceSampler(model32, batch=BATCH).sample(seed=1)
    plain32 = SDFaceSampler(model32, batch=BATCH, use_fused_kernel=False).sample(seed=1)
    err = (fused32 - plain32).abs().max().item()
    bf16_err = (outs[0].float() - plain32).abs().mean().item()
    bf16_plain_err = (plain16.float() - plain32).abs().mean().item()
    results["serve_f32_max_abs_err"] = err
    results["serve_bf16_mean_abs_err"] = dict(fused=bf16_err, plain=bf16_plain_err)
    # the decoder (f32 convs, TF32 off) carries the field's ~1e-5 summation-order
    # differences into the image; 2e-3 is the whole-image tolerance of the CPU tests
    check(err <= 2e-3, f"f32 request, fused vs plain field: max abs err {err} <= 2e-3")
    check(bf16_err <= 1.2 * bf16_plain_err + 1e-4,
          f"bf16 request vs f32 plain: mean abs {bf16_err} <= 1.2 * {bf16_plain_err} + 1e-4")
    emit(phase="serve_compare", f32_fused_vs_plain_max_abs_err=err, tolerance=2e-3,
         bf16_fused_request_vs_f32_plain_mean_abs_err=bf16_err,
         bf16_plain_request_vs_f32_plain_mean_abs_err=bf16_plain_err,
         bf16_tolerance="fused <= 1.2 x plain + 1e-4")
    results["images_per_s"] = images_per_s(sampler)


def serve_f32(results: dict) -> None:
    """The SIREN generator with f32 weights, as ``SDFaceSampler`` serves a
    state dict by default: the f32 field kernel's path.  Zero the counts,
    answer three requests, read the counts; a profiled request must show the
    f32 kernel by name and not the bf16 one; images/s."""
    import torch

    from sdface_gan_tpu_torch.models import Generator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    model = Generator(full_config(), device="cuda", generator=torch.Generator().manual_seed(0))
    sampler = SDFaceSampler(model, batch=BATCH)
    sampler.warmup()
    outs, launches, dt = drive(sampler, ["siren_field"])
    f32 = sk.kernel_name(torch.float32)
    prof = profile_request(sampler, [f32], absent=[sk.kernel_name(torch.bfloat16)])
    results["f32_launches"] = launches
    results["f32_request"] = dict(device_ms_total=prof["device_ms_total"],
                                  kernel_ms=prof["kernel_ms"][f32], top=prof["top"],
                                  images_per_s=images_per_s(sampler))
    emit(phase="serve_f32", requests=3, batch=BATCH, dtype="float32", launches=launches,
         seconds_three_requests=dt, profile_device_ms_total=prof["device_ms_total"],
         kernel=f32, siren_field_kernel_ms=prof["kernel_ms"][f32],
         image_range=[min(o.min().item() for o in outs), max(o.max().item() for o in outs)])


def serve_ngp(results: dict) -> dict:
    """The tuned-grid NGP generator served in bf16, then one upstream-grid
    request; returns the served tuned model (for the timing phase)."""
    from dataclasses import replace

    import torch

    from sdface_gan_tpu_torch.models import Generator
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    cfgs = ngp_configs()
    model = Generator(cfgs["tuned"], device="cuda",
                      generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    sampler = SDFaceSampler(model, batch=BATCH)
    check(model.renderer.network.encoder.packed is not None, "tuned grid packed at load")
    sampler.warmup()
    outs, launches, dt = drive(sampler, ["hash_encode", "table_gather"])
    results["ngp_launches"] = launches
    prof = profile_request(sampler, ["hash_encode_kernel", "table_gather_kernel"])
    results["ngp_profile"] = prof
    emit(phase="serve_ngp", config="ffhq_256_sdf_ngp_tpu", requests=3, batch=BATCH,
         dtype="bfloat16", launches=launches, seconds_three_requests=dt,
         image_range=[min(o.min().item() for o in outs), max(o.max().item() for o in outs)],
         profile_device_ms_total=prof["device_ms_total"], profile_kernel_ms=prof["kernel_ms"])

    up = Generator(cfgs["upstream"], device="cuda",
                   generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    up_sampler = SDFaceSampler(up, batch=BATCH)
    up_sampler.warmup()
    from sdface_gan_tpu_torch.ops import _ext

    torch.cuda.synchronize()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    img = up_sampler.sample(seed=1)
    torch.cuda.synchronize()
    up_dt = time.perf_counter() - t0
    up_launches = dict(_ext.LAUNCHES)
    check(up_launches["hash_encode"] >= 1, "upstream grid: hash_encode launched")
    check(bool(torch.isfinite(img).all()) and tuple(img.shape) == (BATCH, 256, 256, 3),
          "upstream grid: finite image of the expected shape")
    results["ngp_upstream_launches"] = up_launches
    results["ngp_upstream_images_per_s"] = images_per_s(up_sampler, n=3)
    emit(phase="serve_ngp", config="ffhq_256_sdf_ngp", requests=1, batch=BATCH,
         dtype="bfloat16", launches=up_launches, seconds_one_request=up_dt)
    del up, up_sampler
    torch.cuda.empty_cache()

    # f32, hash table redrawn with std 1 (the init's +-1e-4 table would hide
    # the encode from the image): kernels vs plain versions, packed vs unpacked
    model32 = Generator(cfgs["tuned"], device="cuda", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        emb = model32.renderer.network.encoder.embeddings
        emb.copy_(torch.randn(emb.shape, generator=torch.Generator().manual_seed(5)))
    kern = SDFaceSampler(model32, batch=BATCH).sample(seed=1)
    plain = SDFaceSampler(model32, batch=BATCH, use_fused_kernel=False).sample(seed=1)
    rcfg = cfgs["tuned"].renderer
    unpacked_model = Generator(replace(cfgs["tuned"], renderer=replace(rcfg, ngp_pack_mb=0)),
                               device="cuda")
    unpacked_model.load_state_dict(model32.state_dict())
    unpacked = SDFaceSampler(unpacked_model, batch=BATCH).sample(seed=1)
    err = (kern - plain).abs().max().item()
    err_pack = (kern - unpacked).abs().max().item()
    results["ngp_serve_f32_max_abs_err"] = err
    check(err <= 2e-3, f"f32 NGP request, kernels vs plain: max abs err {err} <= 2e-3")
    check(err_pack <= 2e-3, f"f32 NGP request, packed vs unpacked: {err_pack} <= 2e-3")
    emit(phase="serve_ngp_compare", f32_kernels_vs_plain_max_abs_err=err,
         f32_packed_vs_unpacked_max_abs_err=err_pack, tolerance=2e-3,
         image_std=kern.std().item())
    del model32, unpacked_model
    torch.cuda.empty_cache()
    results["ngp_images_per_s"] = images_per_s(sampler)
    return model


def time_field(results: dict) -> dict:
    """Kernel and plain-version medians at batch 8, full width."""
    import copy

    import torch

    from sdface_gan_tpu_torch.models.siren import SirenConfig, SirenGenerator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    net32 = SirenGenerator(SirenConfig(depth=DEPTH, width=WIDTH, style_dim=STYLE),
                           generator=torch.Generator().manual_seed(7)).cuda()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        net = copy.deepcopy(net32).to(dtype)
        pts, views, style = field_inputs(net, BATCH, POINTS, 8)
        pack = sk.pack_siren_field(net)
        gamma, beta = sk.film_coeffs(net, style)
        args = (pack, pts, views, gamma, beta)
        ms = cuda_ms(lambda: sk.siren_field_fused_parts(*args), iters=10)
        plain_ms = cuda_ms(lambda: sk.siren_field_reference(*args), iters=5, warmup=1)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        flops = field_flops(DEPTH, WIDTH) * BATCH * POINTS
        name = str(dtype).split(".")[-1]
        out[name] = dict(
            kernel=sk.kernel_name(dtype), design=FIELD_DESIGN[name],
            ms=ms, plain_ms=plain_ms, **bound(flops, field_bytes(pack, BATCH, POINTS), peak),
            tflops_achieved=flops / ms / 1e9)
        # the FiLM-sine epilogue on the FP32 pipes, not overlapped with the products
        evals = BATCH * POINTS * (DEPTH + 1) * WIDTH
        out[name]["sine_epilogue_fp32_ms"] = evals * SINE_INSTRUCTIONS / (PEAK_F32_FLOPS / 2) * 1e3
        del net, pts, views, args, pack
        torch.cuda.empty_cache()
    results["field_timing"] = out
    return out


def request_points(rcfg, seed: int):
    """The normalized sample points [B * P, 3] of one random-camera request,
    computed as ``render`` computes them."""
    import torch

    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.geometry.rays import get_rays
    from sdface_gan_tpu_torch.models.renderer import _sample_z_vals

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cams = generate_camera_params(rcfg.out_im_res, gen, batch=BATCH, device="cuda")
    rays = get_rays(cams.focal, cams.extrinsics, rcfg.out_im_res)
    near = cams.near.reshape(BATCH, 1, 1, 1)
    far = cams.far.reshape(BATCH, 1, 1, 1)
    z = _sample_z_vals(rcfg, near, far, BATCH, gen)
    pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z[..., None]
    return (pts * 2.0 / (far - near)[..., None]).reshape(-1, 3).contiguous()


def packed_indices(x, plan):
    """The packed-row indices [Lp, N] int32 of ``hash_encode_packed``."""
    import torch

    spec = plan.spec
    x01 = ((x + NGP_BOUND) / (2.0 * NGP_BOUND)).clamp(0.0, 1.0)
    rows = []
    for li, lvl in enumerate(plan.packed_levels):
        res = spec.level_resolution(lvl)
        pg = torch.floor(x01 * spec.level_scale(lvl) + 0.5).long()
        rows.append(pg[:, 0] + pg[:, 1] * res + pg[:, 2] * res * res + plan.row_offsets[li])
    return torch.stack(rows).to(torch.int32).contiguous()


def time_ngp_kernels(results: dict, tuned_model) -> dict:
    """Each hash kernel, its plain version and (table_gather) one PyTorch
    call, at batch 8 on a real request's points."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    out = {}
    cfgs = ngp_configs()
    x = request_points(cfgs["tuned"].renderer, seed=21)
    n = x.shape[0]
    enc = tuned_model.renderer.network.encoder
    plan = cfgs["tuned"].renderer.network_config().pack_plan
    packed, table = enc.packed, enc.embeddings.detach()

    idx = packed_indices(x, plan)
    row_bytes = packed.shape[1] * packed.element_size()
    rows_read = torch.unique(idx).numel()
    gather_bytes = idx.numel() * 4 + rows_read * row_bytes + idx.numel() * row_bytes
    out["table_gather"] = dict(
        shape=dict(table=list(packed.shape), dtype=str(packed.dtype), idx=list(idx.shape)),
        ms=device_ms(lambda: hg.table_gather(packed, idx), "table_gather_kernel"),
        call_ms=cuda_ms(lambda: hg.table_gather(packed, idx), iters=20),
        plain_ms=cuda_ms(lambda: hg.table_gather_reference(packed, idx), iters=10),
        library_ms=cuda_ms(lambda: torch.index_select(packed, 0, idx.reshape(-1)), iters=20),
        rows_read=rows_read, **bound(0, gather_bytes, PEAK_F32_FLOPS))

    def encode_case(spec, tab, pts, levels):
        lv = levels or tuple(range(spec.num_levels))
        c, es = spec.level_dim, tab.element_size()
        table_bytes = sum(spec.level_table_size(l) for l in lv) * c * es
        nbytes = pts.numel() * 4 + pts.shape[0] * len(lv) * c * es + table_bytes
        flops = pts.shape[0] * len(lv) * 8 * (2 * c + 2)  # corner weights and sums
        return dict(
            levels=list(lv), dtype=str(tab.dtype).split(".")[-1], points=pts.shape[0],
            ms=device_ms(lambda: hg.hash_encode(pts, tab, spec, NGP_BOUND, levels),
                         "hash_encode_kernel"),
            call_ms=cuda_ms(lambda: hg.hash_encode(pts, tab, spec, NGP_BOUND, levels), iters=20),
            plain_ms=cuda_ms(lambda: hg.hash_encode_reference(pts, tab, spec, NGP_BOUND,
                                                              levels), iters=5, warmup=1),
            **bound(flops, nbytes, PEAK_F32_FLOPS))

    spec = plan.spec
    rest = tuple(l for l in range(spec.num_levels) if l not in plan.packed_levels)
    out["hash_encode"] = encode_case(spec, table, x, rest)  # the served path
    out["hash_encode_tuned_all_levels"] = encode_case(spec, table, x, None)
    up_spec = cfgs["upstream"].renderer.network_config().grid
    g = torch.Generator(device="cuda").manual_seed(22)
    up_table = (torch.rand((up_spec.table_size, up_spec.level_dim), generator=g,
                           device="cuda") * 2e-4 - 1e-4).to(torch.bfloat16)
    out["hash_encode_upstream"] = encode_case(up_spec, up_table, x, None)
    check(n == BATCH * POINTS, "timing at the served batch")
    results["ngp_timing"] = out
    return out


def scatter_pairs(x, spec, g, box: float = NGP_BOUND):
    """The (row [M], value [M, C]) pairs of the table gradient, formed as
    the plain version forms them: what one ``index_add_`` then sums."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    x01f, oob = hg._normalize(x, spec, box)
    n, c = x01f.shape[0], spec.level_dim
    cot = torch.where(oob[:, :, None], 0.0, g.float().reshape(n, spec.num_levels, c))
    corners = hg._corner_offsets(3)
    rows, vals = [], []
    for lvl in range(spec.num_levels):
        idx, w = hg._level_index_weight(x01f, spec, lvl, corners)
        rows.append(idx.reshape(-1))
        vals.append((w[:, :, None] * cot[None, :, lvl, :]).reshape(-1, c))
    return torch.cat(rows), torch.cat(vals)


def grad_kernel_case(spec, dtype, x, kernel: str, need_x: bool, need_table: bool,
                     need_g: bool = False, box: float = NGP_BOUND) -> dict:
    """One K1 or K2 launch at a main-path shape (points in a box of half
    side ``box``): profiler device ms per
    launch, the call's event ms, the plain version's ms, one ``index_add_``
    of the table gradient's pairs (where it computes one), and the bound:
    x, g (and v) read once, the table read once where d x or d g reads it,
    every output written once; f32 operations per (point, level, corner):
    2 for the weight, 2C for the scatter (its product and atomic add), 2C +
    8 for d x's dot and derivatives (K1), 8 + 2C for d g (K2).  ``kernel``
    "jvp" is K2 asked for d g alone with no g (the encode's tangent along
    v): g is neither passed nor read."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    n, lv, c = x.shape[0], spec.num_levels, spec.level_dim
    gen = torch.Generator(device="cuda").manual_seed(41)
    table = (torch.randn((spec.table_size, c), generator=gen, device="cuda")).to(dtype)
    g = torch.randn((n, lv * c), generator=gen, device="cuda").to(dtype)
    v = torch.randn((n, 3), generator=gen, device="cuda")
    es = table.element_size()
    reads_table = need_x if kernel == "backward" else need_g
    if kernel == "jvp":
        g = None
    if kernel == "backward":
        def fn():
            return hg.hash_encode_backward(x, table, g, spec, box, need_x=need_x,
                                           need_table=need_table)

        def plain():
            return hg.hash_encode_backward_reference(x, table, g, spec, box,
                                                     need_x=need_x, need_table=need_table)

        per = 2 + (2 * c if need_table else 0) + (2 * c + 8 if need_x else 0)
        nbytes = 12 * n + n * lv * c * es + (12 * n if need_x else 0)
        name = "hash_encode_backward_kernel"
    else:
        def fn():
            return hg.hash_encode_double_backward(x, table, g, v, spec, box,
                                                  need_table=need_table, need_g=need_g)

        def plain():
            return hg.hash_encode_double_backward_reference(x, table, g, v, spec, box,
                                                            need_table=need_table,
                                                            need_g=need_g)

        per = 8 + (2 * c if need_table else 0) + (2 * c if need_g else 0)
        nbytes = (24 * n + (n * lv * c * es if g is not None else 0)
                  + (n * lv * c * es if need_g else 0))
        name = "hash_encode_double_backward_kernel"
    nbytes += (spec.table_size * c * es if reads_table else 0)
    nbytes += (spec.table_size * c * es if need_table else 0)
    library_ms = None
    if need_table:
        rows, vals = scatter_pairs(x, spec, g, box)
        out = torch.zeros((spec.table_size, c), device="cuda")
        library_ms = cuda_ms(lambda: out.index_add_(0, rows, vals), iters=10)
        del rows, vals, out
    rec = dict(kernel=name, dtype=str(dtype).split(".")[-1], points=n, levels=lv,
               level_dim=c, need_x=need_x, need_table=need_table, need_g=need_g,
               atomics=n * lv * 8 * c if need_table else 0,
               ms=device_ms(fn, name), call_ms=cuda_ms(fn, iters=10),
               plain_ms=cuda_ms(plain, iters=3, warmup=1), library_ms=library_ms,
               **bound(n * lv * 8 * per, nbytes, PEAK_F32_FLOPS))
    del table, g, v
    torch.cuda.empty_cache()
    return rec


# K1 and K2 at the shapes of the NGP stage-A G step, batch 8, on the points of
# a real request: name -> (grid, table dtype, points, kernel, need_x,
# need_table, need_g).  (t) the tuned yaml: a bf16 table, the render's table
# gradient over 786,432 points, the subsampled eikonal's 32,768 points; (u)
# the upstream grid: f32, the full eikonal over 786,432 points (the first
# pass's d x alone, the table gradient alone, both, as the first pass would
# cost without asking the engine, and K2); under eikonal_mode="jvp", K2 as the
# encode's tangent (d g alone, no g) and as the tangent's table gradient (d
# table alone), each once per unit tangent.
GRAD_CASES = {
    "t_render_k1": ("tuned", "bfloat16", "render", "backward", False, True, False),
    "t_eikonal_k1_first_pass": ("tuned", "bfloat16", "eikonal", "backward", True, False, False),
    "t_eikonal_k2": ("tuned", "bfloat16", "eikonal", "double", False, True, True),
    "u_render_k1": ("upstream", "float32", "render", "backward", False, True, False),
    "u_eikonal_k1_first_pass": ("upstream", "float32", "render", "backward", True, False, False),
    "u_k1_both": ("upstream", "float32", "render", "backward", True, True, False),
    "u_eikonal_k2": ("upstream", "float32", "render", "double", False, True, True),
    "u_jvp_k2": ("upstream", "float32", "render", "jvp", False, False, True),
    "u_jvp_table_k2": ("upstream", "float32", "render", "double", False, True, False),
}


def grad_case_points() -> dict:
    """The G step's points: a request's 786,432 render points and the first
    32,768 of them, as the subsampled eikonal's."""
    x = request_points(ngp_configs()["tuned"].renderer, seed=43)
    return {"render": x, "eikonal": x[:BATCH * EIKONAL_SUBSAMPLE].contiguous()}


def time_grad_kernels(results: dict) -> dict:
    """Each case of ``GRAD_CASES`` timed by ``grad_kernel_case``."""
    import torch

    grids, points = grad_grids(), grad_case_points()
    out = {name: grad_kernel_case(grids[grid], getattr(torch, dtype), points[pts], kernel,
                                  need_x, need_table, need_g)
           for name, (grid, dtype, pts, kernel, need_x, need_table, need_g)
           in GRAD_CASES.items()}
    out["u_first_pass_avoided_scatter_ms"] = (out["u_k1_both"]["ms"]
                                              - out["u_eikonal_k1_first_pass"]["ms"])
    results["grad_timing"] = out
    return out


# ---------------------------------------------------------------------------
# Training: SIREN runs no kernel (the fused field has no backward); NGP runs
# the encode's forward, backward and double backward kernels
# ---------------------------------------------------------------------------

# (loss rel, gradient rel) of the card against the CPU: |l_cuda - l_cpu| <= a |l_cpu|,
# ||g_cuda - g_cpu|| <= b ||g_cpu|| + 1e-6 for every parameter, under
# ``masked_parity``'s rule.  The path step's bar was once (1e-3, 2e-2), its 3.6e-4
# and 5.1e-3 (H100) put down to cuDNN's FFT convs; with the card's leaky-ReLU masks
# replayed they fell to 8e-8 and 2.9e-6 (4 units flipped): the kinks, not the convs.
TRAIN_TOLERANCES = {"stage_a_g": (1e-4, 1e-3), "stage_a_g_jvp": (1e-4, 1e-3),
                    "stage_a_d_r1": (1e-4, 1e-3),
                    "stage_b_d_r1": (1e-4, 1e-3), "stage_b_path": (1e-4, 1e-3)}
EIKONAL_FD_RTOL = 1e-3  # f32 eikonal on the card vs f64 central differences, of max |grad|
# settings (a) reference parity, (b) TPU-tuned, and (a) with remat off
STAGE_A_BATCH = {"a": 8, "b": 8, "a_no_remat": 8}
# the NGP generator's settings: (t) ffhq_256_sdf_ngp_tpu.yaml, (u) ffhq_256_sdf_ngp.yaml
NGP_SETTINGS = ("t", "u")
HASH_KERNELS = ("hash_encode", "hash_encode_backward", "hash_encode_double_backward")


def fake_loader(img_res: int, thumb_res: int, batch: int, seed: int = 0):
    """(img, thumb) batches in [-1, 1] from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    while True:
        yield (rng.uniform(-1, 1, (batch, img_res, img_res, 3)).astype(np.float32),
               rng.uniform(-1, 1, (batch, thumb_res, thumb_res, 3)).astype(np.float32))


def _param_grads(loss, module, params=None) -> dict:
    """The gradient of ``loss`` for every parameter of ``module`` (those
    whose name starts with ``params``), on the CPU; zeros where unused."""
    import torch

    named = [(n, p) for n, p in module.named_parameters()
             if params is None or n.startswith(params)]
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: (torch.zeros(p.shape) if g is None else g.detach().cpu().float())
            for (n, p), g in zip(named, grads)}


def _grad_errors(gc: dict, gh: dict) -> dict:
    """Per-parameter (||g_cuda - g_cpu||, ||g_cpu||)."""
    return {n: ((gc[n] - gh[n]).norm().item(), gh[n].norm().item()) for n in gh}


def _worst(errs: dict) -> tuple:
    worst = max(errs, key=lambda n: errs[n][0] / (errs[n][1] + 1e-30))
    return worst, errs[worst][0] / (errs[worst][1] + 1e-30)


def train_parity() -> dict:
    """One stage-A G step (eikonal, reverse mode, and again in forward mode:
    ``eikonal_mode="jvp"``), one stage-A D step (R1), one stage-B
    regularized D step and one path step, each as loss + gradients on the
    card and on the CPU from the same weights and inputs, f32, no jitter:
    batch 2, out_im_res 16, 24 samples, depth 3, width 64, style 64,
    decoder and D at 64^2 (channel base 128); held by ``masked_parity``'s
    rule."""
    import copy

    import torch

    from sdface_gan_tpu_torch.geometry import CameraParams, generate_camera_params
    from sdface_gan_tpu_torch.models import (
        Generator,
        GeneratorConfig,
        RendererConfig,
        StyleDiscConfig,
        StyleDiscriminator,
        VolumeRenderDiscConfig,
        VolumeRenderDiscriminator,
    )
    from sdface_gan_tpu_torch.training import steps

    style, res, batch = 64, 16, 2
    rkw = dict(type="sdf", out_im_res=res, n_samples=SAMPLES, style_dim=style, width=64,
               depth=3, force_background=False)
    cfg_a = GeneratorConfig(size=64, style_dim=style, full_pipeline=False,
                            renderer=RendererConfig(output_features=False, return_sdf=True,
                                                    **rkw))
    cfg_a_jvp = dataclasses.replace(cfg_a, renderer=dataclasses.replace(
        cfg_a.renderer, eikonal_mode="jvp"))
    cfg_b = GeneratorConfig(size=64, style_dim=style, full_pipeline=True, freeze_renderer=True,
                            channel_base=128, renderer=RendererConfig(**rkw))
    vcfg = VolumeRenderDiscConfig(in_res=res)
    scfg = StyleDiscConfig(size=64, channel_multiplier=2, channel_base=128)
    hp = steps.TrainHParams(batch=batch, style_dim=style)
    seed = torch.Generator().manual_seed
    models = {"cpu": dict(ga=Generator(cfg_a, "cpu", seed(1)), gb=Generator(cfg_b, "cpu", seed(2)),
                          va=VolumeRenderDiscriminator(vcfg, seed(3)),
                          sb=StyleDiscriminator(scfg, seed(4)))}
    models["cuda"] = {k: copy.deepcopy(m).cuda() for k, m in models["cpu"].items()}
    gen = seed(5)
    z, z2 = torch.randn((batch, style), generator=gen), torch.randn((batch, style), generator=gen)
    cams = generate_camera_params(res, gen, batch=batch, device="cpu")
    thumbs = torch.rand((batch, res, res, 3), generator=gen) * 2 - 1
    imgs = torch.rand((batch, 64, 64, 3), generator=gen) * 2 - 1
    noise = torch.randn((batch, 64, 64, 3), generator=gen) / 64.0
    mean0 = torch.tensor(0.0)  # (pl - mean)^2 with mean ~ pl would amplify rounding

    def inputs(dev):
        to = lambda t: t.to(dev)  # noqa: E731
        c = CameraParams(*map(to, cams))
        return to, steps.StepInputs(to(z), c), steps.StepInputs(to(z), c, to(z2), 3,
                                                                path_noise=to(noise))

    def stage_a_g(dev, cfg=cfg_a):
        m, (to, a_in, _) = models[dev], inputs(dev)
        return steps.stage_a_g_loss(m["ga"], m["va"], cfg, vcfg, hp, a_in)[0], m["ga"], None

    def stage_a_d_r1(dev):
        m, (to, a_in, _) = models[dev], inputs(dev)
        return (steps.stage_a_d_loss(m["ga"], m["va"], cfg_a, vcfg, hp, to(thumbs), a_in)[0],
                m["va"], None)

    def stage_b_d_r1(dev):
        m, (to, _, b_in) = models[dev], inputs(dev)
        return (steps.stage_b_d_loss(m["gb"], m["sb"], cfg_b, scfg, hp, to(imgs), b_in,
                                     regularize=True)[0], m["sb"], None)

    def stage_b_path(dev):
        m, (to, _, b_in) = models[dev], inputs(dev)
        return (steps.stage_b_path_loss(m["gb"], cfg_b, hp, b_in, to(mean0))[0], m["gb"],
                "decoder.")

    with torch.enable_grad():
        out = masked_parity("train_parity",
                            {"stage_a_g": stage_a_g,
                             "stage_a_g_jvp": functools.partial(stage_a_g, cfg=cfg_a_jvp),
                             "stage_a_d_r1": stage_a_d_r1,
                             "stage_b_d_r1": stage_b_d_r1, "stage_b_path": stage_b_path},
                            TRAIN_TOLERANCES)
    emit(phase="train_parity", tolerances=TRAIN_TOLERANCES, **out)
    return out


def eikonal_fd_check(n: int = 64) -> dict:
    """The port's subsampled eikonal term on the card (f32, full width) at n
    frustum points against central differences of an f64 copy of the
    field's SDF (h = 1e-7), and the f64 copy's own autograd term too (<= 1e-4
    of the largest component: a wrong derivative is off by O(1); a step of
    1e-6 already crosses the polynomial sine's range-reduction seams, whose
    ~1e-7 jumps then show as 1e-5 of it)."""
    import copy

    import torch

    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.models import RendererConfig, VolumeFeatureRenderer
    from sdface_gan_tpu_torch.models.renderer import _subsampled_eikonal, frustum_points

    cfg = RendererConfig(type="sdf", out_im_res=RES, n_samples=SAMPLES, style_dim=STYLE,
                         width=WIDTH, depth=DEPTH, output_features=False, eikonal_subsample=n,
                         remat=False)
    rend = VolumeFeatureRenderer(cfg, generator=torch.Generator().manual_seed(6)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    cams = generate_camera_params(RES, gen, batch=1, device="cuda")
    style = torch.randn((1, STYLE), generator=gen, device="cuda")
    u_uv = torch.rand((1, n, 2), generator=gen, device="cuda")
    u_t = torch.rand((1, n), generator=gen, device="cuda")
    near, far = cams.near.reshape(1, 1, 1, 1), cams.far.reshape(1, 1, 1, 1)
    with torch.enable_grad():
        eik = _subsampled_eikonal(rend, cfg, cams.focal, cams.extrinsics, near, far, style,
                                  draws=(u_uv, u_t)).detach().double()
    net64 = copy.deepcopy(rend.network).double()
    d = lambda t: t.double()  # noqa: E731
    pts = frustum_points(RES, d(cams.focal), d(cams.extrinsics), d(near), d(far), d(u_uv),
                         d(u_t))
    scale = 2.0 / (d(far) - d(near)).reshape(1, 1, 1)
    zeros = torch.zeros_like(pts)

    def sdf(p):
        return net64.forward_parts(p * scale, zeros, d(style))[1][..., 0]

    h = 1e-7
    fd = torch.stack([(sdf(pts + h * e) - sdf(pts - h * e)) / (2 * h)
                      for e in torch.eye(3, dtype=torch.float64, device="cuda")], -1)
    with torch.enable_grad():
        p = pts.clone().requires_grad_(True)
        (auto64,) = torch.autograd.grad(sdf(p).sum(), p)
    scale_fd = fd.abs().max().item()
    err32 = (eik - fd).abs().max().item()
    err64 = (auto64 - fd).abs().max().item()
    rec = dict(points=n, width=WIDTH, depth=DEPTH, fd_step=h, max_abs_grad=scale_fd,
               f32_card_vs_fd_max_abs_err=err32, f64_autograd_vs_fd_max_abs_err=err64,
               tolerance=f"{EIKONAL_FD_RTOL} x max |grad|",
               mean_grad_norm=fd.norm(dim=-1).mean().item())
    check(err32 <= EIKONAL_FD_RTOL * scale_fd, f"eikonal f32 vs finite differences: {err32}")
    check(err64 <= 1e-4 * scale_fd, f"eikonal f64 autograd vs finite differences: {err64}")
    return rec


def _train_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _finite_losses(rows: list, what: str) -> None:
    import math

    for r in rows:
        for k, v in r.items():
            check(math.isfinite(v), f"{what}: {k} at step {r['step']} is finite")


def stage_a_setting(setting: str) -> tuple:
    """(generator config, hyperparameters) of a stage-A setting at batch 8:
    the flagship's (a), (b) and (a) without remat; the NGP generator's (t)
    and (u)."""
    from sdface_gan_tpu_torch import configs

    if setting == "t":
        return configs.ffhq_256_sdf_ngp_tpu(stage_a=True), configs.train_hparams(
            tpu=True, ngp=True, batch=BATCH)
    if setting == "u":
        return configs.ffhq_256_sdf_ngp(stage_a=True), configs.train_hparams(ngp=True,
                                                                             batch=BATCH)
    tpu = setting == "b"
    gcfg = configs.ffhq_256_sdf_tpu(stage_a=True) if tpu else configs.ffhq_256_sdf(stage_a=True)
    if setting == "a_no_remat":
        gcfg = dataclasses.replace(gcfg, renderer=dataclasses.replace(gcfg.renderer, remat=False))
    return gcfg, configs.train_hparams(tpu=tpu, batch=STAGE_A_BATCH[setting])


@contextlib.contextmanager
def plain_encodes_on_card():
    """Count the calls of the plain encode on CUDA tensors while the block
    runs (the list of their point counts); the card's main path makes none."""
    from sdface_gan_tpu_torch.models import siren
    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    calls = []
    originals = {module: module.hash_encode_reference for module in (hg, siren)}

    def counted(original):
        def fn(x, *args, **kwargs):
            if x.is_cuda:
                calls.append(x.numel() // 3)
            return original(x, *args, **kwargs)
        return fn

    for module, original in originals.items():
        module.hash_encode_reference = counted(original)
    try:
        yield calls
    finally:
        for module, original in originals.items():
            module.hash_encode_reference = original


def run_stage_a(setting: str, out_dir: str) -> dict:
    """2 sphere-init steps, then 3 stage-A iterations at full width through
    ``train_volume_renderer``; the launch counts of the run, and, for the
    NGP settings, the plain encode's calls on the card (none)."""
    import torch

    from sdface_gan_tpu_torch import configs
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.training import train_volume_renderer

    gcfg, hp = stage_a_setting(setting)
    vcfg, _ = configs.discriminator_configs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.enable_grad(), plain_encodes_on_card() as plain_calls:
        train_volume_renderer(fake_loader(gcfg.size, gcfg.renderer.out_im_res, hp.batch),
                              gcfg, vcfg, hp, out_dir,
                              iters=3, sphere_init_iters=2, save_every=0, sample_every=0,
                              log_every=1, device="cuda")
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_ext.LAUNCHES)
    rows = _train_rows(os.path.join(out_dir, "vol_render_metrics.jsonl"))
    _finite_losses(rows, f"stage A ({setting})")
    adv = [r for r in rows if "g" in r]
    check(len(adv) == 3, "3 stage-A iterations logged")
    for r in rows:
        emit(phase="train", run=f"stage_a_{setting}", **r)
    check(launches["siren_field"] == 0, "no siren_field launch in training")
    if setting in NGP_SETTINGS:
        check(all("g_smooth" in r for r in adv), f"stage A ({setting}) logs g_smooth")
        for name in HASH_KERNELS:
            check(launches[name] > 0, f"stage A ({setting}): {name} launched")
        check(not plain_calls, f"stage A ({setting}): no plain encode on the card "
              f"({len(plain_calls)} calls)")
    rec = dict(setting=setting, batch=hp.batch, g_param_dtype=hp.g_param_dtype,
               eikonal_subsample=gcfg.renderer.eikonal_subsample, remat=gcfg.renderer.remat,
               d_ms=statistics.median(r["d_ms"] for r in adv[1:]),
               g_ms=statistics.median(r["g_ms"] for r in adv[1:]),
               first_iteration_ms=adv[0]["d_ms"] + adv[0]["g_ms"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, seconds=seconds,
               launches=launches, plain_encodes_on_card=len(plain_calls))
    return rec


def run_stage_b(vol_dir: str, out_dir: str, setting: str = "a") -> dict:
    """3 stage-B iterations at 256^2 from stage A's ``vol_renderer``: the
    flagship in f32 (setting a) or the tuned NGP yaml (t, bf16 G);
    iteration 0 takes the regularized D and the path step.  Then the warm
    regularized D and path steps timed on the trained models."""
    import torch

    from sdface_gan_tpu_torch import configs
    from sdface_gan_tpu_torch.models import Generator, StyleDiscriminator
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.training import (
        stage_b_optimizers,
        train_full_pipeline,
    )
    from sdface_gan_tpu_torch.training.loop import _generator
    from sdface_gan_tpu_torch.training.steps import (
        sample_inputs,
        stage_b_d_step,
        stage_b_path_step,
    )
    from sdface_gan_tpu_torch.utils.checkpoints import load_checkpoint

    if setting == "t":
        gcfg = configs.ffhq_256_sdf_ngp_tpu(stage_a=False)
        hp = configs.train_hparams(tpu=True, ngp=True, batch=BATCH)
    else:
        gcfg = configs.ffhq_256_sdf(stage_a=False)
        hp = configs.train_hparams(batch=BATCH)
    _, scfg = configs.discriminator_configs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    with torch.enable_grad(), plain_encodes_on_card() as plain_calls:
        train_full_pipeline(fake_loader(gcfg.size, gcfg.renderer.out_im_res, hp.batch),
                            gcfg, scfg, hp, out_dir,
                            vol_renderer_dir=vol_dir, iters=3, save_every=0, sample_every=0,
                            log_every=1, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows = _train_rows(os.path.join(out_dir, "full_pipeline_metrics.jsonl"))
    _finite_losses(rows, "stage B")
    check([r["step"] for r in rows] == [0, 1, 2], "3 stage-B iterations logged")
    check("r1" in rows[0] and "path" in rows[0], "iteration 0: regularized D and path step")
    for r in rows:
        emit(phase="train", run=f"stage_b_{setting}", **r)
    launches = dict(_ext.LAUNCHES)
    if setting in NGP_SETTINGS:  # the frozen renderer encodes without autograd
        check(launches["hash_encode"] > 0 and not plain_calls,
              "stage B (t): hash_encode launched, no plain encode on the card")

    ck = load_checkpoint(out_dir, "full_pipeline", map_location="cuda")
    g = Generator(gcfg, device="cuda")
    g.load_state_dict(ck["g"])
    d = StyleDiscriminator(scfg).cuda()
    d.load_state_dict(ck["d"])
    g_opt, d_opt = stage_b_optimizers(g, d)
    real = torch.rand((hp.batch, gcfg.size, gcfg.size, 3), device="cuda") * 2 - 1
    dev = torch.device("cuda")
    res, n_latent = gcfg.renderer.out_im_res, gcfg.decoder.n_latent
    mean = torch.zeros((), device="cuda")
    with torch.enable_grad():
        d_in = sample_inputs(hp, res, hp.batch, _generator(dev, 0, "smoke", "d"), n_latent)
        p_in = sample_inputs(hp, res, hp.batch // hp.path_batch_shrink,
                             _generator(dev, 0, "smoke", "p"), n_latent)
        reg_d_ms = cuda_ms(lambda: stage_b_d_step(g, d, d_opt, gcfg, scfg, hp, real, d_in,
                                                  regularize=True), iters=3, warmup=1)
        path_ms = cuda_ms(lambda: stage_b_path_step(g, g_opt, gcfg, hp, p_in, mean),
                          iters=3, warmup=1)
    check(_ext.LAUNCHES["siren_field"] == 0, "no siren_field launch in training")
    return dict(setting=setting, batch=hp.batch, path_batch=hp.batch // hp.path_batch_shrink,
                d_ms=statistics.median(r["d_ms"] for r in rows[1:]),
                g_ms=statistics.median(r["g_ms"] for r in rows[1:]),
                first_iteration=dict(reg_d_ms=rows[0]["d_ms"], g_ms=rows[0]["g_ms"],
                                     path_ms=rows[0]["path_ms"]),
                warm_reg_d_ms=reg_d_ms, warm_path_ms=path_ms, peak_memory_gb=peak,
                launches=launches, plain_encodes_on_card=len(plain_calls))


HASH_KERNEL_ROWS = {"hash_encode": "hash_encode_kernel",
                    "hash_encode_backward": "hash_encode_backward_kernel",
                    "hash_encode_double_backward": "hash_encode_double_backward_kernel"}


def profile_train_step(vol_dir: str, setting: str = "a", jvp: bool = False) -> dict:
    """One stage-A G step and one D step of a setting, warm: the launches of
    each (counted), then each profiled: the top device operations, the
    hash kernels' device ms, and no siren_field row in either.  With
    ``jvp``, the G step again under ``eikonal_mode="jvp"`` on the same
    model (:func:`jvp_g_step`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdface_gan_tpu_torch import configs
    from sdface_gan_tpu_torch.models import Generator, VolumeRenderDiscriminator
    from sdface_gan_tpu_torch.training import stage_a_optimizers
    from sdface_gan_tpu_torch.training.loop import _frozen_copy, _generator
    from sdface_gan_tpu_torch.training.steps import sample_inputs, stage_a_d_step, stage_a_g_step
    from sdface_gan_tpu_torch.utils.checkpoints import load_checkpoint

    from sdface_gan_tpu_torch.ops import _ext

    gcfg, hp = stage_a_setting(setting)
    vcfg, _ = configs.discriminator_configs()
    ck = load_checkpoint(vol_dir, "vol_renderer", map_location="cuda")
    g = Generator(gcfg, device="cuda")
    g.load_state_dict(ck["g"])
    d = VolumeRenderDiscriminator(vcfg).cuda()
    d.load_state_dict(ck["d"])
    g_ema = _frozen_copy(g)
    g_opt, d_opt = stage_a_optimizers(g, d)
    dev = torch.device("cuda")
    res = gcfg.renderer.out_im_res
    real = torch.rand((hp.batch, res, res, 3), device="cuda") * 2 - 1
    inputs = sample_inputs(hp, res, hp.batch, _generator(dev, 0, "profile"))

    def g_step():
        stage_a_g_step(g, d, g_opt, g_ema, gcfg, vcfg, hp, inputs)

    def d_step():
        stage_a_d_step(g, d, d_opt, gcfg, vcfg, hp, real, inputs)

    out = {}
    with torch.enable_grad():
        g_step()
        d_step()
        torch.cuda.synchronize()
        for name, fn in (("g_step", g_step), ("d_step", d_step)):
            _ext.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            launches = {k: v for k, v in _ext.LAUNCHES.items() if v}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
            dev_us = {}
            for ev in prof.key_averages():
                if ev.device_type == DeviceType.CUDA:
                    us = getattr(ev, "device_time_total", None)
                    dev_us[ev.key] = (us if us is not None else ev.cuda_time_total, ev.count)
            check(bool(dev_us), f"the {name} profile holds device events")
            check(not any("siren_field" in k for k in dev_us), f"no siren_field row in {name}")
            total = sum(us for us, _ in dev_us.values())
            top = sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:15]
            kernel_ms = {k: sum(us for key, (us, _) in dev_us.items() if row in key) / 1e3
                         for k, row in HASH_KERNEL_ROWS.items()}
            out[name] = dict(host_ms=host_ms, device_ms_total=total / 1e3,
                             device_idle_share=1 - total / 1e3 / host_ms,
                             kernels=len(dev_us), launches=launches,
                             hash_kernel_device_ms=kernel_ms,
                             top=[(k[:100], us / 1e3, n) for k, (us, n) in top])
    if jvp:
        gcfg_jvp = dataclasses.replace(gcfg, renderer=dataclasses.replace(
            gcfg.renderer, eikonal_mode="jvp"))
        out["g_step_jvp"] = jvp_g_step(
            lambda: stage_a_g_step(g, d, g_opt, g_ema, gcfg_jvp, vcfg, hp, inputs), setting)
    return out


JVP_STEP_ITERS = 3


def jvp_g_step(fn, setting: str) -> dict:
    """The NGP stage-A G step under the forward-mode eikonal, on a model
    the vjp step has warmed: its peak memory over its first call, its ms
    (events, the median of ``JVP_STEP_ITERS`` warm calls), then counted and
    profiled (``profiled``): K2
    launched in both of its forward-mode roles (``hash_encode_jvp``, the
    encode's tangent, three per unit-tangent pass and three more in the
    remat's recomputation; ``hash_encode_double_backward``, the tangents'
    table gradients) and seen by name, no plain encode on a CUDA tensor."""
    import torch

    with torch.enable_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        ms = cuda_ms(fn, iters=JVP_STEP_ITERS, warmup=0)
        launches, names, plain = profiled(fn, ("hash_encode_double_backward_kernel",))
    launches = {k: v for k, v in launches.items() if v}
    k2 = [(k, us / 1e3, n) for k, (us, n) in names.items()
          if HASH_KERNEL_ROWS["hash_encode_double_backward"] in k]
    check(launches.get("hash_encode_jvp", 0) > 0
          and launches.get("hash_encode_double_backward", 0) > 0,
          f"jvp G step ({setting}): K2 launched as the tangent and its table gradient "
          f"({launches})")
    check(bool(k2), f"jvp G step ({setting}): K2 by name in the profile")
    check(not plain, f"jvp G step ({setting}): no plain encode on the card ({plain})")
    return dict(ms=ms, peak_memory_gb=peak, launches=launches, k2_rows=k2,
                device_ms_total=sum(us for us, _ in names.values()) / 1e3)


def train(results: dict) -> None:
    """The training phase: parity on the card, the eikonal check, stage A
    under settings (a) and (b), stage B, the profile."""
    import tempfile

    parity = train_parity()
    eik = eikonal_fd_check()
    emit(phase="train_eikonal_check", **eik)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_train_") as td:
        stage_a = {s: run_stage_a(s, os.path.join(td, f"stage_a_{s}")) for s in STAGE_A_BATCH}
        for s, rec in stage_a.items():
            emit(phase="train_stage_a", **rec)
        stage_b = run_stage_b(os.path.join(td, "stage_a_a"), os.path.join(td, "stage_b"))
        emit(phase="train_stage_b", **stage_b)
        prof = profile_train_step(os.path.join(td, "stage_a_a"))
        emit(phase="train_profile", setting="a", **prof)
    results["train"] = dict(parity=parity, eikonal=eik, stage_a=stage_a, stage_b=stage_b,
                            profile=prof)


def masked_parity(phase: str, steps: dict, tolerances: dict) -> dict:
    """The rule both training parities share.  ``steps``: name -> fn(dev)
    -> (loss, module, parameter prefix | None), one step from the same
    weights and inputs on either device.  Each step runs on the card,
    recording the leaky-ReLU masks, and twice on the CPU: with its own
    masks, and replaying the card's (``leaky_relu_masks``).  A
    pre-activation within rounding of 0 may take the other slope on one
    side, which moves a gradient by ~1e-3 of its norm (one unit of 1.48 M
    did, in an NGP D step), and either slope is the gradient's value at the
    kink.  So a step's loss and gradients are held to ``tolerances`` with
    the CPU's own masks; where a unit of that step flipped, with the card's
    masks instead.  Flipped units stay under 1e-5 of the phase's units.
    Both errors are reported: a flip moves only the own-mask one, a kernel
    defect both."""
    import torch
    from torch_masks import leaky_relu_masks

    out, flipped, units = {}, 0, 0
    for name, step in steps.items():
        loss_tol, grad_tol = tolerances[name]
        masks, flips = [], {}
        with leaky_relu_masks(record=masks):
            lc, mc, prefix = step("cuda")
        lh, mh, _ = step("cpu")
        with leaky_relu_masks(replay=masks, flips=flips):
            lr, mr, _ = step("cpu")
        check(not masks, f"{phase} {name}: every recorded mask was replayed")
        gc = _param_grads(lc, mc, prefix)
        own = _grad_errors(gc, _param_grads(lh, mh, prefix))
        replayed = _grad_errors(gc, _param_grads(lr, mr, prefix))
        rel = {k: abs(lc.item() - l.item()) / max(abs(l.item()), 1e-30)
               for k, l in (("own", lh), ("replayed", lr))}
        held = "replayed" if flips["flipped"] else "own"
        worst, worst_rel = _worst(own)
        worst_r, worst_rel_r = _worst(replayed)
        rec = dict(loss_cuda=lc.item(), loss_cpu=lh.item(), loss_rel_err=rel["own"],
                   params=len(own), worst_param=worst, worst_grad_rel_err=worst_rel,
                   leaky_relu_flips=dict(flips), held_with=held,
                   replayed_loss_rel_err=rel["replayed"], replayed_worst_param=worst_r,
                   replayed_worst_grad_rel_err=worst_rel_r)
        emb = "renderer.network.encoder.embeddings"
        if emb in own:
            rec["hash_table_grad_rel_err"] = own[emb][0] / (own[emb][1] + 1e-30)
            rec["replayed_hash_table_grad_rel_err"] = replayed[emb][0] / (replayed[emb][1]
                                                                          + 1e-30)
        out[name] = rec
        errs = replayed if held == "replayed" else own
        check(rel[held] <= loss_tol,
              f"{phase} {name}: loss cuda vs cpu ({held} masks) rel {rel[held]} <= {loss_tol}")
        for n, (e, sc) in errs.items():
            check(e <= grad_tol * sc + 1e-6,
                  f"{phase} {name}: grad {n} cuda vs cpu ({held} masks) {e} vs {sc}")
        flipped, units = flipped + flips["flipped"], units + flips["units"]
    check(units > 0 and flipped <= 1e-5 * units,
          f"{phase}: leaky-ReLU units flipped {flipped} of {units}")
    return out


def ngp_train_parity() -> dict:
    """One NGP stage-A G step under the full eikonal with remat (K1 and K2
    inside the checkpoint), one under the subsampled eikonal and one under
    the full eikonal in forward mode with remat (K2 as the encode's tangent
    inside the checkpoint, and as its table gradient), and one D
    step with R1, as loss + every gradient (the hash table's included) on
    the card and on the CPU from the same weights and draws, f32, no
    jitter: batch 2, out_im_res 16, 24 samples, width = style 64, the tuned
    grid (4 x 8, T = 2^15, finest 256) with a std-0.3 table.  Every logged
    loss finite, g_smooth among them.  Held by ``masked_parity``'s rule, as
    ``train_parity`` is."""
    import copy
    import math

    import torch

    from sdface_gan_tpu_torch.geometry import CameraParams, generate_camera_params
    from sdface_gan_tpu_torch.models import (
        Generator,
        GeneratorConfig,
        RendererConfig,
        VolumeRenderDiscConfig,
        VolumeRenderDiscriminator,
    )
    from sdface_gan_tpu_torch.training import steps

    style, res, batch, m = 64, 16, 2, 256
    rkw = dict(type="ngp", out_im_res=res, n_samples=SAMPLES, style_dim=style, width=style,
               ngp_num_levels=4, ngp_level_dim=8, ngp_finest_res=256,
               ngp_log2_hashmap_size=15, force_background=False, output_features=False,
               return_sdf=True)
    cfgs = {"g_full_remat": dict(remat=True), "g_subsampled": dict(remat=False,
                                                                   eikonal_subsample=m),
            "g_jvp_remat": dict(remat=True, eikonal_mode="jvp")}
    cfgs = {k: GeneratorConfig(size=64, style_dim=style, full_pipeline=False,
                               renderer=RendererConfig(**rkw, **v)) for k, v in cfgs.items()}
    vcfg = VolumeRenderDiscConfig(in_res=res)
    hp = steps.TrainHParams(batch=batch, style_dim=style)
    seed = torch.Generator().manual_seed
    g_cpu = Generator(cfgs["g_full_remat"], "cpu", seed(1))
    with torch.no_grad():
        emb = g_cpu.renderer.network.encoder.embeddings
        emb.copy_(0.3 * torch.randn(emb.shape, generator=seed(2)))
    models = {"cpu": dict(g=g_cpu, d=VolumeRenderDiscriminator(vcfg, seed(3)))}
    models["cuda"] = {k: copy.deepcopy(v).cuda() for k, v in models["cpu"].items()}
    gen = seed(5)
    z = torch.randn((batch, style), generator=gen)
    cams = generate_camera_params(res, gen, batch=batch, device="cpu")
    thumbs = torch.rand((batch, res, res, 3), generator=gen) * 2 - 1
    eik_draws = (torch.rand((batch, m, 2), generator=gen), torch.rand((batch, m), generator=gen))
    smooth_draws = (torch.rand(3, generator=gen), torch.rand(3, generator=gen))

    metrics = {}

    def run(name, dev):
        mm = models[dev]
        to = lambda t: t.to(dev)  # noqa: E731
        inputs = steps.StepInputs(to(z), CameraParams(*map(to, cams)),
                                  eikonal_draws=tuple(map(to, eik_draws)),
                                  smooth_draws=tuple(map(to, smooth_draws)))
        if name == "d_r1":
            loss, logged = steps.stage_a_d_loss(mm["g"], mm["d"], cfgs["g_full_remat"], vcfg,
                                                hp, to(thumbs), inputs)
        else:
            loss, logged = steps.stage_a_g_loss(mm["g"], mm["d"], cfgs[name], vcfg, hp, inputs)
        if dev == "cuda":
            metrics[name] = {k: v.item() for k, v in logged.items()}
        return loss, mm["d" if name == "d_r1" else "g"], None

    from sdface_gan_tpu_torch.ops import _ext

    with torch.enable_grad(), plain_encodes_on_card() as plain_calls:
        _ext.reset_launch_counts()
        out = masked_parity("train_ngp_parity",
                            {k: functools.partial(run, k) for k in (*cfgs, "d_r1")},
                            {k: TRAIN_TOLERANCES["stage_a_g"] for k in (*cfgs, "d_r1")})
        launches = dict(_ext.LAUNCHES)  # the CPU's steps launch nothing
    for name, rec in out.items():
        rec["metrics"] = metrics[name]
        for k, v in metrics[name].items():
            check(math.isfinite(v), f"ngp {name}: {k} finite on the card")
    emit(phase="train_ngp_parity", tolerances=list(TRAIN_TOLERANCES["stage_a_g"]),
         launches=launches, plain_encodes_on_card=len(plain_calls), **out)
    check("g_smooth" in metrics["g_full_remat"], "g_smooth logged")
    check(not plain_calls, "no plain encode on the card in the parity steps")
    for name in HASH_KERNELS + ("hash_encode_jvp",):
        check(launches[name] > 0, f"the parity steps launched {name}")
    return dict(out, launches=launches)


def train_ngp(results: dict) -> None:
    """NGP training at batch 8, nothing cut: parity on the card, stage A
    under (t) and (u), stage B under (t) from (t)'s ``vol_renderer``, and
    one warm G and D step of each setting counted and profiled; (u)'s G
    step also under the forward-mode eikonal (the full eikonal's setting:
    (t) subsamples, which ignores the mode)."""
    import tempfile

    parity = ngp_train_parity()
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_train_") as td:
        stage_a, prof = {}, {}
        for s in NGP_SETTINGS:
            stage_a[s] = run_stage_a(s, os.path.join(td, f"stage_a_{s}"))
            emit(phase="train_ngp_stage_a", **stage_a[s])
            prof[s] = profile_train_step(os.path.join(td, f"stage_a_{s}"), setting=s,
                                         jvp=s == "u")
            emit(phase="train_ngp_profile", setting=s, **prof[s])
        stage_b = run_stage_b(os.path.join(td, "stage_a_t"), os.path.join(td, "stage_b_t"),
                              setting="t")
        emit(phase="train_ngp_stage_b", **stage_b)
    results["train_ngp"] = dict(parity=parity, stage_a=stage_a, stage_b=stage_b, profile=prof)


# The train_cli phase: 16 procedural 320 x 288 images (the crop is exercised),
# the flagship's TPU-tuned settings from the command line at batch 8.
CLI_IMAGES, CLI_HW, CLI_SIZE, CLI_THUMB, CLI_BATCH = 16, (288, 320), 256, 64, 8
CLI_CONFIG, CLI_EXP = "configs/256res/ffhq_256_sdf_tpu.yaml", "ffhq256_sdf_tpu"
CLI_NGP_CONFIG, CLI_NGP_EXP = "configs/256res/ffhq_256_sdf_ngp_tpu.yaml", "ffhq256_sdf_ngp_tpu"
CLI_TRAIN_FLAGS = ("--batch", str(CLI_BATCH), "--sphere_init_iters", "2", "--log_every", "1",
                   "--save_every", "1000", "--sample_every", "1000")
CLI_TIMEOUT_S = 420
CLI_CUT_BATCH = 2  # the --exit-after flow's batch (the stage flow is what it checks)


def procedural_images(n: int, hw: tuple, seed: int) -> list:
    """``n`` uint8 RGB images: smooth sinusoid fields plus Gaussian noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]] / max(hw)
    out = []
    for _ in range(n):
        f = rng.uniform(1, 6, (3, 2))
        phase = rng.uniform(0, 2 * np.pi, 3)
        smooth = np.stack([np.sin(2 * np.pi * (f[c, 0] * xx + f[c, 1] * yy) + phase[c])
                           for c in range(3)], -1)
        img = 127.5 + 100 * smooth + rng.normal(0, 8, smooth.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def run_module(module: str, args: list, cwd: str, expect_rc: int = 0) -> dict:
    """``python -m sdface_gan_tpu_torch.<module> <args>`` in ``cwd`` with the
    checkout on the path; its exit code must be ``expect_rc``."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"sdface_gan_tpu_torch.{module}", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == expect_rc,
          f"{module} {' '.join(args)} exited {proc.returncode}, expected {expect_rc}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return dict(rc=proc.returncode, seconds=seconds, stdout=proc.stdout)


def _tree_mtimes(root: str) -> dict:
    return {os.path.join(d, n): os.stat(os.path.join(d, n)).st_mtime_ns
            for d, _, names in os.walk(root) for n in names}


def _step_medians(rows: list) -> dict:
    """D and G medians after the first (warm-up) iteration."""
    adv = [r for r in rows if "g" in r][1:]
    return dict(d_ms=statistics.median(r["d_ms"] for r in adv),
                g_ms=statistics.median(r["g_ms"] for r in adv))


def prepare(td: str) -> dict:
    """Host-only preparation in ``td``, on a thread beside the kernels' build
    (the card idles then): the native library (g++), train_cli's images
    (16 procedural 320 x 288 PNGs and the committed image fixtures), then
    at once train_cli's store (``prepare_data --size 256``), evaluate's 48
    procedural 256^2 heads (``data.synthetic``) and the 512^2 phase's heads
    and their 64 + 512 store (``data.synthetic --res 512``, ``prepare_data
    --size 64,512``)."""
    from sdface_gan_tpu_torch import native
    from sdface_gan_tpu_torch.data.png import encode_png

    fresh = not native.library_path().exists()
    t0 = time.perf_counter()
    native.build()
    native_s = time.perf_counter() - t0
    os.makedirs(os.path.join(td, "imgs"))
    for i, img in enumerate(procedural_images(CLI_IMAGES, CLI_HW, seed=11)):
        with open(os.path.join(td, "imgs", f"{i:05d}.png"), "wb") as f:
            f.write(encode_png(img))
    # the committed JPEG, BMP and palette / interlaced / 16-bit PNG files
    # too: stages A, B and C then train on a store holding decoded JPEGs
    for name in train_cli_fixtures():
        shutil.copy(os.path.join(IMAGE_FIXTURES, name), os.path.join(td, "imgs", name))
    runs = run_modules_together({
        "store": [("prepare_data", ["imgs", "--out", "store", "--size", str(CLI_SIZE),
                                    "--n_worker", "8"])],
        "heads": [("data.synthetic", ["--out", "heads", "--n", str(EVAL_HEADS), "--res",
                                      str(EVAL_HEAD_RES), "--seed", "3"])],
        "heads_512": [("data.synthetic", ["--out", "heads_512", "--png_dir", "heads_512_png",
                                          "--n", str(CLI_512_HEADS), "--res", "512",
                                          "--seed", "5"]),
                      ("prepare_data", ["heads_512_png", "--out", CLI_512_STORE, "--size",
                                        "64,512", "--n_worker", "8"])]}, td)
    return dict(native_s=native_s, native_built=fresh, runs=runs,
                seconds=time.perf_counter() - t0)


def train_cli(results: dict, smi: str, td: str, prepared: dict, beside) -> tuple:
    """The port's command-line training in ``td``: the store that
    :func:`prepare` made from PNG files by ``python -m
    sdface_gan_tpu_torch.prepare_data``, the loader timed on the host,
    ``python -m sdface_gan_tpu_torch.train`` through sphere init, stage A and
    stage B at full width, alone on the card; then, together, its rerun
    (which trains nothing), the NGP generator's run, and evaluate's tools
    that need no timing: the heads' FID stats, both probe stages and
    sdf_mesh; ``beside()`` runs in this process meanwhile.  Returns (those
    tools' results, ``beside()``'s) for :func:`evaluate`.  A run cut by
    ``--exit-after`` and its resume run in stage C's wave
    (:func:`train_cli_cut_jobs`, checked by :func:`train_cli_flow`)."""
    import numpy as np

    from sdface_gan_tpu_torch.data import DataLoader, MultiResolutionDataset
    from sdface_gan_tpu_torch.utils.checkpoints import checkpoint_exists

    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # leave the card's memory to the training subprocesses
    store = os.path.join(td, "store")
    prep = prepared["runs"]["store"]
    store_bytes = sum(os.path.getsize(os.path.join(store, n)) for n in os.listdir(store))
    ds = MultiResolutionDataset(store, CLI_SIZE, CLI_THUMB)
    records = len(ds)
    fixtures = train_cli_fixtures()
    check(records == CLI_IMAGES + len(fixtures), f"{records} records in the store")
    # prepare_data's seconds were taken beside the kernels' build
    rec_store = dict(records=records, fixture_files=len(fixtures), store_bytes=store_bytes,
                     seconds=prep["seconds"], native_build_s=prepared["native_s"],
                     native_built=prepared["native_built"], beside="the kernels' build")
    emit(phase="train_cli_store", **rec_store)

    # the loader's work, synchronously (decode, flip, HAMMING thumb, stack)
    rng = np.random.default_rng(0)
    work_ms = []
    for b in range(20):
        t0 = time.perf_counter()
        items = [ds.__getitem__(int(i), rng)
                 for i in (np.arange(CLI_BATCH) + b * CLI_BATCH) % records]
        imgs, thumbs = np.stack([a for a, _ in items]), np.stack([t for _, t in items])
        work_ms.append((time.perf_counter() - t0) * 1e3)
    check(imgs.shape == (CLI_BATCH, CLI_SIZE, CLI_SIZE, 3) and thumbs.shape ==
          (CLI_BATCH, CLI_THUMB, CLI_THUMB, 3) and bool(np.isfinite(imgs).all()),
          "loader batch shapes")
    # and through the prefetching DataLoader, as the consumer sees it
    with DataLoader(ds, batch_size=CLI_BATCH, seed=0) as loader:
        it = iter(loader)
        next(it)
        t0 = time.perf_counter()
        for _ in range(20):
            next(it)
        loader_ms = (time.perf_counter() - t0) * 1e3 / 20
    ds.close()

    cmd = ["--config", CLI_CONFIG, "--sdf", "1", "--dataset_path", "store",
           "--iters", "3", *CLI_TRAIN_FLAGS]
    # the entry alone on the card (its logged step ms are this phase's
    # timings); then its rerun and the NGP generator's run together
    entry = run_module("train", cmd, td)
    check("precision: f32 matmuls and convolutions without TF32" in entry["stdout"],
          "the entry trains with TF32 off, as train_parity checks")
    out = os.path.join(td, "out", CLI_EXP)
    vr = os.path.join(out, "volume_renderer")
    check(checkpoint_exists(vr, "vol_renderer") and checkpoint_exists(out, "full_pipeline"),
          "both stage artifacts written")
    rows_a = _train_rows(os.path.join(vr, "vol_render_metrics.jsonl"))
    rows_b = _train_rows(os.path.join(out, "full_pipeline_metrics.jsonl"))
    _finite_losses(rows_a, "train_cli stage A")
    _finite_losses(rows_b, "train_cli stage B")
    check([r["step"] for r in rows_a if "g" in r] == [0, 1, 2]
          and [r["step"] for r in rows_b] == [0, 1, 2], "3 + 3 iterations logged")
    check(all("d_ms" in r and "g_ms" in r for r in rows_b + [r for r in rows_a if "g" in r]),
          "d_ms and g_ms logged")
    for r in rows_a + rows_b:
        emit(phase="train", run="train_cli", **r)
    stage_a, stage_b = _step_medians(rows_a), _step_medians(rows_b)
    step_a_ms = stage_a["d_ms"] + stage_a["g_ms"]
    rec_loader = dict(batch=CLI_BATCH, resolution=CLI_SIZE, thumb=CLI_THUMB,
                      batch_work_ms_median=statistics.median(work_ms),
                      loader_ms_per_batch=loader_ms, stage_a_step_ms=step_a_ms,
                      keeps_up=statistics.median(work_ms) < step_a_ms,
                      prefetch_threads=1)
    emit(phase="train_cli_loader", **rec_loader)
    rec_entry = dict(config=CLI_CONFIG, command_s=entry["seconds"], stage_a=stage_a,
                     stage_b=stage_b, sphere_init_iters=2, iters=3)
    emit(phase="train_cli_entry", **rec_entry)

    before = _tree_mtimes(out)
    wave = Background(lambda: run_modules_together({
        "rerun": [("train", cmd)],
        "ngp": [("train", ["--config", CLI_NGP_CONFIG, "--sdf", "1", "--dataset_path",
                           "store", "--iters", "3", *CLI_TRAIN_FLAGS])],
        # evaluate's tools that time nothing: the heads' stats (for eval's
        # --fid_file runs), both probe stages and sdf_mesh
        "heads_stats": [("calc_fid_stats", ["heads_png", "--out", "heads_stats.npz",
                                            "--img_size", str(EVAL_HEAD_RES), "--batch", "16"])],
        "probe_a": [("probe_geometry", ["--config", CLI_CONFIG, "--stage", "a"])],
        "probe_b": [("probe_geometry", ["--config", CLI_CONFIG, "--stage", "b", "--mesh"])],
        "sdf_mesh": [("sdf_mesh", ["--config", CLI_CONFIG, "--identities", "2"])]}, td))
    beside_out = beside()
    runs = wave.result()
    rerun, ngp = runs.pop("rerun"), runs.pop("ngp")
    # every file it had is untouched and no checkpoint or log is new (the
    # probes and sdf_mesh write their own files beside them)
    after = _tree_mtimes(out)
    check(all(after.get(k) == v for k, v in before.items())
          and not any(k.endswith((".pt", ".jsonl")) for k in after.keys() - before.keys()),
          "a rerun trains nothing")
    check(f"wrote stats for {EVAL_HEADS} images" in runs["heads_stats"]["stdout"],
          "calc_fid_stats")

    # the NGP generator from its tuned yaml (rendering: type: ngp), run above
    ngp_out = os.path.join(td, "out", CLI_NGP_EXP)
    ngp_vr = os.path.join(ngp_out, "volume_renderer")
    check(checkpoint_exists(ngp_vr, "vol_renderer")
          and checkpoint_exists(ngp_out, "full_pipeline"), "NGP: both stage artifacts")
    ngp_a = _train_rows(os.path.join(ngp_vr, "vol_render_metrics.jsonl"))
    ngp_b = _train_rows(os.path.join(ngp_out, "full_pipeline_metrics.jsonl"))
    _finite_losses(ngp_a, "train_cli NGP stage A")
    _finite_losses(ngp_b, "train_cli NGP stage B")
    adv = [r for r in ngp_a if "g" in r]
    check([r["step"] for r in adv] == [0, 1, 2] and [r["step"] for r in ngp_b] == [0, 1, 2]
          and all("g_smooth" in r for r in adv), "NGP: 3 + 3 iterations, g_smooth logged")
    for r in ngp_a + ngp_b:
        emit(phase="train", run="train_cli_ngp", **r)
    # its step ms were logged with the rerun and evaluate's tools on the card
    rec_ngp = dict(config=CLI_NGP_CONFIG, command_s=ngp["seconds"],
                   stage_a=_step_medians(ngp_a), stage_b=_step_medians(ngp_b),
                   card_shared_with=["rerun", *runs], g_smooth=[r["g_smooth"] for r in adv])
    emit(phase="train_cli_ngp", **rec_ngp)
    wall = time.perf_counter() - t_phase
    results["train_cli"] = dict(store=rec_store, loader=rec_loader, entry=rec_entry,
                                rerun=dict(rc=rerun["rc"], seconds=rerun["seconds"]),
                                ngp=rec_ngp, wall_s=wall)
    emit(phase="train_cli", nvidia_smi=smi, records=records, store_bytes=store_bytes,
         store_s=prep["seconds"], loader_ms_per_batch=loader_ms,
         batch_work_ms_median=rec_loader["batch_work_ms_median"], stage_a_step_ms=step_a_ms,
         loader_keeps_up=rec_loader["keeps_up"], entry_rc=entry["rc"],
         entry_s=entry["seconds"], stage_a=stage_a, stage_b=stage_b, rerun_rc=rerun["rc"],
         wave_s={k: v["seconds"] for k, v in {"rerun": rerun, "ngp": ngp, **runs}.items()},
         wall_s=wall)
    return runs, beside_out


def train_cli_cut_jobs(td: str) -> dict:
    """train_cli's stage flow, for stage C's wave: a fresh experiment
    (``cut.yaml``) cut by ``--exit-after 1`` (exit 3, a ``models_*`` left),
    then the same command resuming at step + 1 and finishing; at batch
    ``CLI_CUT_BATCH``, so that it holds a few GB of the card beside stage
    C's train processes (at the entry's batch 8 it peaks at ~17 GB)."""
    with open(os.path.join(td, "cut.yaml"), "w") as f:
        f.write(f"inherit_from: {CLI_CONFIG}\ntraining:\n  out_dir: out/smoke_cut\n")
    cut_cmd = ["--config", "cut.yaml", "--sdf", "1", "--dataset_path", "store",
               "--iters", str(STAGE_C_CUT_ITERS), *CLI_TRAIN_FLAGS, "--batch", str(CLI_CUT_BATCH)]
    return {"cli_cut": [("train", cut_cmd + ["--exit-after", "1"], 3), ("train", cut_cmd)]}


def train_cli_flow(td: str, resume: dict) -> dict:
    """What :func:`train_cli_cut_jobs` left: the cut run exited 3 (checked by
    ``run_modules_together``) with a ``models_*`` checkpoint at some step k -
    1; its resume says it started at k and finished both stages."""
    import re

    from sdface_gan_tpu_torch.utils.checkpoints import checkpoint_exists

    resumed = re.search(r"resumed volume renderer at step (\d+)", resume["stdout"])
    check(resumed is not None and int(resumed.group(1)) >= 1,
          "the run cut by --exit-after was resumed at its checkpoint's step + 1")
    check(checkpoint_exists(os.path.join(td, "out", "smoke_cut"), "full_pipeline"),
          "the resumed run finished")
    rec = dict(exit_after_rc=3, exit_after_step=int(resumed.group(1)) - 1, resume_rc=resume["rc"],
               cut_and_resume_s=resume["seconds"], command_s=resume["command_s"])
    emit(phase="train_cli_flow", **rec)
    return rec


# The train_stage_c phase: stage C over train_cli's artifacts, and the
# script's wave of untimed processes: job -> the job that follows it
WAVE_AFTER = {"psp": "train_512", "giraffe_fixture": "giraffe_surface", "bridge": "eval_files",
              "vae": "ddp_nccl"}
STAGE_C_TOLERANCES = {"vae": (1e-4, 1e-3), "psp": (1e-4, 1e-3)}
STAGE_C_STEPS = 5  # timed E steps per encoder (median after the first)
STAGE_C_CUT_ITERS = 12  # --exit-after 1 cuts well before this (after step 0 so far)


def stage_c_parity() -> dict:
    """One E step per encoder, loss and every encoder gradient on the card
    against the CPU from the same weights and inputs, f32, TF32 off, the
    generator's forward deterministic, held by ``masked_parity``'s rule
    (the encoders' ReLU / PReLU / leaky-ReLU kinks included), both at the
    256^2 input the CLI trains on, against one small generator (batch 2,
    16^2 thumbs, 24 samples, depth 3, width 64, style 256, 256^2 decoder):
    the VAE (z 256, injected eps; its fc the full 262,144 -> 1,024 product)
    and pSp with the ID and LPIPS terms on (random weights) and injected
    mean styles."""
    import copy

    import torch

    from sdface_gan_tpu_torch.encoder import (
        LPIPS,
        IRSEBackbone,
        LossUtils,
        PSPConfig,
        PSPEncoder,
        VAEEncoder,
        VAEEncoderConfig,
    )
    from sdface_gan_tpu_torch.geometry import CameraParams, generate_camera_params
    from sdface_gan_tpu_torch.models import Generator, GeneratorConfig, RendererConfig
    from sdface_gan_tpu_torch.training.encoder_loop import EncoderInputs, encoder_loss

    batch, res = 2, 16
    seed = torch.Generator().manual_seed
    rkw = dict(type="sdf", out_im_res=res, n_samples=SAMPLES, width=64, depth=3,
               force_background=False)
    gcfg = GeneratorConfig(size=256, style_dim=256, full_pipeline=True, freeze_renderer=True,
                           channel_base=128, renderer=RendererConfig(style_dim=256, **rkw))
    ecfgs = {"vae": VAEEncoderConfig(img_size=256, z_size=256),
             "psp": PSPConfig(img_size=256, style_count=gcfg.decoder.n_latent,
                              renderer_style_dim=256)}
    cpu = {"g": Generator(gcfg, "cpu", seed(2)).requires_grad_(False),
           "e_vae": VAEEncoder(ecfgs["vae"], seed(3)), "e_psp": PSPEncoder(ecfgs["psp"], seed(4)),
           "irse": IRSEBackbone(generator=seed(5)), "lpips": LPIPS(generator=seed(6))}
    models = {"cpu": cpu, "cuda": {k: copy.deepcopy(m).cuda() for k, m in cpu.items()}}
    losses = {dev: {"vae": LossUtils(), "psp": LossUtils(irse=m["irse"], lpips=m["lpips"])}
              for dev, m in models.items()}
    gen = seed(7)
    cams = generate_camera_params(res, gen, batch=batch, device="cpu")
    data = {"vae": (torch.rand((batch, 256, 256, 3), generator=gen) * 2 - 1,
                    torch.rand((batch, res, res, 3), generator=gen) * 2 - 1,
                    torch.randn((batch, 256), generator=gen)),
            "psp": (torch.rand((batch, 256, 256, 3), generator=gen) * 2 - 1,
                    torch.rand((batch, res, res, 3), generator=gen) * 2 - 1, None)}
    avg = (0.1 * torch.randn((1, 256), generator=gen), 0.1 * torch.randn((1, 512), generator=gen))
    metrics = {}

    def step(kind, dev):
        m = models[dev]
        to = lambda t: None if t is None else t.to(dev)  # noqa: E731
        imgs, thumbs, eps = data[kind]
        inputs = EncoderInputs(to(imgs), to(thumbs), CameraParams(*map(to, cams)), eps=to(eps))
        loss, logged = encoder_loss(m[f"e_{kind}"], m["g"], gcfg, ecfgs[kind],
                                    losses[dev][kind], inputs,
                                    latent_avg=tuple(map(to, avg)) if kind == "psp" else None)
        if dev == "cuda":
            metrics[kind] = {k: v.item() for k, v in logged.items()}
        return loss, m[f"e_{kind}"], None

    with torch.enable_grad():
        out = masked_parity("train_stage_c_parity",
                            {k: functools.partial(step, k) for k in ("vae", "psp")},
                            STAGE_C_TOLERANCES)
    for kind, rec in out.items():
        rec["metrics"] = metrics[kind]
    check({"e_id", "e_lpips"} <= set(metrics["psp"]), "the pSp parity step ran ID and LPIPS")
    emit(phase="train_stage_c_parity", tolerances=STAGE_C_TOLERANCES, **out)
    return out


def stage_c_generator(td: str, config: str, exp: str):
    """The frozen ``full_pipeline`` generator that train_cli trained under
    ``config``, resolved as the train entry's stage C resolves it."""
    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.build import generator_config, stage_options
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path
    from sdface_gan_tpu_torch.utils.checkpoints import load_generator

    cfg = load_config(os.path.join(HERE, config), default_config_path())
    gcfg = generator_config(stage_options(cfg, False, batch=CLI_BATCH), stage_a=False)
    g = load_generator(os.path.join(td, "out", exp), "full_pipeline", gcfg, device="cuda")
    return gcfg, g.requires_grad_(False)


def stage_c_steps(gcfg, g, kind: str, loss_utils):
    """An encoder of ``kind`` for ``g`` at the CLI's batch and image size (with
    its optimizer), and a function running E step i (inputs from (0, "C", i))."""
    import torch

    from sdface_gan_tpu_torch.encoder import PSPConfig, PSPEncoder, VAEEncoder, VAEEncoderConfig
    from sdface_gan_tpu_torch.models import mean_latent
    from sdface_gan_tpu_torch.training.encoder_loop import encoder_step, sample_encoder_inputs
    from sdface_gan_tpu_torch.training.loop import _generator
    from sdface_gan_tpu_torch.training.optim import encoder_optimizer

    dev = torch.device("cuda")
    if kind == "psp":
        ecfg = PSPConfig(img_size=CLI_SIZE, style_count=gcfg.decoder.n_latent,
                         renderer_style_dim=gcfg.style_dim)
        e = PSPEncoder(ecfg).cuda()
        with torch.no_grad():
            latent_avg = mean_latent(g, torch.Generator(device=dev).manual_seed(2))
    else:
        ecfg = VAEEncoderConfig(img_size=CLI_SIZE, z_size=gcfg.style_dim)
        e, latent_avg = VAEEncoder(ecfg).cuda(), None
    opt = encoder_optimizer(e.parameters(), vae=kind == "vae")
    gen = torch.Generator(device=dev).manual_seed(8)
    imgs = torch.rand((CLI_BATCH, CLI_SIZE, CLI_SIZE, 3), device=dev, generator=gen) * 2 - 1
    res = gcfg.renderer.out_im_res
    thumbs = torch.rand((CLI_BATCH, res, res, 3), device=dev, generator=gen) * 2 - 1

    def run(i):
        inputs = sample_encoder_inputs(imgs, thumbs, res, _generator(dev, 0, "C", i))
        with torch.enable_grad():
            return encoder_step(e, g, opt, gcfg, ecfg, loss_utils, inputs,
                                latent_avg=latent_avg)
    return e, run


def stage_c_timing(td: str) -> dict:
    """E-step ms (CUDA events, median after the first of ``STAGE_C_STEPS``),
    images/s and peak memory of each encoder at batch 8, 256^2, against the
    flagship generator train_cli trained: the VAE with L2 alone (no weights
    given), pSp with the ID and LPIPS terms (random weights); then one pSp E
    step profiled, its top device operations."""
    import gc
    import math

    import torch

    from sdface_gan_tpu_torch.encoder import LPIPS, IRSEBackbone, LossUtils
    from sdface_gan_tpu_torch.training.loop import _timed

    gcfg, g = stage_c_generator(td, CLI_CONFIG, CLI_EXP)
    seed = torch.Generator().manual_seed
    out = {}
    for kind in ("vae", "psp"):
        gc.collect()
        torch.cuda.empty_cache()
        lu = (LossUtils(irse=IRSEBackbone(generator=seed(21)).cuda(),
                        lpips=LPIPS(generator=seed(22)).cuda()) if kind == "psp" else LossUtils())
        torch.cuda.reset_peak_memory_stats()
        e, run = stage_c_steps(gcfg, g, kind, lu)
        ms = []
        for i in range(STAGE_C_STEPS):
            m, elapsed = _timed(torch.device("cuda"), functools.partial(run, i))
            ms.append(elapsed())
            for k, v in m.items():
                check(math.isfinite(v.item()), f"stage C {kind} E step {i}: {k} finite")
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(peak <= 80.0, f"stage C {kind} at batch {CLI_BATCH}: peak {peak:.1f} GB <= 80")
        median = statistics.median(ms[1:])
        out[kind] = dict(batch=CLI_BATCH, image_size=CLI_SIZE, e_ms=ms, e_ms_median=median,
                         images_per_s=CLI_BATCH / (median / 1e3), peak_memory_gb=peak,
                         losses=sorted(m), encoder_params=sum(p.numel() for p in e.parameters()),
                         encoder_tensors=len(list(e.parameters())),
                         styles=getattr(e.cfg, "style_count", None))
        if kind == "psp":
            launches, names, _ = profiled(functools.partial(run, STAGE_C_STEPS))
            total = sum(us for us, _ in names.values())
            check(total > 0, "the pSp E step profile holds device events")
            top = sorted(names.items(), key=lambda kv: -kv[1][0])[:10]
            out["psp_profile"] = dict(device_ms_total=total / 1e3, kernels=len(names),
                                      top=[(k[:100], us / 1e3, n) for k, (us, n) in top])
        del e, run, lu
    return out


def stage_c_ngp_step(td: str) -> dict:
    """One VAE E step against train_cli's NGP generator (the tuned grid),
    counted and profiled: its frozen renderer runs the ``hash_encode``
    kernel and neither gradient kernel (K1 / K2), and no plain encode runs
    on the card."""
    from sdface_gan_tpu_torch.encoder import LossUtils

    gcfg, g = stage_c_generator(td, CLI_NGP_CONFIG, CLI_NGP_EXP)
    check(gcfg.renderer.type == "ngp", "the NGP yaml resolves to an NGP generator")
    _, run = stage_c_steps(gcfg, g, "vae", LossUtils())
    run(0)  # warm
    launches, names, plain = profiled(functools.partial(run, 1),
                                      want=(HASH_KERNEL_ROWS["hash_encode"],))
    check(launches["hash_encode"] > 0 and any(HASH_KERNEL_ROWS["hash_encode"] in k
                                              for k in names),
          f"the NGP E step launched hash_encode ({launches}) and the profile shows it")
    for kname in ("hash_encode_backward", "hash_encode_double_backward"):
        check(launches[kname] == 0 and not any(HASH_KERNEL_ROWS[kname] in k for k in names),
              f"the NGP E step launched no {kname} (frozen renderer)")
    check(not plain, f"no plain field or encode on the card in the NGP E step: {plain}")
    return dict(config=CLI_NGP_CONFIG, launches={k: v for k, v in launches.items() if v},
                hash_kernel_device_ms={k: sum(us for key, (us, _) in names.items()
                                              if row in key) / 1e3
                                       for k, row in HASH_KERNEL_ROWS.items()})


def _stage_c_rows(enc_dir: str, what: str, steps: list) -> list:
    from sdface_gan_tpu_torch.utils.checkpoints import checkpoint_exists

    check(checkpoint_exists(enc_dir, "encoder"), f"{what}: the encoder artifact written")
    rows = _train_rows(os.path.join(enc_dir, "encoder_metrics.jsonl"))
    _finite_losses(rows, what)
    check([r["step"] for r in rows] == steps and all("e_ms" in r for r in rows),
          f"{what}: steps {steps} logged with e_ms")
    return rows


def train_stage_c(results: dict, smi: str, td: str, extra_jobs: dict, beside: dict) -> dict:
    """Stage C on the card over train_cli's artifacts, in its directory:
    both E steps' time and memory at full width (and a profiled pSp step)
    and an NGP E step by kernel, alone on the card; then the script's wave
    of untimed work: train_64's run, the parity of both E steps and the
    in-process ``beside`` checks (name -> fn()), and at once the train
    entry: ``--vae 1`` and ``--psp 1`` (with two weight archives of random
    ID and LPIPS nets) and ``--vae 1`` under the NGP yaml, each skipping
    stages A and B, 3 iterations; a ``--vae 1`` run cut by ``--exit-after
    1`` (exit 3) that the next run resumes at step + 1 (its own experiment,
    holding copies of train_cli's two stage artifacts); giraffe_train's CLI
    runs (:func:`giraffe_train_jobs`) and ``extra_jobs``.  Returns the
    results of giraffe_train's runs, of ``extra_jobs`` and of ``beside``."""
    import gc

    import torch

    from sdface_gan_tpu_torch.encoder import LPIPS, IRSEBackbone
    from sdface_gan_tpu_torch.encoder.lpips import ALEX_CONV_IDS
    from sdface_gan_tpu_torch.ops import _ext

    t0 = time.perf_counter()
    # the timed E steps and the profiled NGP step alone on the card; then
    # train_64's run and the wave's processes (which time nothing; the train
    # processes' logged E-step ms share the card) beside the parities
    timing = stage_c_timing(td)
    emit(phase="train_stage_c_timing", nvidia_smi=smi, **timing)
    _ext.reset_launch_counts()
    ngp = stage_c_ngp_step(td)
    emit(phase="train_stage_c_ngp", nvidia_smi=smi, **ngp)
    run_64 = start_train_64()
    try:
        # random ID / LPIPS nets in the archive formats --irse_weights and
        # --lpips_weights read (model_ir_se50.pth; {"alex": features.*, "lin": lin*})
        seed = torch.Generator().manual_seed
        irse_path = os.path.join(td, "irse_random.pth")
        lpips_path = os.path.join(td, "lpips.pth")
        torch.save(IRSEBackbone(generator=seed(31)).state_dict(), irse_path)
        lp = LPIPS(generator=seed(32))
        alex = {f"features.{cid}.{w}": lp.alex.features[str(cid)].state_dict()[w]
                for cid in ALEX_CONV_IDS for w in ("weight", "bias")}
        lins = {f"lin{i}.model.1.weight": lp.lins[f"lin{i}"].model[1].weight.detach()
                for i in range(5)}
        torch.save({"alex": alex, "lin": lins}, lpips_path)

        base = ["--sdf", "1", "--dataset_path", "store", *CLI_TRAIN_FLAGS]
        # the cut run's own experiment, from copies of the entry's artifacts
        cut_out = os.path.join(td, "out", "smoke_c_cut")
        os.makedirs(os.path.join(cut_out, "volume_renderer"))
        for rel in ("volume_renderer/vol_renderer.pt", "full_pipeline.pt"):
            shutil.copy(os.path.join(td, "out", CLI_EXP, rel), os.path.join(cut_out, rel))
        with open(os.path.join(td, "cut_c.yaml"), "w") as f:
            f.write(f"inherit_from: {CLI_CONFIG}\ntraining:\n  out_dir: out/smoke_c_cut\n")
        cut_cmd = ["--config", "cut_c.yaml", "--iters", str(STAGE_C_CUT_ITERS), "--vae", "1",
                   *base]
        out, ngp_out = os.path.join(td, "out", CLI_EXP), os.path.join(td, "out", CLI_NGP_EXP)
        before = {k: os.stat(os.path.join(d, f"{n}.pt")).st_mtime_ns
                  for k, (d, n) in {"vr": (os.path.join(out, "volume_renderer"), "vol_renderer"),
                                    "fp": (out, "full_pipeline"), "ngp": (ngp_out, "full_pipeline")
                                    }.items()}
        stage_c = {
            "vae": [("train", ["--config", CLI_CONFIG, "--iters", "3", "--vae", "1", *base])],
            "psp": [("train", ["--config", CLI_CONFIG, "--iters", "3", "--psp", "1",
                               "--irse_weights", irse_path, "--lpips_weights", lpips_path,
                               *base])],
            "ngp": [("train", ["--config", CLI_NGP_CONFIG, "--iters", "3", "--vae", "1",
                               *base])],
            "cut": [("train", cut_cmd + ["--exit-after", "1"], 3), ("train", cut_cmd)]}
        # a job of WAVE_AFTER's values starts when its key's job ends: no more
        # than four of the train processes that peak at 10-14 GB of the card
        # (stage C's four, the staged 512^2 CLI) run at once; the card's used
        # memory is sampled meanwhile
        jobs, split = chained({**stage_c, **giraffe_train_jobs(td), **extra_jobs}, WAVE_AFTER)
        gc.collect()
        torch.cuda.empty_cache()  # leave the card to the wave's processes
        wave = Background(lambda: split(run_modules_together(jobs, td)))
        memory = CardMemory()
        # the parities in this process while the wave runs
        parity = stage_c_parity()
        beside_out = {}
        for name, fn in beside.items():
            t_beside = time.perf_counter()
            beside_out[name] = fn()
            emit(phase="wall", of=name, wall_s=time.perf_counter() - t_beside,
                 beside="stage C's wave")
        gc.collect()
        torch.cuda.empty_cache()  # leave the card to the train processes
        try:
            runs = wave.result()
        finally:
            card_peak_used_gb = memory.stop()
        others = {k: runs.pop(k) for k in ("giraffe_resume", "giraffe_cut", "gan2d",
                                           *extra_jobs)}
    except BaseException:
        run_64[0].kill()
        run_64[0].wait()
        run_64[1].cleanup()
        raise
    train_64(results, smi, run_64)
    cut = runs.pop("cut")
    after = {k: os.stat(os.path.join(d, f"{n}.pt")).st_mtime_ns
             for k, (d, n) in {"vr": (os.path.join(out, "volume_renderer"), "vol_renderer"),
                               "fp": (out, "full_pipeline"), "ngp": (ngp_out, "full_pipeline")
                               }.items()}
    check(before == after, "stages A and B skipped: their artifacts untouched")
    for kind, r in {**runs, "cut": cut}.items():
        check("sphere init" not in r["stdout"] and "initialized renderer" not in r["stdout"],
              f"train --{kind}: no stage A or B ran")
    check("loaded ArcFace ID-loss weights" in runs["psp"]["stdout"]
          and "loaded LPIPS weights" in runs["psp"]["stdout"]
          and "warm-started" in runs["psp"]["stdout"], "train --psp read both archives")
    rows = {"vae": _stage_c_rows(os.path.join(out, "encoder"), "train --vae 1", [0, 1, 2]),
            "psp": _stage_c_rows(os.path.join(out, "encoder_psp"), "train --psp 1", [0, 1, 2]),
            "ngp": _stage_c_rows(os.path.join(ngp_out, "encoder"), "train --vae 1 (NGP)",
                                 [0, 1, 2])}
    check(all("e_id" in r and "e_lpips" in r for r in rows["psp"]),
          "train --psp logged the ID and LPIPS terms")
    for kind, rs in rows.items():
        for r in rs:
            emit(phase="train", run=f"train_stage_c_{kind}", **r)

    # the resumed run's step, and every step logged once: the cut run's,
    # then the resumed run's from the cut's step + 1
    resumed = [int(ln.rsplit(" ", 1)[1]) for ln in cut["stdout"].splitlines()
               if ln.startswith("resumed encoder at step ")]
    check(len(resumed) == 1 and resumed[0] >= 1, "the next stage-C run resumed from a checkpoint")
    _stage_c_rows(os.path.join(cut_out, "encoder"), "train --vae 1 resumed",
                  list(range(STAGE_C_CUT_ITERS)))
    rec = dict(parity={k: {m: v[m] for m in ("loss_rel_err", "worst_param",
                                              "worst_grad_rel_err", "held_with")}
                       for k, v in parity.items()},
               e_step={k: {m: timing[k][m] for m in ("e_ms_median", "images_per_s",
                                                      "peak_memory_gb")}
                       for k in ("vae", "psp")},
               psp_profile_top=timing["psp_profile"]["top"][:5], ngp=ngp,
               cli_s={k: r["seconds"] for k, r in runs.items()},
               cli_e_ms_card_shared={k: statistics.median(r["e_ms"] for r in rs[1:])
                                     for k, rs in rows.items()},
               exit_after_step=resumed[0] - 1, exit_after_and_resume_s=cut["seconds"],
               wave_s={k: v["seconds"] for k, v in others.items()},
               wave_card_peak_used_gb=card_peak_used_gb, seconds=time.perf_counter() - t0)
    results["train_stage_c"] = rec
    emit(phase="train_stage_c", nvidia_smi=smi, wall_s=rec["seconds"], **rec)
    return {**others, **beside_out}


# The bridge_and_images phase: JAX's checkpoints and the image decoders.
IMAGE_FIXTURES = os.path.join(HERE, "tests", "fixtures", "images")
JAX_FIXTURE = os.path.join(HERE, "tests", "fixtures", "jax_run")
JAX_IMAGE_TOL = 2e-3  # serve_compare's card-vs-CPU bar, added to IMAGE_TOL's (rtol 2e-3, atol 2e-4)
DECODE_REPEATS = 20
JPEG_PREPARE_COPIES = 8  # the JPEG fixtures, this many times over, through prepare_data
WEBP_PREPARE_COPIES = 12  # the 178 x 218 WebP fixtures, this many times over, the same way
# ms per decode reported by kind: the fixtures' name patterns of each
DECODE_KINDS = {"jpeg_178x218": "head_*.jpg",
                "jpeg_progressive_178x218": "jpeg_progressive_[4r]*.jpg",  # 4:2:0, restarts
                "jpeg_progressive_smoothed_178x218": "jpeg_progressive_smoothed.jpg",
                "jpeg_arith_178x218": "jpeg_arith*.jpg",  # sequential, progressive
                "jpeg_lossless_178x218": "jpeg_lossless_*.jpg",
                "jpeg_cmyk_178x218": "jpeg_cmyk*.jpg",  # PIL's, jpeg_writer.c's
                "jpeg_ycck_178x218": "jpeg_ycck.jpg",
                "jpeg_samplings_178x218": "jpeg_[hc][1-4h]*.jpg",  # h1v2, h4v1, h4v2, chroma above
                "webp_lossy_178x218": "webp_lossy.webp",
                "webp_lossy_vp8x_178x218": "webp_[ae][lx]*.webp",  # alpha, extended
                "webp_lossless_178x218": "webp_lossless.webp",
                "webp_animated_178x218": "webp_anim_*.webp",
                "webp_lossy_512": "webp_lossy_512.webp",
                "webp_lossless_512": "webp_lossless_512.webp",
                "webp_lossy_encoder_settings_128x96": "webp_[nops]*.webp",
                "bmp_kinds_48x64": "bmp_*.bmp"}
WEBP_PREPARE_FILES = ("webp_lossy.webp", "webp_lossless.webp", "webp_alpha.webp",
                      "webp_extended.webp")
BRIDGE_BATCH, BRIDGE_RESUME_ITERS = 2, 2


def image_fixtures() -> list:
    """The committed image files (each with its PIL decode ``<name>.npy``)."""
    return sorted(n for n in os.listdir(IMAGE_FIXTURES)
                  if not n.endswith((".npy", ".py")))


def train_cli_fixtures() -> list:
    """The committed image files train_cli's store holds beside its
    procedural images: the ``head*`` JPEG, PNG and BMP heads (the WebP and
    BMP-kind fixtures are decoded and timed by bridge_and_images only)."""
    return [n for n in image_fixtures() if n.startswith("head")]


def decode_fixtures() -> dict:
    """Every committed image decoded by the port on this host, byte-equal to
    PIL's decode committed beside it; ms per decode (median of 20)."""
    import numpy as np

    from sdface_gan_tpu_torch.data.decode import decode_image

    out = {}
    for name in image_fixtures():
        with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
            data = f.read()
        want = np.load(os.path.join(IMAGE_FIXTURES, name + ".npy"))
        got = decode_image(data)
        check(got.shape == want.shape and bool((got == want).all()),
              f"{name}: the port's decode equals PIL's")
        times = []
        for _ in range(DECODE_REPEATS):
            t0 = time.perf_counter()
            decode_image(data)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(shape=list(got.shape), bytes=len(data), ms=statistics.median(times))
    return out


def jax_fixture_configs():
    """The JAX fixture's configs as the train entry builds them from its
    yaml (stage B's channel table shrunk as the fixture script shrank it)."""
    import numpy as np

    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path
    from sdface_gan_tpu_torch.train import stage_configs
    from sdface_gan_tpu_torch.training.encoder_loop import encoder_config
    from sdface_gan_tpu_torch.utils.checkpoints import RunConfigs

    cfg = load_config(os.path.join(JAX_FIXTURE, "jax_bridge.yaml"), default_config_path())
    with np.load(os.path.join(JAX_FIXTURE, "samples.npz")) as f:
        samples = {k: f[k] for k in f.files}
    cb = int(samples["channel_base"])
    gcfg, sd, hp = stage_configs(cfg, False)
    stage_b = (dataclasses.replace(gcfg, channel_base=cb), dataclasses.replace(sd, channel_base=cb),
               dataclasses.replace(hp, batch=BRIDGE_BATCH))
    size = cfg["data"]["img_size"]
    return samples, size, RunConfigs(stage_a=stage_configs(cfg, True), stage_b=stage_b,
                                     vae=encoder_config(stage_b[0], size, False),
                                     psp=encoder_config(stage_b[0], size, True))


def bridge_jobs(td: str) -> dict:
    """bridge_and_images' CLI runs for stage C's wave, in turn: train_cli's
    images into a store at the committed JAX run's size, stage A's archive
    imported by ``python -m sdface_gan_tpu_torch.import_jax_checkpoints`` from
    its yaml, and the train entry from JAX's imported ``sdf_init_models``
    (2 + 2 iterations)."""
    _, size, _ = jax_fixture_configs()
    shutil.copy(os.path.join(JAX_FIXTURE, "jax_bridge.yaml"), os.path.join(td, "jax_bridge.yaml"))
    return {"bridge": [
        ("prepare_data", ["imgs", "--out", "store32", "--size", str(size), "--n_worker", "8"]),
        ("import_jax_checkpoints", ["--src", os.path.join(JAX_FIXTURE, "stage_a"), "--config",
                                    "jax_bridge.yaml", "--sdf", "1"]),
        ("train", ["--config", "jax_bridge.yaml", "--sdf", "1", "--dataset_path", "store32",
                   "--batch", str(BRIDGE_BATCH), "--iters", "2", "--log_every", "1",
                   "--save_every", "1000", "--sample_every", "1000"])]}


def bridge_and_images(results: dict, smi: str, td: str, cli: dict) -> None:
    """JAX's checkpoints and the image decoders on the card's machine, in
    train_cli's directory: the committed images decoded (byte-equal to the
    PIL decodes committed beside them) and timed, the JPEG fixtures through
    ``prepare_data``; the committed JAX run imported (stage A's archive by
    ``python -m sdface_gan_tpu_torch.import_jax_checkpoints`` from its yaml,
    stage B's by ``import_jax_run``); its ``full_pipeline`` served by
    ``SDFaceSampler.from_checkpoint`` through the f32 field kernel with
    JAX's z, angles and truncation pair, against JAX's images; its stage-B
    ``models_0000002`` resumed by ``train_full_pipeline`` for two iterations
    (resumed at step 3, finite losses, ``models_*`` written); what the train
    entry from JAX's imported ``sdf_init_models`` wrote (``cli``, the runs of
    :func:`bridge_jobs` in stage C's wave); a VAE stage C against the
    imported generator; and train_cli's own flagship ``full_pipeline``
    through ``from_checkpoint`` (bf16, batch 8), bit-equal to a sampler
    built from the same state dict in this process."""
    import io

    import numpy as np
    import torch

    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path
    from sdface_gan_tpu_torch.data import DataLoader, MultiResolutionDataset
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.serving import SDFaceSampler
    from sdface_gan_tpu_torch.train import stage_configs
    from sdface_gan_tpu_torch.training.encoder_loop import train_encoder
    from sdface_gan_tpu_torch.training.loop import train_full_pipeline
    from sdface_gan_tpu_torch.utils.checkpoints import (
        checkpoint_exists,
        import_jax_run,
        latest_checkpoint_step,
        load_checkpoint,
        load_generator,
    )

    t_phase = time.perf_counter()
    decoded = decode_fixtures()
    decode_ms = {kind: statistics.median(r["ms"] for n, r in decoded.items()
                                         if fnmatch.fnmatch(n, pattern))
                 for kind, pattern in DECODE_KINDS.items()}
    emit(phase="bridge_decode", nvidia_smi=smi, files=decoded,
         jpeg_178x218_decode_ms_median=decode_ms["jpeg_178x218"],
         decode_ms_median_by_kind=decode_ms)

    jpegs = os.path.join(td, "jpegs")
    os.makedirs(jpegs)
    for k in range(JPEG_PREPARE_COPIES):
        for name in image_fixtures():
            if fnmatch.fnmatch(name, DECODE_KINDS["jpeg_178x218"]):  # the baseline heads
                shutil.copy(os.path.join(IMAGE_FIXTURES, name), os.path.join(jpegs, f"{k}_{name}"))
    n_jpeg = len(os.listdir(jpegs))
    prep = run_module("prepare_data", ["jpegs", "--out", "jpeg_store", "--size", str(CLI_SIZE),
                                       "--n_worker", "8"], td)
    ds = MultiResolutionDataset(os.path.join(td, "jpeg_store"), CLI_SIZE, CLI_THUMB)
    check(len(ds) == n_jpeg, "prepare_data stored every JPEG")
    ds.close()
    rec_prepare = dict(jpegs=n_jpeg, size=CLI_SIZE, seconds=prep["seconds"],
                       images_per_s=n_jpeg / prep["seconds"])
    emit(phase="bridge_prepare_jpeg", nvidia_smi=smi, **rec_prepare)
    webps = os.path.join(td, "webps")
    os.makedirs(webps)
    for k in range(WEBP_PREPARE_COPIES):
        for name in WEBP_PREPARE_FILES:
            shutil.copy(os.path.join(IMAGE_FIXTURES, name), os.path.join(webps, f"{k}_{name}"))
    n_webp = len(os.listdir(webps))
    prep = run_module("prepare_data", ["webps", "--out", "webp_store", "--size", str(CLI_SIZE),
                                       "--n_worker", "8"], td)
    ds = MultiResolutionDataset(os.path.join(td, "webp_store"), CLI_SIZE, CLI_THUMB)
    check(len(ds) == n_webp, "prepare_data stored every WebP")
    check(ds.__getitem__(1, np.random.default_rng(0))[0].shape == (CLI_SIZE, CLI_SIZE, 3),
          "a WebP record reads back at the store's size")
    ds.close()
    rec_prepare_webp = dict(webps=n_webp, size=CLI_SIZE, seconds=prep["seconds"],
                            images_per_s=n_webp / prep["seconds"])
    emit(phase="bridge_prepare_webp", nvidia_smi=smi, **rec_prepare_webp)

    # the committed JAX run, imported (stage A's archive by the CLI, in the wave)
    samples, size, configs = jax_fixture_configs()
    import_s, entry_s = cli["bridge"]["command_s"][1:]
    jax_out = os.path.join(td, "out", "jax_bridge")
    check(checkpoint_exists(os.path.join(jax_out, "volume_renderer"), "sdf_init_models"),
          "import_jax_checkpoints wrote sdf_init_models where train looks")
    stage_b_dir = os.path.join(td, "jax_stage_b")
    t0 = time.perf_counter()
    written = import_jax_run(os.path.join(JAX_FIXTURE, "stage_b"), stage_b_dir, configs)
    import_stage_b_s = time.perf_counter() - t0
    check(len(written) == 2, "stage B's two archives imported")

    gcfg, sd_cfg, hp = configs.stage_b
    serve_cfg = dataclasses.replace(gcfg, renderer=dataclasses.replace(gcfg.renderer, perturb=0.0))
    trunc = tuple(torch.from_numpy(samples[k]).cuda() for k in ("trunc_renderer", "trunc_decoder"))
    _ext.reset_launch_counts()
    sampler = SDFaceSampler.from_checkpoint(stage_b_dir, cfg=serve_cfg, batch=len(samples["z"]),
                                            truncation=float(samples["truncation"]),
                                            truncation_latent=trunc)
    img = sampler.sample(z=samples["z"], azim=float(samples["azim"]),
                         elev=float(samples["elev"])).float().cpu().numpy()
    torch.cuda.synchronize()
    jax_launches = dict(_ext.LAUNCHES)
    check(jax_launches["siren_field"] >= 1, "the JAX model's request went through the field kernel")
    want = samples["images"]
    err = float(np.abs(img - want).max())
    bar = JAX_IMAGE_TOL + 2e-4 + 2e-3 * np.abs(want)
    check(img.shape == want.shape and bool(np.isfinite(img).all())
          and bool((np.abs(img - want) <= bar).all()),
          f"the card's images of JAX's full_pipeline within the bar of JAX's (max abs {err})")
    serve = dict(batch=len(samples["z"]), width=gcfg.renderer.width, dtype="float32",
                 max_abs_err_vs_jax=err, bar="2e-3 + 2e-4 + 2e-3 |jax|",
                 launches=jax_launches["siren_field"])
    emit(phase="bridge_serve_jax", nvidia_smi=smi, **serve)
    del sampler

    # stage B from JAX's models_0000002, two more iterations
    store32 = os.path.join(td, "store32")
    start = latest_checkpoint_step(stage_b_dir)
    ds = MultiResolutionDataset(store32, resolution=size, nerf_resolution=gcfg.renderer.out_im_res)
    buf = io.StringIO()
    try:
        with DataLoader(ds, batch_size=BRIDGE_BATCH, seed=0) as loader, \
                contextlib.redirect_stdout(buf), torch.enable_grad():
            train_full_pipeline(loader, gcfg, sd_cfg, hp, stage_b_dir,
                                iters=start + 1 + BRIDGE_RESUME_ITERS, save_every=1,
                                sample_every=0, log_every=1, device="cuda")
    finally:
        ds.close()
    check(f"resumed full pipeline at step {start + 1}" in buf.getvalue(),
          "stage B resumed JAX's models_* at step + 1")
    rows = _train_rows(os.path.join(stage_b_dir, "full_pipeline_metrics.jsonl"))
    _finite_losses(rows, "stage B resumed from JAX")
    check([r["step"] for r in rows] == list(range(start + 1, start + 1 + BRIDGE_RESUME_ITERS))
          and latest_checkpoint_step(stage_b_dir) == start + BRIDGE_RESUME_ITERS,
          "the resumed iterations logged and their models_* written")
    for r in rows:
        emit(phase="train", run="bridge_stage_b_resume", **r)
    resume = dict(resumed_at=start + 1, iterations=BRIDGE_RESUME_ITERS,
                  step_ms=[r["d_ms"] + r["g_ms"] + r.get("path_ms", 0.0) for r in rows])

    # the train entry from JAX's sphere init (run in the wave)
    entry = cli["bridge"]
    check("loaded sphere-initialized model" in entry["stdout"],
          "train started stage A from JAX's imported sdf_init_models")
    check(checkpoint_exists(jax_out, "full_pipeline"), "train finished stages A and B")
    _finite_losses(_train_rows(os.path.join(jax_out, "volume_renderer", "vol_render_metrics.jsonl"))
                   + _train_rows(os.path.join(jax_out, "full_pipeline_metrics.jsonl")),
                   "train from JAX's sdf_init_models")

    # stage C (the VAE) against JAX's imported generator
    g_ema = load_generator(stage_b_dir, "full_pipeline", gcfg, device="cuda")
    ds = MultiResolutionDataset(store32, resolution=size, nerf_resolution=gcfg.renderer.out_im_res)
    enc_dir = os.path.join(td, "jax_stage_c")
    try:
        with DataLoader(ds, batch_size=BRIDGE_BATCH, seed=0) as loader, \
                contextlib.redirect_stdout(io.StringIO()), torch.enable_grad():
            train_encoder(loader, gcfg, g_ema, configs.vae, enc_dir, iters=2, log_every=1,
                          sample_every=0, save_every=1000, val_n_sample=1, device="cuda")
    finally:
        ds.close()
    c_rows = _stage_c_rows(enc_dir, "stage C against JAX's generator", [0, 1])
    check(checkpoint_exists(enc_dir, "encoder"), "stage C wrote its encoder")
    del g_ema

    # train_cli's flagship artifact through from_checkpoint, bf16, batch 8
    flagship = stage_configs(load_config(os.path.join(td, CLI_CONFIG), default_config_path()),
                             False)[0]
    out = os.path.join(td, "out", CLI_EXP)
    _ext.reset_launch_counts()
    a = SDFaceSampler.from_checkpoint(out, cfg=flagship, dtype=torch.bfloat16, batch=BATCH)
    img_a = a.sample(seed=5)
    torch.cuda.synchronize()
    flagship_launches = dict(_ext.LAUNCHES)
    del a
    state = load_checkpoint(out, "full_pipeline", map_location="cuda")["g_ema"]
    b = SDFaceSampler.from_state_dict(state, flagship, dtype=torch.bfloat16, batch=BATCH)
    img_b = b.sample(seed=5)
    check(img_a.dtype == torch.bfloat16 and torch.equal(img_a, img_b),
          "from_checkpoint's bf16 images equal a sampler's from the same state dict")
    check(flagship_launches["siren_field"] >= 1, "the flagship request launched the field kernel")
    del b, state

    rec = dict(decode={n: r["ms"] for n, r in decoded.items()},
               jpeg_178x218_decode_ms_median=decode_ms["jpeg_178x218"],
               decode_ms_median_by_kind=decode_ms, prepare_jpeg=rec_prepare,
               prepare_webp=rec_prepare_webp, import_cli_s=import_s,
               import_stage_b_s=import_stage_b_s, serve_jax=serve, stage_b_resume=resume,
               train_entry_s=entry_s, cli_beside="stage C's wave",
               stage_c_e_ms=[r["e_ms"] for r in c_rows],
               flagship_from_checkpoint=dict(batch=BATCH, dtype="bfloat16", bit_equal=True,
                                             launches=flagship_launches["siren_field"]),
               launches=dict(siren_field_f32=jax_launches["siren_field"],
                             siren_field=flagship_launches["siren_field"]),
               seconds=time.perf_counter() - t_phase)
    results["bridge_and_images"] = rec
    emit(phase="bridge_and_images", nvidia_smi=smi, wall_s=rec["seconds"], **rec)


# The giraffe phase: the GIRAFFE generator at full width, the committed JAX
# GIRAFFE run imported and served, and the render / extract_mesh entries.
GIRAFFE_CONFIG = "configs/256res/ffhq_256.yaml"
GIRAFFE_HASH_CONFIG = "configs/256res/ffhq_256_vae_hash.yaml"
GIRAFFE_BATCH, GIRAFFE_REQUESTS, GIRAFFE_MESH_RES = 4, 5, 64
GIRAFFE_TOL = 2e-3  # serve_compare's card-vs-CPU bar
GIRAFFE_FIXTURE = os.path.join(HERE, "tests", "fixtures", "jax_giraffe_run")
GIRAFFE_FIXTURE_FLAGS = ["--i_embed", "1", "--log2_hashmap_size", "10", "--finest_res", "64"]
GIRAFFE_FIXTURE_KW = {k[2:]: int(v) for k, v in zip(GIRAFFE_FIXTURE_FLAGS[::2],
                                                     GIRAFFE_FIXTURE_FLAGS[1::2])}
GIRAFFE_IMAGES = "tests/fixtures/images/head*[gp]"  # the head image files (not webp_*, bmp_*)
# The surface model: ffhq_256's seeded plain generator with its density
# scaled so that the mesh CLIs' level (0.005) cuts object 0's box (a seeded
# density peaks near alpha 0.002 at 64^3, the fixture's is flat).
GIRAFFE_SURFACE_SIGMA = 20.0
GIRAFFE_SURFACE_YAML = ("inherit_from: configs/256res/ffhq_256.yaml\n"
                        "training:\n  out_dir: out/giraffe_surface\n"
                        "rendering:\n  render_program: ['object_rotation']\n")


def giraffe_model(config: str, flags: dict):
    """(GiraffeConfig, generator on the CPU from seed 0) of a yaml and flags."""
    import types

    import torch

    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path
    from sdface_gan_tpu_torch.giraffe.config import giraffe_config_from_yaml
    from sdface_gan_tpu_torch.giraffe.generator import GiraffeGenerator

    cfg = load_config(os.path.join(HERE, config), default_config_path())
    gcfg = giraffe_config_from_yaml(cfg, types.SimpleNamespace(**flags))
    return gcfg, GiraffeGenerator(gcfg, torch.Generator().manual_seed(0)).eval()


def giraffe_request(gcfg, device) -> dict:
    """A batch-4 eval request: codes from seed 1 at 0.65, the fixed camera
    and box transforms."""
    import torch

    from sdface_gan_tpu_torch.giraffe.bbox import fixed_transformations
    from sdface_gan_tpu_torch.giraffe.generator import fixed_camera, sample_latent_codes

    return dict(latent_codes=sample_latent_codes(torch.Generator().manual_seed(1), gcfg,
                                                 GIRAFFE_BATCH, tmp=0.65, device=device),
                camera_matrices=fixed_camera(gcfg, GIRAFFE_BATCH, device=device),
                transformations=fixed_transformations(gcfg.bbox, GIRAFFE_BATCH, device=device),
                mode="eval")


@contextlib.contextmanager
def recorded_hash_inputs():
    """The points each GIRAFFE decoder's hash encode receives while the
    block runs (the box-local points / 15), each call passed on."""
    from sdface_gan_tpu_torch.giraffe import decoder

    seen, original = [], decoder.hash_encode

    def record(x, *args, **kwargs):
        seen.append(x.detach().clone())
        return original(x, *args, **kwargs)

    decoder.hash_encode = record
    try:
        yield seen
    finally:
        decoder.hash_encode = original


@contextlib.contextmanager
def zeroed_hash_encodes():
    """The GIRAFFE decoders' hash encodes give zeros while the block runs:
    how far the image moves then says whether an image check at a bar can
    see the encode."""
    from sdface_gan_tpu_torch.giraffe import decoder

    original = decoder.hash_encode
    decoder.hash_encode = lambda x, table, spec, **kwargs: x.new_zeros(
        x.shape[:-1] + (spec.output_dim,))
    try:
        yield
    finally:
        decoder.hash_encode = original


def serve_giraffe(name: str, config: str, flags: dict, hashed: bool) -> tuple:
    """One full-width request on the card (counted; the hash decoders'
    inputs recorded; their table redrawn at std 1, so that the encode moves
    the image) against the same request on the CPU, then timed."""
    import copy

    import numpy as np
    import torch

    from sdface_gan_tpu_torch.giraffe.generator import giraffe_forward
    from sdface_gan_tpu_torch.ops import _ext

    gcfg, g_cpu = giraffe_model(config, flags)
    if hashed:
        with torch.no_grad():
            g_cpu.decoder.hash_table.normal_(generator=torch.Generator().manual_seed(0))
    g = copy.deepcopy(g_cpu).cuda()
    req, req_cpu = giraffe_request(gcfg, "cuda"), giraffe_request(gcfg, "cpu")
    giraffe_forward(g, gcfg, **req)  # warm-up
    torch.cuda.synchronize()
    _ext.reset_launch_counts()
    with plain_encodes_on_card() as plain, recorded_hash_inputs() as hash_inputs:
        img = giraffe_forward(g, gcfg, **req)
        torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    want = giraffe_forward(g_cpu, gcfg, **req_cpu)
    got = img.cpu()
    err = (got - want).abs().max().item()
    size = gcfg.neural_renderer.img_size
    check(tuple(got.shape) == (GIRAFFE_BATCH, size, size, 3) and bool(torch.isfinite(got).all()),
          f"giraffe {name}: finite images of shape [4, {size}, {size}, 3]")
    check(err <= GIRAFFE_TOL, f"giraffe {name}: card vs CPU max abs {err} <= {GIRAFFE_TOL}")
    check(not plain, f"giraffe {name}: no plain encode on a CUDA tensor ({plain})")
    encode_moves_image = None
    if hashed:
        check(launches["hash_encode"] >= 1 and launches["hash_encode"] == len(hash_inputs),
              f"giraffe {name}: the hash decoder's encodes launched the kernel ({launches})")
        with zeroed_hash_encodes():
            encode_moves_image = (img - giraffe_forward(g, gcfg, **req)).abs().max().item()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(GIRAFFE_REQUESTS):
        giraffe_forward(g, gcfg, **req)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / GIRAFFE_REQUESTS * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, names, _ = profiled(lambda: giraffe_forward(g, gcfg, **req),
                           want=("hash_encode_kernel",) if hashed else ())
    device_ms_total = sum(us for us, _ in names.values()) / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:6]
    rec = dict(config=config, flags=flags, batch=GIRAFFE_BATCH, image=size,
               max_abs_err_vs_cpu=err, bar=GIRAFFE_TOL, ms_per_request=ms,
               images_per_s=GIRAFFE_BATCH / ms * 1e3, peak_gb=peak_gb,
               device_ms_total=device_ms_total, idle_share=1.0 - device_ms_total / ms,
               top_device_ms={k[:80]: us / 1e3 for k, (us, _) in top},
               launches=dict(hash_encode=launches["hash_encode"]),
               plain_encodes_on_card=len(plain), encode_moves_image=encode_moves_image,
               image_mean=float(np.mean(got.numpy())))
    return rec, gcfg, g, g_cpu, hash_inputs


def giraffe_encode_check(gcfg, table, hash_inputs: list) -> dict:
    """``hash_encode`` against the plain encode on a request's own box-local
    points and its model's table (at std 1); the kernel's device ms there
    beside its bound: points, output and the rows the in-box points touch
    (out-of-box points read none)."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    spec = gcfg.decoder.hash_spec
    x = hash_inputs[0].reshape(-1, 3).contiguous()
    table = table.detach()
    got = hg.hash_encode(x, table, spec, 1.0)
    want = hg.hash_encode_reference(x, table, spec, 1.0)
    err = (got - want).abs().max().item()
    check(err <= 1e-5, f"giraffe hash_encode vs plain on the request's points: {err} <= 1e-5")
    inside = ~(x.abs() > 1.0).any(-1)
    x01 = ((x[inside] + 1.0) / 2.0).clamp(0.0, 1.0)
    corners = hg._corner_offsets(3)
    rows = sum(torch.unique(hg._level_index_weight(x01, spec, lvl, corners)[0]).numel()
               for lvl in range(spec.num_levels))
    c = spec.level_dim
    n, n_in = x.shape[0], int(inside.sum().item())
    nbytes = x.numel() * 4 + n * spec.num_levels * c * 4 + rows * c * 4
    flops = n_in * spec.num_levels * 8 * (2 * c + 2)
    return dict(points=n, oob_share=1.0 - n_in / n, max_abs_err=err, rows_read=rows,
                table_rows=spec.table_size, table_mb=spec.table_size * c * 4 / 1e6,
                ms=device_ms(lambda: hg.hash_encode(x, table, spec, 1.0), "hash_encode_kernel"),
                plain_ms=cuda_ms(lambda: hg.hash_encode_reference(x, table, spec, 1.0),
                                 iters=5, warmup=1),
                whole_table_bound_ms=(x.numel() * 4 + n * spec.num_levels * c * 4
                                      + spec.table_size * c * 4) / PEAK_HBM_BYTES * 1e3,
                **bound(flops, nbytes, PEAK_F32_FLOPS))


def giraffe_mesh_check(gcfg, g, g_cpu) -> dict:
    """Marching cubes on object 0's density at 64^3 on the card (at the
    middle of its alpha range, so that there is a surface), the alpha volume
    and the face count against the CPU's at that level."""
    import torch

    from sdface_gan_tpu_torch.giraffe import rendering
    from sdface_gan_tpu_torch.giraffe.generator import sample_latent_codes

    alphas, original = [], rendering.marching_cubes

    def recorded(alpha, level):
        alphas.append(alpha)
        return original(alpha, level)

    def extract(model, device, level=0.005):
        codes = sample_latent_codes(torch.Generator().manual_seed(2), gcfg, 1, tmp=0.65,
                                    device=device)
        return rendering.extract_giraffe_mesh(model, gcfg, codes, resolution=GIRAFFE_MESH_RES,
                                              level=level)

    rendering.marching_cubes = recorded
    try:
        extract(g, "cuda")
        level = float(0.5 * (alphas[0].min() + alphas[0].max()))
        t0 = time.perf_counter()
        card = extract(g, "cuda", level)
        seconds = time.perf_counter() - t0
        cpu = extract(g_cpu, "cpu", level)
    finally:
        rendering.marching_cubes = original
    err = float(abs(alphas[1] - alphas[2]).max())
    check(len(card.faces) > 0, "giraffe: marching cubes found a surface in the card's density")
    check(err <= 1e-5, f"giraffe: the card's alpha volume vs the CPU's {err} <= 1e-5")
    return dict(resolution=GIRAFFE_MESH_RES, level=level, faces=len(card.faces),
                faces_cpu=len(cpu.faces), alpha_max_abs_err_vs_cpu=err,
                alpha_max=float(alphas[1].max()), seconds=seconds)


def save_surface_model(g_cpu, td: str) -> None:
    """The surface model (``g_cpu``, ffhq_256's seeded plain generator, its
    density scaled by ``GIRAFFE_SURFACE_SIGMA``) as ``g_ema`` of
    ``out/giraffe_surface/model.pt`` in ``td``, with its yaml."""
    import copy

    import torch

    from sdface_gan_tpu_torch.utils.checkpoints import CheckpointIO

    g = copy.deepcopy(g_cpu)
    with torch.no_grad():
        g.decoder.sigma_out.weight.mul_(GIRAFFE_SURFACE_SIGMA)
        g.decoder.sigma_out.bias.mul_(GIRAFFE_SURFACE_SIGMA)
    CheckpointIO(os.path.join(td, "out", "giraffe_surface")).save("model", g_ema=g.state_dict())
    with open(os.path.join(td, "giraffe_surface.yaml"), "w") as f:
        f.write(GIRAFFE_SURFACE_YAML)


def ply_faces(path: str) -> int:
    with open(path, "rb") as f:
        head = f.read(512)
    check(head.startswith(b"ply\n"), f"{path} is a PLY file")
    for line in head.split(b"\n"):
        if line.startswith(b"element face "):
            return int(line.split()[-1])
    raise RuntimeError(f"check failed: {path} has no face element")


def giraffe_jobs(td: str) -> dict:
    """giraffe's CLI runs for stage C's wave, and the files they read: the
    surface model (ffhq_256's seeded plain generator, as :func:`giraffe`
    serves it, its density scaled) and a port-saved VAE ``encoder.pt``
    beside the committed JAX GIRAFFE run's import; then, in turn, the
    import (``import_jax_checkpoints --sdf 0``), ``render`` over the yaml's
    programs with ``--export_meshes 1``, ``render --vae 1`` on the committed
    image files and ``extract_mesh --n_meshes 2`` from it; beside them
    ``render --export_meshes 1`` and ``extract_mesh`` of the surface model."""
    import torch

    from sdface_gan_tpu_torch.encoder.vae import VAEEncoder, VAEEncoderConfig
    from sdface_gan_tpu_torch.utils.checkpoints import CheckpointIO

    _, g_plain_cpu = giraffe_model(GIRAFFE_CONFIG, {})
    save_surface_model(g_plain_cpu, td)
    del g_plain_cpu
    if not os.path.exists(os.path.join(td, "tests")):
        os.symlink(os.path.join(HERE, "tests"), os.path.join(td, "tests"))
    shutil.copy(os.path.join(GIRAFFE_FIXTURE, "jax_giraffe.yaml"), td)
    gcfg, _ = giraffe_model(os.path.join(td, "jax_giraffe.yaml"), GIRAFFE_FIXTURE_KW)
    e = VAEEncoder(VAEEncoderConfig(img_size=gcfg.neural_renderer.img_size,
                                    z_size=2 * gcfg.z_dim), torch.Generator().manual_seed(3))
    CheckpointIO(os.path.join(td, "out", "jax_giraffe")).save("encoder", e=e.state_dict())
    with open(os.path.join(td, "jax_giraffe_vae.yaml"), "w") as f:
        f.write("inherit_from: jax_giraffe.yaml\nrendering:\n  render_dir: rendering_vae\n")
    return {
        "giraffe_fixture": [
            ("import_jax_checkpoints", ["--src", os.path.join(GIRAFFE_FIXTURE, "run"),
                                        "--config", "jax_giraffe.yaml", "--sdf", "0",
                                        *GIRAFFE_FIXTURE_FLAGS]),
            ("render", ["--config", "jax_giraffe.yaml", "--export_meshes", "1",
                        *GIRAFFE_FIXTURE_FLAGS]),
            ("render", ["--config", "jax_giraffe_vae.yaml", "--vae", "1", "--vae_images",
                        GIRAFFE_IMAGES, *GIRAFFE_FIXTURE_FLAGS]),
            ("extract_mesh", ["--config", "jax_giraffe.yaml", "--n_meshes", "2",
                              *GIRAFFE_FIXTURE_FLAGS])],
        "giraffe_surface": [
            ("render", ["--config", "giraffe_surface.yaml", "--export_meshes", "1"]),
            ("extract_mesh", ["--config", "giraffe_surface.yaml", "--n_meshes", "2"])]}


def giraffe(results: dict, smi: str, td: str, cli: dict) -> None:
    """The GIRAFFE serving path on the card: the full-width generator with
    the plain, hash and small decoders against the CPU; the hash kernel on a
    request's box-local points; marching cubes; the committed JAX GIRAFFE
    run, imported in stage C's wave, served against JAX's images; and what
    the render and extract_mesh entries (``cli``, the runs of
    :func:`giraffe_jobs` in that wave) wrote."""
    import numpy as np
    import torch

    from sdface_gan_tpu_torch.data.png import decode_png
    from sdface_gan_tpu_torch.giraffe.generator import (
        GiraffeGenerator,
        LatentCodes,
        giraffe_forward,
    )
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.utils.checkpoints import CheckpointIO

    t_phase = time.perf_counter()
    plain, gcfg_plain, g_plain, g_plain_cpu, _ = serve_giraffe("plain", GIRAFFE_CONFIG, {}, False)
    emit(phase="giraffe_plain", nvidia_smi=smi, **plain)
    mesh = giraffe_mesh_check(gcfg_plain, g_plain, g_plain_cpu)
    emit(phase="giraffe_mesh", **mesh)
    del g_plain, g_plain_cpu
    hashed, gcfg_hash, g_hash, _, hash_inputs = serve_giraffe(
        "hash", GIRAFFE_HASH_CONFIG, dict(i_embed=1), True)
    encode = giraffe_encode_check(gcfg_hash, g_hash.decoder.hash_table, hash_inputs)
    emit(phase="giraffe_hash", nvidia_smi=smi, encode=encode, **hashed)
    del g_hash, hash_inputs
    small, _, g_small, _, _ = serve_giraffe("small", GIRAFFE_CONFIG, dict(small_net=1), True)
    emit(phase="giraffe_small", nvidia_smi=smi, **small)
    del g_small
    torch.cuda.empty_cache()

    # the committed JAX run, imported in the wave, and served
    out = os.path.join(td, "out", "jax_giraffe")
    ckpt = CheckpointIO(out)
    check(ckpt.exists("model") and ckpt.exists("model_0000004"),
          "import_jax_checkpoints --sdf 0 wrote model and model_0000004")
    gcfg, _ = giraffe_model(os.path.join(td, "jax_giraffe.yaml"), GIRAFFE_FIXTURE_KW)
    g = GiraffeGenerator(gcfg)
    g.load_state_dict(ckpt.load("model")["g_ema"])
    g = g.cuda().eval()
    with np.load(os.path.join(GIRAFFE_FIXTURE, "samples.npz")) as f:
        s = {k: torch.from_numpy(f[k]).cuda() for k in f.files}
    scene = dict(latent_codes=LatentCodes(s["z_shape_obj"], s["z_app_obj"], s["z_shape_bg"],
                                          s["z_app_bg"]),
                 camera_matrices=(s["camera_mat"], s["world_mat"]),
                 transformations=(s["s"], s["t"], s["r"]), bg_rotation=s["bg_rotation"],
                 mode="eval")
    _ext.reset_launch_counts()
    img = giraffe_forward(g, gcfg, **scene)
    torch.cuda.synchronize()
    jax_launches = _ext.LAUNCHES["hash_encode"]
    got, want = img.cpu().numpy(), s["images"].cpu().numpy()
    err = float(np.abs(got - want).max())
    bar = GIRAFFE_TOL + 2e-4 + 2e-3 * np.abs(want)
    check(got.shape == want.shape and bool(np.isfinite(got).all())
          and bool((np.abs(got - want) <= bar).all()),
          f"giraffe: the card's images of JAX's GIRAFFE model within the bar (max abs {err})")
    check(jax_launches >= 1, "giraffe: JAX's model rendered through the hash kernel")
    with zeroed_hash_encodes():
        img_zero = giraffe_forward(g, gcfg, **scene)
    jax_rec = dict(max_abs_err_vs_jax=err, bar="2e-3 + 2e-4 + 2e-3 |jax|",
                   encode_moves_image=(img - img_zero).abs().max().item(),
                   launches=dict(hash_encode=jax_launches),
                   import_s=cli["giraffe_fixture"]["command_s"][0])
    emit(phase="giraffe_jax_model", nvidia_smi=smi, **jax_rec)
    del g

    # what the entries wrote in the wave: from the fixture render (meshes),
    # render --vae and extract_mesh; from the surface model render (meshes)
    # and extract_mesh
    fixture_s, surface_s = cli["giraffe_fixture"]["command_s"], cli["giraffe_surface"]["command_s"]
    cli_s = dict(import_jax_checkpoints=fixture_s[0], render=fixture_s[1],
                 render_vae=fixture_s[2], extract_mesh=fixture_s[3],
                 render_surface=surface_s[0], extract_mesh_surface=surface_s[1])
    sheets = {}
    for render_dir in ("rendering", "rendering_vae"):
        for program in ("object_rotation", "interpolate_app"):
            path = os.path.join(out, render_dir, f"{program}.png")
            check(os.path.exists(path), f"render wrote {render_dir}/{program}.png")
            with open(path, "rb") as f:
                sheet = decode_png(f.read())
            check(sheet.shape == (16 * 32, 4 * 32, 3) and sheet.std() > 0,
                  f"{render_dir}/{program}.png: a 4 x 16 sheet of 32^2 frames")
            sheets[f"{render_dir}/{program}"] = list(sheet.shape)
    meshes = [os.path.join("rendering", f"{i:02d}_rotation.ply") for i in range(4)] + [
        os.path.join("meshes", f"mesh_{i:03d}.ply") for i in range(2)]
    # the fixture's density is flat (alpha within 2e-7 of 0.0028): no face
    # at the CLIs' level, as JAX's extraction finds none
    plys = {n: ply_faces(os.path.join(out, n)) for n in meshes}
    surface_out = os.path.join(td, "out", "giraffe_surface")
    surface_plys = {n: ply_faces(os.path.join(surface_out, n)) for n in meshes}
    check(all(f > 0 for f in surface_plys.values()),
          f"render --export_meshes and extract_mesh meshed the surface model ({surface_plys})")
    check(os.path.exists(os.path.join(surface_out, "rendering", "object_rotation.png")),
          "render wrote the surface model's object_rotation.png")
    check("conditioning on 4 real images" in cli["giraffe_fixture"]["stdouts"][2],
          "render --vae encoded the committed images")
    rec = dict(plain=plain, mesh=mesh, hash=hashed, hash_encode=encode, small=small,
               jax_model=jax_rec, sheets=sheets, ply_faces=plys, surface_ply_faces=surface_plys,
               cli_s=cli_s, cli_beside="stage C's wave",
               launches=dict(hash_encode=hashed["launches"]["hash_encode"]
                             + small["launches"]["hash_encode"] + jax_launches),
               seconds=time.perf_counter() - t_phase)
    results["giraffe"] = rec
    emit(phase="giraffe", nvidia_smi=smi, wall_s=rec["seconds"],
         **{k: v for k, v in rec.items() if k not in ("plain", "hash", "small")})


# The giraffe_train phase: GIRAFFE's and gan2d's training, after giraffe in
# train_cli's directory.  The full-width steps at the yamls' batch, each
# case: (yaml, model flags, hash decoder, VAE encoder step).
GIRAFFE_TRAIN_BATCH = 32  # training.batch_size of the GIRAFFE yamls (configs/default.yaml)
GIRAFFE_TRAIN_TIMED = 3  # timed steps per kind, the median, after one warm-up
GIRAFFE_TRAIN_CASES = {"plain": (GIRAFFE_CONFIG, {}, False, False),
                       "hash_vae": (GIRAFFE_HASH_CONFIG, dict(i_embed=1), True, True),
                       "small": (GIRAFFE_CONFIG, dict(small_net=1), True, False)}
GIRAFFE_TRAIN_TOL = (1e-4, 1e-3)  # loss rel, gradient of its norm (masked_parity's rule)
GIRAFFE_PARITY_BATCH, GAN2D_PARITY_BATCH = 2, 4
GIRAFFE_CUT_YAML = ("inherit_from: jax_giraffe.yaml\ntraining:\n  out_dir: out/giraffe_cut\n"
                    "  max_it: 100000\n  print_every: 1\n  checkpoint_every: 100000\n")
GIRAFFE_RESUME_YAML = ("inherit_from: jax_giraffe.yaml\ntraining:\n"
                       "  out_dir: out/jax_giraffe_train\n  max_it: 6\n")
GAN2D_YAML = (f"method: gan2d\ndata:\n  path: {GIRAFFE_IMAGES}\n  img_size: 64\n"
              "training:\n  out_dir: out/gan2d_64\n  batch_size: 8\n  max_it: 3\n"
              "  print_every: 1\n  visualize_every: 3\n  checkpoint_every: 3\n")


def giraffe_train_models(config: str, flags: dict, hashed: bool, vae: bool, device):
    """(run configs, G, D, G's EMA, their optimizers, VAE and its optimizer or
    None) of a yaml and flags on ``device``, as the train entry builds them
    from seed 0, G's hash table redrawn at std 1."""
    import types

    import torch

    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path
    from sdface_gan_tpu_torch.giraffe.train_loop import giraffe_models, giraffe_run_configs

    cfg = load_config(os.path.join(HERE, config), default_config_path())
    configs = giraffe_run_configs(cfg, types.SimpleNamespace(**flags))
    models = giraffe_models(configs, torch.Generator().manual_seed(0), device, vae)
    if hashed:
        table = models[0].decoder.hash_table
        with torch.no_grad():
            table.copy_(torch.randn(table.shape, generator=torch.Generator().manual_seed(0)))
    return (configs, *models)


def giraffe_heads(n: int, res: int, seed: int):
    """``n`` procedural heads [n, res, res, 3] in [0, 1] (``data.synthetic``)."""
    import numpy as np
    import torch

    from sdface_gan_tpu_torch.data.synthetic import render_head

    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([render_head(rng, res) for _ in range(n)])).float()


def giraffe_train_case(name: str, config: str, flags: dict, hashed: bool, vae: bool) -> dict:
    """D, G (and E) steps at full width and the yaml's batch on the card:
    median event ms of 3 after a warm-up, peak GB, the device's busy and
    idle share of each step (one profiled step), the hash kernels' launches
    per step kind; the hash G step's own encode inputs for the K1 check."""
    import torch

    from sdface_gan_tpu_torch.giraffe import trainer as tr
    from sdface_gan_tpu_torch.ops import _ext

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    configs, g, d, g_ema, g_opt, d_opt, e, e_opt = giraffe_train_models(config, flags, hashed,
                                                                        vae, "cuda")
    gcfg, hp = configs.generator, configs.hp
    b = GIRAFFE_TRAIN_BATCH
    reals = giraffe_heads(b, gcfg.neural_renderer.img_size, seed=5).cuda()
    gen = torch.Generator().manual_seed(1)
    steps = {"d": (lambda dr: tr.giraffe_d_step(g, d, d_opt, gcfg, hp, reals, dr),
                   tr.sample_scene_draws),
             "g": (lambda dr: tr.giraffe_g_step(g, d, g_opt, g_ema, gcfg, hp, dr),
                   tr.sample_scene_draws)}
    if vae:
        steps["e"] = (lambda dr: tr.giraffe_e_step(e, g, d, e_opt, gcfg, reals, dr),
                      tr.sample_encoder_draws)
    rec, hash_inputs = dict(config=config, flags=flags, batch=b,
                            image=gcfg.neural_renderer.img_size), None
    with torch.enable_grad():
        for kind, (step, sample) in steps.items():
            # the timed steps' draws are made first: the host's draw is timed apart
            draws = [sample(gen, gcfg, b, "cuda") for _ in range(GIRAFFE_TRAIN_TIMED)]
            t0 = time.perf_counter()
            warm = sample(gen, gcfg, b, "cuda")
            draw_ms = (time.perf_counter() - t0) * 1e3
            metrics = step(warm)
            torch.cuda.synchronize()
            _ext.reset_launch_counts()
            with plain_encodes_on_card() as plain:
                times = []
                for _ in range(GIRAFFE_TRAIN_TIMED):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    start.record()
                    step(draws.pop())
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
            launches = {k: _ext.LAUNCHES[k] for k in ("hash_encode", "hash_encode_backward",
                                                     "hash_encode_double_backward")}
            check(not plain, f"giraffe_train {name} {kind}: no plain encode on the card")
            check(all(torch.isfinite(v).all() for v in metrics.values()),
                  f"giraffe_train {name} {kind}: finite losses {metrics}")
            want = ("hash_encode_kernel", "hash_encode_backward_kernel") if (
                hashed and kind == "g") else ()
            if want:
                with recorded_hash_inputs() as seen:
                    step(sample(gen, gcfg, b, "cuda"))
                    torch.cuda.synchronize()
                hash_inputs = seen
            _, names, _ = profiled(lambda: step(sample(gen, gcfg, b, "cuda")), want=want)
            busy = sum(us for us, _ in names.values()) / 1e3
            ms = statistics.median(times)
            top = sorted(names.items(), key=lambda kv: -kv[1][0])[:5]
            # the profiled step's device time over the timed steps' median:
            # above 1 when the profiled step ran longer than that median
            rec[kind] = dict(ms=ms, times_ms=times, draw_ms=draw_ms, device_ms_total=busy,
                             busy_over_ms=busy / ms, idle_share=1.0 - busy / ms,
                             launches=launches,
                             kernels_profiled={k[:60]: names[k][1] for k in names
                                               if "hash_encode" in k},
                             top_device_ms={k[:80]: us / 1e3 for k, (us, _) in top},
                             losses={k: float(v) for k, v in metrics.items()})
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for kind in steps:
        k1 = rec[kind]["launches"]["hash_encode_backward"]
        check((k1 > 0) == (hashed and kind == "g"),
              f"giraffe_train {name}: K1 launched in G steps only ({kind}: {k1} in "
              f"{GIRAFFE_TRAIN_TIMED} steps)")
        check(rec[kind]["launches"]["hash_encode_double_backward"] == 0,
              f"giraffe_train {name} {kind}: no K2 (GIRAFFE has no eikonal)")
        check(not hashed or rec[kind]["launches"]["hash_encode"] > 0,
              f"giraffe_train {name} {kind}: the hash decoder's encodes on the kernel")
    if hashed:
        check(all(any(w in k for k in rec["g"]["kernels_profiled"])
                  for w in ("hash_encode_kernel", "hash_encode_backward_kernel")),
              f"giraffe_train {name}: the G step's profile names both hash kernels "
              f"({rec['g']['kernels_profiled']})")
    spec = g.decoder.cfg.hash_spec if hashed else None
    table = g.decoder.hash_table.detach() if hashed else None
    del g, d, g_ema, g_opt, d_opt, e, e_opt, reals
    torch.cuda.empty_cache()
    return rec, (spec, table, hash_inputs)


def giraffe_k1_check(spec, table, hash_inputs: list) -> dict:
    """K1 (the table gradient alone, as the G step asks it) against the plain
    VJP on a hash G step's own box-local points (bound 1) and its model's
    std-1 table, a random cotangent: <= 1e-5 of the plain gradient's norm;
    then timed at that shape by ``grad_kernel_case`` beside ``index_add_``."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    x = hash_inputs[0].reshape(-1, 3).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(44)
    cot = torch.randn((x.shape[0], spec.output_dim), generator=gen, device="cuda")
    _, got = hg.hash_encode_backward(x, table, cot, spec, 1.0, need_x=False, need_table=True)
    _, want = hg.hash_encode_backward_reference(x, table, cot, spec, 1.0, need_x=False,
                                                need_table=True)
    rel = ((got - want).norm() / want.norm()).item()
    check(rel <= GRAD_RTOL["float32"],
          f"giraffe_train: K1 vs the plain VJP on the G step's points, rel {rel}")
    oob = (x.abs() > 1.0).any(-1).float().mean().item()
    del got, want, cot
    timed = grad_kernel_case(spec, torch.float32, x, "backward", need_x=False, need_table=True,
                             box=1.0)
    return dict(points=x.shape[0], encodes_per_step=len(hash_inputs), oob_share=oob,
                max_rel_err=rel, **{k: timed[k] for k in (
                    "kernel", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "atomics")})


def giraffe_train_parity() -> dict:
    """One D, one G and one E step on the hash decoder at the fixture's cut
    width (``jax_giraffe.yaml``: 32^2, decoder 4 x 32, T = 2^10, a 16^2 x 16
    volume, batch 2), and one gan2d D and G step (64^2, the yaml defaults'
    widths, batch 4): the card against the CPU under ``masked_parity``."""
    import copy

    import torch

    from sdface_gan_tpu_torch.gan2d import trainer as g2
    from sdface_gan_tpu_torch.gan2d.generator import Gan2dGenerator, Gan2dGeneratorConfig
    from sdface_gan_tpu_torch.giraffe import trainer as tr
    from sdface_gan_tpu_torch.giraffe.discriminator import DCDiscConfig, DCDiscriminator

    flags = dict(i_embed=1, log2_hashmap_size=10, finest_res=64)
    configs, g, d, _, _, _, e, _ = giraffe_train_models(
        os.path.join(GIRAFFE_FIXTURE, "jax_giraffe.yaml"), flags, True, True, "cpu")
    gcfg = dataclasses.replace(configs.generator, n_ray_samples=16)
    b = GIRAFFE_PARITY_BATCH
    reals = giraffe_heads(b, gcfg.neural_renderer.img_size, seed=6)

    def draws(dev):
        """The same draws on either device (made on the host, mapped on ``dev``)."""
        gen = torch.Generator().manual_seed(2)
        scene = tr.sample_scene_draws(gen, gcfg, b, dev)
        return scene, tr.sample_encoder_draws(gen, gcfg, b, dev)

    def on(dev, *modules):
        return [copy.deepcopy(m).to(dev) for m in modules]

    def d_step(dev):
        gd, dd = on(dev, g, d)
        return tr.giraffe_d_loss(gd, dd, gcfg, configs.hp, reals.to(dev), draws(dev)[0])[0], \
            dd, None

    def g_step(dev):
        gd, dd = on(dev, g, d)
        with tr.frozen(dd):
            return tr.giraffe_g_loss(gd, dd, gcfg, draws(dev)[0])[0], gd, None

    def e_step(dev):
        ed, gd, dd = on(dev, e, g, d)
        with tr.frozen(gd, dd):
            return tr.giraffe_e_loss(ed, gd, dd, gcfg, reals.to(dev), draws(dev)[1])[0], ed, None

    g2cfg = Gan2dGeneratorConfig(size=64)
    g2d = Gan2dGenerator(g2cfg, torch.Generator().manual_seed(3))
    d2d = DCDiscriminator(DCDiscConfig(img_size=64), torch.Generator().manual_seed(4))
    z = g2.sample_z(torch.Generator().manual_seed(5), GAN2D_PARITY_BATCH, g2cfg.z_dim)
    reals64 = giraffe_heads(GAN2D_PARITY_BATCH, 64, seed=7)

    def gan2d_d(dev):
        gd, dd = on(dev, g2d, d2d)
        return g2.gan2d_d_loss(gd, dd, g2.Gan2dTrainHParams(), reals64.to(dev),
                               z.to(dev))[0], dd, None

    def gan2d_g(dev):
        gd, dd = on(dev, g2d, d2d)
        with tr.frozen(dd):
            return g2.gan2d_g_loss(gd, dd, z.to(dev))[0], gd, None

    steps = dict(giraffe_d=d_step, giraffe_g=g_step, giraffe_e=e_step, gan2d_d=gan2d_d,
                 gan2d_g=gan2d_g)
    with torch.enable_grad():
        return masked_parity("giraffe_train_parity", steps,
                             {k: GIRAFFE_TRAIN_TOL for k in steps})


def giraffe_train_jobs(td: str) -> dict:
    """giraffe_train's CLI runs in ``td`` (32^2 and 64^2 at batch 2-8), for
    ``run_modules_together``: ``import_jax_checkpoints --sdf 0`` of the
    committed JAX GIRAFFE run with every tree and ``train --sdf 0`` resuming
    it at it 5-6; a ``train --sdf 0 --exit-after 1`` run (exit 3) and its
    resume at it + 1 (exit 3 again); a ``method: gan2d`` yaml at 64^2 for 3
    iterations.  They time nothing, so they run beside train_stage_c's
    train processes; giraffe_train checks what they wrote."""
    if not os.path.exists(os.path.join(td, "tests")):
        os.symlink(os.path.join(HERE, "tests"), os.path.join(td, "tests"))
    shutil.copy(os.path.join(GIRAFFE_FIXTURE, "jax_giraffe.yaml"), td)
    for name, text in (("giraffe_cut.yaml", GIRAFFE_CUT_YAML),
                       ("jax_giraffe_train.yaml", GIRAFFE_RESUME_YAML),
                       ("gan2d_64.yaml", GAN2D_YAML)):
        with open(os.path.join(td, name), "w") as f:
            f.write(text)
    fixture_flags = ["--sdf", "0", *GIRAFFE_FIXTURE_FLAGS]
    cut = ["--config", "giraffe_cut.yaml", *fixture_flags, "--exit-after", "1"]
    return {
        "giraffe_resume": [
            ("import_jax_checkpoints", ["--src", os.path.join(GIRAFFE_FIXTURE, "run"),
                                        "--config", "jax_giraffe_train.yaml", *fixture_flags]),
            ("train", ["--config", "jax_giraffe_train.yaml", *fixture_flags])],
        "giraffe_cut": [("train", cut, 3), ("train", cut, 3)],
        "gan2d": [("train", ["--config", "gan2d_64.yaml", "--sdf", "0"])]}


def giraffe_train(results: dict, smi: str, td: str, cli: dict) -> None:
    """GIRAFFE's training on the card: the D, G and E steps at full width
    (``ffhq_256`` plain and small, ``ffhq_256_vae_hash --i_embed 1 --vae 1``)
    at batch 32, K1 on the hash G step's own points and the card against
    the CPU, alone on the card; then what the CLI runs of
    :func:`giraffe_train_jobs` (``cli``, run beside train_stage_c) wrote:
    the train entry from the committed JAX run, cut and resumed, and on a
    gan2d yaml."""
    import torch

    from sdface_gan_tpu_torch.utils.checkpoints import CheckpointIO

    t_phase = time.perf_counter()
    cases, k1_inputs = {}, None
    for name, (config, flags, hashed, vae) in GIRAFFE_TRAIN_CASES.items():
        cases[name], inputs = giraffe_train_case(name, config, flags, hashed, vae)
        emit(phase="giraffe_train_steps", case=name, nvidia_smi=smi, **cases[name])
        if name == "hash_vae":
            k1_inputs = inputs
    k1 = giraffe_k1_check(*k1_inputs)
    emit(phase="giraffe_train_k1", nvidia_smi=smi, **k1)
    del k1_inputs
    torch.cuda.empty_cache()
    parity = giraffe_train_parity()
    emit(phase="giraffe_train_parity", **parity)
    out = os.path.join(td, "out")
    rows = _train_rows(os.path.join(out, "jax_giraffe_train", "giraffe_metrics.jsonl"))
    check([r["step"] for r in rows if "generator" in r] == [5, 6],
          "giraffe_train: the imported JAX run resumed at it 5 and trained it 5-6")
    _finite_losses(rows, "giraffe_train resume")
    imported = CheckpointIO(os.path.join(out, "jax_giraffe_train")).load("model_0000004")
    check(set(imported) == {"g", "d", "g_ema", "it"}, "giraffe_train: model_0000004 imported")
    cut_rows = [r for r in _train_rows(os.path.join(out, "giraffe_cut", "giraffe_metrics.jsonl"))
                if "generator" in r]
    steps = [r["step"] for r in cut_rows]
    check(steps == list(range(1, len(steps) + 1)) and len(steps) >= 2
          and "resumed GIRAFFE from iteration" in cli["giraffe_cut"]["stdout"],
          "giraffe_train: --exit-after exits 3 and the next run resumes at it + 1")
    resumed_at = int(cli["giraffe_cut"]["stdout"].split("resumed GIRAFFE from iteration")[1]
                     .split()[0])
    _finite_losses(cut_rows, "giraffe_train cut")
    g2_rows = _train_rows(os.path.join(out, "gan2d_64", "gan2d_metrics.jsonl"))
    check([r["step"] for r in g2_rows] == [1, 2, 3], "giraffe_train: gan2d trained 3 iterations")
    _finite_losses(g2_rows, "giraffe_train gan2d")
    check(os.path.exists(os.path.join(out, "gan2d_64", "vis_0000003.png")),
          "giraffe_train: gan2d wrote its grid")
    launches = {k: sum(c[kind]["launches"][k] for c in cases.values() for kind in ("d", "g", "e")
                       if kind in c) for k in ("hash_encode", "hash_encode_backward")}
    rec = dict(steps=cases, k1=k1, parity=parity, launches=launches,
               cli_s={k: v["seconds"] for k, v in cli.items()}, cut_resumed_at=resumed_at,
               cut_iterations=len(steps), seconds=time.perf_counter() - t_phase)
    results["giraffe_train"] = rec
    emit(phase="giraffe_train", nvidia_smi=smi, **{k: v for k, v in rec.items()
                                                   if k not in ("steps", "parity")})


# The evaluate phase: evaluation and geometry over train_cli's artifacts.
EVAL_HEADS, EVAL_HEAD_RES = 48, 256
EVAL_DUMP_IMAGES, EVAL_RATE_IMAGES, EVAL_NGP_IMAGES = 48, 128, 32
SURFACE_RES = 128
INCEPTION_TOL = 1e-4  # card vs CPU, TF32 off, of max |activation|
ALIGN_TOL = 1e-6


@contextlib.contextmanager
def plain_fields_on_card():
    """Count the calls of the plain SIREN field (the fused field's plain
    version, and the field module's own forward) on CUDA tensors while the
    block runs; eval's path on the card makes none."""
    from sdface_gan_tpu_torch.models import siren
    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    calls = []
    reference, forward = sk.siren_field_reference, siren.SirenGenerator.forward_parts

    def counted_reference(pack, pts, *args, **kwargs):
        if pts.is_cuda:
            calls.append("siren_field_reference")
        return reference(pack, pts, *args, **kwargs)

    def counted_forward(self, pts, *args, **kwargs):
        if pts.is_cuda:
            calls.append("SirenGenerator.forward_parts")
        return forward(self, pts, *args, **kwargs)

    sk.siren_field_reference = counted_reference
    siren.SirenGenerator.forward_parts = counted_forward
    try:
        yield calls
    finally:
        sk.siren_field_reference = reference
        siren.SirenGenerator.forward_parts = forward


def run_eval(td: str, args: list, kernels: tuple, n_batches: int) -> dict:
    """``sdface_gan_tpu_torch.eval.main(args)`` in this process, in ``td``:
    the launch counts of the run (each of ``kernels`` once per batch), no
    plain field or plain encode on the card, the entry's printed lines."""
    import io

    import torch

    from sdface_gan_tpu_torch import eval as eval_cli
    from sdface_gan_tpu_torch.ops import _ext

    out = io.StringIO()
    torch.cuda.synchronize()
    _ext.reset_launch_counts()
    with contextlib.chdir(td), plain_fields_on_card() as fields, \
            plain_encodes_on_card() as encodes, contextlib.redirect_stdout(out):
        stats = eval_cli.main(args)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    text = out.getvalue()
    for name in kernels:
        check(launches[name] == n_batches,
              f"eval {' '.join(args)}: {name} launched {launches[name]} times in {n_batches} "
              "batches")
    check(not fields and not encodes, f"eval {' '.join(args)}: no plain field or encode on "
          f"the card ({len(fields)} fields, {len(encodes)} encodes)")
    check("precision: f32 matmuls and convolutions without TF32" in text, "eval turns TF32 off")
    n = stats["n_images"]
    warm_s = stats["seconds"] - stats["seconds_first_batch"]
    rates = dict(images_per_s=n / stats["seconds"],
                 warm_images_per_s=(n - n // n_batches) / warm_s if n_batches > 1 else None)
    return dict(stats=stats, launches=launches, lines=text.strip().splitlines()[-2:], **rates)


def eval_kernel_names(td: str, args: list) -> list:
    """Names of the CUDA kernels one short eval run launches (profiler)."""
    import io

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdface_gan_tpu_torch import eval as eval_cli

    with contextlib.chdir(td), contextlib.redirect_stdout(io.StringIO()), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eval_cli.main(args)
        torch.cuda.synchronize()
    return [ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]


# every process run_modules_together starts, so that main can stop those
# still running when a phase fails while a wave runs in the background
STARTED: list = []


def run_modules_together(jobs: dict, cwd: str) -> dict:
    """Run the jobs at once, each a list of ``(module, args)`` or ``(module,
    args, rc)`` run in turn as ``python -m sdface_gan_tpu_torch.<module>
    <args>`` (``python -m <module>`` for a ``torch.*`` module: the
    launcher); every command must exit ``rc`` (0 if not given; else the other
    processes are killed and this raises).  Returns each job's last
    command's output, the job's seconds, and each command's own seconds and
    output."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    # two host threads each: a wave runs more processes than the host has
    # cores, and each would start a pool of one thread per core; the card's
    # allocator grows its segments in place, which keeps the processes that
    # share the card from holding unusable reserved memory
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **{k: "2" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")},
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    live, lock, t0 = [], threading.Lock(), time.perf_counter()

    def chain(commands):
        each, outs = [], []
        for module, args, *rc in commands:
            t_cmd = time.perf_counter()
            target = module if module.startswith("torch.") else f"sdface_gan_tpu_torch.{module}"
            with lock:
                proc = subprocess.Popen([sys.executable, "-m", target, *args], cwd=cwd, env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                live.append(proc)
                STARTED.append(proc)
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
            want = rc[0] if rc else 0
            check(proc.returncode == want, f"{module} {' '.join(args)} exited {proc.returncode},"
                  f" expected {want}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
            each.append(time.perf_counter() - t_cmd)
            outs.append(stdout)
        return dict(rc=proc.returncode, seconds=time.perf_counter() - t0, stdout=stdout,
                    command_s=each, stdouts=outs)

    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = {name: pool.submit(chain, commands) for name, commands in jobs.items()}
            return {name: future.result() for name, future in futures.items()}
    finally:
        with lock:
            for proc in live:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def chained(jobs: dict, after: dict) -> tuple:
    """``jobs`` with each job named as a key of ``after`` followed, in one
    chain, by the job named as its value (which then starts only when the
    first ends), for ``run_modules_together``; and a function that splits
    its result back into both jobs' results."""
    merged, marks = dict(jobs), {}
    for first, then in after.items():
        marks[then] = (first, len(merged[first]))
        merged[first] = merged[first] + merged.pop(then)

    def split(runs: dict) -> dict:
        runs = dict(runs)
        for then, (first, n) in marks.items():
            r = runs[first]
            for name, part in ((first, slice(None, n)), (then, slice(n, None))):
                runs[name] = dict(rc=r["rc"] if name == then else 0, stdout=r["stdouts"][part][-1],
                                  seconds=sum(r["command_s"][part]),
                                  command_s=r["command_s"][part], stdouts=r["stdouts"][part])
        return runs

    return merged, split


class Background:
    """``fn()`` started now on a thread and awaited by :meth:`result`: a wave
    of untimed processes (``run_modules_together``) that runs while this
    process goes on with untimed work of its own."""

    def __init__(self, fn):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(1)
        self._future = self._pool.submit(fn)

    def result(self):
        try:
            return self._future.result()
        finally:
            self._pool.shutdown()


class CardMemory:
    """The card's used memory (every process's, from ``cudaMemGetInfo``)
    sampled on a thread every 0.2 s until :meth:`stop`, which returns its
    peak in GB."""

    def __init__(self):
        import threading

        self._stop, self._peak = threading.Event(), 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import torch

        while not self._stop.wait(0.2):
            free, total = torch.cuda.mem_get_info()
            self._peak = max(self._peak, total - free)

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return self._peak / 1e9


def stop_started() -> None:
    """Kill the processes of :func:`run_modules_together` still running."""
    for proc in STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def closed_mesh(faces) -> bool:
    """Every edge shared by exactly two triangles."""
    from collections import Counter

    edges = Counter()
    for f in faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            edges[(min(a, b), max(a, b))] += 1
    return set(edges.values()) == {2}


def surface_probe(td: str) -> dict:
    """sdf_mesh's surface probe on the SIREN artifact, in this process: its
    time at 128^3 (the f32 field kernel at B = 1, P = 2,097,152 inside), the
    volume's frustum alignment on the card against the CPU, and the kernel
    alone at that shape beside its plain version and bound."""
    import torch

    from sdface_gan_tpu_torch import sdf_mesh
    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.build import generator_config, stage_options
    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.geometry.mesh import align_volume
    from sdface_gan_tpu_torch.models import Generator, mean_latent
    from sdface_gan_tpu_torch.ops import siren_kernel as sk
    from sdface_gan_tpu_torch.training.loop import copy_matching
    from sdface_gan_tpu_torch.utils.checkpoints import load_generator

    with contextlib.chdir(td):
        cfg = load_config(CLI_CONFIG)
    view_cfg, surf_cfg = sdf_mesh.mesh_configs(
        generator_config(stage_options(cfg, False), stage_a=False), SURFACE_RES)
    full = load_generator(os.path.join(td, "out", CLI_EXP), "full_pipeline", view_cfg,
                          device="cuda")
    surf = Generator(surf_cfg, device="cuda")
    copy_matching(surf, full.state_dict())
    surf.eval()
    pack = sk.pack_siren_field(surf.renderer.network)
    front = generate_camera_params(SURFACE_RES, batch=1,
                                   locations=torch.zeros((1, 2), device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn((1, surf_cfg.style_dim), device="cuda", generator=gen)
    trunc = mean_latent(full, gen)
    probe_ms = cuda_ms(lambda: sdf_mesh.probe_surface(surf, surf_cfg, z, front, trunc, 0.5,
                                                      pack), iters=3, warmup=1)
    sdf = sdf_mesh.probe_surface(surf, surf_cfg, z, front, trunc, 0.5, pack)
    check(tuple(sdf.shape) == (1,) + (SURFACE_RES,) * 3 + (1,) and bool(torch.isfinite(sdf).all()),
          "surface probe volume")
    on_card = align_volume(sdf)
    on_cpu = align_volume(sdf.cpu())
    align_err = (on_card.cpu() - on_cpu).abs().max().item()
    check(torch.equal(on_card.cpu() == 1.0, on_cpu == 1.0) and align_err <= ALIGN_TOL,
          f"align_volume card vs CPU: max abs {align_err} <= {ALIGN_TOL}")
    align_ms = cuda_ms(lambda: align_volume(sdf), iters=5)

    # the field kernel alone at the probe's shape
    net = surf.renderer.network
    pts, views, style = field_inputs(net, 1, SURFACE_RES ** 3, 16)
    gamma, beta = sk.film_coeffs(net, style)
    args = (pack, pts, views, gamma, beta)
    ms = cuda_ms(lambda: sk.siren_field_fused_parts(*args), iters=5)
    plain_ms = cuda_ms(lambda: sk.siren_field_reference(*args), iters=2, warmup=1)
    flops = field_flops(DEPTH, WIDTH) * SURFACE_RES ** 3
    kernel = dict(kernel=sk.kernel_name(torch.float32), batch=1, points=SURFACE_RES ** 3, ms=ms,
                  plain_ms=plain_ms,
                  **bound(flops, field_bytes(pack, 1, SURFACE_RES ** 3), PEAK_F32_FLOPS))
    # and at a rank's band of the ray-sharded probe over DDP_WORLD ranks
    p_rank = SURFACE_RES ** 3 // DDP_WORLD
    band = (pack, pts[:, :p_rank].contiguous(), views[:, :p_rank].contiguous(), gamma, beta)
    per_rank = dict(points=p_rank, ms=cuda_ms(lambda: sk.siren_field_fused_parts(*band), iters=5),
                    plain_ms=cuda_ms(lambda: sk.siren_field_reference(*band), iters=2, warmup=1),
                    **bound(field_flops(DEPTH, WIDTH) * p_rank, field_bytes(pack, 1, p_rank),
                            PEAK_F32_FLOPS))
    del args, band, pts, views, full, surf
    torch.cuda.empty_cache()
    return dict(probe_surface_ms=probe_ms, align_volume_ms=align_ms,
                align_max_abs_err=align_err, sdf_range=[sdf.min().item(), sdf.max().item()],
                field_at_probe_shape=kernel, field_at_rank_band=per_rank)


def inception_checks() -> dict:
    """The FID Inception on the card against the CPU (same random weights,
    TF32 off) at 256^2 (grows to 299) and 512^2 (shrinks, antialiased), and
    its device time per batch of 8 at 256^2."""
    import torch

    from sdface_gan_tpu_torch.evaluation import load_inception

    card, cpu = load_inception(device="cuda"), load_inception(device="cpu")
    errs = {}
    for size in (256, 512):
        x = torch.rand((4, size, size, 3), generator=torch.Generator().manual_seed(size)) * 2 - 1
        want = cpu(x)
        got = card(x.cuda()).cpu()
        errs[size] = ((got - want).abs().max() / want.abs().max()).item()
        check(errs[size] <= INCEPTION_TOL, f"Inception card vs CPU at {size}^2: {errs[size]} "
              f"of max |activation| <= {INCEPTION_TOL}")
    x8 = torch.rand((8, 256, 256, 3), device="cuda") * 2 - 1
    ms = cuda_ms(lambda: card(x8), iters=10)
    # the card's busy time inside that: the kernels' device time (profiler)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            card(x8)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None)
            kernels[ev.key] = (us if us is not None else ev.cuda_time_total) / 5 / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    return dict(rel_err_256=errs[256], rel_err_512=errs[512], ms_per_batch_of_8=ms,
                device_busy_ms_per_batch_of_8=sum(kernels.values()),
                top=[(k[:80], v) for k, v in top])


def marching_cubes_check() -> dict:
    """Marching cubes on a sphere SDF made on the card at 128^3: a closed
    mesh of the right radius, and its host seconds."""
    import torch

    from sdface_gan_tpu_torch import native

    lin = torch.linspace(-1, 1, SURFACE_RES, device="cuda")
    x, y, z = torch.meshgrid(lin, lin, lin, indexing="ij")
    vol = (torch.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.5).cpu().numpy()
    t0 = time.perf_counter()
    verts, faces = native.marching_cubes(vol, 0.0)
    seconds = time.perf_counter() - t0
    import numpy as np

    r = np.linalg.norm(verts / (SURFACE_RES - 1) * 2 - 1, axis=1)
    check(abs(float(r.mean()) - 0.5) < 0.01 and float(r.std()) < 0.01 and closed_mesh(faces),
          "marching cubes: a closed sphere of radius 0.5")
    return dict(resolution=SURFACE_RES, seconds=seconds, verts=len(verts), faces=len(faces))


@contextlib.contextmanager
def timed_fid():
    """Seconds spent inside the FID's ``calculate_frechet_distance`` (its
    2048^2 ``sqrtm`` on the host) while the block runs, as a list of calls;
    the values pass through untouched."""
    from sdface_gan_tpu_torch import evaluation

    original, seconds = evaluation.calculate_frechet_distance, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    evaluation.calculate_frechet_distance = timed
    try:
        yield seconds
    finally:
        evaluation.calculate_frechet_distance = original


def timed_eval(td: str, name: str, timings: dict, *args, profile_names: bool = False) -> dict:
    """:func:`run_eval` of ``args``, its wall seconds and its FID's seconds
    put under ``name`` in ``timings`` ({"eval_main_s": ..., "fid_s": ...});
    with ``profile_names`` the run is profiled whole and its CUDA kernels'
    names returned too."""
    t0 = time.perf_counter()
    with timed_fid() as seconds:
        if profile_names:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = run_eval(td, *args)
            out["kernel_names"] = [ev.key for ev in prof.key_averages()
                                   if ev.device_type == DeviceType.CUDA]
        else:
            out = run_eval(td, *args)
    timings["eval_main_s"][name] = time.perf_counter() - t0
    timings["fid_s"][name] = sum(seconds)
    return out


EVAL_COMMON = ("--config", CLI_CONFIG, "--sdf", "1", "--batch", str(BATCH))


def evaluate_beside(td: str) -> dict:
    """evaluate's untimed eval runs, in this process while train_cli's wave
    runs (they time nothing, so the card may be shared): f32 with the PNG
    dump against the heads' store (FID and KID), profiled whole for its
    field kernel's name, and a short profiled bf16 run; each through its
    kernel by launch count, no plain field on the card."""
    import gc

    import numpy as np
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    timings = dict(eval_main_s={}, fid_s={})
    dump = timed_eval(td, "dump", timings, [*EVAL_COMMON, "--n_images", str(EVAL_DUMP_IMAGES),
                                            "--real_dir", "heads"],
                      ("siren_field",), EVAL_DUMP_IMAGES // BATCH, profile_names=True)
    check(all(np.isfinite(dump["stats"][k]) for k in ("fid", "kid_mean", "kid_std")),
          "eval f32: finite FID and KID")
    dumped = sorted(os.listdir(os.path.join(td, "out", CLI_EXP, "eval")))
    check(dumped == [f"{i:07d}.png" for i in range(EVAL_DUMP_IMAGES)], "eval dumped its PNGs")
    t0 = time.perf_counter()
    names = {"float32": dump["kernel_names"],
             "bfloat16": eval_kernel_names(td, [*EVAL_COMMON, "--n_images", str(BATCH),
                                                "--no_dump", "--no_fid", "--g_dtype",
                                                "bfloat16"])}
    timings["eval_main_s"]["bfloat16_names"] = time.perf_counter() - t0
    return dict(dump=dump, names=names, timings=timings)


def evaluate(results: dict, smi: str, td: str, first: dict, beside: dict) -> None:
    """The port's evaluation and geometry tools over train_cli's artifacts
    (``ffhq256_sdf_tpu``, ``ffhq256_sdf_ngp_tpu``, in ``td``): what
    ``beside`` (:func:`evaluate_beside`, during train_cli's wave) found;
    eval in this process, alone on the card: bf16 and f32 with
    ``--no_dump`` against the heads' stats, timed, and NGP, each through its
    kernels by launch count; each dtype's field kernel by name; what
    ``first`` (train_cli's wave: both probe stages and sdf_mesh) printed and
    wrote; the Inception, align_volume and marching cubes checked on the
    card; the surface probe timed.  eval_files scores the dump in stage C's
    wave (:func:`evaluate_files`)."""
    import gc

    import numpy as np
    import torch

    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    common = list(EVAL_COMMON)
    dump, names, timings = beside["dump"], beside["names"], beside["timings"]
    evals_s, fid_s = timings["eval_main_s"], timings["fid_s"]

    rate_args = common + ["--n_images", str(EVAL_RATE_IMAGES), "--no_dump",
                          "--fid_file", "heads_stats.npz"]
    rate = {}
    for dtype in ("bfloat16", "float32"):
        rate[dtype] = timed_eval(td, dtype, timings, rate_args + ["--g_dtype", dtype],
                                 ("siren_field",), EVAL_RATE_IMAGES // BATCH)
        check(np.isfinite(rate[dtype]["stats"]["fid"]), f"eval {dtype} --no_dump: finite FID")
    for dtype, other in (("float32", "bfloat16"), ("bfloat16", "float32")):
        mine, theirs = sk.kernel_name(getattr(torch, dtype)), sk.kernel_name(getattr(torch, other))
        check(any(mine in k for k in names[dtype]) and not any(theirs in k for k in names[dtype]),
              f"eval --g_dtype {dtype} runs {mine} and not {theirs}")
    ngp = timed_eval(td, "ngp", timings, ["--config", CLI_NGP_CONFIG, "--sdf", "1", "--batch",
                                          str(BATCH), "--n_images", str(EVAL_NGP_IMAGES),
                                          "--no_dump", "--no_fid"],
                     ("hash_encode", "table_gather"), EVAL_NGP_IMAGES // BATCH)
    eval_rec = dict(
        dump=dict(n_images=EVAL_DUMP_IMAGES, fid=dump["stats"]["fid"],
                  kid=[dump["stats"]["kid_mean"], dump["stats"]["kid_std"]],
                  launches=dump["launches"]["siren_field"], seconds=dump["stats"]["seconds"],
                  profiled=True, card_shared_with="train_cli's wave"),
        no_dump={d: dict(n_images=EVAL_RATE_IMAGES, fid=r["stats"]["fid"],
                         launches=r["launches"]["siren_field"], seconds=r["stats"]["seconds"],
                         images_per_s=r["images_per_s"],
                         warm_images_per_s=r["warm_images_per_s"]) for d, r in rate.items()},
        ngp=dict(n_images=EVAL_NGP_IMAGES, seconds=ngp["stats"]["seconds"],
                 images_per_s=ngp["images_per_s"], warm_images_per_s=ngp["warm_images_per_s"],
                 launches={k: ngp["launches"][k] for k in ("hash_encode", "table_gather")}),
        kernel_by_name={d: [k[:60] for k in v if "siren_field" in k] for d, v in names.items()},
        lines=dump["lines"] + rate["bfloat16"]["lines"], eval_main_s=evals_s, fid_s=fid_s,
        seconds=sum(evals_s.values()))
    emit(phase="evaluate_eval", nvidia_smi=smi, **eval_rec)
    gc.collect()
    torch.cuda.empty_cache()

    verdicts = {}
    for stage in ("a", "b"):
        lines = first[f"probe_{stage}"]["stdout"].splitlines()
        verdict = [ln for ln in lines if ln.startswith("verdict:")]
        check(len(verdict) == 1 and sum(ln.startswith("id") for ln in lines) == 4,
              f"probe stage {stage}: four identities and a verdict")
        verdicts[stage] = dict(verdict=verdict[0], ids=[ln for ln in lines if ln.startswith("id")])
    renders = os.listdir(os.path.join(td, "out", CLI_EXP, "renders"))
    check(len(renders) == 2 * 16, f"sdf_mesh wrote {len(renders)} view PNGs (32 expected)")
    mesh_lines = [ln for ln in first["sdf_mesh"]["stdout"].splitlines() if ln.startswith("id")]
    objs = sorted(n for n in os.listdir(os.path.join(td, "out", CLI_EXP, "meshes"))
                  if n.endswith(".obj"))
    for ident in range(2):
        check(f"id{ident:03d}.obj" in objs or any(
            ln.startswith(f"id{ident}: marching cubes failed") for ln in mesh_lines),
              f"sdf_mesh: identity {ident} has a mesh or its failure line")
    cli_rec = dict(seconds={k: v["seconds"] for k, v in first.items()},
                   beside="train_cli's rerun and NGP run", probe=verdicts,
                   sdf_mesh=mesh_lines, objs=objs)
    emit(phase="evaluate_cli", **cli_rec)

    checks = dict(inception=inception_checks(), surface=surface_probe(td),
                  marching_cubes=marching_cubes_check())
    emit(phase="evaluate_checks", nvidia_smi=smi, **checks)
    wall = time.perf_counter() - t_phase
    results["evaluate"] = dict(eval=eval_rec, cli=cli_rec, checks=checks, wall_s=wall)
    emit(phase="evaluate", nvidia_smi=smi, wall_s=wall,
         eval_images_per_s={d: r["images_per_s"] for d, r in rate.items()},
         eval_warm_images_per_s={d: r["warm_images_per_s"] for d, r in rate.items()},
         ngp_eval_images_per_s=ngp["images_per_s"], fid=dump["stats"]["fid"],
         kid=dump["stats"]["kid_mean"],
         inception_ms_per_batch_of_8=checks["inception"]["ms_per_batch_of_8"],
         inception_device_busy_ms=checks["inception"]["device_busy_ms_per_batch_of_8"],
         probe_surface_ms=checks["surface"]["probe_surface_ms"],
         marching_cubes_s=checks["marching_cubes"]["seconds"],
         probe_verdicts={k: v["verdict"] for k, v in verdicts.items()},
         sdf_mesh=mesh_lines, eval_main_s=evals_s, fid_s=fid_s)


def evaluate_files_jobs() -> dict:
    """eval_files on eval's dump against the heads' stats, for stage C's wave."""
    return {"eval_files": [("eval_files", [os.path.join("out", CLI_EXP, "eval"), "--fid_file",
                                           "heads_stats.npz", "--batch", "16"])]}


def evaluate_files(results: dict, files: dict) -> None:
    import numpy as np

    fid_line = [ln for ln in files["stdout"].splitlines() if ln.startswith("FID:")]
    check(len(fid_line) == 1 and np.isfinite(float(fid_line[0].split()[1])), "eval_files FID")
    rec = dict(eval_files_fid=float(fid_line[0].split()[1]), seconds=files["seconds"],
               beside="stage C's wave")
    results["evaluate"]["cli"]["eval_files"] = rec
    emit(phase="evaluate_files", **rec)


# The bench phase: the port's benches as a user runs them, then in this
# process under the profiler.
BENCH_NGP_LINES = 1 + 3 + 1 + 3  # the card, the hash grid, stage A, three serving grids


def bench_lines(stdout: str) -> list:
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def profiled(fn, want: tuple = (), tries: int = 3) -> tuple:
    """Run ``fn()`` (its printed lines kept from stdout) under the profiler:
    the launch counts of the call, its CUDA kernels by name with their
    (device microseconds, launches), and the plain fields and plain encodes
    it ran on CUDA tensors.  The profiler can drop a session's device
    records: each session idles ``bench.PROFILE_MARGIN_S`` at both ends,
    and one that shows no kernel named by one of ``want`` is run again, up
    to ``tries`` sessions (counts and names of the last one; the plain runs
    of all)."""
    import io

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdface_gan_tpu_torch.bench import PROFILE_MARGIN_S
    from sdface_gan_tpu_torch.ops import _ext

    plain = []
    for _ in range(tries):
        torch.cuda.synchronize()
        _ext.reset_launch_counts()
        with plain_fields_on_card() as fields, plain_encodes_on_card() as encodes, \
                contextlib.redirect_stdout(io.StringIO()), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        plain += fields + [f"encode of {n} points" for n in encodes]
        names = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                us = getattr(ev, "device_time_total", None)
                names[ev.key] = (us if us is not None else ev.cuda_time_total, ev.count)
        if all(any(w in k for k in names) for w in want):
            break
    return dict(_ext.LAUNCHES), names, plain


def bench(results: dict, smi: str) -> None:
    """``python -m sdface_gan_tpu_torch.bench`` and ``... .bench_ngp`` at their
    defaults, one after the other: exit 0, every line's value finite and
    positive, the card named, each kernel launched in its timed loop; then
    the benches' calls in this process, counted and profiled: the bf16
    field kernel ``siren_field_mma_kernel<256>`` in the bench's sampler (at
    its batch, 32), ``hash_encode`` and K1 in the hash-grid bench's
    functions, ``table_gather``
    and ``hash_encode`` in the packed serving arm, no plain field or plain
    encode on the card."""
    import gc
    import math

    import torch

    from sdface_gan_tpu_torch import bench as bench_mod
    from sdface_gan_tpu_torch import bench_ngp
    from sdface_gan_tpu_torch.ops import siren_kernel as sk
    from sdface_gan_tpu_torch.ops.hash_encoder import HashGridSpec
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # leave the card to the bench processes
    runs = {module: run_module(module, [], HERE) for module in ("bench", "bench_ngp")}
    serve_rec = bench_lines(runs["bench"]["stdout"])
    ngp_recs = bench_lines(runs["bench_ngp"]["stdout"])
    check(len(serve_rec) == 1 and len(ngp_recs) == BENCH_NGP_LINES,
          f"bench printed {len(serve_rec)} line, bench_ngp {len(ngp_recs)} lines")
    serve_rec = serve_rec[0]
    check(ngp_recs[0]["devices"] == [smi], f"bench_ngp names the card: {ngp_recs[0]}")
    for rec in [serve_rec] + ngp_recs[1:]:
        check(math.isfinite(rec["value"]) and rec["value"] > 0 and rec["device"] == smi
              and rec.get("finite", True), f"bench line: {rec}")
    check(serve_rec["batch"] == bench_mod.BATCH
          and serve_rec["launches"]["siren_field"] == bench_mod.ITERS,
          f"bench: batch {bench_mod.BATCH}, the field kernel once per timed iteration")
    by_metric = {r["metric"]: r for r in ngp_recs[1:]}
    hash_fwd = by_metric[bench_ngp.HASH_METRICS["forward"].format(levels=16)]
    hash_bwd = by_metric[bench_ngp.HASH_METRICS["table_grad"]]
    packed = by_metric[bench_ngp.SERVING_METRIC.format(name="tuned 4xdim8 + packed 64MB")]
    stage_a = next(r for r in ngp_recs if r.get("unit") == "it/sec")
    check(hash_fwd["launches"]["hash_encode"] >= 1 and hash_bwd["launches"][
        "hash_encode_backward"] >= 1 and packed["launches"]["table_gather"] >= 1
          and stage_a["launches"]["hash_encode_backward"] >= 1,
          "bench_ngp: hash_encode, K1 and table_gather launched in their timed loops")
    cli_s = {m: r["seconds"] for m, r in runs.items()}
    emit(phase="bench_cli", nvidia_smi=smi, seconds=cli_s,
         bench={k: serve_rec[k] for k in ("value", "unit", "mrays_per_sec", "iter_ms_median",
                                          "iter_ms_max", "iter_ms", "launches")},
         bench_ngp=[{k: r.get(k) for k in ("metric", "value", "unit", "ms", "calls",
                                           "kernel_device_ms", "iter_ms_median",
                                           "iter_ms_max", "launches")} for r in ngp_recs[1:]])

    # in this process: the same calls, counted and profiled
    device = torch.device("cuda")
    sampler = SDFaceSampler(bench_mod.serving_model(bench_mod.flagship_config(), device),
                            batch=bench_mod.BATCH, truncation=bench_mod.TRUNCATION)
    sampler.sample(seed=1)
    field = sk.kernel_name(torch.bfloat16) + "<256>"
    launches, names, plain = profiled(lambda: sampler.sample(seed=1), want=(field,))
    check(launches["siren_field"] == 1 and any(field in k for k in names)
          and not any(sk.kernel_name(torch.float32) in k for k in names) and not plain,
          f"bench sampler: one {field} launch, by name, no plain field ({plain})")
    in_process = {"bench": launches}
    del sampler
    gc.collect()
    torch.cuda.empty_cache()
    spec = HashGridSpec.create(desired_resolution=4096)
    fns = bench_ngp.hash_functions(*bench_ngp.hash_inputs(spec, bench_ngp.HASH_POINTS, device),
                                   spec)
    rows = tuple(HASH_KERNEL_ROWS[k] for k in ("hash_encode", "hash_encode_backward"))
    launches, names, plain = profiled(lambda: [fn() for _ in range(3) for fn in fns.values()],
                                      want=rows)
    for kernel in ("hash_encode", "hash_encode_backward"):
        check(launches[kernel] >= 1 and any(HASH_KERNEL_ROWS[kernel] in k for k in names),
              f"bench_ngp hash grid: {kernel} launched ({launches[kernel]}), by name "
              f"(the profiler kept {[k[:48] for k in names][:16]})")
    check(not plain, f"bench_ngp hash grid: no plain encode on the card ({plain})")
    in_process["bench_ngp_hash"] = launches
    del fns
    tuned = "tuned 4xdim8 + packed 64MB"
    launches, names, plain = profiled(lambda: bench_ngp.bench_ngp_serving(configs={
        tuned: bench_ngp.ngp_serving_config(bench_ngp.SERVING_GRIDS[tuned])}, iters=1),
        want=("table_gather_kernel", "hash_encode_kernel"))
    for kernel in ("table_gather", "hash_encode"):
        check(launches[kernel] >= 1 and any(f"{kernel}_kernel" in k for k in names),
              f"bench_ngp packed serving: {kernel} launched, by name")
    check(not plain, f"bench_ngp packed serving: no plain field or encode ({plain})")
    in_process["bench_ngp_packed"] = launches
    wall = time.perf_counter() - t_phase
    launches = {k: sum(r["launches"][k] for r in [serve_rec] + ngp_recs[1:])
                + sum(r[k] for r in in_process.values()) for k in serve_rec["launches"]}
    # the kernels' own device time inside the calls the hash-grid bench times
    hash_kernel_ms = dict(forward=hash_fwd["kernel_device_ms"],
                          table_grad_k1=hash_bwd["kernel_device_ms"])
    results["bench"] = dict(cli=dict(bench=serve_rec, bench_ngp=ngp_recs[1:]),
                            in_process=in_process, launches=launches,
                            hash_kernel_device_ms=hash_kernel_ms, seconds=cli_s, wall_s=wall)
    emit(phase="bench", nvidia_smi=smi, images_per_s=serve_rec["value"],
         iter_ms_median=serve_rec["iter_ms_median"], iter_ms_max=serve_rec["iter_ms_max"],
         hash_forward_mlookups_per_s=hash_fwd["value"],
         hash_table_grad_mlookups_per_s=hash_bwd["value"],
         stage_a_ngp_it_per_s=stage_a["value"],
         ngp_serving_images_per_s={r["metric"]: r["value"] for r in ngp_recs[5:]},
         hash_call_ms={"forward": hash_fwd["ms"], "table_grad": hash_bwd["ms"]},
         hash_kernel_device_ms=hash_kernel_ms, in_process_launches=in_process, wall_s=wall)


# The train_64 phase: the staged 64^2 convergence run, cut to a few steps.
TRAIN_64_FLAGS = ("--sphere_init_iters", "2", "--iters", "3", "--log_every", "1",
                  "--store_images", "64", "--eval_images", "64")
TRAIN_64_TIMEOUT_S = 600


def start_train_64() -> tuple:
    """Start ``scripts/torch_convergence_run.py`` (``train_64``'s run) in the
    background, in a temporary directory of the checkout: it runs beside
    stage C's train processes, which time nothing.  Returns (process, the
    directory, start time) for :func:`train_64`."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    td = tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_train_")
    os.symlink(os.path.join(HERE, "configs"), os.path.join(td.name, "configs"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "scripts", "torch_convergence_run.py"),
         *TRAIN_64_FLAGS, "--out_dir", "report"], cwd=td.name, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, td, time.perf_counter()


def train_64(results: dict, smi: str, started: tuple) -> None:
    """``scripts/torch_convergence_run.py`` on the card at 2 sphere-init steps
    and 3 iterations per stage (a 64-image store, a 64-image eval), started
    by :func:`start_train_64`: the 64^2 configs' path
    (``synthetic_64_sdf_solid_eik.yaml``: gray background, view-independent
    colour, sparsity, the subsampled eikonal, a bf16 G, a 64^2 decoder)
    through store, train, both probes, sdf_mesh and eval: exit 0, every
    logged loss finite, both verdicts, a mesh line, a finite FID."""
    import math

    proc, td, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=TRAIN_64_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        td.cleanup()
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"torch_convergence_run.py exited {proc.returncode}:\n"
          f"{stdout[-3000:]}\n{stderr[-3000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    for stage in ("stage_a", "stage_b"):
        check(summary[stage]["all_finite"] and summary[stage]["last_step"] == 2,
              f"train_64 {stage}: 3 iterations, every loss finite")
    check(all(summary[p]["verdict"] for p in ("probe_a", "probe_b")), "train_64: two verdicts")
    check(len(summary["mesh"]) == 1, f"train_64: a mesh line ({summary['mesh']})")
    fid = summary["fid"].split()
    check(fid[0] == "FID:" and math.isfinite(float(fid[1])), f"train_64: {summary['fid']}")
    check(summary["nvidia_smi"] == smi, "train_64: the card named")
    rec = dict(seconds=seconds, command_seconds=summary["seconds"],
               stage_a=summary["stage_a"]["at"], stage_b=summary["stage_b"]["at"],
               probe={p: summary[p]["verdict"] for p in ("probe_a", "probe_b")},
               mesh=summary["mesh"], fid=summary["fid"])
    results["train_64"] = rec
    emit(phase="train_64", nvidia_smi=smi, **rec)


# The 512 phases: configs/512res/ffhq_512_sdf_tpu.yaml served and trained.
CONFIG_512, CLI_512_EXP = "configs/512res/ffhq_512_sdf_tpu.yaml", "ffhq512_sdf_tpu"
CLI_512_HEADS, CLI_512_STORE, CLI_512_ITERS = 24, "store_512", 20
# sphere init cut from the entry's 10,000 steps (depth only: its loss is the same)
CLI_512_SPHERE_INIT = 10
SERVE_512_BATCHES, TRAIN_512_BATCHES = (4, 8, 16, 32), (2, 4, 8)  # the benches' defaults
TRAIN_512_ITERS = 3  # bench_train_512's timed calls per step kind here (its default 10)
# the width cut of tests/test_torch_port_512.py: the 512 pyramid over a 64^2
# renderer, field 32 x 2, 4 samples, style 16, channel_base 16, batch 2
PARITY_512 = dict(style=16, width=32, depth=2, samples=4, base=16, batch=2)
TRAIN_512_TOLERANCES = {"stage_b_d_r1": (1e-4, 1e-3), "stage_b_g": (1e-4, 1e-3),
                        "stage_b_path_f64": (1e-4, 1e-3)}


def train_512_jobs() -> dict:
    """The staged CLI at 512^2 for stage C's wave, over the 64 + 512 store of
    :func:`prepare`: sphere init, stage A at 64^2 (the yaml's 4,096 eikonal
    points, no remat, bf16 G), the A -> B transfer and stage B at 512^2, 20
    iterations each (step-0 sample grids of both stages)."""
    return {"train_512": [("train", ["--config", CONFIG_512, "--sdf", "1", "--dataset_path",
                                     CLI_512_STORE, "--iters", str(CLI_512_ITERS),
                                     "--sphere_init_iters", str(CLI_512_SPHERE_INIT),
                                     "--log_every", "1", "--save_every", "1000"])]}


def train_512_parity() -> dict:
    """The three stage-B steps at 512^2 on the card against the CPU, from the
    same weights and inputs, no jitter, at the width cut of
    ``tests/test_torch_port_512.py`` (``PARITY_512``): the D step with R1 and
    the G step in f32, held by ``masked_parity``'s rule (loss rel 1e-4, each
    gradient 1e-3 of its norm + 1e-6).  The path step's gradients are sums of
    512^2 products with cancellation, ~1e-2 of their norm from f64 in f32
    (JAX's own, on the CPU), so it is held by that rule in f64 on both
    devices, and in f32 by the bf16 contract's form against the CPU's f64:
    the card's worst gradient no further than the CPU's f32 one x 1.2 +
    1e-4, its loss within rel 1e-4."""
    import copy

    import torch

    from sdface_gan_tpu_torch.geometry import CameraParams, generate_camera_params
    from sdface_gan_tpu_torch.models import (
        Generator,
        GeneratorConfig,
        RendererConfig,
        StyleDiscConfig,
        StyleDiscriminator,
    )
    from sdface_gan_tpu_torch.training import steps

    c = PARITY_512
    style, batch = c["style"], c["batch"]
    cfg = GeneratorConfig(size=512, style_dim=style, full_pipeline=True, freeze_renderer=True,
                          channel_base=c["base"], renderer=RendererConfig(
                              type="sdf", out_im_res=64, n_samples=c["samples"],
                              style_dim=style, width=c["width"], depth=c["depth"]))
    scfg = StyleDiscConfig(size=512, channel_base=c["base"])
    hp = steps.TrainHParams(batch=batch, style_dim=style)
    seed = torch.Generator().manual_seed
    cpu = dict(g=Generator(cfg, "cpu", seed(51)), d=StyleDiscriminator(scfg, seed(52)))
    models = {("cpu", torch.float32): cpu,
              ("cuda", torch.float32): {k: copy.deepcopy(m).cuda() for k, m in cpu.items()},
              ("cpu", torch.float64): {k: copy.deepcopy(m).double() for k, m in cpu.items()}}
    models[("cuda", torch.float64)] = {k: copy.deepcopy(m).cuda()
                                       for k, m in models[("cpu", torch.float64)].items()}
    gen = seed(53)
    z, z2 = torch.randn((batch, style), generator=gen), torch.randn((batch, style), generator=gen)
    cams = generate_camera_params(64, gen, batch=batch, device="cpu")
    real = torch.rand((batch, 512, 512, 3), generator=gen) * 2 - 1
    noise = torch.randn((batch // 2, 512, 512, 3), generator=gen) / 512.0

    def inputs(dev, dtype, b=batch, **kw):
        to = lambda t: t[:b].to(dev, dtype)  # noqa: E731
        return steps.StepInputs(to(z), CameraParams(*map(to, cams)), to(z2), 3, **kw)

    def d_r1(dev):
        m = models[(dev, torch.float32)]
        return (steps.stage_b_d_loss(m["g"], m["d"], cfg, scfg, hp, real.to(dev),
                                     inputs(dev, torch.float32), regularize=True)[0], m["d"], None)

    def g_step(dev):
        m = models[(dev, torch.float32)]
        return (steps.stage_b_g_loss(m["g"], m["d"], cfg, scfg, hp,
                                     inputs(dev, torch.float32))[0], m["g"], "decoder.")

    def path(dev, dtype):
        g = models[(dev, dtype)]["g"]
        p_in = inputs(dev, dtype, batch // 2, path_noise=noise.to(dev, dtype))
        # the running mean at a fresh run's 0: (length - mean)^2 with mean ~
        # length would amplify the lengths' rounding
        return (steps.stage_b_path_loss(g, cfg, hp, p_in, torch.zeros((), dtype=dtype,
                                                                      device=dev))[0],
                g, "decoder.")

    with torch.enable_grad():
        out = masked_parity("train_512_parity",
                            {"stage_b_d_r1": d_r1, "stage_b_g": g_step,
                             "stage_b_path_f64": lambda dev: path(dev, torch.float64)},
                            TRAIN_512_TOLERANCES)
        truth_loss, truth_g, _ = path("cpu", torch.float64)
        truth = _param_grads(truth_loss, truth_g, "decoder.")
        f32 = {}
        for dev in ("cuda", "cpu"):
            loss, g, _ = path(dev, torch.float32)
            grads = _param_grads(loss, g, "decoder.")
            errs = _grad_errors({k: v.double() for k, v in grads.items()}, truth)
            f32[dev] = dict(loss_rel_err=abs(loss.item() - truth_loss.item()) / truth_loss.item(),
                            worst=_worst(errs))
    card, host = f32["cuda"], f32["cpu"]
    check(card["loss_rel_err"] <= 1e-4,
          f"train_512_parity stage_b_path f32: card loss vs f64 rel {card['loss_rel_err']} <= 1e-4")
    check(card["worst"][1] <= 1.2 * host["worst"][1] + 1e-4,
          f"train_512_parity stage_b_path f32: card's worst gradient vs f64 {card['worst']} <= "
          f"1.2 x the CPU's {host['worst']} + 1e-4")
    out["stage_b_path_f32_vs_f64"] = dict(card=card, cpu=host, rule="card <= 1.2 x cpu + 1e-4")
    emit(phase="train_512_parity", tolerances=TRAIN_512_TOLERANCES, width_cut=PARITY_512, **out)
    return out


def serve_512(results: dict, smi: str) -> None:
    """The 512^2 generator of ``CONFIG_512`` (as ``bench_serving_512`` builds
    it from the yaml) behind ``SDFaceSampler`` at batch 8, bf16 weights, no
    truncation: warm up, zero the counts, answer two seed requests and one
    azim/elev request, read the counts (siren_field launched in every
    request, no plain field on the card); a profiled request shows
    ``siren_field_mma_kernel<256>`` by name and no f32 kernel and no plain
    field; one f32 request through the fused field against the plain field
    (<= 2e-3), and the bf16 request's mean error against that f32 plain
    image <= 1.2x the plain bf16 request's + 1e-4."""
    import gc

    import torch

    from sdface_gan_tpu_torch import bench as bench_mod
    from sdface_gan_tpu_torch.bench_serving_512 import config_512
    from sdface_gan_tpu_torch.ops import siren_kernel as sk
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    gc.collect()
    torch.cuda.empty_cache()
    cfg = config_512()
    model = bench_mod.serving_model(cfg, torch.device("cuda"))
    kw = dict(batch=BATCH, truncation=bench_mod.TRUNCATION)
    sampler = SDFaceSampler(model, **kw)
    sampler.warmup()
    with plain_fields_on_card() as plain:
        outs, launches, dt = drive(sampler, ["siren_field"])
    check(not plain, f"serve_512: no plain field on the card ({plain})")
    mma = sk.kernel_name(torch.bfloat16) + "<256>"
    with plain_fields_on_card() as plain:
        prof = profile_request(sampler, [mma], absent=[sk.kernel_name(torch.float32)])
    check(not plain, f"serve_512: no plain field in the profiled request ({plain})")
    plain16 = SDFaceSampler(model, use_fused_kernel=False, **kw).sample(seed=1)
    model32 = bench_mod.serving_model(cfg, torch.device("cuda"), dtype=torch.float32)
    fused32 = SDFaceSampler(model32, **kw).sample(seed=1)
    plain32 = SDFaceSampler(model32, use_fused_kernel=False, **kw).sample(seed=1)
    err = (fused32 - plain32).abs().max().item()
    bf16_err = (outs[0].float() - plain32).abs().mean().item()
    bf16_plain_err = (plain16.float() - plain32).abs().mean().item()
    check(err <= 2e-3, f"serve_512 f32 request, fused vs plain field: max abs {err} <= 2e-3")
    check(bf16_err <= 1.2 * bf16_plain_err + 1e-4,
          f"serve_512 bf16 request vs f32 plain: mean abs {bf16_err} <= 1.2 * {bf16_plain_err}"
          " + 1e-4")
    rec = dict(config=CONFIG_512, size=cfg.size, n_latent=cfg.decoder.n_latent, batch=BATCH,
               dtype="bfloat16", requests=3, launches=launches, seconds_three_requests=dt,
               profile=dict(device_ms_total=prof["device_ms_total"], kernel=mma,
                            kernel_ms=prof["kernel_ms"][mma], top=prof["top"][:6]),
               f32_fused_vs_plain_max_abs_err=err, tolerance=2e-3,
               bf16_fused_request_vs_f32_plain_mean_abs_err=bf16_err,
               bf16_plain_request_vs_f32_plain_mean_abs_err=bf16_plain_err)
    results["serve_512"] = rec
    emit(phase="serve_512", nvidia_smi=smi, **rec)


def bench_512(results: dict, smi: str) -> None:
    """``python -m sdface_gan_tpu_torch.bench_serving_512`` and ``...
    .bench_train_512`` (``--iters`` ``TRAIN_512_ITERS``) at their default
    batches, one after the other, alone on the
    card: a line per batch (4, 8, 16, 32; 2, 4, 8) with the JAX scripts'
    keys, every batch ``fits_hbm``, finite values, the card named, the field
    kernel once per timed serving call; images/s, ms per batch, the stage-B
    step ms, ``it_per_s_combined`` and the peak GB."""
    import math

    import torch

    from sdface_gan_tpu_torch.bench_serving_512 import ITERS

    torch.cuda.empty_cache()  # leave the card to the bench processes
    runs = {m: run_module(m, args, HERE) for m, args in (
        ("bench_serving_512", []), ("bench_train_512", ["--iters", str(TRAIN_512_ITERS)]))}
    serving = bench_lines(runs["bench_serving_512"]["stdout"])
    training = bench_lines(runs["bench_train_512"]["stdout"])
    check([r["batch"] for r in serving] == list(SERVE_512_BATCHES)
          and [r["batch"] for r in training] == list(TRAIN_512_BATCHES),
          f"bench_512: a line per batch ({[r['batch'] for r in serving + training]})")
    for r in serving:
        check(r["fits_hbm"] and r["finite"] and r["device"] == smi
              and math.isfinite(r["img_per_s"]) and r["img_per_s"] > 0
              and r["launches"]["siren_field"] == ITERS, f"bench_serving_512 line: {r}")
    for r in training:
        check(r["fits_hbm"] and r["finite"] and r["device"] == smi
              and all(math.isfinite(r[k]) and r[k] > 0 for k in (
                  "d_r1_ms", "g_ms", "path_ms", "it_per_s_combined"))
              and r["peak_hbm_gb"] < 80, f"bench_train_512 line: {r}")
    rec = dict(serving={r["batch"]: {k: r[k] for k in ("img_per_s", "ms_per_batch",
                                                        "iter_ms_median", "iter_ms_max",
                                                        "peak_memory_gb", "fits_hbm")}
                        for r in serving},
               training={r["batch"]: {k: r[k] for k in ("d_r1_ms", "g_ms", "path_ms",
                                                         "it_per_s_combined", "peak_hbm_gb",
                                                         "fits_hbm")}
                         for r in training},
               launches={k: sum(r["launches"][k] for r in serving) for k in serving[0]["launches"]},
               seconds={m: r["seconds"] for m, r in runs.items()})
    results["bench_512"] = rec
    emit(phase="bench_512", nvidia_smi=smi, **rec)


def train_512(results: dict, smi: str, td: str, cli: dict, parity: dict) -> None:
    """What the staged 512^2 CLI (:func:`train_512_jobs`, in stage C's wave)
    did: sphere init, then stage A and stage B 20 iterations each, every
    logged loss finite, ``vol_renderer`` and ``full_pipeline`` written, a
    512^2 sample grid; beside it the card-vs-CPU parity
    (:func:`train_512_parity`)."""
    from sdface_gan_tpu_torch.data.png import decode_png
    from sdface_gan_tpu_torch.utils.checkpoints import checkpoint_exists

    out = os.path.join(td, "out", CLI_512_EXP)
    vr = os.path.join(out, "volume_renderer")
    stdout = cli["stdout"]
    check("sphere init done" in stdout and "initialized renderer from vol_renderer" in stdout,
          "train_512: sphere init, then stage B from stage A's vol_renderer")
    check(checkpoint_exists(vr, "vol_renderer") and checkpoint_exists(out, "full_pipeline"),
          "train_512: vol_renderer and full_pipeline written")
    rows_a = _train_rows(os.path.join(vr, "vol_render_metrics.jsonl"))
    rows_b = _train_rows(os.path.join(out, "full_pipeline_metrics.jsonl"))
    _finite_losses(rows_a, "train_512 stage A")
    _finite_losses(rows_b, "train_512 stage B")
    its = list(range(CLI_512_ITERS))
    check([r["step"] for r in rows_a if "g" in r] == its and [r["step"] for r in rows_b] == its,
          f"train_512: {CLI_512_ITERS} + {CLI_512_ITERS} iterations logged")
    with open(os.path.join(out, "samples_0000000.png"), "rb") as f:
        grid = decode_png(f.read())
    check(grid.shape[0] % 512 == 0 and grid.shape[1] % 512 == 0 and grid.std() > 0,
          f"train_512: a grid of 512^2 samples ({grid.shape})")
    rec = dict(config=CONFIG_512, command_s=cli["seconds"], sphere_init_iters=CLI_512_SPHERE_INIT,
               iters=CLI_512_ITERS, stage_a=_step_medians(rows_a), stage_b=_step_medians(rows_b),
               step_ms_card_shared="stage C's wave", sample_grid=list(grid.shape),
               parity={k: {m: v[m] for m in ("loss_rel_err", "worst_param",
                                             "worst_grad_rel_err", "held_with")}
                       for k, v in parity.items() if k.startswith("stage_b_") and "f32" not in k},
               path_f32_vs_f64=parity["stage_b_path_f32_vs_f64"])
    results["train_512"] = rec
    emit(phase="train_512", nvidia_smi=smi, **rec)


# The ddp phase: data parallelism (sdface_gan_tpu_torch/parallel/) on one card.
# NCCL refuses two ranks on one GPU, so the launcher's NCCL group runs at world
# 1 (train_cli's wave) and the arithmetic that crosses ranks runs on two gloo
# ranks sharing cuda:0 (beside stage C's wave).
DDP_WORLD, DDP_BATCH = 2, 8
DDP_TOL = (1e-4, 1e-3)  # train_parity's bars: loss rel, every gradient of its norm
DDP_SAMPLER_TOL = 2e-3  # serve_compare's bar
DDP_PROBE_TOL = 1e-5
# The launcher's world of one against the run without it, by what the card
# reproduces (plain reruns of train_cli's entry, scripts/torch_train_spread.py;
# the readings in PERF.md section 6): every value through stage A's first
# adversarial row, the first computed inside the data-parallel span (its metrics
# through the group's all-reduce, its G half after an all-reduced D update),
# reruns to a few ulp; stage A's later rows and stage B's first D loss, R1 and
# real score (before stage B's first update, through the minibatch stddev's
# gather, the fresh D on real images) to < 1e-4; the rest, from the generator
# stage A trained, drifts: stage B's first fake score by up to 2e-4, and after
# stage B's first update Adam's sign-like steps turn the card's run-to-run noise
# into lr-sized moves of weights whose gradient is near 0, a few %.
DDP_NCCL_TIERS = (1e-6, 1e-3, 0.25)
DDP_NCCL_B_FIRST = ("d", "r1", "real_score")  # stage B's first row: the middle tier
DDP_FREE_GB = 40.0  # the card memory the ranks and rank 0's one-rank run need
DDP_WAIT_S = 60.0
DDP_CASES = ("b_d", "b_g", "b_path", "a_d", "a_g", "vae_e")
DDP_MASKED = ("b_d", "b_g", "b_path")  # the StyleGAN steps: masked_parity's leaky-ReLU rule


def ddp_nccl_jobs(td: str) -> dict:
    """train_cli's entry again as it ran (the card's own run-to-run spread),
    then under ``python -m torch.distributed.run --nproc_per_node 1``: the
    NCCL group at world 1; each its own experiment, one job for stage C's
    wave (chained after ``--vae 1``, see ``WAVE_AFTER``)."""
    cmds = []
    for exp in ("smoke_ddp_plain", "smoke_ddp"):
        with open(os.path.join(td, f"{exp}.yaml"), "w") as f:
            f.write(f"inherit_from: {CLI_CONFIG}\ntraining:\n  out_dir: out/{exp}\n")
        cmds.append(["--config", f"{exp}.yaml", "--sdf", "1", "--dataset_path", "store",
                     "--iters", "3", *CLI_TRAIN_FLAGS])
    return {"ddp_nccl": [("train", cmds[0]), ("torch.distributed.run", [
        "--standalone", "--nproc_per_node", "1", "-m", "sdface_gan_tpu_torch.train", *cmds[1]])]}


def _loss_rel_errs(td: str, exp: str) -> tuple:
    """The largest relative difference of any logged loss of experiment
    ``exp`` from train_cli's entry in each tier of ``DDP_NCCL_TIERS``: (0)
    through stage A's first adversarial row, (1) stage A's later rows and
    ``DDP_NCCL_B_FIRST`` of stage B's first row, (2) the rest of stage B;
    each row's largest difference; and its stage medians."""
    rows = {}
    for e in (CLI_EXP, exp):
        out = os.path.join(td, "out", e)
        rows[e] = (_train_rows(os.path.join(out, "volume_renderer", "vol_render_metrics.jsonl")),
                   _train_rows(os.path.join(out, "full_pipeline_metrics.jsonl")))
    tiers, per_row = [0.0] * len(DDP_NCCL_TIERS), []
    for stage, (got, want) in enumerate(zip(rows[exp], rows[CLI_EXP])):
        check([r["step"] for r in got] == [r["step"] for r in want], f"{exp}: the steps logged")
        adversarial_seen = False
        for i, (g, w) in enumerate(zip(got, want)):
            row = 0.0
            for k, v in w.items():
                if k in ("step", "time") or k.endswith("_ms"):
                    continue
                err = abs(g[k] - v) / max(abs(v), 1e-12)
                tier = (int(adversarial_seen) if stage == 0
                        else 1 if i == 0 and k in DDP_NCCL_B_FIRST else 2)
                tiers[tier], row = max(tiers[tier], err), max(row, err)
            adversarial_seen = adversarial_seen or "g" in w
            per_row.append(dict(stage="AB"[stage], step=w["step"], max_rel_err=row))
    return tiers, per_row, {"stage_a": _step_medians(rows[exp][0]),
                            "stage_b": _step_medians(rows[exp][1])}


def ddp_nccl_check(td: str, run: dict, smi: str) -> dict:
    """The NCCL run's logged losses against the entry's at the same seed,
    each tier within its bar of ``DDP_NCCL_TIERS``; the plain rerun's
    distances reported beside (the card's own spread); its step ms beside
    the entry's."""
    check("data-parallel mesh: rank 0 of 1 on cuda:0 (nccl)" in run["stdouts"][1],
          "the launcher's run formed an NCCL group at world 1")
    plain, plain_rows, plain_ms = _loss_rel_errs(td, "smoke_ddp_plain")
    nccl, nccl_rows, nccl_ms = _loss_rel_errs(td, "smoke_ddp")
    check(all(e <= bar for e, bar in zip(nccl, DDP_NCCL_TIERS)),
          f"NCCL world 1 vs no launcher: losses rel {nccl} by tier (<= {DDP_NCCL_TIERS}); "
          f"the plain rerun's {plain}")
    out = os.path.join(td, "out", CLI_EXP)
    entry = {"stage_a": _step_medians(_train_rows(os.path.join(
        out, "volume_renderer", "vol_render_metrics.jsonl"))),
        "stage_b": _step_medians(_train_rows(os.path.join(out, "full_pipeline_metrics.jsonl")))}
    rec = dict(rel_err_by_tier=nccl, bars=DDP_NCCL_TIERS, plain_rerun_rel_err_by_tier=plain,
               rows=nccl_rows, plain_rerun_rows=plain_rows,
               command_s=run["command_s"], step_ms=nccl_ms, plain_rerun_step_ms=plain_ms,
               entry_step_ms=entry, card_shared_with="stage C's wave")
    emit(phase="ddp_nccl", nvidia_smi=smi, **rec)
    return rec


def ddp_payload() -> dict:
    """The card's 2-rank cases at global batch 8, seeded weights, live
    generators: stage B's D (R1), G and path steps at the flagship's widths
    (f32), stage A's D (R1) and G under ``_tpu`` (f32 here: the card against
    itself), stage C's VAE E step at 256^2; the sampler (bf16, the fused
    field) and the 128^3 surface probe (f32, rows split)."""
    import torch

    from sdface_gan_tpu_torch import configs, sdf_mesh
    from sdface_gan_tpu_torch.encoder import VAEEncoderConfig
    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.training.steps import StepInputs

    gen = torch.Generator().manual_seed(90)
    b = DDP_BATCH
    gcfg_b = configs.ffhq_256_sdf(stage_a=False)
    gcfg_a = configs.ffhq_256_sdf_tpu(stage_a=True)
    hp_b = configs.train_hparams(batch=b)
    hp_a = dataclasses.replace(configs.train_hparams(tpu=True, batch=b), g_param_dtype="float32")
    vcfg, scfg = configs.discriminator_configs(256)
    cams = generate_camera_params(RES, gen, batch=b, device="cpu")
    z = lambda n=b: torch.randn((n, STYLE), generator=gen)  # noqa: E731
    path = b // hp_b.path_batch_shrink
    pcams = generate_camera_params(RES, gen, batch=path, device="cpu")
    cases = {
        "b_d": dict(kind="b_d", gcfg=gcfg_b, dcfg=scfg, hp=hp_b, g=91, d=92, gen_seed=93,
                    inputs=StepInputs(z(), cams, z(), 4),
                    real=torch.rand((b, 256, 256, 3), generator=gen) * 2 - 1),
        "b_g": dict(kind="b_g", gcfg=gcfg_b, dcfg=scfg, hp=hp_b, g=91, d=92, gen_seed=94,
                    inputs=StepInputs(z(), cams, z(), 4)),
        "b_path": dict(kind="b_path", gcfg=gcfg_b, dcfg=scfg, hp=hp_b, g=91, d=92, gen_seed=95,
                       inputs=StepInputs(z(path), pcams, z(path), 4),
                       mean_path_length=torch.tensor(0.5)),
        "a_d": dict(kind="a_d", gcfg=gcfg_a, dcfg=vcfg, hp=hp_a, g=96, d=97, gen_seed=98,
                    inputs=StepInputs(z(), cams),
                    real=torch.rand((b, RES, RES, 3), generator=gen) * 2 - 1),
        "a_g": dict(kind="a_g", gcfg=gcfg_a, dcfg=vcfg, hp=hp_a, g=96, d=97, gen_seed=99,
                    inputs=StepInputs(z(), cams)),
        "vae_e": dict(kind="vae_e", gcfg=gcfg_b, g=91, e=100, gen_seed=101,
                      ecfg=VAEEncoderConfig(img_size=CLI_SIZE, z_size=STYLE),
                      inputs=encoder_inputs(gen, b, cams)),
    }
    _, surf_cfg = sdf_mesh.mesh_configs(gcfg_b, SURFACE_RES)
    front = generate_camera_params(SURFACE_RES, batch=1, locations=torch.zeros((1, 2)))
    style = torch.randn((1, STYLE), generator=gen)
    return dict(device="cuda:0", cases=cases, allreduce_case="b_d", masked=DDP_MASKED,
                samplers=[dict(gcfg=gcfg_b, g=91, batch=b, dtype="bfloat16",
                               sample=dict(seed=7), profile=True)],
                rays=dict(gcfg=surf_cfg, g=91, fused=True, profile=True,
                          args=[front.focal, front.extrinsics, front.near, front.far, style]))


def encoder_inputs(gen, b: int, cams):
    """A VAE E step's images (256^2) and thumbs in [-1, 1] from ``gen``."""
    import torch

    from sdface_gan_tpu_torch.training.encoder_loop import EncoderInputs

    return EncoderInputs(torch.rand((b, CLI_SIZE, CLI_SIZE, 3), generator=gen) * 2 - 1,
                         torch.rand((b, RES, RES, 3), generator=gen) * 2 - 1, cams)


def ddp(results: dict, smi: str) -> dict:
    """Two gloo ranks sharing cuda:0 (``tests/torch_parallel_ranks.py``'s card
    job), beside train_cli's wave once the card has ``DDP_FREE_GB`` free: each
    case's step over the ranks against rank 0's one-rank step at the same
    global batch (f32, TF32 off; train_parity's bars, the StyleGAN steps under
    ``masked_parity``'s rule with the ranks' masks replayed), the parameters
    after an Adam step bit-equal across the ranks; the sampler's gathered images
    against the one-rank sampler (2e-3) with ``siren_field_mma_kernel<256>``
    in rank 0's profile and no plain field; the ray-sharded probe's sdf
    against the one-rank probe (1e-5) through ``siren_field_f32_kernel<256>``;
    the steps' ms (the card shared) and the all-reduce's ms and bytes."""
    import torch

    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    import torch_parallel_ranks as ranks

    t0 = time.perf_counter()
    waited = 0.0
    while torch.cuda.mem_get_info()[0] / 1e9 < DDP_FREE_GB and waited < DDP_WAIT_S:
        time.sleep(1.0)
        waited = time.perf_counter() - t0
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    res = ranks.spawn("card", DDP_WORLD, ddp_payload(), timeout=CLI_TIMEOUT_S, threads=2)
    one = res[0]["one"]
    cases, failed = {}, []
    for name in DDP_CASES:
        rk = [r["cases"][name] for r in res]
        ref, flips, held = one["cases"][name], None, "own"
        if name in DDP_MASKED:  # held with rank 0's own masks unless a unit flipped
            replayed = res[0]["one_replayed"][name]
            flips = replayed["flips"]
            check(replayed["unreplayed"] == 0 and 0 < flips["units"]
                  and flips["flipped"] <= 1e-5 * flips["units"],
                  f"ddp {name}: every mask of the ranks replayed, {flips} flipped")
            if flips["flipped"]:
                ref, held = replayed, "replayed"
        check(all(torch.equal(r["params"][k], rk[0]["params"][k]) for r in rk[1:]
                  for k in rk[0]["params"]), f"ddp {name}: parameters bit-equal across ranks")
        check(all(torch.equal(r["grads"][k], rk[0]["grads"][k]) for r in rk[1:]
                  for k in rk[0]["grads"]), f"ddp {name}: the same reduced gradients")
        metrics = {k: statistics.mean(r["metrics"][k] for r in rk) for k in ref["metrics"]}
        loss_err = max(abs(metrics[k] - v) / max(abs(v), 1e-12)
                       for k, v in ref["metrics"].items())
        diffs = {k: ((rk[0]["grads"][k] - g).norm().item(), g.norm().item())
                 for k, g in ref["grads"].items()}
        errs = {k: d / (n + 1e-30) for k, (d, n) in diffs.items()}
        worst = max(errs, key=errs.get)
        if not (loss_err <= DDP_TOL[0] and errs[worst] <= DDP_TOL[1]):  # every case first
            failed.append(f"ddp {name}: metrics rel {loss_err}, gradient {worst} {errs[worst]} "
                          f"(||diff|| {diffs[worst][0]}, ||g|| {diffs[worst][1]})")
        cases[name] = dict(held_with=held, leaky_relu_flips=flips,
                           metrics_max_rel_err=loss_err, worst_param=worst,
                           worst_grad_rel_err=errs[worst], grad_norm=diffs[worst][1],
                           step_ms=[r["step_ms"] for r in rk], one_rank_step_ms=ref["step_ms"])
        emit(phase="ddp_case", case=name, **cases[name])
    check(not failed, "; ".join(failed))
    img, img1 = res[0]["serving"]["images0"], one["serving"]["images0"]
    sampler_err = (img - img1).abs().max().item()
    check(all(torch.equal(r["serving"]["images0"], img) for r in res[1:]),
          "ddp sampler: every rank holds the gathered batch")
    check(tuple(img.shape) == (DDP_BATCH, 256, 256, 3) and bool(torch.isfinite(img).all())
          and sampler_err <= DDP_SAMPLER_TOL,
          f"ddp sampler: max abs {sampler_err} <= {DDP_SAMPLER_TOL}")
    sdf, sdf1 = res[0]["serving"]["rays"]["sdf"], one["serving"]["rays"]["sdf"]
    probe_err = (sdf - sdf1).abs().max().item()
    check(tuple(sdf.shape) == (1,) + (SURFACE_RES,) * 3 + (1,) and probe_err <= DDP_PROBE_TOL,
          f"ddp probe: max abs {probe_err} <= {DDP_PROBE_TOL}")
    names = res[0]["serving"]["kernels"]
    for dtype in (torch.bfloat16, torch.float32):
        check(any(sk.kernel_name(dtype) in n for n in names),
              f"ddp: {sk.kernel_name(dtype)} in rank 0's profile")
    check(all(r["plain_field_calls"] == 0 for r in res), "ddp: no plain field on the card")
    launches = {"sampler": sum(r["serving"]["launches0"]["siren_field"] for r in res),
                "probe": sum(r["serving"]["rays_launches"]["siren_field"] for r in res)}
    check(all(r["serving"]["launches0"]["siren_field"] > 0
              and r["serving"]["rays_launches"]["siren_field"] > 0 for r in res),
          "ddp: every rank launched the field kernel in the sampler and the probe")
    rec = dict(world=DDP_WORLD, batch=DDP_BATCH, backend="gloo", device="cuda:0",
               free_gb_at_start=free_gb, waited_s=waited, cases=cases,
               sampler_max_abs_err=sampler_err, probe_max_abs_err=probe_err,
               probe_points_per_rank=SURFACE_RES ** 3 // DDP_WORLD,
               kernels=[n[:90] for n in names if "siren_field" in n],
               launches=launches,
               allreduce=[r["allreduce"] for r in res],
               peak_gb_per_rank=[r["peak_gb"] for r in res],
               card_shared_with="train_cli's wave and evaluate's untimed evals",
               seconds=time.perf_counter() - t0)
    results["ddp"] = rec
    emit(phase="ddp", nvidia_smi=smi, **rec)
    return rec


def build_kernels() -> None:
    """Every CUDA source of the served paths, one nvcc each, started together;
    ptxas's registers and spills."""
    from sdface_gan_tpu_torch.ops import _ext

    built = {src: not _ext.library_path(src).exists() for src in SOURCES}
    t0 = time.perf_counter()
    _ext.build(*SOURCES)
    seconds = time.perf_counter() - t0
    for src in SOURCES:
        _ext.load(src)
        ptxas = [ln.strip() for ln in open(str(_ext.library_path(src)) + ".log")
                 if "registers" in ln or "spill" in ln or "Function properties" in ln]
        emit(phase="build", source=f"csrc/{src}.cu", seconds_all_sources=seconds,
             built=built[src], ptxas=ptxas)


def kernel_check(results: dict) -> tuple:
    """Each kernel against its plain version (the module docstring's phase 3)."""
    checks = [check_field(DEPTH, POINTS, seed=1), check_field(3, 700, seed=2),
              check_field(3, 700, seed=3, width=64), check_field(3, 700, seed=4, width=512),
              # the bench's shape: one call at batch 32
              check_field(DEPTH, POINTS, seed=16, batch=BENCH_BATCH)]
    # the f32 kernel at every tile geometry class, ragged tiles (P = 1, 700)
    f32_checks = [check_field(3, p, seed=5 + i, width=w, bf16=False)
                  for i, (w, p) in enumerate((w, p) for w in (64, 192, 256, 320, 512)
                                             for p in (1, 700))]
    # and at sdf_mesh's surface probe: one call, B = 1, P = 128^3, full width
    f32_checks.append(check_field(DEPTH, SURFACE_RES ** 3, seed=15, bf16=False, batch=1))
    for rec in checks + f32_checks:
        emit(phase="kernel_check", kernel="siren_field", **rec)
    results["field_checks"], results["field_f32_checks"] = checks, f32_checks
    gather_checks = check_table_gather()
    bench_encode_check, bench_grad_checks = check_bench_hash()
    encode_checks = check_hash_encode() + [bench_encode_check]
    grad_checks = check_encode_grads() + bench_grad_checks
    for rec in gather_checks + encode_checks + grad_checks:
        emit(phase="kernel_check", **rec)
    results["gather_checks"], results["encode_checks"] = gather_checks, encode_checks
    results["grad_checks"] = grad_checks
    return checks, f32_checks, gather_checks, encode_checks, grad_checks


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every result to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "sdface_gan_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]  # the port; the checks' shared helpers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)  # inference by default; training enables it

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    results = dict(nvidia_smi=smi, device=name)
    emit(phase="device", nvidia_smi=smi, name=name,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    import tempfile

    walls = {}

    def timed(name, fn, *fn_args):
        """``fn(*fn_args)``; its wall seconds on a line of their own."""
        t0 = time.perf_counter()
        out = fn(*fn_args)
        walls[name] = time.perf_counter() - t0
        emit(phase="wall", of=name, wall_s=walls[name])
        return out

    # one working directory for the CLI phases, their files made beside the build
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_train_") as td:
        try:
            os.symlink(os.path.join(HERE, "configs"), os.path.join(td, "configs"))
            prep = Background(lambda: prepare(td))
            timed("build", build_kernels)
            checks, f32_checks, gather_checks, encode_checks, grad_checks = timed(
                "kernel_check", kernel_check, results)
            prepared = prep.result()
            emit(phase="prepare", beside="build and kernel_check", seconds=prepared["seconds"],
                 native_build_s=prepared["native_s"],
                 jobs_s={k: v["command_s"] for k, v in prepared["runs"].items()})

            def serving():
                serve(results)
                serve_f32(results)
                ngp_model = serve_ngp(results)
                timing = time_field(results)
                ngp_timing = time_ngp_kernels(results, ngp_model)
                del ngp_model
                grad_timing = time_grad_kernels(results)
                emit(phase="timing", nvidia_smi=smi, batch=BATCH, field=timing, ngp=ngp_timing,
                     encode_grads=grad_timing,
                     images_per_s=results["images_per_s"],
                     ngp_images_per_s=results["ngp_images_per_s"],
                     f32_images_per_s=results["f32_request"]["images_per_s"],
                     f32_request_device_ms=results["f32_request"]["device_ms_total"],
                     f32_request_kernel_ms=results["f32_request"]["kernel_ms"],
                     ngp_upstream_images_per_s=results["ngp_upstream_images_per_s"])
                return timing, ngp_timing, grad_timing

            timing, ngp_timing, grad_timing = timed("serve_and_timing", serving)
            timed("train", train, results)
            timed("train_ngp", train_ngp, results)
            summary_keys = ("batch", "d_ms", "g_ms", "peak_memory_gb")
            stage_b_keys = ("d_ms", "g_ms", "warm_reg_d_ms", "warm_path_ms", "peak_memory_gb")
            emit(phase="train_summary", nvidia_smi=smi,
                 stage_a={k: {m: v[m] for m in summary_keys}
                          for k, v in {**results["train"]["stage_a"],
                                       **results["train_ngp"]["stage_a"]}.items()},
                 stage_b={m: results["train"]["stage_b"][m] for m in stage_b_keys},
                 stage_b_t={m: results["train_ngp"]["stage_b"][m] for m in stage_b_keys},
                 ngp_g_step={s: {k: p["g_step"][k] for k in ("launches",
                                                              "hash_kernel_device_ms",
                                                              "device_ms_total", "host_ms")}
                             for s, p in results["train_ngp"]["profile"].items()})
            def beside_train_cli():
                """evaluate's untimed evals here and the ddp ranks on a thread,
                beside train_cli's wave (stage C's has no card memory to spare)"""
                card = Background(lambda: ddp(results, smi))
                out = evaluate_beside(td)
                card.result()
                return out

            first, evaluated = timed("train_cli", train_cli, results, smi, td, prepared,
                                     beside_train_cli)
            timed("evaluate", evaluate, results, smi, td, first, evaluated)
            # the script's wave of untimed work, run beside stage C's parity
            extra = {**train_cli_cut_jobs(td), **evaluate_files_jobs(), **bridge_jobs(td),
                     **giraffe_jobs(td), **train_512_jobs(), **ddp_nccl_jobs(td)}
            wave = timed("train_stage_c", train_stage_c, results, smi, td, extra,
                         {"train_512_parity": train_512_parity})
            results["train_cli"]["flow"] = train_cli_flow(td, wave["cli_cut"])
            results["ddp_nccl"] = ddp_nccl_check(td, wave["ddp_nccl"], smi)
            evaluate_files(results, wave["eval_files"])
            timed("bridge_and_images", bridge_and_images, results, smi, td, wave)
            timed("giraffe", giraffe, results, smi, td, wave)
            timed("giraffe_train", giraffe_train, results, smi, td,
                  {k: wave[k] for k in ("giraffe_resume", "giraffe_cut", "gan2d")})
            timed("bench", bench, results, smi)
            timed("serve_512", serve_512, results, smi)
            timed("bench_512", bench_512, results, smi)
            train_512(results, smi, td, wave["train_512"], wave["train_512_parity"])
        finally:
            stop_started()
    results["walls"] = walls
    emit(phase="walls", nvidia_smi=smi, wall_s=walls, total_s=time.perf_counter() - START)

    bf16, f32 = timing["bfloat16"], timing["float32"]
    gather, encode = ngp_timing["table_gather"], ngp_timing["hash_encode"]
    probe_shape = results["evaluate"]["checks"]["surface"]["field_at_probe_shape"]
    rank_band = results["evaluate"]["checks"]["surface"]["field_at_rank_band"]
    ngp_eval = results["evaluate"]["eval"]["ngp"]["launches"]
    benched = results["bench"]["launches"]
    bridged = results["bridge_and_images"]["launches"]
    giraffe_encode = results["giraffe"]["hash_encode"]
    kernels = [
        dict(name="siren_field", route="cuda",
             source="sdface_gan_tpu_torch/ops/csrc/siren_field.cu",
             replaces="sdface_gan_tpu/ops/siren_kernel.py:40",
             kernel=bf16["kernel"], design=bf16["design"],
             launches=results["launches"]["siren_field"]
             + results["evaluate"]["eval"]["no_dump"]["bfloat16"]["launches"]
             + benched["siren_field"] + bridged["siren_field"]
             + results["serve_512"]["launches"]["siren_field"]
             + results["bench_512"]["launches"]["siren_field"]
             + results["ddp"]["launches"]["sampler"], checked=True,
             max_abs_err=checks[0]["bf16_max_abs_kernel_vs_plain"],
             f32_max_abs_err=checks[0]["f32_max_abs_err"],
             ms=bf16["ms"], plain_ms=bf16["plain_ms"], bound_ms=bf16["bound_ms"],
             bound_by=bf16["bound_by"], library_ms=None),
        dict(name="siren_field_f32", route="cuda",
             source="sdface_gan_tpu_torch/ops/csrc/siren_field.cu",
             replaces="sdface_gan_tpu/ops/siren_kernel.py:40",
             kernel=f32["kernel"], design=f32["design"],
             launches=results["f32_launches"]["siren_field"]
             + results["evaluate"]["eval"]["dump"]["launches"]
             + results["evaluate"]["eval"]["no_dump"]["float32"]["launches"]
             + bridged["siren_field_f32"] + results["ddp"]["launches"]["probe"], checked=True,
             max_abs_err=max(r["f32_max_abs_err"] for r in checks + f32_checks),
             ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
             bound_by=f32["bound_by"], library_ms=None,
             probe_shape={k: probe_shape[k] for k in ("batch", "points", "ms", "plain_ms",
                                                      "bound_ms", "bound_by")},
             probe_rank_band={k: rank_band[k] for k in ("points", "ms", "plain_ms", "bound_ms",
                                                        "bound_by")}),
        dict(name="table_gather", route="cuda",
             source="sdface_gan_tpu_torch/ops/csrc/hash_grid.cu",
             replaces="scripts/bench_packed_gather.py:128",
             launches=results["ngp_launches"]["table_gather"] + ngp_eval["table_gather"]
             + benched["table_gather"],
             checked=True,
             max_abs_err=max(r["max_abs_err"] for r in gather_checks),
             ms=gather["ms"], plain_ms=gather["plain_ms"], bound_ms=gather["bound_ms"],
             bound_by=gather["bound_by"], library_ms=gather["library_ms"]),
        dict(name="hash_encode", route="cuda",
             source="sdface_gan_tpu_torch/ops/csrc/hash_grid.cu",
             replaces="sdface_gan_tpu/ops/hash_encoder.py:205",
             launches=results["ngp_launches"]["hash_encode"] + ngp_eval["hash_encode"]
             + benched["hash_encode"]
             + results["train_stage_c"]["ngp"]["launches"]["hash_encode"]
             + results["giraffe"]["launches"]["hash_encode"]
             + results["giraffe_train"]["launches"]["hash_encode"],
             checked=True,
             max_abs_err=max([r["max_abs_err"] for r in encode_checks
                              if r["dtype"] == "float32"] + [giraffe_encode["max_abs_err"]]),
             ms=encode["ms"], plain_ms=encode["plain_ms"], bound_ms=encode["bound_ms"],
             bound_by=encode["bound_by"], library_ms=None,
             giraffe_shape={k: giraffe_encode[k] for k in (
                 "points", "oob_share", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by")}),
    ]
    ngp_runs = results["train_ngp"]["stage_a"].values()
    # the forward-mode eikonal's G step (train_ngp, (u)): K2 as the encode's
    # tangent (counted as hash_encode_jvp) and as its table gradient
    jvp_launches = results["train_ngp"]["profile"]["u"]["g_step_jvp"]["launches"]
    for kname, case, replaces, outputs in (
            ("hash_encode_backward", "t_render_k1", "sdface_gan_tpu/ops/hash_encoder.py:245",
             ("d_x", "d_x_alone", "d_table")),
            ("hash_encode_double_backward", "u_eikonal_k2",
             "sdface_gan_tpu/ops/hash_encoder.py:205", ("dd_table", "dd_g", "jvp_table")),
            ("hash_encode_jvp", "u_jvp_k2", "sdface_gan_tpu/ops/hash_encoder.py:205",
             ("jvp",))):
        rec = grad_timing[case]
        kernels.append(dict(
            name=kname, route="cuda", source="sdface_gan_tpu_torch/ops/csrc/hash_grid.cu",
            replaces=replaces, kernel=rec["kernel"], shape=case,
            launches=sum(r["launches"][kname] for r in ngp_runs)
            + (benched[kname] if kname != "hash_encode_jvp" else 0)
            + results["giraffe_train"]["launches"].get(kname, 0)
            + jvp_launches.get(kname, 0), checked=True,
            max_abs_err=max(r["max_abs_err"][k] for r in grad_checks if r["dtype"] == "float32"
                            for k in outputs),
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    k2_row = next(k for k in kernels if k["name"] == "hash_encode_double_backward")
    k2_row["jvp_table_gradient"] = {k: grad_timing["u_jvp_table_k2"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    giraffe_k1 = results["giraffe_train"]["k1"]
    k1_row = next(k for k in kernels if k["name"] == "hash_encode_backward")
    k1_row["giraffe_g_step"] = {k: giraffe_k1[k] for k in (
        "points", "oob_share", "max_rel_err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")}
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
