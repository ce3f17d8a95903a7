"""Rank processes for the port's data-parallel checks, JAX-free.

``spawn(job, world, payload)`` (or :func:`start`, which returns while they
run) starts ``world`` processes of this file, each
of which joins a gloo group (a ``file://`` rendezvous of its own, so that
concurrent test workers never meet), adopts it with the port's
``parallel.make_mesh`` and runs ``JOBS[job](mesh, payload)`` on the
payload's device (the CPU, or ``cuda:0`` shared by every rank: gloo offers
broadcast and all-reduce on CUDA tensors).  A payload is a dict saved with
``torch.save``; each rank returns a dict, saved for the caller, who gets the
list of the ranks' dicts.  :func:`run_cases` also runs in the caller with
``mesh=None``: the one-rank reference of the same cases at the global batch.

Each step case returns its metrics, the gradients the optimizer received
(all-reduced over the ranks, captured by :class:`Capture`), with ``naive``
the gradients of the naive per-rank version (the loss outside
``parallel.over``: every coupling of the batch taken over the rank's rows
alone, the gradients averaged as plain DDP would), and the parameters after
one real optimizer step (bit-equal across the ranks, or the ranks drifted).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


class Capture(torch.optim.Adam):
    """Adam (lr 1e-3) that first records each parameter's ``.grad`` by name:
    the gradient the step received, then the parameters after it."""

    def __init__(self, named):
        named = list(named)
        super().__init__([p for _, p in named], lr=1e-3)
        self.names = {id(p): n for n, p in named}
        self.grads: Dict[str, torch.Tensor] = {}

    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                self.grads[self.names[id(p)]] = p.grad.detach().cpu().clone()
        return super().step(closure)


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple):
        parts = [_to(x, device) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    if isinstance(tree, list):
        return [_to(x, device) for x in tree]
    return tree


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


# ------------------------------------------------------------------ the step cases
def _module(cls, cfg, weights, on, **kw):
    """``cls(cfg, **kw)`` on the device ``on`` with ``weights``: a state dict,
    or an int seeding the module's own initialization (alike on every rank)."""
    if isinstance(weights, int):
        return cls(cfg, generator=torch.Generator().manual_seed(weights), **kw).to(on)
    m = cls(cfg, **kw).to(on)
    m.load_state_dict(weights)
    return m


def _live(inputs, case, device):
    """``inputs`` with a fresh generator of the case's ``gen_seed`` (the
    draws inside the step: depth jitter, noise, eikonal points), or as they
    are (deterministic)."""
    if case.get("gen_seed") is None:
        return inputs
    return inputs._replace(generator=torch.Generator(device=device).manual_seed(case["gen_seed"]))


def _sdf_modules(case, device):
    from sdface_gan_tpu_torch.models.discriminator import (
        StyleDiscConfig,
        StyleDiscriminator,
        VolumeRenderDiscriminator,
    )
    from sdface_gan_tpu_torch.models.generator import Generator

    g = _module(Generator, case["gcfg"], case["g"], device, device=device)
    d_cls = StyleDiscriminator if isinstance(case["dcfg"], StyleDiscConfig) else \
        VolumeRenderDiscriminator
    return g, _module(d_cls, case["dcfg"], case["d"], device)


def _sdf_case(case, mesh, naive, device, masks=None):
    from sdface_gan_tpu_torch.parallel import shard_batch
    from sdface_gan_tpu_torch.training import steps

    kind, hp, gcfg, dcfg = case["kind"], case["hp"], case["gcfg"], case["dcfg"]
    g, d = _sdf_modules(case, device)
    rows = shard_batch(_to(case["inputs"], device), mesh)
    real = shard_batch(_to(case.get("real"), device), mesh)
    decoder = kind in ("b_g", "b_path")  # stage B trains the decoder alone
    trained = d if kind.endswith("_d") else (g.decoder if decoder else g)
    prefix = "decoder." if decoder else ""

    def run(opt, naive_run):
        inputs = _live(rows, case, device)
        if kind == "a_d":
            def loss_fn():
                return steps.stage_a_d_loss(g, d, gcfg, dcfg, hp, real, inputs)

            def step_fn():
                return steps.stage_a_d_step(g, d, opt, gcfg, dcfg, hp, real, inputs, mesh=mesh)
        elif kind == "a_g":
            ema = copy.deepcopy(g).requires_grad_(False)

            def loss_fn():
                return steps.stage_a_g_loss(g, d, gcfg, dcfg, hp, inputs)

            def step_fn():
                return steps.stage_a_g_step(g, d, opt, ema, gcfg, dcfg, hp, inputs, mesh=mesh)
        elif kind == "b_d":
            def loss_fn():
                return steps.stage_b_d_loss(g, d, gcfg, dcfg, hp, real, inputs, True)

            def step_fn():
                return steps.stage_b_d_step(g, d, opt, gcfg, dcfg, hp, real, inputs, True,
                                            mesh=mesh)
        elif kind == "b_g":
            def loss_fn():
                return steps.stage_b_g_loss(g, d, gcfg, dcfg, hp, inputs)

            def step_fn():
                return steps.stage_b_g_step(g, d, opt, gcfg, dcfg, hp, inputs, mesh=mesh)
        else:  # b_path
            mpl = case["mean_path_length"].to(device)

            def loss_fn():
                loss, new_mean, m = steps.stage_b_path_loss(g, gcfg, hp, inputs, mpl)
                return loss, {**m, "mean_path_length": new_mean}

            def step_fn():
                new_mean, m = steps.stage_b_path_step(g, opt, gcfg, hp, inputs, mpl, mesh=mesh)
                return {**m, "mean_path_length": new_mean}
        if naive_run:  # per-rank statistics, gradients averaged as plain DDP does
            loss, m = loss_fn()
            steps._step(opt, loss, mesh)
            return m
        return step_fn()

    return _run_trained(trained, prefix, run, naive, masks)


def _sync(module):
    p = next(module.parameters())
    if p.is_cuda:
        torch.cuda.synchronize(p.device)


def _run_trained(module, prefix, run, naive, masks=None):
    """One step with :class:`Capture`: its gradients, metrics, milliseconds
    (the host clock between two synchronisations, the capture's copies to the
    host included) and the parameters after it; with ``naive``, first the
    naive version's gradients (from a copy of the parameters, restored).
    ``masks``: keywords of ``torch_masks.leaky_relu_masks`` for the step (its
    kinked activations' masks recorded, or replayed)."""
    named = [(prefix + n, p) for n, p in module.named_parameters() if p.requires_grad]
    out = {}
    with torch.enable_grad(), _masks(masks):
        if naive:
            saved = [p.detach().clone() for _, p in named]
            cap = Capture(named)
            out["naive_metrics"] = _floats(run(cap, True))
            out["naive_grads"] = cap.grads
            with torch.no_grad():
                for (_, p), v in zip(named, saved):
                    p.copy_(v)
        cap = Capture(named)
        _sync(module)
        t0 = time.perf_counter()
        out["metrics"] = _floats(run(cap, False))
        _sync(module)
    out.update(grads=cap.grads, step_ms=(time.perf_counter() - t0) * 1e3,
               params={n: p.detach().cpu().clone() for n, p in named})
    return out


def _masks(spec):
    if spec is None:
        return contextlib.nullcontext()
    from torch_masks import leaky_relu_masks

    return leaky_relu_masks(**spec)


def _vae_case(case, mesh, naive, device):
    from sdface_gan_tpu_torch.encoder import LossUtils, VAEEncoder
    from sdface_gan_tpu_torch.models.generator import Generator
    from sdface_gan_tpu_torch.parallel import shard_batch
    from sdface_gan_tpu_torch.training import encoder_loop, steps

    g = _module(Generator, case["gcfg"], case["g"], device, device=device)
    g.requires_grad_(False)
    e = _module(VAEEncoder, case["ecfg"], case["e"], device)
    rows = shard_batch(_to(case["inputs"], device), mesh)
    lu = LossUtils()

    def run(opt, naive_run):
        inputs = _live(rows, case, device)
        if naive_run:
            loss, m = encoder_loop.encoder_loss(e, g, case["gcfg"], case["ecfg"], lu, inputs)
            steps._step(opt, loss, mesh)
            return m
        return encoder_loop.encoder_step(e, g, opt, case["gcfg"], case["ecfg"], lu, inputs,
                                         mesh=mesh)

    return _run_trained(e, "", run, naive)


def _giraffe_case(case, mesh, naive, device):
    from sdface_gan_tpu_torch.encoder.vae import VAEEncoder
    from sdface_gan_tpu_torch.giraffe import trainer
    from sdface_gan_tpu_torch.giraffe.discriminator import DCDiscriminator
    from sdface_gan_tpu_torch.giraffe.generator import GiraffeGenerator
    from sdface_gan_tpu_torch.parallel import shard_batch

    kind, cfg, hp = case["kind"], case["gcfg"], case["hp"]
    g = GiraffeGenerator(cfg).to(device)
    g.load_state_dict(case["g"])
    d = DCDiscriminator(case["dcfg"]).to(device)
    d.load_state_dict(case["d"])
    draws = shard_batch(_to(case["draws"], device), mesh)
    x_real = shard_batch(_to(case["real"], device), mesh)
    e = None
    if kind == "giraffe_e":
        e = VAEEncoder(case["ecfg"]).to(device)
        e.load_state_dict(case["e"])
    module = {"giraffe_d": d, "giraffe_g": g, "giraffe_e": e}[kind]

    def run(opt, naive_run):
        if kind == "giraffe_d":
            if naive_run:
                loss, m = trainer.giraffe_d_loss(g, d, cfg, hp, x_real, draws)
                trainer.update(opt, d, loss, mesh)
                return m
            return trainer.giraffe_d_step(g, d, opt, cfg, hp, x_real, draws, mesh)
        if kind == "giraffe_g":
            return trainer.giraffe_g_step(g, d, opt, copy.deepcopy(g), cfg, hp, draws, mesh)
        if naive_run:
            with trainer.frozen(g, d):
                loss, m = trainer.giraffe_e_loss(e, g, d, cfg, x_real, draws)
                trainer.update(opt, e, loss, mesh, op="sum")
            return m
        return trainer.giraffe_e_step(e, g, d, opt, cfg, x_real, draws, mesh)

    return _run_trained(module, "", run, naive)


def run_cases(mesh, payload, masks=None) -> Dict[str, Any]:
    """Every step case of the payload on this rank's rows (``mesh=None``: one
    rank at the global batch); ``masks``: case name -> the SDF step's
    ``leaky_relu_masks`` keywords."""
    device = torch.device(payload.get("device", "cpu"))
    out = {}
    for name, case in payload["cases"].items():
        kind = case["kind"]
        naive = bool(case.get("naive")) and mesh is not None
        if masks and name in masks:
            out[name] = _sdf_case(case, mesh, naive, device, masks[name])
            continue
        fn = (_vae_case if kind == "vae_e" else
              _giraffe_case if kind.startswith("giraffe") else _sdf_case)
        out[name] = fn(case, mesh, naive, device)
    return out


# ------------------------------------------------------------------ serving jobs
def run_serving(mesh, payload) -> Dict[str, Any]:
    """The sampler at the payload's global batch and the ray-sharded probe."""
    from sdface_gan_tpu_torch.models.generator import Generator
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.parallel import place_ray_sharded, render_ray_sharded
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    device = torch.device(payload.get("device", "cpu"))
    out = {}
    for i, s in enumerate(payload.get("samplers", [])):
        model = _module(Generator, s["gcfg"], s["g"], device, device=device)
        if s.get("dtype"):
            model = model.to(getattr(torch, s["dtype"]))
        try:
            SDFaceSampler(model, batch=s["batch"] + 1, mesh=mesh)
        except ValueError as err:
            out["divide_error"] = str(err)
        sampler = SDFaceSampler(model, batch=s["batch"], mesh=mesh, **s.get("kwargs", {}))
        _ext.reset_launch_counts()
        out[f"images{i}"] = sampler.sample(**s.get("sample", {})).float().cpu()
        out[f"launches{i}"] = dict(_ext.LAUNCHES)
        if s.get("profile"):
            out["kernels"] = _profiled_names(lambda: sampler.sample(**s.get("sample", {})))
    if "rays" in payload:
        r = payload["rays"]
        model = _module(Generator, r["gcfg"], r["g"], device, device=device)
        args = [_to(t, device) for t in r["args"]]
        pack = None
        if r.get("fused"):
            from sdface_gan_tpu_torch.ops.siren_kernel import pack_siren_field

            pack = pack_siren_field(model.renderer.network)
        _ext.reset_launch_counts()
        with torch.inference_mode():
            ro = render_ray_sharded(model.renderer, r["gcfg"].renderer, *args, mesh,
                                    field_pack=pack)
        out["rays_launches"] = dict(_ext.LAUNCHES)
        out["rays"] = {k: getattr(ro, k).float().cpu() for k in ("rgb", "sdf")
                       if getattr(ro, k) is not None}
        out["band"] = place_ray_sharded(ro.rgb, mesh).float().cpu()
        if mesh is not None:  # an image height the world does not divide
            from dataclasses import replace

            bad = replace(r["gcfg"].renderer, out_im_res=r["gcfg"].renderer.out_im_res + 1)
            try:
                render_ray_sharded(model.renderer, bad, *args, mesh)
            except ValueError as err:
                out["rays_divide_error"] = str(err)
        if r.get("profile"):
            out["kernels"] = out.get("kernels", []) + _profiled_names(
                lambda: render_ray_sharded(model.renderer, r["gcfg"].renderer, *args, mesh,
                                           field_pack=pack))
    return out


@contextlib.contextmanager
def plain_field_calls():
    """Count the calls of the plain SIREN field on CUDA tensors (the fused
    field's plain version and the field module's own forward) inside."""
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


def _profiled_names(fn) -> List[str]:
    from torch.profiler import ProfilerActivity, profile

    # three calls: the profiler can drop some device records of a session
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()})


# ------------------------------------------------------------------ the stage-A loop
def run_loop(mesh, payload) -> Dict[str, Any]:
    """``train_volume_renderer`` on this rank's rows of the payload's global
    batches; its exit code (3 under ``exit_after``) and last step."""
    from sdface_gan_tpu_torch.training.loop import train_volume_renderer

    world = mesh.world if mesh is not None else 1
    rank = mesh.rank if mesh is not None else 0
    k = payload["batch"] // world
    loader = [(img[rank * k:(rank + 1) * k], th[rank * k:(rank + 1) * k])
              for img, th in payload["batches"]]
    exit_after = (payload.get("exit_after") or [None] * world)[rank]
    code = 0
    try:
        train_volume_renderer(loader, payload["gcfg"], payload["dcfg"], payload["hp"],
                              payload["out_dir"], iters=payload["iters"],
                              sphere_init_iters=payload["sphere_init_iters"], save_every=0,
                              sample_every=0, log_every=1, seed=0, exit_after=exit_after,
                              device="cpu", mesh=mesh)
    except SystemExit as e:
        code = e.code
    return {"code": code}


def run_basics(mesh, payload) -> Dict[str, Any]:
    """The mesh's pieces on rank-specific values (the caller holds them
    against the same sums over the global tensors)."""
    from sdface_gan_tpu_torch import parallel
    from sdface_gan_tpu_torch.training.steps import StepInputs

    r = mesh.rank
    x = torch.arange(8 * 3, dtype=torch.float64).reshape(8, 3)
    inputs = StepInputs(x, (x, x), None, torch.tensor(3), None)
    sharded = parallel.shard_batch(inputs, mesh)
    tuple_kept = (isinstance(sharded, StepInputs) and torch.equal(sharded.cams[1], sharded.z)
                  and sharded.z2 is None and int(sharded.inject_index) == 3)
    module = torch.nn.Linear(3, 2)
    torch.nn.init.normal_(module.weight, generator=torch.Generator().manual_seed(r))
    opt = torch.optim.Adam(module.parameters())
    module(torch.ones(1, 3)).sum().backward()
    opt.step()
    parallel.replicate([module, opt], mesh)
    grads = [torch.full((3,), float(r + 1)), torch.full((2,), float(r + 1), dtype=torch.float64)]
    # the gather, differentiated twice: L_r = sum(c_r * X^3), X the global batch
    gen = torch.Generator().manual_seed(10 + r)
    xr = torch.rand((2, 3), generator=gen, dtype=torch.float64).requires_grad_(True)
    c = torch.rand((4, 3), generator=gen, dtype=torch.float64)
    v = torch.rand((2, 3), generator=gen, dtype=torch.float64)
    gathered = parallel.all_gather_batch(xr, mesh)
    (grad1,) = torch.autograd.grad((c * gathered ** 3).sum(), xr, create_graph=True)
    (grad2,) = torch.autograd.grad((v * grad1).sum(), xr)
    return {"rows": sharded.z, "tuple_kept": tuple_kept, "module": module.weight.detach(),
            "opt_state": opt.state[module.weight]["exp_avg"],
            "mean": parallel.all_reduce_grads(grads, mesh),
            "sum": parallel.all_reduce_grads(grads, mesh, "sum"),
            "x": xr.detach(), "c": c, "v": v, "grad1": grad1.detach(), "grad2": grad2,
            "gathered": gathered.detach()}


def run_card(mesh, payload) -> Dict[str, Any]:
    """The card's check: the step cases and the serving jobs over the ranks
    (serving's plain field calls counted: none on the card; the gradient
    all-reduce's milliseconds and bytes), then on rank 0 the same work as
    one rank at the global batch."""
    from sdface_gan_tpu_torch.parallel import all_reduce_grads, gather_rows

    # the StyleGAN cases record their kinked activations' masks, which rank 0's
    # one-rank step then replays too (a unit within rounding of 0 may take the
    # other slope at batch 8 than at batch 4: chip_smoke.masked_parity's rule)
    recorded = {n: [] for n in payload.get("masked", ())}
    out = {"cases": run_cases(mesh, payload, {n: dict(record=m) for n, m in recorded.items()})}
    gathered = {n: [gather_rows(m.to(torch.uint8), mesh).bool() for m in ms]
                for n, ms in recorded.items()}
    del recorded
    with plain_field_calls() as plain:
        out["serving"] = run_serving(mesh, payload)
    out["plain_field_calls"] = len(plain)
    grads = list(out["cases"][payload["allreduce_case"]]["grads"].values())
    grads = [g.to(payload["device"]) for g in grads]
    sync = torch.cuda.synchronize if grads[0].is_cuda else (lambda: None)
    times = []
    for _ in range(6):
        sync()
        t0 = time.perf_counter()
        all_reduce_grads(grads, mesh)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    out["allreduce"] = dict(ms=sorted(times[1:])[len(times[1:]) // 2],
                            bytes=sum(g.numel() * g.element_size() for g in grads),
                            tensors=len(grads))
    if grads[0].is_cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if mesh.rank == 0:
        one = {k: v for k, v in payload.items()}
        for s in one.get("samplers", []):
            s.pop("profile", None)
        one["rays"] = {k: v for k, v in one["rays"].items() if k != "profile"}
        out["one"] = {"cases": run_cases(None, one), "serving": run_serving(None, one)}
        flips = {n: {} for n in gathered}
        replayed = run_cases(None, dict(one, cases={n: one["cases"][n] for n in gathered}),
                             {n: dict(replay=gathered[n], flips=flips[n]) for n in gathered})
        out["one_replayed"] = {n: dict(replayed[n], flips=flips[n],
                                       unreplayed=len(gathered[n])) for n in gathered}
    return out


def run_group(mesh, payload) -> Dict[str, Any]:
    """Several jobs in one spawn: ``payload`` maps a job's name to its payload."""
    return {job: JOBS[job](mesh, part) for job, part in payload.items()}


JOBS: Dict[str, Callable] = {"cases": run_cases, "serving": run_serving, "loop": run_loop,
                             "basics": run_basics, "card": run_card, "group": run_group}


# ------------------------------------------------------------------ spawning
class Ranks:
    """``world`` rank processes running ``JOBS[job]``, started at once
    (:func:`start`); :meth:`result` waits for them."""

    def __init__(self, job: str, world: int, payload: Dict[str, Any], timeout: float,
                 threads: int):
        self.td = tempfile.mkdtemp()
        torch.save(payload, os.path.join(self.td, "payload.pt"))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO, HERE, os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads))
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        self.deadline = time.time() + timeout
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                                        str(world), self.td, str(threads)], env=env, cwd=REPO,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
                      for r in range(world)]

    def result(self) -> List[Dict[str, Any]]:
        """Each rank's result, in order (raises with the ranks' output if one
        failed)."""
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=max(1.0, self.deadline - time.time()))
                logs.append(out)
            bad = [(r, p.returncode) for r, p in enumerate(self.procs) if p.returncode != 0]
            if bad:
                raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(
                    f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs)))
            return [torch.load(os.path.join(self.td, f"rank{r}.pt"), weights_only=False)
                    for r in range(len(self.procs))]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(self.td, ignore_errors=True)


def start(job: str, world: int, payload: Dict[str, Any], timeout: float = 240.0,
          threads: int = 1) -> Ranks:
    """Start ``JOBS[job]`` on ``world`` gloo ranks; the caller works meanwhile."""
    return Ranks(job, world, payload, timeout, threads)


def spawn(job: str, world: int, payload: Dict[str, Any], timeout: float = 240.0,
          threads: int = 1) -> List[Dict[str, Any]]:
    """Run ``JOBS[job]`` on ``world`` gloo ranks; each rank's result, in order."""
    return start(job, world, payload, timeout, threads).result()


def _main(job: str, rank: int, world: int, td: str, threads: int) -> None:
    import torch.distributed as dist

    from sdface_gan_tpu_torch.parallel import make_mesh

    torch.set_num_threads(threads)
    payload = torch.load(os.path.join(td, "payload.pt"), weights_only=False)
    device = torch.device(payload.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(td, 'rendezvous')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=180))
    try:
        mesh = make_mesh(device)
        assert (mesh.rank, mesh.world) == (rank, world)
        result = JOBS[job](mesh, payload)
        torch.save(_cpu(result) if isinstance(result, dict) else result,
                   os.path.join(td, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]))
