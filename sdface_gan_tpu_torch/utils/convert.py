"""JAX parameter tree -> the port's ``state_dict``.

The inverse of ``sdface_gan_tpu/utils/torch_import.py``: takes the nested
dict that ``init_generator`` or ``import_generator_state`` returns (leaves
as numpy arrays or anything ``np.asarray`` takes) and gives tensors under
the reference ``g_ema`` names, which the port's ``Generator`` uses.

* linear ``{"w": [in, out], "b"}`` -> ``weight`` [out, in], ``bias``
* modconv HWIO [k, k, I, O] -> ``weight`` [1, O, I, k, k]
* noise [1, r, r, 1] -> [1, 1, r, r]
* ToRGB bias [1, 1, 1, 3] -> [1, 3, 1, 1]
* NGP hash table -> ``renderer.network.encoder.embeddings`` (a corner-packed
  inference table, if the tree carries one, is left out: it is rebuilt at
  load)

Values are copied bit for bit, for every field type ('sdf', 'ngp', 'fc').
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def jax_params_to_state_dict(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Convert a JAX generator parameter tree for ``cfg`` (a
    ``GeneratorConfig``) into the port's state dict."""
    sd: Dict[str, np.ndarray] = {}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[f"{prefix}.bias"] = np.asarray(p["b"])

    def film(prefix, p):
        lin(prefix, p)
        lin(f"{prefix}.gamma", p["gamma"])
        lin(f"{prefix}.beta", p["beta"])

    def modconv(prefix, p):
        sd[f"{prefix}.weight"] = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))[None]
        lin(f"{prefix}.modulation", p["modulation"])

    def styled(prefix, p):
        modconv(f"{prefix}.conv", p["conv"])
        sd[f"{prefix}.noise.weight"] = np.asarray(p["noise_weight"])
        sd[f"{prefix}.activate.bias"] = np.asarray(p["act_bias"])

    def to_rgb(prefix, p):
        modconv(f"{prefix}.conv", p["conv"])
        sd[f"{prefix}.bias"] = np.transpose(np.asarray(p["bias"]), (0, 3, 1, 2))

    for i, p in enumerate(params["mapping"]):
        lin(f"style.{i}", p)
    renderer = params["renderer"]
    if "sigmoid_beta" in renderer:
        sd["renderer.sigmoid_beta"] = np.asarray(renderer["sigmoid_beta"])
    net, prefix = renderer["network"], "renderer.network"
    if cfg.renderer.type == "fc":
        lin(f"{prefix}.x_in", net["x_in"])
        lin(f"{prefix}.style_in", net["style_in"])
        for i, p in enumerate(net["pts_linears"]):
            lin(f"{prefix}.pts_linears.{i}", p)
        lin(f"{prefix}.views_linears", net["views_linear"])
    else:
        if cfg.renderer.type == "ngp":
            sd[f"{prefix}.encoder.embeddings"] = np.asarray(net["hash_table"])
            lin(f"{prefix}.input_linear", net["input_linear"])
        for i, p in enumerate(net["pts_linears"]):
            film(f"{prefix}.pts_linears.{i}", p)
        film(f"{prefix}.views_linears", net["views_linear"])
    lin(f"{prefix}.rgb_linear", net["rgb_linear"])
    lin(f"{prefix}.sigma_linear", net["sigma_linear"])

    if cfg.full_pipeline:
        dec = params["decoder"]
        for i, p in enumerate(dec["mapping"]):
            lin(f"decoder.style.{i + 1}", p)  # decoder.style.0 is PixelNorm
        styled("decoder.conv1", dec["conv1"])
        to_rgb("decoder.to_rgb1", dec["to_rgb1"])
        for i, p in enumerate(dec["convs"]):
            styled(f"decoder.convs.{i}", p)
        for i, p in enumerate(dec["to_rgbs"]):
            to_rgb(f"decoder.to_rgbs.{i}", p)
        for i, n in enumerate(dec["noises"]):
            sd[f"decoder.noises.noise_{i}"] = np.transpose(np.asarray(n), (0, 3, 1, 2))
    return _tensors(sd)


def _tensors(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def jax_disc_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a JAX discriminator parameter tree (``init_volume_render_
    discriminator`` or ``init_style_discriminator``; the StyleGAN2 D is told
    by its ``final_linear1``) into the port's ``VolumeRenderDiscriminator``
    or ``StyleDiscriminator`` state dict, bit for bit.

    * conv HWIO [k, k, I, O] -> ``weight`` [O, I, k, k]; ``b`` -> ``bias``
    * ``final_linear1`` [h*w*c, out] (the JAX D flattens (h, w, c)) ->
      ``weight`` [out, c*h*w] (the port flattens (c, h, w))
    """
    sd: Dict[str, np.ndarray] = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))
        if "b" in p:
            sd[f"{prefix}.bias"] = np.asarray(p["b"])

    def act(prefix, p):
        if "act_bias" in p:
            sd[f"{prefix}.act_bias"] = np.asarray(p["act_bias"])

    if "final_linear1" not in params:  # VolumeRenderDiscriminator
        for prefix, p in [("conv_in", params["conv_in"]), ("final", params["final"])] + [
                (f"blocks.{i}.{name}", blk[name])
                for i, blk in enumerate(params["blocks"]) for name in blk]:
            conv(prefix, p)
            act(prefix, p)
        return _tensors(sd)

    layers = [("conv_in", params["conv_in"]), ("final_conv", params["final_conv"])] + [
        (f"blocks.{i}.{name}", blk[name])
        for i, blk in enumerate(params["blocks"]) for name in blk]
    for prefix, p in layers:
        conv(f"{prefix}.conv", p["conv"])
        act(prefix, p)
    w1 = np.asarray(params["final_linear1"]["w"])
    c = w1.shape[0] // 16  # the last feature map is [4, 4, c]
    sd["final_linear1.weight"] = w1.reshape(4, 4, c, -1).transpose(3, 2, 0, 1).reshape(
        w1.shape[1], -1)
    sd["final_linear1.bias"] = np.asarray(params["final_linear1"]["b"])
    sd["final_linear2.weight"] = np.asarray(params["final_linear2"]["w"]).T
    sd["final_linear2.bias"] = np.asarray(params["final_linear2"]["b"])
    return _tensors(sd)
