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
The discriminators (``jax_disc_params_to_state_dict``), the FID
Inception (``jax_inception_params_to_state_dict``), stage C's encoders
and perceptual nets (``jax_{vae,psp,irse,lpips}_params_to_state_dict``)
and the GIRAFFE family's generators and discriminators
(``jax_{giraffe,dc_disc,resnet_disc,gan2d}_params_to_state_dict``) have
converters too.
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
        # a decoder at its input's resolution has no convs: an exported tree
        # (``utils/jax_export.py``) then lacks the empty lists
        for i, p in enumerate(dec.get("convs", [])):
            styled(f"decoder.convs.{i}", p)
        for i, p in enumerate(dec.get("to_rgbs", [])):
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


# JAX Inception branch names -> pytorch-fid's, per block kind (the inverse of
# the table in ``sdface_gan_tpu/evaluation/inception.py``'s torch import)
_INCEPTION_BRANCHES = {
    "a": {"b1x1": "branch1x1", "b5x5_1": "branch5x5_1", "b5x5_2": "branch5x5_2",
          "b3x3dbl_1": "branch3x3dbl_1", "b3x3dbl_2": "branch3x3dbl_2",
          "b3x3dbl_3": "branch3x3dbl_3", "bpool": "branch_pool"},
    "b": {"b3x3": "branch3x3", "b3x3dbl_1": "branch3x3dbl_1",
          "b3x3dbl_2": "branch3x3dbl_2", "b3x3dbl_3": "branch3x3dbl_3"},
    "c": {"b1x1": "branch1x1", "b7_1": "branch7x7_1", "b7_2": "branch7x7_2",
          "b7_3": "branch7x7_3", "b7d_1": "branch7x7dbl_1", "b7d_2": "branch7x7dbl_2",
          "b7d_3": "branch7x7dbl_3", "b7d_4": "branch7x7dbl_4", "b7d_5": "branch7x7dbl_5",
          "bpool": "branch_pool"},
    "d": {"b3_1": "branch3x3_1", "b3_2": "branch3x3_2", "b7_1": "branch7x7x3_1",
          "b7_2": "branch7x7x3_2", "b7_3": "branch7x7x3_3", "b7_4": "branch7x7x3_4"},
    "e": {"b1x1": "branch1x1", "b3_1": "branch3x3_1", "b3_2a": "branch3x3_2a",
          "b3_2b": "branch3x3_2b", "b3d_1": "branch3x3dbl_1", "b3d_2": "branch3x3dbl_2",
          "b3d_3a": "branch3x3dbl_3a", "b3d_3b": "branch3x3dbl_3b", "bpool": "branch_pool"},
}
_INCEPTION_BLOCKS = {
    "Mixed_5b": "a", "Mixed_5c": "a", "Mixed_5d": "a", "Mixed_6a": "b",
    "Mixed_6b": "c", "Mixed_6c": "c", "Mixed_6d": "c", "Mixed_6e": "c",
    "Mixed_7a": "d", "Mixed_7b": "e", "Mixed_7c": "e",
}
_INCEPTION_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                   "Conv2d_4a_3x3")


def jax_inception_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a JAX FID Inception tree (``init_inception`` or
    ``import_torch_state_dict``) into the port's ``InceptionV3`` state dict
    under pytorch-fid's names, bit for bit: conv HWIO -> OIHW, ``bn_scale``
    / ``bn_bias`` / ``bn_mean`` / ``bn_var`` -> the BatchNorm's ``weight`` /
    ``bias`` / ``running_mean`` / ``running_var``.  The inverse of the JAX
    package's ``import_torch_state_dict``."""
    sd: Dict[str, np.ndarray] = {}

    def conv_bn(prefix, p):
        sd[f"{prefix}.conv.weight"] = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))
        for ours, theirs in (("weight", "bn_scale"), ("bias", "bn_bias"),
                             ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            sd[f"{prefix}.bn.{ours}"] = np.asarray(p[theirs])

    for stem in _INCEPTION_STEM:
        conv_bn(stem, params[stem])
    for block, kind in _INCEPTION_BLOCKS.items():
        for jax_name, torch_name in _INCEPTION_BRANCHES[kind].items():
            conv_bn(f"{block}.{torch_name}", params[block][jax_name])
    return _tensors(sd)


# --- the encoder family (stage C) -------------------------------------------

def _conv_w(p) -> np.ndarray:
    """HWIO [k, k, I, O] -> OIHW."""
    return np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))


def _put_conv(sd: Dict[str, Any], prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _conv_w(p)
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _put_linear(sd: Dict[str, Any], prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["w"]).T
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _put_stat_bn(sd: Dict[str, Any], prefix: str, p) -> None:
    """ir_se-50 BN {scale, bias, mean, var} -> ``StatNorm`` (nn.BatchNorm names)."""
    for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                         ("running_var", "var")):
        sd[f"{prefix}.{ours}"] = np.asarray(p[theirs])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def jax_vae_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``init_vae_encoder`` tree -> the port's ``VAEEncoder`` state
    dict, bit for bit.  The trunk's ``fc`` [h*w*c, 1024] (the JAX encoder
    flattens (h, w, c)) becomes ``weight`` [1024, c*h*w] (the port flattens
    (c, h, w))."""
    sd: Dict[str, Any] = {}
    for i, block in enumerate(params["blocks"]):
        _put_conv(sd, f"blocks.{i}.conv", block["conv"])
        sd[f"blocks.{i}.bn.weight"] = np.asarray(block["bn"]["scale"])
        sd[f"blocks.{i}.bn.bias"] = np.asarray(block["bn"]["bias"])
    w = np.asarray(params["fc"]["w"])
    f = int(round((w.shape[0] // 256) ** 0.5))  # the last feature map is [f, f, 256]
    sd["fc.weight"] = w.reshape(f, f, 256, -1).transpose(3, 2, 0, 1).reshape(w.shape[1], -1)
    sd["fc_bn.weight"] = np.asarray(params["fc_bn"]["scale"])
    sd["fc_bn.bias"] = np.asarray(params["fc_bn"]["bias"])
    _put_linear(sd, "l_mu", params["l_mu"])
    _put_linear(sd, "l_var", params["l_var"])
    return _tensors(sd)


def _irse_entries(sd: Dict[str, Any], prefix: str, params: Dict[str, Any]) -> None:
    _put_conv(sd, f"{prefix}input_layer.0", params["input_conv"])
    _put_stat_bn(sd, f"{prefix}input_layer.1", params["input_bn"])
    sd[f"{prefix}input_layer.2.weight"] = np.asarray(params["input_prelu"]["alpha"])
    for i, blk in enumerate(params["body"]):
        pre = f"{prefix}body.{i}"
        _put_stat_bn(sd, f"{pre}.res_layer.0", blk["res_bn1"])
        _put_conv(sd, f"{pre}.res_layer.1", blk["conv1"])
        sd[f"{pre}.res_layer.2.weight"] = np.asarray(blk["prelu"]["alpha"])
        _put_conv(sd, f"{pre}.res_layer.3", blk["conv2"])
        _put_stat_bn(sd, f"{pre}.res_layer.4", blk["res_bn2"])
        _put_conv(sd, f"{pre}.res_layer.5.fc1", blk["se_fc1"])
        _put_conv(sd, f"{pre}.res_layer.5.fc2", blk["se_fc2"])
        if "shortcut_conv" in blk:
            _put_conv(sd, f"{pre}.shortcut_layer.0", blk["shortcut_conv"])
            _put_stat_bn(sd, f"{pre}.shortcut_layer.1", blk["shortcut_bn"])
    _put_stat_bn(sd, f"{prefix}output_layer.0", params["out_bn"])
    _put_linear(sd, f"{prefix}output_layer.3", params["out_fc"])  # NCHW flatten on both sides
    _put_stat_bn(sd, f"{prefix}output_layer.4", params["out_bn1d"])


def jax_irse_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``init_irse_backbone`` tree -> the port's ``IRSEBackbone`` state
    dict under upstream's ``model_ir_se50`` names, bit for bit (the inverse
    of the JAX ``import_irse_state``)."""
    sd: Dict[str, Any] = {}
    _irse_entries(sd, "", params)
    return _tensors(sd)


def jax_psp_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``init_psp_encoder`` tree {gse, proj} -> the port's
    ``PSPEncoder`` state dict, bit for bit."""
    sd: Dict[str, Any] = {}
    gse = params["gse"]
    _irse_entries(sd, "gse.backbone.", gse["backbone"])
    for j, style in enumerate(gse["styles"]):
        for k, conv in enumerate(style.get("convs", [])):  # none at small inputs
            _put_conv(sd, f"gse.styles.{j}.convs.{k}", conv)
        _put_linear(sd, f"gse.styles.{j}.linear", style["linear"])
    _put_conv(sd, "gse.latlayer1", gse["latlayer1"])
    _put_conv(sd, "gse.latlayer2", gse["latlayer2"])
    _put_linear(sd, "proj", params["proj"])
    return _tensors(sd)


def jax_lpips_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``init_lpips`` tree -> the port's ``LPIPS`` state dict
    (``alex.features.{0,3,6,8,10}``, ``lins.lin{i}.model.1``), bit for bit."""
    from ..encoder.lpips import ALEX_CONV_IDS

    sd: Dict[str, Any] = {}
    for cid, conv in zip(ALEX_CONV_IDS, params["convs"]):
        _put_conv(sd, f"alex.features.{cid}", conv)
    for i, lin in enumerate(params["lins"]):
        _put_conv(sd, f"lins.lin{i}.model.1", lin)
    return _tensors(sd)


# --- the GIRAFFE family -------------------------------------------------------

def _giraffe_entries(sd: Dict[str, Any], prefix: str, node: Any) -> None:
    """Linears ``{w [in, out], b}`` -> ``weight`` [out, in] / ``bias``, convs
    ``{w HWIO, b}`` -> OIHW, lists -> ``.{i}``, other arrays (``hash_table``,
    ``B_pos``, ``B_view``) as they are."""
    if isinstance(node, dict) and "w" in node:
        w = np.asarray(node["w"])
        if w.ndim == 4:
            _put_conv(sd, prefix, node)
        else:
            _put_linear(sd, prefix, node)
    elif isinstance(node, dict):
        for k, v in node.items():
            _giraffe_entries(sd, f"{prefix}.{k}" if prefix else k, v)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _giraffe_entries(sd, f"{prefix}.{i}", v)
    else:
        sd[prefix] = np.asarray(node)


def jax_giraffe_params_to_state_dict(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """A JAX ``init_giraffe`` tree -> the port's ``GiraffeGenerator`` state
    dict for ``cfg`` (a ``GiraffeConfig``), bit for bit.  Raises when the
    tree's object decoder is not the kind ``cfg`` builds (the small
    decoder of ``--small_net 1``, the hash table of ``--i_embed 1``)."""
    dec = params["decoder"]
    small = "sigma_layers" in dec
    hashed = "hash_table" in dec
    want_hash = cfg.small_decoder or cfg.decoder.positional_encoding == "hash"
    if small != cfg.small_decoder or hashed != want_hash:
        raise ValueError(
            f"the tree's object decoder is {'small' if small else 'the NeRF MLP'}"
            f"{' with' if hashed else ' without'} a hash table; the config wants "
            f"{'small' if cfg.small_decoder else 'the NeRF MLP'}"
            f"{' with' if want_hash else ' without'} one: are --small_net / --i_embed "
            "those of the run?")
    return _plain_tree(params)


def _plain_tree(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, Any] = {}
    _giraffe_entries(sd, "", params)
    return _tensors(sd)


def jax_dc_disc_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``init_dc_discriminator`` tree -> the port's ``DCDiscriminator``
    state dict (``blocks.{i}``, ``conv_out``; HWIO -> OIHW), bit for bit."""
    return _plain_tree(params)


def jax_resnet_disc_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``init_resnet_discriminator`` tree -> the port's
    ``ResnetDiscriminator`` state dict, bit for bit (both flatten NHWC
    before ``fc``, so its weight is only transposed)."""
    return _plain_tree(params)


def jax_gan2d_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``init_gan2d_generator`` tree -> the port's ``Gan2dGenerator``
    state dict, bit for bit (its ``fc`` emits (h, w, c) in both)."""
    return _plain_tree(params)
