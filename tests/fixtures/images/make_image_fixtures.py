#!/usr/bin/env python
"""Write the image fixtures of this directory and PIL's decode of each.

    python tests/fixtures/images/make_image_fixtures.py

Needs PIL (12, with libjpeg-turbo and libwebp: the reference the JAX
package reads images with).  The images are the port's procedural heads
(``sdface_gan_tpu_torch.data.synthetic.render_head``), 178 x 218 as
CelebA's aligned faces: JPEGs in 4:2:0 (qualities 95 and 75, the latter
with optimised Huffman tables), 4:2:2, 4:4:4, grey and 4:2:0 with restart
markers; WebPs lossy, lossless, RGBA with real alpha (VP8X + ALPH) and
extended (VP8X with EXIF and ICCP); then, at 48 x 64, a PIL-written
palette PNG, an Adam7-interlaced 8-bit RGB PNG and a 16-bit RGB PNG built
by hand (PIL writes neither), a 24-bit BMP and the BMP kinds built by hand
(RLE8, RLE4, 5-6-5 bit fields, 16-bit 5-5-5, 32-bit bit fields with an
alpha mask); at 128 x 96, lossy WebPs with the encoder settings PIL's save
cannot reach (the simple loop filter, 4 and 8 token partitions, one
segment, sharpness 7, no loop filter), written by the libwebp that PIL
bundles through its advanced API (ctypes, here only); at 512^2, a lossy
and a lossless WebP of a head with a little noise, for the decoders'
timing.  Beside each file
``<name>.npy`` holds ``Image.open(<name>).convert("RGB")``:
``chip_smoke.py`` holds the port's decoders against it on the card's
machine, which has no PIL.
"""

import ctypes
import glob
import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def heads(n: int, res: int, seed: int) -> list:
    from sdface_gan_tpu_torch.data.synthetic import render_head

    rng = np.random.default_rng(seed)
    return [np.clip(render_head(rng, res) * 255 + 0.5, 0, 255).astype(np.uint8)
            for _ in range(n)]


_CONFIG_FIELDS = (  # libwebp's WebPConfig, in order (all int but two floats)
    "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
    "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
    "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
    "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
    "qmax")
_ABI = 0x020F  # an encoder ABI of major version 2, which libwebp 1.x accepts


class _Config(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int)
                for n in _CONFIG_FIELDS] + [("pad", ctypes.c_uint32 * 8)]


class _Picture(ctypes.Structure):  # libwebp's WebPPicture
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int), ("y", ctypes.c_void_p),
                ("u", ctypes.c_void_p), ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
                ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2)]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]


def bundled_libwebp() -> ctypes.CDLL:
    """The libwebp that PIL bundles (its dependencies loaded by importing
    PIL's WebP module first)."""
    from PIL import _webp

    libs = os.path.join(os.path.dirname(os.path.dirname(_webp.__file__)), "pillow.libs")
    found = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    if not found:
        raise RuntimeError(f"no bundled libwebp under {libs}")
    return ctypes.CDLL(found[0])


def webp_advanced(img: np.ndarray, quality: float, **settings) -> bytes:
    """A lossy WebP of RGB ``img`` from libwebp's advanced encoder, with
    WebPConfig fields PIL's save does not expose (``filter_type``,
    ``partitions``, ``segments``, ``filter_sharpness``,
    ``filter_strength``)."""
    lib = bundled_libwebp()
    cfg = _Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), _ABI):
        raise RuntimeError("WebPConfigInit failed")
    for k, v in settings.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise RuntimeError(f"libwebp refuses the settings {settings}")
    pic = _Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI):
        raise RuntimeError("WebPPictureInit failed")
    rgb = np.ascontiguousarray(img, np.uint8)
    pic.height, pic.width = rgb.shape[:2]
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not lib.WebPPictureImportRGB(ctypes.byref(pic), rgb.ctypes.data_as(ctypes.c_void_p),
                                        3 * pic.width):
            raise RuntimeError("WebPPictureImportRGB failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
        pic.custom_ptr = ctypes.addressof(writer)
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed (error {pic.error_code})")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def _webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def main() -> int:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_port_images import (
        WEBP_ENCODER_FIXTURES,
        bmp_bitfield_bytes,
        bmp_rle_bytes,
        png_bytes,
        vp8_header_fields,
    )

    faces = [h[:, 20:198] for h in heads(6, 218, seed=0)]  # 218 high, 178 wide
    small = heads(3, 64, seed=1)
    files = {}
    for name, img, kw in (("head_420_q95.jpg", faces[0], dict(quality=95, subsampling=2)),
                          ("head_420_q75_optimized.jpg", faces[1],
                           dict(quality=75, subsampling=2, optimize=True)),
                          ("head_422.jpg", faces[2], dict(quality=90, subsampling=1)),
                          ("head_444.jpg", faces[3], dict(quality=90, subsampling=0)),
                          ("head_grey.jpg", faces[4][..., 1], dict(quality=90)),
                          ("head_restart.jpg", faces[5],
                           dict(quality=90, subsampling=2, restart_marker_blocks=6))):
        path = os.path.join(HERE, name)
        Image.fromarray(img).save(path, "JPEG", **kw)
        files[name] = open(path, "rb").read()
    buf = io.BytesIO()
    Image.fromarray(small[0][:48]).convert("P").save(buf, "PNG")
    files["head_palette.png"] = buf.getvalue()
    files["head_interlaced.png"] = png_bytes(small[1][:48], 2, 8, 1)
    files["head_rgb16.png"] = png_bytes(small[2][:48].astype(np.int64) * 257 + 3, 2, 16, 0)
    buf = io.BytesIO()
    Image.fromarray(small[0][16:]).save(buf, "BMP")
    files["head.bmp"] = buf.getvalue()

    # WebP: CelebA-sized heads from PIL's save
    webp_faces = [h[:, 20:198] for h in heads(4, 218, seed=2)]
    yy, xx = np.mgrid[:218, :178]
    alpha = np.clip(255 - np.hypot(yy - 109, xx - 89) * 2.2, 0, 255).astype(np.uint8)
    files["webp_lossy.webp"] = _webp(webp_faces[0], quality=80)
    files["webp_lossless.webp"] = _webp(webp_faces[1], lossless=True)
    files["webp_alpha.webp"] = _webp(np.dstack([webp_faces[2], alpha]), quality=80)
    files["webp_extended.webp"] = _webp(webp_faces[3], quality=90, icc_profile=bytes(range(131)),
                                        exif=b"Exif\0\0II*\0\x08\0\0\0\0\0")
    assert b"ALPH" in files["webp_alpha.webp"] and b"EXIF" in files["webp_extended.webp"]
    # the encoder settings PIL's save cannot reach (partitions need method <= 2)
    mid = heads(1, 128, seed=3)[0][:, 16:112]  # 128 high, 96 wide
    settings = {"webp_simple_filter.webp": dict(filter_type=0),
                "webp_partitions4.webp": dict(partitions=2, method=2),
                "webp_partitions8.webp": dict(partitions=3, method=2),
                "webp_one_segment.webp": dict(segments=1),
                "webp_sharpness7.webp": dict(filter_sharpness=7),
                "webp_no_filter.webp": dict(filter_strength=0)}
    for name, kw in settings.items():
        files[name] = webp_advanced(mid, 80.0, **kw)
        field, value = WEBP_ENCODER_FIXTURES[name]
        assert vp8_header_fields(files[name])[field] == value, name
    big = heads(1, 512, seed=4)[0]  # with a little noise, as a photo's sensor leaves it
    big = np.clip(big + np.random.default_rng(5).normal(0, 1.5, big.shape), 0, 255).astype(np.uint8)
    files["webp_lossy_512.webp"] = _webp(big, quality=80)
    files["webp_lossless_512.webp"] = _webp(big, lossless=True)

    # BMP kinds built by hand (PIL writes none of them)
    bmp_src = small[1][16:]
    pal_img = Image.fromarray(bmp_src).quantize(256)
    pal = np.asarray(pal_img.getpalette()[:768]).reshape(-1, 3)
    files["bmp_rle8.bmp"] = bmp_rle_bytes(np.asarray(pal_img), False, pal)
    pal_img = Image.fromarray(bmp_src).quantize(16)
    pal = np.asarray(pal_img.getpalette()[:48]).reshape(-1, 3)
    files["bmp_rle4.bmp"] = bmp_rle_bytes(np.asarray(pal_img), True, pal)
    files["bmp_bitfields565.bmp"] = bmp_bitfield_bytes(bmp_src, 16, (0xF800, 0x7E0, 0x1F))
    files["bmp_rgb555.bmp"] = bmp_bitfield_bytes(bmp_src, 16, (0x7C00, 0x3E0, 0x1F),
                                                 compression=0)
    files["bmp_bitfields_alpha.bmp"] = bmp_bitfield_bytes(
        bmp_src, 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=124)
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        np.save(os.path.join(HERE, name + ".npy"),
                np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    total = 0
    for name in sorted(os.listdir(HERE)):
        size = os.path.getsize(os.path.join(HERE, name))
        total += size
        print(f"{name}  {size} bytes")
    print(f"total {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
