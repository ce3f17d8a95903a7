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
timing; at 178 x 218, the JPEG kinds: PIL's progressive (4:2:0 with
optimised tables, with restart markers) and CMYK files, and, from
``../jpeg_writer.c`` (built here with gcc against libjpeg's headers and linked
to PIL's bundled libjpeg-turbo, skipped without them), arithmetic-coded
sequential and progressive files with restart markers and DAC
conditioning, lossless files (predictor 1; predictor 7 with point
transform 2 over 4:2:0), CMYK and YCCK, samplings h1v2, h4v1, h4v2 and
chroma above luma, and a progressive file whose scans leave AC bits
unrefined (libjpeg block-smooths it); then animated WebPs assembled by hand
from PIL-written stills (a full-canvas lossy first frame, a lossless first
frame smaller than the canvas at an offset, a first frame with ALPH asking
for alpha-blending) and one from PIL's ``save_all``.  Beside each file
``<name>.npy`` holds ``Image.open(<name>).convert("RGB")``:
``chip_smoke.py`` holds the port's decoders against it on the card's
machine, which has no PIL.
"""

import ctypes
import glob
import io
import os
import sys
import tempfile

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
        animated_webp_bytes,
        bmp_bitfield_bytes,
        bmp_rle_bytes,
        png_bytes,
        vp8_header_fields,
    )
    from test_torch_port_images_jpeg import SCAN_SCRIPTS, build_jpeg_writer, write_jpeg

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
    # JPEG kinds PIL writes: progressive (4:2:0 with optimised tables; with
    # restart markers) and CMYK
    jpeg_faces = [h[:, 20:198] for h in heads(4, 218, seed=6)]
    for name, img, kw in (("jpeg_progressive_420_optimized.jpg", jpeg_faces[0],
                           dict(quality=90, subsampling=2, progressive=True, optimize=True)),
                          ("jpeg_progressive_restart.jpg", jpeg_faces[1],
                           dict(quality=85, subsampling=2, progressive=True,
                                restart_marker_blocks=5)),
                          ("jpeg_cmyk_pil.jpg", Image.fromarray(jpeg_faces[2]).convert("CMYK"),
                           dict(quality=90))):
        path = os.path.join(HERE, name)
        (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(path, "JPEG", **kw)
        files[name] = open(path, "rb").read()
    # the kinds PIL's save cannot write, from jpeg_writer.c over PIL's
    # bundled libjpeg-turbo (without gcc or the library the committed files stay)
    with tempfile.TemporaryDirectory() as build:
        exe = build_jpeg_writer(build)
        if exe is None:
            print("jpeg_writer.c not built (no gcc, libjpeg headers or PIL's libjpeg-turbo): "
                  "the committed jpeg_* writer fixtures are kept")
        else:
            face = jpeg_faces[3]
            yy, xx = np.mgrid[:218, :178]
            cmyk = np.dstack([255 - face, (40 + 60 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
                                           + 60).astype(np.uint8)])
            for name, img, kw in (
                    ("jpeg_arith.jpg", face, dict(arith=1, restart=5, dac="1,3,8")),
                    ("jpeg_arith_progressive.jpg", face,
                     dict(arith=1, progressive=1, restart=7, dac="2,4,12")),
                    ("jpeg_lossless_p1.jpg", face, dict(lossless="1,0")),
                    ("jpeg_lossless_p7_pt2_420.jpg", face,
                     dict(lossless="7,2", sampling="2x2,1x1,1x1")),
                    ("jpeg_cmyk.jpg", cmyk, dict(space="cmyk")),
                    ("jpeg_ycck.jpg", cmyk, dict(space="ycck", sampling="2x2,1x1,1x1,2x2")),
                    ("jpeg_h1v2.jpg", face, dict(sampling="1x2,1x1,1x1")),
                    ("jpeg_h4v1.jpg", face, dict(sampling="4x1,1x1,1x1")),
                    ("jpeg_h4v2.jpg", face, dict(sampling="4x2,1x1,1x1")),
                    ("jpeg_chroma_above_luma.jpg", face, dict(sampling="1x1,2x2,2x2")),
                    ("jpeg_progressive_smoothed.jpg", face,
                     dict(scans=SCAN_SCRIPTS["ac_unrefined"], sampling="2x2,1x1,1x1"))):
                files[name] = write_jpeg(exe, img, quality=85, **kw)

    # animated WebP: frame 1 on its canvas (PIL's animation decoder)
    anim_faces = [h[:, 20:198] for h in heads(3, 218, seed=7)]
    lossy_full = _webp(anim_faces[0], quality=80)
    lossless_part = _webp(anim_faces[1][30:180, 20:140], lossless=True)  # 120 x 150
    yy, xx = np.mgrid[:160, :140]
    ring = np.clip(255 - np.hypot(yy - 80, xx - 70) * 3, 0, 255).astype(np.uint8)
    alpha_part = _webp(np.dstack([anim_faces[2][20:180, 10:150], ring]), quality=80)
    assert b"ALPH" in alpha_part
    files["webp_anim_lossy.webp"] = animated_webp_bytes(
        (178, 218), [(lossy_full, 0, 0, 0), (lossless_part, 20, 34, 0)])
    files["webp_anim_lossless_offset.webp"] = animated_webp_bytes(
        (178, 218), [(lossless_part, 20, 34, 0), (lossy_full, 0, 0, 2)])
    files["webp_anim_alpha.webp"] = animated_webp_bytes(  # alpha-blending asked of frame 1
        (178, 218), [(alpha_part, 10, 20, 1), (lossy_full, 0, 0, 0)], alpha=True)
    buf = io.BytesIO()
    frames = [Image.fromarray(f) for f in anim_faces]
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=60, quality=80)
    files["webp_anim_pil.webp"] = buf.getvalue()

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
