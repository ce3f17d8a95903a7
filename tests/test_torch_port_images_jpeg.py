"""The port's JPEG decoder on every kind PIL reads, against PIL, on the CPU.

Beside the baseline files of ``test_torch_port_images.py``: progressive
Huffman files (PIL's ``progressive=True``, and scan scripts that leave
coefficients unrefined, which libjpeg-turbo block-smooths),
arithmetic-coded files (sequential and progressive, with restart markers
and DAC conditioning), lossless files (predictors 1-7, point transforms,
sampled chroma), CMYK and YCCK files and every whole sampling ratio.  PIL
writes what it can; ``fixtures/jpeg_writer.c``, built here with gcc
against libjpeg's headers and linked to the libjpeg-turbo PIL bundles,
writes the rest (its tests skip where gcc, the headers or the library are
missing; the committed fixtures hold the same kinds without them).  The
kinds PIL refuses (12- and 16-bit, hierarchical, lossless
arithmetic-coded, fractional sampling ratios) raise ``ValueError`` saying
that PIL refuses them too.
"""

import glob
import io
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sdface_gan_tpu_torch.data.decode import check_image, decode_image

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
# the committed JPEG fixtures of this slice: name -> (SOF marker, components)
JPEG_KIND_FIXTURES = {"jpeg_progressive_420_optimized.jpg": (0xC2, 3),
                      "jpeg_progressive_restart.jpg": (0xC2, 3),
                      "jpeg_progressive_smoothed.jpg": (0xC2, 3),
                      "jpeg_arith.jpg": (0xC9, 3),
                      "jpeg_arith_progressive.jpg": (0xCA, 3),
                      "jpeg_lossless_p1.jpg": (0xC3, 3),
                      "jpeg_lossless_p7_pt2_420.jpg": (0xC3, 3),
                      "jpeg_cmyk_pil.jpg": (0xC0, 4),
                      "jpeg_cmyk.jpg": (0xC0, 4),
                      "jpeg_ycck.jpg": (0xC0, 4),
                      "jpeg_h1v2.jpg": (0xC0, 3),
                      "jpeg_h4v1.jpg": (0xC0, 3),
                      "jpeg_h4v2.jpg": (0xC0, 3),
                      "jpeg_chroma_above_luma.jpg": (0xC0, 3)}


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _smooth(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth colour waves plus a little noise (as the baseline tests')."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    f = rng.uniform(0.05, 0.3, (3, 2))
    img = np.stack([128 + 90 * np.sin(f[c, 0] * xx + c) * np.cos(f[c, 1] * yy - c)
                    for c in range(3)], -1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _noise(h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _assert_matches_pil(data: bytes, msg: str = "") -> None:
    check_image(data)
    np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=msg)


# ------------------------------------------------------- the C writer
def build_jpeg_writer(out_dir: str):
    """``jpeg_writer.c`` built into ``out_dir`` against libjpeg's headers
    and linked to PIL's bundled libjpeg-turbo; None without gcc, the
    headers or the library."""
    from PIL import _imaging

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(_imaging.__file__)),
                                  "pillow.libs", "libjpeg-*.so*"))
    if not libs or not shutil.which("gcc"):
        return None
    exe = os.path.join(out_dir, "jpeg_writer")
    proc = subprocess.run(["gcc", "-O1", "-o", exe, str(FIXTURES.parent / "jpeg_writer.c"), libs[0],
                           f"-Wl,-rpath,{os.path.dirname(libs[0])}"], capture_output=True)
    return exe if proc.returncode == 0 else None


def write_jpeg(exe: str, img: np.ndarray, **settings) -> bytes:
    """JPEG bytes of ``img`` ([H, W] grey, [H, W, 3] RGB or [H, W, 4] CMYK)
    from the C writer with its ``key=value`` settings."""
    img = np.ascontiguousarray(img, np.uint8)
    nc = 1 if img.ndim == 2 else img.shape[2]
    with tempfile.TemporaryDirectory() as d:
        raw, out = os.path.join(d, "in.raw"), os.path.join(d, "out.jpg")
        img.tofile(raw)
        proc = subprocess.run([exe, out, raw, str(img.shape[1]), str(img.shape[0]), str(nc)]
                              + [f"{k}={v}" for k, v in settings.items()], capture_output=True)
        if proc.returncode:
            raise RuntimeError(f"jpeg_writer {settings}: {proc.stderr.decode()}")
        return Path(out).read_bytes()


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    exe = build_jpeg_writer(str(tmp_path_factory.mktemp("jpeg_writer")))
    if exe is None:
        pytest.skip("no gcc, libjpeg headers or PIL-bundled libjpeg-turbo to build jpeg_writer.c")
    return exe


# ------------------------------------------------------ progressive
def _pil_jpeg(img, tmp_path, **kw) -> bytes:
    path = tmp_path / "x.jpg"  # progressive and optimize need a real file at large sizes
    Image.fromarray(img).save(path, "JPEG", **kw)
    return path.read_bytes()


@pytest.mark.parametrize("variant", ["plain", "optimize", "restart"])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (218, 178)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 95])
def test_progressive_jpeg_matches_pil(quality, subsampling, size, variant, tmp_path):
    """PIL's ``progressive=True`` (libjpeg's default scan script: DC and
    AC first scans, successive-approximation refinements, end-of-band runs)
    at two qualities, three samplings and sizes with odd edges, plain, with
    optimised tables or with restart markers."""
    kw = {"plain": {}, "optimize": {"optimize": True},
          "restart": {"restart_marker_blocks": 3}}[variant]
    for img in (_smooth(*size, seed=quality), _noise(*size, seed=size[0])):
        try:
            data = _pil_jpeg(img, tmp_path, quality=quality, subsampling=subsampling,
                             progressive=True, **kw)
        except OSError:  # PIL's buffer is too small for noise at 218 x 178, quality 95
            assert img.std() > 50 and size == (218, 178)
            continue
        assert b"\xff\xc2" in data
        _assert_matches_pil(data, f"{size} {variant}")


def test_progressive_grey_and_cmyk_match_pil(tmp_path):
    """PIL's progressive grey and CMYK files, and its sequential CMYK one
    (Adobe's inverted CMYK, converted by PIL's own cmyk2rgb)."""
    for size in ((7, 9), (218, 178)):
        img = _smooth(*size, seed=5)
        for kw in (dict(progressive=True), {}):
            _assert_matches_pil(_pil_jpeg(img[..., 1], tmp_path, **kw))
            cmyk = Image.fromarray(img).convert("CMYK")
            path = tmp_path / "c.jpg"
            cmyk.save(path, "JPEG", **kw)
            _assert_matches_pil(path.read_bytes())


# libjpeg scan scripts, "components:Ss:Se:Ah:Al" per scan
SCAN_SCRIPTS = {
    # every band refined to the last bit: no block smoothing
    "split_bands": "0:0:0:0:1;1:0:0:0:1;2:0:0:0:1;0:1:5:0:2;0:6:63:0:2;1:1:63:0:1;2:1:63:0:1;"
                   "0:1:63:2:1;0:1:63:1:0;1:1:63:1:0;2:1:63:1:0;0:0:0:1:0;1:0:0:1:0;2:0:0:1:0",
    "deep_dc": "0,1,2:0:0:0:3;0:1:63:0:0;1:1:63:0:0;2:1:63:0:0;0,1,2:0:0:3:2;0,1,2:0:0:2:1;"
               "0,1,2:0:0:1:0",
    "high_band_unrefined": "0,1,2:0:0:0:0;0:1:9:0:0;0:10:63:0:2;1:1:63:0:0;2:1:63:0:0",
    "high_band_missing": "0,1,2:0:0:0:0;0:1:20:0:0;1:1:9:0:0;2:1:9:0:0",
    # some of the first nine AC coefficients unrefined or missing: smoothed
    "ac_unrefined": "0,1,2:0:0:0:1;0:1:63:0:1;1:1:63:0:1;2:1:63:0:1",
    "dc_only": "0,1,2:0:0:0:0",
    "dc_only_unrefined": "0,1,2:0:0:0:2",
    "chroma_band_missing": "0,1,2:0:0:0:0;0:1:63:0:0;1:1:5:0:0;2:1:63:0:0",
    "mixed": "0:0:0:0:2;1,2:0:0:0:0;0:1:9:0:2;0:1:9:2:1;0:10:63:0:0;1:1:63:0:1;2:1:63:0:0;"
             "0:0:0:2:1",
}


@pytest.mark.parametrize("script", list(SCAN_SCRIPTS))
def test_progressive_scan_scripts_match_pil(writer, script):
    """Custom scan scripts, Huffman and arithmetic-coded, at shapes where
    libjpeg's smoothing meets the edges (two blocks across, a short last
    iMCU row): where the scans leave any of the first nine AC coefficients
    unrefined, libjpeg-turbo block-smooths from the DC values around, and so
    does the port."""
    for size in ((16, 9), (9, 16), (57, 70), (100, 23)):
        for sampling in ("2x2,1x1,1x1", "1x1,1x1,1x1", "1x2,1x1,1x1"):
            for extra in ({}, {"arith": 1, "restart": 3}):
                img = _smooth(*size, seed=size[1])
                data = write_jpeg(writer, img, scans=SCAN_SCRIPTS[script], sampling=sampling,
                                  quality=60, **extra)
                _assert_matches_pil(data, f"{size} {sampling} {extra}")


SAMPLINGS = ["1x1,1x1,1x1", "2x1,1x1,1x1", "2x2,1x1,1x1", "1x2,1x1,1x1", "4x1,1x1,1x1",
             "4x2,1x1,1x1", "3x1,1x1,1x1", "3x2,1x1,1x1", "1x3,1x1,1x1", "1x1,2x2,2x2",
             "1x1,2x1,1x2", "2x2,2x1,1x2", "2x1,1x2,1x1", "1x4,1x2,1x1", "4x1,2x1,1x1"]


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_samplings_match_pil(writer, sampling):
    """Every whole sampling ratio libjpeg reads, with luma or chroma on top:
    the fancy h2v1, h2v2 and h1v2 upsamplers and the box for the rest, in
    sequential, progressive, arithmetic-coded and lossless files (lossless
    ones always boxed)."""
    for size in ((1, 1), (5, 3), (17, 33), (57, 70)):
        for img in (_smooth(*size, seed=size[0]), _noise(*size, seed=size[1])):
            for mode in ({}, {"progressive": 1}, {"arith": 1, "restart": 1},
                         {"lossless": "4,1"}):
                _assert_matches_pil(write_jpeg(writer, img, sampling=sampling, **mode),
                                    f"{size} {mode}")


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictors_match_pil(writer, predictor):
    """Lossless files at each predictor and point transform 0, 2 and 7,
    with restart markers every row, sampled chroma, grey and grey sampled
    2x2 (the first row and column rules, the reset at each restart)."""
    for size in ((1, 1), (5, 3), (40, 48)):
        img = _smooth(*size, seed=predictor)
        for pt in (0, 2, 7):
            for extra in ({}, {"restart": size[1]}, {"sampling": "2x2,1x1,1x1"}):
                _assert_matches_pil(write_jpeg(writer, img, lossless=f"{predictor},{pt}", **extra),
                                    f"{size} pt {pt} {extra}")
        _assert_matches_pil(write_jpeg(writer, img[..., 0], lossless=f"{predictor},0"))
        _assert_matches_pil(write_jpeg(writer, img[..., 0], lossless=f"{predictor},1",
                                       sampling="2x2"))


@pytest.mark.parametrize("space", ["cmyk", "ycck"])
def test_four_component_files_match_pil(writer, space):
    """CMYK (Adobe transform 0) and YCCK (transform 2, through libjpeg's
    YCCK -> CMYK) files, sampled and not, sequential, progressive
    arithmetic-coded and lossless."""
    for size in ((5, 3), (40, 48)):
        img = _smooth(*size, seed=11)
        cmyk = np.dstack([img, (img[..., 1:2] // 2 + 40)])
        for sampling in ("1x1,1x1,1x1,1x1", "2x2,1x1,1x1,2x2", "2x1,1x1,1x1,1x1"):
            for mode in ({}, {"arith": 1, "progressive": 1}, {"lossless": "1,0"}):
                _assert_matches_pil(write_jpeg(writer, cmyk, space=space, sampling=sampling,
                                               **mode), f"{size} {sampling} {mode}")


def test_arithmetic_conditioning_matches_pil(writer):
    """Arithmetic-coded files under DAC conditioning other than libjpeg's
    defaults (L, U, Kx), with restart markers that clear the statistics."""
    img = _smooth(40, 48, seed=2)
    for dac in ("0,1,5", "0,0,1", "1,3,10", "2,5,63", "0,15,0"):
        for extra in ({}, {"progressive": 1}, {"restart": 2}):
            data = write_jpeg(writer, img, arith=1, dac=dac, **extra)
            assert b"\xff\xcc" in data
            _assert_matches_pil(data, f"{dac} {extra}")


# --------------------------------------------------------- fixtures
@pytest.mark.parametrize("name", sorted(JPEG_KIND_FIXTURES))
def test_jpeg_kind_fixtures_hold_their_kinds(name):
    """Each committed fixture of the new kinds is of the frame type and
    component count it is named for (``test_committed_fixtures_decode_to_
    their_pil_decodes`` holds its decode to PIL's and to the ``.npy``)."""
    data = (FIXTURES / name).read_bytes()
    sof, nc = JPEG_KIND_FIXTURES[name]
    at = data.index(bytes([0xFF, sof]))
    assert data[at + 9] == nc, name
    check_image(data)


# ---------------------------------------------- refused and corrupt files
def _patched(data: bytes, sof: int, at: int, value: int) -> bytes:
    """The file with byte ``at`` of its SOF segment (from the marker) set."""
    i = data.index(bytes([0xFF, sof]))
    out = bytearray(data)
    out[i + at] = value
    return bytes(out)


def test_kinds_pil_refuses_raise_saying_so(tmp_path):
    """12-bit and 16-bit (lossless) frames, hierarchical ones (SOF5, SOF7,
    SOF13), lossless arithmetic-coded ones (SOF11), a 2-component frame and
    a fractional sampling ratio: PIL refuses each, and the port raises
    saying so, naming no ROADMAP gap."""
    base = _pil_jpeg(_smooth(16, 16), tmp_path, quality=90)
    lossless = (FIXTURES / "jpeg_lossless_p1.jpg").read_bytes()
    cases = {"12-bit": _patched(base, 0xC0, 4, 12),
             "16-bit": _patched(lossless, 0xC3, 4, 16),
             "hierarchical": _patched(base, 0xC0, 1, 0xC5),
             "hierarchical lossless": _patched(lossless, 0xC3, 1, 0xC7),
             "hierarchical arithmetic": _patched(base, 0xC0, 1, 0xCD),
             "lossless arithmetic": _patched(lossless, 0xC3, 1, 0xCB),
             "2 components": _patched(base, 0xC0, 9, 2),
             # luma 2x2 (PIL's 4:2:0) against a chroma made 3x1: 3 does not divide 2
             "fractional sampling": _patched(base, 0xC0, 17, 0x31)}
    for what, data in cases.items():
        with pytest.raises((OSError, SyntaxError)):
            _pil(data)
        for fn in (decode_image, check_image):
            with pytest.raises(ValueError, match="nor by PIL") as e:
                fn(data)
            assert "ROADMAP" not in str(e.value), (what, str(e.value))


def test_dnl_marker_is_skipped_and_a_height_left_to_it_refused(tmp_path):
    """libjpeg skips a DNL marker (the frame's height stands) and refuses a
    frame of height 0, whose height only a DNL marker would give."""
    data = _pil_jpeg(_smooth(20, 30), tmp_path, quality=90, progressive=True)
    dnl = data[:-2] + b"\xff\xdc\x00\x04\x00\x14" + data[-2:]
    _assert_matches_pil(dnl)
    no_height = _patched(_patched(dnl, 0xC2, 5, 0), 0xC2, 6, 0)  # the frame's height: 0
    with pytest.raises((OSError, SyntaxError)):
        _pil(no_height)
    with pytest.raises(ValueError, match="DNL marker is not read by the port, nor by PIL"):
        decode_image(no_height)


def test_truncated_and_corrupt_files_of_the_new_kinds_raise():
    """Progressive, arithmetic-coded and lossless files cut short or with a
    broken scan header raise ``ValueError`` naming the fault (PIL refuses
    each too); so do restart markers out of order, which libjpeg resyncs
    past with a warning."""
    for name in ("jpeg_progressive_restart.jpg", "jpeg_arith.jpg", "jpeg_arith_progressive.jpg",
                 "jpeg_lossless_p1.jpg", "jpeg_ycck.jpg"):
        data = (FIXTURES / name).read_bytes()
        sos = data.index(b"\xff\xda")
        bad_scan = bytearray(data)
        bad_scan[sos + 5] = 0x77  # the first component's id: no such component
        for bad in (data[:len(data) // 2], data[:sos + 40], bytes(bad_scan)):
            with pytest.raises((OSError, SyntaxError)):
                _pil(bad)
            with pytest.raises(ValueError, match="truncated|corrupt"):
                decode_image(bad)
        if b"\xff\xd1" in data:
            rst = bytearray(data)
            rst[data.index(b"\xff\xd1") + 1] = 0xD5
            with pytest.raises(ValueError, match="restart marker"):
                decode_image(bytes(rst))


@pytest.mark.parametrize("name", ["jpeg_progressive_restart.jpg", "jpeg_progressive_smoothed.jpg",
                                  "jpeg_arith.jpg", "jpeg_arith_progressive.jpg",
                                  "jpeg_lossless_p1.jpg", "jpeg_ycck.jpg"])
def test_flipped_bytes_match_pil_or_raise(name):
    """Random bytes of the scans overwritten (seeded): wherever the port
    decodes the file, PIL decodes it to the same bytes.  libjpeg goes on
    past faults with a warning where the port raises (a bad Huffman code,
    a band overrun, coefficients its 16-bit SIMD IDCT would wrap), so the
    port may raise where PIL decodes, never the reverse."""
    data = (FIXTURES / name).read_bytes()
    start = data.index(b"\xff\xda")
    rng = np.random.default_rng(len(name))
    both = 0
    for _ in range(60):
        bad = bytearray(data)
        for at in rng.integers(start, len(bad), rng.integers(1, 4)):
            bad[at] = rng.integers(0, 256)
        try:
            got = decode_image(bytes(bad))
        except ValueError as e:
            assert "ROADMAP" not in str(e), str(e)
            continue
        np.testing.assert_array_equal(got, _pil(bytes(bad)))
        both += 1
    assert both >= 3
