#!/usr/bin/env python
"""Write the image fixtures of this directory and PIL's decode of each.

    python tests/fixtures/images/make_image_fixtures.py

Needs PIL (12, with libjpeg-turbo: the reference the JAX package reads
images with).  The images are the port's procedural heads
(``sdface_gan_tpu_torch.data.synthetic.render_head``), 178 x 218 as
CelebA's aligned faces: JPEGs in 4:2:0 (qualities 95 and 75, the latter
with optimised Huffman tables), 4:2:2, 4:4:4, grey and 4:2:0 with restart
markers; then, at 48 x 64, a PIL-written palette PNG, an Adam7-interlaced
8-bit RGB PNG and a 16-bit RGB PNG built by hand (PIL writes neither), and
a 24-bit BMP.  Beside each file ``<name>.npy`` holds
``Image.open(<name>).convert("RGB")``: ``chip_smoke.py`` holds the port's
decoders against it on the card's machine, which has no PIL.
"""

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


def main() -> int:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_port_images import png_bytes

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
