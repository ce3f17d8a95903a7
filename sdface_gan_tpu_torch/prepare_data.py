"""Dataset preparation CLI of the port, with the flags of the repository's
``prepare_data.py``, plus ``--npy``: an image folder (PNG, JPEG, WebP,
BMP, read as PIL reads them; ``.npy`` arrays too with
``--npy``) -> a multi-resolution record store keyed
``{size}-{idx:05d}``.

    python -m sdface_gan_tpu_torch.prepare_data <image dir> --out <store> --size 256
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Prepare a multi-res dataset store.")
    p.add_argument("path", type=str, help="input image folder")
    p.add_argument("--out", type=str, required=True, help="output store dir")
    p.add_argument("--size", type=str, default="64,128,256,512,1024",
                   help="comma-separated resolutions")
    p.add_argument("--n_worker", type=int, default=8)
    p.add_argument("--npy", action="store_true",
                   help="also store the folder's .npy uint8 arrays (the JAX CLI skips them)")
    args = p.parse_args(argv)

    from .data import prepare_data

    sizes = tuple(int(s) for s in args.size.split(","))
    n = prepare_data(args.path, args.out, sizes=sizes, n_workers=args.n_worker,
                     npy=args.npy)
    print(f"wrote {n} images x {len(sizes)} resolutions to {args.out}")


if __name__ == "__main__":
    main()
