"""Standalone FID between stored images and precomputed stats, port of the
repository's ``eval_files.py``, with the same flags plus ``--device``.

    python -m sdface_gan_tpu_torch.eval_files <images.npy or PNG dir> --fid_file stats.npz

A ``.npy`` array may be NCHW or NHWC, uint8 (0-255) or float ([-1, 1]); a
directory holds PNG (or ``.npy``) images, scored at their own size.
"""

from __future__ import annotations

import argparse
import itertools


def image_batches(path: str, batch: int):
    """(batches of [n, H, W, 3] float32 in [-1, 1], H) for a ``.npy`` array
    (NCHW or NHWC; uint8 when its maximum exceeds 1.5) or a directory of
    PNG images (scored at their own size)."""
    import numpy as np

    from .evaluation.real import dir_batches, list_image_files

    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.shape[1] in (1, 3):  # NCHW -> NHWC
            arr = np.transpose(arr, (0, 2, 3, 1))
        if arr.max() > 1.5:  # uint8 range
            arr = arr.astype(np.float32) / 127.5 - 1.0
        return (arr[i:i + batch].astype(np.float32) for i in range(0, len(arr), batch)), \
            int(arr.shape[1])
    batches = dir_batches(path, list_image_files(path), batch)
    first = next(batches)
    return itertools.chain([first], batches), int(first.shape[1])


def main(argv=None) -> float:
    """Returns the FID."""
    p = argparse.ArgumentParser(description="Score FID for stored images with the PyTorch port.")
    p.add_argument("images", type=str, help=".npy image array or a directory of PNG images")
    p.add_argument("--fid_file", type=str, required=True)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    from .evaluation import (
        calculate_activation_statistics,
        calculate_frechet_distance,
        compute_activations,
        load_inception,
        load_stats_npz,
    )
    from .utils.device import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    batches, img_size = image_batches(args.images, args.batch)
    inc = load_inception(args.inception_weights, device=device)
    acts = compute_activations(inc, batches, batch_size=args.batch)
    mu, sigma = calculate_activation_statistics(acts)
    mu_r, s_r = load_stats_npz(args.fid_file, expect_img_size=img_size)
    fid = calculate_frechet_distance(mu, sigma, mu_r, s_r)
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
