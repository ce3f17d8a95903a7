"""Precompute real-image FID statistics (mu, sigma) to an .npz, port of the
repository's ``calc_fid_stats.py``, with the same flags plus ``--device``.

    python -m sdface_gan_tpu_torch.calc_fid_stats <png dir> --out stats.npz --img_size 256

Writes the ``fid_file`` that ``eval`` reads (``mu``, ``sigma`` and the
``img_size`` the images were resized to, LANCZOS as PIL does).  The port
reads PNG (and ``.npy``) images; a directory holding another format raises
before any work.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    """Returns the number of images scored."""
    p = argparse.ArgumentParser(description="Precompute FID stats with the PyTorch port.")
    p.add_argument("images", type=str, help="directory of real PNG images")
    p.add_argument("--out", type=str, required=True, help="output .npz path")
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--n_images", type=int, default=50000)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    import numpy as np

    from .evaluation import calculate_activation_statistics, compute_activations, load_inception
    from .evaluation.real import dir_batches, list_image_files
    from .utils.device import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    names = list_image_files(args.images, args.n_images)
    inc = load_inception(args.inception_weights, device=device)
    acts = compute_activations(inc, dir_batches(args.images, names, args.batch, args.img_size),
                               batch_size=args.batch)
    mu, sigma = calculate_activation_statistics(acts)
    np.savez(args.out, mu=mu, sigma=sigma, img_size=args.img_size)
    print(f"wrote stats for {len(acts)} images to {args.out}")
    return len(acts)


if __name__ == "__main__":
    main()
