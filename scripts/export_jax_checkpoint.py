#!/usr/bin/env python
"""Export every orbax checkpoint of a JAX run to a numpy archive.

    python scripts/export_jax_checkpoint.py out/<exp> <dst>

Walks ``out/<exp>`` (the JAX package's ``train.py`` output) and, for every
orbax checkpoint in it (a directory holding ``_CHECKPOINT_METADATA``),
writes ``<dst>/<same relative path>.npz``.  The PyTorch port reads these
archives (``sdface_gan_tpu_torch.utils.jax_export.read_export``) and turns
them into its own checkpoints with ``python -m
sdface_gan_tpu_torch.import_jax_checkpoints``; it cannot read orbax itself
(OCDBT with zarr chunks needs tensorstore).

Each checkpoint is restored without a target, which gives the saved tree
as it was written: nested dicts, optax chains as lists, ``None`` for empty
optimizer states and masked leaves, python ints for ``step``.  The archive:

* a key is the leaf's tree path joined by ``/``, list indices as digits;
* ``None`` leaves are left out;
* python scalars become 0-d arrays;
* a bfloat16 leaf is stored bit for bit as ``uint16`` and named in the
  0-d JSON string ``__dtypes__`` ({key: "bfloat16"}): numpy cannot save
  bfloat16.

Needs JAX and orbax; needs no config, and only reads the source tree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

METADATA = "_CHECKPOINT_METADATA"
DTYPES_KEY = "__dtypes__"


def flatten(tree, prefix: str = ""):
    """(key, leaf) pairs of a restored tree under the archive's key rule."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for k, v in items:
        if "/" in k:
            raise ValueError(f"tree key {k!r} under {prefix or '/'} holds a '/'")
        yield from flatten(v, f"{prefix}/{k}" if prefix else k)


def to_archive(tree) -> dict:
    """The arrays of one archive: ``None`` dropped, scalars 0-d, bf16 as uint16."""
    arrays, dtypes = {}, {}
    for key, leaf in flatten(tree):
        if leaf is None:
            continue
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            arr, dtypes[key] = arr.view(np.uint16), "bfloat16"
        elif arr.dtype == object:
            raise ValueError(f"leaf {key} is not numeric: {type(leaf).__name__}")
        arrays[key] = arr
    if DTYPES_KEY in arrays:
        raise ValueError(f"the tree has a leaf named {DTYPES_KEY}")
    arrays[DTYPES_KEY] = np.array(json.dumps(dtypes, sort_keys=True))
    return arrays


def checkpoint_dirs(src: str):
    """Relative paths of the orbax checkpoints under ``src``, sorted."""
    found = []
    for root, dirs, files in os.walk(src):
        if METADATA in files:
            found.append(os.path.relpath(root, src))
            dirs[:] = []  # a checkpoint's own subdirectories hold no checkpoint
        else:
            dirs.sort()
    return sorted(found)


def export_run(src: str, dst: str) -> list:
    """Write one archive per checkpoint of ``src`` under ``dst``; returns
    the relative paths written."""
    from sdface_gan_tpu.utils.checkpoints import load_checkpoint

    src, dst = os.path.abspath(src), os.path.abspath(dst)
    if dst == src or dst.startswith(src + os.sep):
        raise ValueError(f"{dst} lies inside the source run {src}")
    written = []
    for rel in checkpoint_dirs(src):
        tree = load_checkpoint(os.path.dirname(os.path.join(src, rel)), os.path.basename(rel))
        out = os.path.join(dst, rel + ".npz")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = out + ".tmp.npz"
        np.savez(tmp, **to_archive(tree))
        os.replace(tmp, out)
        written.append(rel + ".npz")
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("src", help="a JAX run directory, out/<exp>")
    p.add_argument("dst", help="where the archives go")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    written = export_run(args.src, args.dst)
    if not written:
        print(f"no orbax checkpoint under {args.src}", file=sys.stderr)
        return 1
    for rel in written:
        print(os.path.join(args.dst, rel))
    return 0


if __name__ == "__main__":
    sys.exit(main())
