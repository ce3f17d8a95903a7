"""The port's data layer, counterpart of ``sdface_gan_tpu/data``: record
store -> PNG decode -> flip and HAMMING thumb -> prefetching batches, and
the preparation of a store from an image folder; ``LSUNClass`` over a store
of LSUN-style records."""

from .dataset import LSUNClass, MultiResolutionDataset, resolve_record_dir
from .loader import DataLoader
from .prepare import prepare_data

__all__ = ["LSUNClass", "MultiResolutionDataset", "DataLoader", "prepare_data",
           "resolve_record_dir"]
