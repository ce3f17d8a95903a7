"""The port's data layer, counterpart of ``sdface_gan_tpu/data``: record
store -> PNG decode -> flip and HAMMING thumb -> prefetching batches, and
the preparation of a store from an image folder."""

from .dataset import MultiResolutionDataset, resolve_record_dir
from .loader import DataLoader
from .prepare import prepare_data

__all__ = ["MultiResolutionDataset", "DataLoader", "prepare_data",
           "resolve_record_dir"]
