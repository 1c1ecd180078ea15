"""Data of the port: PNG decode, the frame-triplet dataset, augmentation
and the prefetching loader."""

from vfi_tpu_torch.data.augment import AugmentConfig, augment_triplet
from vfi_tpu_torch.data.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                        TripletDataset, load_image)
from vfi_tpu_torch.data.loader import DataLoader

__all__ = ["AugmentConfig", "DataLoader", "IMAGENET_MEAN", "IMAGENET_STD",
           "TripletDataset", "augment_triplet", "load_image"]
