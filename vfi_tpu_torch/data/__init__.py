"""Data of the port: PNG decode and the frame-triplet index."""

from vfi_tpu_torch.data.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                        TripletDataset, load_image)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "TripletDataset", "load_image"]
