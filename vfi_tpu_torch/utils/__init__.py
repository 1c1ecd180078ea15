"""Checkpoint I/O (`.npz`, reference `.pth` conversion) and the JAX-tree
-> torch state-dict mapping."""

from vfi_tpu_torch.utils.convert import (convert_ema_vfi_state_dict,
                                         convert_ema_vfi_torch,
                                         convert_vgg16_state_dict,
                                         convert_vgg16_torch,
                                         infer_model_dims, load_params_npz,
                                         params_from_jax, params_to_jax,
                                         save_params_npz)

__all__ = ["convert_ema_vfi_state_dict", "convert_ema_vfi_torch",
           "convert_vgg16_state_dict", "convert_vgg16_torch",
           "infer_model_dims", "load_params_npz", "params_from_jax",
           "params_to_jax", "save_params_npz"]
