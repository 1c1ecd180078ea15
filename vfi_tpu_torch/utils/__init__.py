"""Checkpoint loading and the JAX-tree -> torch state-dict mapping."""

from vfi_tpu_torch.utils.convert import (infer_model_dims, load_params_npz,
                                         params_from_jax)

__all__ = ["infer_model_dims", "load_params_npz", "params_from_jax"]
