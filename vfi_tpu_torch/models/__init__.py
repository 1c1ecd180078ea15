"""Models of the port: EMAVFI, SimpleFlowNet and the flow-prior pre-warp."""

from vfi_tpu_torch.models.ema_vfi import EMAVFI
from vfi_tpu_torch.models.flownet import SimpleFlowNet
from vfi_tpu_torch.models.prior import prior_prewarp

__all__ = ["EMAVFI", "SimpleFlowNet", "prior_prewarp"]
