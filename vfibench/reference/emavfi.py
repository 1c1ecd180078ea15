"""Plain PyTorch reference of the served path: ImageNet normalisation, the
SimpleFlowNet flow prior, the EMAVFI self-cascade and model, and the
conversion of the midpoint to uint8.

A frozen, independent statement of the function the program computes,
written from the model's equations in NCHW with `F.conv2d`,
`F.grid_sample` and `F.interpolate`. It imports nothing of the program
and takes nothing the program made: it reads the checkpoints' `.npz`
files with numpy and computes from the raw frames.

Precision: float32 with TF32 off (`float32`). `fp8` rounds both operands
of every product (conv, DCN contraction, dense) to float8 e4m3 first: the
control, one precision step below the bfloat16 the configurations state.

The model, per frame pair (f0, f1) in [0, 1]:
  n = (f - mean) / std; flow01 = flownet(n0, n1); n1 = warp(n1, 0.5 flow01)
  cascade (levels L): for l = L-1 .. 1, the motion stages on both frames
    resized to ceil(H / 2^l) x ceil(W / 2^l); their flow resized back,
    each axis scaled by its size ratio; n1 = warp(n1, that flow)
  feat, flow = motion(n0, n1); warped = warp(n1, clip(flow, +-warp_max))
  x = cat(feat, warped) [-> 1x1 fuse_proj]; 3 DCNs, offsets clipped to
  +-R; rec chain; midpoint = (tanh(x) + 1) / 2; uint8 = trunc(255 m + 0.5)
warp is bilinear backward warping in pixels with zero padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
PRECISIONS = ("float32", "fp8")


def load_npz(path) -> dict:
    """The checkpoint's arrays by their path without the leading
    'params/' (e.g. 'fusion_dcn0/kernel', HWIO)."""
    with np.load(path) as z:
        return {k.split("/", 1)[1] if k.startswith("params/") else k:
                np.array(z[k], np.float32) for k in z.files}


class Reference:
    """`midpoints_u8(f0, f1)` on (B, H, W, 3) uint8 -> (B, H, W, 3) uint8."""

    def __init__(self, config: dict, device="cpu", precision="float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        eng = config["engine"]
        self.device = torch.device(device)
        self.precision = precision
        self.R = eng["dcn_max_offset"]
        self.warp_max = eng["warp_max_flow"]
        self.cascade = eng["cascade_levels"]
        self.prior_scale = eng["flow_prior_scale"]
        self.flow_levels = eng["flow_levels"]
        self.p = self._tensors(load_npz(config["checkpoint"]))
        self.fp = self._tensors(load_npz(config["flow_checkpoint"]))
        self.num_blocks = sum(1 for k in self.p
                              if k.startswith("feat_ext_block")
                              and k.endswith("/kernel"))
        self.fuse_project = "fuse_proj/conv/kernel" in self.p

    def _tensors(self, arrays: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return t.to(torch.float8_e4m3fn).float()
        return t

    # -- operations -------------------------------------------------------

    def conv(self, x, params, name, stride=1, act=True):
        k = params[f"{name}/kernel"]           # HWIO
        w = k.permute(3, 2, 0, 1)
        y = F.conv2d(self.q(x), self.q(w), params[f"{name}/bias"],
                     stride=stride, padding=k.shape[0] // 2)
        return F.relu(y) if act else y

    @staticmethod
    def resize(x, size):
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def _grid(x, dx, dy):
        """Normalised sampling grid for pixel displacements (B, H, W)."""
        _, _, h, w = x.shape
        ys = torch.arange(h, device=x.device, dtype=torch.float32)[:, None]
        xs = torch.arange(w, device=x.device, dtype=torch.float32)[None, :]
        gx = (xs + dx) * (2.0 / (w - 1)) - 1.0
        gy = (ys + dy) * (2.0 / (h - 1)) - 1.0
        return torch.stack([gx, gy], dim=-1)

    def warp(self, x, flow):
        """Backward warp by flow (B, 2, H, W), channels (dx, dy)."""
        return F.grid_sample(x, self._grid(x, flow[:, 0], flow[:, 1]),
                             mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    # -- the flow prior ---------------------------------------------------

    def flownet(self, f0, f1):
        _, _, h, w = f0.shape
        flow = None
        for lvl, k in enumerate(range(self.flow_levels - 1, -1, -1)):
            size = (h >> k, w >> k)
            p0 = f0 if size == (h, w) else self.resize(f0, size)
            p1 = f1 if size == (h, w) else self.resize(f1, size)
            if flow is None:
                flow = f0.new_zeros(f0.shape[0], 2, *size)
            else:
                flow = self.resize(flow, size) * (size[0] / flow.shape[2])
            x = torch.cat([p0, self.warp(p1, flow), flow], dim=1)
            x = self.conv(x, self.fp, f"level{lvl}/c1/conv")
            x = self.conv(x, self.fp, f"level{lvl}/c2/conv")
            flow = flow + self.conv(x, self.fp, f"level{lvl}/flow/conv",
                                    act=False)
        return flow

    # -- the model --------------------------------------------------------

    def motion(self, a, b):
        p = self.p
        feat = self.conv(torch.cat([a, b], dim=1), p, "feat_ext_conv1/conv")
        for i in range(self.num_blocks):
            feat = self.conv(feat, p, f"feat_ext_block{i}/conv")
        ctx = self.conv(feat, p, "ctx_conv1/conv", stride=2)
        ctx = self.conv(ctx, p, "ctx_conv2/conv", stride=2)
        ctx = self.conv(ctx, p, "ctx_conv3/conv")
        ctx = ctx.mean(dim=(2, 3))
        ctx = self.q(ctx) @ self.q(p["ctx_dense/kernel"]) + p["ctx_dense/bias"]
        ctx_map = ctx[:, :, None, None].expand(-1, -1, *feat.shape[2:])
        x = self.conv(torch.cat([feat, ctx_map], dim=1), p,
                      "motion_conv1/conv")
        x = self.conv(x, p, "motion_conv2/conv")
        return feat, self.conv(x, p, "motion_conv3/conv", act=False)

    def dcn(self, x, i):
        """Modulated deformable 3x3 conv, offsets clipped to [-R, R]. The
        offset conv's 27 channels are static | mask | dynamic groups of 9;
        the offsets cat(static, dynamic) hold (dy, dx) of tap t = 3a + b
        at channels (2t, 2t + 1); tap t of output pixel (r, c) samples x
        at (r - 1 + a + dy, c - 1 + b + dx)."""
        name = f"fusion_dcn{i}"
        raw = self.conv(x, self.p, f"{name}/offset_conv", act=False)
        off = torch.cat([raw[:, :9], raw[:, 18:]], dim=1)
        off = off.clamp(-self.R, self.R)
        mask = torch.sigmoid(raw[:, 9:18])
        k = self.p[f"{name}/kernel"]            # (3, 3, Cin, Cout)
        out = self.p[f"{name}/bias"][None, :, None, None].expand(
            x.shape[0], -1, *x.shape[2:]).clone()
        for t in range(9):
            a, b = divmod(t, 3)
            s = self.warp(x, torch.stack([off[:, 2 * t + 1] + (b - 1),
                                          off[:, 2 * t] + (a - 1)], dim=1))
            s = s * mask[:, t:t + 1]
            out += torch.einsum("bchw,co->bohw", self.q(s), self.q(k[a, b]))
        return out

    def model(self, n0, n1):
        _, _, h, w = n0.shape
        for lvl in range(self.cascade - 1, 0, -1):
            s = 2 ** lvl
            ch, cw = -(-h // s), -(-w // s)
            _, cflow = self.motion(self.resize(n0, (ch, cw)),
                                   self.resize(n1, (ch, cw)))
            up = self.resize(cflow, (h, w))
            up = up * torch.tensor([w / cw, h / ch], device=up.device,
                                   dtype=up.dtype)[None, :, None, None]
            n1 = self.warp(n1, up)
        feat, flow = self.motion(n0, n1)
        if self.warp_max is not None:
            flow = flow.clamp(-self.warp_max, self.warp_max)
        x = torch.cat([feat, self.warp(n1, flow)], dim=1)
        if self.fuse_project:
            x = self.conv(x, self.p, "fuse_proj/conv", act=False)
        for i in range(self.num_blocks):
            x = self.dcn(x, i)
        x = self.conv(x, self.p, "rec_conv1/conv")
        x = self.conv(x, self.p, "rec_conv2/conv")
        x = self.conv(x, self.p, "rec_conv3/conv", act=False)
        return (torch.tanh(x) + 1.0) * 0.5

    @torch.no_grad()
    def midpoint(self, a: np.ndarray, b: np.ndarray) -> torch.Tensor:
        """The (1, 3, H, W) float midpoint in [0, 1] of one (H, W, 3)
        uint8 pair."""
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        mean = torch.tensor(MEAN, device=self.device)[None, :, None, None]
        std = torch.tensor(STD, device=self.device)[None, :, None, None]
        n0, n1 = ((torch.from_numpy(np.ascontiguousarray(f)).to(
            self.device).permute(2, 0, 1)[None].float() / 255.0 - mean)
            / std for f in (a, b))
        flow = self.flownet(n0, n1)
        return self.model(n0, self.warp(n1, flow * self.prior_scale))

    def midpoints_u8(self, f0: np.ndarray, f1: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 pairs -> (B, H, W, 3) uint8 midpoints, one
        pair at a time, so the reference fits beside nothing."""
        out = []
        for a, b in zip(f0, f1):
            m = self.midpoint(a, b)
            u8 = torch.clamp(m * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
            out.append(u8[0].permute(1, 2, 0).cpu().numpy())
        return np.stack(out)
