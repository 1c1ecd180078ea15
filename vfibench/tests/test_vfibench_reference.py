"""The frozen reference against the port's plain float32 engine at a tiny
size on the CPU (this test imports both; the reference imports nothing of
the port)."""

import numpy as np
import pytest
import torch

from vfibench.inputs import make_pool
from vfibench.manifest import REPO, load_config
from vfibench.reference.emavfi import Reference


@pytest.mark.parametrize("name", ["qocc", "q12"])
def test_reference_is_the_ports_function(name):
    from vfi_tpu_torch.infer.pair import FrameInterpolator
    from vfi_tpu_torch.utils.convert import load_params_npz

    cfg = load_config(name)
    paths = {k: str(REPO / cfg[k]) for k in ("checkpoint", "flow_checkpoint")}
    f0, f1 = make_pool(11, 2, (40, 72), (240, 400))
    eng = FrameInterpolator(load_params_npz(paths["checkpoint"]),
                            flow_params=load_params_npz(
                                paths["flow_checkpoint"]),
                            device="cpu", **dict(cfg["engine"], bf16=False))
    got = eng.midpoints(f0.astype(np.float32) / 255.0,
                        f1.astype(np.float32) / 255.0)
    ref = Reference(dict(cfg, **paths))
    for i in range(2):
        want = ref.midpoint(f0[i], f1[i])[0].permute(1, 2, 0)
        assert torch.allclose(got[i], want, atol=2e-5, rtol=0), (
            (got[i] - want).abs().max())
