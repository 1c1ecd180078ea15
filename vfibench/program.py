"""The system under test: the port's engine, built from a configuration.

The only module of the benchmark that imports the program
(`vfi_tpu_torch`), and only inside its functions.
"""

from __future__ import annotations

from vfibench.manifest import REPO


def build_engine(config: dict, device, io_uint8: bool = True):
    """`FrameInterpolator` over the configuration's checkpoints and
    engine settings; raises where the checkpoint's widths are not the
    configuration's."""
    from vfi_tpu_torch.infer.pair import FrameInterpolator
    from vfi_tpu_torch.utils.convert import infer_model_dims, load_params_npz

    params = load_params_npz(str(REPO / config["checkpoint"]))
    dims = infer_model_dims(params)
    want = {k: config["widths"][k] for k in dims}
    if dims != want:
        raise ValueError(f"{config['checkpoint']}: widths {dims}, the "
                         f"configuration states {want}")
    flow = load_params_npz(str(REPO / config["flow_checkpoint"]))
    return FrameInterpolator(params, flow_params=flow, device=device,
                             io_uint8=io_uint8, **config["engine"])


def build_server(engine, params: dict):
    """The HTTP server around `engine`, on 127.0.0.1 at a free port, with
    the cell's batcher settings; not started."""
    from vfi_tpu_torch.serve import InterpolationServer

    return InterpolationServer(
        engine, host="127.0.0.1", port=0, max_batch=params["max_batch"],
        max_delay_ms=params["max_delay_ms"],
        pad_to_max=params["pad_to_max"],
        max_px_per_launch=params["max_px_per_launch"])
