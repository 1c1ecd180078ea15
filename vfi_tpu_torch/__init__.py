"""vfi_tpu_torch — the PyTorch/CUDA port of `vfi_tpu`.

The same model, engine and numerics as the JAX package, for an NVIDIA
Hopper card (H100, `sm_90a`). Plain tensor code is PyTorch; every TPU
(Pallas) kernel of the JAX package is a hand-written CUDA kernel under
`csrc/`, built with `nvcc` into a plain shared library on first use and
bound with `ctypes` (`ops/cuda/build.py`).

Layout mirrors `vfi_tpu` so each module's counterpart is easy to find:
  ops/        warp, resize, the exact and the plain bounded DCN; ops/cuda/
              the kernel wrappers (each with its plain PyTorch version
              beside it)
  csrc/       CUDA C++ kernels
  models/     EMAVFI, SimpleFlowNet, the flow-prior pre-warp
  infer/      the frame-pair engine (`FrameInterpolator`), the single- and
              multi-clip video pipelines (video files through cv2,
              imported only when a file is opened)
  serve/      the micro-batcher and the HTTP server (cli/serve.py)
  cli/        the eval, serve and infer entry points
  native/     the PNG codec (C++ unfilter, built on first use)
  utils/      checkpoint I/O (`.npz`, reference `.pth` conversion) and
              the JAX-tree -> torch mapping,
              profiling (`trace`, `StepTimer`)
  tools/      the kernel microbenchmarks (bench_conv, bench_kernels) and
              the serving load generator (bench_serve)

Public functions take NHWC tensors, like the JAX package. Entry points run
on `cuda` unless the caller passes `device="cpu"`. Importing the package
does no CUDA work and builds nothing.
"""

__version__ = "0.1.0"
