"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Each ``repro_torch.X.Y`` is the counterpart of ``repro.X.Y``. The port imports
torch and never JAX or the reference package; its hand-written Hopper kernels
(``kernels/csrc``) are built with nvcc at first use. Entry points run on CUDA
unless the caller passes ``device="cpu"``, which runs the plain PyTorch
versions of the kernels (the CPU tests do so).

Ported so far (first slice): greedy and sampled serving of the dense qwen2
family through the paged continuous-batching engine, on the paged decode and
chunked-prefill attention kernels.
"""
__version__ = "0.1.0"
