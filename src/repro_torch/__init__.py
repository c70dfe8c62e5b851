"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Mirrors the paths and names of ``src/repro`` (the JAX reference, which
it never imports).  The first slice is the dense serving path:
``models`` (DecoderLM, dense family), ``serving`` (paged
``ServingEngine``), ``launch.serve``, and the three kernels that path
runs — ``kernels.rmsnorm``, ``kernels.flash_attention`` and
``kernels.paged_chunk_attention`` (CUDA C++ for sm_90a, as every kernel
of the port).

Entry points run on the card unless given ``device="cpu"``
(``repro_torch.device.resolve_device``).
"""
from repro_torch.device import resolve_device, torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
