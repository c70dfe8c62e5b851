"""Hand-written Hopper kernels of the port, one package each
(``kernel.py`` the binding, ``ops.py`` the dispatch and autograd
Function, ``ref.py`` the plain PyTorch version), built by ``build.py``.

``launch_counts()`` reads every kernel's launch counter and
``reset_launch_counts()`` zeroes them: a run that sets them to 0 before
it drives a path and reads them after shows which kernels that path went
through.
"""
from repro_torch.kernels import flash_attention, paged_chunk_attention, \
    quant_comm, rmsnorm, ssd_scan, topk_gating

KERNELS = {
    "rmsnorm": rmsnorm.LAUNCHES,
    "rmsnorm_bwd": rmsnorm.LAUNCHES_BWD,
    "flash_attention": flash_attention.LAUNCHES,
    "flash_attention_bwd_dkv": flash_attention.LAUNCHES_BWD_DKV,
    "flash_attention_bwd_dq": flash_attention.LAUNCHES_BWD_DQ,
    "paged_chunk_attention": paged_chunk_attention.LAUNCHES,
    "topk_gating": topk_gating.LAUNCHES,
    "topk_gating_bwd": topk_gating.LAUNCHES_BWD,
    "ssd_scan": ssd_scan.LAUNCHES,
    "ssd_scan_bwd": ssd_scan.LAUNCHES_BWD,
    "quantize": quant_comm.LAUNCHES_QUANT,
    "dequantize": quant_comm.LAUNCHES_DEQUANT,
}


def launch_counts() -> dict:
    return {name: c.value for name, c in KERNELS.items()}


def reset_launch_counts() -> None:
    for c in KERNELS.values():
        c.reset()
