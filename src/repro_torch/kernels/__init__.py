"""Hand-written Hopper kernels of the port, one package each
(``kernel.py`` the binding, ``ops.py`` the dispatch, ``ref.py`` the
plain PyTorch version), built by ``build.py``.

``launch_counts()`` reads every kernel's launch counter and
``reset_launch_counts()`` zeroes them: a run that sets them to 0 before
it drives the serving path and reads them after shows which kernels
that path went through.
"""
from repro_torch.kernels import flash_attention, paged_chunk_attention, \
    rmsnorm

KERNELS = {
    "rmsnorm": rmsnorm.LAUNCHES,
    "flash_attention": flash_attention.LAUNCHES,
    "paged_chunk_attention": paged_chunk_attention.LAUNCHES,
}


def launch_counts() -> dict:
    return {name: c.value for name, c in KERNELS.items()}


def reset_launch_counts() -> None:
    for c in KERNELS.values():
        c.reset()
