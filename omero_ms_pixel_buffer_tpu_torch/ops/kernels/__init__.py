"""Hand-written Hopper kernels and their PyTorch wrappers.

Each wrapper takes its plain PyTorch version only for a CPU tensor; for
a CUDA tensor it launches its kernel (built from ``csrc/`` at first use)
or raises. ``launch_counts`` reads every wrapper's launch counter.
"""

from __future__ import annotations

from typing import Dict


def _wrappers() -> Dict[str, object]:
    from .bitpack import pack_tokens_sp
    from .bitpack_dense import pack_tokens_dense
    from .filter import filter_tiles

    return {"filter": filter_tiles, "bitpack": pack_tokens_sp,
            "bitpack_dense": pack_tokens_dense}


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches} for every kernel of the port."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
