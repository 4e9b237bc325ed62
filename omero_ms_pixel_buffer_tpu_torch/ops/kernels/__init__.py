"""Hand-written Hopper kernels and their PyTorch wrappers.

Each wrapper takes its plain PyTorch version only for a CPU tensor; for
a CUDA tensor it launches its kernel (built from ``csrc/`` at first use)
or raises. ``launch_counts`` reads every wrapper's launch counter.
"""

from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches} for every kernel of the port."""
    from .bitpack import pack_tokens
    from .filter import filter_tiles

    return {
        "filter": filter_tiles.launches,
        "bitpack": pack_tokens.launches,
    }


def reset_launch_counts() -> None:
    from .bitpack import pack_tokens
    from .filter import filter_tiles

    filter_tiles.launches = 0
    pack_tokens.launches = 0
