"""Hand-written Hopper kernels and their PyTorch wrappers.

Each wrapper takes its plain PyTorch version only for a CPU tensor; for
a CUDA tensor it launches its kernel (built from ``csrc/`` at first use)
or raises. ``launch_counts`` reads every wrapper's launch counter;
``slot_launch_counts`` splits the launches made inside ``slot_scope`` by
mesh slot (``parallel/sharding.py`` runs each slot's chain in one).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

_SLOT = threading.local()
_SLOT_LOCK = threading.Lock()
_SLOT_LAUNCHES: Dict[int, int] = {}


@contextlib.contextmanager
def slot_scope(index: Optional[int]):
    """Attribute this thread's launches to mesh slot ``index``."""
    prev = getattr(_SLOT, "index", None)
    _SLOT.index = index
    try:
        yield
    finally:
        _SLOT.index = prev


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: its counter, and its slot's."""
    wrapper.launches += 1
    index = getattr(_SLOT, "index", None)
    if index is not None:
        with _SLOT_LOCK:
            _SLOT_LAUNCHES[index] = _SLOT_LAUNCHES.get(index, 0) + 1


def slot_launch_counts() -> Dict[int, int]:
    """{mesh slot index: kernel launches made in its scope}."""
    with _SLOT_LOCK:
        return dict(_SLOT_LAUNCHES)


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
    with _SLOT_LOCK:
        _SLOT_LAUNCHES.clear()
