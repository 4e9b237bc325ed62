"""Device selection and GPU identification.

Replaces ``runtime/device_probe.py``: there is no link probe. The engine
is always the device engine; ``resolve_device`` picks the torch device
and raises when CUDA is asked for but absent, so nothing silently serves
from the CPU. Only tests pass ``"cpu"``.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The torch device entry points run on (default ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' only for tests"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device: {dev}")
    return dev


def gpu_info(index: int = 0) -> Optional[dict]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports them
    (``smi`` holds that line verbatim); None without a GPU."""
    if not torch.cuda.is_available():
        return None
    info = {"name": torch.cuda.get_device_name(index), "smi": None}
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        try:
            out = subprocess.run(
                [smi, "--query-gpu=name,power.limit",
                 "--format=csv,noheader", f"--id={index}"],
                capture_output=True, text=True, timeout=20, check=True,
            ).stdout.strip()
            info["smi"] = out.splitlines()[0] if out else None
        except (OSError, subprocess.SubprocessError):
            pass
    return info
