"""Device selection shared by the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device` for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def device_record(dev: torch.device) -> dict:
    """What a result line names its device by: the torch name and device
    count, and on a card nvidia-smi's name and power limit per card (a
    card below its full power limit runs slower under load)."""
    if dev.type != "cuda":
        return {"name": "cpu", "count": 1, "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return {"name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}
