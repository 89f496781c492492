"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device; raise if it is CUDA and no CUDA
    device is present (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(device) -> None:
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_record(dev: torch.device) -> dict:
    """What a measurement ran on: the device type and, on a card, its name
    and the `nvidia-smi --query-gpu=name,power.limit` line (None where
    nvidia-smi gives none)."""
    if dev.type != "cuda":
        return {"type": "cpu"}
    rec = {"type": "cuda", "name": torch.cuda.get_device_name(dev)}
    try:
        rec["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        rec["nvidia_smi"] = None
    return rec
