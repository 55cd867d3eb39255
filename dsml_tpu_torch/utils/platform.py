"""Device selection for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU
(the tests do). A request for CUDA on a machine without it is an error,
never a quiet fall back to the CPU: a number measured on the CPU must not
pass for one measured on the card.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def card_name_and_power_limit() -> str:
    """The current card's ``name, power.limit`` as ``nvidia-smi`` prints
    them (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``), to stand beside every
    number measured on it: a card set below its full power limit runs
    slower under load."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={torch.cuda.current_device()}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
