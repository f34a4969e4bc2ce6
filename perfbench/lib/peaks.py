"""The card's published peaks and its description in the result line.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit):
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3. A
roofline share is stated against these, with the card's power limit
beside it (``power_limit``)."""

from __future__ import annotations

import subprocess

import torch

PEAK_HBM_BYTES = 3.35e12


def power_limit(index: int = 0) -> str | None:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index),
                              "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device(dev: torch.device, peak_bytes: int) -> dict:
    """The ``device`` object of the result line."""
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1,
                "memory_peak_bytes": int(peak_bytes)}
    index = dev.index if dev.index is not None else 0
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index),
            "count": 1, "memory_peak_bytes": int(peak_bytes),
            "power_limit": power_limit(index)}
