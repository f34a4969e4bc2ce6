"""The card's published peaks, the run's peak memory on each card of its
card set, and the run's cards as the result line describes them.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit):
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3. A
roofline share is stated against these, with the cards' power limits
beside it (``power_limit``)."""

from __future__ import annotations

import subprocess

import torch

PEAK_HBM_BYTES = 3.35e12


def power_limit(indices=(0,)) -> str | None:
    """The power limits of the cards ``indices`` as nvidia-smi reads
    them (one a card, joined by "; "), or None."""
    try:
        out = subprocess.run(["nvidia-smi", "-i",
                              ",".join(str(i) for i in indices),
                              "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip()) or None


def reset(cards) -> None:
    """Start every CUDA card's peak of allocated memory afresh."""
    for dev in cards:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)


def read(cards) -> list[int]:
    """Each card's peak of allocated memory since ``reset`` (0 off the
    card)."""
    return [torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0 for dev in cards]


def device(cards, peak_bytes: list[int]) -> dict:
    """The ``device`` object of the result line for the card set
    ``cards`` and its peaks ``peak_bytes`` (``read``): ``count`` cards,
    ``memory_peak_bytes`` the fullest card's peak and, over several
    cards, each card's."""
    dev, fullest = cards[0], int(max(peak_bytes))
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": len(cards),
                "memory_peak_bytes": fullest}
    indices = [d.index or 0 for d in cards]
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(indices[0]),
           "count": len(cards), "memory_peak_bytes": fullest,
           "power_limit": power_limit(indices)}
    if len(cards) > 1:
        out["memory_peak_bytes_per_card"] = [int(p) for p in peak_bytes]
    return out
