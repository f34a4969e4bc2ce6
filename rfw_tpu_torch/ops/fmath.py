"""Float32 transcendentals evaluated in float64 and rounded once.

The float32 ``sin``/``cos``/... of CPU and CUDA libraries differ in the
last bits, and a path tracer turns last-bit differences into different
paths (an occlusion test that lands on the other side of its bound). In
float64 both are accurate far below float32 resolution, so the rounded
results agree on every device, and frames traced on the card match the
CPU frames the tests check.
"""

from __future__ import annotations

import torch


def sin(x):
    return torch.sin(x.double()).float()


def cos(x):
    return torch.cos(x.double()).float()


def atan2(y, x):
    return torch.atan2(y.double(), x.double()).float()


def arccos(x):
    return torch.arccos(x.double()).float()


def log(x):
    return torch.log(x.double()).float()


def exp(x):
    return torch.exp(x.double()).float()


def log2(x):
    return torch.log2(x.double()).float()


def pow(x, y):
    return torch.pow(x.double(), y.double() if torch.is_tensor(y)
                     else float(y)).float()


def erf(x):
    return torch.erf(x.double()).float()


def erfinv(x):
    return torch.erfinv(x.double()).float()
