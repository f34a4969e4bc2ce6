"""Edge-avoiding à-trous wavelet denoiser (torch port of
``rfw_tpu.ops.denoise``).

Four levels of the 5x5 B3-spline kernel at steps 1, 2, 4 and 8, with
SVGF-style edge stopping: a gaussian in the color difference, a powered
cosine between the normals and the relative depth difference, the last
two where the guide planes are given. Plain PyTorch on both devices:
the reference runs it as XLA code, not as a Pallas kernel. rfw_tpu's
``denoise`` is only its jit entry to ``atrous_denoise``; the engines
call ``atrous_denoise`` here.
"""

from __future__ import annotations

import torch

# B3-spline à-trous taps
_KERNEL = tuple(x / 16.0 for x in (1.0, 4.0, 6.0, 4.0, 1.0))


def _shift2d(img, dy: int, dx: int):
    """``img`` (H, W, ...) read at (y + dy, x + dx), clamped to the edge."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def atrous_denoise(color, normal=None, depth=None, iterations: int = 4,
                   sigma_color: float = 0.35, sigma_normal: float = 0.2,
                   sigma_depth: float = 0.5):
    """``color`` (H, W, 3) HDR, ``normal`` (H, W, 3), ``depth`` (H, W):
    the filtered (H, W, 3) image."""
    out = color
    for level in range(iterations):
        step = 1 << level
        accum = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype,
                           device=out.device)
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                c = _shift2d(out, dy, dx)
                dc = ((c - out) ** 2).sum(-1, keepdim=True)
                w = (_KERNEL[ky] * _KERNEL[kx]) * torch.exp(
                    -dc / (sigma_color * sigma_color))
                if normal is not None:
                    ndot = (_shift2d(normal, dy, dx) * normal).sum(
                        -1, keepdim=True)
                    w = w * torch.clamp(ndot, 0.0, 1.0) ** (
                        1.0 / max(sigma_normal, 1e-3))
                if depth is not None:
                    dd = _shift2d(depth, dy, dx) - depth
                    w = w * torch.exp(-dd.abs()[..., None] / (
                        sigma_depth * torch.clamp(depth.abs()[..., None],
                                                  min=1e-3)))
                accum = accum + w * c
                wsum = wsum + w
        out = accum / torch.clamp(wsum, min=1e-8)
    return out
