"""Accumulator → display: ACES-fitted tonemap with brightness/contrast,
and the FXAA post pass (torch port of ``rfw_tpu.ops.tonemap``)."""

from __future__ import annotations

import torch

# Stephen Hill's ACES fit matrices (public constants)
_ACES_INPUT = ((0.59719, 0.35458, 0.04823),
               (0.07600, 0.90834, 0.01566),
               (0.02840, 0.13383, 0.83777))
_ACES_OUTPUT = ((1.60475, -0.53108, -0.07367),
                (-0.10208, 1.10813, -0.00605),
                (-0.00327, -0.07276, 1.07602))


def _mat3(m, color):
    """(3, 3) @ (..., 3) as fixed-order elementwise sums (no matmul)."""
    return torch.stack([color[..., 0] * row[0] + color[..., 1] * row[1]
                        + color[..., 2] * row[2] for row in m], dim=-1)


def _rrt_and_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_fitted(color):
    """(..., 3) linear → (..., 3) in [0, 1]."""
    c = _rrt_and_odt_fit(_mat3(_ACES_INPUT, color))
    return torch.clamp(_mat3(_ACES_OUTPUT, c), 0.0, 1.0)


def tonemap(hdr, brightness=0.05, contrast=1.0):
    """Contrast/brightness shift, then ACES."""
    return aces_fitted(torch.clamp(hdr - 0.5 * contrast + 0.5 + brightness,
                                   min=0.0))


def resolve_accumulator(accumulator, sample_count: int):
    """accumulator / spp."""
    return accumulator / float(max(sample_count, 1))


_LUMA = (0.299, 0.587, 0.114)


def _luma(img):
    """Rec. 601 luma of (..., 3) as a fixed-order sum."""
    return img[..., 0] * _LUMA[0] + img[..., 1] * _LUMA[1] \
        + img[..., 2] * _LUMA[2]


def fxaa(ldr, span_max: float = 8.0, reduce_mul: float = 1.0 / 8.0,
         reduce_min: float = 1.0 / 128.0):
    """FXAA 3.11-style luma edge anti-aliasing of a tonemapped (H, W, 3)
    frame, as rfw_tpu's: the luma gradient from the 4 diagonal neighbours
    (which wrap around the image edges, as ``jnp.roll`` does there), a
    step of up to ``span_max`` pixels along the edge, and two bilinear
    taps (clamped to the image) blended along it, or four when the two
    stay inside the local luma range."""
    img = torch.as_tensor(ldr, dtype=torch.float32)
    h, w = img.shape[0], img.shape[1]
    luma = _luma(img)

    def sl(dy, dx):
        return torch.roll(luma, (-dy, -dx), dims=(0, 1))

    l_nw, l_ne = sl(-1, -1), sl(-1, 1)
    l_sw, l_se = sl(1, -1), sl(1, 1)
    l_min = torch.minimum(luma, torch.minimum(torch.minimum(l_nw, l_ne),
                                              torch.minimum(l_sw, l_se)))
    l_max = torch.maximum(luma, torch.maximum(torch.maximum(l_nw, l_ne),
                                              torch.maximum(l_sw, l_se)))
    dir_x = -((l_nw + l_ne) - (l_sw + l_se))
    dir_y = (l_nw + l_sw) - (l_ne + l_se)
    dir_reduce = torch.clamp((l_nw + l_ne + l_sw + l_se) * 0.25 * reduce_mul,
                             min=reduce_min)
    rcp = 1.0 / (torch.minimum(dir_x.abs(), dir_y.abs()) + dir_reduce)
    dx = torch.clamp(dir_x * rcp, -span_max, span_max)
    dy = torch.clamp(dir_y * rcp, -span_max, span_max)

    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]

    def sample(fx, fy):
        xf = torch.clamp(xs + fx, 0.0, w - 1.0)
        yf = torch.clamp(ys + fy, 0.0, h - 1.0)
        x0, y0 = torch.floor(xf), torch.floor(yf)
        tx, ty = (xf - x0)[..., None], (yf - y0)[..., None]
        x0i, y0i = x0.long(), y0.long()
        x1i = torch.clamp(x0i + 1, max=w - 1)
        y1i = torch.clamp(y0i + 1, max=h - 1)
        return ((1 - tx) * (1 - ty) * img[y0i, x0i]
                + tx * (1 - ty) * img[y0i, x1i]
                + (1 - tx) * ty * img[y1i, x0i]
                + tx * ty * img[y1i, x1i])

    rgb_a = 0.5 * (sample(dx * (1.0 / 3.0 - 0.5), dy * (1.0 / 3.0 - 0.5))
                   + sample(dx * (2.0 / 3.0 - 0.5), dy * (2.0 / 3.0 - 0.5)))
    rgb_b = rgb_a * 0.5 + 0.25 * (sample(-0.5 * dx, -0.5 * dy)
                                  + sample(0.5 * dx, 0.5 * dy))
    l_b = _luma(rgb_b)
    use_a = (l_b < l_min) | (l_b > l_max)
    return torch.where(use_a[..., None], rgb_a, rgb_b)
