"""The renderer's random numbers, frozen: WangHash seeding and the
xorshift stream of each (pixel, sample, depth), and the blue-noise mask
(void and cluster) with its R2 sequence. 32-bit words live in int64
tensors masked with ``& 0xFFFFFFFF``. Floats come out in the dtype the
caller asks for, so that the control can run in a lower precision."""

from __future__ import annotations

import os

import numpy as np
import torch

_M32 = 0xFFFFFFFF
MASK_SIZE = 128
STACK_DIMS = 16
MASK_SEED = 0x5F3759DF
_R2_ALPHA = np.array([0.7548776662466927, 0.5698402909980532], np.float64)


def wang_hash(s):
    s = s.to(torch.int64) & _M32
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _M32
    return s ^ (s >> 15)


def random_float(seed, dtype=torch.float32):
    """One xorshift step: (new seed, uniform in [0, 1))."""
    seed = seed ^ ((seed << 13) & _M32)
    seed = seed ^ (seed >> 17)
    seed = seed ^ ((seed << 5) & _M32)
    return seed, (seed.to(torch.float32) * 2.3283064365387e-10).to(dtype)


def random_floats(seed, n: int, dtype=torch.float32):
    vals = []
    for _ in range(n):
        seed, v = random_float(seed, dtype)
        vals.append(v)
    return seed, vals


def path_seed(path_index, sample_index, path_length=None):
    """Seed of (pixel, sample[, depth]); ``sample_index`` may be a tensor."""
    s = ((path_index.to(torch.int64) * 16789) & _M32) \
        + ((sample_index * 1791) & _M32)
    if path_length is not None:
        s = (s & _M32) + ((path_length * 720898027) & _M32)
    return wang_hash(s)


def blue_noise_mask(cache_dir: str | None = None, size: int = MASK_SIZE,
                    seed: int = MASK_SEED) -> np.ndarray:
    """(size, size) float32 blue-noise ranks by void and cluster. About
    15 s at 128^2, so it is kept in ``cache_dir`` when one is given."""
    cache = (os.path.join(cache_dir, f"bluenoise_{size}_{seed:x}.npy")
             if cache_dir else None)
    if cache and os.path.exists(cache):
        m = np.load(cache)
        if m.shape == (size, size):
            return m.astype(np.float32)
    rng = np.random.default_rng(seed)
    n = size * size
    xs = np.arange(size)
    d = np.minimum(xs, size - xs).astype(np.float64)
    e1 = np.exp(-(d ** 2) / (2.0 * 1.9 ** 2))
    energy_kernel = np.outer(e1, e1)
    fk = np.fft.rfft2(np.fft.ifftshift(
        np.roll(np.roll(energy_kernel, size // 2, 0), size // 2, 1)))
    binary = np.zeros((size, size), dtype=bool)
    binary.ravel()[rng.choice(n, size=n // 10, replace=False)] = True

    def energy(b):
        return np.fft.irfft2(np.fft.rfft2(b.astype(np.float64)) * fk,
                             s=(size, size))

    for _ in range(n // 10):
        e = energy(binary)
        cluster = np.unravel_index(
            np.argmax(np.where(binary, e, -np.inf)), e.shape)
        binary[cluster] = False
        e = energy(binary)
        void = np.unravel_index(
            np.argmin(np.where(binary, np.inf, e)), e.shape)
        if void == cluster:
            binary[cluster] = True
            break
        binary[void] = True
    rank = np.zeros((size, size), dtype=np.int64)
    work = binary.copy()
    count = int(work.sum())
    for r in range(count - 1, -1, -1):
        e = energy(work)
        cluster = np.unravel_index(
            np.argmax(np.where(work, e, -np.inf)), e.shape)
        work[cluster] = False
        rank[cluster] = r
    work = binary.copy()
    for r in range(count, n):
        e = energy(work)
        void = np.unravel_index(np.argmin(np.where(work, np.inf, e)),
                                e.shape)
        work[void] = True
        rank[void] = r
    out = ((rank.astype(np.float32) + 0.5) / float(n)).astype(np.float32)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{cache}.{os.getpid()}.npy"
        np.save(tmp, out)
        os.replace(tmp, cache)
    return out


def _dim_offsets(dim: int, size: int) -> tuple[int, int]:
    ox = (dim * 59 + (dim // 2) * 31) % size
    oy = (dim * 101 + (dim // 2) * 17) % size
    return ox, oy


def blue_noise_stack(mask: np.ndarray, dims: int = STACK_DIMS) -> np.ndarray:
    """(size, size, dims) per-dimension shifted copies of the mask."""
    size = mask.shape[0]
    out = np.empty((size, size, dims), np.float32)
    for d in range(dims):
        ox, oy = _dim_offsets(d, size)
        out[:, :, d] = np.roll(mask, (-oy, -ox), axis=(0, 1))
    return out


def blue_noise(stack, x, y, sample_index, dim: int, dtype=torch.float32):
    """The blue-noise-shifted R2 sample of pixel (x, y), per-lane
    ``sample_index`` (int64 tensor) and dimension ``dim``: the float32
    product ``a * k`` plus the pixel's shift, mod 1."""
    size = stack.shape[0]
    shift = stack[(y % size).long(), (x % size).long(), dim % stack.shape[2]]
    a = float(np.float32(_R2_ALPHA[dim % 2]))
    k = sample_index.to(torch.float32) + float(
        np.float32((dim // 2) * 0.38196601))
    return torch.remainder(shift + a * k, 1.0).to(dtype)
