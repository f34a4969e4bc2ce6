"""Deterministic per-pixel RNG (torch port of ``rfw_tpu.ops.rng``).

Bit-identical to the reference: WangHash seeding + xorshift RandomFloat,
and the blue-noise-shifted R2 sequence. torch has no usable uint32
arithmetic, so 32-bit words live in int64 tensors masked with
``& 0xFFFFFFFF`` after every operation that can carry past bit 31.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def wang_hash(s):
    """WangHash on int64 tensors holding uint32 values."""
    s = s.to(torch.int64) & _M32
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _M32
    return s ^ (s >> 15)


def random_int(seed):
    """xorshift step; returns (new_seed, bits)."""
    seed = seed ^ ((seed << 13) & _M32)
    seed = seed ^ (seed >> 17)
    seed = seed ^ ((seed << 5) & _M32)
    return seed, seed


def random_float(seed):
    """Uniform in [0, 1); returns (new_seed, value)."""
    seed, bits = random_int(seed)
    return seed, bits.to(torch.float32) * 2.3283064365387e-10


def random_floats(seed, n: int):
    """``n`` sequential uniforms; returns (new_seed, [v0..vn-1])."""
    vals = []
    for _ in range(n):
        seed, v = random_float(seed)
        vals.append(v)
    return seed, vals


def path_seed(path_index, sample_index, path_length=None):
    """Seed of (pixel, sample[, depth]); ``sample_index``/``path_length``
    are Python ints or int tensors."""
    s = ((path_index.to(torch.int64) * 16789) & _M32) \
        + ((sample_index * 1791) & _M32)
    if path_length is not None:
        s = (s & _M32) + ((path_length * 720898027) & _M32)
    return wang_hash(s)


# ---------------------------------------------------------------------------
# Blue-noise mask (generated on the host, numpy) + R2 sequence
# ---------------------------------------------------------------------------

_MASK_SIZE = 128
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


@functools.lru_cache(maxsize=1)
def blue_noise_mask(size: int = _MASK_SIZE, seed: int = 0x5F3759DF) -> np.ndarray:
    """(size, size) float32 blue-noise ranks in [0, 1) by void-and-cluster
    (the reference generator, step for step). ~15 s at 128², so the
    result is cached in the package's build directory (``_build/``)."""
    cache = os.path.join(_BUILD_DIR, f"bluenoise_{size}_{seed:x}.npy")
    try:
        m = np.load(cache)
        if m.shape == (size, size):
            return m.astype(np.float32)
    except (OSError, ValueError):
        pass
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

    # relax the initial set: move the tightest cluster into the largest void
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
    for r in range(count - 1, -1, -1):   # tightest first → ranks descending
        e = energy(work)
        cluster = np.unravel_index(
            np.argmax(np.where(work, e, -np.inf)), e.shape)
        work[cluster] = False
        rank[cluster] = r
    work = binary.copy()
    for r in range(count, n):            # largest void first → ascending
        e = energy(work)
        void = np.unravel_index(np.argmin(np.where(work, np.inf, e)),
                                e.shape)
        work[void] = True
        rank[void] = r
    out = ((rank.astype(np.float32) + 0.5) / float(n)).astype(np.float32)
    try:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.save(cache, out)
    except OSError:
        pass
    return out


_R2_ALPHA = np.array([0.7548776662466927, 0.5698402909980532], dtype=np.float64)

_STACK_DIMS = 16


def dim_offsets(dim: int, size: int) -> tuple[int, int]:
    ox = (dim * 59 + (dim // 2) * 31) % size
    oy = (dim * 101 + (dim // 2) * 17) % size
    return ox, oy


@functools.lru_cache(maxsize=1)
def blue_noise_stack(size: int = _MASK_SIZE,
                     dims: int = _STACK_DIMS) -> np.ndarray:
    """(size, size, dims) per-dimension shifted copies of the mask, so one
    row gather fetches every dimension's shift for a pixel."""
    mask = blue_noise_mask(size)
    out = np.empty((size, size, dims), np.float32)
    for d in range(dims):
        ox, oy = dim_offsets(d, size)
        out[:, :, d] = np.roll(mask, (-oy, -ox), axis=(0, 1))
    return out


def blue_noise_shift_row(stack, x, y):
    """Per-pixel (R, dims) shift rows from the stack."""
    size = stack.shape[0]
    return stack[(y % size).long(), (x % size).long()]


def r2_offset(sample_index: int, dim: int) -> float:
    """The R2 term of ``blue_noise_from_shift``: the float32 product
    ``a * k`` of host scalars, rounded once."""
    a = np.float32(_R2_ALPHA[dim % 2])
    k = np.float32(sample_index) + np.float32((dim // 2) * 0.38196601)
    return float(a * k)


def blue_noise_from_shift(shift, sample_index: int, dim: int):
    """R2 sample given the pixel's shift for ``dim``: the shift plus
    ``r2_offset``, mod 1."""
    return torch.remainder(shift + r2_offset(sample_index, dim), 1.0)


def blue_noise_sample(mask, x, y, sample_index: int, dim: int):
    """Blue-noise-shifted R2 sample for pixel (x, y), sample and dimension
    (``mask`` is the 2-D mask or the pre-shifted stack)."""
    size = mask.shape[0]
    if mask.ndim == 3:
        shift = mask[(y % size).long(), (x % size).long(),
                     dim % mask.shape[2]]
    else:
        ox, oy = dim_offsets(dim, size)
        shift = mask[((y + oy) % size).long(), ((x + ox) % size).long()]
    return blue_noise_from_shift(shift, sample_index, dim)
