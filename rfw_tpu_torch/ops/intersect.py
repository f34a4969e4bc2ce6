"""Ray–triangle intersection primitives (torch port of
``rfw_tpu/ops/intersect.py``) plus the host-side Woop transform.

Positions and directions are float32 tensors with a trailing dim of 3;
all functions broadcast over leading dims.
"""

from __future__ import annotations

import numpy as np
import torch

BIG_T = 1e30


def dot3(a, b):
    """The three products summed in a fixed order, one rounding per
    operation: CPU and CUDA give the same bits (a reduction kernel or a
    fused multiply-add would not)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def normalize(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=eps))[..., None]


def cross3(a, b):
    """a x b component by component (see ``dot3``)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def intersect_tri(origin, direction, v0, e1, e2, t_epsilon=1e-4, t_max=BIG_T):
    """Möller–Trumbore ray/triangle test. Returns (hit, t, u, v)."""
    pvec = cross3(direction, e2)
    det = dot3(e1, pvec)
    valid = det.abs() > 1e-12
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(direction, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    hit = (valid
           & (u >= 0.0) & (u <= 1.0)
           & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_epsilon) & (t < t_max))
    return hit, t, u, v


def intersect_woop(origin, direction, woop, t_epsilon=1e-4, t_max=BIG_T):
    """Rays (R, 3) against Woop-transformed triangles (K, 3, 4): the
    dense test of ``rfw_tpu.ops.intersect.intersect_woop``. Each row of
    the 3x4 map is applied as four separately rounded products summed
    in order (no matrix-multiply library, so no TF32). ``t_max`` is a
    number or one bound per ray. Returns (hit, t, u, v), each (R, K)."""
    if torch.is_tensor(t_max) and t_max.dim() == 1:
        t_max = t_max[:, None]
    o, d = origin[:, None, None, :], direction[:, None, None, :]
    op = (o[..., 0] * woop[..., 0] + o[..., 1] * woop[..., 1]
          + o[..., 2] * woop[..., 2] + woop[..., 3])           # (R, K, 3)
    dp = (d[..., 0] * woop[..., 0] + d[..., 1] * woop[..., 1]
          + d[..., 2] * woop[..., 2])
    oz, dz = op[..., 2], dp[..., 2]
    valid = dz.abs() > 1e-12
    t = -oz / torch.where(valid, dz, 1.0)
    u = op[..., 0] + t * dp[..., 0]
    v = op[..., 1] + t * dp[..., 1]
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_epsilon) & (t < t_max))
    return hit, t, u, v


def closest_hit_woop(origin, direction, woop, prim_ids, t_epsilon=1e-4,
                     t_max=BIG_T, tri_verts=None):
    """Closest hit of rays (R, 3) against triangles (K, 3, 4) with ids
    (K,): (t, prim, u, v), t = BIG_T and prim = -1 on a miss; on equal t
    the first triangle wins, as ``jnp.argmin`` picks it. Given
    ``tri_verts`` (K, 3, 3), the winner is refined by one Möller–Trumbore
    test (better conditioned than the Woop form), whose numbers are kept
    where it agrees that the ray hits."""
    hit, t, u, v = intersect_woop(origin, direction, woop, t_epsilon, t_max)
    t = torch.where(hit, t, BIG_T)
    k = torch.argmin(t, dim=-1)
    rows = torch.arange(t.shape[0], device=t.device)
    t_best, u_best, v_best = t[rows, k], u[rows, k], v[rows, k]
    found = t_best < BIG_T
    if tri_verts is not None:
        tv = tri_verts[k]                                      # (R, 3, 3)
        rhit, rt, ru, rv = intersect_tri(
            origin, direction, tv[:, 0], tv[:, 1] - tv[:, 0],
            tv[:, 2] - tv[:, 0], t_epsilon=t_epsilon * 0.5, t_max=t_max)
        keep = found & rhit
        t_best = torch.where(keep, rt, t_best)
        u_best = torch.where(keep, ru, u_best)
        v_best = torch.where(keep, rv, v_best)
    return (t_best, torch.where(found, prim_ids[k], -1),
            torch.where(found, u_best, 0.0), torch.where(found, v_best, 0.0))


def intersect_aabb(origin, inv_dir, bmin, bmax, t_max=BIG_T):
    """Slab test of broadcastable (..., 3) rays and boxes: (hit, t_near).
    ``torch.minimum``/``maximum`` and ``amax``/``amin`` carry a NaN
    through, as jnp's do."""
    t1 = (bmin - origin) * inv_dir
    t2 = (bmax - origin) * inv_dir
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < t_max)
    return hit, tmin


def safe_inv_dir(direction):
    """1/d with the sign-preserving clamp that avoids inf*0."""
    tiny = torch.full_like(direction, 1e-12)
    d = torch.where(direction.abs() < 1e-12,
                    torch.where(direction < 0, -tiny, tiny), direction)
    return 1.0 / d


def woop_matrices(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Per-triangle 3x4 world→unit-triangle matrices (host, numpy; the
    same arithmetic as ``rfw_tpu.ops.intersect.woop_matrices``).

    A point p maps to (u, v, w) with w = 0 on the triangle's plane; a ray
    hits the triangle where w(t) = 0, at barycentrics (u, v). Returns
    (T, 3, 4) float32; degenerate triangles get w ≡ 1 (never hit).
    """
    e1 = (v1 - v0).astype(np.float64)
    e2 = (v2 - v0).astype(np.float64)

    def cross_into(a, b, out):
        out[:, 0] = a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1]
        out[:, 1] = a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2]
        out[:, 2] = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
        return out

    t = v0.shape[0]
    n = cross_into(e1, e2, np.empty_like(e1))
    det = np.einsum("ti,ti->t", n, n)
    bad = det < 1e-18
    inv_det = (1.0 / np.where(bad, 1.0, det))[:, None]
    m64 = np.empty((t, 3, 4))
    cross_into(e2, n, m64[:, 0, :3])
    cross_into(n, e1, m64[:, 1, :3])
    m64[:, 2, :3] = n
    m64[:, :, :3] *= inv_det[:, :, None]
    m64[bad, :, :3] = np.eye(3)
    m64[:, :, 3] = -np.einsum("tij,tj->ti", m64[:, :, :3],
                              v0.astype(np.float64))
    out = m64.astype(np.float32)
    if bad.any():
        out[bad] = 0.0
        out[bad, 2, 3] = 1.0
    return out
