"""Per-block exact visit-list intersector (torch port of
``rfw_tpu/ops/visit_intersect.py``).

1. **Enumerate** (kernel ``block_entries``): per 256-ray block, the
   entry lower bound of every cell some ray of the block crosses.
2. **Order**: per block, cells sort by packed (quantized entry, cell id)
   keys into a front-to-back visit list, computed once per launch.
3. **Visit** (kernel ``visit``): per block, walk the list and Woop-test
   every ray against every triangle of each visited granule, with an
   early exit once no later granule can win.
4. **Recull passes**: blocks whose list outruns ``M_C`` granules go on
   with the next window of the same list, until every ray is finished.

The two kernels are hand-written CUDA (``csrc/visit_kernels.cu``). Their
wrappers run the plain PyTorch versions (``block_entries_ref``,
``visit_ref``) only for CPU tensors; a CUDA tensor launches the kernel,
and any other device raises. Rays travel as (8, N) SoA rows: origin xyz,
t_max, direction xyz, pad.

Tables derived from the scene build serve the kernels (``device_tables``,
once per build): the triangle-major planes ``wplanes_tm`` (T, K, 12),
from which the visit kernel copies a cell's contiguous 12·K floats per
visit while the plain version keeps reading ``wplanes`` (and, for a scene
with the sub-cell child tables, ``wplanes32_tm`` for the tvisit kernel);
and the real cell counts, past which the enum kernel writes "no entry"
without testing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import tracing
from . import cuda_lib
from .cuda_lib import check_inputs, launch_counts, ptr
from .compaction import ray_sort_keys
from .intersect import BIG_T, dot3, intersect_tri, safe_inv_dir

BLOCK = 256        # rays per block
M_C = 128          # visit-list window (granules per block per pass)
EXIT_EVERY = 4     # visits between front-to-back exit checks
_BIGKEY = float(1 << 25)
# the build appends its padding cells after the real ones as far-point
# boxes (every coordinate 3e37); a box whose lower corner lies at or past
# FAR_BOX on every axis is out of reach of every ray with t <= BIG_T
FAR_BOX = 1e37

def _cid_bits(t_c: int) -> int:
    return max((t_c - 1).bit_length(), 1)


def _pack_rays(origins, directions, t_hi):
    """(N, 3), (N, 3), (N,) → (8, N) contiguous SoA rows."""
    return torch.cat([origins.T, t_hi[None], directions.T,
                      torch.zeros_like(t_hi)[None]]).contiguous()


# ---------------------------------------------------------------------------
# Phase 1: per-block entry bounds
# ---------------------------------------------------------------------------

def slab_crossed(ent, ext, t_hi):
    """A ray crosses a box when its slab interval [ent, ext] is not empty
    and starts before ``t_hi`` (0 for a dead lane). The interval is
    closed: the build pads a flat box (a wall) by 1e-6, one ulp or less
    at |x| >= 8, and ``lo - o`` rounds that away, so a ray meeting the
    wall gets ent == ext exactly. rfw_tpu's strict ``ent < ext`` drops
    such hits unless another ray of the block crosses the box."""
    return (ent <= ext) & (ent < t_hi)


def block_entries_ref(rays, bounds8, max_elems: int = 1 << 24):
    """Plain version of the enum kernel: rays (8, N) → (NB, T)."""
    nb = rays.shape[1] // BLOCK
    t_dim = bounds8.shape[1]
    r = rays.reshape(8, nb, BLOCK)
    out = torch.empty((nb, t_dim), dtype=torch.float32, device=rays.device)
    step = max(1, max_elems // (BLOCK * t_dim))
    inv = safe_inv_dir(r[4:7])
    for s in range(0, nb, step):
        ent = torch.zeros((min(step, nb - s), BLOCK, t_dim),
                          device=rays.device)
        ext = torch.full_like(ent, 3e38)
        for ax in range(3):
            o = r[ax, s:s + step, :, None]
            iv = inv[ax, s:s + step, :, None]
            t1 = (bounds8[ax] - o) * iv
            t2 = (bounds8[3 + ax] - o) * iv
            ent = torch.maximum(ent, torch.minimum(t1, t2))
            ext = torch.minimum(ext, torch.maximum(t1, t2))
        tm = r[3, s:s + step, :, None]
        crossed = slab_crossed(ent, ext, tm)
        out[s:s + step] = torch.where(crossed, ent, 1e30).amin(1)
    return out


def block_entries(rays, bounds8, n_real: int):
    """Per-block entry lower bounds: rays (8, N) → (NB, T). Enum kernel
    on CUDA tensors, ``block_entries_ref`` on CPU tensors. ``n_real`` is
    the table's real cell count (``real_cells``): the kernel writes 1e30
    for the padding cells past it without testing them, which equals the
    plain version's result because no ray reaches a far box."""
    n, t_dim = rays.shape[1], bounds8.shape[1]
    if rays.shape[0] != 8 or n % BLOCK or bounds8.shape[0] != 8:
        raise ValueError(f"bad shapes: rays {tuple(rays.shape)}, "
                         f"bounds {tuple(bounds8.shape)}")
    if not 0 <= n_real <= t_dim:
        raise ValueError(f"real cell count {n_real} outside [0, {t_dim}]")
    if not cuda_lib.kernel_device(rays, "visit-list"):
        return block_entries_ref(rays, bounds8)
    check_inputs(rays.device, rays=(rays, torch.float32),
                  bounds=(bounds8, torch.float32))
    out = torch.empty((n // BLOCK, t_dim), dtype=torch.float32,
                      device=rays.device)
    if n == 0:
        return out
    with cuda_lib.launch(rays.device) as (lib, stream):
        err = lib.rfw_enum_entries(ptr(rays), n, ptr(bounds8), t_dim,
                                   n_real, ptr(out), stream)
        cuda_lib.check(err, "enum kernel")
    launch_counts["enum"] += 1
    return out


def _imul(a_lo, a_hi, b_lo, b_hi):
    """Interval product endpoints: [a_lo, a_hi] x [b_lo, b_hi]."""
    p1, p2 = a_lo * b_lo, a_lo * b_hi
    p3, p4 = a_hi * b_lo, a_hi * b_hi
    return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
            torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))


def block_entries_envelope(rays, bounds8):
    """Per-block interval-envelope entry bounds: (NB, T) like
    ``block_entries`` from NB x T slab tests. Conservative (the envelope
    crosses a superset of cells, with lower entries), so results stay
    exact; meant for coherent streams such as primary tiles."""
    nb = rays.shape[1] // BLOCK
    r = rays.reshape(8, nb, BLOCK)
    o, tm, d = r[0:3], r[3], r[4:7]
    t_hi = tm.amax(1)[:, None]
    o_lo, o_hi = o.amin(2), o.amax(2)                  # (3, NB)
    inv = safe_inv_dir(d)
    inv_lo, inv_hi = inv.amin(2), inv.amax(2)
    t_dim = bounds8.shape[1]
    ent = torch.zeros((nb, t_dim), device=rays.device)
    ext = torch.full_like(ent, 3e38)
    for ax in range(3):
        b_lo = bounds8[ax][None, :]
        b_hi = bounds8[3 + ax][None, :]
        il, ih = inv_lo[ax][:, None], inv_hi[ax][:, None]
        lo1, hi1 = _imul(b_lo - o_hi[ax][:, None], b_lo - o_lo[ax][:, None],
                         il, ih)
        lo2, hi2 = _imul(b_hi - o_hi[ax][:, None], b_hi - o_lo[ax][:, None],
                         il, ih)
        ent = torch.maximum(ent, torch.minimum(lo1, lo2))
        ext = torch.minimum(ext, torch.maximum(hi1, hi2))
    return torch.where(slab_crossed(ent, ext, t_hi), ent, 1e30)


# ---------------------------------------------------------------------------
# Phase 2: entry-ordered visit lists
# ---------------------------------------------------------------------------

def quant_scale(qmax: int, diag):
    """qmax / diag as one float32 division (``int / tensor`` in torch
    multiplies by the reciprocal, which rounds differently)."""
    return diag.new_full((), float(qmax)) / diag


def quant_gran(qmax: int, diag):
    """diag / qmax, the width of one quantisation step, as one float32
    division of two tensors (a CUDA tensor divided by a Python number is
    multiplied by its reciprocal, which can round one ulp away)."""
    return diag / diag.new_full((), float(qmax))


def sort_candidates(b_entry, diag, m_c: int):
    """(NB, T) entries → (keys_all, counts_all): the full entry-sorted
    packed-key table, computed once per launch. Keys pack the quantized
    entry with the cell id into exact-integer float32 (< 2^24); the
    table is padded to a multiple of ``m_c`` with invalid keys."""
    t_c = b_entry.shape[1]
    cb = _cid_bits(t_c)
    qmax = (1 << (24 - cb)) - 1
    q = torch.clamp(torch.floor(b_entry * quant_scale(qmax, diag)),
                    max=float(qmax))
    q = torch.clamp(q, min=0.0)
    cid = torch.arange(t_c, dtype=torch.float32, device=b_entry.device)[None]
    key = torch.where(b_entry < BIG_T, q * float(1 << cb) + cid, _BIGKEY)
    keys_all = torch.sort(key, dim=-1).values
    counts_all = (key < _BIGKEY).sum(-1).to(torch.int32)
    pad = (-t_c) % m_c
    if pad:
        keys_all = torch.nn.functional.pad(keys_all, (0, pad), value=_BIGKEY)
    return keys_all, counts_all


def window_candidates(keys_all, counts_all, it: int, diag, m_c: int, t_c: int):
    """Pass ``it``'s visit window: (ids, counts, tnears, next_tnear).
    ``next_tnear`` is each block's entry bound of the first granule past
    this window (BIG_T when exhausted)."""
    cb = _cid_bits(t_c)
    qmax = (1 << (24 - cb)) - 1
    gran = quant_gran(qmax, diag)
    t_pad = keys_all.shape[1]
    start = min(it * m_c, t_pad - m_c)
    keys = keys_all[:, start:start + m_c]
    counts = torch.clamp(counts_all - it * m_c, 0, m_c).to(torch.int32)
    valid = keys < _BIGKEY
    ids = torch.where(valid, keys.to(torch.int32) & ((1 << cb) - 1),
                      t_c).to(torch.int32)
    tnears = torch.where(valid, torch.floor(keys / float(1 << cb)) * gran,
                         BIG_T)
    nxt = keys_all[:, min((it + 1) * m_c, t_pad - 1)]
    next_tnear = torch.where(nxt < _BIGKEY,
                             torch.floor(nxt / float(1 << cb)) * gran, BIG_T)
    return ids.contiguous(), counts, tnears.contiguous(), next_tnear


# ---------------------------------------------------------------------------
# Phase 3: the visit kernel
# ---------------------------------------------------------------------------

def visit_ref(rays, ids, counts, tnears, wg, super_g: int, k_size: int,
              t_epsilon: float, any_hit: bool):
    """Plain version of the visit kernel, in the TPU kernel's own form:
    a per-(ray, lane) strict running minimum over the visits of every
    block, a final argmin over lanes, and the same exit cadence. Returns
    per-ray (t, slot) with t = t_max and slot = -1 on a miss."""
    nb, m_c = ids.shape
    n_gran = wg.shape[0]
    r = rays.reshape(8, nb, BLOCK)
    o = [r[a][:, :, None] for a in range(3)]           # (NB, BLOCK, 1)
    d = [r[4 + a][:, :, None] for a in range(3)]
    t_max0 = r[3]
    btk = t_max0[:, :, None].expand(nb, BLOCK, k_size).clone()
    bgk = torch.zeros((nb, BLOCK, k_size), dtype=torch.int32,
                      device=rays.device)
    counts = counts.long()
    done = torch.zeros(nb, dtype=torch.bool, device=rays.device)
    rows = torch.arange(nb, device=rays.device)
    n_max = int(counts.max()) if nb else 0
    for i in range(n_max):
        active = (i < counts) & ~done
        j = torch.clamp(torch.clamp(counts - 1, max=i), 0, m_c - 1)
        g = torch.clamp(ids[rows, j].long(), max=n_gran - 1)
        wp = wg[g]                                      # (NB, G*16, K)
        for sub in range(super_g):
            w = [wp[:, 16 * sub + q][:, None, :] for q in range(12)]

            def xf_o(r0):
                acc = w[r0 + 3] + o[0] * w[r0]
                acc = acc + o[1] * w[r0 + 1]
                return acc + o[2] * w[r0 + 2]

            def xf_d(r0):
                acc = d[0] * w[r0]
                acc = acc + d[1] * w[r0 + 1]
                return acc + d[2] * w[r0 + 2]

            ou, du = xf_o(0), xf_d(0)
            ov, dv = xf_o(4), xf_d(4)
            ow, dw = xf_o(8), xf_d(8)
            valid = dw.abs() > 1e-12
            t = -ow / torch.where(valid, dw, 1.0)
            u = ou + t * du
            v = ov + t * dv
            hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > t_epsilon))
            t_hit = torch.where(hit, t, 1e30)
            upd = (t_hit < btk) & active[:, None, None]
            btk = torch.where(upd, t_hit, btk)
            gran = (g * super_g + sub).to(torch.int32)[:, None, None]
            bgk = torch.where(upd, gran, bgk)
        if i % EXIT_EVERY == EXIT_EVERY - 1:
            bt = btk.amin(2)
            if any_hit:
                d_s = ~((bt >= t_max0) & (t_max0 > 0)).any(1)
            else:
                d_s = bt.amax(1) <= tnears[:, min(i + 1, m_c - 1)]
            done = done | (active & d_s)
    tmin, kbest = btk.min(2)
    gbest = torch.gather(bgk, 2, kbest[:, :, None])[:, :, 0]
    found = tmin < t_max0
    slot = torch.where(found, gbest * k_size + kbest.to(torch.int32), -1)
    return (torch.where(found, tmin, t_max0).reshape(-1),
            slot.to(torch.int32).reshape(-1))


def visit(rays, ids, counts, tnears, gran: Granules, t_epsilon: float,
          any_hit: bool, walked=None):
    """Visit-list walk: per-ray (t, slot). Visit kernel on CUDA tensors
    (reading ``gran.planes_tm``), ``visit_ref`` on CPU tensors (reading
    ``gran.planes``). ``walked``, an (NB,) int32 tensor, receives each
    block's count of walked visits (kernel only; the visits its exit rule
    let it take)."""
    nb, m_c = ids.shape
    n = rays.shape[1]
    wg, wtm, g, k = gran.planes, gran.planes_tm, gran.super_g, gran.k_size
    if (rays.shape[0] != 8 or n != nb * BLOCK or counts.shape != (nb,)
            or tnears.shape != (nb, m_c)
            or wg.shape[1:] != (16 * g, k)
            or wtm.shape != (wg.shape[0], g * k, 12)
            or (walked is not None and walked.shape != (nb,))):
        raise ValueError(
            f"bad shapes: rays {tuple(rays.shape)}, ids {tuple(ids.shape)}, "
            f"counts {tuple(counts.shape)}, tnears {tuple(tnears.shape)}, "
            f"planes {tuple(wg.shape)}, triangle-major planes "
            f"{tuple(wtm.shape)}, super_g {g}, k_size {k}")
    if not cuda_lib.kernel_device(rays, "visit-list"):
        if walked is not None:
            raise ValueError("walked visits are counted by the kernel only")
        return visit_ref(rays, ids, counts, tnears, wg, g, k, t_epsilon,
                         any_hit)
    check_inputs(rays.device, rays=(rays, torch.float32),
                  ids=(ids, torch.int32), counts=(counts, torch.int32),
                  tnears=(tnears, torch.float32),
                  planes_tm=(wtm, torch.float32))
    if walked is not None:
        check_inputs(rays.device, walked=(walked, torch.int32))
    if wtm.data_ptr() % 16:
        raise ValueError("triangle-major planes must be 16-byte aligned")
    t_out = torch.empty(n, dtype=torch.float32, device=rays.device)
    slot_out = torch.empty(n, dtype=torch.int32, device=rays.device)
    if n == 0:
        return t_out, slot_out
    with cuda_lib.launch(rays.device) as (lib, stream):
        err = lib.rfw_visit(ptr(rays), n, ptr(ids), ptr(counts),
                            ptr(tnears), m_c, ptr(wtm), wtm.shape[0], g, k,
                            float(t_epsilon), int(any_hit), ptr(t_out),
                            ptr(slot_out),
                            None if walked is None else ptr(walked), stream)
        cuda_lib.check(err, "visit kernel")
    launch_counts["visit"] += 1
    return t_out, slot_out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _pad_rays(origins, directions, t_max):
    r = origins.shape[0]
    pad = (-r) % BLOCK
    if pad:
        origins = torch.cat([origins, origins.new_zeros((pad, 3))])
        directions = torch.cat([directions, directions.new_ones((pad, 3))])
        t_max = torch.cat([t_max, t_max.new_zeros(pad)])
    return origins, directions, t_max, r


def _sort_carry_in(tl, origins, directions, t_max):
    """Coherence-sort rays (stable, so ties keep lane order). Returns the
    sorted (o, d, t_max) and the permutation for ``_sort_carry_out``."""
    keys = ray_sort_keys(origins, directions, tl["scene_lo"], tl["scene_hi"])
    keys = keys + ((t_max <= 0).long() << 28)
    order = torch.sort(keys, stable=True).indices
    return origins[order], directions[order], t_max[order], order


def _sort_carry_out(order, *cols):
    """Scatter sorted results back to the original lane order."""
    out = []
    for c in cols:
        o = torch.empty_like(c)
        o[order] = c
        out.append(o)
    return out


def triangle_major(wplanes):
    """(T, 16, K) plane blocks → (T, K, 12): rows 0-11 of each cell, one
    triangle's 12 floats (u, v, w rows of its Woop matrix) after another,
    so a triangle is three 16-byte loads and a cell 12·K contiguous
    floats."""
    return wplanes[:, :12].transpose(1, 2).contiguous()


def real_cells(lo) -> int:
    """Number of real cells in a box table, given its (T, 3) lower
    corners: the cells before the build's padding. Raises ValueError
    unless every cell past that count is a far box (lower corner at or
    past FAR_BOX on every axis), the condition under which the enum
    kernel may skip them."""
    far = (lo >= FAR_BOX).all(1)
    with tracing.span("sync.real_cells"):
        n = int((~far).sum())
        padded_far = bool(far[n:].all())
    if not padded_far:
        raise ValueError("padding cells are not all far boxes after the "
                         "real cells: the enum kernel cannot skip them")
    return n


def device_tables(tl) -> dict:
    """The tables the kernels derive from a scene build, made once per
    build (``scene_data.scene_to_torch``): the triangle-major planes of
    the cells (and of the sub-cell children, ``wplanes32_tm``, when the
    scene has the child tables) and the real cell counts of the cell and
    super-cell tables."""
    out = {"wplanes_tm": triangle_major(tl["wplanes"]),
           "n_cells": real_cells(tl["bmin"]),
           "n_super": real_cells(tl["sbmin"])}
    if "bmin32" in tl:
        k32 = tl["slot_to_prim"].shape[0] // tl["bmin32"].shape[0]
        out["wplanes32_tm"] = triangle_major(tl["wplanes32"][:, :, :k32])
    return out


class Granules(NamedTuple):
    """One visit granularity's tables: ``planes`` (n_gran, 16·super_g, K)
    for the plain version, ``planes_tm`` (n_gran, super_g·K, 12) for the
    kernel, the (8, n_gran) SoA box rows and their real count."""
    planes: torch.Tensor
    planes_tm: torch.Tensor
    bounds8: torch.Tensor
    n_real: int
    super_g: int
    k_size: int


def _granularity(tl, config) -> Granules:
    """Visit-granule tables: "cell" (one K-triangle cell per visit) or
    "super" (SUPER_G consecutive cells per visit)."""
    wp, wtm = tl["wplanes"], tl["wplanes_tm"]
    t, rows, k_size = wp.shape
    if config.visit_granularity == "super":
        from ..bvh.wide import SUPER_G
        g = SUPER_G
        wp = wp.reshape(t // g, g * rows, k_size)
        wtm = wtm.reshape(t // g, g * k_size, 12)
        lo, hi, n_real = tl["sbmin"], tl["sbmax"], tl["n_super"]
    else:
        g, lo, hi, n_real = 1, tl["bmin"], tl["bmax"], tl["n_cells"]
    bounds = torch.cat([lo.T, hi.T, lo.new_zeros((2, lo.shape[0]))])
    return Granules(wp, wtm, bounds.contiguous(), n_real, g, k_size)


def scene_diag(tl):
    """Length of the scene's bounding-box diagonal (keys quantise entry
    distances against it)."""
    ext = tl["scene_hi"] - tl["scene_lo"]
    return torch.sqrt(dot3(ext, ext))


def trace_passes(origins, directions, t_max, bounds8, n_real: int, diag,
                 m_c: int, any_hit: bool, coherent: bool, visit_window):
    """Visit-list passes to exactness: per-ray (t, slot). Enumerates the
    cells of ``bounds8`` (``n_real`` of them real; the envelope when
    ``coherent``, else the enum kernel), sorts them once, then runs
    ``visit_window(ids, counts,
    tnears, t_hi) -> (t, slot)`` on successive windows of ``m_c`` cells
    until every ray is finished. One host sync per pass (the
    all-finished test)."""
    n = origins.shape[0]
    t_c = bounds8.shape[1]
    rays0 = _pack_rays(origins, directions,
                       torch.where(t_max <= 0, 0.0, t_max))
    b_entry = (block_entries_envelope(rays0, bounds8) if coherent
               else block_entries(rays0, bounds8, n_real))
    keys_all, counts_all = sort_candidates(b_entry, diag, m_c)

    best_t = t_max.clone()
    best_slot = torch.full((n,), -1, dtype=torch.int32, device=t_max.device)
    finished = t_max <= 0
    for it in range(keys_all.shape[1] // m_c):
        with tracing.span("sync.visit_pass"):
            done = bool(finished.all())
        if done:
            break
        t_hi = torch.minimum(t_max, best_t)
        if any_hit:
            t_hi = torch.where(best_slot >= 0, 0.0, t_hi)
        t_hi = torch.where(finished, 0.0, t_hi)
        ids, counts, tnears, next_tnear = window_candidates(
            keys_all, counts_all, it, diag, m_c, t_c)
        t_row, s_row = visit_window(ids, counts, tnears, t_hi)
        # commit only actual new hits: finished blocks return (0, -1)
        better = (s_row >= 0) & (t_row < torch.minimum(best_t, t_max))
        best_t = torch.where(better, t_row, best_t)
        best_slot = torch.where(better, s_row, best_slot)
        # done: list exhausted, best hit precedes the next window's first
        # entry bound, or (occlusion) anything hit
        overflow = (counts_all > (it + 1) * m_c).repeat_interleave(BLOCK)[:n]
        if any_hit:
            finished = finished | ~overflow | (best_slot >= 0)
        else:
            ray_next = next_tnear.repeat_interleave(BLOCK)[:n]
            finished = finished | ~overflow | (best_t <= ray_next)
    return best_t, best_slot


def _trace(scene, origins, directions, t_max, config, any_hit: bool,
           coherent: bool = False):
    """The visit kernel's passes over the cell (or super-cell) lists."""
    tl = scene["treelets"]
    gran = _granularity(tl, config)

    def visit_window(ids, counts, tnears, t_hi):
        return visit(_pack_rays(origins, directions, t_hi), ids, counts,
                     tnears, gran, float(config.t_epsilon), any_hit)

    return trace_passes(origins, directions, t_max, gran.bounds8,
                        gran.n_real, scene_diag(tl), M_C, any_hit, coherent,
                        visit_window)


def closest_hit(scene, origins, directions, config, t_max=None,
                sort: bool = True, coherent: bool = False):
    """Intersector ABI: (t, prim, u, v); lanes with t_max == 0 are dead.
    ``sort=False`` for streams already in a coherent order; ``coherent``
    enables the per-block envelope enumeration."""
    return closest_hit_driver(_trace, scene, origins, directions, config,
                              t_max, sort, coherent)


def _ray_bounds(t, n, like):
    if t is None:
        return torch.full((n,), BIG_T, dtype=torch.float32,
                          device=like.device)
    t = torch.as_tensor(t, dtype=torch.float32, device=like.device)
    return t.expand(n).contiguous()


def closest_hit_driver(trace_fn, scene, origins, directions, config,
                       t_max, sort, coherent):
    """Closest-hit wrapper around a ``trace_fn(scene, o, d, tm, config,
    any_hit, coherent) -> (t, slot)``: coherence sort in, ray padding,
    slot → prim mapping, Möller–Trumbore refinement of the winner, sort
    out."""
    tl = scene["treelets"]
    n = origins.shape[0]
    t_max = _ray_bounds(t_max, n, origins)
    order = None
    if sort:
        origins, directions, t_max, order = _sort_carry_in(
            tl, origins, directions, t_max)
    o, d, tm, r = _pad_rays(origins, directions, t_max)
    t, slot = trace_fn(scene, o, d, tm, config, any_hit=False,
                       coherent=coherent)
    t, slot = t[:r], slot[:r]
    safe = torch.clamp(slot, min=0).long()
    prim = torch.where(slot >= 0, tl["slot_to_prim"][safe], -1)
    found = prim >= 0
    tv = tl["verts"][safe]
    rhit, rt, ru, rv = intersect_tri(
        o[:r], d[:r], tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0],
        t_epsilon=config.t_epsilon * 0.5)
    t = torch.where(found, torch.where(rhit, rt, t), BIG_T)
    u = torch.where(found & rhit, ru, 0.0)
    v = torch.where(found & rhit, rv, 0.0)
    if order is None:
        return t, prim, u, v
    return tuple(_sort_carry_out(order, t, prim, u, v))


def any_hit(scene, origins, directions, dist, config, sort: bool = True,
            coherent: bool = False):
    """Occlusion: True where something lies closer than ``dist``."""
    return any_hit_driver(_trace, scene, origins, directions, config, dist,
                          sort, coherent)


def any_hit_driver(trace_fn, scene, origins, directions, config, dist,
                   sort, coherent):
    """Occlusion wrapper (see closest_hit_driver)."""
    tl = scene["treelets"]
    n = origins.shape[0]
    dist = _ray_bounds(dist, n, origins)
    order = None
    if sort:
        origins, directions, dist, order = _sort_carry_in(
            tl, origins, directions, dist)
    o, d, tm, r = _pad_rays(origins, directions, dist)
    _, slot = trace_fn(scene, o, d, tm, config, any_hit=True,
                       coherent=coherent)
    slot = slot[:r]
    occluded = torch.where(
        slot >= 0, tl["slot_to_prim"][torch.clamp(slot, min=0).long()],
        -1) >= 0
    if order is None:
        return occluded
    return _sort_carry_out(order, occluded)[0]
