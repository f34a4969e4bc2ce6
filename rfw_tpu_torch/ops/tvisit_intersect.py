"""Transposed sub-cell visit-list intersector (torch port of
``rfw_tpu/ops/tvisit_intersect.py``).

Parent candidates come from the visit intersector unchanged
(``visit_intersect.trace_passes``: enum kernel or envelope, entry-sorted
keys, windows of ``M_C`` cells, recull passes), always at cell
granularity. Then, per pass:

1. **Expand** (kernel ``expand_children``): each window's parents become
   ``4 * M_C`` child cells of K/4 triangles (``subdivide_cells``). Every
   ray of a 128-ray sub-block is slab-tested against them, the entries
   are reduced per sub-block and row-sorted into a front-to-back child
   list per sub-block.
2. **Visit** (kernel ``tvisit``): per sub-block, walk its child list and
   Woop-test its 128 rays against each child's triangles, with an early
   exit once no later child can win.

Parent entries lower-bound their children's, so the cross-window exit
stays exact. Slots are the visit intersector's (child·K/4 + k equals
cell·K + sub-range), so the shared closest-hit/any-hit drivers refine
and map them unchanged.

Both kernels are hand-written CUDA (``csrc/expand_kernel.cu``,
``csrc/tvisit_kernel.cu``). Their wrappers run the plain versions
(``expand_children_ref``, ``tvisit_ref``) only for CPU tensors; a CUDA
tensor launches the kernel, and any other device raises. The scene needs
the child tables that ``build_device_scene`` adds under
``config.subcell_tables``; the tvisit kernel reads their triangle-major
form ``wplanes32_tm`` (``visit_intersect.device_tables``).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .intersect import BIG_T, safe_inv_dir
from .cuda_lib import check_inputs, launch_counts, ptr
from .visit_intersect import (BLOCK, EXIT_EVERY, M_C, _BIGKEY, _pack_rays,
                              any_hit_driver, closest_hit_driver, quant_gran,
                              quant_scale, scene_diag, slab_crossed,
                              trace_passes)

SUB = 2                 # sub-blocks per 256-ray block
LANES = BLOCK // SUB    # rays per sub-block
_CHUNK_BLOCKS = 256     # blocks per slab chunk: (256, 256, 4*M_C) floats


# ---------------------------------------------------------------------------
# Child expansion: parent window → per-sub-block entry-sorted child lists
# ---------------------------------------------------------------------------

def _slot_bits(cslots: int) -> tuple:
    """(slot bits, qmax) of the packed child keys: 9 slot bits at
    4·M_C = 512 leave 15 bits of quantized entry."""
    sb = max((cslots - 1).bit_length(), 1)
    return sb, (1 << (24 - sb)) - 1


def expand_children_ref(ids, rays, bmin32, bmax32, diag, t_p: int):
    """Plain version of the expansion kernel: parent window ids (NB, M_C)
    and rays (8, N) → per-sub-block child visit lists.

    Slab-tests every ray of each sub-block against the 4·M_C child boxes
    of its block's window (chunked over blocks, one axis at a time, to
    bound the (256, 256, 4·M_C) transients), takes each child's minimum
    entry per sub-block, and row-sorts packed exact-integer keys
    (quantized entry | slot).

    Returns (cids, counts, tnears): global child ids (NB·SUB, 4·M_C;
    invalid = 4·t_p), live counts, and entry lower bounds (BIG_T pad).
    """
    nb, m_p = ids.shape
    cslots = 4 * m_p
    t32 = 4 * t_p
    dev = ids.device
    # global child ids of the window; invalid parents → t32
    cid = (torch.clamp(ids, max=t_p - 1)[:, :, None] * 4
           + torch.arange(4, dtype=ids.dtype, device=dev))
    cid = torch.where((ids < t_p)[:, :, None], cid, t32).reshape(nb, cslots)
    # invalid slots get a far-point box, not the clamped last child's:
    # when the padded cell count equals the real one, child t32-1 is real
    cb = torch.cat([bmin32, bmax32], 1)
    cbw = cb[torch.clamp(cid, max=t32 - 1).reshape(-1).long()].reshape(
        nb, cslots, 6)
    cbw = torch.where((cid < t32)[:, :, None], cbw, 3e37)

    r = rays.reshape(8, nb, BLOCK)
    inv = safe_inv_dir(r[4:7])
    e_sub = torch.empty((nb, SUB, cslots), dtype=torch.float32, device=dev)
    for s in range(0, nb, _CHUNK_BLOCKS):
        c = slice(s, s + _CHUNK_BLOCKS)
        ent = ext = None
        for ax in range(3):
            o = r[ax, c, :, None]                         # (nbc, B, 1)
            iv = inv[ax, c, :, None]
            t1 = (cbw[c, None, :, ax] - o) * iv           # (nbc, B, S)
            t2 = (cbw[c, None, :, 3 + ax] - o) * iv
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            ent = lo if ent is None else torch.maximum(ent, lo)
            ext = hi if ext is None else torch.minimum(ext, hi)
        ent = torch.clamp(ent, min=0.0)
        e = torch.where(slab_crossed(ent, ext, r[3, c, :, None]), ent, 1e30)
        e_sub[c] = e.reshape(-1, SUB, LANES, cslots).amin(2)
    e_sub = e_sub.reshape(nb * SUB, cslots)

    sb, qmax = _slot_bits(cslots)
    q = torch.clamp(torch.floor(e_sub * quant_scale(qmax, diag)), 0.0,
                    float(qmax))
    slot_f = torch.arange(cslots, dtype=torch.float32, device=dev)[None]
    key = torch.where(e_sub < BIG_T, q * float(1 << sb) + slot_f, _BIGKEY)
    keys = torch.sort(key, dim=-1).values
    valid = keys < _BIGKEY
    counts = valid.sum(-1).to(torch.int32)
    slot_srt = torch.where(valid, keys.to(torch.int32) & ((1 << sb) - 1), 0)
    cid_sub = cid.repeat_interleave(SUB, dim=0)           # (NB·SUB, S)
    cids = torch.where(valid, torch.gather(cid_sub, 1, slot_srt.long()),
                       t32).to(torch.int32)
    tnears = torch.where(valid, torch.floor(keys / float(1 << sb))
                         * quant_gran(qmax, diag), BIG_T)
    return cids.contiguous(), counts, tnears.contiguous()


def expand_children(ids, rays, bmin32, bmax32, diag, t_p: int):
    """Per-sub-block child visit lists (cids, counts, tnears) of a parent
    window: the expansion kernel on CUDA tensors, ``expand_children_ref``
    on CPU tensors (see there). ``diag`` is the scene diagonal as a
    0-dim tensor; the kernel reads the quantisation scale and step from
    the device, with no host sync."""
    nb, m_p = ids.shape
    cslots = 4 * m_p
    n = rays.shape[1]
    if (rays.shape[0] != 8 or n != nb * BLOCK
            or bmin32.shape != (4 * t_p, 3) or bmax32.shape != bmin32.shape
            or diag.shape != ()):
        raise ValueError(
            f"bad shapes: ids {tuple(ids.shape)}, rays {tuple(rays.shape)}, "
            f"child boxes {tuple(bmin32.shape)}/{tuple(bmax32.shape)} for "
            f"{t_p} parents, diag {tuple(diag.shape)}")
    if not cuda_lib.kernel_device(rays, "visit-list"):
        return expand_children_ref(ids, rays, bmin32, bmax32, diag, t_p)
    check_inputs(rays.device, rays=(rays, torch.float32),
                  ids=(ids, torch.int32), bmin32=(bmin32, torch.float32),
                  bmax32=(bmax32, torch.float32), diag=(diag, torch.float32))
    sb, qmax = _slot_bits(cslots)
    scale = quant_scale(qmax, diag)
    gran = quant_gran(qmax, diag)
    cids = torch.empty((nb * SUB, cslots), dtype=torch.int32,
                       device=rays.device)
    counts = torch.empty(nb * SUB, dtype=torch.int32, device=rays.device)
    tnears = torch.empty((nb * SUB, cslots), dtype=torch.float32,
                         device=rays.device)
    if n == 0:
        return cids, counts, tnears
    with cuda_lib.launch(rays.device) as (lib, stream):
        err = lib.rfw_expand(ptr(rays), n, ptr(ids), m_p, t_p, ptr(bmin32),
                             ptr(bmax32), ptr(scale), ptr(gran), sb,
                             float(qmax), float(BIG_T), ptr(cids),
                             ptr(counts), ptr(tnears), stream)
        cuda_lib.check(err, "expansion kernel")
    launch_counts["expand"] += 1
    return cids, counts, tnears


def expand_occupancy(lib=None) -> int:
    """Resident blocks of the expansion kernel per SM of the current CUDA
    device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), from
    ``lib`` or this checkout's kernel library."""
    lib = lib or cuda_lib.load()
    blocks = ctypes.c_int(0)
    cuda_lib.check(lib.rfw_expand_occupancy(ctypes.byref(blocks)),
                   "expansion occupancy query")
    return blocks.value


# ---------------------------------------------------------------------------
# The tvisit kernel
# ---------------------------------------------------------------------------

def tvisit_ref(rays, cids, counts, tnears, wg32, k_size: int,
               t_epsilon: float, any_hit: bool):
    """Plain version of the tvisit kernel, in the TPU kernel's form: per
    sub-block and visit, a (K, 128) Woop test, an argmin over the K
    triangles (lowest k wins a tie) and a strict commit (the earliest
    visit wins), with the same per-sub-block exit cadence. Returns per-ray
    (t, slot) with t = t_max and slot = -1 on a miss."""
    ns, cslots = cids.shape
    n_child = wg32.shape[0]
    r = rays.reshape(8, ns, LANES)
    o = [r[a][:, None, :] for a in range(3)]             # (NS, 1, LANES)
    d = [r[4 + a][:, None, :] for a in range(3)]
    t_max0 = r[3]
    bt = t_max0.clone()
    bs = torch.full((ns, LANES), -1, dtype=torch.int32, device=rays.device)
    counts = counts.long()
    done = torch.zeros(ns, dtype=torch.bool, device=rays.device)
    rows = torch.arange(ns, device=rays.device)
    n_max = int(counts.max()) if ns else 0
    for i in range(n_max):
        live = ~done & (i < counts)
        j = torch.clamp(torch.clamp(counts - 1, max=i), 0, cslots - 1)
        g = torch.clamp(cids[rows, j].long(), max=n_child - 1)
        wp = wg32[g]                                     # (NS, 16, 128)
        w = [wp[:, q, :k_size, None] for q in range(12)]  # (NS, K, 1)

        def xf_o(c0):
            a = w[c0 + 3] + w[c0] * o[0]
            a = a + w[c0 + 1] * o[1]
            return a + w[c0 + 2] * o[2]

        def xf_d(c0):
            a = w[c0] * d[0]
            a = a + w[c0 + 1] * d[1]
            return a + w[c0 + 2] * d[2]

        ou, du = xf_o(0), xf_d(0)
        ov, dv = xf_o(4), xf_d(4)
        ow, dw = xf_o(8), xf_d(8)
        valid = dw.abs() > 1e-12
        t = -ow / torch.where(valid, dw, 1.0)
        u = ou + t * du
        v = ov + t * dv
        hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_epsilon))
        tmin, kmin = torch.where(hit, t, 1e30).min(1)    # first k on ties
        upd = (tmin < bt) & live[:, None]
        bt = torch.where(upd, tmin, bt)
        bs = torch.where(upd, (g[:, None] * k_size + kmin).to(torch.int32),
                         bs)
        if i % EXIT_EVERY == EXIT_EVERY - 1:
            if any_hit:
                d_s = ~((bt >= t_max0) & (t_max0 > 0)).any(1)
            else:
                d_s = bt.amax(1) <= tnears[:, min(i + 1, cslots - 1)]
            done = done | (live & d_s)
        done = done | (i + 1 >= counts)
    found = bt < t_max0
    return (torch.where(found, bt, t_max0).reshape(-1),
            torch.where(found, bs, -1).reshape(-1))


def tvisit(rays, cids, counts, tnears, wg32, wtm32, k_size: int,
           t_epsilon: float, any_hit: bool, walked=None):
    """Per-sub-block child-list walk: per-ray (t, slot). The tvisit kernel
    on CUDA tensors, reading the triangle-major child planes ``wtm32``
    (T32, K, 12); ``tvisit_ref`` on CPU tensors, reading the lane-padded
    ``wg32`` (T32, 16, 128). ``walked``, an (NS,) int32 tensor, receives
    each sub-block's count of walked visits (kernel only)."""
    ns, cslots = cids.shape
    n = rays.shape[1]
    if (rays.shape[0] != 8 or n != ns * LANES or counts.shape != (ns,)
            or tnears.shape != (ns, cslots) or wg32.dim() != 3
            or wg32.shape[1] < 12 or not 0 < k_size <= wg32.shape[2]
            or wtm32.shape != (wg32.shape[0], k_size, 12)
            or (walked is not None and walked.shape != (ns,))):
        raise ValueError(
            f"bad shapes: rays {tuple(rays.shape)}, cids "
            f"{tuple(cids.shape)}, counts {tuple(counts.shape)}, tnears "
            f"{tuple(tnears.shape)}, planes {tuple(wg32.shape)}, "
            f"triangle-major planes {tuple(wtm32.shape)}, k_size {k_size}")
    if not cuda_lib.kernel_device(rays, "visit-list"):
        if walked is not None:
            raise ValueError("walked visits are counted by the kernel only")
        return tvisit_ref(rays, cids, counts, tnears, wg32, k_size,
                          t_epsilon, any_hit)
    check_inputs(rays.device, rays=(rays, torch.float32),
                  cids=(cids, torch.int32), counts=(counts, torch.int32),
                  tnears=(tnears, torch.float32),
                  planes_tm=(wtm32, torch.float32))
    if walked is not None:
        check_inputs(rays.device, walked=(walked, torch.int32))
    if wtm32.data_ptr() % 16:
        raise ValueError("triangle-major planes must be 16-byte aligned")
    t_out = torch.empty(n, dtype=torch.float32, device=rays.device)
    slot_out = torch.empty(n, dtype=torch.int32, device=rays.device)
    if n == 0:
        return t_out, slot_out
    with cuda_lib.launch(rays.device) as (lib, stream):
        err = lib.rfw_tvisit(ptr(rays), n, ptr(cids), ptr(counts),
                             ptr(tnears), cslots, ptr(wtm32),
                             wtm32.shape[0], k_size, float(t_epsilon),
                             int(any_hit), ptr(t_out), ptr(slot_out),
                             None if walked is None else ptr(walked),
                             stream)
        cuda_lib.check(err, "tvisit kernel")
    launch_counts["tvisit"] += 1
    return t_out, slot_out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def child_tables(tl):
    """(bmin32, bmax32, wplanes32, wplanes32_tm, k32) of the scene's
    treelets; raises ValueError when the scene was built without them."""
    if "bmin32" not in tl:
        raise ValueError(
            "the tvisit intersector needs the sub-cell child tables: build "
            "the scene with config.subcell_tables=True (and a treelet_size "
            "that is a multiple of 4, at least 32)")
    # child triangle count from the slot table (the plane blocks are
    # lane-padded to 128, so their width cannot tell)
    k32 = tl["slot_to_prim"].shape[0] // tl["bmin32"].shape[0]
    return (tl["bmin32"], tl["bmax32"], tl["wplanes32"], tl["wplanes32_tm"],
            k32)


def parent_bounds(tl):
    """(8, T) SoA rows of the cell boxes: the parent windows are always
    cell-granular, whatever ``config.visit_granularity`` says."""
    bmin, bmax = tl["bmin"], tl["bmax"]
    return torch.cat([bmin.T, bmax.T,
                      bmin.new_zeros((2, bmin.shape[0]))]).contiguous()


def _trace(scene, origins, directions, t_max, config, any_hit: bool,
           coherent: bool = False):
    """Parent windows expanded to child lists and walked by the tvisit
    kernel, pass after pass."""
    tl = scene["treelets"]
    bmin32, bmax32, wg32, wtm32, k32 = child_tables(tl)
    bounds8 = parent_bounds(tl)
    t_p = bounds8.shape[1]
    diag = scene_diag(tl)

    def visit_window(ids, counts, tnears, t_hi):
        rays = _pack_rays(origins, directions, t_hi)    # one packing, both
        cids, ccounts, ctnears = expand_children(ids, rays, bmin32, bmax32,
                                                 diag, t_p)
        return tvisit(rays, cids, ccounts, ctnears, wg32, wtm32, k32,
                      float(config.t_epsilon), any_hit)

    return trace_passes(origins, directions, t_max, bounds8, tl["n_cells"],
                        diag, M_C, any_hit, coherent, visit_window)


def closest_hit(scene, origins, directions, config, t_max=None,
                sort: bool = True, coherent: bool = False):
    """Intersector ABI: (t, prim, u, v); lanes with t_max == 0 are dead."""
    return closest_hit_driver(_trace, scene, origins, directions, config,
                              t_max, sort, coherent)


def any_hit(scene, origins, directions, dist, config, sort: bool = True,
            coherent: bool = False):
    """Occlusion: True where something lies closer than ``dist``."""
    return any_hit_driver(_trace, scene, origins, directions, config, dist,
                          sort, coherent)
