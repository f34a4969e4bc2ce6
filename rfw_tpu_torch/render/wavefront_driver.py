"""Compacted wavefront driver (torch port of
``rfw_tpu.render.wavefront_driver``): per-depth whole-frame stages with
lane compaction between depths.

* Depth 0 runs ray-gen fused into the stage, chunk by chunk.
* Between depths the per-lane ``PathState`` lives packed in one (N, 18)
  float32 matrix (flags encoded, the int32 pid carried as float32 bits)
  and compacts by ONE stable sort on (dead, direction octant, direction
  Morton, origin Morton) keys: live lanes first, coherence-ordered for
  the intersector, whose own per-launch sort is then skipped.
* Later depths only run ceil(live / chunk) chunks. The live count is
  read back to the host once per depth — the reference keeps it on the
  device under a traced trip count; eager PyTorch needs it on the host
  to size the chunk loop.
* Counters (``utils/tracing``, recorded only while a profiler records):
  ``driver.lanes_run``, the lanes the chunks of each depth from 1 on
  run (``nc * chunk``), and ``driver.lanes_live``, the live lanes among
  them (the count the compaction already reads back).
* After the last depth the radiance scatters back to pixel order by pid.
  Depth 0's aux planes (the denoiser's guide normals and depths) stay in
  the lanes' tile-permuted order; ``aux_inverse`` orders them by pixel,
  once a frame, when the engine denoises.

Every random draw is keyed by pixel id (+ sample, depth), so the
compacted frame equals the fused ``trace_sample`` frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.compaction import ray_sort_keys
from ..ops.rng import blue_noise_shift_row
from ..utils import tracing
from .integrator import (Intersector, PathState, _tile_permutation,
                         depth_stage, make_path_state)


def _pack_state(state: PathState):
    """PathState → (N, 18) float32. The pid column is the int32 pid's
    bit pattern (pids < 2^31 are never NaN patterns); it only moves
    through gathers and slices, never arithmetic."""
    flags = state.alive.float() + 2.0 * state.spec_bounce.float()
    pid_f = state.pid.to(torch.int32).view(torch.float32)
    return torch.cat([state.origin, state.direction, state.throughput,
                      state.last_n, state.last_pdf[:, None], state.radiance,
                      flags[:, None], pid_f[:, None]], dim=1)


def _unpack_state(m) -> PathState:
    flags = m[:, 16]
    return PathState(
        origin=m[:, 0:3], direction=m[:, 3:6], throughput=m[:, 6:9],
        radiance=m[:, 13:16], last_n=m[:, 9:12], last_pdf=m[:, 12],
        spec_bounce=flags >= 2.0,
        alive=torch.remainder(flags, 2.0) >= 1.0,
        pid=m[:, 17].contiguous().view(torch.int32))


def _compact_keys_of(scene, state: PathState):
    tl = scene["treelets"]
    keys = ray_sort_keys(state.origin, state.direction, tl["scene_lo"],
                         tl["scene_hi"])
    return keys + ((~state.alive).long() << 28)


def _compact_sort_packed(scene, packed):
    """Stable sort of the packed rows by compaction key; returns the
    sorted rows and the live count (device scalar)."""
    state = _unpack_state(packed)
    order = torch.sort(_compact_keys_of(scene, state), stable=True).indices
    return packed[order], state.alive.sum()


def _compact_prefix(scene, packed, prev_nc: int, chunk: int):
    """Compact only the first ``prev_nc * chunk`` rows — the rows the
    previous depth touched. Rows beyond are an already-compacted dead
    tail: nothing revives a lane, and live keys sort below dead ones, so
    the live prefix equals a full-frame compaction. Returns (packed,
    live) with ``live`` a host int (one sync)."""
    if prev_nc == 0:
        return packed, 0
    m = prev_nc * chunk
    head, live = _compact_sort_packed(scene, packed[:m])
    if m < packed.shape[0]:
        head = torch.cat([head, packed[m:]])
    with tracing.span("sync.compact"):
        live = int(live)
    return head, live


class WavefrontDriver:
    """The compacted per-sample step for one (width, height, config,
    intersector) combination, over the ``n_pixels`` pixels from
    ``pixel_offset`` on (the whole frame by default; a tile's row block
    under ``parallel.tiles``). Ray generation and every random draw see
    absolute pixel ids; the accumulator, the probe index and the aux
    planes are the range's own, from 0."""

    def __init__(self, width: int, height: int, config: RenderConfig,
                 intersector: Intersector, tex_flags, chunk: int, device,
                 n_pixels: int | None = None, pixel_offset: int = 0):
        n = n_pixels if n_pixels is not None else width * height
        if n % chunk:
            raise ValueError(f"chunk {chunk} does not divide {n} lanes")
        self.width, self.height, self.n, self.chunk = width, height, n, chunk
        self.pixel_offset = pixel_offset
        self.config = config
        self.device = torch.device(device)
        self._intersector = intersector
        self._tex_flags = tex_flags
        tp = _tile_permutation(width, n)
        pid_np = tp[0] if tp is not None else np.arange(n, dtype=np.int32)
        self._pid = torch.from_numpy(pid_np + np.int32(pixel_offset)).to(
            self.device)
        pid_l = self._pid.long()
        self._sx, self._sy = pid_l % width, pid_l // width
        self._inv_np = tp[1] if tp is not None else None
        self._inv = (torch.from_numpy(self._inv_np).to(self.device).long()
                     if tp is not None else None)
        self._pc = None
        self._pc_key = None
        self.depth_times: list[float] = []

    def _pixel_cache(self, scene):
        """Sample-invariant per-pixel raygen values in lane order: sx/sy,
        and the blue-noise shift rows (one gather per scene)."""
        bn = scene.get("blue_noise") if self.config.blue_noise else None
        key = id(bn) if bn is not None else None
        if self._pc is None or self._pc_key != key:
            pc = {"sx": self._sx, "sy": self._sy}
            if bn is not None and bn.ndim == 3:
                pc["bn_row"] = blue_noise_shift_row(bn, self._sx, self._sy)
            self._pc, self._pc_key = pc, key
        return self._pc

    def _stage(self, scene, view, state, sample_index, probe_lane, depth,
               with_aux: bool = True):
        return depth_stage(scene, view, state, self.width, depth,
                           sample_index, probe_lane, self.config,
                           self._intersector, tex_flags=self._tex_flags,
                           sort_rays=False, height=self.height,
                           with_aux=with_aux)

    def step(self, scene, accumulator, view, sample_index: int,
             probe_index: int, depth_times: list | None = None,
             with_aux: bool = True):
        """One sample for the driver's pixels. Returns (accumulator, probe,
        stats, aux) with stats {"ray_count_d", "shadow_count_d"} as
        device scalars and aux depth 0's {"normal" (N, 3), "depth" (N,)}
        in lane order (``aux_inverse``), None unless ``with_aux``. With ``depth_times`` (a list),
        the device is synchronised at the end of each depth and the
        depth's wall time (its stages and the compaction after it), the
        ``driver.depth`` span's own, is appended, in seconds."""
        cfg, n, chunk = self.config, self.n, self.chunk
        probe_lane = (probe_index if self._inv_np is None
                      else int(self._inv_np[probe_index]))
        pc = self._pixel_cache(scene)
        packed = torch.empty((n, 18), device=self.device)
        stats = {}
        probe = None
        aux = []
        nc = n // chunk
        for depth in range(cfg.max_path_length + 1):
            with tracing.span("driver.depth",
                              timed=depth_times is not None) as span:
                for c in range(nc):
                    sl = slice(c * chunk, (c + 1) * chunk)
                    rel = probe_lane - c * chunk
                    in_chunk = depth == 0 and 0 <= rel < chunk
                    if depth == 0:
                        with tracing.span("driver.raygen"):
                            state = make_path_state(
                                scene, view, self.width, self.height,
                                sample_index, cfg, self._pid[sl],
                                pixel_cache={k: v[sl] for k, v in pc.items()})
                    else:
                        state = _unpack_state(packed[sl])
                    with tracing.span("driver.stage"):
                        out, st, probe_c, aux_c = self._stage(
                            scene, view, state, sample_index,
                            rel if in_chunk else 0, depth, with_aux=with_aux)
                    with tracing.span("driver.pack"):
                        packed[sl] = _pack_state(out)
                    if in_chunk:
                        probe = probe_c
                    if depth == 0 and with_aux:
                        aux.append(aux_c)
                    for k, v in st.items():
                        key = f"{k}_{depth}"
                        stats[key] = stats[key] + v if key in stats else v
                if depth < cfg.max_path_length:
                    with tracing.span("driver.compact"):
                        packed, live = _compact_prefix(scene, packed, nc,
                                                       chunk)
                    nc = -(-live // chunk)
                    # the next depth's lanes: those its chunks run, and
                    # the live ones among them
                    tracing.count("driver.lanes_run", nc * chunk)
                    tracing.count("driver.lanes_live", live)
                if depth_times is not None and self.device.type == "cuda":
                    with tracing.span("sync.depth_times"):
                        torch.cuda.synchronize(self.device)
            if depth_times is not None:
                depth_times.append(span.seconds)

        with tracing.span("driver.resolve"):
            pid = packed[:, 17].contiguous().view(torch.int32).long()
            radiance = torch.empty((n, 3), device=self.device)
            radiance[pid - self.pixel_offset] = packed[:, 13:16]
            aux = ({k: torch.cat([a[k] for a in aux]) for k in aux[0]}
                   if with_aux else None)
            accumulator = accumulator + radiance
        return accumulator, probe, stats, aux

    def aux_inverse(self, aux):
        """``step``'s aux planes from lane order to pixel order."""
        if self._inv is None:
            return aux
        return {k: v[self._inv] for k, v in aux.items()}

    def step_profiled(self, scene, accumulator, view, sample_index: int,
                      probe_index: int, with_aux: bool = True):
        """``step`` with a device sync after each depth, its wall times in
        ``depth_times`` (the per-stage RenderStats split); the frame is
        the same."""
        self.depth_times = []
        return self.step(scene, accumulator, view, sample_index,
                         probe_index, depth_times=self.depth_times,
                         with_aux=with_aux)

    def step_multi(self, scene, accumulator, view, sample_index: int,
                   probe_index: int, n_samples: int, with_aux: bool = True):
        """``n_samples`` consecutive samples; probe, stats and aux are the
        last sample's (only the last builds aux)."""
        probe = stats = aux = None
        for s in range(n_samples):
            accumulator, probe, stats, aux = self.step(
                scene, accumulator, view, sample_index + s, probe_index,
                with_aux=with_aux and s == n_samples - 1)
        return accumulator, probe, stats, aux
