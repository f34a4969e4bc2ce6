"""Tiled rendering over several devices: each tile traces a contiguous
row block of the pixels (port of ``rfw_tpu.parallel.tiles``; BASELINE
config 5's route).

One host process drives every tile, as one JAX controller drives
rfw_tpu's shard_map. For each tile it works under ``torch.cuda.device``
of the tile's card (the kernels' launches go to the calling thread's
current device), on the scene's replica for that device (the engine's
own tensors when the device is the same), traces its rows with
``pixel_offset = tile * n_local`` and accumulates them. Every random
draw is keyed by the absolute pixel id, so a tiled frame equals the
single-device one per pixel. The collectives become:

* all-gather: each tile's rows copied to one device and concatenated in
  tile order;
* psum: every stats key summed over the tiles;
* the probe: the tile that owns the probe pixel gives it.

The engines' single-device fused frame runs through the same loop: a
mesh of n copies of the engine's device, one chunk of the frame a tile.

The tiles run one after another on the host: the compacted driver reads
the live count back once a depth, so tile i + 1's dispatch waits for
tile i's syncs, where rfw_tpu's shard_map runs the tiles at once.

The copies between cards: each step sends every tile its accumulator
rows and the view (the scatter), a scene replica goes to a card when
the replica cache misses (``mesh.replicate``), and the tiles' rows, aux
planes and the probe come back to the home card (the gather). Each is
a device-to-device copy the host only enqueues; the stats' scalars are
summed on the home card as the tiles finish. Spans and counters
(``utils/tracing``, recorded only while a profiler records):

* span ``tiles.tile``: one tile's trace on its card, one a tile a step;
* span ``tiles.gather``: the gather of the rows, aux planes and probe;
* span ``tiles.replicate``: a scene copy that misses the replica cache;
* counters ``tiles.tiles`` (tiles traced), ``tiles.scatter_bytes``
  (rows and view sent to the tiles' cards), ``tiles.gather_bytes``
  (rows, aux planes and probe copied back) and ``tiles.replica_bytes``
  (the scene copies of replica misses), from the tensors' shapes: a
  tensor counts where its copy goes to another device than its own
  (the scatter, the replicas) or comes from a tile whose device is not
  the home one (the gather). With every tile on one card, or on the
  CPU, every count of bytes is 0.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import RenderConfig
from ..render.integrator import Intersector, trace_sample
from ..render.wavefront_driver import WavefrontDriver
from ..utils import tracing
from .mesh import (make_tile_mesh, moved_bytes, replicate, row_block,
                   tree_bytes)


def _on(dev: torch.device):
    """The tile's card as the current device (nothing on the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _gather(parts, device):
    """The all-gather: the tiles' rows on ``device``, in tile order."""
    return torch.cat([p.to(device) for p in parts])


def _psum(total: dict, stats: dict, device) -> None:
    for k, v in stats.items():
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        total[k] = total[k] + v if k in total else v


def chunk_count(n_total: int, max_lanes: int, height: int | None = None):
    """The fewest equal chunks of at most ``max_lanes`` of ``n_total``
    pixels, preferably a count that divides ``height`` (chunks of whole
    image rows keep the 16x16 tile lane order available), else one that
    divides ``n_total``."""
    first = max(1, -(-n_total // max_lanes))
    n = first
    if height is not None:
        while height % n and n < height:
            n += 1
        if not height % n:
            return n
        n = first
    while n_total % n:
        n += 1
    return n


def _run_tiles(mesh, n_local: int, replicas: dict, trace, scene, rows,
               view, sample_index: int, probe_index: int, with_aux: bool,
               home, gather: bool = True):
    """The one loop over the tiles: ``trace(i, scene, view, rows, rel,
    sample_index, with_aux)`` runs tile i on its device and returns
    (rows', probe, stats, aux or None), aux in the tile's pixel order,
    ``rel`` the probe index within the tile; ``rows`` holds each tile's
    (n_local, 3) accumulator rows, on any device. Returns the tiles' new
    rows (gathered on ``home`` with ``gather``, else each on its tile's
    device), the owning tile's probe and the summed stats on ``home``,
    and the tiles' aux planes gathered on ``home`` (None when the tiles
    make none)."""
    owner = min(max(probe_index // n_local, 0), len(mesh) - 1)
    out, aux, stats, probe = [], [], {}, None
    for i, dev in enumerate(mesh):
        rel = min(max(probe_index - i * n_local, 0), n_local - 1)
        with tracing.span("tiles.tile"):
            tracing.count("tiles.tiles")
            tracing.count("tiles.scatter_bytes",
                          moved_bytes((rows[i], view), dev))
            with _on(dev):
                rows_i, probe_i, st, aux_i = trace(
                    i, replicate(scene, dev, replicas), replicate(view, dev),
                    rows[i].to(dev), rel, sample_index, with_aux)
            out.append(rows_i)
            aux.append(aux_i)
            _psum(stats, st, home)
            if i == owner:
                probe = probe_i
    away = [i for i, dev in enumerate(mesh) if dev != home]
    with tracing.span("tiles.gather"):
        tracing.count("tiles.gather_bytes", tree_bytes(
            [(out[i] if gather else None, aux[i]) for i in away]
            + [probe if owner in away else None]))
        probe = probe.to(home)
        aux = (None if aux[0] is None else
               {k: _gather([a[k] for a in aux], home) for k in aux[0]})
        if gather:
            out = _gather(out, home)
    return out, probe, stats, aux


def make_step(mesh, n_local: int, trace, replicas: dict | None = None):
    """The engine step over ``mesh``, one row block of ``n_local`` pixels
    a tile: step(scene, accumulator, view, sample_index, probe_index,
    with_aux=True) → (accumulator', probe, stats, aux), the accumulator
    and aux full-frame, row-major and on the accumulator's device.
    ``trace`` runs one tile (see ``_run_tiles``). ``replicas`` is the
    caller's cache of scene copies (``mesh.replicate``), cleared when
    its scene changes. A mesh of n copies of one device is the
    single-device frame in n chunks."""
    replicas = {} if replicas is None else replicas

    def step(scene, accumulator, view, sample_index, probe_index,
             with_aux=True):
        home = accumulator.device
        rows = [accumulator[i * n_local:(i + 1) * n_local]
                for i in range(len(mesh))]
        return _run_tiles(mesh, n_local, replicas, trace, scene, rows, view,
                          sample_index, probe_index, with_aux, home)

    return step


def _fused_trace(width, height, config, intersector, n_local,
                 tex_flags=None):
    """A tile on the fused ``trace_sample``: its radiance added to its
    rows."""
    def trace(i, scene, view, rows, rel, sample_index, with_aux):
        radiance, probe, st, aux = trace_sample(
            scene, view, width, height, sample_index, rel, config,
            intersector, pixel_offset=i * n_local, n_pixels=n_local,
            tex_flags=tex_flags, with_aux=with_aux)
        return rows + radiance, probe, st, aux

    return trace


def make_tiled_renderer(mesh, width: int, height: int,
                        config: RenderConfig, intersector: Intersector,
                        gather: bool = True):
    """A tiled render step over ``mesh`` (a tuple of devices, one a tile).

    Returns step(scene, rows, view, sample_index) → (accumulator',
    stats), where ``rows`` holds each tile's (n_local, 3) accumulator on
    its device. With ``gather=True`` the accumulator comes back gathered
    on ``mesh[0]``, (W*H, 3); with ``gather=False`` as the tiles' rows,
    for accumulating several samples before one gather."""
    n_local = row_block(width * height, len(mesh))
    trace = _fused_trace(width, height, config, intersector, n_local)
    replicas: dict = {}

    def step(scene, rows, view, sample_index):
        out, _, stats, _ = _run_tiles(mesh, n_local, replicas, trace, scene,
                                      rows, view, sample_index, 0, False,
                                      mesh[0], gather)
        return (out if gather else tuple(out)), stats

    return step


def make_engine_step(mesh, width: int, height: int, config: RenderConfig,
                     intersector: Intersector, tex_flags=None,
                     replicas: dict | None = None):
    """``make_step`` with each tile on the fused ``trace_sample``."""
    n_local = row_block(width * height, len(mesh))
    return make_step(mesh, n_local, _fused_trace(
        width, height, config, intersector, n_local, tex_flags), replicas)


def make_driver_engine_step(mesh, width: int, height: int,
                            config: RenderConfig, intersector: Intersector,
                            tex_flags=None, chunk: int | None = None,
                            replicas: dict | None = None):
    """``make_step`` with each tile on the compacted wavefront driver
    (per-depth lane compaction) over its row block: one
    ``WavefrontDriver`` a tile, with absolute pixel ids and chunks of at
    most ``config.max_rays_per_pass`` lanes that divide the tile."""
    n_local = row_block(width * height, len(mesh))
    if chunk is None:
        chunk = n_local // chunk_count(n_local, config.max_rays_per_pass)
    drivers = [WavefrontDriver(width, height, config, intersector, tex_flags,
                               chunk, dev, n_pixels=n_local,
                               pixel_offset=i * n_local)
               for i, dev in enumerate(mesh)]

    def trace(i, scene, view, rows, rel, sample_index, with_aux):
        drv = drivers[i]
        rows, probe, st, aux = drv.step(scene, rows, view, sample_index, rel,
                                        with_aux=with_aux)
        return (rows, probe, st,
                None if aux is None else drv.aux_inverse(aux))

    return make_step(mesh, n_local, trace, replicas)


def render_tiled(scene, view, width: int, height: int,
                 config: RenderConfig, intersector: Intersector,
                 samples: int = 1, mesh=None):
    """Allocate, run ``samples`` samples, resolve: (frame (H, W, 3) on
    ``mesh[0]``, the last sample's stats). The tiles accumulate their own
    rows and are gathered once, at the end. ``mesh`` defaults to every
    card (one tile on the CPU) of the scene's device."""
    mesh = mesh or make_tile_mesh(device=scene["tri_pack"].device)
    n_local = row_block(width * height, len(mesh))
    step = make_tiled_renderer(mesh, width, height, config, intersector,
                               gather=False)
    rows = tuple(torch.zeros((n_local, 3), device=dev) for dev in mesh)
    stats = None
    for s in range(samples):
        rows, stats = step(scene, rows, view, s)
    frame = _gather(rows, mesh[0]) / float(max(samples, 1))
    return frame.reshape(height, width, 3), stats
