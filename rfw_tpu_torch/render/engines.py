"""Path-tracing engines implementing the EngineContext ABI (port of
``rfw_tpu.render.engines``).

* ``megakernel`` — the full path tracer on the ``bvh`` intersector, whose
  traversal is a hand-written CUDA kernel: every chunk of a frame runs
  the fused ``trace_sample``, all depths on fixed lanes;
* ``bruteforce`` — the same on the O(R·T) ``brute`` intersector, the
  oracle for tiny scenes;
* ``direct`` — primary rays and next-event estimation only (no bounces):
  ``megakernel`` with ``max_path_length=0`` and no Russian roulette;
* ``wavefront`` — the visit-list intersector (``tvisit`` or any other on
  request, through ``set_setting``): frames of more than one chunk go
  through the compacted ``WavefrontDriver``, single-chunk frames run the
  fused ``trace_sample`` (with one chunk, compaction cannot save work).

Kernels run on a CUDA device and their plain PyTorch versions on the
CPU. ``PathTracerEngine._route`` picks the path of a same-topology update
(a moved instance, a deformed mesh):

=====================================  ===============  ===============
scene / intersector                    move             deformation
=====================================  ===============  ===============
``tlas`` (scene has TLAS tables)       device update    full build
no TLAS tables, not ``bvh``,           device update    device update
``config.device_refit``
``bvh``, or ``device_refit`` False     host refit       host refit
TLAS tables, not ``tlas``              full build       full build
=====================================  ===============  ===============

The device update (``scene_data.move_instances_device``) leaves the wide
BVH and the BLASes as they were; the host refit
(``scene_data.refit_deformed``) counts towards ``config.max_refits``.

With ``config.n_devices`` above 1 every engine renders through
``parallel/tiles.py``: one contiguous row block of the pixels a tile,
``wavefront`` on one compacted driver a tile, the others on the fused
``trace_sample``; the scene's copies on the tiles' devices are dropped
at every update. A single-device fused frame runs its chunks through
the same loop, over a mesh of one copy of the engine's device a chunk.

The ``denoise`` setting runs the à-trous filter (``ops/denoise.py``) over
each finished frame, guided by the last sample's primary-hit normal and
depth planes, which the integrator builds only while the setting is on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.denoise import atrous_denoise
from ..ops.rng import blue_noise_stack
from ..ops.tonemap import resolve_accumulator
from ..parallel import tiles
from ..parallel.mesh import make_tile_mesh
from ..scene.lights import pack_lights
from ..scene.materials import MaterialList
from ..scene.mesh import TriangleSoA
from ..scene.skybox import Skybox
from ..utils import Timer, logger, tracing
from . import scene_data
from .context import (EngineContext, RenderSetting, RenderStatus,
                      register_engine, resolve_device)
from .intersectors import FACTORIES, make_intersector
from .wavefront_driver import WavefrontDriver

_TEX_SLOTS = {"diffuse": ("tex0_id",), "normal": ("tex1_id",),
              "rough": ("tex3_id",),
              "diffuse_layers": ("tex5_id", "tex6_id"),
              "normal_layers": ("tex7_id", "tex8_id")}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_wide(bvh: dict, n_tri: int, what: str) -> None:
    """A wide BVH's leaf ranges inside ``n_tri`` triangles and its child
    indices inside its nodes, else ValueError."""
    child = bvh["child"].cpu().numpy()
    count = bvh["count"].cpu().numpy()
    leaf = count > 0
    if leaf.any():
        firsts = child[leaf]
        if firsts.min() < 0 or (firsts + count[leaf]).max() > n_tri:
            raise ValueError(f"{what} leaf range out of bounds")
    internal = (count < 0) & (child >= 0)
    if internal.any() and child[internal].max() >= child.shape[0]:
        raise ValueError(f"{what} child index out of bounds")


class PathTracerEngine(EngineContext):
    """Scene bookkeeping, device upload, accumulation and stats."""

    default_intersector = "bvh"
    use_wavefront_driver = False

    def __init__(self, config: RenderConfig | None = None, *,
                 device="cuda"):
        super().__init__(config)
        self.device = resolve_device(device)
        self._meshes: dict[int, TriangleSoA] = {}
        self._instances: dict[int, tuple[int, np.ndarray]] = {}
        self._mesh_versions: dict[int, int] = {}
        self._materials: dict | None = None
        self._lights: dict | None = None
        self._light_overrides: dict = {}
        self._skybox: dict | None = None
        self._atlas: dict | None = None
        self._atlas_t: dict | None = None
        self._dirty = True
        self._scene: dict | None = None
        self._geo = None
        self._geo_key = None
        self._anim_key = None
        self._shape_caps: dict = {}
        # host caches of the last full build, for the refits: the
        # triangle order, the binary BVH and the shading pack
        self._perm_host: np.ndarray | None = None
        self._bvh_host = None
        self._pack_host: np.ndarray | None = None
        self._refits = 0
        # what a device update reads besides the transforms
        # (scene_data.move_tables), dropped by a build or a new mesh version
        self._move_tables: dict | None = None
        self._slot_planes_dev: dict = {}
        self._aux_dev: dict = {}
        self._accumulator: torch.Tensor | None = None
        self._sample_count = 0
        self._size = (0, 0)
        self._probe_result = (-1, -1, -1.0)
        self._step = None
        self._step_key = None
        self._driver: WavefrontDriver | None = None
        # the scene's copies on the tiles' devices (none for a tile on
        # the engine's own device), dropped on every update
        self._replicas: dict = {}
        self._pending = None
        self._intersector_name = self.default_intersector
        self._denoise = False

    # -- uploads -------------------------------------------------------------

    def set_mesh(self, slot: int, triangles: TriangleSoA) -> None:
        if self._meshes.get(slot) is not triangles:
            self._mesh_versions[slot] = self._mesh_versions.get(slot, 0) + 1
            self._move_tables = None
        self._meshes[slot] = triangles
        self._dirty = True

    def set_instance(self, instance_id: int, mesh_slot: int,
                     transform: np.ndarray) -> None:
        self._instances[instance_id] = (mesh_slot,
                                        np.asarray(transform, np.float32))
        self._dirty = True

    def remove_instance(self, instance_id: int) -> None:
        self._instances.pop(instance_id, None)
        self._dirty = True

    def set_materials(self, device_materials) -> None:
        self._materials = device_materials
        self._atlas_t = None      # mtex_id decides which atlas ships
        self._dirty = True

    def set_textures(self, atlas) -> None:
        """The texture atlas dict of ``scene.texture.build_atlases_cached``
        ({"atlas", "desc"}, with {"matlas", "matlas_desc"} when merged)."""
        self._atlas = atlas
        self._atlas_t = None
        self._dirty = True

    def set_lights(self, lights, overrides=None) -> None:
        self._lights = lights
        self._light_overrides = overrides or {}
        self._dirty = True

    def set_sky(self, pixels: np.ndarray) -> None:
        pixels = np.asarray(pixels, np.float32)
        self._skybox = {"pixels": pixels}
        if self.config.envmap_nee:
            self._skybox.update(Skybox(pixels).build_importance_tables())
            # radiance + pdf in one (H, W, 4) plane for bounce-depth MIS
            self._skybox["pixpdf"] = np.concatenate(
                [pixels, self._skybox["pdf"][..., None]], axis=-1)
        self._dirty = True

    # -- scene build ---------------------------------------------------------

    def _instance_list(self) -> list:
        instances = [
            scene_data.InstancedMesh(triangles=self._meshes[slot],
                                     transform=tr, instance_id=iid,
                                     mesh_slot=slot)
            for iid, (slot, tr) in sorted(self._instances.items())
            if slot in self._meshes]
        if not instances:   # implicit identity instance per mesh
            instances = [
                scene_data.InstancedMesh(
                    triangles=tris, transform=np.eye(4, dtype=np.float32),
                    instance_id=slot, mesh_slot=slot)
                for slot, tris in sorted(self._meshes.items())]
        return instances

    def _device_slot_planes(self, instances) -> dict:
        """The object-space planes of each mesh slot on the device, kept
        per mesh version: an instance move uploads nothing, a deformation
        only the slots whose mesh changed."""
        slot_planes = {}
        for im in instances:
            ver = self._mesh_versions.get(im.mesh_slot, 0)
            cached = self._slot_planes_dev.get(im.mesh_slot)
            if cached is None or cached[0] != ver:
                planes = {k: np.ascontiguousarray(getattr(im.triangles, k),
                                                  np.float32)
                          for k in scene_data.SLOT_PLANES}
                tracing.count("upload_bytes",
                              sum(a.nbytes for a in planes.values()))
                cached = (ver, {k: torch.from_numpy(a).to(self.device)
                                for k, a in planes.items()})
                self._slot_planes_dev[im.mesh_slot] = cached
            slot_planes[im.mesh_slot] = cached[1]
        return slot_planes

    def prewarm_instance_moves(self) -> None:
        """Run the device update once on the current scene and discard the
        result, so that the first interactive move finds its tables,
        device memory and planes in place. Engine state is unchanged; a
        no-op when a move would not take the device update."""
        if (self._dirty or self._geo_key is None
                or self._route(self._anim_key, self._geo_key[0]) != "device"):
            return
        self._device_update(self._instance_list())
        with tracing.span("sync.prewarm"):
            _sync(self.device)

    def _route(self, anim_key, structure_key) -> str:
        """How the geometry follows a change of the instances or meshes
        (see the module's table): "device" (``_device_update``), "host"
        (``_host_refit``) or "build". A move keeps ``structure_key``; a
        deformation keeps ``anim_key`` and bumps a mesh version. The host
        refit counts towards ``max_refits``, the device update does
        not."""
        geo, name = self._geo, self._intersector_name
        if geo is None or self._perm_host is None:
            return "build"
        if "tlas" in geo:
            # the device update keeps the BLASes, so only a move, and only
            # the tlas intersector reads the instance tables it refreshes
            moved = (name == "tlas" and self._geo_key is not None
                     and self._geo_key[0] == structure_key)
            return "device" if moved else "build"
        if (self._anim_key != anim_key
                or self._refits >= self.config.max_refits):
            return "build"
        if self.config.device_refit and name not in ("bvh", "tlas"):
            return "device"
        return "host" if self._bvh_host is not None else "build"

    def _device_update(self, instances) -> dict:
        """The scene after ``scene_data.move_instances_device``, over the
        move tables of this build and mesh versions (made here when
        ``set_mesh`` or a build dropped them). The host pack is kept: the
        host refit takes only its invariant columns (uv, material, lod,
        light index)."""
        if self._move_tables is None:
            self._move_tables = scene_data.move_tables(
                self._geo, instances, self._device_slot_planes(instances))
        return {**self._geo, **scene_data.move_instances_device(
            self._geo, self._move_tables, instances)}

    def _host_refit(self, instances) -> dict | None:
        """The scene after the host refit, or None when it cannot refit."""
        out = scene_data.refit_deformed(
            self._geo, instances, self._perm_host, self._bvh_host,
            self.config, self._shape_caps, pack_host=self._pack_host)
        if out is None:
            return None
        self._pack_host = out.pop("_pack_host", self._pack_host)
        self._refits += 1
        return scene_data.scene_to_torch(out, self.device)

    def _aux_tables(self) -> dict:
        """Materials, lights, sky and blue noise on the device, uploaded
        again only when the host object changed identity."""
        aux = {"materials": self._materials, "lights": self._lights}
        if self._skybox is not None:
            aux["skybox"] = self._skybox
        if self.config.blue_noise:
            aux["blue_noise"] = blue_noise_stack()
        out = {}
        for k, src in aux.items():
            ent = self._aux_dev.get(k)
            if ent is None or ent[0] is not src:
                ent = (src, scene_data.scene_to_torch({k: src},
                                                      self.device)[k])
                self._aux_dev[k] = ent
            out[k] = ent[1]
        return out

    def update(self) -> None:
        """Bring the device scene up to date. The geometry changes only
        when meshes, instances or light overrides did: a same-topology
        change (a deformed mesh, a moved instance) takes the path
        ``_route`` picks, anything else builds it in full. The small
        tables always follow the host objects."""
        if not self._dirty:
            return
        if not self._meshes:
            raise RuntimeError("no meshes uploaded")
        with tracing.span("engine.update"):
            self._replicas.clear()
            if self._lights is None:
                self._lights = pack_lights([], [], [], [])
            if self._materials is None:
                self._materials = MaterialList().generate_device_materials()
            instances = self._instance_list()
            overrides = tuple(sorted(self._light_overrides.items()))
            structure_key = (
                tuple((im.instance_id, im.mesh_slot,
                       self._mesh_versions.get(im.mesh_slot, 0))
                      for im in instances), overrides)
            geo_key = (structure_key,
                       tuple(im.transform.tobytes() for im in instances))
            # the structure without mesh versions, plus the triangle counts:
            # when it holds, a version bump is a deformation of one topology
            anim_key = (
                tuple((im.instance_id, im.mesh_slot) for im in instances),
                overrides,
                tuple(im.triangles.vertices.shape[0] for im in instances))
            if geo_key != self._geo_key:
                tracing.count("updates")
                route = self._route(anim_key, structure_key)
                geo = None
                if route == "device":
                    tracing.count("device_moves")
                    geo = self._device_update(instances)
                elif route == "host":
                    geo = self._host_refit(instances)
                if geo is None:
                    built = scene_data.build_device_scene_cached(
                        instances, None, None, None, None, self.config,
                        area_light_overrides=self._light_overrides,
                        shape_caps=self._shape_caps)
                    self._perm_host = built.pop("_perm_host")
                    self._bvh_host = built.pop("_bvh_host")
                    self._pack_host = built.pop("_pack_host")
                    for k in ("materials", "lights", "atlas", "atlas_desc"):
                        built.pop(k)
                    geo = scene_data.scene_to_torch(built, self.device)
                    self._refits = 0
                    self._move_tables = None
                self._geo = geo
                self._geo_key = geo_key
                self._anim_key = anim_key
            self._scene = {**self._geo, **self._textures(),
                           **self._aux_tables()}
            self._dirty = False
            # scene changed: restart accumulation (a CONVERGE frame must not
            # divide the old scene's radiance by the restarted count)
            self._sample_count = 0
            self._accumulator = None

    def _textures(self) -> dict:
        """The atlas tables on the device, uploaded once per
        ``set_textures``. The merged atlas (``matlas``) is read only
        through the per-material ``mtex_id`` table: with it, every fetch
        reads the merged atlas and the flat one ships as a 1-texel stub;
        without it, the merged atlas is dropped so that shading reads the
        real flat atlas (a stub beside real descriptors would fetch
        garbage)."""
        if self._atlas is None:
            return {"atlas": None, "atlas_desc": None}
        if self._atlas_t is None:
            a = self._atlas
            t = {"atlas": a["atlas"], "atlas_desc": a["desc"]}
            if a.get("matlas") is not None:
                if "mtex_id" in (self._materials or {}):
                    t.update(atlas=np.ones((1, 4), np.float32),
                             matlas=a["matlas"],
                             matlas_desc=a["matlas_desc"])
            self._atlas_t = scene_data.scene_to_torch(t, self.device)
        return self._atlas_t

    # -- render --------------------------------------------------------------

    def _tex_flags(self) -> dict:
        mats = self._materials or {}
        return {flag: bool(any(np.any(np.asarray(mats.get(k, [-1])) >= 0)
                               for k in keys))
                for flag, keys in _TEX_SLOTS.items()}

    def _integrator_config(self) -> RenderConfig:
        return self.config

    def _get_step(self, width: int, height: int):
        tex_flags = self._tex_flags()
        key = (width, height, tuple(sorted(tex_flags.items())),
               self._intersector_name)
        if self._step is not None and self._step_key == key:
            return self._step
        cfg = self._integrator_config()
        intersector = make_intersector(self._intersector_name, cfg)
        n_total = width * height
        self._driver = None
        if cfg.n_devices and cfg.n_devices > 1:
            # tiles: each device traces a contiguous row block, on the
            # compacted driver where this engine uses it
            mesh = make_tile_mesh(cfg.n_devices, self.device)
            make = (tiles.make_driver_engine_step
                    if self.use_wavefront_driver and cfg.compaction
                    else tiles.make_engine_step)
            step = make(mesh, width, height, cfg, intersector, tex_flags,
                        replicas=self._replicas)
        else:
            # equal chunks of at most max_rays_per_pass lanes
            n_chunks = tiles.chunk_count(n_total, cfg.max_rays_per_pass,
                                         height)
            if self.use_wavefront_driver and cfg.compaction and n_chunks > 1:
                self._driver = WavefrontDriver(
                    width, height, cfg, intersector, tex_flags,
                    n_total // n_chunks, self.device)
                step = self._driver.step
            else:
                step = tiles.make_engine_step(
                    (self.device,) * n_chunks, width, height, cfg,
                    intersector, tex_flags, replicas=self._replicas)
        self._step, self._step_key = step, key
        return step

    def render_frame_async(self, view,
                           status: RenderStatus = RenderStatus.RESET,
                           samples: int = 1) -> None:
        """Enqueue ``samples`` samples per pixel; ``finish_frame()`` waits
        for the device and returns the frame. ``view`` is the camera
        view's dict (``Camera.get_view().as_pytree()``) after
        ``resize(w, h)``."""
        if self._pending is not None:
            raise RuntimeError("render_frame_async while a frame is in "
                               "flight; call finish_frame() first")
        with tracing.span("engine.render"):
            width, height = self._size
            if width <= 0:
                raise RuntimeError("call resize(w, h) first")
            self.update()
            step = self._get_step(width, height)
            n = width * height
            if (status == RenderStatus.RESET or self._accumulator is None
                    or self._accumulator.shape[0] != n):
                self._accumulator = torch.zeros((n, 3), device=self.device)
                self._sample_count = 0
            # host-to-device copies, each of which waits for the device
            with tracing.span("sync.view"):
                view_t = {k: torch.as_tensor(np.asarray(v, np.float32),
                                             device=self.device)
                          for k, v in view.items()}
            probe_index = self._probe_xy[1] * width + self._probe_xy[0]
            timer = Timer()
            drv = self._driver
            profiled = (drv is not None and samples > 1
                        and self.config.profile_stages)
            if profiled:
                # the last sample runs with a sync per depth, which fills the
                # per-stage times of RenderStats; the frame is the same
                acc, _, _, _ = drv.step_multi(
                    self._scene, self._accumulator, view_t, self._sample_count,
                    probe_index, samples - 1, with_aux=False)
                acc, probe, stats, aux = drv.step_profiled(
                    self._scene, acc, view_t, self._sample_count + samples - 1,
                    probe_index, with_aux=self._denoise)
            elif drv is not None:
                acc, probe, stats, aux = drv.step_multi(
                    self._scene, self._accumulator, view_t, self._sample_count,
                    probe_index, samples, with_aux=self._denoise)
            else:
                # the denoiser's guide planes: the last sample's, and only
                # when it runs
                acc = self._accumulator
                for s in range(samples):
                    acc, probe, stats, aux = step(
                        self._scene, acc, view_t, self._sample_count + s,
                        probe_index,
                        with_aux=self._denoise and s == samples - 1)
            self._accumulator = acc
            self._sample_count += samples
            tracing.count("samples", samples)
            # the frame keeps its own accumulator and count: a scene update
            # while it is in flight restarts the accumulation for the next
            # frame, not this one
            self._pending = (probe, stats, aux, timer, profiled, acc,
                             self._sample_count)

    def finish_frame(self) -> np.ndarray:
        """Wait for the dispatched frame, fill stats, return resolved HDR
        (H, W, 3) as numpy, denoised under the ``denoise`` setting (the
        last sample's primary-hit normal and depth planes guide it)."""
        if self._pending is None:
            raise RuntimeError("finish_frame without a frame in flight")
        probe, stats, aux, timer, profiled, acc, count = self._pending
        self._pending = None
        with tracing.span("engine.finish_frame"):
            with tracing.span("sync.finish"):
                _sync(self.device)
            elapsed = timer.elapsed()
            keys = sorted(stats)
            flat = torch.cat([torch.stack([torch.as_tensor(
                stats[k], device=self.device).double() for k in keys]),
                probe.double()])
            with tracing.span("sync.stats"):
                flat = flat.cpu().numpy()
            s = {k: int(flat[i]) for i, k in enumerate(keys)}
            self.stats.primary_count = s.get("ray_count_0", 0)
            self.stats.secondary_count = s.get("ray_count_1", 0)
            self.stats.deep_count = sum(
                v for k, v in s.items()
                if k.startswith("ray_count_") and int(k.split("_")[-1]) >= 2)
            self.stats.shadow_count = sum(
                v for k, v in s.items() if k.startswith("shadow_count_"))
            self.stats.render_time = elapsed
            if profiled:
                dt = self._driver.depth_times
                self.stats.primary_time = dt[0]
                self.stats.secondary_time = dt[1] if len(dt) > 1 else 0.0
                self.stats.deep_time = sum(dt[2:])
            nan_ct = sum(v for k, v in s.items()
                         if k.startswith("nan_scrubbed"))
            if nan_ct:
                logger.warning("debug_checks: %d NaN contributions scrubbed "
                               "this frame", nan_ct)
            p = flat[len(keys):]
            self._probe_result = (int(p[0]), int(p[1]), float(p[2]))
            width, height = self._size
            frame = resolve_accumulator(acc, count)
            frame = frame.reshape(height, width, 3)
            if self._denoise and aux is not None:
                if self._driver is not None:
                    # the compacted driver keeps aux in its lanes' order
                    aux = self._driver.aux_inverse(aux)
                frame = atrous_denoise(
                    frame, aux["normal"].reshape(height, width, 3),
                    aux["depth"].reshape(height, width))
            with tracing.span("sync.frame"):
                return frame.cpu().numpy()

    def get_render_state(self):
        """(accumulator (N, 3) float32 numpy, sample count), or None
        before the first frame."""
        if self._accumulator is None:
            return None
        return self._accumulator.cpu().numpy(), int(self._sample_count)

    def set_render_state(self, accumulator, sample_count: int) -> None:
        """Resume from ``get_render_state``'s pair at the current size;
        the next CONVERGE frame adds to it."""
        acc = np.asarray(accumulator, np.float32)
        w, h = self._size
        if acc.shape != (w * h, 3):
            raise ValueError(f"accumulator {acc.shape} does not match "
                             f"{w}x{h}")
        self._accumulator = torch.from_numpy(acc.copy()).to(self.device)
        self._sample_count = int(sample_count)

    def resize(self, width: int, height: int) -> None:
        if (width, height) != self._size:
            self._size = (width, height)
            self._step = None
            self._accumulator = None

    def get_probe_results(self):
        return self._probe_result

    def validate(self) -> None:
        """Scene invariants: finite geometry, material ids in range, the
        wide BVH's leaf ranges and child indices in bounds, and those of
        every BLAS of the TLAS tables, with their instances' triangles
        inside the flattened planes."""
        self.update()
        s = self._scene
        verts = s["tri_vertices"].cpu().numpy()
        if not np.isfinite(verts).all():
            raise ValueError("non-finite triangle vertices")
        n_mat = s["materials"]["color"].shape[0]
        mats = s["tri_material"].cpu().numpy()
        if mats.min() < 0 or mats.max() >= n_mat:
            raise ValueError(
                f"material id out of range: [{mats.min()}, {mats.max()}] "
                f"vs {n_mat} materials")
        _check_wide(s["bvh"], verts.shape[0], "BVH")
        if "tlas" in s:
            n_flat = s["tlas"]["orig_to_perm"].shape[0]
            for i, b in enumerate(s["tlas"]["blas"]):
                n_tri = b["prim_order"].shape[0]
                _check_wide(b, n_tri, f"BLAS {i}")
                if int(b["inst_base"].max()) + n_tri > n_flat:
                    raise ValueError(f"BLAS {i}: instance triangles past "
                                     f"the {n_flat} flattened triangles")

    # -- settings ------------------------------------------------------------

    def get_available_settings(self):
        return [RenderSetting("intersector", self._intersector_name,
                              sorted(FACTORIES)),
                RenderSetting("denoise", "1" if self._denoise else "0",
                              ["0", "1"])]

    def set_setting(self, name: str, value: str) -> None:
        super().set_setting(name, value)
        if name == "intersector":
            make_intersector(value, self.config)   # raises on a bad name
            if value != self._intersector_name:
                # intersectors may read different tables: a switch
                # updates the geometry, not only the small tables
                self._geo_key = None
                self._dirty = True
            # the child-cell tables of tvisit and the two-level tables of
            # tlas are opt-in; selecting the intersector implies them
            # (the config is frozen, as in the reference). Adding tables
            # takes a full build: a refit of the scene without them would
            # keep it without them
            flag = {"tvisit": "subcell_tables", "tlas": "use_tlas"}.get(value)
            if flag is not None and not getattr(self.config, flag):
                object.__setattr__(self.config, flag, True)
                self._geo_key = None
                self._anim_key = None
                self._dirty = True
            self._intersector_name = value
            self._step = None
        elif name == "denoise":
            self._denoise = value in ("1", "true", "True")


@register_engine("bruteforce")
class BruteForceEngine(PathTracerEngine):
    """The exact O(R·T) tracer: the oracle for tiny scenes."""

    default_intersector = "brute"


@register_engine("megakernel")
class MegakernelEngine(PathTracerEngine):
    """The fused path tracer on the wide-BVH traversal kernel (the
    inherited ``bvh`` intersector)."""


@register_engine("wavefront")
class WavefrontEngine(PathTracerEngine):
    """The compacted wavefront driver over the visit-list intersector."""

    default_intersector = "visit"
    use_wavefront_driver = True


@register_engine("direct")
class DirectEngine(PathTracerEngine):
    """Primary rays and next-event estimation only: direct light, no
    bounces."""

    def _integrator_config(self) -> RenderConfig:
        return dataclasses.replace(self.config, max_path_length=0,
                                   russian_roulette=False)
