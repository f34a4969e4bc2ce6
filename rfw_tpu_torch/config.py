"""Render configuration.

The reference splits configuration into compile-time defines
(rendering-fw/RFW/system/context/rfw/context/settings.h:1-18) and a runtime
string key/value protocol (context/context.h:36-48). Here both tiers live in one
dataclass; engines additionally expose the queryable runtime-settings protocol
(see render/context.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The settings an engine reads. Frozen, as the reference's compiled
    settings are; selecting the ``tvisit`` or ``tlas`` intersector turns
    on the tables it needs (``subcell_tables``, ``use_tlas``) in place."""

    # Path tracing (reference settings.h:3-8, CUDART/Context.cpp:50-51)
    max_path_length: int = 2          # MAX_PATH_LENGTH: the last depth
    min_roughness: float = 0.01       # MIN_ROUGHNESS: below it, specular
    importance_sample_lights: bool = True   # IS_LIGHTS: pick lights by power
    variance_reduction: bool = True   # VARIANCE_REDUCTION (NEE + MIS)
    firefly_clamp: float = 10.0       # clampValue (CUDART/Context.cpp:51)
    geometry_epsilon: float = 1e-5    # geometryEpsilon: ray origin offset
    t_epsilon: float = 1e-4           # T_EPSILON triangle-test epsilon
    russian_roulette: bool = True     # RR survival (Kernels.cu:783)

    # Sampling: the blue-noise mask below blue_noise_spp_cutoff samples,
    # hashed random numbers from there on
    blue_noise: bool = True           # BLUENOISE
    blue_noise_spp_cutoff: int = 256

    # Envmap next-event estimation with MIS, from the sky's importance
    # tables (the reference declares but never fills them, skybox.h:37-39)
    envmap_nee: bool = True
    # deepest path vertex that shoots an envmap NEE ray; -1 = every vertex.
    # BSDF sampling with MIS still collects sky light at deeper vertices
    envmap_nee_max_depth: int = 0
    # lanes sharing one envmap NEE sample (interleaved sampling, Keller &
    # Heidrich): 256 = one direction per 16x16 pixel tile, so the envmap
    # shadow rays of a tile travel together. Unbiased; 0/1 = a sample a lane
    env_nee_interleave: int = 256
    # one RGBA8 atlas holding each material's diffuse, normal and
    # roughness maps, so that a stochastic fetch reads one texel for all
    # three (RenderSystem builds it; False keeps one atlas a map)
    merged_material_atlas: bool = True
    # build the two-level TLAS/BLAS tables of the 'tlas' intersector (one
    # object-space BLAS a mesh slot, instance tables): under 'tlas' an
    # instance move refreshes the instance tables alone, on the device
    use_tlas: bool = False
    # same-topology updates (deformations, instance moves) of a scene
    # without TLAS tables take the device update
    # (scene_data.move_instances_device) unless the intersector is 'bvh';
    # False takes the host refit (scene_data.refit_deformed). Not read
    # under 'tlas', whose moves always take the device update
    device_refit: bool = True
    # host refits (which keep the cells and BVH topology while the
    # geometry drifts) before a full build; the device update re-cells
    # every time and does not count. 0 = a full build for every change
    # that would take the host refit, and for every device update of a
    # scene without TLAS tables
    max_refits: int = 64
    # texture filtering: "stochastic" (one tap a map whose expectation is
    # the 8-tap trilinear filter: mip level and bilinear corner drawn with
    # their filter weights; unbiased), "trilinear" (8 taps a map, the
    # reference's filter), "bilinear" (nearest mip, 4 taps), "nearest"
    texture_filter: str = "stochastic"

    # Animation: False makes RenderSystem.set_animations_to a no-op
    animation_enabled: bool = True

    # Debug: count the NaN contributions the NEE and emission guards zero
    # into each depth's "nan_scrubbed" stat and warn once a frame
    debug_checks: bool = False

    # BSDF model (reference bsdf/bsdf.h:19-22: disney active; lambert,
    # microfacet and microsurface selectable). The NEE kernel serves disney
    bsdf: str = "disney"

    # Engine knobs (no reference analog)
    # row-block tiles of the frame (parallel/tiles.py), one a device of
    # make_tile_mesh; 0/1 = one device
    n_devices: int = 0
    # the wavefront engine's compacted loop: live paths packed to the
    # front between depths (a frame of one chunk runs fused either way)
    compaction: bool = True
    max_rays_per_pass: int = 1 << 19  # lanes a chunk: bounds device memory
    treelet_size: int = 128           # triangles a visit cell
    treelet_spatial: bool = True      # cells cut by centroid (kd) splits;
    #                                   False: SAH-subtree ranges
    # the K/4-triangle child cells of the 'tvisit' intersector (each
    # cell's slots reordered into spatial quarters). Selecting 'tvisit'
    # implies them. On one H100, on the 2.18 M-triangle SPD mount at 1080p
    # and path length 8, tvisit took 1,251-1,284 ms a sample against
    # visit's 2,259-2,315, for 1.19 GiB more device memory (PERF.md §6)
    subcell_tables: bool = False
    # visit-list granule: "cell" (one K-triangle cell a visit) or "super"
    # (SUPER_G cells a visit). See ops/visit_intersect.py
    visit_granularity: str = "cell"
    # fill RenderStats' per-depth times: the wavefront engine runs the
    # last sample of a frame with a sync after each stage (same frame)
    profile_stages: bool = False


DEFAULT_CONFIG = RenderConfig()
