#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's main paths (rfw_tpu_torch).

    python3 chip_smoke.py [--png PATH] [--profile]

Needs one CUDA card; imports no JAX. Phases, one or more lines each:

1. the card: name and power limit as nvidia-smi reports them;
2. builds both native libraries ahead of time with ``python -m
   rfw_tpu_torch.native.build`` (the BVH builder with g++, the CUDA
   kernels from csrc/ with one nvcc per source, in parallel), printing
   its commands, paths and build seconds; then cuda_lib.load() must find
   the library and build nothing (its time is the dlopen), and each
   kernel's registers, shared memory, stack frame and spills as ptxas
   reported them are printed (a spill fails the run; the 64-entry stack
   of the traversal and of the tlas walk is a stack frame);
3. holds each kernel against its plain PyTorch version on the main
   path's own 1080p streams (a primary chunk and a bounce chunk of
   518,400 lanes each): enum must be equal, visit and tvisit (built with
   --fmad=false) equal in t and slot; prints kernel and plain times
   (CUDA events around one launch, median of 5; tvisit's plain version
   median of 3), each kernel's device time (20 launches queued behind a
   device-side wait, median of 5: one launch between two events also
   counts the wrapper's host work where that is longer), each
   kernel's bound (the larger of its FLOP at the card's FP32 peak and its
   bytes at the memory rate, counted from this run's inputs: the visits
   the exit rule walked, the real cells, the live lanes) and the
   walked-visit distribution per block; then enum and visit once more
   at visit_granularity="super" on the bounce chunk, equal too. The
   tvisit half runs after phase 5, once the same RenderSystem has been
   switched to the tvisit intersector (set_setting, which rebuilds the
   scene with the child-cell tables): the quantisation step diag/qmax of
   both key tables against numpy's IEEE quotient; the expansion kernel's
   registers, shared memory, spills and resident blocks per SM; the
   kernel against expand_children_ref (cids, counts and tnears equal) on
   pass 0 and pass 1 of the primary, bounce and depth-0 shadow streams
   and on made-up windows on the bounce rays (every parent real, invalid
   parents interleaved, one live lane a sub-block, dead and NaN t_hi
   blocks, a ray whose far-point box entry lies below its t_hi), with
   each window's mean real child slots and live lanes a block and its
   device time (rfw_tpu_torch/tools/expand_times.py times an earlier
   checkout's kernel against this one on the same windows); then on
   pass 0's parent window of each chunk the expansion, and tvisit
   against tvisit_ref on the kernel's own lists (t and slot equal,
   closest and any-hit), timed and bounded as above. The traversal
   kernel is held to traverse_wide_ref bit for bit (t, prim, u and v),
   closest and any hit: first on edge batches (the comb BVH, whose walks
   overflow the 64-entry stack; axis-parallel rays, zero direction
   components and zero directions; dead and NaN t_max lanes in every
   warp; n = 0, 1, 33, one above a block of the kernel and one above 512
   blocks), then on the same two
   chunks and on the depth-0 fused shadow launch (2 lanes a ray, any
   hit), timed as the others (the plain version once) and bounded by the
   node visits and
   triangle tests the plain version counts on that stream over its live
   lanes (t_max > eps) and by the bytes each lane needs (a live lane's
   ray in, a dead lane's t_max in, every lane's hit out), with the
   longest walk and the share of the visits a walk of every lane spent
   on the dead ones. The two tlas kernels are held, timed and bounded
   the same way in phase 10, on the instanced slice's streams;
4. renders the config-2 Cornell scene and the config-3 scene
   (microfacet BSDF, a checker-textured floor through the merged
   material atlas, envmap importance sampling; 64², 8 spp, compacted
   driver) on the card through the visit and the tvisit intersectors and
   holds them to tests/golden/config{2,3}_64_8spp.npy (RMSE < 2e-3, the
   golden matrix's bar); then the Cornell scene (tests/test_golden.py),
   config 2 and config 3 through megakernel (fused chunks, the bvh
   traversal kernel) against their goldens, and bruteforce against
   megakernel on the Cornell scene (32², 4 spp, RMSE < 2e-3);
5. the visit slice at full size: RenderSystem("wavefront") at 1920x1080
   on a generated ~317k-triangle scene loaded through add_object (PLY,
   with texture coordinates that no untextured material reads), one
   warm-up sample, then 3 CONVERGE windows of 4 samples; kernel launch
   counters are reset just before the windows and must grow (the NEE's
   two kernels too); then one profile_stages frame gives the per-depth
   split; then (phase 5b, ``phase_nee``) the NEE kernel bit for bit
   against ``ops/nee.py::nee_plain`` on the slice's own depth-0 and
   bounce lanes of chunk 0 and on ``synthetic.nee_case``'s made-up lanes
   (all four light types, both picks, glass, the hashed pair, the envmap
   per lane, planted NaNs under debug_checks), one launch, its device
   time, its bytes bound and the plain version's time, and the same for
   the second kernel, ``add_unoccluded``; then (phase 5c,
   ``phase_extend``) the BSDF extension kernel bit for bit against
   ``ops/extension.py::extend_plain`` on the slice's own depth-0 and
   bounce lanes of chunk 0 and on ``synthetic.extend_case``'s made-up
   lanes (a depth-0 chunk in tile order and a scattered bounce chunk;
   glass, metallic, subsurface, back-face, alpha-cut, dead and NaN
   lanes; Russian roulette on and off), its ptxas line, one launch, its
   device time beside its bytes bound, and the plain version's time;
6. the tvisit slice: the same scene, camera and samples after the
   switch; the expand, tvisit, visit and enum counters must all grow,
   and the frame must lie within RMSE 2e-3 of phase 5's;
7. the textured slice: the same geometry on a new RenderSystem with the
   microfacet BSDF, eight sphere materials and one room material each
   binding 1024² diffuse, normal and metallic-roughness maps made from
   SEED, shaded through the merged material atlas (its bytes printed)
   with one stochastic texel a hit; timed as phase 5, with its build
   times, its per-depth split, a finite non-black frame, and enum and
   visit launched;
8. config 4's path, deformation and instance moves: a new RenderSystem
   on the untextured slice plus a skinned glTF tube of 65,536 triangles
   (written from SEED), built at t = 0; then 8 deformation frames
   (set_animations_to, synchronize, one CONVERGE sample at 1080p) and 8
   moves of the spheres' instance, each update timed (host part, device
   refit by CUDA events) and none allowed to run a full build or to
   take as long as the build; one more deformation update under the
   profiler; the final state against a fresh build of it (4 spp, RMSE <
   2e-3); then one deformation frame through tvisit, which must launch
   expand and tvisit; then the system switched to the bvh intersector
   and one deformation update, which must take the host refit (no full
   build), its frame (2 spp) within RMSE 2e-3 of a fresh build's;
9. the megakernel slice: RenderSystem("megakernel") on phase 5's scene,
   camera and samples, timed as phase 5; the traverse counter must grow
   and enum and visit stay 0, and the frame must lie within RMSE 2e-3 of
   phase 5's; then the same scene, camera and samples through
   RenderSystem("wavefront") on the bvh intersector (the compacted
   driver over the traversal kernel), timed as phase 5, which must
   launch traverse and no visit-list kernel and lie within RMSE 2e-3 of
   the megakernel frame; then BASELINE config 1, RenderSystem("direct")
   on the Cornell scene at 512², 1 spp (median of 5 frames), finite,
   non-black and darker than megakernel's frame of the same scene and
   samples;
10. the instanced slice on the tlas intersector: phase 5's world
   geometry with the spheres as 60 instances of one icosphere PLY (3
   BLASes under 62 instances) on one RenderSystem("wavefront"), 4 spp
   through bvh, then the switch to tlas (a full build with the BLASes,
   timed) and 4 spp, within RMSE 2e-3 of the bvh frame; on the chunk-0
   streams (primary and bounce closest hit, shadow any hit) the tlas
   intersector's two kernels held bit for bit on every BLAS group,
   tlas_premask_kernel against premask_ref (cross, tn_min, and its list
   of walking lanes as a sorted set) and tlas_walk_kernel against
   walk_group_ref (t, orig, u, v), the list's length beside the lanes
   the plain walk walked (the same set), the spheres' BLAS with culled
   and live lanes in the bounce and the shadow stream, each kernel's
   ptxas line and resident blocks per SM, every launch's device time,
   and the bounce chunk's launches timed (one launch) beside their
   plain versions and bounds (the walk's also beside the bound of its
   walks alone); then the same on made-up inputs from the spheres'
   bounce launch (utils/synthetic.py::tlas_cases: dead lanes inside a
   box, every lane live, no lane crossing, coincident instances in
   closest and any hit); one closest
   and one occluded call under torch.cuda.set_sync_debug_mode("error")
   (no host read); its hits against the bvh intersector's (at most 2e-5
   of a stream's lanes apart, relative t < 1e-4); the tlas slice timed
   as phase 5 (the two tlas kernels must launch, traverse and the
   visit-list kernels not), its per-depth split, the tlas launches a
   sample and, from one more sample, the touched instances per
   intersector call (its walk launches' counts, read after the frame;
   one premask and one walk launch a BLAS group and call); a 1-spp frame
   raw and denoised against the slice's converged frame (the denoised
   one must be closer; the denoise timed between CUDA events), FXAA
   (finite, in [0, 1], timed); then 8 moves of one sphere, each update
   timed, none a full build, each one device move and one launch of the
   re-transform kernel, and the moved frame within RMSE 2e-3 of a fresh
   tlas build; then (``phase_retransform``) the re-transform kernel on
   made-up inputs at the benchmark sphereflake's layout
   (utils/synthetic.py::retransform_case, 1,049,608 triangles) bit for
   bit against retransform_ref, its ptxas line, one launch and its
   device time beside its bytes bound;
11. the raster preview, tiles, the App and the live viewer: (a)
   RenderSystem("raster") on phase 5's scene and camera, median of 5
   synced 1080p frames and their peak memory (traverse must launch,
   enum and visit not), two frames equal bit for bit, the async
   CONVERGE and samples=2 frames equal to the sync RESET frame, finite
   and lit, and one frame's traverse launches (one a chunk) bit for bit
   against traverse_wide_ref on their tensors; then the Cornell
   scene at 64², the card's raster frame within RMSE 2e-3 of the CPU's;
   (b) BASELINE config 5's path on one card: phase 5's scene through
   wavefront with n_devices=4 (four tiles round-robin on cuda:0, one
   compacted driver a tile) against n_devices=0, RESET plus 4 spp within
   1e-5 (printed whether bit for bit), the primary ray count and the
   probe equal, enum and visit launched; tile 1's depth-1 enum launch
   and visit launches (closest, any hit) bit for bit against their
   plain versions on their tensors; both timed as phase 5; then
   megakernel with n_devices=4 against n_devices=0, 2 spp, the same
   checks with traverse; (c) an App on phase 5's scene at 1080p on
   wavefront, 3 frames of 2 spp with an orbit-and-brightness update,
   pipelined and sequential frames equal bit for bit (wall ms a frame
   of each), then an update raising ValueError surfaces as itself with
   no frame left in flight, and the next run works; PNGs to a
   temporary directory; (d) the LiveViewer on 127.0.0.1 at 512² on
   megakernel (Cornell, 20 frames, in a thread): the frame is a PNG of
   that size, a keys POST moves the camera and restarts the
   accumulation, a material POST lands, a probe POST gives a probe, and
   /stats has rfw_tpu's keys;
12. the five examples of rfw_tpu_torch/examples/ through their main(argv)
   at their rfw_tpu counterparts' default sizes: cornell (256², 16 spp),
   textured_env (256², 32 spp), instances (6 frames of 160², 4 spp, the
   flattened scene and --tlas), animation (8 frames of 160², 4 spp, the
   skinned tube) and viewer (256², --duration 3 on a free port, one
   frame fetched over HTTP): each exits 0, writes its PNGs and launches
   the kernels of its engine and intersector and no other (traverse on
   megakernel, the two tlas kernels and, for its moves, the
   re-transform under --tlas, enum and visit on the viewer's
   wavefront; the extension kernel wherever the Disney BSDF shades),
   and of each
   kernel its launch with the most live lanes is held bit for bit to its
   plain version; then the example's Cornell at 64², 8 spp on
   megakernel, card against CPU (RMSE < 2e-3);
13. the port's bench: ``python3 bench_torch.py`` at its defaults in a
   process of its own (timeout 600 s), as a user runs it: the pica-4x
   stand-in (phase 5's scene) at 1080p on wavefront, 3 CONVERGE windows
   of 4 samples; it must exit 0 and print a last line with the bench's
   keys, a finite positive Mrays/s, 1920x1080 primary rays a sample, 3
   windows and enum and visit launched in its timed windows; the line
   is printed beside the card's name and power limit.

Every scene is built cold (RFW_NO_SCENE_CACHE, RFW_NO_TEX_CACHE). Any
failure raises (non-zero exit, no result). The last four lines are
phase 8's launches per deformation frame, the kernel table as JSON
(eleven kernels; its launches from phases 5, 6, 9, 10, 11, 12 and 13,
the NEE's two from phase 5's windows, and split by phase in
``launches_by_phase``; ``ms`` one launch between two
events, ``device_ms`` the device time), the card's name and power
limit, and the run's JSON result.

To compare two trees on one card, run this script from an unpacked
``git archive`` of each, one after the other, in one chip command.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from rfw_tpu_torch.utils import synthetic
from rfw_tpu_torch.utils.synthetic import SEED, build_slice_scene

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"enum": "rfw_tpu_torch/csrc/visit_kernels.cu",
           "visit": "rfw_tpu_torch/csrc/visit_kernels.cu",
           "expand": "rfw_tpu_torch/csrc/expand_kernel.cu",
           "tvisit": "rfw_tpu_torch/csrc/tvisit_kernel.cu",
           "traverse": "rfw_tpu_torch/csrc/traverse_kernel.cu",
           "tlas_premask": "rfw_tpu_torch/csrc/tlas_kernel.cu",
           "tlas_walk": "rfw_tpu_torch/csrc/tlas_kernel.cu",
           "retransform": "rfw_tpu_torch/csrc/retransform_kernel.cu",
           "extend": "rfw_tpu_torch/csrc/extend_kernel.cu"}
# expand, traverse and the two tlas kernels replace XLA steps, not Pallas
# kernels; retransform a numpy step on the host; extend the XLA-fused
# BSDF extension of rfw_tpu's depth stage
REPLACES = {"enum": "rfw_tpu/ops/visit_intersect.py:94",
            "visit": "rfw_tpu/ops/visit_intersect.py:303",
            "expand": "rfw_tpu/ops/tvisit_intersect.py:89",
            "tvisit": "rfw_tpu/ops/tvisit_intersect.py:186",
            "traverse": "rfw_tpu/ops/traverse.py:58",
            "tlas_premask": "rfw_tpu/render/intersectors.py:201",
            "tlas_walk": "rfw_tpu/render/intersectors.py:201",
            "retransform": "rfw_tpu/render/scene_data.py:982",
            "extend": "rfw_tpu/render/integrator.py:637"}
KERNELS = tuple(SOURCES)
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense)
PEAK_FP32 = 67e12          # FLOP/s, an FMA counted as two
PEAK_BYTES = 3.35e12       # bytes/s of HBM
# FP32 operations per unit of work, counted from the kernels' source
FLOP_PER_TEST = 39         # one Woop (ray, triangle) test
FLOP_PER_SLAB = 28         # one (ray, cell) slab test
FLOP_PER_BOX = 25          # one (ray, child box) test of the traversal
FLOP_PER_MT = 53           # one Möller–Trumbore (ray, triangle) test
FLOP_PER_XFORM = 33        # one ray into object space (18 + 15)
TRAVERSE_THREADS = 128     # traverse_kernel.cu's block, kTraverseThreads


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

N_SPHERE_MATERIALS = 8


def build_instanced_scene(rs, workdir: str):
    """Phase 10's scene: ``build_slice_scene``'s world geometry with the
    spheres as 60 instances of one level-4 icosphere, written once as a
    PLY and loaded with add_object, each placed by ``add_instance``
    (scale r, translation c, as ``sphere_placements`` draws them), so
    the TLAS holds 3 BLASes (sphere, room, lamp) under 62 instances.
    Returns (triangle count, the spheres' InstanceRefs)."""
    sv, sf = synthetic.icosphere(4)
    path = os.path.join(workdir, "sphere.ply")
    synthetic.write_ply(path, sv, sv, sf, synthetic.sphere_uv(sv))
    (sphere_m,), room_m = synthetic.slice_materials_plain(rs)
    ref = rs.add_object(path, material_override=sphere_m)
    spheres = [rs.add_instance(ref, scale=(r, r, r), translation=c)
               for r, c in synthetic.sphere_placements()]
    return (len(spheres) * len(sf)
            + synthetic.add_room(rs, workdir, room_m)), spheres


def slice_materials(rs, size: int = 1024):
    """Eight sphere materials and one room material, each binding a
    diffuse, a tangent-space normal and a metallic-roughness map of
    ``size``² made from SEED (texel noise: every fetch lands on its own
    texel). Returns (sphere material ids, room material id)."""
    from rfw_tpu_torch.scene import HostMaterial, Texture
    rng = np.random.default_rng(SEED + 1)

    def textured(tint, roughness, metallic):
        diffuse = (0.5 * np.asarray(tint, np.float32)
                   + 0.5 * rng.random((size, size, 3), np.float32))
        tilt = rng.normal(0.0, 0.25, (size, size, 2)).astype(np.float32)
        nrm = np.concatenate([tilt, np.ones((size, size, 1), np.float32)], -1)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        mr = np.stack([np.zeros((size, size), np.float32),
                       rng.uniform(0.2, 1.0, (size, size)).astype(np.float32),
                       rng.random((size, size), np.float32)], -1)
        mat = HostMaterial(roughness=roughness, metallic=metallic)
        for slot, img in ((0, diffuse), (1, 0.5 * nrm + 0.5), (3, mr)):
            mat.maps[slot].texture_id = rs.materials.add_texture(
                Texture.from_array(img))
        return rs.materials.add(mat)

    spheres = [textured(rng.uniform(0.2, 0.9, 3), 0.35, 0.6)
               for _ in range(N_SPHERE_MATERIALS)]
    return spheres, textured([0.6, 0.62, 0.65], 0.8, 0.2)


def make_cornell(rs, size: int = 64):
    """tests/test_integrator.py::make_cornell's scene (the Cornell golden's
    and BASELINE config 1's), through the port."""
    white = rs.add_material([0.73] * 3)
    red = rs.add_material([0.63, 0.065, 0.05])
    green = rs.add_material([0.14, 0.45, 0.091])
    lamp_m = rs.add_material([20.0] * 3)
    for (n, p, w, h, m) in [
        ([0, 1, 0], [0, 0, 0], 5.56, 5.56, white),
        ([0, -1, 0], [0, 5.48, 0], 5.56, 5.56, white),
        ([0, 0, -1], [0, 2.74, 2.796], 5.56, 5.48, white),
        ([1, 0, 0], [-2.78, 2.74, 0], 5.48, 5.56, red),
        ([-1, 0, 0], [2.78, 2.74, 0], 5.48, 5.56, green),
        ([0, -1, 0], [0, 5.47, 0], 1.3, 1.05, lamp_m),
    ]:
        rs.add_instance(rs.add_quad(n, p, w, h, m))
    rs.camera.resize(size, size)
    rs.camera.fov = 40.0
    rs.camera.look_at([0, 2.73, -8.0], [0, 2.73, 0])
    return rs


def make_config2(rs):
    """tests/golden_scenes.py::make_config2's scene, through the port."""
    white = rs.add_material([0.73] * 3)
    red = rs.add_material([0.63, 0.065, 0.05])
    green = rs.add_material([0.14, 0.45, 0.091])
    mirror = rs.add_material([0.95, 0.95, 0.95], roughness=0.0,
                             metallic=1.0)
    lamp_m = rs.add_material([18.0] * 3)
    for (n, p, w, h, m) in [
        ([0, 1, 0], [0, 0, 0], 5.56, 5.56, white),
        ([0, -1, 0], [0, 5.48, 0], 5.56, 5.56, white),
        ([0, 0, -1], [0, 2.74, 2.796], 5.56, 5.48, white),
        ([1, 0, 0], [-2.78, 2.74, 0], 5.48, 5.56, red),
        ([-1, 0, 0], [2.78, 2.74, 0], 5.48, 5.56, green),
        ([0, -1, 0], [0, 5.47, 0], 1.3, 1.05, lamp_m),
        ([0.5, 0, -0.866], [-1.1, 1.1, 1.2], 1.8, 2.2, mirror),
    ]:
        rs.add_instance(rs.add_quad(n, p, w, h, m))
    rs.add_point_light([1.8, 4.5, -1.5], [12.0, 11.0, 10.0])
    rs.camera.resize(64, 64)
    rs.camera.fov = 40.0
    rs.camera.look_at([0, 2.73, -8.0], [0, 2.73, 0])
    return rs


def config3(**kw):
    """tests/golden_scenes.py::make_config3's RenderConfig: microfacet
    BSDF, envmap importance sampling at every depth, blue noise."""
    from rfw_tpu_torch.config import RenderConfig
    return RenderConfig(blue_noise=True, max_path_length=2, bsdf="microfacet",
                        envmap_nee=True, envmap_nee_max_depth=-1,
                        env_nee_interleave=0, **kw)


def make_config3(rs):
    """tests/golden_scenes.py::make_config3's scene, through the port: a
    checker-textured floor, a shiny quad and the test sky."""
    from rfw_tpu_torch.scene import HostMaterial, Skybox, Texture
    checker = np.indices((32, 32)).sum(0) % 2
    tex = Texture.from_array(np.stack(
        [checker * 0.7 + 0.15, checker * 0.5 + 0.2, 0.6 - checker * 0.3,
         np.ones((32, 32))], -1).astype(np.float32))
    tid = rs.materials.add_texture(tex)
    floor_mat = HostMaterial(name="floor", roughness=0.35, metallic=0.1)
    floor_mat.maps[0].texture_id = tid
    floor = rs.materials.add(floor_mat)
    shiny = rs.add_material([0.9, 0.7, 0.3], roughness=0.12, metallic=0.9)
    rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 10, 10, floor))
    rs.add_instance(rs.add_quad([0, 0, -1], [0, 1.2, 2.0], 2.5, 2.4, shiny))
    rs.set_skybox(Skybox.test_sky(128, 64))
    rs.camera.resize(64, 64)
    rs.camera.fov = 50.0
    rs.camera.look_at([0, 2.2, -5.5], [0, 1.0, 0.0])
    return rs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _rmse(a, b) -> float:
    return float(np.sqrt(((a - b) ** 2).mean()))


def _median_ms(fn, reps: int = 5) -> float:
    import torch
    fn()                                   # warm
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


SLEEP_CYCLES = 40_000_000    # a device-side wait of ~20 ms


def _device_ms(fn, reps: int = 5, queue: int = 20) -> float:
    """The device time of one launch of ``fn``, median of ``reps``: a
    device-side wait (torch.cuda._sleep) holds the stream while the host
    enqueues ``queue`` launches, which the card then runs back to back
    between two CUDA events. ``_median_ms``'s one launch between two
    events also counts the wrapper's host work wherever that takes longer
    than the kernel. Fails if the host took longer to enqueue than the
    wait lasted."""
    import torch
    fn()                                   # warm
    times = []
    for _ in range(reps):
        w, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        w.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(queue):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        _check(host_ms < w.elapsed_time(a),
               f"enqueueing {queue} launches took {host_ms:.2f} ms, longer "
               f"than the device-side wait ({w.elapsed_time(a):.2f} ms)")
        times.append(a.elapsed_time(b) / queue)
    return float(np.median(times))


def _streams(rs):
    """The main path's own ray streams of chunk 0 at 1080p: the primary
    rays (depth-0 closest hit), the depth-0 fused shadow launch (light
    and envmap shadow rays, 2 lanes a ray, those not wanted at t_max 0,
    as integrator.depth_stage builds it) and the depth-1 bounce rays
    after compaction, each as (origins, directions, t_max)."""
    import torch
    from rfw_tpu_torch.render.integrator import make_path_state
    from rfw_tpu_torch.render.wavefront_driver import (_compact_sort_packed,
                                                       _pack_state,
                                                       _unpack_state)
    eng = rs.context
    w, h = rs.camera.pixel_count
    eng.resize(w, h)
    eng.update()
    eng._get_step(w, h)
    drv = eng._driver
    _check(drv is not None, "1080p frame did not take the compacted driver")
    view = {k: torch.as_tensor(np.asarray(v, np.float32), device=eng.device)
            for k, v in rs.camera.get_view().as_pytree().items()}
    sl = slice(0, drv.chunk)
    pc = {k: v[sl] for k, v in drv._pixel_cache(eng._scene).items()}
    st = make_path_state(eng._scene, view, w, h, 0, rs.config, drv._pid[sl],
                         pixel_cache=pc)
    primary = (st.origin, st.direction,
               torch.full((drv.chunk,), 1e30, device=eng.device))
    isect, shadow = drv._intersector, []

    def occluded(scene, o, d, dist, sort=True, coherent=False):
        if not shadow:                      # depth 0's first launch
            shadow.append((o.contiguous(), d.contiguous(), dist))
        return isect.occluded(scene, o, d, dist, sort=sort,
                              coherent=coherent)

    drv._intersector = isect._replace(occluded=occluded)
    try:
        out, _, _, _ = drv._stage(eng._scene, view, st, 0, 0, 0)
    finally:
        drv._intersector = isect
    _check(len(shadow) == 1, "depth 0 made no occlusion launch")
    packed, live = _compact_sort_packed(eng._scene, _pack_state(out))
    b = _unpack_state(packed)
    bounce = (b.origin.contiguous(), b.direction.contiguous(),
              torch.where(b.alive, 1e30, 0.0))
    return (eng._scene, {"primary": primary, "bounce": bounce,
                         "shadow": shadow[0]}, int(live))


def _bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the FLOP at the
    FP32 peak and the bytes at the memory rate. ``half_ms`` is the FLOP
    bound at half the peak, the rate of separately rounded multiplies
    and adds (--fmad=false forbids FMAs)."""
    ops_ms, bytes_ms = flop / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "half_ms": 2.0 * ops_ms, "flop": flop, "bytes": nbytes}


def _walked_stats(walked, counts) -> str:
    """Mean, max and tail of the visits each block walked (the exit
    rule's work), beside its list lengths (the most it could walk)."""
    import torch
    _check(bool((walked <= counts).all())
           and bool((walked[counts > 0] >= 1).all()),
           "walked-visit counts outside [1, list length]")
    w = walked.float()
    p50, p90, p99 = torch.quantile(
        w, torch.tensor([0.5, 0.9, 0.99], device=w.device)).tolist()
    top = float(w.sort().values[-max(1, w.numel() // 100):].sum()
                / max(float(w.sum()), 1.0))
    return (f"walked visits per block: mean {float(w.mean()):.2f}, max "
            f"{int(walked.max())}, p50/p90/p99 {p50:.0f}/{p90:.0f}/{p99:.0f}"
            f", longest 1 % of blocks {top:.3f} of all visits (list mean "
            f"{float(counts.float().mean()):.2f}, max {int(counts.max())})")


def phase_kernels(rs, cfg, ptxas):
    """enum and visit against their plain versions on the primary and
    bounce chunks at the main path's cell granules, timed, and on the
    bounce chunk at visit_granularity="super" (SUPER_G cells a visit, a
    larger staging buffer), checked and the kernel timed."""
    import dataclasses
    import torch
    from rfw_tpu_torch.ops import visit_intersect as vi
    scene, streams, live = _streams(rs)
    tl = scene["treelets"]
    gran = vi._granularity(tl, cfg)
    t_dim = gran.bounds8.shape[1]
    ext = tl["scene_hi"] - tl["scene_lo"]
    diag = torch.sqrt((ext * ext).sum())
    report = {"enum": {"err": 0.0}, "visit": {"err": 0.0}}
    print(f"phase 3: streams of {streams['primary'][0].shape[0]} lanes, "
          f"{live} live bounce lanes, {t_dim} cells ({gran.n_real} real), "
          f"triangle-major planes {tuple(gran.planes_tm.shape)}")
    for name in ("enum", "visit"):
        p = ptxas.get(f"{name}_kernel", {})
        print(f"phase 3: {name}_kernel ptxas: {p.get('registers')} "
              f"registers, {p.get('smem')} B static shared memory, "
              f"{p.get('spill_stores')}/{p.get('spill_loads')} B spill "
              f"stores/loads")
    sgran = vi._granularity(
        tl, dataclasses.replace(cfg, visit_granularity="super"))
    cases = [("primary", streams["primary"], gran),
             ("bounce", streams["bounce"], gran),
             ("bounce super", streams["bounce"], sgran)]
    eps = float(cfg.t_epsilon)
    for name, (o, d, tm), g in cases:
        timed = g is gran       # the plain versions take seconds at super
        rays = vi._pack_rays(o, d, tm)
        n, bounds = rays.shape[1], g.bounds8
        e_k = vi.block_entries(rays, bounds, g.n_real)
        e_p = vi.block_entries_ref(rays, bounds)
        torch.cuda.synchronize()
        _check(torch.equal(e_k, e_p), f"enum kernel != plain on {name}")
        report["enum"]["err"] = max(report["enum"]["err"],
                                    float((e_k - e_p).abs().max()))
        if timed:
            enum_k = _median_ms(lambda: vi.block_entries(rays, bounds,
                                                         g.n_real))
            enum_d = _device_ms(lambda: vi.block_entries(rays, bounds,
                                                         g.n_real))
            enum_p = _median_ms(lambda: vi.block_entries_ref(rays, bounds))
            # the work this stream needs: a dead lane (t_max 0) crosses no
            # box
            n_live = int((rays[3] > 0).sum())
            eb = _bound(float(n_live) * g.n_real * FLOP_PER_SLAB,
                        4.0 * (7 * n + 6 * t_dim
                               + (n // vi.BLOCK) * t_dim))
            print(f"phase 3: enum  {name:8s} equal, kernel {enum_k:.3f} "
                  f"ms (device {enum_d:.3f} ms), plain {enum_p:.3f} ms, "
                  f"bound {eb['bound_ms']:.3f} ms ({eb['bound_by']}, "
                  f"{n_live} live lanes; {eb['half_ms']:.3f} ms at the "
                  f"unfused half rate), share of bound "
                  f"{eb['bound_ms'] / enum_k:.3f} (device "
                  f"{eb['bound_ms'] / enum_d:.3f})")
            if name == "bounce":
                report["enum"].update(ms=enum_k, device_ms=enum_d,
                                      plain_ms=enum_p, **eb)
        keys, counts = vi.sort_candidates(e_k, diag, vi.M_C)
        ids, cnt, tn, _ = vi.window_candidates(keys, counts, 0, diag, vi.M_C,
                                               bounds.shape[1])
        for any_hit in (False, True):
            args = (rays, ids, cnt, tn)
            walked = torch.zeros(ids.shape[0], dtype=torch.int32,
                                 device=rays.device)
            t_k, s_k = vi.visit(*args, g, eps, any_hit, walked=walked)

            def plain():
                return vi.visit_ref(*args, g.planes, g.super_g, g.k_size,
                                    eps, any_hit)

            t_p, s_p = plain()
            torch.cuda.synchronize()
            found = s_k >= 0
            agree = float((s_k == s_p).float().mean())
            mode = "any-hit" if any_hit else "closest"
            _check(torch.equal(found, s_p >= 0) and torch.equal(s_k, s_p)
                   and torch.equal(t_k, t_p),
                   f"visit kernel != plain on {name} {mode} "
                   f"(slot agreement {agree})")
            report["visit"]["err"] = max(report["visit"]["err"],
                                         float((t_k - t_p).abs().max()))
            ms_k = _median_ms(lambda: vi.visit(*args, g, eps, any_hit))
            ms_d = (_device_ms(lambda: vi.visit(*args, g, eps, any_hit))
                    if timed else None)
            ms_p = _median_ms(plain) if timed else None
            tests = float(walked.sum()) * vi.BLOCK * g.super_g * g.k_size
            vb = _bound(tests * FLOP_PER_TEST,
                        4.0 * (7 * n + 2 * n + 2 * ids.numel() + cnt.numel()
                               + g.planes_tm.numel()))
            plain_s = f"{ms_p:.3f} ms" if timed else "not timed"
            dev_s = (f"device {ms_d:.3f} ms, share of bound "
                     f"{vb['bound_ms'] / ms_d:.3f}" if timed
                     else "device not timed")
            print(f"phase 3: visit {name:8s} {mode:7s} equal "
                  f"(found {float(found.float().mean()):.4f}; {g.n_real} "
                  f"real granules of {g.super_g} cells), kernel "
                  f"{ms_k:.3f} ms, plain {plain_s}, bound "
                  f"{vb['bound_ms']:.3f} ms ({vb['bound_by']}, {tests:.4g} "
                  f"tests; {vb['half_ms']:.3f} ms at the unfused half "
                  f"rate), share of bound {vb['bound_ms'] / ms_k:.3f} "
                  f"({dev_s})")
            print(f"phase 3: visit {name:8s} {mode:7s} "
                  f"{_walked_stats(walked, cnt)}")
            if name == "bounce" and not any_hit:
                report["visit"].update(ms=ms_k, device_ms=ms_d,
                                       plain_ms=ms_p, **vb)
    return report


def _bits_equal(a, b) -> bool:
    """Two (t, prim, u, v) results equal bit for bit (a NaN t_max's NaN
    t too)."""
    import torch
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _edge_batches(scene, primary, eps):
    """The traversal's edge cases, as (name, bvh, triangle table,
    origins, directions, t_max): the comb BVH, whose walks overflow the
    64-entry stack, and batches of the slice's primary rays of n = 0, 1,
    33, one above a block of the kernel (TRAVERSE_THREADS + 1) and one
    above 512 blocks, with axis-parallel
    directions, zero (and minus zero) components, zero directions and
    NaN directions and origins, and t_max 1e30, 0, -1, eps, NaN and 2.5
    mixed in every warp."""
    import torch
    from rfw_tpu_torch.ops import traverse
    from rfw_tpu_torch.utils.synthetic import comb_bvh
    dev = scene["tri_table"].device
    wb, tris = comb_bvh()
    comb = {k: torch.from_numpy(v).to(dev) for k, v in wb.items()}
    comb["nodes"] = traverse.node_table(comb)
    comb_tris = traverse.tri_table(
        tuple(torch.from_numpy(x).to(dev) for x in tris))
    rng = np.random.default_rng(SEED)
    o = rng.uniform(-2.5, 2.5, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(128, 1e30, np.float32)
    tm[3::11], tm[5::11], tm[7::11] = 0.0, np.nan, -1.0
    out = [("comb", comb, comb_tris, torch.from_numpy(o).to(dev),
            torch.from_numpy(d).to(dev), torch.from_numpy(tm).to(dev))]
    axes = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                        device=dev)
    t_pattern = torch.tensor([1e30, 0.0, 1e30, -1.0, eps, float("nan"),
                              2.5], device=dev)
    for n in (0, 1, 33, TRAVERSE_THREADS + 1, 512 * TRAVERSE_THREADS + 1):
        o, d = primary[0][:n].clone(), primary[1][:n].clone()
        _check(o.shape[0] == n, f"edge batch of {n} rays from a chunk of "
               f"{primary[0].shape[0]}")
        k = torch.arange(n, device=dev)
        m = k % 8 == 3
        d[m] = axes[(k[m] // 8) % 6]
        for lane, zero in ((5, 0.0), (6, -0.0)):
            m = k % 8 == lane
            d[m, (k[m] // 8) % 3] = zero
        d[k % 32 == 7] = 0.0
        d[k % 32 == 11, 1] = float("nan")      # NaN slabs: no box is hit
        o[k % 32 == 13] = float("nan")
        out.append((f"slice n={n}", scene["bvh"], scene["tri_table"], o, d,
                    t_pattern[k % 7]))
    return out


def phase_traverse_kernel(rs, cfg, ptxas):
    """The traversal kernel against traverse_wide_ref, bit for bit (t,
    prim, u, v): on the edge batches, then on the primary and bounce
    chunks (closest and any hit) and the depth-0 fused shadow launch (any
    hit), timed and bounded by the work the plain version counts on the
    same stream, which walks the live lanes (t_max > eps) only."""
    import torch
    from rfw_tpu_torch.ops import traverse
    scene, streams, _ = _streams(rs)
    bvh, table = scene["bvh"], scene["tri_table"]
    eps = float(cfg.t_epsilon)
    p = ptxas.get("traverse_kernel", {})
    print(f"phase 3: traverse_kernel ptxas: {p.get('registers')} registers, "
          f"{p.get('smem')} B shared memory, {p.get('stack')} B stack frame "
          f"(the 64-entry stack), {p.get('spill_stores')}/"
          f"{p.get('spill_loads')} B spill stores/loads; "
          f"{bvh['nodes'].shape[0]} nodes of 128 B, {table.shape[0]} "
          f"triangles of 48 B")
    for name, b, tris, o, d, tm in _edge_batches(scene, streams["primary"],
                                                  eps):
        for any_hit in (False, True):
            mode = "any-hit" if any_hit else "closest"
            out_k = traverse.traverse_wide(o, d, b, tris, t_max=tm,
                                           t_epsilon=eps, any_hit=any_hit)
            out_p = traverse.traverse_wide_ref(o, d, b, tris, t_max=tm,
                                               t_epsilon=eps,
                                               any_hit=any_hit)
            torch.cuda.synchronize()
            _check(_bits_equal(out_k, out_p),
                   f"traverse kernel != plain on the edge batch {name} "
                   f"{mode}")
            print(f"phase 3: traverse edge batch {name:16s} {mode:7s} "
                  f"equal bit for bit ({o.shape[0]} lanes, "
                  f"{int((out_k[1] >= 0).sum())} hits)")
    report = {"err": 0.0}
    for name, modes in (("primary", (False, True)), ("bounce", (False, True)),
                        ("shadow", (True,))):
        o, d, tm = streams[name]
        n = o.shape[0]
        n_live = int((tm > eps).sum())
        for any_hit in modes:
            mode = "any-hit" if any_hit else "closest"

            def kernel():
                return traverse.traverse_wide(o, d, bvh, table, t_max=tm,
                                              t_epsilon=eps, any_hit=any_hit)

            work, walked = {}, {}
            out_k = kernel()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out_p = traverse.traverse_wide_ref(o, d, bvh, table, t_max=tm,
                                               t_epsilon=eps,
                                               any_hit=any_hit, stats=work)
            b.record()
            torch.cuda.synchronize()
            ms_p = a.elapsed_time(b)
            agree = float((out_k[1] == out_p[1]).float().mean())
            _check(_bits_equal(out_k, out_p),
                   f"traverse kernel != plain on {name} {mode} (prim "
                   f"agreement {agree})")
            report["err"] = max(report["err"], float(
                (out_k[0] - out_p[0]).abs().max()))
            ms_k = _median_ms(kernel)
            ms_d = _device_ms(kernel)
            # the walk before the exact exit: dead lanes too
            traverse.traverse_wide_ref(o, d, bvh, table, t_max=tm,
                                       t_epsilon=eps, any_hit=any_hit,
                                       stats=walked, walk_dead=True)
            dead_share = 1.0 - work["visits"] / max(walked["visits"], 1)
            # bytes: a live lane's origin, direction and t_max in (28 B),
            # a dead lane's t_max (4 B), every lane's t, prim, u, v out
            # (16 B); the 128 B row of each node a live lane popped and
            # the 36 B of each triangle it tested (padded nodes,
            # untouched subtrees and dead lanes read none)
            nodes_read = int(work["node_seen"].sum())
            tris_read = int(work["tri_seen"].sum())
            tb = _bound(work["visits"] * 4.0 * FLOP_PER_BOX
                        + work["tests"] * float(FLOP_PER_MT),
                        28.0 * n_live + 4.0 * (n - n_live) + 16.0 * n
                        + 128.0 * nodes_read + 36.0 * tris_read)
            found = float((out_k[1] >= 0).float().mean())
            print(f"phase 3: traverse {name:8s} {mode:7s} equal bit for bit "
                  f"(found {found:.4f}; {n_live} live of {n} lanes), kernel "
                  f"{ms_k:.4f} ms (one launch, median of 5; device "
                  f"{ms_d:.4f} ms), plain {ms_p:.1f} ms (one run), bound "
                  f"{tb['bound_ms']:.4f} ms ({tb['bound_by']}, "
                  f"{tb['bytes']:.0f} B, {work['visits']} node visits of "
                  f"{nodes_read} distinct nodes, {work['tests']} triangle "
                  f"tests of {tris_read} distinct triangles; "
                  f"{tb['half_ms']:.4f} ms at the unfused half rate), share "
                  f"of bound {tb['bound_ms'] / ms_k:.4f} (device "
                  f"{tb['bound_ms'] / ms_d:.4f}); longest walk "
                  f"{work['longest']} nodes ("
                  f"{1e3 * ms_d / max(work['longest'], 1):.2f} us a node "
                  f"along it on the device); walking every lane (no "
                  f"dead-lane exit) took {walked['visits']} visits, "
                  f"{walked['tests']} tests: dead lanes' share "
                  f"{dead_share:.4f}")
            if name == "bounce" and not any_hit:
                report.update(ms=ms_k, device_ms=ms_d, plain_ms=ms_p, **tb)
    return {"traverse": report}


def phase_megakernel_golden():
    """Phase 4's megakernel half: the Cornell golden and the config-2 and
    config-3 goldens through megakernel on the card, then bruteforce
    against megakernel on the Cornell scene."""
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.system import RenderSystem
    cases = (("cornell", make_cornell, lambda: RenderConfig(blue_noise=True)),
             ("config2", make_config2,
              lambda: RenderConfig(blue_noise=True, max_path_length=3)),
             ("config3", make_config3, config3))
    for label, make, cfg in cases:
        golden = np.load(os.path.join(ROOT, "tests", "golden",
                                      f"{label}_64_8spp.npy")).astype(
                                          np.float32)
        rs = make(RenderSystem("megakernel", cfg(), device="cuda"))
        img = rs.render_frame(samples=8)
        rmse = _rmse(img, golden)
        print(f"phase 4: {label} 64x64 8 spp on the card, megakernel: RMSE "
              f"vs golden {rmse:.6g} (bar 2e-3), mean "
              f"{float(img.mean()):.6g}")
        _check(img.shape == (64, 64, 3) and bool(np.isfinite(img).all()),
               f"{label} megakernel frame not finite or misshapen")
        _check(rmse < 2e-3, f"{label} megakernel frame RMSE {rmse} >= 2e-3")
    fast = dict(bsdf="lambert", blue_noise=False, russian_roulette=False,
                firefly_clamp=1e9, max_path_length=2)
    imgs = {name: make_cornell(RenderSystem(name, RenderConfig(**fast),
                                            device="cuda"), 32)
            .render_frame(samples=4) for name in ("bruteforce", "megakernel")}
    rmse = _rmse(imgs["bruteforce"], imgs["megakernel"])
    print(f"phase 4: Cornell 32x32 4 spp, bruteforce vs megakernel: equal "
          f"{bool(np.array_equal(imgs['bruteforce'], imgs['megakernel']))}, "
          f"RMSE {rmse:.6g} (bar 2e-3)")
    _check(rmse < 2e-3, f"bruteforce vs megakernel RMSE {rmse} >= 2e-3")


def phase_golden():
    """The config-2 and config-3 golden frames on the card, through visit
    and through tvisit."""
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.system import RenderSystem
    cases = (("config2", make_config2,
              lambda: RenderConfig(blue_noise=True, max_path_length=3,
                                   max_rays_per_pass=1024)),
             ("config3", make_config3,
              lambda: config3(max_rays_per_pass=1024)))
    for label, make, cfg in cases:
        golden = np.load(os.path.join(ROOT, "tests", "golden",
                                      f"{label}_64_8spp.npy")).astype(
                                          np.float32)
        for name in ("visit", "tvisit"):
            rs = make(RenderSystem("wavefront", cfg(), device="cuda"))
            rs.set_setting("intersector", name)
            img = rs.render_frame(samples=8)
            rmse = _rmse(img, golden)
            print(f"phase 4: {label} 64x64 8 spp on the card, {name}: RMSE "
                  f"vs golden {rmse:.6g} (bar 2e-3), mean "
                  f"{float(img.mean()):.6g}")
            _check(img.shape == (64, 64, 3) and bool(np.isfinite(img).all()),
                   f"{label} {name} frame not finite or misshapen")
            _check(rmse < 2e-3, f"{label} {name} frame RMSE {rmse} >= 2e-3")


def pass0_window(tl, rays, diag):
    """Pass 0's parent window of a stream on the cell table: (ids, t_p),
    as the tvisit intersector's first pass takes it."""
    from rfw_tpu_torch.ops import tvisit_intersect as tv
    from rfw_tpu_torch.ops import visit_intersect as vi
    bounds = tv.parent_bounds(tl)
    keys, counts = vi.sort_candidates(
        vi.block_entries(rays, bounds, tl["n_cells"]), diag, tv.M_C)
    t_p = bounds.shape[1]
    return vi.window_candidates(keys, counts, 0, diag, tv.M_C, t_p)[0], t_p


def _gran_check(tl, diag) -> None:
    """The quantisation step diag / qmax of the cell keys and of the
    child keys on the card: the Python-number division the port used to
    make against quant_gran's tensor division, which must equal numpy's
    IEEE float32 quotient."""
    import torch
    from rfw_tpu_torch.ops import tvisit_intersect as tv
    from rfw_tpu_torch.ops import visit_intersect as vi
    t_c = tl["bmin"].shape[0]
    for what, qmax in (("cell", (1 << (24 - vi._cid_bits(t_c))) - 1),
                       ("child", tv._slot_bits(4 * tv.M_C)[1])):
        old, new = diag / qmax, vi.quant_gran(qmax, diag)
        ieee = np.float32(diag.item()) / np.float32(qmax)
        print(f"phase 3: gran of the {what} keys (qmax {qmax}, diag "
              f"{diag.item()!r}): diag / qmax {old.item()!r}, quant_gran "
              f"{new.item()!r}, numpy {float(ieee)!r}; the old form "
              f"{'differs' if not torch.equal(old, new) else 'agrees'}")
        _check(np.float32(new.item()) == ieee,
               f"quant_gran of the {what} keys is not the IEEE quotient")


def expansion_windows(tl, streams, diag) -> dict:
    """The windows the expansion kernel is held on, {name: (ids, rays,
    t_p)}: pass 0 and pass 1 of the primary, bounce and depth-0 shadow
    streams, then synthetic.expansion_windows' made-up windows (from
    SEED) on the bounce rays and their pass-0 window: every parent real
    (512 real slots, the full row), invalid parents interleaved with
    valid ones, one live lane a sub-block, blocks of dead and NaN t_hi
    lanes, and a ray whose far-point box entry lies below its t_hi."""
    import torch
    from rfw_tpu_torch.ops import tvisit_intersect as tv
    from rfw_tpu_torch.ops import visit_intersect as vi
    bounds = tv.parent_bounds(tl)
    t_p = bounds.shape[1]
    out = {}
    for name in ("primary", "bounce", "shadow"):
        rays = vi._pack_rays(*streams[name])
        keys, counts = vi.sort_candidates(
            vi.block_entries(rays, bounds, tl["n_cells"]), diag, tv.M_C)
        for it in (0, 1):
            out[f"{name} pass {it}"] = (vi.window_candidates(
                keys, counts, it, diag, tv.M_C, t_p)[0], rays, t_p)
    ids, rays, _ = out["bounce pass 0"]
    made = synthetic.expansion_windows(ids.cpu().numpy(), rays.cpu().numpy(),
                                       t_p, SEED)
    for name, (i, r) in made.items():
        out[name] = (torch.from_numpy(i).to(rays.device),
                     torch.from_numpy(r).to(rays.device), t_p)
    return out


def phase_tvisit_kernel(rs, cfg, ptxas):
    """After the RenderSystem was switched to the tvisit intersector: the
    quantisation step; the expansion kernel against expand_children_ref
    on every window of ``expansion_windows`` (cids, counts and tnears
    equal), with its device time there; then on pass 0 of the primary
    and bounce chunks the kernel's one-launch and plain times and bound,
    and tvisit against tvisit_ref on the kernel's lists."""
    import torch
    from rfw_tpu_torch.ops import tvisit_intersect as tv
    from rfw_tpu_torch.ops import visit_intersect as vi
    scene, streams, live = _streams(rs)
    tl = scene["treelets"]
    _check("bmin32" in tl, "switch to tvisit did not rebuild the scene "
           "with the child tables")
    bmin32, bmax32, wg32, wtm32, k32 = tv.child_tables(tl)
    diag = vi.scene_diag(tl)
    _gran_check(tl, diag)
    for name in ("expand_kernel", "tvisit_kernel"):
        p = ptxas.get(name, {})
        print(f"phase 3: {name} ptxas: {p.get('registers')} registers, "
              f"{p.get('smem')} B static shared memory, "
              f"{p.get('spill_stores')}/{p.get('spill_loads')} B spill "
              f"stores/loads")
    print(f"phase 3: expand_kernel resident blocks per SM "
          f"{tv.expand_occupancy()} (cudaOccupancyMaxActiveBlocksPer"
          f"Multiprocessor)")
    eps = float(cfg.t_epsilon)
    report = {"expand": {"err": 0.0}, "tvisit": {"err": 0.0}}
    windows = expansion_windows(tl, streams, diag)
    for wname, (ids, rays, t_p) in windows.items():
        args = (ids, rays, bmin32, bmax32, diag, t_p)
        lists = tv.expand_children(*args)
        plain = tv.expand_children_ref(*args)
        torch.cuda.synchronize()
        for what, a, b in zip(("cids", "counts", "tnears"), lists, plain):
            _check(torch.equal(a, b), f"expansion kernel != plain on "
                   f"{wname} ({what}: {float((a != b).float().mean())} "
                   f"differ)")
        live_b = (rays[3] > 0).reshape(-1, vi.BLOCK).sum(1).float()
        real_b = 4 * (ids < t_p).sum(1).float()
        full = real_b == 4 * ids.shape[1]
        pairs_b = live_b * real_b
        ms_d = _device_ms(lambda: tv.expand_children(*args))
        full_pairs = float(pairs_b[full].sum() / pairs_b.sum().clamp(min=1))
        print(f"phase 3: expand {wname:14s} equal (cids, counts, tnears; "
              f"a 256-ray block: mean real child slots "
              f"{float(real_b.mean()):.1f}, live lanes "
              f"{float(live_b.mean()):.1f}; full windows "
              f"{float(full.float().mean()):.3f} of the blocks, "
              f"{full_pairs:.3f} of the live pairs; child list mean "
              f"{float(lists[1].float().mean()):.1f}, max "
              f"{int(lists[1].max())}), device {ms_d:.4f} ms")
    for name in ("primary", "bounce"):
        ids, rays, t_p = windows[f"{name} pass 0"]
        n = rays.shape[1]
        args = (ids, rays, bmin32, bmax32, diag, t_p)
        cids, ccounts, ctnears = tv.expand_children(*args)
        ms_k = _median_ms(lambda: tv.expand_children(*args))
        ms_d = _device_ms(lambda: tv.expand_children(*args))
        ms_p = _median_ms(lambda: tv.expand_children_ref(*args))
        # the work this window needs: each live lane against the real
        # children (those of a valid parent) of its block's window
        live_b = (rays[3] > 0).reshape(-1, vi.BLOCK).sum(1)
        real_b = 4 * (ids < t_p).sum(1)
        pairs = float((live_b * real_b).sum())
        xb = _bound(pairs * FLOP_PER_SLAB,
                    4.0 * (7 * n + ids.numel() + 6 * bmin32.shape[0]
                           + 2 * cids.numel() + ccounts.numel()))
        print(f"phase 3: expand {name:8s} pass 0: {cids.shape[0]} "
              f"sub-blocks, kernel {ms_k:.3f} ms (device {ms_d:.4f} ms), "
              f"plain {ms_p:.3f} ms, bound {xb['bound_ms']:.4f} ms "
              f"({xb['bound_by']}, {pairs:.4g} live (ray, child) pairs; "
              f"{xb['half_ms']:.4f} ms at the unfused half rate; bytes "
              f"{xb['bytes']:.4g}, {xb['bytes'] / PEAK_BYTES * 1e3:.4f} ms),"
              f" share of bound {xb['bound_ms'] / ms_k:.3f} (device "
              f"{xb['bound_ms'] / ms_d:.3f})")
        if name == "bounce":
            report["expand"].update(ms=ms_k, device_ms=ms_d, plain_ms=ms_p,
                                    **xb)
        for any_hit in (False, True):
            targs = (rays, cids, ccounts, ctnears, wg32, wtm32, k32, eps,
                     any_hit)
            rargs = (rays, cids, ccounts, ctnears, wg32, k32, eps, any_hit)
            walked = torch.zeros(cids.shape[0], dtype=torch.int32,
                                 device=rays.device)
            t_k, s_k = tv.tvisit(*targs, walked=walked)
            t_r, s_r = tv.tvisit_ref(*rargs)
            torch.cuda.synchronize()
            mode = "any-hit" if any_hit else "closest"
            agree = float((s_k == s_r).float().mean())
            _check(torch.equal(s_k, s_r) and torch.equal(t_k, t_r),
                   f"tvisit kernel != plain on {name} {mode} "
                   f"(slot agreement {agree})")
            report["tvisit"]["err"] = max(report["tvisit"]["err"],
                                          float((t_k - t_r).abs().max()))
            ms_k = _median_ms(lambda: tv.tvisit(*targs))
            ms_d = _device_ms(lambda: tv.tvisit(*targs))
            ms_p = _median_ms(lambda: tv.tvisit_ref(*rargs), reps=3)
            found = float((s_k >= 0).float().mean())
            tests = float(walked.sum()) * tv.LANES * k32
            tb = _bound(tests * FLOP_PER_TEST,
                        4.0 * (9 * n + 2 * cids.numel() + ccounts.numel()
                               + wtm32.numel()))
            print(f"phase 3: tvisit {name:8s} {mode:7s} equal (found "
                  f"{found:.4f}), kernel {ms_k:.3f} ms (median of 5; device "
                  f"{ms_d:.3f} ms), plain {ms_p:.3f} ms (median of 3), bound "
                  f"{tb['bound_ms']:.3f} ms ({tb['bound_by']}, {tests:.4g} "
                  f"tests; {tb['half_ms']:.3f} ms at the unfused half "
                  f"rate), share of bound {tb['bound_ms'] / ms_k:.3f} "
                  f"(device {tb['bound_ms'] / ms_d:.3f})")
            print(f"phase 3: tvisit {name:8s} {mode:7s} "
                  f"{_walked_stats(walked, ccounts)}")
            if name == "bounce" and not any_hit:
                report["tvisit"].update(ms=ms_k, device_ms=ms_d,
                                        plain_ms=ms_p, **tb)
    print(f"phase 3: tvisit chunks: {live} live bounce lanes, "
          f"{wtm32.shape[0]} children of {k32} triangles, triangle-major "
          f"child planes {tuple(wtm32.shape)}")
    return report


SLICE_WINDOWS, WINDOW_SAMPLES = 3, 4


def phase_slice(rs, n_tris, label, png, profile, must_launch):
    """One warm-up sample, then 3 CONVERGE windows of 4 samples; the
    launch counters are reset just before the windows. Returns the
    launches and the frame."""
    import torch
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.render import RenderStatus
    rs.render_frame(status=RenderStatus.RESET, samples=1)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    samples, windows = WINDOW_SAMPLES, []
    cuda_lib.reset_launch_counts()
    for _ in range(SLICE_WINDOWS):
        t0 = time.perf_counter()
        rs.render_frame_async(status=RenderStatus.CONVERGE, samples=samples)
        frame = rs.finish_frame()
        windows.append((time.perf_counter() - t0) * 1000.0 / samples)
    launches = dict(cuda_lib.launch_counts)
    st = rs.get_render_stats()
    rays = (st.primary_count + st.secondary_count + st.deep_count
            + st.shadow_count)
    med = float(np.median(windows))
    mrays = rays * samples / (med * samples / 1000.0) / 1e6
    print(f"{label}: {n_tris} triangles at 1920x1080, ms/sample median "
          f"{med:.1f}, windows {[round(w, 1) for w in windows]}")
    print(f"{label}: rays/sample {rays} (primary {st.primary_count}, "
          f"secondary {st.secondary_count}, deep {st.deep_count}, shadow "
          f"{st.shadow_count}), {mrays:.3f} Mrays/s, frame mean "
          f"{float(frame.mean()):.6g}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          f"{launches}")
    _check(frame.shape == (1080, 1920, 3) and bool(np.isfinite(frame).all())
           and float(frame.mean()) > 0, "1080p frame not finite/positive")
    _check(all(launches[k] > 0 for k in must_launch),
           f"kernels not launched on the {label} path: {launches}")
    if png:
        from rfw_tpu_torch.utils.image import save_png
        save_png(png, rs.tonemap_frame(frame))
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            rs.render_frame(status=RenderStatus.CONVERGE, samples=1)
            wall = (time.perf_counter() - t0) * 1000.0
        events = p.key_averages()
        # device rows only: an operator row repeats its kernels' time
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation) / 1000.0
        print(events.table(sort_by="cuda_time_total", row_limit=25))
        print(f"{label}: profiled sample: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms, idle share {1.0 - busy / wall:.3f}")
    return launches, frame


def phase_depth_split(rs, label):
    """One CONVERGE frame of 2 samples with ``profile_stages``: its last
    sample syncs after each depth and RenderStats holds the split."""
    from rfw_tpu_torch.render import RenderStatus
    object.__setattr__(rs.config, "profile_stages", True)
    try:
        t0 = time.perf_counter()
        rs.render_frame(status=RenderStatus.CONVERGE, samples=2)
        wall = (time.perf_counter() - t0) * 1000.0
    finally:
        object.__setattr__(rs.config, "profile_stages", False)
    st = rs.get_render_stats()
    split = [st.primary_time * 1e3, st.secondary_time * 1e3,
             st.deep_time * 1e3]
    print(f"{label}: per-depth split of a profiled sample (depth 0 with "
          f"ray generation, depth 1, depths >= 2; each with the compaction "
          f"after it): {split[0]:.1f}, {split[1]:.1f}, {split[2]:.1f} ms, "
          f"sum {sum(split):.1f} ms; the 2-sample frame took {wall:.1f} ms")
    _check(st.primary_time > 0 and st.secondary_time > 0,
           f"{label}: profile_stages filled no per-depth times")
    return split


def phase_textured(png, profile):
    """Phase 7: the textured 1080p slice on a RenderSystem of its own
    (microfacet BSDF, stochastic merged-atlas fetches)."""
    import torch
    import rfw_tpu_torch.system as system_mod
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.system import RenderSystem
    rs = RenderSystem("wavefront", RenderConfig(bsdf="microfacet"),
                      device="cuda")
    cfg = rs.config
    _check(cfg.texture_filter == "stochastic"
           and cfg.merged_material_atlas, "phase 7 config is not the default")
    t0 = time.perf_counter()
    mats = slice_materials(rs)
    t_tex = time.perf_counter() - t0
    atlas_s = []
    build = system_mod.build_atlases_cached

    def timed_build(*args, **kw):
        t = time.perf_counter()
        out = build(*args, **kw)
        atlas_s.append(time.perf_counter() - t)
        return out

    system_mod.build_atlases_cached = timed_build
    try:
        with tempfile.TemporaryDirectory() as work:
            t0 = time.perf_counter()
            n_tris = build_slice_scene(rs, work, mats)
            rs.synchronize()
            t_scene = time.perf_counter() - t0
    finally:
        system_mod.build_atlases_cached = build
    scene = rs.context._scene
    _check(scene.get("matlas") is not None
           and scene["matlas"].dtype == torch.int32
           and scene["atlas"].shape == (1, 4),
           "phase 7 scene did not take the merged material atlas")
    matlas_b = scene["matlas"].numel() * 4
    tex0 = rs.materials.textures[0]
    print(f"phase 7: {len(rs.materials.textures)} textures of "
          f"{tex0.width}x{tex0.height} made in {t_tex:.1f} s; scene of "
          f"{n_tris} triangles, {len(rs.materials.materials)} materials "
          f"loaded and built in "
          f"{t_scene:.1f} s, of which the atlases {sum(atlas_s):.1f} s; "
          f"merged atlas on the card {matlas_b} B "
          f"({matlas_b / 2**20:.1f} MiB, {scene['matlas'].shape[0]} texels "
          f"of 3 words), flat atlas a {tuple(scene['atlas'].shape)} stub")
    launches, frame = phase_slice(rs, n_tris, "phase 7", png, profile,
                                  ("enum", "visit"))
    split = phase_depth_split(rs, "phase 7")
    return launches, frame, split


REFIT_FRAMES = 8


def _refit_system(work: str, t: float, sphere_xf=None):
    """Phase 8's scene: the untextured slice plus the skinned tube (3x,
    in front of the spheres), posed at ``t``, with the spheres' instance
    (0) at ``sphere_xf``; not yet synchronised."""
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.system import RenderSystem
    from rfw_tpu_torch.utils.synthetic import write_skinned_gltf
    rs = RenderSystem("wavefront", RenderConfig(), device="cuda")
    n_tris = build_slice_scene(rs, work)
    path = os.path.join(work, "tube.gltf")
    n_tris += write_skinned_gltf(path, SEED)
    rs.add_instance(rs.add_object(path), scale=(3, 3, 3),
                    translation=(0.0, 0.0, -10.0))
    if sphere_xf is not None:
        rs.update_instance(0, sphere_xf)
    rs.set_animations_to(t)
    return rs, n_tris


def _sphere_move(i: int):
    """The spheres' i-th instance transform: turned about y, shifted."""
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.02 * i), np.sin(0.02 * i)
    m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    m[:3, 3] = [0.05 * i, 0.0, 0.03 * i]
    return m


def phase_refit():
    """Phase 8: config 4's path at 1080p. Deformation frames (the skinned
    tube re-posed) and instance moves (the spheres) must update the scene
    by the device update (``scene_data.move_instances_device``: one
    ``retransform`` launch each), never by a full build, each faster than
    the build; the final state renders like a fresh build of it; one more
    deformation frame runs through tvisit. Returns the launches of each
    deformation frame."""
    import torch
    import rfw_tpu_torch.render.scene_data as sd
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.render import RenderStatus
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    builds, refits = [0], []
    build, update = sd.build_device_scene, sd.move_instances_device

    def counted_build(*a, **kw):
        builds[0] += 1
        return build(*a, **kw)

    def timed_device_update(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = update(*a, **kw)
        ev[1].record()
        refits.append(ev)
        return out

    def timed_update(change):
        torch.cuda.synchronize()
        n_refits = len(refits)
        launched = cuda_lib.launch_counts["retransform"]
        t0 = time.perf_counter()
        change()
        t1 = time.perf_counter()
        rs.synchronize()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _check(len(refits) == n_refits + 1, "an update ran no device update")
        _check(cuda_lib.launch_counts["retransform"] == launched + 1,
               "a device update did not launch retransform once")
        refit = refits[-1][0].elapsed_time(refits[-1][1])
        return (t2 - t0) * 1e3, (t1 - t0) * 1e3, refit

    def sample():
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        frame = rs.render_frame(status=RenderStatus.CONVERGE, samples=1)
        ms = (time.perf_counter() - t0) * 1e3
        _check(bool(np.isfinite(frame).all()) and float(frame.mean()) > 0,
               "phase 8 frame not finite/positive")
        return ms, dict(cuda_lib.launch_counts)

    def report(label, rows):
        upd, host, refit, smp = (float(np.median(c)) for c in zip(*rows))
        print(f"phase 8: {label}: median update {upd:.1f} ms (host "
              f"{host:.1f} ms before synchronize, refit span {refit:.2f} "
              f"ms between CUDA events around the device update's call, "
              f"host-dispatch bound, the rest {upd - host - refit:.1f} ms), "
              f"median 1080p sample {smp:.1f} ms, {1e3 / (upd + smp):.3f} "
              f"frames/s at 1 spp; updates "
              f"{[round(r[0], 1) for r in rows]} ms")
        _check(upd < build_s * 1e3,
               f"{label}: median update {upd:.1f} ms not below the full "
               f"build's {build_s * 1e3:.1f} ms")

    torch.cuda.reset_peak_memory_stats()
    sd.move_instances_device = timed_device_update
    try:
        with tempfile.TemporaryDirectory() as work:
            rs, n_tris = _refit_system(work, 0.0)
            t0 = time.perf_counter()
            rs.synchronize()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            print(f"phase 8: slice with the skinned tube, {n_tris} triangles"
                  f", built at t = 0 in {build_s:.2f} s (host BVH build and "
                  f"upload, no disk cache)")
            rs.render_frame(status=RenderStatus.RESET, samples=1)  # warm-up
            rs.context.prewarm_instance_moves()
            sd.build_device_scene = counted_build
            deform, launches = [], []
            for i in range(REFIT_FRAMES):
                t = (i + 1) / (REFIT_FRAMES + 2)
                upd = timed_update(lambda: rs.set_animations_to(t))
                ms, counts = sample()
                deform.append((*upd, ms))
                launches.append(counts)
                _check(counts["enum"] > 0 and counts["visit"] > 0,
                       f"deformation frame {i} launched no enum/visit")
            report("deformation (tube re-skinned, 65,536 triangles)", deform)
            moves = []
            for i in range(REFIT_FRAMES):
                upd = timed_update(
                    lambda: rs.update_instance(0, _sphere_move(i + 1)))
                moves.append((*upd, sample()[0]))
            report("instance move (60 spheres)", moves)
            _check(builds[0] == 0, f"{builds[0]} full builds in "
                   f"{2 * REFIT_FRAMES} same-topology updates")
            # one more deformation update under the profiler: the
            # update's kernels and device time (the refit span above
            # brackets the host's dispatch of the update's ops, not the
            # device's work)
            t_last = (REFIT_FRAMES + 0.5) / (REFIT_FRAMES + 2)
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                upd = timed_update(lambda: rs.set_animations_to(t_last))
            dev = [e for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
            print(f"phase 8: profiled deformation update: wall "
                  f"{upd[0]:.1f} ms, refit span {upd[2]:.2f} ms (events; "
                  f"host-dispatch bound); {sum(e.count for e in dev)} device"
                  f" kernels, device time (busy) "
                  f"{sum(e.self_device_time_total for e in dev) / 1e3:.2f}"
                  f" ms")
            _check(builds[0] == 0, "the profiled update built in full")
            sd.build_device_scene = build

            # the refit state against a fresh build of the same state
            fresh, _ = _refit_system(work, t_last,
                                     _sphere_move(REFIT_FRAMES))
            t0 = time.perf_counter()
            fresh.synchronize()
            torch.cuda.synchronize()
            print(f"phase 8: fresh build of the final state "
                  f"{time.perf_counter() - t0:.2f} s")
            a = rs.render_frame(status=RenderStatus.RESET, samples=4)
            b = fresh.render_frame(status=RenderStatus.RESET, samples=4)
            del fresh
            rmse = _rmse(a, b)
            print(f"phase 8: refit frame vs fresh build, 4 spp at 1080p: "
                  f"RMSE {rmse:.6g} (bar 2e-3), max abs difference "
                  f"{float(np.abs(a - b).max()):.6g}, frame mean "
                  f"{float(a.mean()):.6g}")
            _check(rmse < 2e-3, f"refit frame RMSE {rmse} >= 2e-3")

            # the refit's child tables reach the tvisit kernels
            rs.set_setting("intersector", "tvisit")
            rs.render_frame(status=RenderStatus.RESET, samples=1)
            sd.build_device_scene = counted_build
            upd = timed_update(lambda: rs.set_animations_to(0.95))
            _check(builds[0] == 0, "the tvisit deformation built in full")
            ms, counts = sample()
            print(f"phase 8: tvisit deformation frame: update {upd[0]:.1f} "
                  f"ms (refit span {upd[2]:.2f} ms), sample {ms:.1f} ms, "
                  f"launches {counts}")
            _check(counts["expand"] > 0 and counts["tvisit"] > 0,
                   f"tvisit deformation frame launched {counts}")
            phase_host_refit(rs, work, builds)
    finally:
        sd.build_device_scene, sd.move_instances_device = build, update
    print(f"phase 8: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_host_refit(rs, work, builds):
    """Phase 8's host refit: the phase-8 system switched to the bvh
    intersector, then one deformation update, which must take the host
    refit (no full build; ``builds`` counts them) and render like a fresh
    build of its state through bvh."""
    import torch
    import rfw_tpu_torch.render.scene_data as sd
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.render import RenderStatus
    host_refit = sd.refit_deformed
    spans = []

    def timed_host_refit(*a, **kw):
        t = time.perf_counter()
        out = host_refit(*a, **kw)
        spans.append((time.perf_counter() - t) * 1e3)
        return out

    sd.refit_deformed = timed_host_refit
    try:
        n_builds = builds[0]
        t0 = time.perf_counter()
        rs.set_setting("intersector", "bvh")
        rs.render_frame(status=RenderStatus.RESET, samples=1)
        print(f"phase 8: switch to bvh and one 1080p sample "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"({builds[0] - n_builds} full builds, {len(spans)} host "
              f"refits: the switch keeps the topology)")
        t_state = 0.97
        torch.cuda.synchronize()
        n_builds, n_spans = builds[0], len(spans)
        t0 = time.perf_counter()
        rs.set_animations_to(t_state)
        rs.synchronize()
        torch.cuda.synchronize()
        upd = (time.perf_counter() - t0) * 1e3
    finally:
        sd.refit_deformed = host_refit
    _check(builds[0] == n_builds and len(spans) == n_spans + 1,
           f"the bvh deformation took {builds[0] - n_builds} full builds and "
           f"{len(spans) - n_spans} host refits")
    cuda_lib.reset_launch_counts()
    a = rs.render_frame(status=RenderStatus.RESET, samples=2)
    counts = dict(cuda_lib.launch_counts)
    _check(counts["traverse"] > 0, f"bvh frame launched {counts}")
    fresh, _ = _refit_system(work, t_state, _sphere_move(REFIT_FRAMES))
    fresh.set_setting("intersector", "bvh")
    b = fresh.render_frame(status=RenderStatus.RESET, samples=2)
    del fresh
    rmse = _rmse(a, b)
    print(f"phase 8: bvh deformation update {upd:.1f} ms, of which the host "
          f"refit (refit_deformed, host clock) {spans[-1]:.1f} ms; 2 spp at "
          f"1080p vs a fresh build: RMSE {rmse:.6g} (bar 2e-3), max abs "
          f"difference {float(np.abs(a - b).max()):.6g}; launches {counts}")
    _check(rmse < 2e-3, f"host refit frame RMSE {rmse} >= 2e-3")


def phase_megakernel(frame_visit, png, profile):
    """Phase 9: the megakernel slice at 1080p (phase 5's scene, camera
    and samples), then BASELINE config 1 (direct, Cornell, 512², 1 spp).
    Returns the slice's launches."""
    import torch
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.render import RenderStatus
    from rfw_tpu_torch.system import RenderSystem
    rs = RenderSystem("megakernel", RenderConfig(), device="cuda")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        n_tris = build_slice_scene(rs, work)
        rs.synchronize()
        print(f"phase 9: scene of {n_tris} triangles loaded and built in "
              f"{time.perf_counter() - t0:.1f} s")
    launches, frame = phase_slice(rs, n_tris, "phase 9", png, profile,
                                  ("traverse",))
    _check(launches["enum"] == 0 and launches["visit"] == 0,
           f"the megakernel slice launched visit-list kernels: {launches}")
    rmse = _rmse(frame, frame_visit)
    print(f"phase 9: megakernel frame vs phase 5's visit frame: RMSE "
          f"{rmse:.6g} (bar 2e-3), max abs difference "
          f"{float(np.abs(frame - frame_visit).max()):.6g}")
    _check(rmse < 2e-3, f"megakernel slice frame RMSE {rmse} >= 2e-3")
    del rs
    torch.cuda.empty_cache()

    # the same scene, camera and samples through the compacted driver on
    # the bvh intersector
    rs = RenderSystem("wavefront", RenderConfig(), device="cuda")
    rs.set_setting("intersector", "bvh")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        build_slice_scene(rs, work)
        rs.synchronize()
        print(f"phase 9: wavefront on bvh: scene built in "
              f"{time.perf_counter() - t0:.1f} s")
    launches_w, frame_w = phase_slice(rs, n_tris, "phase 9 wavefront/bvh",
                                      None, False, ("traverse",))
    _check(launches_w["enum"] == 0 and launches_w["visit"] == 0,
           f"wavefront on bvh launched visit-list kernels: {launches_w}")
    rmse = _rmse(frame_w, frame)
    per = SLICE_WINDOWS * WINDOW_SAMPLES
    print(f"phase 9: wavefront on bvh: {launches_w['traverse'] / per:.2f} "
          f"traverse launches a sample (megakernel "
          f"{launches['traverse'] / per:.2f}); frame vs the megakernel "
          f"frame: RMSE {rmse:.6g} (bar 2e-3), max abs difference "
          f"{float(np.abs(frame_w - frame).max()):.6g}")
    _check(rmse < 2e-3, f"wavefront-on-bvh frame RMSE {rmse} >= 2e-3")
    del rs
    torch.cuda.empty_cache()

    frames = {}
    for name in ("direct", "megakernel"):
        rs = make_cornell(RenderSystem(name, RenderConfig(), device="cuda"),
                          512)
        times = []
        for _ in range(6):                  # the first one warms up
            t0 = time.perf_counter()
            frames[name] = rs.render_frame(status=RenderStatus.RESET,
                                           samples=1)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"phase 9: BASELINE config 1 scene (Cornell, 512x512, 1 spp) "
              f"through {name}: median frame {float(np.median(times[1:])):.2f}"
              f" ms over 5 (synced), frame mean "
              f"{float(frames[name].mean()):.6g}")
    d, m = frames["direct"], frames["megakernel"]
    _check(d.shape == (512, 512, 3) and bool(np.isfinite(d).all())
           and float(d.mean()) > 0.01, "direct frame not finite/non-black")
    _check(float(m.mean()) > float(d.mean()),
           "direct frame not darker than megakernel's")
    return launches


TLAS_MOVES = 8
VISIT_LIST = ("enum", "visit", "expand", "tvisit")
TLAS_KERNELS = ("tlas_premask", "tlas_walk")


def _tlas_system(work, moves=0):
    """Phase 10's system on ``build_instanced_scene``, with sphere 7
    moved ``moves`` times by ``_tlas_move``; not yet synchronised."""
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.system import RenderSystem
    rs = RenderSystem("wavefront", RenderConfig(), device="cuda")
    n_tris, spheres = build_instanced_scene(rs, work)
    for i in range(moves):
        _tlas_move(spheres, i)
    return rs, n_tris, spheres


def _tlas_move(spheres, i: int) -> None:
    """The i-th move: sphere 7 lifted and pushed sideways."""
    spheres[7].translate((0.15, 0.1 + 0.02 * i, -0.05))


# the share of a stream's lanes on which the tlas and bvh intersectors
# may part: both test the same triangles, tlas in object space, so they
# part only where rounding decides a hit (a silhouette, a shared edge)
TLAS_APART = 2e-5


def _premask_equal(a, b) -> bool:
    """Two premask results (cross, tn_min, lanes, n_lanes) equal: cross,
    tn_min bit for bit, the walking lanes (the first n_lanes entries of
    lanes) as a sorted set, the list a permutation of the rays."""
    import torch
    k, n = int(a[3]), a[2].shape[0]
    return (torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
            and torch.equal(a[3], b[3])
            and torch.equal(a[2][:k].sort().values, b[2][:k])
            and torch.equal(a[2].sort().values,
                            torch.arange(n, dtype=torch.int32,
                                         device=a[2].device)))


class _TlasLaunches:
    """While entered, wraps bvh.tlas's two kernel wrappers (``premask``
    and ``walk_group``, which ``walk`` calls BLAS by BLAS) and keeps each
    launch's inputs and output, keyed by (``label``, BLAS group), for the
    comparison with the plain versions after the run. Nothing is read to
    the host while entered."""

    def __init__(self):
        self.label = None
        self.premask, self.walk = {}, {}

    def __enter__(self):
        from rfw_tpu_torch.bvh import tlas
        self.orig = (tlas.premask, tlas.walk_group)
        launch_p, launch_w = self.orig
        self.groups = {}

        def premask_held(lo, hi, o, d, best_t, t_epsilon, orig=None,
                         ray_chunk=65536):
            out = launch_p(lo, hi, o, d, best_t, t_epsilon, orig, ray_chunk)
            g = self.groups.setdefault(id(lo), len(self.groups))
            self.premask[(self.label, g)] = (
                (lo, hi, o, d, best_t, t_epsilon, orig), out)
            return out

        def walk_held(rows, o, d, state, order, count, lanes, n_lanes,
                      t_epsilon, any_hit=False):
            out = launch_w(rows, o, d, state, order, count, lanes, n_lanes,
                           t_epsilon, any_hit)
            g = self.groups[id(rows["inst_bmin"])]
            self.walk[(self.label, g)] = (
                (rows, o, d, state, order, count, lanes, n_lanes, t_epsilon,
                 any_hit), out)
            return out

        tlas.premask, tlas.walk_group = premask_held, walk_held
        return self

    def __exit__(self, *exc):
        from rfw_tpu_torch.bvh import tlas
        tlas.premask, tlas.walk_group = self.orig


def _tlas_walk_bound(args, out, stats) -> dict:
    """tlas_walk_kernel's bound on one launch, from the work its plain
    version counted for the rays on the premask's list (the rays that
    walk): FLOP of their box tests of the touched instances, the
    transforms into object space and the walks' box and triangle tests;
    bytes of every ray's state in (16 B), out (16 B) and list entry (4
    B), the listed rays' origin and direction (24 B), the list's length,
    the group's rows (boxes, matrix, base: 92 B an instance, and its
    order entry), the distinct nodes (128 B) and triangles (36 B) the
    walks read and the prim_order entry of each distinct hit.
    ``walks_ms`` is the bound without the box tests, as if every culling
    test were free; ``every_ray_ms`` the bound of a thread a ray over
    every ray (the design before the list): the box tests of every ray
    and 56 B of every ray in and out, the fixed yardstick of the two
    designs."""
    import torch
    rows, o, _, state = args[:4]
    n, k = o.shape[0], rows["inst_base"].shape[0]
    listed = int(stats["walked"].sum())
    changed = out[1] != state[1]
    hits = int(torch.unique(out[1][changed]).numel())
    walks_flop = (stats["walks"] * float(FLOP_PER_XFORM)
                  + stats.get("visits", 0) * 4.0 * FLOP_PER_BOX
                  + stats.get("tests", 0) * float(FLOP_PER_MT))
    nodes = int(stats["node_seen"].sum()) if "node_seen" in stats else 0
    tris = int(stats["tri_seen"].sum()) if "tri_seen" in stats else 0
    shared = 96.0 * k + 4.0 + 128.0 * nodes + 36.0 * tris + 4.0 * hits
    nbytes = 36.0 * n + 24.0 * listed + 4.0 + shared
    every_ray = _bound(stats["box_tests_every_ray"] * float(FLOP_PER_BOX)
                       + walks_flop, 56.0 * n + shared)
    return {**_bound(stats["box_tests"] * float(FLOP_PER_BOX) + walks_flop,
                     nbytes),
            "nodes": nodes, "tris": tris,
            "walks_ms": _bound(walks_flop, nbytes)["bound_ms"],
            "every_ray_ms": every_ray["bound_ms"]}


def _lanes_walked(lanes, n_lanes, walked) -> bool:
    """The kernel's list of walking lanes (its first ``n_lanes`` entries
    of ``lanes``) as a sorted set equals the rays the plain walk walked
    (``walk_group_ref``'s ``stats["walked"]``)."""
    import torch
    k = int(n_lanes)
    return torch.equal(lanes[:k].sort().values.long(),
                       walked.nonzero()[:, 0])


def _tlas_ptxas() -> None:
    """The two tlas kernels' ptxas lines (phase 2 fails the run on a
    spill) and resident blocks per SM."""
    from rfw_tpu_torch.bvh import tlas
    from rfw_tpu_torch.ops import cuda_lib
    ptxas = cuda_lib.ptxas_report(cuda_lib.build_log)
    blocks = tlas.occupancy()
    for k in TLAS_KERNELS:
        p = ptxas.get(f"{k}_kernel", {})
        print(f"phase 10: {k}_kernel ptxas: {p.get('registers')} registers, "
              f"{p.get('smem')} B shared memory, {p.get('stack')} B stack "
              f"frame, {p.get('spill_stores')}/{p.get('spill_loads')} B "
              f"spill stores/loads; {blocks[k]} resident blocks per SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")


def _tlas_kernels(held, streams, spheres, eps, timed) -> dict:
    """Each held premask and walk launch against its plain version, bit
    for bit (cross, tn_min and the list of walking lanes as a sorted set;
    t, orig, u and v), the list against the lanes the plain walk walked,
    with the walk's lanes that walked (live) and those every box culled,
    and each launch's device time; the launches of the ``timed`` stream
    also timed one launch at a time beside their plain version and
    bound. Returns the report of each kernel on the timed stream's
    spheres group."""
    import torch
    from rfw_tpu_torch.bvh import tlas
    _tlas_ptxas()
    report = {"tlas_premask": {"err": 0.0}, "tlas_walk": {"err": 0.0}}
    culled_live = set()
    for (name, g), (args, out_k) in sorted(held.premask.items()):
        lo, hi, o, d, best_t, t_eps, orig = args
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out_p = tlas.premask_ref(lo, hi, o, tlas.safe_inv_box_dir(d), best_t,
                                 t_eps, orig)
        b.record()
        torch.cuda.synchronize()
        _check(_premask_equal(out_k, out_p),
               f"tlas premask kernel != premask_ref on the {name} launch of "
               f"BLAS {g}")
        report["tlas_premask"]["err"] = max(
            report["tlas_premask"]["err"],
            float((out_k[1] - out_p[1]).abs().max()))
        n, k = o.shape[0], lo.shape[0]

        def kernel():
            return tlas.premask(lo, hi, o, d, best_t, t_eps, orig)

        ms_d = _device_ms(kernel)
        line = (f"phase 10: tlas_premask vs premask_ref on the {name} launch "
                f"of BLAS {g} ({k} instances, {n} lanes): "
                f"{int(out_k[0].sum())} crossed, {int(out_k[3])} lanes "
                f"listed (plain {int(out_p[3])}); equal bit for bit, the "
                f"list as a sorted set; device {ms_d:.4f} ms")
        if name == timed:
            ms_p = a.elapsed_time(b)
            ms_k = _median_ms(kernel)
            # bytes: a ray's origin, direction, best t (and any hit's
            # orig) in and its list entry out, an instance's box in and
            # cross and tn_min out, the list's two ends
            pb = _bound(float(n) * k * FLOP_PER_BOX + 3.0 * n,
                        (32.0 if orig is None else 36.0) * n + 32.0 * k
                        + 8.0)
            line += (f"; kernel {ms_k:.4f} ms (one launch, median of 5), "
                     f"plain {ms_p:.1f} ms (one run), "
                     f"bound {pb['bound_ms']:.5f} ms ({pb['bound_by']}, "
                     f"{pb['flop']:.4g} FLOP, {pb['bytes']:.0f} B), share "
                     f"of bound {pb['bound_ms'] / ms_k:.4f} (device "
                     f"{pb['bound_ms'] / ms_d:.4f})")
            if g == spheres:
                report["tlas_premask"].update(ms=ms_k, device_ms=ms_d,
                                              plain_ms=ms_p, **pb)
        print(line)
    for (name, g), (args, out_k) in sorted(held.walk.items()):
        rows, o, d, state, order, count, lanes, n_lanes, t_eps, any_hit = args
        stats = {}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out_p = tlas.walk_group_ref(rows, o, d, state, order, count, t_eps,
                                    any_hit, stats=stats)
        b.record()
        torch.cuda.synchronize()
        _check(_bits_equal(out_k, out_p),
               f"tlas walk kernel != walk_group_ref on the {name} launch of "
               f"BLAS {g}")
        _check(_lanes_walked(lanes, n_lanes, stats["walked"]),
               f"tlas premask's list != the lanes walk_group_ref walked on "
               f"the {name} launch of BLAS {g}")
        report["tlas_walk"]["err"] = max(
            report["tlas_walk"]["err"],
            float((out_k[0] - out_p[0]).abs().max()))
        n = o.shape[0]
        live = int(stats["walked"].sum())
        if 0 < live < n:
            culled_live.add((name, g))

        def kernel():
            return tlas.walk_group(rows, o, d, state, order, count, lanes,
                                   n_lanes, t_eps, any_hit)

        ms_d = _device_ms(kernel)
        line = (f"phase 10: tlas_walk vs walk_group_ref on the {name} launch "
                f"of BLAS {g} ({rows['tri_table'].shape[0]} triangles, "
                f"{'any' if any_hit else 'closest'} hit): {n} lanes, "
                f"{int(count)} touched instances, {int(n_lanes)} lanes "
                f"listed, {live} lanes walked in the plain version (the "
                f"same set), {n - live} culled by every box, "
                f"{stats['walks']} walks, "
                f"{int((out_k[1] != state[1]).sum())} lanes with a new hit; "
                f"equal bit for bit; device {ms_d:.4f} ms")
        if name == timed:
            ms_p = a.elapsed_time(b)
            ms_k = _median_ms(kernel)
            wb = _tlas_walk_bound(args, out_k, stats)
            line += (f"; kernel {ms_k:.4f} ms (one launch, median of 5), "
                     f"plain {ms_p:.1f} ms (one run), "
                     f"bound {wb['bound_ms']:.5f} ms ({wb['bound_by']}, "
                     f"{wb['bytes']:.0f} B, {stats['box_tests']} box tests "
                     f"of the listed rays, "
                     f"{stats['walks']} transforms, "
                     f"{stats.get('visits', 0)} node visits of "
                     f"{wb['nodes']} distinct nodes, {stats.get('tests', 0)} "
                     f"triangle tests of {wb['tris']} distinct triangles; "
                     f"{wb['half_ms']:.5f} ms at the unfused half rate; "
                     f"the walks alone {wb['walks_ms']:.5f} ms; a thread "
                     f"a ray over every ray, {stats['box_tests_every_ray']} "
                     f"box tests, {wb['every_ray_ms']:.5f} ms), "
                     f"share of bound {wb['bound_ms'] / ms_k:.4f} (device "
                     f"{wb['bound_ms'] / ms_d:.4f}); longest walk "
                     f"{stats.get('longest', 0)} nodes")
            if g == spheres:
                report["tlas_walk"].update(ms=ms_k, device_ms=ms_d,
                                           plain_ms=ms_p, **wb)
        print(line)
    groups = {g for _, g in held.walk}
    _check(set(held.premask) == set(held.walk)
           and all({g for name_, g in held.walk if name_ == name} == groups
                   for name in streams),
           f"tlas launches held: premask {sorted(held.premask)}, walk "
           f"{sorted(held.walk)}")
    _check(all((name, spheres) in culled_live
               for name in ("bounce", "shadow")),
           f"no tlas walk launch with culled and live lanes on the spheres' "
           f"BLAS in the bounce or the shadow stream: {sorted(culled_live)}")
    return report


def _tlas_made_up(held, spheres, eps) -> None:
    """The two tlas kernels on made-up inputs from the spheres' bounce
    launch (``utils/synthetic.py::tlas_cases``): each case's premask,
    visit order and walk through the kernels against premask_ref and
    walk_group_ref, bit for bit, the list against the lanes the plain
    walk walked, and the case's own property: every box crossed at entry
    0 and no dead lane listed (dead lanes inside boxes), every lane
    listed (all live), none listed and no box crossed (none crossing), no
    hit on the coincident twin (closest and any hit); each kernel's
    device time."""
    import torch
    from rfw_tpu_torch.bvh import tlas
    args, _ = held.walk[("bounce", spheres)]
    rows, o, d, state = args[:4]
    dev = o.device
    cases = synthetic.tlas_cases(
        *(x.cpu().numpy() for x in (rows["inst_bmin"], rows["inst_bmax"], o,
                                    d, state[0])), seed=SEED)
    n, k = o.shape[0], rows["inst_base"].shape[0]
    for name, (o_n, d_n, t_n, any_hit, twin) in cases.items():
        # a dead lane's direction may be anything; every lane of all_live
        # needs a finite one
        d_n = np.where(np.isfinite(d_n).all(-1, keepdims=True), d_n,
                       np.float32([0.0, 0.0, 1.0]))
        o2, d2, t2 = (torch.from_numpy(x).to(dev) for x in (o_n, d_n, t_n))
        rows2 = dict(rows)
        if twin:
            for key in ("inst_inv", "inst_bmin", "inst_bmax"):
                rows2[key] = rows[key].clone()
                rows2[key][1] = rows[key][0]
        lo, hi = rows2["inst_bmin"], rows2["inst_bmax"]
        st = tlas.start_state(o2, t2)
        orig = st[1] if any_hit else None

        def premask():
            return tlas.premask(lo, hi, o2, d2, st[0], eps, orig)

        pm = premask()
        order, count = tlas.visit_order(pm[0], pm[1])

        def walk():
            return tlas.walk_group(rows2, o2, d2, st, order, count, pm[2],
                                   pm[3], eps, any_hit)

        out = walk()
        pm_p = tlas.premask_ref(lo, hi, o2, tlas.safe_inv_box_dir(d2), st[0],
                                eps, orig)
        stats = {}
        out_p = tlas.walk_group_ref(rows2, o2, d2, st, order, count, eps,
                                    any_hit, stats=stats)
        torch.cuda.synchronize()
        _check(_premask_equal(pm, pm_p),
               f"tlas premask kernel != premask_ref on made-up {name}")
        _check(_bits_equal(out, out_p),
               f"tlas walk kernel != walk_group_ref on made-up {name}")
        _check(_lanes_walked(pm[2], pm[3], stats["walked"]),
               f"tlas premask's list != the walked lanes on made-up {name}")
        listed, crossed = int(pm[3]), int(pm[0].sum())
        if name == "dead_inside":
            dead = (t2 == 0).nonzero()[:, 0]
            ok = (crossed == k and bool((pm[1] == 0).all())
                  and not torch.isin(pm[2][:listed].long(), dead).any())
        elif name == "all_live":
            ok = listed == n
        elif name == "none_cross":
            ok = listed == 0 and crossed == 0
        else:
            base = int(rows2["inst_base"][1])
            n_tri = rows2["tri_table"].shape[0]
            ok = not bool(((out[1] >= base) & (out[1] < base + n_tri)).any())
        _check(ok, f"made-up {name}: its property does not hold (listed "
               f"{listed}, crossed {crossed})")
        hits = int((out[1] >= 0).sum())
        print(f"phase 10: made-up {name} on the spheres' bounce rays "
              f"({'any' if any_hit else 'closest'} hit): {crossed} of {k} "
              f"instances crossed, {listed} of {n} lanes listed, "
              f"{int(stats['walked'].sum())} walked in the plain version, "
              f"{stats['walks']} walks, {hits} lanes hit; premask and walk "
              f"equal their plain versions bit for bit; device premask "
              f"{_device_ms(premask):.4f} ms, walk {_device_ms(walk):.4f} ms")


def tlas_launches(rs):
    """The tlas intersector's calls on the main path's chunk-0 streams
    (``_streams``: primary and bounce closest hit, the depth-0 shadow
    launch any hit) with the two tlas kernels' launches caught
    (``_TlasLaunches``); the launch counts are reset just before those
    calls. Returns (scene, streams, run, held, results, spheres):
    ``run(name, o, d, t_max)`` makes a stream's call, and spheres is the
    BLAS group with the most instances."""
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.render.intersectors import make_intersector
    scene, streams, _ = _streams(rs)
    tlas = make_intersector("tlas", rs.config)
    blas = scene["tlas"]["blas"]
    spheres = max(range(len(blas)), key=lambda i: blas[i]["inst_base"]
                  .shape[0])

    def run(name, o, d, tm):
        return (tlas.occluded(scene, o, d, tm) if name == "shadow"
                else tlas.closest(scene, o, d, tm))

    results = {}
    cuda_lib.reset_launch_counts()
    with _TlasLaunches() as held:
        for name, (o, d, tm) in streams.items():
            held.label = name
            results[name] = run(name, o, d, tm)
    return scene, streams, run, held, results, spheres


def _tlas_against_bvh(rs) -> dict:
    """The tlas intersector on the main path's chunk-0 streams (primary
    and bounce closest hit, the depth-0 shadow launch any hit), with the
    two tlas kernels' launches caught: every BLAS group's premask launch
    against premask_ref and its walk launch against walk_group_ref on the
    same tensors, bit for bit, the bounce chunk's timed. The spheres'
    BLAS (60 instances) must have a walk launch with culled and live
    lanes in the bounce (closest hit) and the shadow (any hit) stream;
    chunk 0's primary rays, the top of the image, touch no sphere. Then
    one intersector call of each kind under
    torch.cuda.set_sync_debug_mode("error"): nothing may be read to the
    host. Then the tlas results against the bvh intersector's on the
    same rays: per stream at most ``TLAS_APART`` of the lanes hit (or
    are occluded) in one only or on another triangle, and where both hit
    one triangle their t is apart by less than 1e-4 relative
    (tests/test_visit.py's bar). Returns the two kernels' reports."""
    import torch
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.render.intersectors import make_intersector
    cfg = rs.config
    bvh = make_intersector("bvh", cfg)
    scene, streams, run, held, results, spheres = tlas_launches(rs)
    blas = scene["tlas"]["blas"]
    counts = dict(cuda_lib.launch_counts)
    want = {k: (len(blas) * len(streams)
                if k in ("tlas_premask", "tlas_walk") else 0) for k in counts}
    _check(counts == want, f"tlas calls on the chunk-0 streams launched "
           f"{counts}, expected {want}")
    report = _tlas_kernels(held, streams, spheres, float(cfg.t_epsilon),
                           "bounce")
    _tlas_made_up(held, spheres, float(cfg.t_epsilon))

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name in ("bounce", "shadow"):
            again = run(name, *streams[name])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _check(torch.equal(again, results["shadow"]),
           "the shadow call under the sync check gave another result")
    print("phase 10: tlas closest (bounce) and occluded (shadow) calls ran "
          "under torch.cuda.set_sync_debug_mode(\"error\"): no host sync")

    for name, (o, d, tm) in streams.items():
        bar = TLAS_APART * o.shape[0]
        if name == "shadow":
            occ = bvh.occluded(scene, o, d, tm)
            apart = int((results[name] != occ).sum())
            print(f"phase 10: tlas vs bvh on the {name} launch: {apart} of "
                  f"{o.shape[0]} lanes occluded in one only (bar "
                  f"{bar:.1f})")
            _check(apart <= bar, f"tlas and bvh part on {apart} {name} "
                   f"lanes")
            continue
        t_a, p_a, _, _ = results[name]
        t_b, p_b, _, _ = bvh.closest(scene, o, d, tm)
        both = (p_a >= 0) & (p_b >= 0)
        one_only = int(((p_a >= 0) != (p_b >= 0)).sum())
        other = int((p_a != p_b)[both].sum())
        same = both & (p_a == p_b)
        rel = ((t_a - t_b).abs() / t_b.abs().clamp(min=1e-6))[same]
        rel_max = float(rel.max()) if rel.numel() else 0.0
        print(f"phase 10: tlas vs bvh on the {name} chunk: {one_only} of "
              f"{o.shape[0]} lanes hit in one only; of {int(both.sum())} "
              f"hit in both, {other} on another triangle (bar {bar:.1f} "
              f"each); on the same triangle relative t apart by at most "
              f"{rel_max:.3g} (bar 1e-4)")
        _check(one_only <= bar and other <= bar and rel_max < 1e-4,
               f"tlas and bvh part on the {name} chunk: {one_only} lanes "
               f"hit in one only, {other} on another triangle, relative t "
               f"{rel_max}")
    torch.cuda.synchronize()
    return report


def phase_tlas(png, profile):
    """Phase 10: the instanced slice on the tlas intersector at 1080p.
    The same system renders 4 spp on bvh, then on tlas (a full build
    with the BLASes), and the two frames must agree; then the two tlas
    kernels are held to their plain versions on the chunk-0 streams
    (``_tlas_against_bvh``); then the tlas slice is timed as phase 5
    (the two tlas kernels must launch, no traverse and no visit-list
    kernel) with the tlas launches per sample and the touched instances
    per intersector call; then a 1-spp frame raw and denoised against
    the slice's converged frame, and FXAA; then 8 moves of one sphere,
    which must refresh the instance tables without a full build and
    render like a fresh build. Returns the slice's launches, with the
    re-transform kernel's in the moves under ``retransform``, and the two
    tlas kernels' reports (times, bounds, largest kernel-plain
    difference of t)."""
    import torch
    import rfw_tpu_torch.render.engines as engines
    import rfw_tpu_torch.render.scene_data as sd
    from rfw_tpu_torch.ops import cuda_lib, tonemap
    from rfw_tpu_torch.render import RenderStatus

    builds, blas_s, moves_seen = [0], [], [0]
    build, tables, retransform = (sd.build_device_scene,
                                  sd._build_tlas_tables,
                                  sd.move_instances_device)

    def counted_build(*a, **kw):
        builds[0] += 1
        return build(*a, **kw)

    def timed_tables(*a, **kw):
        t0 = time.perf_counter()
        out = tables(*a, **kw)
        blas_s.append(time.perf_counter() - t0)
        return out

    def counted_retransform(*a, **kw):
        moves_seen[0] += 1
        return retransform(*a, **kw)

    def frame(rs, spp):
        return rs.render_frame(status=RenderStatus.RESET, samples=spp)

    sd._build_tlas_tables = timed_tables
    try:
        with tempfile.TemporaryDirectory() as work:
            rs, n_tris, spheres = _tlas_system(work)
            rs.set_setting("intersector", "bvh")
            t0 = time.perf_counter()
            rs.synchronize()
            torch.cuda.synchronize()
            flat_s = time.perf_counter() - t0
            frame_bvh = frame(rs, 4)
            rs.set_setting("intersector", "tlas")
            t0 = time.perf_counter()
            rs.context.update()          # the switch builds in full
            torch.cuda.synchronize()
            tlas_s = time.perf_counter() - t0
            tl = rs.context._geo["tlas"]
            n_inst = sum(b["inst_base"].shape[0] for b in tl["blas"])
            print(f"phase 10: {n_tris} world triangles as {len(tl['blas'])} "
                  f"BLASes under {n_inst} instances; build on bvh "
                  f"{flat_s:.2f} s, on tlas {tlas_s:.2f} s (the flat tables "
                  f"and the BLASes; BLASes and instance tables "
                  f"{blas_s[-1]:.2f} s)")
            _check(len(tl["blas"]) == 3 and n_inst == 62,
                   "phase 10: the TLAS is not 3 BLASes under 62 instances")
            frame_tlas = frame(rs, 4)
            rmse = _rmse(frame_tlas, frame_bvh)
            diff = np.abs(frame_tlas - frame_bvh).max(-1)
            print(f"phase 10: tlas frame vs bvh frame, 4 spp: RMSE "
                  f"{rmse:.6g} (bar 2e-3), max abs difference "
                  f"{float(diff.max()):.6g}; pixels apart by more than "
                  f"1e-2: {int((diff > 1e-2).sum())}, by more than 1e-5: "
                  f"{int((diff > 1e-5).sum())} of {diff.size}")
            _check(rmse < 2e-3, f"tlas frame RMSE {rmse} >= 2e-3")
            report = _tlas_against_bvh(rs)

            launches, converged = phase_slice(rs, n_tris, "phase 10", png,
                                              profile, TLAS_KERNELS)
            _check(all(launches[k] == 0 for k in ("traverse", *VISIT_LIST)),
                   f"the tlas slice launched traverse or visit-list kernels: "
                   f"{launches}")
            phase_depth_split(rs, "phase 10")
            # the touched instances of each intersector call: the sum of
            # its walk launches' counts, read after the frame; each call
            # launches one premask and one walk a BLAS group
            from rfw_tpu_torch.bvh import tlas as tlas_mod
            drv = rs.context._driver
            n_groups = len(tl["blas"])
            isect, calls, all_occluded = drv._intersector, [], []
            walk_group, counts = tlas_mod.walk_group, []

            def counting_walk(rows, o, d, state, order, count, *a, **kw):
                counts.append(count)
                return walk_group(rows, o, d, state, order, count, *a, **kw)

            def counted(fn):
                def run(*a, **kw):
                    n0 = (len(counts), cuda_lib.launch_counts["tlas_premask"],
                          cuda_lib.launch_counts["tlas_walk"])
                    out = fn(*a, **kw)
                    calls.append((n0, (
                        len(counts), cuda_lib.launch_counts["tlas_premask"],
                        cuda_lib.launch_counts["tlas_walk"])))
                    if fn is isect.occluded:
                        # when rfw_tpu's any-hit loop could stop early
                        all_occluded.append(bool(out.all()))
                    return out
                return run

            drv._intersector = isect._replace(
                closest=counted(isect.closest),
                occluded=counted(isect.occluded))
            tlas_mod.walk_group = counting_walk
            try:
                rs.render_frame(status=RenderStatus.CONVERGE, samples=1)
            finally:
                drv._intersector = isect
                tlas_mod.walk_group = walk_group
            touched = torch.cat(counts).tolist()
            per_call = [sum(touched[a[0]:b[0]]) for a, b in calls]
            _check(all(b[i] - a[i] == n_groups for a, b in calls
                       for i in range(3)),
                   f"an intersector call did not launch one premask and one "
                   f"walk a BLAS group: {calls}")
            per = SLICE_WINDOWS * WINDOW_SAMPLES
            print(f"phase 10: {launches['tlas_premask'] / per:.2f} "
                  f"tlas_premask and {launches['tlas_walk'] / per:.2f} "
                  f"tlas_walk launches a sample ({n_groups} BLAS groups a "
                  f"call); touched instances an intersector call (the walk "
                  f"launches' counts): mean {float(np.mean(per_call)):.2f}, "
                  f"max {max(per_call)} over {len(per_call)} calls of one "
                  f"sample; occlusion calls with every lane occluded "
                  f"{sum(all_occluded)} of {len(all_occluded)}")

            # denoise and FXAA on a 1-spp frame of the same view
            raw = frame(rs, 1)
            rs.set_setting("denoise", "1")
            spans, denoise = [], engines.atrous_denoise

            def timed_denoise(*a, **kw):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = denoise(*a, **kw)
                ev[1].record()
                spans.append(ev)
                return out

            engines.atrous_denoise = timed_denoise
            try:
                denoised = frame(rs, 1)
            finally:
                engines.atrous_denoise = denoise
            rs.set_setting("denoise", "0")
            dn_ms = spans[0][0].elapsed_time(spans[0][1])
            r_raw, r_dn = _rmse(raw, converged), _rmse(denoised, converged)
            print(f"phase 10: denoise {dn_ms:.2f} ms at 1920x1080 (CUDA "
                  f"events); 1-spp frame vs the converged frame "
                  f"({1 + per} samples): RMSE raw {r_raw:.6g}, denoised "
                  f"{r_dn:.6g}")
            _check(len(spans) == 1 and r_dn < r_raw,
                   "the denoised frame is not closer to the converged one")
            t0 = time.perf_counter()
            ldr = rs.tonemap_frame(denoised, fxaa=True)
            fx_wall = (time.perf_counter() - t0) * 1e3
            ldr_t = tonemap.tonemap(torch.as_tensor(denoised,
                                                    device=rs.device),
                                    rs.camera.brightness, rs.camera.contrast)
            fx_ms = _median_ms(lambda: tonemap.fxaa(ldr_t))
            print(f"phase 10: tonemap_frame(fxaa=True) {fx_wall:.1f} ms "
                  f"(host clock, with the copy to the host); fxaa "
                  f"{fx_ms:.2f} ms at 1920x1080 (CUDA events, median of 5)")
            _check(ldr.shape == (1080, 1920, 3)
                   and bool(np.isfinite(ldr).all())
                   and float(ldr.min()) >= 0.0 and float(ldr.max()) <= 1.0,
                   "FXAA output not finite or outside [0, 1]")

            # instance moves: the instance tables only, no full build
            sd.build_device_scene = counted_build
            sd.move_instances_device = counted_retransform
            launched = cuda_lib.launch_counts["retransform"]
            updates = []
            for i in range(TLAS_MOVES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _tlas_move(spheres, i)
                rs.synchronize()
                torch.cuda.synchronize()
                updates.append((time.perf_counter() - t0) * 1e3)
            sd.build_device_scene = build
            sd.move_instances_device = retransform
            launched = cuda_lib.launch_counts["retransform"] - launched
            launches["retransform"] = launched
            print(f"phase 10: {TLAS_MOVES} moves of one sphere: median "
                  f"update {float(np.median(updates)):.1f} ms (host clock, "
                  f"synced), updates {[round(u, 1) for u in updates]} ms; "
                  f"{builds[0]} full builds, {moves_seen[0]} device moves, "
                  f"{launched} re-transform launches")
            _check(builds[0] == 0 and moves_seen[0] == launched == TLAS_MOVES,
                   f"tlas moves: {builds[0]} full builds, {moves_seen[0]} "
                   f"device moves, {launched} launches in {TLAS_MOVES} "
                   f"moves")
            moved = frame(rs, 2)
            del rs
            torch.cuda.empty_cache()
            fresh, _, _ = _tlas_system(work, TLAS_MOVES)
            fresh.set_setting("intersector", "tlas")
            want = frame(fresh, 2)
            del fresh
            rmse = _rmse(moved, want)
            print(f"phase 10: moved frame vs a fresh tlas build, 2 spp: RMSE "
                  f"{rmse:.6g} (bar 2e-3), max abs difference "
                  f"{float(np.abs(moved - want).max()):.6g}")
            _check(rmse < 2e-3, f"moved tlas frame RMSE {rmse} >= 2e-3")
    finally:
        sd.build_device_scene, sd._build_tlas_tables = build, tables
        sd.move_instances_device = retransform
    return launches, report


# bytes a triangle of the re-transform: its map entries (row, prim) and
# the two 32 B sectors of its pack row that hold the columns it keeps
# read (the other two sectors hold only columns it writes anew), its
# planes, triangle table and pack row written
RETRANSFORM_BYTES = 8 + 64 + 36 + 36 + 36 + 4 + 48 + 128


def retransform_args(case, device) -> tuple:
    """``scene_data.retransform``'s arguments from a
    ``synthetic.retransform_case`` on ``device``."""
    import torch
    import rfw_tpu_torch.render.scene_data as sd

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (on(case["row"]), on(case["prim"]), on(case["base"]),
            on(sd.instance_matrices(case["transforms"])),
            {k: on(case["obj"][k]) for k in sd.SLOT_PLANES},
            on(case["pack"]))


def phase_retransform(ptxas=None) -> dict:
    """The re-transform kernel of a tlas move on made-up inputs at the
    benchmark sphereflake's layout (``synthetic.retransform_case``, two
    seeds): bit for bit against ``retransform_ref`` on the same tensors
    and within 1e-6 of it on the CPU, its ptxas line, one launch (CUDA
    events) and its device time beside the bytes bound and the plain
    version's time. Returns its report."""
    import torch
    import rfw_tpu_torch.render.scene_data as sd
    from rfw_tpu_torch.ops import cuda_lib

    for seed in (SEED, SEED + 1):
        case = synthetic.retransform_case(seed)
        n = case["row"].shape[0]
        on_card = retransform_args(case, "cuda")
        before = cuda_lib.launch_counts["retransform"]
        got = sd.retransform(*on_card)
        want = sd.retransform_ref(*on_card)
        on_cpu = sd.retransform_ref(*retransform_args(case, "cpu"))
        torch.cuda.synchronize()
        equal = all(torch.equal(got[k].view(torch.int32),
                                want[k].view(torch.int32))
                    for k in sd.MOVE_PLANES)
        cpu_err = max(float((got[k].cpu() - on_cpu[k]).abs().max())
                      for k in sd.MOVE_PLANES)
        print(f"phase 10: retransform kernel vs retransform_ref on the same "
              f"tensors, seed {seed}, {n} triangles of "
              f"{case['base'].shape[0]} instances: "
              f"{'equal bit for bit' if equal else 'DIFFERENT'}; the plain "
              f"version on the CPU: max abs difference {cpu_err:.3g}")
        _check(equal and cuda_lib.launch_counts["retransform"] == before + 1
               and cpu_err <= 1e-6, "retransform kernel != its plain version")
    p = (ptxas or cuda_lib.ptxas_report(cuda_lib.build_log)).get(
        "retransform_kernel", {})
    _check(p.get("spill_stores") == 0 and p.get("spill_loads") == 0,
           f"retransform_kernel: ptxas reports spills or no report ({p})")
    ms = _median_ms(lambda: sd.retransform(*on_card))
    plain_ms = _median_ms(lambda: sd.retransform_ref(*on_card))
    device_ms = _device_ms(lambda: sd.retransform(*on_card))
    bound_ms = RETRANSFORM_BYTES * n / PEAK_BYTES * 1e3
    print(f"phase 10: retransform_kernel: ptxas {p}; one launch {ms:.4f} "
          f"ms, device {device_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"(bytes: {RETRANSFORM_BYTES} B x {n} triangles at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s), share {bound_ms / ms:.3f} "
          f"({bound_ms / device_ms:.3f} device); plain version "
          f"{plain_ms:.2f} ms on the card")
    return {"err": 0.0, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes"}


# ---------------------------------------------------------------------------
# phase 5b: the NEE kernel
# ---------------------------------------------------------------------------

# bytes a lane of the NEE kernel reads and writes (csrc/nee_kernel.cu's
# note): 115 in, the seed and 41 a shadow ray out
NEE_BYTES_IN, NEE_BYTES_RAY = 115, 41
NEE_KERNELS = ("nee", "nee_add")


def _same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape equal bit for bit."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def nee_args(case, device) -> tuple:
    """``ops/nee.nee``'s scene and lanes from a ``synthetic.nee_case`` on
    ``device``: its lights and sky, the engine's blue-noise stack."""
    import torch
    from rfw_tpu_torch.ops import nee, rng

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lanes = case["lanes"]
    scene = {"lights": {k: on(v) for k, v in case["lights"].items()},
             "skybox": {k: on(v) for k, v in case["skybox"].items()},
             "blue_noise": on(rng.blue_noise_stack())}
    return scene, nee.NeeLanes(
        sd={k: on(v) for k, v in lanes["sd"].items()},
        **{k: on(v) for k, v in lanes.items() if k != "sd"})


def nee_against_plain(scene, config, lanes, width, height, depth,
                      sample_index) -> bool:
    """One launch of the NEE kernel against ``nee_plain`` (Disney) on the
    same tensors: every output and the counts equal bit for bit, and the
    radiance ``add_unoccluded`` makes of them under a made-up occlusion
    mask equal to its plain version's."""
    import torch
    from rfw_tpu_torch.ops import cuda_lib, nee
    from rfw_tpu_torch.ops.bsdf import disney
    st_k, st_p = {}, {}
    before = cuda_lib.launch_counts["nee"]
    got = nee.nee(scene, config, disney, lanes, width, height, depth,
                  sample_index, st_k)
    want = nee.nee_plain(scene, config, disney, lanes, width, height, depth,
                         sample_index, st_p)
    equal = cuda_lib.launch_counts["nee"] == before + 1 and all(
        _same_bits(a, b) for a, b in zip(got, want))
    equal &= st_k.keys() == st_p.keys() and all(
        int(st_k[k]) == int(st_p[k]) for k in st_k)
    g = torch.Generator(device=lanes.pid.device).manual_seed(depth)
    occ = torch.rand(want.want.shape, generator=g,
                     device=lanes.pid.device) < 0.3
    rad = torch.rand((lanes.pid.shape[0], 3), generator=g,
                     device=lanes.pid.device)
    equal &= _same_bits(nee.add_unoccluded(rad, got, occ),
                        nee.add_unoccluded_plain(rad, want, occ))
    return bool(equal)


class _HeldNee:
    """While entered, keeps the inputs of the first ``ops/nee.nee`` call of
    each depth (chunk 0) in ``held`` and of the first
    ``ops/extension.extend`` call after it in ``held_extend``, cloned."""

    def __enter__(self):
        from rfw_tpu_torch.ops import extension, nee
        self.held, self.held_extend, self.depth = {}, {}, None
        self.orig = (nee.nee, extension.extend)
        orig_nee, orig_extend = self.orig

        def held(scene, config, bsdf, lanes, width, height, depth,
                 sample_index, stats):
            self.depth = depth
            if depth not in self.held:
                self.held[depth] = (scene, config, _clone(lanes),
                                    width, height, depth, sample_index)
            return orig_nee(scene, config, bsdf, lanes, width, height, depth,
                            sample_index, stats)

        def held_extend(config, bsdf, lanes, seed, state):
            if self.depth not in self.held_extend:
                self.held_extend[self.depth] = (
                    config, _clone(lanes), seed.clone(), _clone(state))
            return orig_extend(config, bsdf, lanes, seed, state)
        nee.nee, extension.extend = held, held_extend
        return self

    def __exit__(self, *exc):
        from rfw_tpu_torch.ops import extension, nee
        nee.nee, extension.extend = self.orig
        return False


def phase_nee(rs, ptxas=None) -> dict:
    """The NEE kernel (phase 5b): on the 1080p slice's own depth-0 and
    bounce lanes of chunk 0 (518,400 each, caught from one sample of
    ``rs``) and on made-up lanes of ``synthetic.nee_case`` at the same
    layout (all four light types under importance and uniform picks,
    glass, the hashed pair past the blue-noise cutoff, the envmap
    interleaved and per lane, planted NaNs under ``debug_checks``), bit
    for bit against ``nee_plain``; its ptxas line; one launch (CUDA
    events), its device time, its bytes bound and the plain version's
    time on the depth-0 lanes; then phase 5c (``phase_extend``) on the
    extension calls caught in the same sample. Returns both reports."""
    import dataclasses
    import torch
    from rfw_tpu_torch.ops import cuda_lib, nee
    from rfw_tpu_torch.ops.bsdf import disney
    from rfw_tpu_torch.render import RenderStatus

    with _HeldNee() as h:
        rs.render_frame(status=RenderStatus.RESET, samples=1)
    torch.cuda.synchronize()
    held_extend = h.held_extend
    _check(0 in h.held and 1 in h.held, f"no depth-0 or depth-1 NEE call "
           f"caught ({sorted(h.held)})")
    for depth in (0, 1):
        scene, cfg, lanes, width, height, _, si = h.held[depth]
        equal = nee_against_plain(scene, cfg, lanes, width, height, depth,
                                  si)
        print(f"phase 5b: nee kernel vs nee_plain on the slice's depth-"
              f"{depth} lanes of chunk 0 ({lanes.pid.shape[0]} lanes): "
              f"{'equal bit for bit' if equal else 'DIFFERENT'}")
        _check(equal, f"nee kernel != nee_plain at depth {depth}")
    base = h.held[0][1]
    cases = (("all lights, importance", {}, {}, 0, 3),
             ("all lights, uniform", {}, {"importance_sample_lights": False},
              1, 3),
             ("lamps, glass, past the cutoff", {"lights": "lamps",
                                                "glass": 0.5}, {}, 0, 300),
             ("envmap per lane", {"order": "scattered"},
              {"env_nee_interleave": 1}, 0, 5),
             ("planted NaNs, debug_checks", {"nan_share": 0.01},
              {"debug_checks": True}, 0, 2))
    for label, case_kw, cfg_kw, depth, si in cases:
        cfg = dataclasses.replace(base, **cfg_kw)
        scene, lanes = nee_args(synthetic.nee_case(SEED + depth, 518_400,
                                                   **case_kw), "cuda")
        equal = nee_against_plain(scene, cfg, lanes, 1920, 1080, depth, si)
        print(f"phase 5b: nee kernel vs nee_plain, made-up lanes ({label}, "
              f"depth {depth}, sample {si}): "
              f"{'equal bit for bit' if equal else 'DIFFERENT'}")
        _check(equal, f"nee kernel != nee_plain ({label})")
    p = (ptxas or cuda_lib.ptxas_report(cuda_lib.build_log))
    for name in ("nee_kernel", "nee_add_kernel"):
        _check(p.get(name, {}).get("spill_stores") == 0
               and p.get(name, {}).get("spill_loads") == 0,
               f"{name}: ptxas reports spills or no report ({p.get(name)})")
    report = {}
    for depth in (0, 1):
        scene, cfg, lanes, width, height, _, si = h.held[depth]
        n = lanes.pid.shape[0]
        env = nee.env_nee_at(scene, cfg, depth)

        def kernel():
            return nee.nee(scene, cfg, disney, lanes, width, height, depth,
                           si, {})

        ms = _median_ms(kernel)
        device_ms = _device_ms(kernel)
        plain_ms = _median_ms(lambda: nee.nee_plain(
            scene, cfg, disney, lanes, width, height, depth, si, {}))
        nbytes = n * (NEE_BYTES_IN + 8 + NEE_BYTES_RAY * (2 if env else 1))
        bound_ms = nbytes / PEAK_BYTES * 1e3
        print(f"phase 5b: nee_kernel on the depth-{depth} lanes ({n}, "
              f"envmap {'on' if env else 'off'}): ptxas {p.get('nee_kernel')}"
              f"; one launch {ms:.4f} ms, device {device_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms (bytes: {nbytes / n:.0f} B x {n} lanes at "
              f"{PEAK_BYTES / 1e12:.2f} TB/s), share {bound_ms / ms:.3f} "
              f"({bound_ms / device_ms:.3f} device); nee_plain {plain_ms:.2f}"
              f" ms on the card")
        if depth == 0:
            report["nee"] = {"err": 0.0, "ms": ms, "device_ms": device_ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": "bytes"}
    scene, cfg, lanes, width, height, _, si = h.held[0]
    rays = nee.nee(scene, cfg, disney, lanes, width, height, 0, si, {})
    occ = torch.zeros_like(rays.want)
    rad = torch.zeros((lanes.pid.shape[0], 3), device=lanes.pid.device)
    ms = _median_ms(lambda: nee.add_unoccluded(rad, rays, occ))
    device_ms = _device_ms(lambda: nee.add_unoccluded(rad, rays, occ))
    plain_ms = _median_ms(lambda: nee.add_unoccluded_plain(rad, rays, occ))
    k = rays.want.shape[0] // lanes.pid.shape[0]
    nbytes = lanes.pid.shape[0] * (12 + 14 * k + 12)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(f"phase 5b: nee_add_kernel ({k} rays a lane): ptxas "
          f"{p.get('nee_add_kernel')}; one launch {ms:.4f} ms, device "
          f"{device_ms:.4f} ms; bound {bound_ms:.4f} ms, share "
          f"{bound_ms / device_ms:.3f} device; plain {plain_ms:.3f} ms")
    report["nee_add"] = {"err": 0.0, "ms": ms, "device_ms": device_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": "bytes"}
    report.update(phase_extend(held_extend, ptxas))
    return report


# ---------------------------------------------------------------------------
# phase 5c: the BSDF extension kernel
# ---------------------------------------------------------------------------

# bytes a lane of the extension kernel reads and writes
# (csrc/extend_kernel.cu's note)
EXTEND_BYTES = 189 + 54


def extend_args(case, device) -> tuple:
    """``ops/extension.extend``'s lanes, lane seeds and the path state it
    carries over (radiance and pid) from a ``synthetic.extend_case`` on
    ``device``."""
    import torch
    from rfw_tpu_torch.ops import extension
    from rfw_tpu_torch.render.integrator import PathState

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lanes = case["lanes"]
    n = case["seed"].shape[0]
    ext = extension.ExtendLanes(
        sd={k: on(v) for k, v in lanes["sd"].items()},
        **{k: on(v) for k, v in lanes.items() if k != "sd"})
    state = PathState(*(None,) * 9)._replace(
        radiance=torch.rand((n, 3), device=device),
        pid=torch.arange(n, dtype=torch.int32, device=device))
    return ext, on(case["seed"]), state


def _state_bits(a, b) -> bool:
    """Two path states equal field for field, bit for bit."""
    return all(_same_bits(x, y) for x, y in zip(a, b))


def extend_against_plain(config, lanes, seed, state) -> bool:
    """One launch of the extension kernel against ``extend_plain``
    (Disney) on the same tensors: every field of the next path state
    equal bit for bit."""
    from rfw_tpu_torch.ops import cuda_lib, extension
    from rfw_tpu_torch.ops.bsdf import disney
    before = cuda_lib.launch_counts["extend"]
    got = extension.extend(config, disney, lanes, seed, state)
    want = extension.extend_plain(config, disney, lanes, seed, state)
    return (cuda_lib.launch_counts["extend"] == before + 1
            and _state_bits(got, want))


def phase_extend(held, ptxas=None) -> dict:
    """The BSDF extension kernel (phase 5c): on the slice's own depth-0
    and bounce lanes of chunk 0 (``held``: the ``_HeldNee`` of phase 5b's
    sample) and on made-up lanes of ``synthetic.extend_case`` at the same
    size (a depth-0 chunk in tile order, a scattered bounce chunk; glass,
    metallic, subsurface, back-face, alpha-cut, dead and NaN lanes;
    Russian roulette on and off), bit for bit against ``extend_plain``;
    its ptxas line; one launch (CUDA events), its device time, its bytes
    bound and the plain version's time on the depth-0 lanes. Returns its
    report."""
    import dataclasses
    from rfw_tpu_torch.ops import cuda_lib, extension
    from rfw_tpu_torch.ops.bsdf import disney
    _check(0 in held and 1 in held, f"no depth-0 or depth-1 extension "
           f"caught ({sorted(held)})")
    for depth in (0, 1):
        cfg, lanes, seed, state = held[depth]
        for rr in (True, False):
            c = dataclasses.replace(cfg, russian_roulette=rr)
            equal = extend_against_plain(c, lanes, seed, state)
            print(f"phase 5c: extend kernel vs extend_plain on the slice's "
                  f"depth-{depth} lanes of chunk 0 ({seed.shape[0]} lanes, "
                  f"Russian roulette {'on' if rr else 'off'}): "
                  f"{'equal bit for bit' if equal else 'DIFFERENT'}")
            _check(equal, f"extend kernel != extend_plain at depth {depth}")
    base = held[0][0]
    for label, case_kw in (("depth-0 chunk", {}),
                           ("bounce chunk", {"order": "scattered",
                                             "glass": 0.5,
                                             "nan_share": 0.01})):
        lanes, seed, state = extend_args(synthetic.extend_case(
            SEED, 518_400, **case_kw), "cuda")
        for rr in (True, False):
            cfg = dataclasses.replace(base, russian_roulette=rr)
            equal = extend_against_plain(cfg, lanes, seed, state)
            print(f"phase 5c: extend kernel vs extend_plain, made-up lanes "
                  f"({label}, Russian roulette {'on' if rr else 'off'}): "
                  f"{'equal bit for bit' if equal else 'DIFFERENT'}")
            _check(equal, f"extend kernel != extend_plain ({label})")
    p = ptxas or cuda_lib.ptxas_report(cuda_lib.build_log)
    _check(p.get("extend_kernel", {}).get("spill_stores") == 0
           and p.get("extend_kernel", {}).get("spill_loads") == 0,
           f"extend_kernel: ptxas reports spills or no report "
           f"({p.get('extend_kernel')})")
    report = {}
    for depth in (0, 1):
        cfg, lanes, seed, state = held[depth]
        n = seed.shape[0]
        ms = _median_ms(lambda: extension.extend_kernel(cfg, lanes, seed,
                                                        state))
        device_ms = _device_ms(lambda: extension.extend_kernel(
            cfg, lanes, seed, state))
        plain_ms = _median_ms(lambda: extension.extend_plain(
            cfg, disney, lanes, seed, state))
        bound_ms = n * EXTEND_BYTES / PEAK_BYTES * 1e3
        print(f"phase 5c: extend_kernel on the depth-{depth} lanes ({n}): "
              f"ptxas {p.get('extend_kernel')}; one launch {ms:.4f} ms, "
              f"device {device_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes: "
              f"{EXTEND_BYTES} B x {n} lanes at {PEAK_BYTES / 1e12:.2f} "
              f"TB/s), share {bound_ms / ms:.3f} ({bound_ms / device_ms:.3f}"
              f" device); extend_plain {plain_ms:.2f} ms on the card")
        if depth == 0:
            report["extend"] = {"err": 0.0, "ms": ms, "device_ms": device_ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": "bytes"}
    return report


# ---------------------------------------------------------------------------
# phase 11: the raster preview, tiles, the App and the live viewer
# ---------------------------------------------------------------------------

PREVIEW_FRAMES = 5
TILES = 4
PROBE_XY = (960, 700)          # in tile 2 of 4 (rows 540-809)
APP_FRAMES, APP_SAMPLES = 3, 2
VIEWER_SIZE, VIEWER_FRAMES = 512, 20


def _slice_system(engine, config, work):
    """A RenderSystem on phase 5's scene and camera, built."""
    from rfw_tpu_torch.system import RenderSystem
    rs = RenderSystem(engine, config, device="cuda")
    n_tris = build_slice_scene(rs, work)
    rs.synchronize()
    return rs, n_tris


def _raster_against_plain(rs) -> float:
    """One 1080p raster frame with the traversal kernel's launches caught
    (one a chunk of the frame), each held against traverse_wide_ref on
    the same tensors: t, prim, u and v bit for bit. Returns the largest
    kernel-plain difference of t."""
    import torch
    from rfw_tpu_torch.ops import traverse
    from rfw_tpu_torch.render import RenderStatus
    launch, caught = traverse.traverse_wide, []

    def catching(*a, **kw):
        out = launch(*a, **kw)
        caught.append((a, kw, out))
        return out

    traverse.traverse_wide = catching
    try:
        rs.render_frame(status=RenderStatus.RESET)
    finally:
        traverse.traverse_wide = launch
    _check(bool(caught), "the raster frame launched no traversal")
    err = 0.0
    for i, (a, kw, out_k) in enumerate(caught):
        out_p = traverse.traverse_wide_ref(*a, **kw)
        torch.cuda.synchronize()
        _check(_bits_equal(out_k, out_p),
               f"traverse kernel != plain on raster launch {i}")
        err = max(err, float((out_k[0] - out_p[0]).abs().max()))
        print(f"phase 11: traverse kernel vs traverse_wide_ref on raster "
              f"launch {i} of {len(caught)}: {a[0].shape[0]} lanes, "
              f"{int((out_k[1] >= 0).sum())} hits; equal bit for bit")
    return err


def phase_preview(work):
    """Phase 11 (a): the raster preview at 1080p on phase 5's scene and
    camera, timed (median of 5 synced frames, and their peak memory),
    deterministic and the same through the async path whatever status
    and sample count, its traversal launches held to the plain version;
    then the Cornell scene at 64² against the port's CPU raster frame.
    Returns the timed frames' launches and the largest kernel-plain
    difference of t."""
    import torch
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.render import RenderStatus
    from rfw_tpu_torch.system import RenderSystem
    t0 = time.perf_counter()
    rs, n_tris = _slice_system("raster", RenderConfig(), work)
    print(f"phase 11: raster: scene of {n_tris} triangles built in "
          f"{time.perf_counter() - t0:.1f} s")
    first = rs.render_frame(status=RenderStatus.RESET)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    times = []
    for _ in range(PREVIEW_FRAMES):
        t0 = time.perf_counter()
        frame = rs.render_frame(status=RenderStatus.RESET)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(cuda_lib.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rs.render_frame_async(status=RenderStatus.CONVERGE)
    converge = rs.finish_frame()
    rs.render_frame_async(status=RenderStatus.RESET, samples=2)
    two = rs.finish_frame()
    print(f"phase 11: raster at 1920x1080: median frame "
          f"{float(np.median(times)):.2f} ms over {PREVIEW_FRAMES} (synced, "
          f"the frame read back), frames {[round(t, 2) for t in times]} ms;"
          f" frame mean {float(frame.mean()):.6g}, max_memory_allocated "
          f"{peak:.2f} GiB, launches {launches}; "
          f"two frames equal: {np.array_equal(first, frame)}, async "
          f"CONVERGE and samples=2 equal the sync frame: "
          f"{np.array_equal(converge, frame)}, {np.array_equal(two, frame)}")
    _check(frame.shape == (1080, 1920, 3) and bool(np.isfinite(frame).all())
           and float(frame.mean()) > 0.01, "raster frame not finite/lit")
    _check(launches["traverse"] >= PREVIEW_FRAMES
           and launches["enum"] == 0 and launches["visit"] == 0,
           f"raster launches {launches}")
    _check(np.array_equal(first, frame), "raster frames differ")
    _check(np.array_equal(converge, frame) and np.array_equal(two, frame),
           "the async raster frames differ from the 1-spp frame")
    err = _raster_against_plain(rs)
    del rs
    torch.cuda.empty_cache()
    frames = {dev: make_cornell(RenderSystem("raster", RenderConfig(),
                                             device=dev)).render_frame()
              for dev in ("cuda", "cpu")}
    diff = np.abs(frames["cuda"] - frames["cpu"])
    rmse = _rmse(frames["cuda"], frames["cpu"])
    print(f"phase 11: raster Cornell 64x64, card vs CPU: RMSE {rmse:.6g} "
          f"(bar 2e-3), max abs difference {float(diff.max()):.6g}, "
          f"{int((diff.max(axis=-1) > 1e-3).sum())} pixels apart by > 1e-3")
    _check(rmse < 2e-3, f"raster Cornell card vs CPU RMSE {rmse} >= 2e-3")
    return launches, err


def _equal_frames(label, rs0, rs4, samples, launch_keys):
    """RESET plus ``samples`` spp on the untiled and the tiled system:
    max abs difference < 1e-5, the ray count, the probe. Returns the
    tiled frame's launches."""
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.render import RenderStatus
    frames = []
    for rs in (rs0, rs4):
        rs.set_probe_index(PROBE_XY)
        cuda_lib.reset_launch_counts()
        frames.append(rs.render_frame(status=RenderStatus.RESET,
                                      samples=samples))
    launches = dict(cuda_lib.launch_counts)
    diff = float(np.abs(frames[0] - frames[1]).max())
    probes = [rs.get_probe_results() for rs in (rs0, rs4)]
    primary = rs4.get_render_stats().primary_count
    print(f"phase 11: {label}: {TILES} tiles vs one, RESET + {samples} spp:"
          f" max abs difference {diff:.6g} (bar 1e-5), equal bit for bit: "
          f"{np.array_equal(frames[0], frames[1])}; primary rays "
          f"{primary}; probes {probes[0]}, {probes[1]}; tiled launches "
          f"{launches}")
    _check(diff < 1e-5, f"{label}: tiled frame differs by {diff}")
    _check(primary == 1920 * 1080 and probes[0] == probes[1],
           f"{label}: primary {primary}, probes {probes}")
    _check(all(launches[k] > 0 for k in launch_keys),
           f"{label}: kernels not launched on the tiles: {launches}")
    return launches


def _tile_against_plain(rs, tile: int = 1, depth: int = 1) -> dict:
    """One RESET 1-spp frame of the tiled wavefront system with tile
    ``tile``'s depth-``depth`` launches caught: the first enum launch and
    the first visit launch of each mode (closest, any hit), on the lanes
    that tile's driver compacted. Each is held against its plain version
    on the same tensors, bit for bit. Returns the largest kernel-plain
    difference per kernel."""
    import torch
    from rfw_tpu_torch.ops import visit_intersect as vi
    from rfw_tpu_torch.render import RenderStatus
    from rfw_tpu_torch.render.wavefront_driver import WavefrontDriver
    stage, enum, visit = WavefrontDriver._stage, vi.block_entries, vi.visit
    where, caught = [None], {}

    def staging(self, *a, **kw):
        # a: scene, view, state, sample_index, probe_lane, depth
        where[0] = (self.pixel_offset // self.n, a[5])
        try:
            return stage(self, *a, **kw)
        finally:
            where[0] = None

    def enum_caught(rays, bounds8, n_real):
        out = enum(rays, bounds8, n_real)
        if where[0] == (tile, depth):
            caught.setdefault("enum", (rays, bounds8, out))
        return out

    def visit_caught(rays, ids, counts, tnears, gran, eps, any_hit,
                     walked=None):
        out = visit(rays, ids, counts, tnears, gran, eps, any_hit,
                    walked=walked)
        if where[0] == (tile, depth):
            caught.setdefault(("visit", bool(any_hit)),
                              (rays, ids, counts, tnears, gran, eps, out))
        return out

    WavefrontDriver._stage = staging
    vi.block_entries, vi.visit = enum_caught, visit_caught
    try:
        rs.render_frame(status=RenderStatus.RESET)
    finally:
        WavefrontDriver._stage = stage
        vi.block_entries, vi.visit = enum, visit
    _check(set(caught) == {"enum", ("visit", False), ("visit", True)},
           f"tile {tile} depth {depth}: launches caught "
           f"{sorted(map(str, caught))}")
    rays, bounds8, e_k = caught["enum"]
    e_p = vi.block_entries_ref(rays, bounds8)
    torch.cuda.synchronize()
    _check(torch.equal(e_k, e_p),
           f"enum kernel != plain on tile {tile} depth {depth}")
    err = {"enum": float((e_k - e_p).abs().max()), "visit": 0.0}
    print(f"phase 11: enum kernel vs block_entries_ref on tile {tile}'s "
          f"depth-{depth} launch: {rays.shape[1]} lanes, "
          f"{int((rays[3] > 0).sum())} live, {bounds8.shape[1]} cells; "
          f"equal bit for bit")
    for any_hit in (False, True):
        rays, ids, counts, tnears, g, eps, (t_k, s_k) = caught[
            ("visit", any_hit)]
        t_p, s_p = vi.visit_ref(rays, ids, counts, tnears, g.planes,
                                g.super_g, g.k_size, eps, any_hit)
        torch.cuda.synchronize()
        mode = "any hit" if any_hit else "closest"
        _check(torch.equal(t_k, t_p) and torch.equal(s_k, s_p),
               f"visit kernel != plain on tile {tile} depth {depth} {mode}")
        err["visit"] = max(err["visit"], float((t_k - t_p).abs().max()))
        print(f"phase 11: visit kernel vs visit_ref on tile {tile}'s "
              f"depth-{depth} {mode} launch: {rays.shape[1]} lanes, "
              f"{int((s_k >= 0).sum())} hits; equal bit for bit")
    return err


def phase_tiles(work):
    """Phase 11 (b): BASELINE config 5's path on the one card: phase 5's
    scene through wavefront with n_devices=4 (four tiles round-robin on
    cuda:0, one compacted driver a tile) against n_devices=0, then the
    same on megakernel (make_engine_step over the traversal kernel).
    Tile 1's depth-1 enum and visit launches are held to their plain
    versions. Returns the tiled systems' launches in the timed windows
    and the largest kernel-plain differences."""
    import torch
    from rfw_tpu_torch.config import RenderConfig
    systems = {}
    for n_dev in (0, TILES):
        t0 = time.perf_counter()
        systems[n_dev], n_tris = _slice_system(
            "wavefront", RenderConfig(n_devices=n_dev), work)
        print(f"phase 11: wavefront, n_devices={n_dev}: scene built in "
              f"{time.perf_counter() - t0:.1f} s")
    from rfw_tpu_torch.parallel import make_tile_mesh
    print(f"phase 11: the tiles' devices: "
          f"{[str(d) for d in make_tile_mesh(TILES)]}")
    _equal_frames("wavefront", systems[0], systems[TILES], 4,
                  ("enum", "visit"))
    err = _tile_against_plain(systems[TILES])
    launches = None
    for n_dev, rs in systems.items():
        out, _ = phase_slice(rs, n_tris, f"phase 11 wavefront n_devices="
                             f"{n_dev}", None, False, ("enum", "visit"))
        if n_dev:
            launches = out
    del systems, rs
    torch.cuda.empty_cache()
    systems = [_slice_system("megakernel", RenderConfig(n_devices=n_dev),
                             work)[0] for n_dev in (0, TILES)]
    mk = _equal_frames("megakernel", *systems, 2, ("traverse",))
    del systems
    torch.cuda.empty_cache()
    return launches, mk, err


def phase_app(work):
    """Phase 11 (c): an App on phase 5's scene at 1080p on wavefront, 3
    frames of 2 spp with an orbit-and-brightness update, pipelined and
    sequential (bit for bit equal frames, the wall ms a frame of each);
    then an update that raises ValueError must surface as itself, with no
    frame left in flight, and the next run must work. PNGs go to
    ``work``."""
    import torch
    from rfw_tpu_torch.app import App
    from rfw_tpu_torch.config import RenderConfig

    class Orbit(App):
        def __init__(self, tag):
            super().__init__(1920, 1080, "wavefront", RenderConfig(),
                             camera_file=os.path.join(work, f"{tag}.bin"),
                             output_dir=os.path.join(work, tag))
            self.frames, self.stamps, self.ticks = [], [], 0
            self.fail = False

        def init(self, rs):
            if not rs.materials.materials:
                build_slice_scene(rs, work)

        def update(self, rs, dt):
            if self.fail:
                raise ValueError("update failed on purpose")
            self.ticks += 1
            ang = 0.05 * self.ticks
            rs.camera.look_at([22.0 * np.sin(ang), 12.0,
                               -22.0 * np.cos(ang)], [0.0, 1.0, 2.0])
            rs.camera.brightness = 0.05 * self.ticks
            return True

        def post_render(self, frame, frame_index):
            super().post_render(frame, frame_index)
            self.frames.append(frame)
            self.stamps.append(time.perf_counter())

    runs = {}
    for pipeline in (True, False):
        app = Orbit("pipe" if pipeline else "seq")
        app.run(frames=APP_FRAMES, samples_per_frame=APP_SAMPLES,
                pipeline=pipeline)
        runs[pipeline] = app
        ms = np.diff(app.stamps) * 1e3
        print(f"phase 11: App, pipeline={pipeline}: {APP_FRAMES} frames of "
              f"{APP_SAMPLES} spp at 1920x1080 (wavefront, tonemap, FXAA, "
              f"PNG), wall ms a frame after the first "
              f"{[round(float(m), 1) for m in ms]}, PNGs "
              f"{len(os.listdir(app.output_dir))}")
    pipe, seq = runs[True], runs[False]
    equal = [np.array_equal(a, b) for a, b in zip(pipe.frames, seq.frames)]
    print(f"phase 11: App pipelined vs sequential frames equal bit for bit: "
          f"{equal}; frames differ from each other: "
          f"{not np.array_equal(pipe.frames[0], pipe.frames[1])}")
    _check(len(pipe.frames) == len(seq.frames) == APP_FRAMES and all(equal),
           "App pipelined frames differ from the sequential ones")
    _check(all(f.shape == (1080, 1920, 3) and bool(np.isfinite(f).all())
               for f in pipe.frames)
           and not np.array_equal(pipe.frames[0], pipe.frames[1]),
           "App frames not finite or not moving")
    del seq, runs
    pipe.fail = True
    try:
        pipe.run(frames=2, samples_per_frame=APP_SAMPLES)
        raised = None
    except ValueError as e:
        raised = e
    in_flight = pipe.rs.context._pending is not None
    pipe.fail = False
    pipe.run(frames=1, samples_per_frame=APP_SAMPLES)
    print(f"phase 11: App update raising ValueError: surfaced as {raised!r},"
          f" frame in flight after it: {in_flight}; the next run gave frame "
          f"{len(pipe.frames)}")
    _check(raised is not None and not in_flight
           and len(pipe.frames) == APP_FRAMES + 1,
           "App: the update's ValueError did not surface cleanly")
    del pipe
    torch.cuda.empty_cache()


def _png_size(png: bytes):
    """(width, height) from a PNG's IHDR chunk."""
    _check(png[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    return (int.from_bytes(png[16:20], "big"),
            int.from_bytes(png[20:24], "big"))


def phase_viewer():
    """Phase 11 (d): the LiveViewer on 127.0.0.1 (a free port) at 512² on
    megakernel (the Cornell scene), at most 20 frames, in a thread: the
    frame is a PNG of that size, a keys POST moves the camera and restarts
    the accumulation, a material POST lands, a probe POST gives a probe,
    and /stats has rfw_tpu's keys."""
    import threading
    import urllib.request
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.system import RenderSystem
    from rfw_tpu_torch.viewer import LiveViewer
    rs = make_cornell(RenderSystem("megakernel", RenderConfig(),
                                   device="cuda"), VIEWER_SIZE)
    viewer = LiveViewer(rs, VIEWER_SIZE, VIEWER_SIZE, host="127.0.0.1",
                        port=0)
    url = f"http://127.0.0.1:{viewer.port}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.read()

    def stats():
        return json.loads(get("/stats"))

    def post(**ev):
        req = urllib.request.Request(url + "/input", method="POST",
                                     data=json.dumps(ev).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def wait(pred, what):
        for _ in range(1200):
            out = pred()
            if out:
                return out
            time.sleep(0.025)
        raise RuntimeError(f"chip_smoke: viewer: timed out waiting for "
                           f"{what}")

    t0 = time.perf_counter()
    thread = threading.Thread(target=viewer.run,
                              kwargs={"max_frames": VIEWER_FRAMES})
    thread.start()
    try:
        png = wait(lambda: get("/frame.png"), "the first frame")
        size = _png_size(png)
        s = wait(lambda: (lambda s: s if s["stats"]["spp"] >= 2 else None)(
            stats()), "2 samples")
        keys = sorted(s["stats"])
        pos0 = rs.camera.position.copy()
        post(action="keys", keys=["w"])
        moved = not np.allclose(rs.camera.position, pos0)
        spp_before = s["stats"]["spp"]
        post(action="probe", x=VIEWER_SIZE // 2, y=VIEWER_SIZE // 2)
        post(action="material", index=0, color=[0.9, 0.2, 0.1],
             roughness=0.3)
        m0 = rs.get_material(0)
        s = wait(lambda: (lambda s: s if s["probe"] and s["probe"][2] > 0
                          and s["stats"]["spp"] < spp_before else None)(
            stats()), "the reset and the probe")
    finally:
        thread.join(timeout=120)
        if thread.is_alive():
            viewer.stop()
            thread.join(timeout=60)
    print(f"phase 11: viewer at {VIEWER_SIZE}x{VIEWER_SIZE} on megakernel: "
          f"frame PNG {size}, /stats keys {keys}, keys POST moved the "
          f"camera: {moved}, spp {spp_before} -> {s['stats']['spp']}, "
          f"material 0 now {[float(c) for c in np.asarray(m0.color)[:3]]} "
          f"roughness {float(m0.roughness):.3g}, probe {s['probe']}; "
          f"{time.perf_counter() - t0:.1f} s")
    want = ["Mrays/s", "deep ms", "primary ms", "rays primary",
            "rays shadow", "render ms", "secondary ms", "spp"]
    _check(size == (VIEWER_SIZE, VIEWER_SIZE), f"viewer PNG size {size}")
    _check(keys == want, f"viewer /stats keys {keys}")
    _check(moved and s["stats"]["spp"] < spp_before,
           "viewer: the keys POST did not move the camera and reset spp")
    _check(abs(float(m0.roughness) - 0.3) < 1e-6
           and abs(float(np.asarray(m0.color)[0]) - 0.9) < 1e-6,
           "viewer: the material edit did not land")
    _check(len(s["probe"]) == 3 and s["probe"][1] >= 0,
           f"viewer probe {s['probe']}")
    _check(not thread.is_alive(), "viewer thread still running")


def phase_11():
    """Phase 11: the raster preview, tiles, the App and the viewer.
    Returns the launches of the timed raster frames, the tiled
    wavefront windows and the tiled megakernel frame, summed, and the
    largest kernel-plain difference per kernel held in the phase."""
    with tempfile.TemporaryDirectory() as work:
        launches, err_traverse = phase_preview(work)
        tiles_wf, tiles_mk, err = phase_tiles(work)
        phase_app(work)
    phase_viewer()
    err["traverse"] = err_traverse
    return ({k: launches[k] + tiles_wf[k] + tiles_mk[k] for k in launches},
            err)


# the examples at their rfw_tpu counterparts' default sizes: (label,
# module, arguments besides --out, the kernels its engine and intersector
# launch, its PNGs' width, height and count: one file, frames under
# --out, or for the viewer the frame fetched over HTTP; every example
# but textured_env, whose BSDF is microfacet, shades with Disney and so
# launches the extension kernel)
EXAMPLES = (
    ("cornell", "cornell", [], ("traverse", "extend"), (256, 256, 1)),
    ("textured_env", "textured_env", [], ("traverse",), (256, 256, 1)),
    ("instances", "instances", [], ("traverse", "extend"), (160, 160, 6)),
    ("instances --tlas", "instances", ["--tlas"],
     (*TLAS_KERNELS, "retransform", "extend"), (160, 160, 6)),
    ("animation", "animation", [], ("traverse", "extend"), (160, 160, 8)),
    ("viewer", "viewer", ["--size", "256", "--duration", "3"],
     ("enum", "visit", "extend"), (256, 256, 1)),
)


def _live(t_hi, n: int, eps: float = 0.0) -> int:
    """Lanes whose bound exceeds ``eps`` (every lane for no bound)."""
    import torch
    if t_hi is None:
        return n
    return int((torch.as_tensor(t_hi).broadcast_to((n,)) > eps).sum())


def _clone(x):
    """A copy of the tensors in ``x`` (nested tuples and dicts)."""
    import torch
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = map(_clone, x)
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class _Held:
    """While entered, wraps the traverse, enum, visit, the two tlas, the
    re-transform and the extension wrappers so that of each kernel's
    launches the one with the most live lanes (for the tlas kernels and
    the extension: rays; for the re-transform: triangles) is kept, inputs
    and output cloned, for the comparison with its plain version after
    the run."""

    def __enter__(self):
        from rfw_tpu_torch.bvh import tlas
        from rfw_tpu_torch.ops import extension, traverse
        from rfw_tpu_torch.ops import visit_intersect as vi
        from rfw_tpu_torch.render import scene_data as sd
        self.best = {}
        self.orig = (traverse.traverse_wide, vi.block_entries, vi.visit,
                     tlas.premask, tlas.walk_group, sd.retransform,
                     extension.extend_kernel)
        launch_t, launch_e, launch_v, launch_p, launch_w, launch_r, \
            launch_x = self.orig

        def keep(kernel, live, args, out):
            if live > self.best.get(kernel, (-1,))[0]:
                self.best[kernel] = (live, _clone(args), _clone(out))

        def traverse_held(origins, directions, bvh, tris, **kw):
            out = launch_t(origins, directions, bvh, tris, **kw)
            keep("traverse", _live(kw.get("t_max"), origins.shape[0],
                                   kw.get("t_epsilon", 1e-4)),
                 ((origins, directions, bvh, tris), kw), out)
            return out

        def enum_held(rays, bounds8, n_real):
            out = launch_e(rays, bounds8, n_real)
            keep("enum", _live(rays[3], rays.shape[1]), (rays, bounds8),
                 out)
            return out

        def visit_held(rays, ids, counts, tnears, gran, eps, any_hit,
                       walked=None):
            out = launch_v(rays, ids, counts, tnears, gran, eps, any_hit,
                           walked=walked)
            keep("visit", _live(rays[3], rays.shape[1]),
                 (rays, ids, counts, tnears, gran.planes, gran.super_g,
                  gran.k_size, eps, any_hit), out)
            return out

        def premask_held(lo, hi, o, d, best_t, t_epsilon, orig=None,
                         ray_chunk=65536):
            out = launch_p(lo, hi, o, d, best_t, t_epsilon, orig, ray_chunk)
            keep("tlas_premask", o.shape[0],
                 (lo, hi, o, d, best_t, t_epsilon, orig), out)
            return out

        def walk_held(rows, o, d, state, order, count, lanes, n_lanes,
                      t_epsilon, any_hit=False):
            out = launch_w(rows, o, d, state, order, count, lanes, n_lanes,
                           t_epsilon, any_hit)
            keep("tlas_walk", o.shape[0],
                 (rows, o, d, state, order, count, lanes, n_lanes,
                  t_epsilon, any_hit), out)
            return out

        def retransform_held(row, prim, base, xf, obj, pack):
            out = launch_r(row, prim, base, xf, obj, pack)
            keep("retransform", row.shape[0],
                 (row, prim, base, xf, obj, pack),
                 tuple(out[k] for k in sd.MOVE_PLANES))
            return out

        def extend_held(config, lanes, seed, state):
            out = launch_x(config, lanes, seed, state)
            keep("extend", seed.shape[0], (config, lanes, seed, state), out)
            return out

        traverse.traverse_wide = traverse_held
        vi.block_entries, vi.visit = enum_held, visit_held
        tlas.premask, tlas.walk_group = premask_held, walk_held
        sd.retransform = retransform_held
        extension.extend_kernel = extend_held
        return self

    def __exit__(self, *exc):
        from rfw_tpu_torch.bvh import tlas
        from rfw_tpu_torch.ops import extension, traverse
        from rfw_tpu_torch.ops import visit_intersect as vi
        from rfw_tpu_torch.render import scene_data as sd
        (traverse.traverse_wide, vi.block_entries, vi.visit, tlas.premask,
         tlas.walk_group, sd.retransform, extension.extend_kernel) = \
            self.orig

    def against_plain(self, label) -> dict:
        """Each held launch against its plain version, bit for bit.
        Returns the largest kernel-plain difference per kernel."""
        import torch
        from rfw_tpu_torch.bvh import tlas
        from rfw_tpu_torch.ops import extension, traverse
        from rfw_tpu_torch.ops import visit_intersect as vi
        from rfw_tpu_torch.ops.bsdf import disney
        from rfw_tpu_torch.render import scene_data as sd
        err = {}
        for kernel, (live, args, out_k) in sorted(self.best.items()):
            equal, t_at = _bits_equal, 0       # the output holding t
            if kernel == "traverse":
                a, kw = args
                out_p = traverse.traverse_wide_ref(*a, **kw)
                lanes = a[0].shape[0]
                mode = "any hit" if kw.get("any_hit") else "closest"
            elif kernel == "enum":
                out_k, out_p = (out_k,), (vi.block_entries_ref(*args),)
                lanes, mode = args[0].shape[1], f"{args[1].shape[1]} cells"
            elif kernel == "tlas_premask":
                lo, hi, o, d, best_t, t_eps, orig = args
                out_p = tlas.premask_ref(lo, hi, o, tlas.safe_inv_box_dir(d),
                                         best_t, t_eps, orig)
                equal, t_at = _premask_equal, 1   # (cross, tn_min, ...)
                lanes = o.shape[0]
                mode = (f"{lo.shape[0]} instances, {int(out_k[3])} lanes "
                        f"listed, the list as a sorted set")
            elif kernel == "tlas_walk":
                rows, o, d, state, order, count, lst, n_lst, t_eps, any_hit \
                    = args
                stats = {}
                out_p = tlas.walk_group_ref(rows, o, d, state, order, count,
                                            t_eps, any_hit, stats=stats)
                _check(_lanes_walked(lst, n_lst, stats["walked"]),
                       f"{label}: the tlas list != the lanes the plain walk "
                       f"walked")
                lanes = o.shape[0]
                mode = (f"{int(count)} of {order.shape[0]} instances "
                        f"touched, {int(n_lst)} lanes listed and walked, "
                        f"{'any hit' if any_hit else 'closest'}")
            elif kernel == "extend":
                config, lanes_x, seed, state = args
                out_p = extension.extend_plain(config, disney, lanes_x,
                                               seed, state)
                equal = _state_bits
                lanes = seed.shape[0]
                mode = (f"Russian roulette "
                        f"{'on' if config.russian_roulette else 'off'}, "
                        f"every field of the next path state")
            elif kernel == "retransform":
                want = sd.retransform_ref(*args)
                out_p = tuple(want[k] for k in sd.MOVE_PLANES)
                lanes = args[0].shape[0]
                mode = (f"{args[2].shape[0]} instances, every plane, the "
                        f"triangle table and the pack")
            else:
                out_p = vi.visit_ref(*args)
                lanes = args[0].shape[1]
                mode = "any hit" if args[-1] else "closest"
            torch.cuda.synchronize()
            _check(equal(out_k, out_p),
                   f"{label}: {kernel} kernel != plain on its launch with "
                   f"the most live lanes")
            err[kernel] = float((out_k[t_at] - out_p[t_at]).abs().max())
            print(f"phase 12: {label}: {kernel} kernel vs its plain version "
                  f"on the launch with the most live lanes ({live} of "
                  f"{lanes}, {mode}): equal bit for bit")
        return err


def _viewer_example(main, argv):
    """The viewer example in a thread on a free port of 127.0.0.1, one
    frame fetched over HTTP while it runs; its ``stop`` waits until the
    frame was fetched (at most 120 s), so the server cannot close first.
    Returns (main's exit code, the PNG)."""
    import socket
    import threading
    import urllib.request
    from rfw_tpu_torch.viewer import LiveViewer
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    fetched, stop, result = threading.Event(), LiveViewer.stop, []

    def stop_after_the_fetch(self):
        fetched.wait(timeout=120)
        stop(self)

    LiveViewer.stop = stop_after_the_fetch
    thread = threading.Thread(target=lambda: result.append(
        main([*argv, "--port", str(port)])))
    png = b""
    try:
        thread.start()
        for _ in range(4800):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/frame.png",
                        timeout=60) as r:
                    png = r.read()
            except OSError:
                png = b""
            if png:
                break
            time.sleep(0.025)
    finally:
        fetched.set()
        thread.join(timeout=300)
        LiveViewer.stop = stop
    _check(not thread.is_alive(), "viewer example still running")
    return (result[0] if result else None), png


def phase_examples(work):
    """Phase 12: the five examples on the card through their ``main``, at
    their rfw_tpu counterparts' default sizes: each exits 0, writes its
    PNGs and launches its kernels, and of each kernel its launch with the
    most live lanes is held bit for bit to its plain version; then the
    example's Cornell at 64², 8 spp, card against CPU (RMSE < 2e-3).
    Returns the examples' launches, summed, and the largest kernel-plain
    difference per kernel."""
    import importlib
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.render import RenderStatus, create_engine
    launches = dict.fromkeys(KERNELS, 0)
    err: dict = {}
    for label, name, argv, kernels, pngs in EXAMPLES:
        main = importlib.import_module(f"rfw_tpu_torch.examples.{name}").main
        out = os.path.join(work, label.replace(" --", "_"))
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        w, h, n = pngs
        with _Held() as held:
            if name == "viewer":
                rc, png = _viewer_example(main, argv)
                sizes = [_png_size(png)] if png else []
            else:
                if n == 1:
                    rc = main([*argv, "--out", out + ".png"])
                    files = [out + ".png"]
                else:
                    rc = main([*argv, "--out", out])
                    files = [os.path.join(out, f"frame_{i:05d}.png")
                             for i in range(n)]
                sizes = []
                for f in files:
                    with open(f, "rb") as fh:
                        sizes.append(_png_size(fh.read()))
        want = [(w, h)] * n
        wall = time.perf_counter() - t0
        counts = dict(cuda_lib.launch_counts)
        print(f"phase 12: {label}: exit {rc}, {wall:.1f} s, PNGs {sizes}, "
              f"launches {counts}")
        _check(rc == 0, f"{label}: exit code {rc}")
        _check(sizes == want, f"{label}: PNGs {sizes}, expected {want}")
        _check(all((counts[k] > 0) == (k in kernels) for k in KERNELS)
               and set(held.best) == set(kernels),
               f"{label}: launched {counts}, expected {kernels} only")
        for k, e in held.against_plain(label).items():
            err[k] = max(err.get(k, 0.0), e)
        for k in KERNELS:
            launches[k] += counts[k]
    cornell = importlib.import_module("rfw_tpu_torch.examples.cornell")
    frames = {}
    for dev in ("cuda", "cpu"):
        eng = create_engine("megakernel", device=dev)
        cornell.build_cornell(eng)
        eng.resize(64, 64)
        frames[dev] = eng.render_frame(
            cornell.default_camera(64).get_view().as_pytree(),
            RenderStatus.RESET, samples=8)
    rmse = _rmse(frames["cuda"], frames["cpu"])
    diff = np.abs(frames["cuda"] - frames["cpu"])
    print(f"phase 12: the example's Cornell at 64x64, 8 spp on megakernel, "
          f"card vs CPU: RMSE {rmse:.6g} (bar 2e-3), max abs difference "
          f"{float(diff.max()):.6g}")
    _check(bool(np.isfinite(frames["cuda"]).all())
           and float(frames["cuda"].mean()) > 0.01,
           "the example's Cornell frame is not finite and lit")
    _check(rmse < 2e-3, f"example Cornell card vs CPU RMSE {rmse} >= 2e-3")
    return launches, err


BENCH_TIMEOUT = 600
BENCH_KEYS = ("metric", "value", "unit", "ms_per_sample_median",
              "ms_per_sample_windows", "rays_per_sample", "cache_state",
              "setup_compile_s", "scene_build_s", "warm_session_ttfp_s",
              "stage_ms", "device", "launches")


def phase_bench(card: str) -> dict:
    """Phase 13: ``python3 bench_torch.py`` at its defaults, in a process
    of its own (the RFW_BENCH_* variables cleared). Returns each kernel's
    launches in the bench's timed windows. Also prints the CPU cores
    the bench process and this one kept busy meanwhile."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RFW_BENCH_")}
    t0, cpu0 = time.perf_counter(), os.times()
    run = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    cpu = os.times()
    bench_cpu = (cpu.children_user + cpu.children_system
                 - cpu0.children_user - cpu0.children_system)
    own_cpu = cpu.user + cpu.system - cpu0.user - cpu0.system
    print(f"phase 13: CPU cores busy while the bench ran: the bench "
          f"process's {bench_cpu / wall:.2f}, this process's "
          f"{own_cpu / wall:.2f}")
    for line in run.stderr.splitlines():
        print(f"phase 13: {line}")
    _check(run.returncode == 0,
           f"bench_torch.py exited {run.returncode}:\n{run.stdout}")
    out = json.loads(run.stdout.strip().splitlines()[-1])
    _check(all(k in out for k in BENCH_KEYS),
           f"bench_torch.py's line lacks {set(BENCH_KEYS) - set(out)}")
    _check(np.isfinite(out["value"]) and out["value"] > 0,
           f"bench_torch.py's Mrays/s {out['value']} not finite/positive")
    _check(out["rays_per_sample"]["primary"] == 1920 * 1080,
           f"bench_torch.py's primary rays {out['rays_per_sample']}")
    windows = out["ms_per_sample_windows"]
    _check(len(windows) == 3, f"bench_torch.py's windows {windows}")
    _check(out["launches"]["enum"] > 0 and out["launches"]["visit"] > 0,
           f"bench_torch.py's windows launched {out['launches']}")
    _check(f"{out['device']['name']}, {out['device']['power_limit']}"
           == card, f"bench_torch.py's card {out['device']} is not {card}")
    print(f"phase 13: {card}: {json.dumps(out)}")
    print(f"phase 13: bench_torch.py took {wall:.1f} s, median "
          f"{out['ms_per_sample_median']:.1f} ms/sample, "
          f"{out['value']:.3f} Mrays/s")
    samples = out["samples_per_window"] * len(windows)
    return {k: round(v * samples) for k, v in out["launches"].items()}


def phase_build() -> dict:
    """Phase 2: ``python -m rfw_tpu_torch.native.build`` builds both
    native libraries ahead of time; then the loaders must find them and
    build nothing. Returns the ptxas report per kernel."""
    from rfw_tpu_torch import native
    from rfw_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    build = subprocess.run([sys.executable, "-m",
                            "rfw_tpu_torch.native.build"], cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
    build_s = time.perf_counter() - t0
    for line in build.stdout.splitlines():
        print(f"phase 2: {line}")
    _check(build.returncode == 0,
           f"python -m rfw_tpu_torch.native.build exited "
           f"{build.returncode}:\n{build.stdout}{build.stderr}")
    print(f"phase 2: python -m rfw_tpu_torch.native.build took "
          f"{build_s:.2f} s")
    t0 = time.perf_counter()
    cuda_lib.load()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bvh_lib = native._load()
    native_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase 2: after the build, cuda_lib.load() took {load_ms:.1f} ms "
          f"(nvcc {cuda_lib.build_seconds:.2f} s, must be 0) and the BVH "
          f"builder's load {native_ms:.1f} ms")
    _check(cuda_lib.build_seconds == 0,
           f"cuda_lib.load() built the kernels again "
           f"({cuda_lib.build_seconds:.2f} s)")
    _check(bvh_lib is not None, "the BVH builder's library did not load")
    # the build printed each kernel's report; a spill fails the run
    ptxas = cuda_lib.ptxas_report(cuda_lib.build_log)
    for name in (f"{k}_kernel" for k in KERNELS):
        p = ptxas.get(name, {})
        _check(p.get("spill_stores") == 0 and p.get("spill_loads") == 0,
               f"{name}: ptxas reports spills or no report ({p})")
    return ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--png", help="write the tonemapped 1080p frame here")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more 1080p sample (torch.profiler)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false)")
    # every run builds the texture atlases and the scenes cold and writes
    # no cache
    os.environ["RFW_NO_TEX_CACHE"] = "1"
    os.environ["RFW_NO_SCENE_CACHE"] = "1"
    sys.path.insert(0, ROOT)
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.ops import cuda_lib
    from rfw_tpu_torch.system import RenderSystem

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    ptxas = phase_build()

    cfg = RenderConfig()
    rs = RenderSystem("wavefront", cfg, device="cuda")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        n_tris = build_slice_scene(rs, work)
        rs.synchronize()
        print(f"phase 5: scene of {n_tris} triangles loaded and built in "
              f"{time.perf_counter() - t0:.1f} s")
    report = phase_kernels(rs, cfg, ptxas)
    report.update(phase_traverse_kernel(rs, cfg, ptxas))
    phase_golden()
    phase_megakernel_golden()
    launches, frame_visit = phase_slice(rs, n_tris, "phase 5", args.png,
                                        args.profile,
                                        ("enum", "visit", *NEE_KERNELS,
                                         "extend"))
    phase_depth_split(rs, "phase 5")
    report.update(phase_nee(rs, ptxas))
    t0 = time.perf_counter()
    rs.set_setting("intersector", "tvisit")
    report.update(phase_tvisit_kernel(rs, cfg, ptxas))
    print(f"phase 3: switch to tvisit, rebuild and tvisit checks "
          f"{time.perf_counter() - t0:.1f} s")
    png6 = args.png and os.path.splitext(args.png)[0] + "_tvisit.png"
    launches_t, frame_tvisit = phase_slice(rs, n_tris, "phase 6", png6,
                                           args.profile,
                                           ("enum", "visit", "expand",
                                            "tvisit"))
    rmse = _rmse(frame_tvisit, frame_visit)
    diff = float(np.abs(frame_tvisit - frame_visit).max())
    print(f"phase 6: tvisit frame vs phase 5's visit frame: RMSE {rmse:.6g} "
          f"(bar 2e-3), max abs difference {diff:.6g}")
    _check(rmse < 2e-3, f"tvisit slice frame RMSE {rmse} >= 2e-3")
    launches.update(expand=launches_t["expand"], tvisit=launches_t["tvisit"])
    del rs                    # phase 7's peak memory is its scene's alone
    torch.cuda.empty_cache()
    png7 = args.png and os.path.splitext(args.png)[0] + "_textured.png"
    launches_7, _, _ = phase_textured(png7, args.profile)
    print(f"phase 7: launches on the textured slice {launches_7}")
    torch.cuda.empty_cache()
    launches_8 = phase_refit()
    torch.cuda.empty_cache()
    png9 = args.png and os.path.splitext(args.png)[0] + "_megakernel.png"
    launches.update(traverse=phase_megakernel(frame_visit, png9,
                                              args.profile)["traverse"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    png10 = args.png and os.path.splitext(args.png)[0] + "_tlas.png"
    launches_10, report_10 = phase_tlas(png10, args.profile)
    report.update(report_10)
    report["retransform"] = phase_retransform(ptxas)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s; launches in its "
          f"timed windows: {launches_10}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_11, err_11 = phase_11()
    print(f"phase 11: {time.perf_counter() - t0:.1f} s; launches in its "
          f"timed raster frames, tiled wavefront windows and tiled "
          f"megakernel frame: {launches_11}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        launches_12, err_12 = phase_examples(work)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s; launches in the "
          f"examples' runs: {launches_12}")
    torch.cuda.empty_cache()
    launches_13 = phase_bench(card)
    # each kernel's launches in the timed windows of the phases whose
    # path it is: enum and visit phase 5 (visit), expand and tvisit phase
    # 6 (tvisit), traverse phase 9 (megakernel) and phase 10 (tlas, 0),
    # the two tlas kernels phase 10, retransform phase 10's moves, extend
    # phase 5 (visit, whose NEE and extension are the kernels'); all of
    # them in phase 11 (raster, tiles); the examples' in phase 12; enum
    # and visit in the bench's timed windows, phase 13
    by_phase = {"enum": {"5": launches["enum"]},
                "visit": {"5": launches["visit"]},
                "extend": {"5": launches["extend"]},
                "expand": {"6": launches["expand"]},
                "tvisit": {"6": launches["tvisit"]},
                "traverse": {"9": launches["traverse"],
                             "10": launches_10["traverse"]},
                **{k: {"10": launches_10[k]}
                   for k in (*TLAS_KERNELS, "retransform")}}
    for name in ("traverse", *TLAS_KERNELS, "retransform"):
        launches[name] += launches_10[name]
    for name in KERNELS:
        by_phase[name]["11"] = launches_11[name]
        by_phase[name]["12"] = launches_12[name]
        launches[name] += launches_11[name] + launches_12[name]
    for name in ("enum", "visit"):
        by_phase[name]["13"] = launches_13[name]
        launches[name] += launches_13[name]
    for name, e in (*err_11.items(), *err_12.items()):
        report[name]["err"] = max(report[name]["err"], e)
    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print("phase 8: launches per deformation frame (1080p, 1 spp): "
          + json.dumps(launches_8))

    # no single PyTorch call computes any of the eleven functions
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "launches_by_phase": by_phase[name],
                "max_abs_err": report[name]["err"], "ms": report[name]["ms"],
                "device_ms": report[name]["device_ms"],
                "plain_ms": report[name]["plain_ms"],
                "bound_ms": report[name]["bound_ms"],
                "bound_by": report[name]["bound_by"], "library_ms": None}
               for name in KERNELS]
    # the NEE step replaces no Pallas kernel: an XLA-fused step of
    # rfw_tpu's depth stage; its launches are phase 5's
    kernels += [{"name": name, "route": "cuda",
                 "source": "rfw_tpu_torch/csrc/nee_kernel.cu",
                 "replaces": "rfw_tpu/render/integrator.py:193",
                 "launches": launches[name],
                 "launches_by_phase": {"5": launches[name]},
                 **{k: report[name][k] for k in (
                     "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                 "max_abs_err": report[name]["err"], "library_ms": None}
                for name in NEE_KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
