"""The NEE step of the port (``rfw_tpu_torch/ops/nee.py``) on the CPU.

``nee_plain``, which CPU lanes take, is held to rfw_tpu's depth stage:
both frameworks run one depth on the same scene (config 2's Cornell box
with a glass panel, a spot and a directional light added, the test sky
importance-sampled, the blue-noise stack) and the same lanes, with a
stand-in intersector that hands both the same hits and the same
occlusion answers, so the radiance a depth adds is its sky, emission and
NEE, and the extension rays follow the lane seeds the NEE leaves. Floats
agree to rtol = atol = 1e-4 (XLA fuses multiply-adds and evaluates its
transcendentals in float32); a lane whose shadow ray passes a test by an
ulp on one side may differ, at most 0.5 % of them.

Also: CPU lanes take the plain step (``nee.plain`` counted, no launch),
the Disney choice of ``depth_stage``, and the kernel's argument block
against ``csrc/nee_kernel.cu``'s ``NeeArgs``, field for field."""

import ctypes
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.render import integrator as jint
from rfw_tpu.render import scene_data as jax_sd

from golden_scenes import make_config2
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib, nee, rng
from rfw_tpu_torch.ops.bsdf import disney, lambert
from rfw_tpu_torch.render import integrator as tint
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.scene import Skybox
from rfw_tpu_torch.utils import synthetic, tracing

N = 2048
WIDTH, HEIGHT = 64, 48
TOL = dict(rtol=1e-4, atol=1e-4)
FLIPS = 0.005


@pytest.fixture(scope="module")
def scenes():
    """The scene as rfw_tpu builds it (numpy leaves for jnp) and as the
    port takes it."""
    rs = make_config2(size=16)
    glass = rs.add_material([0.9, 0.95, 1.0], roughness=0.3,
                            transmission=1.0, eta=1.5)
    rs.add_instance(rs.add_quad([0, 0, -1], [1.2, 1.5, 0.5], 1.2, 1.6,
                                glass))
    rs.add_spot_light([-2.0, 4.0, 2.0], 0.95, [30.0, 28.0, 25.0], 0.8,
                      [0.4, -1.0, -0.3])
    rs.add_directional_light([-0.3, -1.0, 0.2], [1.5, 1.4, 1.2])
    rs.synchronize()
    eng = rs.context
    scene = jax_sd.build_device_scene(
        eng._instance_list(), eng._materials, eng._lights, None, None,
        eng.config, area_light_overrides=eng._light_overrides)
    sky = Skybox.test_sky(64, 32)
    scene["skybox"] = {"pixels": sky.pixels,
                       **sky.build_importance_tables()}
    scene["blue_noise"] = rng.blue_noise_stack()
    ported = scene_data.scene_to_torch(scene, "cpu")
    ported["skybox"] = {k: torch.from_numpy(v)
                        for k, v in scene["skybox"].items()}
    ported["blue_noise"] = torch.from_numpy(scene["blue_noise"])
    return scene, ported


def _lanes(scene, seed):
    """Hits on random triangles of the scene, rays toward them, a tenth
    of the lanes dead, and the pixels of a 64 x 48 image in a random
    order."""
    r = np.random.default_rng(seed)
    n_tri = scene["tri_pack"].shape[0]
    u = r.uniform(0, 1, N).astype(np.float32)
    v = (r.uniform(0, 1, N) * (1 - u)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"prim": r.integers(0, n_tri, N).astype(np.int32), "u": u, "v": v,
            "t": r.uniform(0.5, 4.0, N).astype(np.float32),
            "origin": r.uniform(-2, 2, (N, 3)).astype(np.float32)
            + np.float32([0, 2.7, 0]),
            "direction": d,
            "throughput": r.uniform(0.2, 1.0, (N, 3)).astype(np.float32),
            "last_pdf": r.uniform(0.5, 2.0, N).astype(np.float32),
            "spec_bounce": r.random(N) < 0.2,
            "last_n": d,
            "alive": r.random(N) < 0.9,
            "pid": r.permutation(WIDTH * HEIGHT)[:N].astype(np.int32)}


def _occluded(o, d, dist, xp):
    """The stand-in occlusion answer: shot rays leaning to -x."""
    return (dist > 0) & (d[:, 0] < -0.2)


def _run_jax(scene, x, cfg, depth, sample):
    hits = (jnp.asarray(x["t"]), jnp.asarray(x["prim"]), jnp.asarray(x["u"]),
            jnp.asarray(x["v"]))
    isect = jint.Intersector(
        closest=lambda s, o, d, tmax, sort=True, coherent=False: hits,
        occluded=lambda s, o, d, dist, sort=True, coherent=False:
        _occluded(o, d, dist, jnp))
    state = jint.PathState(
        **{k: jnp.asarray(x[k]) for k in (
            "origin", "direction", "throughput", "last_pdf", "spec_bounce",
            "last_n", "alive")},
        radiance=jnp.zeros((N, 3), jnp.float32),
        pid=jnp.asarray(x["pid"].astype(np.uint32)))
    js = {k: v for k, v in scene.items()}
    out, stats, _, _ = jint.depth_stage(
        js, {"spread_angle": jnp.float32(1e-3)}, state, WIDTH, depth, sample,
        0, cfg, isect, height=HEIGHT)
    return out, stats


def _run_port(scene, x, cfg, depth, sample):
    on = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    hits = (on["t"], on["prim"], on["u"], on["v"])
    isect = tint.Intersector(
        closest=lambda s, o, d, tmax, sort=True, coherent=False: hits,
        occluded=lambda s, o, d, dist, sort=True, coherent=False:
        _occluded(o, d, dist, torch))
    state = tint.PathState(
        **{k: on[k] for k in ("origin", "direction", "throughput",
                              "last_pdf", "spec_bounce", "last_n", "alive",
                              "pid")},
        radiance=torch.zeros((N, 3)))
    out, stats, _, _ = tint.depth_stage(
        scene, {"spread_angle": torch.tensor(1e-3)}, state, WIDTH, depth,
        sample, 0, cfg, isect, height=HEIGHT)
    return out, stats


def _agree(a, b, what):
    """Rows of ``a`` (jax) and ``b`` (torch) agree to TOL but for FLIPS."""
    a = np.asarray(a, np.float32).reshape(N, -1)
    b = b.numpy().reshape(N, -1)
    ok = np.isclose(a, b, **TOL).all(-1) | (np.isnan(a) & np.isnan(b)).all(-1)
    assert (~ok).mean() <= FLIPS, (what, int((~ok).sum()))


# name: RenderConfig changes, depth, sample index
CASES = {
    "importance_depth0": ({}, 0, 3),
    "importance_bounce": ({}, 1, 3),
    "uniform_pick": ({"importance_sample_lights": False}, 1, 5),
    "past_the_cutoff": ({}, 0, 256),
    "no_blue_noise": ({"blue_noise": False}, 1, 2),
    "envmap_off": ({"envmap_nee": False}, 0, 3),
    "envmap_per_lane": ({"env_nee_interleave": 1}, 0, 3),
    "envmap_every_depth": ({"envmap_nee_max_depth": -1}, 2, 3),
    "debug_checks": ({"debug_checks": True}, 1, 3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nee_plain_matches_rfw_tpus_depth_stage(scenes, name):
    from rfw_tpu.config import RenderConfig as JaxConfig
    cfg_kw, depth, sample = CASES[name]
    base = dict(max_path_length=3, **cfg_kw)
    x = _lanes(scenes[0], 100 + depth)
    if name == "debug_checks":
        x["throughput"][::97, 1] = np.nan        # planted NaNs
    j_out, j_stats = _run_jax(scenes[0], x, JaxConfig(**base), depth, sample)
    t_out, t_stats = _run_port(scenes[1], x, RenderConfig(**base), depth,
                               sample)
    _agree(j_out.radiance, t_out.radiance, "radiance")
    _agree(j_out.direction, t_out.direction, "extension direction")
    _agree(j_out.throughput, t_out.throughput, "extension throughput")
    assert abs(int(j_stats["shadow_count"]) - int(t_stats["shadow_count"])) \
        <= FLIPS * N
    if name == "debug_checks":
        assert int(t_stats["nan_scrubbed"]) > 0
        assert int(j_stats["nan_scrubbed"]) == int(t_stats["nan_scrubbed"])


def _case_lanes(seed=3, **kw):
    case = synthetic.nee_case(seed, 4096, **kw)
    lanes = case["lanes"]

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    scene = {"lights": {k: on(v) for k, v in case["lights"].items()},
             "skybox": {k: on(v) for k, v in case["skybox"].items()},
             "blue_noise": on(rng.blue_noise_stack())}
    return scene, nee.NeeLanes(sd={k: on(v) for k, v in lanes["sd"].items()},
                               **{k: on(v) for k, v in lanes.items()
                                  if k != "sd"})


def test_cpu_lanes_take_the_plain_step():
    scene, lanes = _case_lanes(lights="all", glass=0.2)
    cfg = RenderConfig()
    before = dict(cuda_lib.launch_counts)
    tracing.clear()
    with tracing.recording():
        stats = {}
        got = nee.nee(scene, cfg, disney, lanes, 1920, 1080, 0, 3, stats)
        occ = torch.zeros(got.want.shape, dtype=torch.bool)
        rad = nee.add_unoccluded(torch.zeros((4096, 3)), got, occ)
    assert tracing.snapshot().counters == {"nee.plain": 1}
    assert cuda_lib.launch_counts == before
    want_stats = {}
    want = nee.nee_plain(scene, cfg, disney, lanes, 1920, 1080, 0, 3,
                         want_stats)
    assert got.want.shape == (2 * 4096,)           # light and envmap rays
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(stats["shadow_count"]) == int(want_stats["shadow_count"]) \
        == int(got.want.sum())
    hit = got.want.view(2, -1, 1)
    assert torch.equal(rad, (got.contrib.view(2, -1, 3) * hit).sum(0))


@pytest.mark.parametrize("bsdf", ["disney", "lambert"])
def test_depth_stage_sends_disney_to_the_kernel_step(scenes, monkeypatch,
                                                      bsdf):
    """The depth stage makes one NEE call, ``nee.nee`` with the config's
    BSDF module, which chooses the step; on CPU lanes it takes the plain
    step of that BSDF."""
    calls = []
    real_nee, real_plain = nee.nee, nee.nee_plain
    monkeypatch.setattr(nee, "nee", lambda *a: calls.append(
        ("nee", a[2])) or real_nee(*a))
    monkeypatch.setattr(nee, "nee_plain", lambda *a: calls.append(
        ("plain", a[2])) or real_plain(*a))
    _run_port(scenes[1], _lanes(scenes[0], 5),
              RenderConfig(max_path_length=3, bsdf=bsdf), 1, 3)
    module = {"disney": disney, "lambert": lambert}[bsdf]
    assert calls == [("nee", module), ("plain", module)]


@pytest.mark.parametrize("bsdf", ["disney", "lambert"])
def test_nee_launches_the_kernel_for_card_lanes_under_disney(monkeypatch,
                                                             bsdf):
    """``nee.nee`` on lanes it takes for card lanes (a stand-in library):
    the Disney BSDF launches the kernel once and counts ``nee.kernel``,
    another BSDF runs the plain step and counts ``nee.plain``."""
    scene, lanes = _case_lanes()
    launched = []

    class Lib:
        def rfw_nee(self, addr, stream):
            launched.append(addr)
            return 0

    import contextlib
    monkeypatch.setattr(cuda_lib, "kernel_device", lambda t, family: True)
    monkeypatch.setattr(cuda_lib, "launch", contextlib.contextmanager(
        lambda dev: iter([(Lib(), None)])))
    before = cuda_lib.launch_counts["nee"]
    module = {"disney": disney, "lambert": lambert}[bsdf]
    tracing.clear()
    with tracing.recording():
        rays = nee.nee(scene, RenderConfig(bsdf=bsdf), module, lanes, 1920,
                       1080, 0, 3, {})
    counters = tracing.snapshot().counters
    if bsdf == "disney":
        assert len(launched) == 1 and counters == {"nee.kernel": 1}
        assert cuda_lib.launch_counts["nee"] == before + 1
    else:
        assert not launched and counters == {"nee.plain": 1}
        assert cuda_lib.launch_counts["nee"] == before
        want = nee.nee_plain(scene, RenderConfig(bsdf=bsdf), lambert, lanes,
                             1920, 1080, 0, 3, {})
        for a, b in zip(rays, want):
            assert torch.equal(a, b)


def _c_fields(source, struct):
    """The fields of ``struct`` in ``csrc/<source>``: (name, kind)."""
    path = os.path.join(os.path.dirname(cuda_lib.SOURCES[0]), source)
    body = re.search(r"struct %s \{(.*?)\};" % struct, open(path).read(),
                     re.S).group(1)
    out = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = "p" if "*" in decl else decl.split()[0]
        names = decl.split(None, 1)[1] if kind != "p" else \
            decl.rsplit("*", 1)[1]
        out += [(n.strip(), kind) for n in names.split(",")]
    return out


def test_kernel_argument_block_matches_the_source():
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    assert [(k, kinds[t]) for k, t in nee.NeeArgs._fields_] == \
        _c_fields("nee_kernel.cu", "NeeArgs")


def test_kernel_route_fills_the_argument_block(monkeypatch):
    """The kernel route's wrapper on CPU tensors, with a stand-in
    library: every pointer is a tensor's, the scalars are the step's."""
    scene, lanes = _case_lanes(order="scattered")
    cfg = dataclasses.replace(RenderConfig(), env_nee_interleave=1,
                              envmap_nee_max_depth=-1)
    seen = {}

    class Lib:
        def rfw_nee(self, addr, stream):
            seen["args"] = nee.NeeArgs.from_buffer_copy(
                ctypes.string_at(addr, ctypes.sizeof(nee.NeeArgs)))
            return 0

    import contextlib
    monkeypatch.setattr(cuda_lib, "kernel_device", lambda t, family: True)
    monkeypatch.setattr(cuda_lib, "launch", contextlib.contextmanager(
        lambda dev: iter([(Lib(), None)])))
    before = cuda_lib.launch_counts["nee"]
    rays = nee.nee(scene, cfg, disney, lanes, 1920, 1080, 2, 7, {})
    assert cuda_lib.launch_counts["nee"] == before + 1
    a = seen["args"]
    assert a.pid == lanes.pid.data_ptr()
    assert a.color == lanes.sd["color"].data_ptr()
    assert a.flat_cdf == scene["skybox"]["flat_cdf"].data_ptr()
    assert a.origin_out == rays.origin.data_ptr()
    assert (a.n, a.width, a.n_area, a.env_mode) == (4096, 1920, 8, 1)
    assert (a.bn_size, a.bn_dims, a.bn_index0, a.bn_index1) == (128, 16, 8,
                                                                 9)
    assert a.bn_add0 == np.float32(rng.r2_offset(7, 8))
    key = (7 * 1791 + 2 * 720898027) & 0xFFFFFFFF
    assert a.key == (key if key < 1 << 31 else key - (1 << 32))
    assert rays.want.shape == (2 * 4096,)
