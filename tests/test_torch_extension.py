"""The BSDF extension of the port (``rfw_tpu_torch/ops/extension.py``) on
the CPU.

``extend_plain``, which CPU lanes take, is held to rfw_tpu's depth stage
on ``test_torch_nee.py``'s scene, lanes, stand-in intersector and
tolerances: both frameworks run one depth, and every field of the path
state they hand the next depth agrees. A stand-in for
``get_shading_data`` (the same in both) turns a share of the hits into
glass, subsurface and metallic hits and into alpha-cut lanes, so that
every side of the Disney sample and the pass-through are taken.

Also: CPU lanes take the plain step (``extend.plain`` counted, no
launch), the depth stage's choice of step, the kernel's argument block
against ``csrc/extend_kernel.cu``'s ``ExtendArgs`` field for field and
its filling, and the kernel's source compiled for the host with g++
against ``extend_plain`` bit for bit (with ``torch.sqrt`` rounded once
from float64, as the card's square root is and the CPU's is not
always)."""

import contextlib
import ctypes
import dataclasses
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import extend_args
from rfw_tpu.render import integrator as jint

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib, extension
from rfw_tpu_torch.ops.bsdf import disney, lambert
from rfw_tpu_torch.render import integrator as tint
from rfw_tpu_torch.utils import synthetic, tracing
from test_torch_nee import (_agree, _c_fields, _lanes, _run_jax,  # noqa: F401
                            _run_port, scenes)

FIELDS = ("origin", "direction", "throughput", "radiance", "last_pdf",
          "spec_bounce", "last_n", "alive", "pid")


def _materials(where, alpha_cut, sd, prim):
    """The stand-in's changes, keyed by the hit's triangle: glass with
    absorption, subsurface, metallic, alpha-cut."""
    k = prim % 6
    sd = dict(sd)
    sd["transmission"] = where(k == 1, 1.0, sd["transmission"])
    sd["eta"] = where(k == 1, 1.5, sd["eta"])
    sd["absorption"] = where((k == 1)[..., None], 0.3, sd["absorption"])
    sd["subsurface"] = where(k == 2, 0.7, sd["subsurface"])
    sd["metallic"] = where(k == 3, 0.9, sd["metallic"])
    return sd, alpha_cut | (k == 4)


@pytest.fixture
def mixed_materials(monkeypatch):
    j_orig, t_orig = jint.get_shading_data, tint.get_shading_data

    def j_gsd(scene, prim, *a, **kw):
        sd, n_geom, i_n, t_vec, b_vec, ac = j_orig(scene, prim, *a, **kw)
        sd, ac = _materials(jnp.where, ac, sd, prim)
        return sd, n_geom, i_n, t_vec, b_vec, ac

    def t_gsd(scene, prim, *a, **kw):
        sd, n_geom, i_n, t_vec, b_vec, ac = t_orig(scene, prim, *a, **kw)
        sd, ac = _materials(torch.where, ac, sd, prim)
        return sd, n_geom, i_n, t_vec, b_vec, ac
    monkeypatch.setattr(jint, "get_shading_data", j_gsd)
    monkeypatch.setattr(tint, "get_shading_data", t_gsd)


# name: RenderConfig changes, depth, sample index
CASES = {
    "depth0": ({}, 0, 3),
    "bounce": ({}, 1, 3),
    "no_russian_roulette": ({"russian_roulette": False}, 1, 5),
    "no_variance_reduction": ({"variance_reduction": False}, 1, 3),
    "no_variance_reduction_depth0": ({"variance_reduction": False,
                                      "russian_roulette": False}, 0, 7),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_extend_plain_matches_rfw_tpus_depth_stage(scenes, mixed_materials,
                                                   name):
    from rfw_tpu.config import RenderConfig as JaxConfig
    cfg_kw, depth, sample = CASES[name]
    base = dict(max_path_length=3, **cfg_kw)
    x = _lanes(scenes[0], 200 + depth)
    calls = []
    real = extension.extend_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(extension, "extend_plain",
                   lambda *a: calls.append(a[2]) or real(*a))
        t_out, _ = _run_port(scenes[1], x, RenderConfig(**base), depth,
                             sample)
    j_out, _ = _run_jax(scenes[0], x, JaxConfig(**base), depth, sample)
    lanes = calls[0]
    # every side of the sample and the pass-through were taken
    glass = lanes.sd["transmission"] == 1.0
    assert int((lanes.alive & glass).sum()) > 20
    assert int((lanes.alive & (lanes.sd["subsurface"] == 0.7)).sum()) > 20
    assert int(lanes.alpha_cut.sum()) > 20
    assert int((lanes.alive & lanes.backfacing).sum()) > 20
    for k in FIELDS:
        _agree(getattr(j_out, k), getattr(t_out, k), k)
    assert 0 < int(t_out.alive.sum()) < int(lanes.alive.sum())


def _case(seed=3, n=4096, **kw):
    return extend_args(synthetic.extend_case(seed, n, **kw), "cpu")


def test_cpu_lanes_take_the_plain_step():
    lanes, seed, state = _case()
    cfg = RenderConfig()
    before = dict(cuda_lib.launch_counts)
    tracing.clear()
    with tracing.recording():
        got = extension.extend(cfg, disney, lanes, seed, state)
    assert tracing.snapshot().counters == {"extend.plain": 1}
    assert cuda_lib.launch_counts == before
    want = extension.extend_plain(cfg, disney, lanes, seed, state)
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.radiance is state.radiance and got.pid is state.pid


@pytest.mark.parametrize("bsdf", ["disney", "lambert"])
def test_depth_stage_sends_disney_to_the_kernel_step(scenes, monkeypatch,
                                                     bsdf):
    """With the extension's lanes taken for card lanes (``kernel_device``
    patched for its family alone), the depth stage's one extension call
    under Disney takes the kernel step, and under another BSDF the plain
    step of that BSDF."""
    calls = []
    real_plain = extension.extend_plain
    monkeypatch.setattr(cuda_lib, "kernel_device",
                        lambda t, family: family == "extend")
    monkeypatch.setattr(extension, "extend_kernel",
                        lambda cfg, *a: calls.append(("kernel", None))
                        or real_plain(cfg, disney, *a))
    monkeypatch.setattr(extension, "extend_plain", lambda *a: calls.append(
        ("plain", a[1])) or real_plain(*a))
    tracing.clear()
    with tracing.recording():
        _run_port(scenes[1], _lanes(scenes[0], 5),
                  RenderConfig(max_path_length=3, bsdf=bsdf), 1, 3)
    spans = [s.name for s in tracing.snapshot().spans]
    assert spans.count("stage.extend") == 1
    if bsdf == "disney":
        assert calls == [("kernel", None)]
    else:
        assert calls == [("plain", lambert)]


def test_kernel_argument_block_matches_the_source():
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    assert [(k, kinds[t]) for k, t in extension.ExtendArgs._fields_] == \
        _c_fields("extend_kernel.cu", "ExtendArgs")


@pytest.mark.parametrize("rr", [True, False])
def test_kernel_route_fills_the_argument_block(monkeypatch, rr):
    """The kernel route's wrapper on CPU tensors, with a stand-in
    library: one launch, every pointer a tensor's, the outputs the next
    state's, the scalars the config's."""
    lanes, seed, state = _case(n=1000)
    cfg = dataclasses.replace(RenderConfig(), russian_roulette=rr,
                              geometry_epsilon=3e-5)
    seen = []

    class Lib:
        def rfw_extend(self, addr, stream):
            seen.append(extension.ExtendArgs.from_buffer_copy(
                ctypes.string_at(addr, ctypes.sizeof(extension.ExtendArgs))))
            return 0

    monkeypatch.setattr(cuda_lib, "kernel_device", lambda t, family: True)
    monkeypatch.setattr(cuda_lib, "launch", contextlib.contextmanager(
        lambda dev: iter([(Lib(), None)])))
    before = cuda_lib.launch_counts["extend"]
    tracing.clear()
    with tracing.recording():
        out = extension.extend(cfg, disney, lanes, seed, state)
    assert tracing.snapshot().counters == {"extend.kernel": 1}
    assert cuda_lib.launch_counts["extend"] == before + 1 and len(seen) == 1
    a = seen[0]
    assert a.seed == seed.data_ptr()
    assert a.color == lanes.sd["color"].data_ptr()
    assert a.absorption == lanes.sd["absorption"].data_ptr()
    assert a.throughput_predpdf == lanes.throughput_predpdf.data_ptr()
    assert a.backfacing == lanes.backfacing.data_ptr()
    for k in extension._OUT:
        assert getattr(a, f"{k}_out") == getattr(out, k).data_ptr(), k
    assert (a.n, a.russian_roulette) == (1000, int(rr))
    assert a.geometry_epsilon == np.float32(3e-5)
    assert out.radiance is state.radiance and out.pid is state.pid
    assert out.origin.shape == (1000, 3) and out.alive.dtype == torch.bool


# a stand-in for the CUDA runtime header: the kernel's source compiled as
# host code, one call a lane
_HOST_RUNTIME = """#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
using std::isnan;
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx;
inline float __uint2float_rn(uint32_t u) { return (float)u; }
typedef void* cudaStream_t;
"""
_HOST_DRIVER = """
}  // namespace
extern "C" void host_extend(const void* block) {
  const ExtendArgs* a = static_cast<const ExtendArgs*>(block);
  for (int b = 0; b * kExtendThreads < a->n; ++b)
    for (int t = 0; t < kExtendThreads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      extend_kernel(*a);
    }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/extend_kernel.cu`` and ``shading.cuh`` built for the host
    by g++ (no contraction of multiplies and adds, as --fmad=false)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("extend_host")
    csrc = os.path.dirname(cuda_lib.SOURCES[0])
    src = open(os.path.join(csrc, "extend_kernel.cu")).read()
    src = src[:src.index("}  // namespace")] + _HOST_DRIVER
    (d / "extend.cpp").write_text(src)
    (d / "cuda_runtime.h").write_text(_HOST_RUNTIME)
    shutil.copy(os.path.join(csrc, "shading.cuh"), d)
    lib = d / "extend.so"
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{d}", "-o", str(lib), str(d / "extend.cpp")],
                   check=True, capture_output=True, timeout=300)
    host = ctypes.CDLL(str(lib))
    host.host_extend.argtypes = [ctypes.c_void_p]
    return host


@pytest.mark.parametrize("rr", [True, False])
@pytest.mark.parametrize("kw", [{}, {"order": "scattered", "glass": 0.6,
                                     "nan_share": 0.01}],
                         ids=["tiles", "scattered_glass_nan"])
def test_kernel_source_on_the_host_equals_extend_plain(host_kernel,
                                                       monkeypatch, rr, kw):
    lanes, seed, state = _case(seed=11, n=8192, **kw)
    cfg = RenderConfig(russian_roulette=rr)
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())
    want = extension.extend_plain(cfg, disney, lanes, seed, state)

    def launch(addr, stream):
        host_kernel.host_extend(addr)
        return 0
    lib = type("Lib", (), {"rfw_extend": staticmethod(launch)})()
    monkeypatch.setattr(cuda_lib, "kernel_device", lambda t, family: True)
    monkeypatch.setattr(cuda_lib, "launch", contextlib.contextmanager(
        lambda dev: iter([(lib, None)])))
    got = extension.extend(cfg, disney, lanes, seed, state)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k
    # the lanes took every side of the sample
    assert int((lanes.sd["transmission"] == 1.0).sum()) > 100
    assert 0 < int(got.alive.sum()) < int(lanes.alive.sum())
