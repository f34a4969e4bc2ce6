"""The NEE kernel (``rfw_tpu_torch/csrc/nee_kernel.cu``) on the card:
equal bit for bit to its plain version, ``ops/nee.py::nee_plain`` with
the Disney BSDF, on the same CUDA tensors (every shadow ray, contribution,
flag and lane seed, the shadow-ray count and, under ``debug_checks``, the
NaN-scrub count), and its second kernel, ``add_unoccluded``, to
``add_unoccluded_plain``. The lanes are ``synthetic.nee_case``'s: a
depth-0 chunk of 518,400 lanes in tile order and a bounce chunk in a
scattered order under the benchmark sphereflake's three lamps, all four
light types under importance and uniform picks, glass lanes, samples
past the blue-noise cutoff, the envmap off, interleaved over 16 x 16
tiles, per lane, at every depth and on a sky whose sides are no powers
of two. An engine's frames launch the kernel once a ``stage.nee`` span,
and equal the frames of the plain step on the card bit for bit.

Every test needs a CUDA card and skips without one. On the card's
machine, which has no JAX (``tests/conftest.py`` imports it):
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_nee_card.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (_same_bits, make_config2, nee_against_plain,
                        nee_args)
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib, nee
from rfw_tpu_torch.ops.bsdf import disney
from rfw_tpu_torch.render import RenderStatus
from rfw_tpu_torch.scene import Skybox
from rfw_tpu_torch.system import RenderSystem
from rfw_tpu_torch.utils import synthetic, tracing

pytestmark = pytest.mark.card

CHUNK = 518_400
SMALL = 65_536
# name: (nee_case keywords, RenderConfig changes, depth, sample index)
CASES = {
    "depth0_chunk": ({"n": CHUNK}, {}, 0, 3),
    "bounce_chunk": ({"n": CHUNK, "order": "scattered", "lights": "lamps"},
                     {}, 1, 3),
    "all_lights_importance": ({}, {}, 1, 5),
    "all_lights_uniform": ({}, {"importance_sample_lights": False}, 1, 5),
    "glass": ({"glass": 1.0}, {}, 0, 5),
    "past_the_cutoff": ({}, {}, 0, 256),
    "no_blue_noise": ({}, {"blue_noise": False}, 1, 3),
    "envmap_off": ({}, {"envmap_nee": False}, 0, 3),
    "envmap_per_lane": ({"order": "scattered"}, {"env_nee_interleave": 1},
                        0, 3),
    "envmap_every_depth": ({}, {"envmap_nee_max_depth": -1}, 2, 3),
    "odd_sky": ({"sky": (500, 250)}, {"env_nee_interleave": 1}, 0, 3),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_its_plain_version_bit_for_bit(card, name, seed):
    case_kw, cfg_kw, depth, sample = CASES[name]
    case_kw = {"n": SMALL, **case_kw}
    cfg = dataclasses.replace(RenderConfig(), **cfg_kw)
    scene, lanes = nee_args(synthetic.nee_case(seed, **case_kw), card)
    assert nee_against_plain(scene, cfg, lanes, 1920, 1080, depth, sample)
    # without the image height (the per-lane tile stream) the same
    assert nee_against_plain(scene, cfg, lanes, 1920, None, depth, sample)


def test_debug_checks_count_the_same_scrubs(card):
    cfg = RenderConfig(debug_checks=True)
    scene, lanes = nee_args(synthetic.nee_case(3, SMALL, nan_share=0.01),
                            card)
    stats_k, stats_p = {"nan_scrubbed": torch.tensor(5, device=card)}, {}
    nee.nee(scene, cfg, disney, lanes, 1920, 1080, 0, 3, stats_k)
    nee.nee_plain(scene, cfg, disney, lanes, 1920, 1080, 0, 3, stats_p)
    assert int(stats_p["nan_scrubbed"]) > 0
    assert int(stats_k["nan_scrubbed"]) == int(stats_p["nan_scrubbed"]) + 5
    assert int(stats_k["shadow_count"]) == int(stats_p["shadow_count"])
    assert nee_against_plain(scene, cfg, lanes, 1920, 1080, 0, 3)


def test_add_unoccluded_reads_rows_of_any_stride(card):
    cfg = RenderConfig()
    scene, lanes = nee_args(synthetic.nee_case(5, SMALL), card)
    rays = nee.nee(scene, cfg, disney, lanes, 1920, 1080, 0, 3, {})
    packed = torch.rand((SMALL, 18), device=card)
    radiance = packed[:, 13:16]
    occ = torch.rand(rays.want.shape, device=card) < 0.5
    before = cuda_lib.launch_counts["nee_add"]
    got = nee.add_unoccluded(radiance, rays, occ)
    assert cuda_lib.launch_counts["nee_add"] == before + 1
    assert _same_bits(got, nee.add_unoccluded_plain(radiance, rays, occ))


def _system(device):
    rs = make_config2(RenderSystem(
        "wavefront", RenderConfig(max_path_length=3), device=device))
    glass = rs.add_material([0.9, 0.95, 1.0], roughness=0.05,
                            transmission=1.0, eta=1.5)
    rs.add_instance(rs.add_quad([0, 0, -1], [1.2, 1.5, 0.5], 1.2, 1.6,
                                glass))
    rs.add_spot_light([-2.0, 4.0, 2.0], 0.95, [30.0, 28.0, 25.0], 0.8,
                      [0.4, -1.0, -0.3])
    rs.add_directional_light([-0.3, -1.0, 0.2], [1.5, 1.4, 1.2])
    rs.set_skybox(Skybox.test_sky(128, 64))
    return rs


def test_an_engine_frame_launches_the_kernel_once_a_stage(card, monkeypatch):
    rs = _system(card)
    rs.render_frame(status=RenderStatus.RESET, samples=1)
    before = {k: cuda_lib.launch_counts[k] for k in ("nee", "nee_add")}
    tracing.clear()
    with tracing.recording():
        frame = rs.render_frame(status=RenderStatus.RESET, samples=2)
    snap = tracing.snapshot()
    stages = sum(s.name == "stage.nee" for s in snap.spans)
    assert stages == 2 * 4          # two samples of four depths, one chunk
    assert snap.counters.get("nee.kernel") == stages
    assert "nee.plain" not in snap.counters
    for k in ("nee", "nee_add"):
        assert cuda_lib.launch_counts[k] == before[k] + stages, k

    # the same frames with the plain step on the card: equal bit for bit
    def plain(scene, config, bsdf, lanes, *args):
        return nee.nee_plain(scene, config, bsdf, lanes, *args)
    monkeypatch.setattr(nee, "nee", plain)
    want = rs.render_frame(status=RenderStatus.RESET, samples=2)
    assert np.array_equal(frame.view(np.int32), want.view(np.int32))
