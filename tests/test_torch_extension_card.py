"""The BSDF extension kernel (``rfw_tpu_torch/csrc/extend_kernel.cu``) on
the card: equal bit for bit to its plain version,
``ops/extension.py::extend_plain`` with the Disney BSDF, on the same CUDA
tensors (every field of the next path state, dead lanes included). The
lanes are ``synthetic.extend_case``'s: a depth-0 chunk of 518,400 lanes
in tile order and a scattered bounce chunk, with glass, metallic,
subsurface, back-face, alpha-cut, dead and NaN lanes, under Russian
roulette and without it. An engine's frames launch the kernel once a
``stage.extend`` span, count ``extend.kernel`` there and never
``extend.plain``, and equal the frames of the plain step on the card bit
for bit.

Every test needs a CUDA card and skips without one. On the card's
machine, which has no JAX (``tests/conftest.py`` imports it):
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_extension_card.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import extend_against_plain, extend_args
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib, extension
from rfw_tpu_torch.render import RenderStatus
from rfw_tpu_torch.utils import synthetic, tracing
from test_torch_nee_card import _system

pytestmark = pytest.mark.card

CHUNK = 518_400
SMALL = 65_536
# name: extend_case keywords
CASES = {
    "depth0_chunk": {"n": CHUNK},
    "bounce_chunk": {"n": CHUNK, "order": "scattered"},
    "glass": {"glass": 1.0},
    "nan_lanes": {"order": "scattered", "nan_share": 0.02},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("rr", [True, False])
@pytest.mark.parametrize("seed", [7, 2**31 + 11])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_its_plain_version_bit_for_bit(card, name, seed, rr):
    case_kw = {"n": SMALL, **CASES[name]}
    cfg = dataclasses.replace(RenderConfig(), russian_roulette=rr)
    lanes, seeds, state = extend_args(synthetic.extend_case(seed, **case_kw),
                                      card)
    assert extend_against_plain(cfg, lanes, seeds, state)


def test_an_engine_frame_launches_the_kernel_once_a_stage(card, monkeypatch):
    rs = _system(card)
    rs.render_frame(status=RenderStatus.RESET, samples=1)
    before = cuda_lib.launch_counts["extend"]
    tracing.clear()
    with tracing.recording():
        frame = rs.render_frame(status=RenderStatus.RESET, samples=2)
    snap = tracing.snapshot()
    stages = sum(s.name == "stage.extend" for s in snap.spans)
    assert stages == 2 * 3          # two samples of three extending depths
    assert snap.counters.get("extend.kernel") == stages
    assert "extend.plain" not in snap.counters
    assert not any(s.name == "sync.disney_const" for s in snap.spans)
    assert cuda_lib.launch_counts["extend"] == before + stages

    # the same frames with the plain step on the card: equal bit for bit
    def plain(config, bsdf, lanes, seed, state):
        return extension.extend_plain(config, bsdf, lanes, seed, state)
    monkeypatch.setattr(extension, "extend", plain)
    want = rs.render_frame(status=RenderStatus.RESET, samples=2)
    assert np.array_equal(frame.view(np.int32), want.view(np.int32))
