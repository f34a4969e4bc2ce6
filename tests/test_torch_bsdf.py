"""The port's lambert, microfacet and microsurface BSDFs against rfw_tpu's
on the same seeded inputs.

Values, pdfs and sampled directions agree to rtol = atol = 1e-5, the
bar of tests/test_torch_shading.py's Disney cases: both sides compute
the same float32 formulas, the transcendentals (sin/cos, and erf, erfinv,
exp and powers in the microsurface walk) a few ulps apart. The
microsurface walk's randoms hash the query's float bits, so equal
inputs walk the same path on both sides. Its erf and erfinv are
jax.scipy.special's float32 approximations in rfw_tpu (erfinv up to 64
ulps from the exact value, which the walk's slope solve amplifies past
1e-4 in a few lanes); the tests swap in the exactly rounded functions
that the port uses (``ops.fmath``), on the reference's side only for the
duration of the test. Roughness stays at or above
0.45: these models square it, so their alpha stays at or above 0.2, the
Disney cases' floor (a sharper lobe multiplies a sampled direction's
ulps past the tolerance: at roughness 0.2, 24 of 6,144 microfacet sample
values differed by up to 1.2e-4 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.ops import bsdf as jbsdf
from rfw_tpu.ops.bsdf import microsurface as jmicrosurface

from rfw_tpu_torch.ops import bsdf as tbsdf
from rfw_tpu_torch.ops import shade as tshade

N = 2048
TOL = dict(rtol=1e-5, atol=1e-5)
MODELS = ("lambert", "microfacet", "microsurface")


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(71)

    def u(lo, hi):
        return rng.uniform(lo, hi, N).astype(np.float32)

    sd = {"color": rng.uniform(0, 1, (N, 3)).astype(np.float32),
          "metallic": u(0, 1), "specular": u(0, 1), "roughness": u(0.45, 1)}
    n = _unit(rng, N)
    t_vec, b_vec = (x.numpy() for x in tshade.create_tangent_space(
        torch.from_numpy(n)))
    wo = _unit(rng, N)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    return {"sd": sd, "n": n, "t": t_vec, "b": b_vec, "wo": wo,
            "wi": _unit(rng, N), "r3": u(0, 1), "r4": u(0, 1),
            "t_dist": u(0.1, 5), "backfacing": rng.random(N) < 0.3}


def _rounded(fn):
    """``fn`` (a torch function) evaluated in float64 and rounded to
    float32, as a JAX callback."""
    def call(x):
        return jax.pure_callback(
            lambda a: fn(torch.from_numpy(np.asarray(a, np.float64)))
            .float().numpy(),
            jax.ShapeDtypeStruct(x.shape, jnp.float32), x)
    return call


@pytest.fixture(autouse=True)
def exact_special_functions(monkeypatch):
    monkeypatch.setattr(jmicrosurface, "_erf", _rounded(torch.erf))
    monkeypatch.setattr(jmicrosurface, "_erfinv", _rounded(torch.erfinv))


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), err_msg=what,
                               **TOL)


def test_registry_names():
    for name in ("disney",) + MODELS:
        assert tbsdf.get(name).__name__.endswith(name)


@pytest.mark.parametrize("model", MODELS)
def test_evaluate_bsdf(inputs, model):
    x = inputs
    args = [x[k] for k in ("n", "t", "b", "wo", "wi")]
    ref = jbsdf.get(model).evaluate_bsdf(
        {k: jnp.asarray(v) for k, v in x["sd"].items()},
        *map(jnp.asarray, args))
    got = tbsdf.get(model).evaluate_bsdf(
        {k: torch.from_numpy(v) for k, v in x["sd"].items()},
        *map(torch.from_numpy, args))
    for what, a, b in zip(("value", "pdf"), ref, got):
        _close(a, b, what)
    assert float(got[1].gt(0).float().mean()) > 0.3


@pytest.mark.parametrize("model", MODELS)
def test_sample_bsdf(inputs, model):
    x = inputs
    args = [x[k] for k in ("n", "n", "t", "b", "wo", "t_dist", "backfacing",
                           "r3", "r4")]
    ref = jbsdf.get(model).sample_bsdf(
        {k: jnp.asarray(v) for k, v in x["sd"].items()},
        *map(jnp.asarray, args))
    got = tbsdf.get(model).sample_bsdf(
        {k: torch.from_numpy(v) for k, v in x["sd"].items()},
        *map(torch.from_numpy, args))
    assert np.array_equal(np.asarray(ref[3]), got[3].numpy())
    for what, a, b in zip(("direction", "pdf"), ref[1:3], got[1:3]):
        _close(a, b, what)
    # the value as the integrator's throughput takes it, times |n . wi|:
    # a value divided by a grazing cosine (0.035 in one microsurface
    # lane) carries that cosine's last-ulp difference past 1e-5
    n = x["n"]
    cos_j = np.abs((n * np.asarray(ref[1])).sum(-1, keepdims=True))
    cos_t = (torch.from_numpy(n) * got[1]).sum(-1, keepdim=True).abs()
    _close(np.asarray(ref[0]) * cos_j, got[0] * cos_t, "value * cos")
    assert float(got[2].gt(0).float().mean()) > 0.5
