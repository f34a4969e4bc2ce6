"""BSDF library (torch port of ``rfw_tpu.ops.bsdf``): the Disney model
by default, Lambert, GGX microfacet and the multiple-scattering
microsurface as alternatives (``RenderConfig.bsdf``)."""

from . import common, disney, lambert, microfacet, microsurface

_REGISTRY = {"disney": disney, "lambert": lambert,
             "microfacet": microfacet, "microsurface": microsurface}


def get(name: str):
    return _REGISTRY[name]


__all__ = ["common", "disney", "lambert", "microfacet", "microsurface",
           "get"]
