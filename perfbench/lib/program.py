"""Builds a configuration's scene in the program through its public API
(``RenderSystem.add_material``, ``add_object``, ``add_quad``,
``add_instance``, ``set_skybox``, ``camera``) from the layout that
``bench.layout`` makes and the configuration's materials, sky and
camera. The PLYs are written under a work directory the caller gives
(the run's ``TMPDIR``)."""

from __future__ import annotations

import math
import os

import numpy as np

from . import geometry


def build(rs, config: dict, layout: list[dict], workdir: str) -> list:
    """Add the scene to ``rs``; returns the instance refs in layout
    order."""
    mats = {name: rs.add_material(**m)
            for name, m in config["materials"].items()}
    objects, refs = {}, []
    for inst in layout:
        name = inst["mesh"]
        if name in objects:
            geom = objects[name]
        elif inst.get("quad"):
            geom = objects[name] = rs.add_quad(
                material_id=mats[inst["material"]], **inst["quad"])
        else:
            path = os.path.join(workdir, f"{name}.ply")
            geometry.write_ply(path, inst["pos"], inst["nrm"], inst["faces"],
                               inst["uv"])
            geom = objects[name] = rs.add_object(
                path, material_override=mats[inst["material"]])
        if inst["scale"] is not None:
            refs.append(rs.add_instance(geom, scale=tuple(inst["scale"]),
                                        translation=inst["translation"]))
        else:
            refs.append(rs.add_instance(geom))
    rs.set_skybox(geometry.sky_pixels(config["sky"]))
    return refs


def camera_eye(config: dict, orbit: float, seed: int) -> np.ndarray:
    """The camera's place drawn from ``seed``: on a horizontal circle of
    ``orbit`` times the eye's distance to its target, round the
    configuration's eye."""
    cam = config["camera"]
    eye = np.asarray(cam["eye"], np.float64)
    r = orbit * np.linalg.norm(eye - np.asarray(cam["target"], np.float64))
    phi = np.random.default_rng([seed, 1]).uniform(0.0, 2.0 * math.pi)
    return (eye + r * np.array([math.cos(phi), 0.0, math.sin(phi)])
            ).astype(np.float32)


def place_camera(rs, config: dict, eye) -> None:
    """The configuration's camera at ``eye``."""
    cam = config["camera"]
    rs.camera.resize(config["width"], config["height"])
    rs.camera.fov = cam["fov"]
    rs.camera.focal_distance = cam["focal_distance"]
    rs.camera.aperture = cam["aperture"]
    rs.camera.look_at(np.asarray(eye, np.float32), cam["target"])
