"""Textures: load, mip chain, and the flat HBM atlas.

Reimplements the reference texture pipeline (texture.cpp): LDR images become
linear-RGBA float with a 5-level box-filtered mip chain (MIPLEVELCOUNT,
settings.h:3, texture.cpp:94,137); HDR images are float and unmipped
(texture.cpp:96-113). Like the CUDA backend — which flattens every texture
into one big device array (CUDART/src/Context.cpp:201-268) — all textures and
their mips are packed into a single (N, 4) float32 atlas; shading gathers rows
by computed address. One flat array + row gathers is the TPU-friendly layout.
"""

from __future__ import annotations


import numpy as np

from ..utils import image

MIP_LEVEL_COUNT = 5


class Texture:
    """Decoded texture with mip chain; mips[0] is the base level.

    File-backed textures are LAZY: ``Texture.load`` only stats the file
    (its stat digest keys both the mip cache and the atlas cache), and
    texels decode on first ``.mips`` access. When the atlas disk cache
    hits, a textured scene builds without ever touching a texel — the
    round-4 scene-build lever (decode+mip was ~8 s of the 16 s warm
    build for pica-4x)."""

    def __init__(self, mips: list[np.ndarray] | None = None,
                 is_hdr: bool = False, _lazy=None, _digest=None):
        self._mips = mips
        self.is_hdr = is_hdr
        self._lazy = _lazy
        if _digest is not None:
            self._digest = _digest   # atlas-key digest (see
        #                              build_atlases_cached's memo)

    @property
    def mips(self) -> list[np.ndarray]:
        if self._mips is None:
            self._mips = self._lazy()
        return self._mips

    @property
    def width(self) -> int:
        return self.mips[0].shape[1]

    @property
    def height(self) -> int:
        return self.mips[0].shape[0]

    @staticmethod
    def load(path: str) -> "Texture":
        p = str(path)
        is_hdr = p.lower().endswith(".hdr")
        key = _mip_key(p)   # stat digest: path | mtime | size

        def decode() -> list[np.ndarray]:
            cached = _mip_cache_load(p)
            if cached is not None:
                return cached.mips
            if is_hdr:
                rgb = image.load_hdr(p)
                rgba = np.concatenate(
                    [rgb, np.ones_like(rgb[..., :1])],
                    axis=-1).astype(np.float32)
                tex = Texture(mips=[rgba], is_hdr=True)
            else:
                base = image.load_ldr(p, to_linear=True)
                tex = Texture.from_array(base, is_hdr=False)
            _mip_cache_store(p, tex)
            return tex.mips

        if key is None:   # unreadable path: decode now so load() raises
            return Texture(mips=decode(), is_hdr=is_hdr)
        return Texture(is_hdr=is_hdr, _lazy=decode,
                       _digest=f"stat:{key}".encode())

    @staticmethod
    def from_array(base: np.ndarray, is_hdr: bool = False) -> "Texture":
        base = np.asarray(base, np.float32)
        if base.ndim == 2:
            base = base[..., None].repeat(3, axis=-1)
        if base.shape[-1] == 3:
            base = np.concatenate(
                [base, np.ones_like(base[..., :1])], axis=-1)
        mips = [base]
        if not is_hdr:
            for _ in range(MIP_LEVEL_COUNT - 1):
                mips.append(_downsample2x(mips[-1]))
        return Texture(mips=mips, is_hdr=is_hdr)


def _cache_dir() -> str | None:
    """The mip and atlas cache: the port's own directory, so that it never
    reads mips that rfw_tpu wrote (its odd-size mips differ, see
    ``_downsample2x``); ``RFW_TEX_CACHE_DIR`` overrides it."""
    import os
    if os.environ.get("RFW_NO_TEX_CACHE"):
        return None
    d = os.environ.get(
        "RFW_TEX_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "rfw_tpu_torch",
                     "tex"))
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def _mip_key(path: str) -> str | None:
    """Decoded-texture cache key: absolute path + mtime + size (the
    skybox .bin cache recipe, reference skybox.cpp:87-139, applied to
    every texture — PNG decode + sRGB→linear + mip build is ~60% of a
    textured scene's host load time)."""
    import hashlib
    import os
    try:
        st = os.stat(path)
    except OSError:
        return None
    raw = f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}|v1"
    return hashlib.sha1(raw.encode()).hexdigest()


def _mip_cache_load(path: str) -> "Texture | None":
    d = _cache_dir()
    key = d and _mip_key(path)
    if not key:
        return None
    import os
    f = os.path.join(d, f"mips_{key}.npz")
    try:
        z = np.load(f)
        n = int(z["n_mips"])
        return Texture(mips=[z[f"m{i}"] for i in range(n)],
                       is_hdr=bool(z["is_hdr"]))
    except (OSError, KeyError, ValueError):
        return None


def _mip_cache_store(path: str, tex: "Texture") -> None:
    d = _cache_dir()
    key = d and _mip_key(path)
    if not key:
        return
    import os
    f = os.path.join(d, f"mips_{key}.npz")
    try:
        # tmp name must end in .npz — np.savez APPENDS the suffix
        # otherwise and os.replace would miss the real file
        tmp = f"{f}.{os.getpid()}.tmp.npz"
        np.savez(tmp, n_mips=len(tex.mips), is_hdr=tex.is_hdr,
                 **{f"m{i}": m for i, m in enumerate(tex.mips)})
        os.replace(tmp, f)
    except OSError:
        pass


def _downsample2x(img: np.ndarray) -> np.ndarray:
    """2x box filter (texture.cpp mip build). The next level is
    floor(size / 2): an odd size drops its last row or column, so every
    texel stays the equal-weight mean of a 2x2 block and the level sizes
    are the ``size >> level`` the atlases assume; a size of 1 repeats its
    edge. (rfw_tpu pads by a negative width there and raises.)"""
    h, w, c = img.shape
    if h <= 1 and w <= 1:
        return img.copy()
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    img = img[:2 * h2, :2 * w2]
    if img.shape[:2] != (2 * h2, 2 * w2):
        img = np.pad(img, ((0, 2 * h2 - img.shape[0]),
                           (0, 2 * w2 - img.shape[1]), (0, 0)), mode="edge")
    return img.reshape(h2, 2, w2, 2, c).mean(axis=(1, 3)).astype(np.float32)


def _resample_bilinear_wrap(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resample (H0, W0, 4) → (h, w, 4) with repeat wrap."""
    h0, w0, _ = img.shape
    if (h0, w0) == (h, w):
        return img
    x = (np.arange(w, dtype=np.float32) + 0.5) / w * w0 - 0.5
    y = (np.arange(h, dtype=np.float32) + 0.5) / h * h0 - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[None, :, None]
    fy = (y - y0)[:, None, None]
    x0w, x1w = x0 % w0, (x0 + 1) % w0
    y0w, y1w = y0 % h0, (y0 + 1) % h0
    top = (1 - fx) * img[y0w][:, x0w] + fx * img[y0w][:, x1w]
    bot = (1 - fx) * img[y1w][:, x0w] + fx * img[y1w][:, x1w]
    return ((1 - fy) * top + fy * bot).astype(np.float32)


def _pack_rgba8(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) f32 [0,1] → (H*W,) u32 RGBA8 (r in bits 0-7)."""
    q = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint32)
    return (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
            | (q[..., 3] << 24)).reshape(-1)


_FLAT_NORMAL = np.array([0.5, 0.5, 1.0, 1.0], np.float32)


def build_merged_material_atlas(materials, textures: list[Texture]):
    """Merge each material's diffuse/normal/roughness maps into ONE texture
    whose texels pack all three as RGBA8 u32 words, so shading needs one
    trilinear fetch (8 row gathers) instead of three (24) — the gather count,
    not bandwidth, is the TPU cost (measured: 24 separate row gathers cost
    ~264 ms per 518k lanes; one fused (R,24) gather is worse; multi-row
    slice gathers are 30x worse — tools/shade_opt.py).

    Texel layout: word0 = diffuse RGBA8, word1 = normal-map RGBA8,
    word2 = roughness/metalness RGBA8 (glTF convention: G=rough, B=metal),
    Unbound slots bake neutral texels (white / flat
    normal) but shading still applies its has-texture masks, so unbound
    behavior is bit-identical to the legacy path.

    8-bit quantization matches the reference's RGBA8 texture storage
    (texture.cpp LDR path). Entries are deduped by (tex0, tex1, tex3)
    triple; resolutions unify to the max of the bound maps per mip.

    Returns (matlas dict | None, mtex_id (M,) i32). None = scene ineligible
    (an HDR map bound to a material slot, or a non-identity UV transform on
    a material that also binds normal/rough maps — those need per-slot UVs).
    """
    from .materials import TEX_DIFFUSE, TEX_NORMAL, TEX_ROUGHNESS

    mats = materials or []
    mtex_id = np.zeros(max(len(mats), 1), np.int32)
    if not textures or not mats:
        return None, mtex_id

    entries: dict[tuple, int] = {}
    chunks: list[np.ndarray] = []
    desc_rows: list[np.ndarray] = []
    addr = 0

    def add_entry(t0: int, t1: int, t3: int) -> int:
        nonlocal addr
        key = (t0, t1, t3)
        if key in entries:
            return entries[key]
        bound = [textures[t] for t in (t0, t1, t3) if t >= 0]
        bw = max((t.width for t in bound), default=1)
        bh = max((t.height for t in bound), default=1)
        drow = np.zeros((MIP_LEVEL_COUNT, 3), np.int64)
        for level in range(MIP_LEVEL_COUNT):
            w = max(bw >> level, 1)
            h = max(bh >> level, 1)
            words = []
            for tid, default in ((t0, np.ones(4, np.float32)),
                                 (t1, _FLAT_NORMAL),
                                 (t3, np.ones(4, np.float32))):
                if tid < 0:
                    img = np.broadcast_to(default, (h, w, 4))
                else:
                    mips = textures[tid].mips
                    img = _resample_bilinear_wrap(
                        mips[min(level, len(mips) - 1)], w, h)
                words.append(_pack_rgba8(img))
            texels = np.zeros((w * h, 3), np.uint32)
            texels[:, 0], texels[:, 1], texels[:, 2] = words
            chunks.append(texels)
            drow[level] = (addr, w, h)
            addr += w * h
        desc_rows.append(drow)
        eid = len(desc_rows) - 1
        entries[key] = eid
        return eid

    from .materials import (TEX_DIFFUSE1, TEX_DIFFUSE2, TEX_NORMAL1,
                            TEX_NORMAL2)

    add_entry(-1, -1, -1)   # entry 0: neutral (untextured materials)
    for i, m in enumerate(mats):
        t0 = m.maps[TEX_DIFFUSE].texture_id
        t1 = m.maps[TEX_NORMAL].texture_id
        t3 = m.maps[TEX_ROUGHNESS].texture_id
        if len(m.maps) > TEX_NORMAL2 and any(
                m.maps[s].texture_id >= 0
                for s in (TEX_DIFFUSE1, TEX_DIFFUSE2, TEX_NORMAL1,
                          TEX_NORMAL2)):
            # additive texture layers need the flat-atlas path (the
            # merged texel holds exactly one map per word)
            return None, np.zeros(max(len(mats), 1), np.int32)
        for t in (t0, t1, t3):
            if t >= 0 and textures[t].is_hdr:
                return None, np.zeros(max(len(mats), 1), np.int32)
        mp = m.maps[TEX_DIFFUSE]
        identity_uv = (tuple(mp.uv_scale) == (1.0, 1.0)
                       and tuple(mp.uv_offset) == (0.0, 0.0))
        if not identity_uv and (t1 >= 0 or t3 >= 0):
            return None, np.zeros(max(len(mats), 1), np.int32)
        mtex_id[i] = add_entry(t0, t1, t3)

    matlas = {
        "matlas": np.concatenate(chunks, axis=0),
        "matlas_desc": np.stack(desc_rows).astype(np.int32),
    }
    return matlas, mtex_id


def build_atlases_cached(materials, textures: list[Texture],
                         merged: bool):
    """Atlas assembly with a disk cache: returns (atlas_dict, mtex_id).

    ``atlas_dict`` holds {"atlas", "desc"} plus {"matlas", "matlas_desc"}
    when ``merged`` and the scene is eligible; ``mtex_id`` is the
    per-material merged-entry table (None when not merged). The pack +
    resample + quantize pipeline is ~10 s for a Sponza-class texture set
    and is a pure function of (texture contents, material bindings) — the
    cache keys on sha1 of every base mip + the binding tuples, so edits
    invalidate precisely."""
    import hashlib
    import os

    d = _cache_dir()
    key = None
    if d is not None:
        h = hashlib.sha1(f"v2|{MIP_LEVEL_COUNT}|{merged}".encode())
        for t in textures:
            dig = getattr(t, "_digest", None)
            if dig is None:
                # memoize per Texture: synchronize() re-keys on every
                # materials-dirty edit, and hashing hundreds of MB of
                # texels per edit would dominate interactive latency
                m0 = np.ascontiguousarray(t.mips[0])
                hd = hashlib.sha1(
                    str((m0.shape, str(m0.dtype), t.is_hdr)).encode())
                hd.update(m0.tobytes())
                dig = hd.digest()
                try:
                    t._digest = dig
                except AttributeError:
                    pass
            h.update(dig)
        if merged:
            # hash EVERY slot binding — matlas eligibility depends on
            # layer slots too, so a partial key would alias scenes
            for m in materials or []:
                h.update(str([
                    (mp.texture_id,
                     tuple(np.asarray(mp.uv_scale).tolist()),
                     tuple(np.asarray(mp.uv_offset).tolist()))
                    for mp in m.maps]).encode())
        key = h.hexdigest()
        # per-member .npy files so the big planes load MEMORY-MAPPED: the
        # merged-atlas engine path replaces "atlas" with a 1-texel stub
        # before upload, so eagerly reading its ~190 MB from the cache
        # (~0.7-1.9 s, the largest single cost of a warm scene build) was
        # pure waste; mmap defers each member's IO to first touch
        # (device_put pages it in exactly once for members that DO ship)
        mdir = os.path.join(d, f"atlas_{key}")
        try:
            atlas = {
                "atlas": np.load(os.path.join(mdir, "atlas.npy"),
                                 mmap_mode="r"),
                "desc": np.load(os.path.join(mdir, "desc.npy")),
            }
            mp = os.path.join(mdir, "matlas.npy")
            if os.path.exists(mp):
                atlas["matlas"] = np.load(mp, mmap_mode="r")
                atlas["matlas_desc"] = np.load(
                    os.path.join(mdir, "matlas_desc.npy"))
            ip = os.path.join(mdir, "mtex_id.npy")
            mtex_id = np.load(ip) if os.path.exists(ip) else None
            return atlas, mtex_id
        except (OSError, KeyError, ValueError):
            pass
        # legacy single-npz cache (pre-mmap format): npz members can't
        # mmap, so this pays an eager multi-hundred-MB read (~6.5 s for
        # the bench scene's 337 MB atlas — round-4 profile). Load once,
        # MIGRATE to the member-dir format and drop the npz so every
        # later build takes the mmap path above.
        f = os.path.join(d, f"atlas_{key}.npz")
        try:
            z = np.load(f)
            atlas = {"atlas": z["atlas"], "desc": z["desc"]}
            if "matlas" in z.files:
                atlas["matlas"] = z["matlas"]
                atlas["matlas_desc"] = z["matlas_desc"]
            mtex_id = z["mtex_id"] if "mtex_id" in z.files else None
            _publish_member_dir(d, key, atlas, mtex_id)
            try:
                os.remove(f)
            except OSError:
                pass
            return atlas, mtex_id
        except (OSError, KeyError, ValueError):
            pass

    atlas = build_texture_atlas(textures)
    mtex_id = None
    if merged:
        matlas, mtex_id = build_merged_material_atlas(materials, textures)
        if matlas is not None:
            atlas.update(matlas)
    if key is not None:
        _publish_member_dir(d, key, atlas, mtex_id)
    return atlas, mtex_id


def _publish_member_dir(d, key, atlas, mtex_id) -> None:
    """Write the per-member .npy atlas cache dir (atomic publish)."""
    import os
    try:
        save = dict(atlas)
        if mtex_id is not None:
            save["mtex_id"] = mtex_id
        mdir = os.path.join(d, f"atlas_{key}")
        tdir = f"{mdir}.{os.getpid()}.tmp"
        os.makedirs(tdir, exist_ok=True)
        for name, arr in save.items():
            np.save(os.path.join(tdir, f"{name}.npy"), arr)
        os.replace(tdir, mdir)   # atomic publish (same filesystem)
    except OSError:
        pass


def build_texture_atlas(textures: list[Texture]) -> dict[str, np.ndarray]:
    """Pack all textures' mip chains into one flat (N, 4) array.

    Returns {"atlas": (N,4) f32, "desc": (T, MIP_LEVEL_COUNT, 3) i32} where
    desc[t, l] = (addr, width, height); unmipped textures repeat level 0 so
    LOD lookups need no branching. With no textures, a 1-texel white atlas is
    emitted so jitted code has a valid array to gather from.
    """
    if not textures:
        atlas = np.ones((1, 4), np.float32)
        desc = np.zeros((1, MIP_LEVEL_COUNT, 3), np.int32)
        desc[0, :, 1:] = 1
        return {"atlas": atlas, "desc": desc}

    chunks: list[np.ndarray] = []
    desc = np.zeros((len(textures), MIP_LEVEL_COUNT, 3), np.int32)
    addr = 0
    for t, tex in enumerate(textures):
        for level in range(MIP_LEVEL_COUNT):
            mip = tex.mips[min(level, len(tex.mips) - 1)]
            h, w, _ = mip.shape
            if level < len(tex.mips):
                chunks.append(mip.reshape(-1, 4))
                desc[t, level] = (addr, w, h)
                addr += w * h
            else:  # reuse the last real mip's storage
                desc[t, level] = desc[t, len(tex.mips) - 1]
    atlas = np.concatenate(chunks, axis=0).astype(np.float32)
    return {"atlas": atlas, "desc": desc}
