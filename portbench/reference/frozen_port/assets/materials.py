"""PBR materials: descriptor + ``*.materials.json`` loader.

The port's copy of swift_game_engine_tpu/assets/materials.py.

Same material model and JSON schema as the reference
(reference: Game/Material.swift:11-163, Game/MaterialLoader.swift:13-156):
five texture slots (baseColor sRGB, normal, metallicRoughness with glTF
G=rough/B=metal packing, emissive sRGB, occlusion R) plus factors, alpha,
transmission/ior, unlit, normalScale, exposure and tone-map flags. Texture
files resolve relative to the JSON, then against asset search roots.

Cull mode / winding are kept as plain enums for the render paths.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from .procedural_textures import Texture


CULL_NONE, CULL_BACK, CULL_FRONT = 0, 1, 2
WINDING_CCW, WINDING_CW = 0, 1


@dataclass(frozen=True)
class Material:
    name: str = "material"
    base_color_texture: Optional[Texture] = None
    normal_texture: Optional[Texture] = None
    metallic_roughness_texture: Optional[Texture] = None
    emissive_texture: Optional[Texture] = None
    occlusion_texture: Optional[Texture] = None
    base_color_factor: tuple = (1.0, 1.0, 1.0)
    metallic_factor: float = 0.0
    roughness_factor: float = 0.5
    emissive_factor: tuple = (0.0, 0.0, 0.0)
    occlusion_strength: float = 1.0
    alpha: float = 1.0
    transmission_factor: float = 0.0
    ior: float = 1.5
    unlit: bool = False
    normal_scale: float = 1.0
    exposure: float = 1.0
    tone_mapped: bool = False
    cull_mode: int = CULL_BACK
    front_facing: int = WINDING_CCW

    def with_(self, **kw) -> "Material":
        return replace(self, **kw)


def _load_image(path: str, srgb: bool) -> Optional[Texture]:
    try:
        from PIL import Image
        img = Image.open(path).convert("RGBA")
        px = np.asarray(img, np.uint8)
        return Texture(px, srgb=srgb)
    except Exception as e:  # pragma: no cover - env dependent
        print(f"materials: failed to load texture {path}: {e}")
        return None


def _resolve(path: str, base_dir: str, search_roots=()) -> Optional[str]:
    """reference: Game/MaterialLoader.swift:107-124 (absolute, json-relative,
    then bundle-root fallbacks)."""
    if os.path.isabs(path):
        return path if os.path.exists(path) else None
    cand = os.path.join(base_dir, path)
    if os.path.exists(cand):
        return cand
    for root in search_roots:
        cand = os.path.join(root, path)
        if os.path.exists(cand):
            return cand
    return None


def load_materials(path: str, search_roots=()) -> dict[str, Material]:
    """Load a ``*.materials.json`` file into a name -> Material dict."""
    with open(path) as f:
        data = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))
    out: dict[str, Material] = {}
    for entry in data.get("materials", []):
        def tex(key, srgb):
            p = entry.get(key)
            if not p:
                return None
            resolved = _resolve(p, base_dir, search_roots)
            if resolved is None:
                print(f"materials: missing texture: {p}")
                return None
            return _load_image(resolved, srgb)

        def vec3(key, fallback):
            v = entry.get(key)
            if not v or len(v) < 3:
                return tuple(fallback)
            return (float(v[0]), float(v[1]), float(v[2]))

        name = entry["name"]
        out[name] = Material(
            name=name,
            base_color_texture=tex("baseColorTexture", True),
            normal_texture=tex("normalTexture", False),
            metallic_roughness_texture=tex("metallicRoughnessTexture", False),
            emissive_texture=tex("emissiveTexture", True),
            occlusion_texture=tex("occlusionTexture", False),
            base_color_factor=vec3("baseColorFactor", (1, 1, 1)),
            metallic_factor=float(entry.get("metallicFactor", 0.0)),
            roughness_factor=float(entry.get("roughnessFactor", 0.5)),
            emissive_factor=vec3("emissiveFactor", (0, 0, 0)),
            occlusion_strength=float(entry.get("occlusionStrength", 1.0)),
            alpha=float(entry.get("alpha", 1.0)),
            transmission_factor=float(entry.get("transmissionFactor", 0.0)),
            ior=float(entry.get("ior", 1.5)),
            unlit=bool(entry.get("unlit", False)),
            normal_scale=float(entry.get("normalScale", 1.0)),
        )
    return out
