"""Scene and material tables as frozen dataclasses of tensors.

Port of kylespathtracer_tpu/scene/types.py. Object IDs: 0 is "miss"; the
default scene uses the reference's IDs (common.glsl:220-226).

`scene_from_numpy` carries a JAX-side `Scene` across as numpy arrays, so
both packages compute on the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE


class OBJ:
    """Reference object IDs (common.glsl:220-226)."""

    MISS = 0
    LIGHT = 1
    FLOOR = 2
    WALL1 = 3
    BOX = 4
    WALL2 = 6
    CEIL = 7


class BSDF:
    """BSDF lobe kinds for `Materials.bsdf`."""

    DIFFUSE = 0
    GLOSSY = 1
    MIRROR = 2
    DIELECTRIC = 3


def _map_tensors(obj, fn):
    """dataclasses.replace with `fn` applied to every tensor field."""
    return dataclasses.replace(obj, **{
        f.name: fn(v) for f in dataclasses.fields(obj)
        if isinstance(v := getattr(obj, f.name), torch.Tensor)
    })


@dataclasses.dataclass(frozen=True)
class Materials:
    """Per-object-ID material table (s = s0 + s1·checker(hl·freq);
    albedo = alb_const + alb_scale·s; energy = en_const + en_scale·s)."""

    s0: torch.Tensor         # f32[K]
    s1: torch.Tensor         # f32[K]
    freq: torch.Tensor       # f32[K]
    alb_const: torch.Tensor  # f32[K,3]
    alb_scale: torch.Tensor  # f32[K,3]
    emission: torch.Tensor   # f32[K,3]
    en_const: torch.Tensor   # f32[K,2]
    en_scale: torch.Tensor   # f32[K,2]
    bsdf: torch.Tensor | None = None  # i32[K]
    ior: torch.Tensor | None = None   # f32[K]

    @property
    def num_ids(self) -> int:
        return self.s0.shape[0]

    def to(self, device) -> "Materials":
        return _map_tensors(self, lambda t: t.to(device))


def bsdf_table(materials: Materials) -> tuple[torch.Tensor, torch.Tensor]:
    """(bsdf[K] i32, ior[K] f32) with all-diffuse / ior-1.5 defaults."""
    k = materials.num_ids
    dev = materials.s0.device
    b = materials.bsdf
    if b is None:
        b = torch.zeros((k,), dtype=torch.int32, device=dev)
    i = materials.ior
    if i is None:
        i = torch.full((k,), 1.5, dtype=torch.float32, device=dev)
    return b, i


@dataclasses.dataclass(frozen=True)
class Scene:
    """Analytic scene: P planes, S spheres, B rounded boxes, materials."""

    planes: torch.Tensor      # f32[P,4] (n, d): signed distance = dot(p,n)+d
    plane_ids: torch.Tensor   # i32[P]
    spheres: torch.Tensor     # f32[S,4] (center, radius)
    sphere_ids: torch.Tensor  # i32[S]
    boxes: torch.Tensor       # f32[B,7] (center, half-extent, rounding radius)
    box_ids: torch.Tensor     # i32[B]
    light_color: torch.Tensor  # f32[3]
    materials: Materials
    light_index: int = 0      # index of the NEE light sphere in `spheres`

    @property
    def light(self) -> torch.Tensor:
        """The NEE sphere light as (pos, radius) — f32[4]."""
        return self.spheres[self.light_index]

    @property
    def light_id(self) -> torch.Tensor:
        return self.sphere_ids[self.light_index]

    @property
    def device(self) -> torch.device:
        return self.planes.device

    def to(self, device) -> "Scene":
        scene = _map_tensors(self, lambda t: t.to(device))
        return dataclasses.replace(scene, materials=self.materials.to(device))


_F32 = ("planes", "spheres", "boxes", "light_color")
_I32 = ("plane_ids", "sphere_ids", "box_ids")
_MAT_F32 = ("s0", "s1", "freq", "alb_const", "alb_scale", "emission",
            "en_const", "en_scale", "ior")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def materials_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> Materials:
    kw = {}
    for k in _MAT_F32 + ("bsdf",):
        v = tree.get(k)
        if v is not None:
            kw[k] = _tensor(v, np.int32 if k == "bsdf" else np.float32, device)
    return Materials(**kw)


def scene_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> Scene:
    """The port's `Scene` from a JAX `Scene` given as numpy arrays: every
    geometry field, `materials` as a dict of its fields, and `light_index`."""
    kw = {k: _tensor(tree[k], np.float32, device) for k in _F32}
    kw.update({k: _tensor(tree[k], np.int32, device) for k in _I32})
    return Scene(
        **kw,
        materials=materials_from_numpy(tree["materials"], device),
        light_index=int(tree.get("light_index", 0)),
    )
