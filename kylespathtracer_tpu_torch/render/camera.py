"""Camera model and primary-ray generation.

Port of kylespathtracer_tpu/render/camera.py (geometry.frag:38-39,67).
Pixel row 0 is the *bottom* of the image (GL fragCoord).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kylespathtracer_tpu_torch import DEFAULT_DEVICE
from kylespathtracer_tpu_torch.core import gmath


@dataclasses.dataclass(frozen=True)
class Camera:
    loc: torch.Tensor     # f32[3] (or [T,3] for a stacked path)
    orient: torch.Tensor  # f32[2] (pitch, yaw)

    @classmethod
    def create(cls, loc=(3.0, 2.0, -3.0), orient=(0.0, 0.0), device=DEFAULT_DEVICE
               ) -> "Camera":
        return cls(
            loc=torch.tensor(loc, dtype=torch.float32, device=device),
            orient=torch.tensor(orient, dtype=torch.float32, device=device),
        )

    def to(self, device) -> "Camera":
        return Camera(loc=self.loc.to(device), orient=self.orient.to(device))

    def __getitem__(self, i) -> "Camera":
        """Frame i of a stacked camera path."""
        return Camera(loc=self.loc[i], orient=self.orient[i])

    def __len__(self) -> int:
        return self.loc.shape[0]


def camera_from_numpy(tree: dict, device=DEFAULT_DEVICE) -> Camera:
    """The port's `Camera` from a JAX `Camera` given as numpy arrays."""
    return Camera(
        loc=torch.as_tensor(np.array(tree["loc"], np.float32), device=device),
        orient=torch.as_tensor(np.array(tree["orient"], np.float32), device=device),
    )


def ndc_grid(width: int, height: int, device=DEFAULT_DEVICE, row0: int = 0,
             rows: int | None = None) -> torch.Tensor:
    """Aspect-scaled NDC coords of the pixel centers of image rows
    [row0, row0+rows) (all rows by default); f32[rows, W, 2]. The divisors
    are tensors on the device: on the card torch divides by a Python scalar
    as a multiply by its reciprocal, an ulp off the true quotient that the
    kernels compute."""
    asp = width / height
    rows = height if rows is None else rows
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=device)
    div = lambda n: torch.tensor(float(n), dtype=torch.float32, device=device)
    x = (2.0 * (ar(width) + 0.5) / div(width) - 1.0) * asp
    y = 2.0 * (row0 + ar(rows) + 0.5) / div(height) - 1.0
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def ray_dirs(camera: Camera, width: int, height: int, fov: float = gmath.FOV
             ) -> torch.Tensor:
    """Primary ray directions f32[H, W, 3]:
    rd = rotateXY(normalize(vec3(ndca, FOV)), orient) (geometry.frag:67)."""
    return ray_dirs_window(camera, width, height, 0, height, fov)


def ray_dirs_window(camera: Camera, width: int, height: int, row0: int, rows: int,
                    fov: float = gmath.FOV) -> torch.Tensor:
    """Ray directions f32[rows, W, 3] of image rows [row0, row0+rows) of a
    height-row image (a tile of the sharded renderer), bitwise the matching
    rows of `ray_dirs`."""
    ndca = ndc_grid(width, height, camera.orient.device, row0, rows)
    d = torch.cat([ndca, torch.full_like(ndca[..., :1], fov)], dim=-1)
    return gmath.rotate_xy(gmath.normalize_fast(d), camera.orient)


def camera_pose_spline(t) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's scripted camera path (geometry.frag:26-55):
    smoothstep between three poses on a 6-second loop → (loc[3], orient[2])."""
    poses_loc = torch.tensor(
        [[4.8, 0.5, -9.5], [4.8, 0.5, -4.8], [-3.5, 2.5, -4.0]], dtype=torch.float32
    )
    poses_or = torch.tensor(
        [[0.20, 0.85], [0.15, 2.33], [0.10, 1.80]], dtype=torch.float32
    )
    tt = torch.as_tensor(t, dtype=torch.float32) * 0.5
    i0 = torch.floor(torch.remainder(tt, 6.0) / 2.0).long()
    i1 = torch.floor(torch.remainder(tt + 1.0, 6.0) / 2.0).long()
    ft = gmath.smoothstep01(tt - torch.floor(tt))
    loc = gmath.mix(poses_loc[i0], poses_loc[i1], ft[..., None])
    orient = gmath.mix(poses_or[i0], poses_or[i1], ft[..., None])
    return loc, orient
