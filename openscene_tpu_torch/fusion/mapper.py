"""Point-cloud -> image projection with depth-occlusion visibility.

Re-implements the reference's ``PointCloudToImageMapper.compute_mapping``
(scripts/feature_fusion/fusion_util.py:93-139) semantics:

* world -> camera via inv(camera_to_world), pinhole projection, ROUNDED pixel
  coordinates, in-bounds test with a ``cut_bound`` margin;
* occlusion: |depth[pix] - z_cam| <= vis_thres * depth[pix];
* without a depth map: front-facing test (z > 0) only.

Provided both as the NumPy float64 reference (``PointCloudToImageMapper``)
and as ``compute_mapping_torch``, the fp32 tensor version the fuser runs on
its device, several views at once.  The tensor version follows the JAX
package's ``compute_mapping_jax`` op for op (bit for bit on the CPU test
fixtures), with the same float-to-int cast on every device, also where the
JAX package departs from the NumPy reference: a point at the camera centre
projects to NaN, which that cast turns into pixel (0, 0) (the NumPy cast
puts it out of bounds), so with ``cut_bound`` 0 it counts as visible
wherever ``depth[0, 0] == 0``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# |coordinate| cap before the int32 cast: fp32 cannot hold 2**31 - 1, and a
# pixel coordinate this large is outside every image whatever its exact size
INT_CAP = 2.0 ** 30


class PointCloudToImageMapper:
    def __init__(self, image_dim: Tuple[int, int],
                 visibility_threshold: float = 0.25, cut_bound: int = 0,
                 intrinsics: Optional[np.ndarray] = None):
        self.image_dim = image_dim
        self.vis_thres = visibility_threshold
        self.cut_bound = cut_bound
        self.intrinsics = intrinsics

    def compute_mapping(self, camera_to_world: np.ndarray, coords: np.ndarray,
                        depth: Optional[np.ndarray] = None,
                        intrinsic: Optional[np.ndarray] = None) -> np.ndarray:
        """(N, 3) int mapping rows (v, u, visible) — NumPy reference."""
        if self.intrinsics is not None:
            intrinsic = self.intrinsics
        n = coords.shape[0]
        mapping = np.zeros((3, n), dtype=np.int64)
        homo = np.concatenate([coords, np.ones((n, 1))], axis=1).T
        p = np.linalg.inv(camera_to_world) @ homo
        p[0] = (p[0] * intrinsic[0][0]) / p[2] + intrinsic[0][2]
        p[1] = (p[1] * intrinsic[1][1]) / p[2] + intrinsic[1][2]
        pi = np.round(p).astype(np.int64)
        W, H = self.image_dim
        cb = self.cut_bound
        inside = ((pi[0] >= cb) & (pi[1] >= cb) & (pi[0] < W - cb)
                  & (pi[1] < H - cb))
        if depth is not None:
            d = depth[pi[1][inside], pi[0][inside]]
            occ = np.abs(d - p[2][inside]) <= self.vis_thres * d
            inside[inside] = occ
        else:
            inside = inside & (p[2] > 0)
        mapping[0][inside] = pi[1][inside]
        mapping[1][inside] = pi[0][inside]
        mapping[2][inside] = 1
        return mapping.T


def round_to_int32(x: torch.Tensor) -> torch.Tensor:
    """``round(x).astype(int32)`` as XLA computes it, on every device: half
    to even, NaN -> 0, and saturation (capped at ``INT_CAP``, which decides
    every bounds test the same way as the int32 limits).  The device's own
    float-to-int cast is not used for NaN or out-of-range values: the CPU's
    gives INT32_MIN for all of them."""
    return torch.round(x).nan_to_num_(nan=0.0).clamp_(-INT_CAP, INT_CAP).to(
        torch.int32)


def compute_mapping_torch(camera_to_world: torch.Tensor,
                          intrinsic: torch.Tensor, coords: torch.Tensor,
                          depth: Optional[torch.Tensor],
                          image_dim: Tuple[int, int], vis_thres: float,
                          cut_bound: int, use_depth: bool = True):
    """Mapping of one view, or of K views at once, in fp32 on ``coords``'
    device: ``compute_mapping_jax``'s arithmetic op for op.

    camera_to_world: ([K,] 4, 4); intrinsic: ([K,] >=3, >=3); coords: (N, 3);
    depth: ([K,] H, W) (zeros or None with use_depth=False: the lidar /
    no-depth front-facing path).  The pose is inverted in fp32.  Returns
    (v, u, visible), each ([K,] N): int32 pixel rows and columns, 0 off the
    visible set, and a bool mask.
    """
    single = camera_to_world.dim() == 2
    pose = camera_to_world.reshape(-1, 4, 4).float()
    intr = intrinsic.reshape(pose.shape[0], *intrinsic.shape[-2:]).float()
    coords = coords.float()
    n = coords.shape[0]
    homo = torch.cat([coords, coords.new_ones((n, 1))], dim=1)
    world_to_cam = torch.linalg.inv(pose)
    # (K, N, 4), in full fp32: resolve_device turns TF32 off on CUDA
    p = torch.matmul(homo, world_to_cam.transpose(1, 2))
    z = p[..., 2]
    fx, cx = intr[:, 0, 0, None], intr[:, 0, 2, None]
    fy, cy = intr[:, 1, 1, None], intr[:, 1, 2, None]
    u = round_to_int32(p[..., 0] * fx / z + cx)
    v = round_to_int32(p[..., 1] * fy / z + cy)
    W, H = image_dim
    cb = cut_bound
    inside = (u >= cb) & (v >= cb) & (u < W - cb) & (v < H - cb)
    if use_depth:
        uc = u.clamp(0, W - 1)
        vc = v.clamp(0, H - 1)
        flat = depth.reshape(pose.shape[0], H * W).float()
        d = torch.gather(flat, 1, (vc * W + uc).long())
        visible = inside & ((d - z).abs() <= vis_thres * d)
    else:
        visible = inside & (z > 0)
    zero = torch.zeros((), dtype=torch.int32, device=coords.device)
    v = torch.where(visible, v, zero)
    u = torch.where(visible, u, zero)
    if single:
        return v[0], u[0], visible[0]
    return v, u, visible


def make_intrinsic(fx: float, fy: float, mx: float, my: float) -> np.ndarray:
    intrinsic = np.eye(4)
    intrinsic[0, 0], intrinsic[1, 1] = fx, fy
    intrinsic[0, 2], intrinsic[1, 2] = mx, my
    return intrinsic


def adjust_intrinsic(intrinsic: np.ndarray,
                     intrinsic_image_dim: Tuple[int, int],
                     image_dim: Tuple[int, int]) -> np.ndarray:
    """Rescale intrinsics to a resized image (fusion_util.py:27-39)."""
    import math
    if intrinsic_image_dim == image_dim:
        return intrinsic
    intrinsic = intrinsic.copy()
    resize_width = int(math.floor(
        image_dim[1] * float(intrinsic_image_dim[0])
        / float(intrinsic_image_dim[1])))
    intrinsic[0, 0] *= float(resize_width) / float(intrinsic_image_dim[0])
    intrinsic[1, 1] *= float(image_dim[1]) / float(intrinsic_image_dim[1])
    intrinsic[0, 2] *= float(image_dim[0] - 1) / float(intrinsic_image_dim[0] - 1)
    intrinsic[1, 2] *= float(image_dim[1] - 1) / float(intrinsic_image_dim[1] - 1)
    return intrinsic
