"""Multi-view feature fusion: project per-pixel 2D features onto 3D points.

The port of ``openscene_tpu.fusion.fuse`` (the reference's fusion job,
scripts/feature_fusion/{scannet,matterport,nuscenes,replica}_openseg.py):
for each scene, every selected view's CLIP-aligned 2D feature map is sampled
at each 3D point's projected pixel (with the depth-occlusion test) and
averaged over views into one feature per point; train scenes are saved as
``num_rand_file_per_scene`` random point chunks intersected with the
visibility mask (fusion_util.py:70-90).

The 2D feature extractor (OpenSeg/LSeg) is a frozen external teacher: this
module consumes per-view feature maps from a callback — precomputed arrays on
disk, a live TF SavedModel wrapper, or the synthetic generator in tests.

``MultiViewFuser`` runs on its device (``cuda`` unless the caller passes
``device="cpu"``) in plain PyTorch; the JAX package's fusion has no Pallas
kernel either.  A scene takes two passes:

1. projection and occlusion (``mapper.compute_mapping_torch``), views
   stacked ``views_per_dispatch`` at a time, the visible (point, pixel)
   pairs of each view compacted; the host waits for each step's pairs and
   their counts while the device has nothing else queued;
2. features, one view at a time in view order, with no host read: the
   teacher's map keeps its dtype on the host (fp16 stays fp16), goes to the
   device through a pinned staging buffer (two of them, so the host fills
   one while the other is copied), is laid out once as (H*W, C) rows,
   and the visible points' rows are gathered, upcast to fp32 and added into
   ``sum_feat`` (``index_add_`` of the visible rows only: for finite maps
   this equals the JAX step's ``s + sampled * m``, and each point appears
   once per view, so the fp32 sums run in view order as there).

The JAX step pads its last chunk of views to one compiled shape; the port
has no compiled shape and does not pad.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..data.scene_io import save_fused_features
from ..device import resolve_device
from .mapper import compute_mapping_torch


def save_fused_feature(feat_bank: np.ndarray, point_ids: np.ndarray,
                       n_points: int, out_dir: str, scene_id: str,
                       num_rand_file_per_scene: int, n_split_points: int,
                       rng: Optional[np.random.Generator] = None) -> None:
    """Chunked save, reference fusion_util.py:70-90: for each of the k output
    files pick n_split_points random points, intersect with visibility, store
    {'feat' (fp16 compact), 'mask_full'}."""
    rng = rng if rng is not None else np.random.default_rng()
    os.makedirs(out_dir, exist_ok=True)
    visible = np.zeros(n_points, dtype=bool)
    visible[point_ids] = True
    for k in range(num_rand_file_per_scene):
        n_cur = min(n_points, n_split_points)
        rand_ind = rng.choice(n_points, n_cur, replace=False)
        mask_entire = np.zeros(n_points, dtype=bool)
        mask_entire[rand_ind] = True
        mask_entire &= visible
        save_fused_features(join(out_dir, f"{scene_id}_{k}.npz"),
                            feat_bank[mask_entire].astype(np.float16),
                            mask_entire)


class MultiViewFuser:
    """Fuse per-view 2D features onto a scene's points on ``device``.

    feature_fn(view_id) -> (C, H, W) float feature map for that view (the
    frozen 2D teacher's output).
    """

    def __init__(self, image_dim: Tuple[int, int], vis_thres: float = 0.25,
                 cut_bound: int = 0, use_depth: bool = True,
                 feat_dim: int = 768, views_per_dispatch: int = 4,
                 device=None):
        self.image_dim = image_dim
        self.vis_thres = vis_thres
        self.cut_bound = cut_bound
        self.use_depth = use_depth
        self.feat_dim = feat_dim
        self.views_per_dispatch = max(1, views_per_dispatch)
        self.device = resolve_device(device)
        self._staging = {}  # (shape, dtype) -> [pinned, on device, event] x 2
        self._slot = 0

    def _project(self, coords: torch.Tensor, views: List, counter):
        """Pass 1: per view, the visible points' ids and flat pixel indices
        (int64 tensors on the device); ``counter`` += visibility."""
        W, H = self.image_dim
        dev = self.device
        out = []
        for start in range(0, len(views), self.views_per_dispatch):
            chunk = views[start:start + self.views_per_dispatch]
            poses = np.stack([np.asarray(p, np.float32) for p, _, _ in chunk])
            intrs = np.stack([np.asarray(i, np.float32)[:3, :3]
                              for _, i, _ in chunk])
            depths = np.stack([
                np.zeros((H, W), np.float32) if d is None
                else np.asarray(d, np.float32) for _, _, d in chunk])
            v, u, visible = compute_mapping_torch(
                torch.as_tensor(poses, device=dev),
                torch.as_tensor(intrs, device=dev), coords,
                torch.as_tensor(depths, device=dev), (W, H), self.vis_thres,
                self.cut_bound, self.use_depth)
            counter += visible.sum(0, dtype=torch.int32)
            pix = (v.long() * W + u.long()).reshape(-1)
            flat = visible.reshape(-1).nonzero().squeeze(1)
            sizes = visible.sum(1).tolist()
            n = coords.shape[0]
            out.extend(zip(torch.split(flat % n, sizes),
                           torch.split(pix[flat], sizes)))
        return out

    def _upload(self, fmap: np.ndarray) -> torch.Tensor:
        """The teacher's (C, H, W) map on the device, in its own dtype; on
        CUDA through the next of two pinned staging buffers."""
        src = torch.from_numpy(np.ascontiguousarray(fmap))
        if self.device.type != "cuda":
            return src.to(self.device)
        key = (tuple(src.shape), src.dtype)
        slots = self._staging.get(key)
        if slots is None:
            slots = [[torch.empty(key[0], dtype=key[1], pin_memory=True),
                      torch.empty(key[0], dtype=key[1], device=self.device),
                      torch.cuda.Event()] for _ in range(2)]
            self._staging[key] = slots
        self._slot ^= 1
        host, dev, copied = slots[self._slot]
        copied.synchronize()  # this buffer's previous copy has finished
        host.copy_(src)
        dev.copy_(host, non_blocking=True)
        copied.record()
        return dev

    def accumulate(self, coords: np.ndarray,
                   views: Iterable[Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]],
                   feature_fn: Callable[[int], np.ndarray]):
        """(sum_feat (N, C) fp32, counter (N,) int32) on the device: the sum
        of each point's sampled features over the views that see it, and
        their count."""
        n = coords.shape[0]
        dev = self.device
        W, H = self.image_dim
        C = self.feat_dim
        coords_t = torch.as_tensor(np.asarray(coords, np.float32), device=dev)
        sum_feat = torch.zeros((n, C), dtype=torch.float32, device=dev)
        counter = torch.zeros(n, dtype=torch.int32, device=dev)
        pairs = self._project(coords_t, list(views), counter)
        for i, (ids, pix) in enumerate(pairs):
            fmap = self._upload(feature_fn(i))
            rows = fmap.reshape(C, H * W).t().contiguous()  # (H*W, C)
            sum_feat.index_add_(0, ids, rows.index_select(0, pix).float())
        return sum_feat, counter

    def fuse_scene(self, coords: np.ndarray,
                   views: Iterable[Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]],
                   feature_fn: Callable[[int], np.ndarray]):
        """views: iterable of (pose 4x4, intrinsic, depth HxW or None).

        Returns (feat_bank (N, C) float32 averaged, point_ids of points seen
        in >= 1 view) as NumPy arrays — reference scannet_openseg.py:74-111
        semantics, the JAX package's ``fuse_scene`` results.
        """
        sum_feat, counter = self.accumulate(coords, views, feature_fn)
        feat_bank = sum_feat / counter.clamp(min=1)[:, None]
        point_ids = torch.nonzero(counter > 0).squeeze(1)
        return feat_bank.cpu().numpy(), point_ids.cpu().numpy()
