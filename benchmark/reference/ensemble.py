"""Plain zero-shot ensemble evaluation of one scene pass.

The reference repository's ``run/evaluate.py`` (``feature_type:
ensemble``): the 3D model's per-voxel output and the fused 2D feature are
each L2-normalised (``f / (|f| + 1e-5)``) and matched to the text
embeddings; per voxel the feature whose best normalised logit is higher is
kept, unnormalised, and matched to the text again; points take their
voxel's logits.  The val loader's part (``dataset/feature_loader.py``, val
split): the fused features are scattered to the full cloud
(``mask_full``) and each voxel takes its representative point's feature
(zero where it has none).  The model runs in eval mode (BatchNorm on its
running statistics) on the constant input.

Departure: everything is float32 (the stored fp16 features upcast), where
the program normalises the fp16 features in fp16.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry, minkunet
from .voxelize import voxelize

EPS = 1e-5


def _normalize(f: torch.Tensor) -> torch.Tensor:
    return f / (f.norm(dim=-1, keepdim=True) + EPS)


@torch.no_grad()
def scene_logits(p, points: np.ndarray, feat: np.ndarray,
                 mask_full: np.ndarray, text: torch.Tensor,
                 voxel_size: float, seed: int, index: int, arch: str,
                 quant=minkunet.identity, choice: dict = None
                 ) -> torch.Tensor:
    """(P, classes) float32 point logits of one scene pass; ``choice``, if
    given, adds up the pass's voxels, those with a fused feature and those
    whose ensemble took it."""
    dev = text.device
    vox = voxelize(points, voxel_size, seed, index)
    coords = torch.zeros((len(vox.coords), 4), dtype=torch.long)
    coords[:, 1:] = torch.from_numpy(vox.coords)
    coords = coords.to(dev)
    geo = geometry.build(coords)
    x = torch.ones((coords.shape[0], 3), device=dev)
    out = minkunet.forward(p, geo, x, arch, train=False, quant=quant)
    del geo
    rows = np.cumsum(mask_full) - 1            # compact row of each point
    has = mask_full[vox.rep]
    fused = torch.zeros((len(vox.rep), feat.shape[1]), device=dev)
    src = torch.from_numpy(rows[vox.rep[has]]).to(dev)
    fused[torch.from_numpy(np.flatnonzero(has)).to(dev)] = \
        torch.from_numpy(feat).to(dev).index_select(0, src).float()
    text_t = text.t().float()
    logit_d = _normalize(out) @ text_t
    logit_f = _normalize(fused) @ text_t
    use_fused = logit_d.amax(-1) < logit_f.amax(-1)
    if choice is not None:
        choice["voxels"] += len(vox.rep)
        choice["present"] += int(has.sum())
        choice["fused"] += int(use_fused.sum())
    chosen = torch.where(use_fused[:, None], fused, out)
    logits = chosen @ text_t
    return logits.index_select(0, torch.from_numpy(vox.inverse).to(dev))
