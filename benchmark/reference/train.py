"""Plain train steps of MinkUNet18A: supervised segmentation (the reference
repository's ``run/train_mink.py``) and 3D distillation
(``run/distill.py``).

* seg: mean cross-entropy over the voxels whose label is not 255; SGD with
  momentum and coupled weight decay (the gradient plus ``weight_decay *
  w`` enters the momentum buffer, as ``torch.optim.SGD`` does) at the poly
  rate ``base_lr * (1 - it / max_iter) ** power``.
* distill: mean of ``1 - cos(out, target)`` over the voxels that have a
  fused target (``torch.nn.CosineSimilarity``, eps 1e-8); Adam (0.9, 0.999,
  eps 1e-8, no decay) at ``10 * base_lr`` times the same poly factor (the
  reference's ``index_split=0`` puts every group on its 10x branch).

Input features are the constant (1, 1, 1) (``input_color: false``).
``drop_half`` plants a fault in the reference put in the program's place:
the second half of the batch's voxels is left out and the mean taken over
the rest (``control.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import geometry, minkunet


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = 255) -> torch.Tensor:
    valid = labels != ignore
    logp = torch.log_softmax(logits[valid], dim=-1)
    return -logp.gather(1, labels[valid].long()[:, None]).mean()


def cosine_loss(out: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    cos = (out * target).sum(-1) / (out.norm(dim=-1) * target.norm(dim=-1)
                                    ).clamp_min(eps)
    m = mask > 0
    return (1.0 - cos[m]).mean()


def train_steps(p0: Dict[str, torch.Tensor], batches: Sequence, cfg: dict,
                max_iter: int, quant=minkunet.identity,
                drop_half: bool = False) -> dict:
    """Train ``len(batches)`` steps from ``p0``.  A seg batch is ``(coords
    (N, 4), labels (N,))``, a distill batch ``(coords, target (N, D),
    mask (N,))``.  Returns the losses, the first step's head output (on
    the host), each leaf's norm of the first step's gradient and of the
    change after the last step."""
    distill = cfg.get("loss_type") == "cosine"
    names = [k for k in p0 if minkunet.trainable(k)]
    p = {k: v.clone() for k, v in p0.items()}
    state: Dict[str, list] = {}
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for it, batch in enumerate(batches):
        coords, rest = batch[0], batch[1:]
        if drop_half:
            keep = coords.shape[0] // 2
            coords, rest = coords[:keep], [t[:keep] for t in rest]
        geo = geometry.build(coords)
        leaves = [p[k].requires_grad_(True) for k in names]
        x = torch.ones((coords.shape[0], 3), device=coords.device)
        out = minkunet.forward(p, geo, x, cfg["arch_3d"], train=True,
                               quant=quant)
        loss = (cosine_loss(out, rest[0].float(), rest[1]) if distill
                else cross_entropy(out, rest[0], cfg["ignore_label"]))
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if it == 0:
            out1 = out.detach().cpu()
        del geo, out, loss
        poly = max(1.0 - it / max_iter, 0.0) ** cfg["power"]
        with torch.no_grad():
            for k, g in zip(names, grads):
                w = p[k].detach()
                if it == 0:
                    grad1[k] = float(g.norm())
                if distill:
                    lr = cfg["base_lr"] * 10.0 * poly
                    m, v = state.get(k, (torch.zeros_like(w),
                                         torch.zeros_like(w)))
                    m = 0.9 * m + 0.1 * g
                    v = 0.999 * v + 0.001 * g * g
                    state[k] = (m, v)
                    t = it + 1
                    step = (m / (1 - 0.9 ** t)) / (
                        (v / (1 - 0.999 ** t)).sqrt() + 1e-8)
                else:
                    lr = cfg["base_lr"] * poly
                    d = g + cfg["weight_decay"] * w
                    buf = state.get(k)
                    step = d if buf is None else cfg["momentum"] * buf + d
                    state[k] = step
                p[k] = w - lr * step
    change = {k: float((p[k] - p0[k]).norm()) for k in names}
    return {"losses": losses, "out1": out1, "grad1": grad1,
            "change": change}
