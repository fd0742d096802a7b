"""Entry: the distillation train step of Point Transformer V3 (PT-v3m1):
``distill_step_bottleneck.py``'s entry (``DistillTrainer.train_step`` on
raw batches, the first step's head output compared as ``feat_p99``) with
the PTv3 reference (``reference/ptv3.py``) and counts
(``counts_ptv3.py``).

The set-up is ``BottleneckDistillStep``'s with the PTv3 reference's
weights and counts, after a check that the configuration's published
keys are the architecture both the program and the reference run.  The
first ``check_steps`` steps record the orders each drew
(``PTv3.last_orders``), which the reference replays; DropPath needs only
the seed and the step (``models/ptv3.py``).  A unit also carries the
attention's least time, ``attn_bound_ms``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import counts_ptv3
from ..reference import geometry as ref_geometry
from ..reference import ptv3
from .distill_step_bottleneck import FAULTS, BottleneckDistillStep
from .seg_step import Clock, _no_tf32, batch_counts

KEYS = ("enc_depths", "enc_channels", "enc_num_head", "dec_depths",
        "dec_channels", "dec_num_head", "mlp_ratio", "drop_path")


def scene_counts(coords: np.ndarray, device) -> list:
    """Each level's voxels a scene, by the reference's own pyramid."""
    levels, _ = ref_geometry.pyramid(torch.from_numpy(coords).to(device))
    return [torch.bincount(lv.coords[:, 0]).tolist() for lv in levels]


def check_arch(cfg: dict) -> dict:
    """The reference's architecture of ``cfg``, after checking that the
    configuration's published keys are what the program and the reference
    run."""
    from openscene_tpu_torch.models import ptv3 as port
    from openscene_tpu_torch.sparse.serialize import ORDERS
    a = ptv3.ARCHS[cfg["arch_3d"]]
    mine = port.ARCHS[cfg["arch_3d"]]
    said = {k: cfg[k] for k in KEYS}
    said.update(patch_size=set(cfg["enc_patch_size"] + cfg["dec_patch_size"]),
                order=cfg["order"], stride=set(cfg["stride"]),
                bn=(cfg["bn_eps"], cfg["bn_momentum"], cfg["ln_eps"]),
                out=cfg["backbone_out_channels"])
    ref = {**{k: a[k] for k in KEYS}, "patch_size": {a["patch_size"]},
           "order": list(ORDERS), "stride": {2},
           "bn": (ptv3.BN_EPS, mine.bn_momentum, ptv3.LN_EPS),
           "out": a["dec_channels"][0]}
    prog = {**{k: (list(getattr(mine, k))
                   if isinstance(getattr(mine, k), tuple)
                   else getattr(mine, k)) for k in KEYS},
            "patch_size": {mine.patch_size}, "order": list(ORDERS),
            "stride": {2}, "bn": (mine.bn_eps, mine.bn_momentum,
                                  mine.ln_eps),
            "out": mine.dec_channels[0]}
    for k, v in said.items():
        if v != ref[k] or v != prog[k]:
            raise ValueError(f"{k}: the configuration says {v}, the "
                             f"reference runs {ref[k]}, the program "
                             f"{prog[k]}")
    if not (cfg["shuffle_orders"] and cfg["pre_norm"] and cfg["qkv_bias"]
            and cfg["qk_scale"] is None and not cfg["enable_rpe"]):
        raise ValueError("the program runs shuffled orders, pre-norm "
                         "blocks, a qkv bias, the scale 16^-0.5 and no "
                         "relative position encoding")
    return a


class PTv3DistillStep(BottleneckDistillStep):
    def __init__(self, ctx, fault: str = ""):
        cfg, wl = ctx.config, ctx.workload
        self.ctx, self.fault = ctx, fault
        dev = ctx.device
        self.arch = check_arch(cfg)
        clock = Clock()
        self.trainer = self._trainer(cfg, wl, ctx)
        clock("rooms written, trainer built")
        sd = self.trainer.model.state_dict()
        w = ptv3.make_weights(self.arch, cfg["in_channels"],
                              cfg[self.out_key], ctx.seed, dev)
        self.trainer.model.load_state_dict({k: w[k] for k in sd})
        del w
        clock("weights")
        self.batches = list(self.trainer._epoch_batches())
        clock("batches assembled")
        if len(self.batches) != wl["batches"]:
            raise ValueError(f"{len(self.batches)} batches, the traffic "
                             f"asks for {wl['batches']}")
        self.facts, self.scenes = [], []
        for raw, _ in self.batches:
            n = int(raw.num)
            coords = np.asarray(raw.coords[:n])
            self.scenes.append(scene_counts(coords, dev))
            self.facts.append({"voxels": n, **counts_ptv3.step_facts(
                self.arch, batch_counts(coords, dev), self.scenes[-1],
                cfg["in_channels"], cfg[self.out_key])})
        clock("pairs counted")
        self.hist = None
        self.orders, self._record = [], True
        self.prog = self._first_steps(wl["check_steps"])
        self._record = False
        clock("first steps")
        self.setup_phases = clock.phases
        self.i = 0

    def notes(self) -> list:
        return super().notes() + [
            f"voxels a scene by level, first batch: {self.scenes[0]}"]

    def _step(self, batch):
        loss = super()._step(batch)
        if self._record:
            self.orders.append(self.trainer.model.last_orders)
        return loss

    def unit(self) -> dict:
        u = super().unit()
        u["attn_bound_ms"] = self.facts[(self.i - 1)
                                        % len(self.batches)]["attn_bound_ms"]
        return u

    def reference(self, **kw) -> dict:
        cfg, dev = self.ctx.config, self.ctx.device
        with _no_tf32():
            p0 = ptv3.make_weights(self.arch, cfg["in_channels"],
                                   cfg[self.out_key], self.ctx.seed, dev)
            batches = [tuple(torch.from_numpy(a).to(dev) for a in parts)
                       for parts in self.ref_batches]
            return ptv3.train_steps(p0, batches, cfg, self.max_iter,
                                    self.orders, self.run_cfg.manual_seed,
                                    **kw)


def setup(ctx, fault: str = "") -> PTv3DistillStep:
    if fault and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return PTv3DistillStep(ctx, fault)
