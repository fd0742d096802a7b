"""Entry driver: the distillation train step (``DistillTrainer.train_step``
on raw batches: geometry built on the card, the 768-d fp16 targets copied
up, forward, cosine loss, backward, Adam) back to back on ``batches``
pre-assembled batches, cycled; the seg step's driver with the distill
trainer, its targets and its loss (``seg_step.py``).
"""

from __future__ import annotations

import numpy as np

from .. import data
from .seg_step import SegStep

FAULTS = ("unchanged", "half_batch")


class DistillStep(SegStep):
    out_key = "feature_dim"
    head_is_forward = False  # the cosine loss applies the head itself

    def _trainer(self, cfg: dict, wl: dict, ctx):
        from openscene_tpu_torch.config import Config
        from openscene_tpu_torch.runtime.distill import DistillTrainer
        ds = data.write(ctx.data_dir, wl, ctx.seed, ctx.device,
                        dim=cfg["feature_dim"], num_classes=cfg["classes"],
                        fused_dir="scannet_multiview_openseg")
        self.run_cfg = Config(
            data_root=ds.data_root,
            data_root_2d_fused_feature=ds.fused_root,
            feature_2d_extractor=cfg["feature_2d_extractor"],
            classes=cfg["classes"], arch_3d=cfg["arch_3d"],
            voxel_size=cfg["voxel_size"], aug=cfg["aug"],
            input_color=cfg["input_color"], use_shm=cfg["use_shm"],
            workers=cfg["workers"], batch_size=cfg["batch_size"],
            base_lr=cfg["base_lr"], loss_type=cfg["loss_type"],
            loop=wl.get("loop", cfg["loop"]), epochs=cfg["epochs"],
            power=cfg["power"], compute_dtype=cfg["compute_dtype"],
            evaluate=False, manual_seed=ctx.seed % (1 << 31),
            save_path="", embedding_file=ds.text_file, text_embedding_cache="",
            device_geometry=wl.get("device_geometry", "auto"))
        return DistillTrainer(self.run_cfg, device=ctx.device)

    @staticmethod
    def _ref_parts(raw) -> tuple:
        m = int(raw.num)
        return (np.asarray(raw.coords[:m]), np.asarray(raw.feat_3d[:m]),
                np.asarray(raw.mask[:m]))

    def _step(self, batch):
        return float(self.trainer.train_step(batch))

    def _faulty(self, batch):
        raw, caps = batch
        if self.fault == "half_batch":
            mask = np.array(raw.mask)
            mask[int(raw.num) // 2:] = 0
            return raw._replace(mask=mask), caps
        return batch

    def free(self) -> None:
        super().free()
        cfg = self.ctx.config
        scenes = len(self.ctx.workload["train"]["rooms"])
        loop = self.ctx.workload.get("loop", cfg["loop"])
        self.max_iter = cfg["epochs"] * max(scenes * loop
                                            // cfg["batch_size"], 1)


def setup(ctx, fault: str = "") -> DistillStep:
    if fault and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return DistillStep(ctx, fault)
