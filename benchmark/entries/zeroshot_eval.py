"""Entry driver: the zero-shot evaluator (``ZeroShotEvaluator.run()``) back
to back, one ``run()`` a unit: every val scene under ``test_repeats``
voxelizations, the loader ``test_workers`` threads ahead, geometry on the
card, the model, the ensemble and the text product per scene, the mIoU
per repeat.

Set-up writes the val rooms with their fused features and the text file,
builds the model with the benchmark's weights and the evaluator, and runs
one ``run()`` (every shape of the window; the caps are final).  The
timed path's per-point logits reach the host in the evaluator's
``_host_rows``; a sample of the window's scene passes, drawn from the seed
by reservoir, is kept and compared with the reference after the window.
The check prints how the reference's ensemble chose on the compared
passes: the share of voxels that took the fused feature, beside the share
that has one.
"""

from __future__ import annotations

from typing import List

import sys

import numpy as np
import torch

from .. import data
from ..reference import ensemble, minkunet
from ..reference.voxelize import repeat_seeds
from .seg_step import Clock

# ``logits``: every kept pass's logits shifted where they reach the host;
# ``choice``: the ensemble takes the fused feature wherever a voxel has one
# and the 3D output elsewhere, without comparing the two.
FAULTS = ("logits", "choice")


class ZeroShotEval:
    def __init__(self, ctx, fault: str = ""):
        from openscene_tpu_torch.config import Config
        from openscene_tpu_torch.models.sparse_unet import MinkUNet
        from openscene_tpu_torch.runtime.evaluate import ZeroShotEvaluator
        cfg, wl = ctx.config, ctx.workload
        self.ctx, self.fault, dev = ctx, fault, ctx.device
        clock = Clock()
        self.ds = data.write(ctx.data_dir, wl, ctx.seed, dev,
                             dim=cfg["feature_dim"],
                             num_classes=cfg["classes"],
                             fused_dir="scannet_multiview_openseg")
        clock("rooms and features written")
        if len(self.ds.val_files) != cfg["val_scenes"]:
            raise ValueError(f"{len(self.ds.val_files)} val rooms, the "
                             f"config states {cfg['val_scenes']}")
        self.run_cfg = Config(
            data_root=self.ds.data_root,
            data_root_2d_fused_feature=self.ds.fused_root,
            feature_2d_extractor=cfg["feature_2d_extractor"],
            classes=cfg["classes"], arch_3d=cfg["arch_3d"],
            voxel_size=cfg["voxel_size"], input_color=cfg["input_color"],
            use_shm=cfg["use_shm"], split="val",
            feature_type=cfg["feature_type"],
            prompt_eng=cfg["prompt_eng"],
            mark_no_feature_to_unknown=cfg["mark_no_feature_to_unknown"],
            test_workers=cfg["test_workers"],
            test_repeats=cfg["test_repeats"],
            compute_dtype=cfg["compute_dtype"],
            manual_seed=ctx.seed % (1 << 31), embedding_file=self.ds.text_file,
            text_embedding_cache="",
            device_geometry=wl.get("device_geometry", "auto"))
        model = MinkUNet(cfg["in_channels"], cfg["feature_dim"],
                         cfg["arch_3d"])
        w = minkunet.make_weights(cfg["arch_3d"], cfg["in_channels"],
                                  cfg["feature_dim"], ctx.seed, dev)
        model.load_state_dict({k: w[k] for k in model.state_dict()})
        del w
        self.ev = ZeroShotEvaluator(self.run_cfg, model.to(dev), device=dev)
        self.rng = np.random.default_rng((ctx.seed, 1))
        self.k = wl["check_passes"]
        self.kept: List[tuple] = []     # (rep, scene, point logits)
        self.seen = 0
        self.pass_voxels: List[int] = []
        self._hook()
        clock("model and evaluator built")
        self.ev.run()                   # warm-up: every shape of a run()
        clock("warm-up run")
        self.setup_phases = clock.phases
        self.kept, self.seen = [], 0

    def _hook(self) -> None:
        """Count each scene pass's voxels (``step``) and keep the sampled
        passes' host logits (``_host_rows``), on the evaluator object."""
        ev = self.ev
        step, host_rows = ev.step, ev._host_rows
        if self.fault == "choice":
            step = _fused_where_present()

        def counted_step(model, text, batch, geo=None):
            n = batch.num if hasattr(batch, "num") else batch.num_voxels
            self.pass_voxels.append(int(n))
            return step(model, text, batch, geo)

        def kept_rows(*args, **kwargs):
            self.rep += 1
            for row in host_rows(*args, **kwargs):
                i, logits = row[0], row[1]
                if self.fault == "logits":
                    logits = logits.copy()
                    logits[:, 0] += 1.0
                    row = (i, logits) + tuple(row[2:])
                self._keep(self.rep, i, logits)
                yield row

        ev.step, ev._host_rows = counted_step, kept_rows
        self.rep = -1

    def _keep(self, rep: int, scene: int, logits: np.ndarray) -> None:
        """Reservoir sample of ``k`` passes (Algorithm R, seeded)."""
        if len(self.kept) < self.k:
            self.kept.append((rep, scene, logits))
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.k:
                self.kept[j] = (rep, scene, logits)
        self.seen += 1

    def notes(self) -> List[str]:
        g = self.ev.geometry
        return [f"zeroshot_eval: scene passes {len(self.pass_voxels)}, "
                f"voxels a pass {min(self.pass_voxels)}-"
                f"{max(self.pass_voxels)}, caps {g.caps and g.caps.fixed}, "
                f"host fallbacks (overflows) {g.overflows}",
                f"set-up phases (s): {self.setup_phases}"]

    def install_spans(self, spans) -> None:
        from openscene_tpu_torch.data.loaders import FusedFeatureLoader
        spans.patch(FusedFeatureLoader, "get", "loader")
        spans.patch(self.ev, "scene", "scene",
                    sync=self.ctx.device.type == "cuda")

    def unit(self) -> dict:
        start = len(self.pass_voxels)
        self.rep = -1
        with self.ctx.spans.span("run"):
            self.ev.run()
        n = self.pass_voxels[start:]
        return {"items": len(n), "voxels": sum(n)}

    def free(self) -> None:
        del self.ev
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self) -> dict:
        return self.compare(minkunet.identity)

    def control(self, faults: bool = True) -> dict:
        """Readings of the program and of the fp8 control against the
        reference on the same passes (``control.py``)."""
        out = {"program": self.compare(minkunet.identity)}
        if faults:
            out["fp8"] = self.compare(minkunet.fp8, quiet=True)
        return out

    def compare(self, quant, quiet: bool = False) -> dict:
        """The kept passes' logits (the program's, or with ``quant`` other
        than the identity the reference's at that precision) against the
        float32 reference: the worst pass's 99th percentile and maximum
        over points of ``max_c |logit - reference|`` over the reference
        logits' RMS.  Unless ``quiet``, prints the reference ensemble's
        choice over those passes."""
        cfg, dev = self.ctx.config, self.ctx.device
        p = minkunet.make_weights(cfg["arch_3d"], cfg["in_channels"],
                                  cfg["feature_dim"], self.ctx.seed, dev)
        seeds = repeat_seeds(self.run_cfg.manual_seed, cfg["test_repeats"])
        text = torch.from_numpy(np.load(self.ds.text_file)).to(dev)
        p99, worst = 0.0, 0.0
        choice = {"voxels": 0, "present": 0, "fused": 0}
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for rep, scene, logits in self.kept:
                pts, feat, mask = data.load_val(self.ds.val_files[scene],
                                                self.ds.fused_root)
                args = (p, pts, feat, mask, text, cfg["voxel_size"],
                        seeds[rep], scene, cfg["arch_3d"])
                ref = ensemble.scene_logits(*args, choice=choice
                                            ).cpu().numpy()
                if quant is not minkunet.identity:
                    logits = ensemble.scene_logits(
                        *args, quant=quant).cpu().numpy()
                scale = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
                err = np.abs(logits - ref).max(1) / scale
                p99 = max(p99, float(np.quantile(err, 0.99)))
                worst = max(worst, float(err.max()))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        if not quiet and choice["voxels"]:
            n = choice["voxels"]
            print(f"ensemble choice over {len(self.kept)} passes, {n} "
                  f"voxels: fused feature taken at "
                  f"{100 * choice['fused'] / n:.3f}%, present at "
                  f"{100 * choice['present'] / n:.3f}%", file=sys.stderr)
        return {"logit_p99": p99, "logit_max": worst}


def _fused_where_present():
    """The ``choice`` fault's eval step: the fused feature's logits where
    the voxel has one, the 3D output's elsewhere."""
    from openscene_tpu_torch.runtime.evaluate import make_eval_step
    fusion, distill = make_eval_step("fusion"), make_eval_step("distill")

    def step(model, text, batch, geo=None):
        lf, mask = fusion(model, text, batch, geo)
        ld, _ = distill(model, text, batch, geo)
        return torch.where(mask.bool()[:, None], lf, ld), mask
    return step


def setup(ctx, fault: str = "") -> ZeroShotEval:
    if fault and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return ZeroShotEval(ctx, fault)
