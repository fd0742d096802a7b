"""Entry driver: the supervised seg train step (``SegTrainer.train_step``
on raw batches: geometry built on the card, forward, cross-entropy,
backward, SGD) back to back on ``batches`` pre-assembled batches, cycled.

Set-up writes the traffic's train rooms, builds one ``SegTrainer`` with the
benchmark's weights, assembles its batches through the trainer's own
``_epoch_batches`` (its loader, augmentation, workers and caps), and runs
each batch once through the window's own call: those are the first
``check_steps`` steps, which the reference follows, and they leave the
caps final.  A unit is one step with the trainer's per-step work (the
IoU histograms added up, one ``float(loss)`` wait).
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .. import counts, data
from ..reference import geometry as ref_geometry
from ..reference import minkunet, train

FAULTS = ("unchanged", "half_batch", "labels")


def batch_counts(coords: np.ndarray, device) -> counts.LevelCounts:
    geo = ref_geometry.build(torch.from_numpy(coords).to(device))
    return counts.LevelCounts(geo.num, [p.count() for p in geo.self3],
                              geo.stem.count())


def gaps(prog: Dict[str, float], ref: Dict[str, float],
         grad: Dict[str, float], floor_share=1e-3):
    """(worst, median) over the leaves of ``|norm_prog - norm_ref| /
    max(norm_ref, median leaf's norm)``, leaving out the leaves whose
    first reference gradient is under ``floor_share`` of the median
    leaf's (they move by rounding alone)."""
    med = statistics.median(ref.values())
    gmed = statistics.median(grad.values())
    g = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref
         if grad[k] >= floor_share * gmed]
    return max(g), statistics.median(g)


class Clock:
    """Seconds of each set-up phase, for the notes."""

    def __init__(self):
        self.t, self.phases = time.perf_counter(), {}

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        self.phases[what] = round(now - self.t, 2)
        self.t = now


class SegStep:
    out_key = "classes"      # the config key of the head's width
    head_is_forward = True   # the model's forward returns the head output

    def __init__(self, ctx, fault: str = ""):
        cfg, wl = ctx.config, ctx.workload
        self.ctx, self.fault = ctx, fault
        dev = ctx.device
        clock = Clock()
        self.trainer = self._trainer(cfg, wl, ctx)
        clock("rooms written, trainer built")
        sd = self.trainer.model.state_dict()
        w = minkunet.make_weights(cfg["arch_3d"], cfg["in_channels"],
                                  cfg[self.out_key], ctx.seed, dev)
        self.trainer.model.load_state_dict({k: w[k] for k in sd})
        del w
        clock("weights")
        self.batches = list(self.trainer._epoch_batches())
        clock("batches assembled")
        if len(self.batches) != wl["batches"]:
            raise ValueError(f"{len(self.batches)} batches, the traffic "
                             f"asks for {wl['batches']}")
        arch = minkunet.ARCHS[cfg["arch_3d"]]
        self.facts = []
        for raw, _ in self.batches:
            n = int(raw.num)
            c = batch_counts(np.asarray(raw.coords[:n]), dev)
            b = counts.launch_bounds_ms(arch, c, train=True)
            self.facts.append({
                "voxels": n,
                "flops": counts.model_flops(arch, c, cfg["in_channels"],
                                            cfg[self.out_key], train=True),
                "conv_bound_ms": b["fwd"] + b["bwd"]})
        clock("pairs counted")
        self.hist = torch.zeros((3, cfg["classes"]), dtype=torch.int64,
                                device=dev)
        self.prog = self._first_steps(wl["check_steps"])
        clock("first steps")
        self.setup_phases = clock.phases
        self.i = 0

    def _trainer(self, cfg: dict, wl: dict, ctx):
        from openscene_tpu_torch.config import Config
        from openscene_tpu_torch.runtime.train_seg import SegTrainer
        ds = data.write(ctx.data_dir, wl, ctx.seed, ctx.device)
        self.run_cfg = Config(
            data_root=ds.data_root, classes=cfg["classes"],
            arch_3d=cfg["arch_3d"], voxel_size=cfg["voxel_size"],
            aug=cfg["aug"], input_color=cfg["input_color"],
            use_shm=cfg["use_shm"], workers=cfg["workers"],
            batch_size=cfg["batch_size"], base_lr=cfg["base_lr"],
            loop=cfg["loop"], epochs=cfg["epochs"], power=cfg["power"],
            momentum=cfg["momentum"], weight_decay=cfg["weight_decay"],
            ignore_label=cfg["ignore_label"], evaluate=cfg["evaluate"],
            compute_dtype=cfg["compute_dtype"],
            manual_seed=ctx.seed % (1 << 31), save_path="",
            device_geometry=wl.get("device_geometry", "auto"))
        return SegTrainer(self.run_cfg, device=ctx.device)

    @staticmethod
    def _ref_parts(raw) -> tuple:
        """The level-0 arrays of a batch that the reference reads."""
        m = int(raw.num)
        return (np.asarray(raw.coords[:m]),
                np.asarray(raw.labels[:m]).astype(np.int64))

    def _step(self, batch):
        loss, *h = self.trainer.train_step(batch)
        self.hist += torch.stack(h)
        return float(loss)

    def _first_steps(self, n: int) -> dict:
        """The first ``n`` steps through the window's call; what the
        reference is compared on: each loss, the first step's head output
        at the batch's voxels and each leaf's norm of the change after
        ``n`` steps."""
        model = self.trainer.model
        p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
        losses, kept = [], []
        rows = int(self.batches[0][0].num)
        hook = model.register_forward_hook(
            lambda m, args, out: kept.append(out[:rows].detach().float().cpu())
            if self.head_is_forward else None)
        for s in range(n):
            batch = self.batches[s % len(self.batches)]
            if self.fault == "unchanged":
                with torch.no_grad():
                    saved = {k: p.clone()
                             for k, p in model.named_parameters()}
            losses.append(self._step(self._faulty(batch)))
            hook.remove()
            if self.fault == "unchanged":
                with torch.no_grad():
                    for k, p in model.named_parameters():
                        p.copy_(saved[k])
        change = {k: float((p.detach() - p0[k]).norm())
                  for k, p in model.named_parameters()}
        del p0
        return {"losses": losses, "out1": kept[0] if kept else None,
                "change": change}

    def _faulty(self, batch):
        """The batch as a planted fault hands it to the step."""
        raw, caps = batch
        if self.fault == "half_batch":
            labels = np.array(raw.labels)
            labels[int(raw.num) // 2:] = 255
            return raw._replace(labels=labels), caps
        if self.fault == "labels":
            labels = np.array(raw.labels)
            n = int(raw.num)
            labels[:n] = np.where(labels[:n] == 255, 255,
                                  (labels[:n] + 1) % self.run_cfg.classes)
            return raw._replace(labels=labels), caps
        return batch

    def notes(self) -> List[str]:
        return [f"seg_step: {len(self.batches)} batches of "
                f"{[f['voxels'] for f in self.facts]} voxels, caps "
                f"{sorted({tuple(c) for _, c in self.batches})}, host "
                f"fallbacks (overflows) {self.trainer.overflows}",
                f"set-up phases (s): {self.setup_phases}"]

    def install_spans(self, spans) -> None:
        from openscene_tpu_torch.runtime.distill import RawTrainStep
        from openscene_tpu_torch.sparse import edge_conv, stencil_conv
        spans.patch(RawTrainStep, "geometry", "geometry")
        for mod, names in ((stencil_conv, ("stencil_conv_fwd",
                                           "stencil_conv_bwd")),
                           (edge_conv, ("down_conv_fwd", "down_conv_bwd",
                                        "up_conv_fwd", "up_conv_bwd"))):
            for name in names:
                spans.patch(mod, name, "conv")

    def unit(self) -> dict:
        k = self.i % len(self.batches)
        self.i += 1
        with self.ctx.spans.span("step"):
            self._step(self.batches[k])
        f = self.facts[k]
        return {"items": 1, "voxels": f["voxels"], "flops": f["flops"],
                "conv_bound_ms": f["conv_bound_ms"]}

    def free(self) -> None:
        cfg = self.ctx.config
        n = len(self.trainer.train_data) // cfg["batch_size"]
        self.max_iter = cfg["epochs"] * max(n, 1)
        self.ref_batches = [self._ref_parts(raw) for raw, _ in
                            self.batches[:len(self.prog["losses"])]]
        del self.trainer, self.batches, self.hist
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    def reference(self, **kw) -> dict:
        """The reference's readings of the first steps (``kw``: its
        precision ``quant`` or a planted ``drop_half``)."""
        cfg, dev = self.ctx.config, self.ctx.device
        with _no_tf32():
            p0 = minkunet.make_weights(cfg["arch_3d"], cfg["in_channels"],
                                       cfg[self.out_key], self.ctx.seed, dev)
            batches = [tuple(torch.from_numpy(a).to(dev) for a in parts)
                       for parts in self.ref_batches]
            return train.train_steps(p0, batches, cfg, self.max_iter, **kw)

    def check(self) -> dict:
        ref = self.reference()
        gmed = statistics.median(ref["grad1"].values())
        out = [k for k, g in ref["grad1"].items() if g < 1e-3 * gmed]
        print(f"leaves left out of the change gaps: {out}", file=sys.stderr)
        return compare(self.prog, ref)

    def control(self, faults: bool = True) -> dict:
        """Readings of the program, the fp8 control and (``faults``) the
        reference with half of each batch left out, each against the
        reference (``control.py``)."""
        ref = self.reference()
        out = {"program": compare(self.prog, ref)}
        if faults:
            out["fp8"] = compare(self.reference(quant=minkunet.fp8), ref)
            out["half_batch"] = compare(self.reference(drop_half=True), ref)
        return out


class _no_tf32:
    """float32 products in float32 for the reference."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def logit_p99(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """99th percentile over rows of ``max_c |prog - ref|`` over the
    reference's RMS (over the rows both have)."""
    n = min(len(prog), len(ref))
    ref = ref[:n].double()
    err = (prog[:n].double() - ref).abs().amax(1) / ref.pow(2).mean().sqrt()
    return float(np.quantile(err.numpy(), 0.99))


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers of a train cell: the first step's head output
    (``logit_p99``), the worst step's relative loss gap, and the worst and
    the median leaf's gap of the change after the checked steps.  The
    first step's gradient norms are not compared: neither the control nor
    a fault reads three times the program's (PERF.md, section 2)."""
    c_worst, c_med = gaps(prog["change"], ref["change"], ref["grad1"])
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    vals = {"loss_gap": max(steps), "change_gap": c_worst,
            "change_gap_median": c_med}
    if prog["out1"] is not None:
        vals["logit_p99"] = logit_p99(prog["out1"], ref["out1"])
    return vals


def setup(ctx, fault: str = "") -> SegStep:
    if fault and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return SegStep(ctx, fault)
