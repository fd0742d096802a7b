"""Entry: the distillation train step of a bottleneck MinkUNet
(MinkUNet50/101): ``distill_step.py``'s entry with the bottleneck
reference (``reference/bottleneck.py``) and counts
(``counts_bottleneck.py``), and one more compared number, ``feat_p99``:
the first step's head output as the loss sees it (the prehead that the
forward returns, through ``model.head`` with the weights before the step)
against the reference's, as ``seg_step.logit_p99`` compares logits.

The set-up (``BottleneckDistillStep.__init__``) is ``SegStep.__init__``
with the bottleneck reference's weights and counts in place of
``minkunet``'s and ``counts``'; a units' four counts in place of two.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from .. import counts_bottleneck
from ..reference import bottleneck, minkunet
from .distill_step import DistillStep
from .seg_step import Clock, _no_tf32, batch_counts, compare

FAULTS = ("unchanged", "half_batch")
CHUNK = 1 << 16   # rows of the head output made at once


def feat_p99(prog: torch.Tensor, ref: torch.Tensor, device) -> float:
    """``seg_step.logit_p99`` in row chunks on ``device``: the 99th
    percentile over rows of ``max_c |prog - ref|`` over the reference's
    RMS (over the rows both have), in float64."""
    n = min(len(prog), len(ref))
    worst, sq = [], 0.0
    for i in range(0, n, CHUNK):
        r = ref[i:min(i + CHUNK, n)].to(device, torch.float64)
        p = prog[i:i + len(r)].to(device, torch.float64)
        worst.append((p - r).abs().amax(1).cpu())
        sq += float(r.pow(2).sum())
    rms = (sq / (n * ref.shape[1])) ** 0.5
    return float(np.quantile(torch.cat(worst).numpy(), 0.99)) / rms


class BottleneckDistillStep(DistillStep):
    def __init__(self, ctx, fault: str = ""):
        cfg, wl = ctx.config, ctx.workload
        self.ctx, self.fault = ctx, fault
        dev = ctx.device
        clock = Clock()
        self.trainer = self._trainer(cfg, wl, ctx)
        clock("rooms written, trainer built")
        sd = self.trainer.model.state_dict()
        w = bottleneck.make_weights(cfg["arch_3d"], cfg["in_channels"],
                                    cfg[self.out_key], ctx.seed, dev)
        self.trainer.model.load_state_dict({k: w[k] for k in sd})
        del w
        clock("weights")
        self.batches = list(self.trainer._epoch_batches())
        clock("batches assembled")
        if len(self.batches) != wl["batches"]:
            raise ValueError(f"{len(self.batches)} batches, the traffic "
                             f"asks for {wl['batches']}")
        arch = bottleneck.ARCHS[cfg["arch_3d"]]
        self.facts = []
        for raw, _ in self.batches:
            n = int(raw.num)
            c = batch_counts(np.asarray(raw.coords[:n]), dev)
            self.facts.append({"voxels": n, **counts_bottleneck.step_facts(
                arch, c, cfg["in_channels"], cfg[self.out_key])})
        clock("pairs counted")
        self.hist = None
        self.prog = self._first_steps(wl["check_steps"])
        clock("first steps")
        self.setup_phases = clock.phases
        self.i = 0

    def _first_steps(self, n: int) -> dict:
        """``SegStep._first_steps``, and the first step's head output
        (``feat1``, fp32 on the host) made from the prehead the forward
        returns, before the step changes the head."""
        model = self.trainer.model
        rows = int(self.batches[0][0].num)
        chunks = []

        def keep(m, args, out):
            if chunks:
                return
            with torch.no_grad():
                for i in range(0, rows, CHUNK):
                    chunks.append(model.head(
                        out[i:min(i + CHUNK, rows)]).cpu())

        hook = model.register_forward_hook(keep)
        try:
            prog = super()._first_steps(n)
        finally:
            hook.remove()
        prog["feat1"] = torch.cat(chunks)
        return prog

    def unit(self) -> dict:
        u = super().unit()
        f = self.facts[(self.i - 1) % len(self.batches)]
        u["conv1x1_bound_ms"] = f["conv1x1_bound_ms"]
        u["bn_bound_ms"] = f["bn_bound_ms"]
        return u

    def reference(self, **kw) -> dict:
        cfg, dev = self.ctx.config, self.ctx.device
        with _no_tf32():
            p0 = bottleneck.make_weights(cfg["arch_3d"], cfg["in_channels"],
                                         cfg[self.out_key], self.ctx.seed,
                                         dev)
            batches = [tuple(torch.from_numpy(a).to(dev) for a in parts)
                       for parts in self.ref_batches]
            return bottleneck.train_steps(p0, batches, cfg, self.max_iter,
                                          **kw)

    def _compare(self, ref: dict) -> dict:
        vals = compare(self.prog, ref)
        vals["feat_p99"] = feat_p99(self.prog["feat1"], ref["out1"],
                                    self.ctx.device)
        return vals

    def check(self) -> dict:
        ref = self.reference()
        gmed = statistics.median(ref["grad1"].values())
        out = [k for k, g in ref["grad1"].items() if g < 1e-3 * gmed]
        print(f"leaves left out of the change gaps: {out}", file=sys.stderr)
        return self._compare(ref)

    def control(self, faults: bool = True) -> dict:
        """``SegStep.control`` with ``feat_p99``: the program, the fp8
        control and the half-batch fault, each against the reference."""
        ref = self.reference()
        out = {"program": self._compare(ref)}
        if faults:
            for name, kw in (("fp8", {"quant": minkunet.fp8}),
                             ("half_batch", {"drop_half": True})):
                other = self.reference(**kw)
                vals = compare({**other, "out1": None}, ref)
                vals["feat_p99"] = feat_p99(other["out1"], ref["out1"],
                                            self.ctx.device)
                out[name] = vals
        return out


def setup(ctx, fault: str = "") -> BottleneckDistillStep:
    if fault and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return BottleneckDistillStep(ctx, fault)
