"""The PTv3 cell's pieces on the CPU: the reference's parameters are the
port model's (46.2M at the published widths); the configuration's keys
are what both run; ``counts_ptv3`` against a brute count over a tiny
layout and over the port model's modules; the readers of ``ptv3.attn``
and ``ptv3.attn_kernel`` on a hand-made trace, spans of any thread."""

import threading

import numpy as np
import pytest
import torch

from benchmark import counts_ptv3, run
from benchmark.entries import distill_step_ptv3
from benchmark.entries.seg_step import batch_counts
from benchmark.reference import geometry as ref_geometry
from benchmark.reference import ptv3
from benchmark.spans import Spans
from benchmark.tests.test_bench_bottleneck import (AUTOGRAD, D0, D1, H0, H1,
                                                   MAIN, host)
from benchmark.tests.test_bench_counts import tiny_coords

ARCH = "PTv3m1"
DIM = 768


def test_param_shapes_are_the_port_models():
    from openscene_tpu_torch.models.ptv3 import PTv3
    model = PTv3(3, DIM, ARCH)
    shapes = ptv3.param_shapes(ptv3.ARCHS[ARCH], 3, DIM)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == shapes
    n = sum(int(np.prod(s)) for k, s in shapes.items()
            if not k.endswith((".mean", ".var")))
    assert n == sum(p.numel() for p in model.parameters()) == 46_203_424


def test_configuration_is_what_runs():
    cfg = run.load_json(run.BENCH, "configs", "scannet_openseg_ptv3.json")
    assert distill_step_ptv3.check_arch(cfg) is ptv3.ARCHS[ARCH]
    with pytest.raises(ValueError, match="enc_depths"):
        distill_step_ptv3.check_arch({**cfg, "enc_depths": [2, 2, 2, 2, 2]})
    with pytest.raises(ValueError, match="patch_size"):
        distill_step_ptv3.check_arch({**cfg, "dec_patch_size": [512] * 4})


@pytest.mark.parametrize("counts", [[10, 40, 70], [16, 17, 32, 1],
                                    [1030, 2048, 5, 1024]])
def test_attention_pairs_match_a_brute_count(counts):
    """Each patch's real queries against all its keys, duplicates
    included, over Pointcept's layout."""
    patch = 16 if max(counts) < 100 else 1024
    offset = np.cumsum(counts).tolist()
    pad, unpad, cu = ptv3.padding_and_inverse(offset, patch, "cpu")
    real = torch.zeros(len(pad), dtype=torch.bool)
    real[unpad] = True
    brute = sum(int(real[s:e].sum()) * (e - s)
                for s, e in zip(cu[:-1].tolist(), cu[1:].tolist()))
    assert counts_ptv3.attn_pairs(counts, patch) == brute


@pytest.mark.parametrize("counts,c", [([10, 40, 70], 64),
                                      ([1030, 2048, 5, 1024], 256),
                                      ([120_000, 95_000], 64),
                                      ([3], 512)])
def test_dev_bench_bound_is_the_yardsticks(counts, c):
    """The attention bench's least time (``chip_smoke.py``'s kernel table)
    is ``attention_ms``, the yardstick of ``attn_roofline``; what it says
    bounds it is the larger term of each pass."""
    from openscene_tpu_torch.scripts import dev_attn_bench
    ms, by = dev_attn_bench.bound(counts, c)
    want = counts_ptv3.attention_ms(sum(counts),
                                    counts_ptv3.attn_pairs(counts, 1024), c)
    assert ms == pytest.approx(want, rel=1e-12)
    assert dev_attn_bench.PATCH == ptv3.ARCHS[ARCH]["patch_size"]
    assert (dev_attn_bench.PEAK_FLOPS, dev_attn_bench.HBM_BYTES_PER_S) == (
        counts_ptv3.PEAKS["bf16_flops"], counts_ptv3.PEAKS["hbm_bytes_per_s"])
    pairs = counts_ptv3.attn_pairs(counts, 1024)
    ops = [2 * 32.0 * pairs * (c // 16) * k / 989e12 for k in (2, 5)]
    nbytes = [sum(counts) * (k * c + 4 * (c // 16)) / 3.35e12
              for k in (8, 16)]
    assert by == "+".join(sorted({"bytes" if b > o else "ops"
                                  for b, o in zip(nbytes, ops)}))


def test_step_flops_match_a_brute_count_over_the_modules():
    from openscene_tpu_torch.models import ptv3 as port
    c = tiny_coords()
    levels, _ = ref_geometry.pyramid(torch.from_numpy(c))
    lc = batch_counts(c, "cpu")
    scenes = [torch.bincount(lv.coords[:, 0]).tolist() for lv in levels]
    a = ptv3.ARCHS[ARCH]
    model = port.PTv3(3, DIM, ARCH)
    n = lc.num
    stem = 2.0 * lc.pairs5 * 3 * a["enc_channels"][0]
    fwd = stem + 2.0 * n[0] * a["dec_channels"][0] * DIM
    for name, m in model.named_modules():
        top = name.split(".")[0]
        s = int(top[3:]) if top[:3] in ("enc", "dec") else None
        if isinstance(m, port.Linear):
            rows = n[s]
            if ".pool." in name:
                rows = n[s - 1]
            elif name.endswith("unpool.proj"):
                rows = n[s + 1]
            fwd += 2.0 * rows * m.weight.shape[0] * m.weight.shape[1]
        elif isinstance(m, port.Block):
            cch = m.cpe_conv.shape[1]
            fwd += 2.0 * lc.pairs3[s] * cch * cch
            fwd += 2 * 2.0 * 16 * counts_ptv3.attn_pairs(
                scenes[s], a["patch_size"]) * m.attn.heads
    facts = counts_ptv3.step_facts(a, lc, scenes, 3, DIM)
    assert facts["flops"] == pytest.approx(3.0 * fwd - stem, rel=1e-12)
    assert facts["attn_bound_ms"] > 0 and facts["conv_bound_ms"] > 0


def _trace():
    from benchmark.devtrace import DeviceTrace

    def launch(ts, corr, tid):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": D0 + ts, "dur": 2, "tid": tid,
                "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": D0 + ts,
                "dur": dur, "args": {"correlation": corr}}

    return DeviceTrace([
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": D0, "dur": D1 - D0, "tid": MAIN},
        launch(110, 1, MAIN), kernel(120, 30, 1),         # forward
        launch(610, 3, AUTOGRAD), kernel(620, 50, 3),     # backward
        launch(800, 5, MAIN), kernel(810, 100, 5)])       # in neither


@pytest.mark.parametrize("metric,value", [
    ("attn_ms.train_step", 0.080),
    ("attn_roofline.train_step", 100 * 0.004 / 0.080),
    ("attn_kernel_share.train_step", 1.0)])
def test_attention_readers_read_spans_of_any_thread(metric, value,
                                                    monkeypatch):
    """A value where the port's spans are in the window (the backward's
    on autograd's thread), None where the program has none."""
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    recs = [("ptv3.attn", main, host(100), host(200)),
            ("ptv3.attn_kernel", main, host(105), host(190)),
            ("ptv3.attn", 77, host(600), host(700)),
            ("ptv3.attn_kernel", 77, host(605), host(690))]
    spans = Spans()
    spans.record("window", H0, H1)
    units = [{"items": 1, "attn_bound_ms": 0.004}]
    readings = run.Readings(spans, units, (H0, H1), _trace(),
                            {"platform": "gpu"})
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert run.metric_reader(metric)(readings) == pytest.approx(value)
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert run.metric_reader(metric)(readings) is None
    monkeypatch.delattr(profiling, "records")
    assert run.metric_reader(metric)(readings) is None
