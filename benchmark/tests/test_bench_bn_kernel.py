"""The reader of the program's ``unet.bn_kernel`` spans,
``bn_kernel_share.train_step``: kernel spans over BatchNorm spans on any
thread; 1.0 when they match, less when some BatchNorms ran without the
kernels, None without kernel spans or without the span API (a program
whose BatchNorm has no kernels)."""

import threading

import pytest

from benchmark import run
from benchmark.spans import Spans

H0, H1 = 5.0, 5.001                  # the window on the host, s
METRIC = "bn_kernel_share.train_step"


def host(us: float) -> float:
    """The host time ``us`` microseconds into the window."""
    return H0 + us * 1e-6


def _readings():
    spans = Spans()
    spans.record("window", H0, H1)
    return run.Readings(spans, [{"items": 1}], (H0, H1), None,
                        {"platform": "gpu"})


def _spans(pairs, kernels, thread):
    """``pairs`` BatchNorm spans on ``thread``, the first ``kernels`` of
    them with a kernel span inside."""
    recs = []
    for i in range(pairs):
        t = 10.0 * i
        recs.append(("unet.bn", thread, host(t), host(t + 8)))
        if i < kernels:
            recs.append(("unet.bn_kernel", thread, host(t + 1),
                         host(t + 7)))
    return recs


def test_reads_one_when_every_batch_norm_took_the_kernels(monkeypatch):
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    recs = _spans(4, 4, main) + _spans(4, 4, 99)   # forward, backward
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert run.metric_reader(METRIC)(_readings()) == pytest.approx(1.0)


def test_reads_less_than_one_when_some_took_none(monkeypatch):
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    recs = _spans(4, 4, main) + _spans(4, 1, 99)
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert run.metric_reader(METRIC)(_readings()) == pytest.approx(5 / 8)


def test_falls_silent_without_kernel_spans(monkeypatch):
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    reader = run.metric_reader(METRIC)
    monkeypatch.setattr(profiling, "records",
                        lambda: _spans(4, 0, main))
    assert reader(_readings()) is None
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert reader(_readings()) is None
    monkeypatch.delattr(profiling, "records")
    assert reader(_readings()) is None
