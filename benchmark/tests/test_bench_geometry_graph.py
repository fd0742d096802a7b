"""The reader of the program's ``geometry.replay`` spans,
``geometry_graph_share.train_step``: replay spans over ``geometry.build``
spans on the main thread; 1.0 when every build replayed, the fraction
when some built eagerly, None without replay spans or without the span
API (a program whose build is eager)."""

import threading

import pytest

from benchmark import run
from benchmark.spans import Spans

H0, H1 = 5.0, 5.001                  # the window on the host, s
METRIC = "geometry_graph_share.train_step"


def host(us: float) -> float:
    """The host time ``us`` microseconds into the window."""
    return H0 + us * 1e-6


def _readings():
    spans = Spans()
    spans.record("window", H0, H1)
    return run.Readings(spans, [{"items": 1}], (H0, H1), None,
                        {"platform": "gpu"})


def _spans(builds, replays, thread):
    """``builds`` build spans on ``thread``, the first ``replays`` of them
    with a replay span inside."""
    recs = []
    for i in range(builds):
        t = 10.0 * i
        recs.append(("geometry.build", thread, host(t), host(t + 8)))
        if i < replays:
            recs.append(("geometry.replay", thread, host(t + 1),
                         host(t + 7)))
    return recs


def test_reads_one_when_every_build_replayed(monkeypatch):
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    recs = _spans(3, 3, main)
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert run.metric_reader(METRIC)(_readings()) == pytest.approx(1.0)


def test_reads_the_fraction_when_some_built_eagerly(monkeypatch):
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    recs = _spans(3, 1, main) + _spans(3, 3, 99)   # another thread's
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert run.metric_reader(METRIC)(_readings()) == pytest.approx(1 / 3)


def test_falls_silent_without_replay_spans(monkeypatch):
    from openscene_tpu_torch.utils import profiling
    main = threading.main_thread().ident
    reader = run.metric_reader(METRIC)
    monkeypatch.setattr(profiling, "records", lambda: _spans(3, 0, main))
    assert reader(_readings()) is None
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert reader(_readings()) is None
    monkeypatch.delattr(profiling, "records")
    assert reader(_readings()) is None
