"""The port's spans (``protoclip_tpu_torch/obs/profiler.py``) on the CPU:
counted always and kept only while a profiler records, never a profiler
range, exact under threads, on the profiler's clock, in ``trace_to``'s
Chrome trace, and where the bank build and the classifier do their work."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from protoclip_tpu_torch.data.loader import ArrayLoader
from protoclip_tpu_torch.memory.banks import encode_loader
from protoclip_tpu_torch.obs import profiler
from protoclip_tpu_torch.obs.profiler import span, trace_to
from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier
from protoclip_tpu_torch.train.runner import make_encode_fns
from tests.test_toolkit import classifier_env  # noqa: F401  (pytest fixture)
from tests.test_torch_ragged import tiny_cfg  # noqa: F401  (pytest fixture)
from tests.test_torch_toolkit import _configs, _crops, _triple


@pytest.fixture(autouse=True)
def fresh_table():
    profiler.clear()
    yield
    profiler.clear()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name():
    out = {}
    for r in profiler.records():
        out.setdefault(r.name, []).append(r)
    return out


def test_untraced_span_counts_and_keeps_no_record(monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("a span opened a profiler range")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    with profiler.request("/encode"):
        with span("outer", rows=3, nbytes=10):
            with span("inner", rows=1) as inner:
                inner.nbytes = 7
    with span("outer"):
        pass
    assert profiler.records() == []
    totals = profiler.totals()
    assert totals[("outer", "/encode")][0::2] == (1, 3) and totals[("outer", "/encode")][3] == 10
    assert totals[("inner", "/encode")][0] == 1 and totals[("inner", "/encode")][2:] == (1, 7)
    assert totals[("outer", "/encode")][1] >= totals[("inner", "/encode")][1] > 0
    assert totals[("outer", "")][0] == 1  # outside a request: no label
    profiler.clear(totals=False)
    assert ("outer", "/encode") in profiler.totals()


def test_threads_count_exactly():
    threads, each = 8, 10_000
    barrier = threading.Barrier(threads)

    def work(i):
        barrier.wait()
        with profiler.request("t"):
            for _ in range(each):
                with span("hot", rows=1, nbytes=i):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(interval)
    count, ns, rows, nbytes = profiler.totals()[("hot", "t")]
    assert (count, rows, nbytes) == (threads * each, threads * each, each * sum(range(threads)))
    assert ns > 0


def test_records_lie_on_the_profilers_clock():
    with _profile() as prof:
        with torch.profiler.record_function("enclosing"):
            with profiler.request("/classify") as req:
                with span("outer") as outer:
                    with span("inner", rows=2):
                        torch.ones(64).sum()
    (rf,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "enclosing"]
    records = _by_name()
    (o,), (i,) = records["outer"], records["inner"]
    for r in (o, i):
        assert rf.start_ns() - 1_000_000 <= r.start_ns <= r.end_ns <= rf.end_ns() + 1_000_000
        assert r.request == req.id and r.label == "/classify"
    assert o.parent == 0 and i.parent == o.id == outer.id and i.rows == 2
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns


def test_trace_to_writes_the_spans(tmp_path):
    with trace_to(str(tmp_path)):
        done = threading.Event()

        def other_thread():  # no profiler of its own: trace_to records it
            with span("elsewhere"):
                pass
            done.set()

        with span("here", rows=4):
            threading.Thread(target=other_thread).start()
            assert done.wait(30)
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"]
    spans = {e["name"]: e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "span"}
    assert set(spans) == {"here", "elsewhere"}
    (here,) = [r for r in profiler.records() if r.name == "here"]
    assert spans["here"]["ts"] == pytest.approx((here.start_ns - base) / 1e3)
    assert spans["here"]["args"]["rows"] == 4
    assert spans["elsewhere"]["tid"] != spans["here"]["tid"]


def test_bank_build_spans(tiny_cfg):
    """The bank build through the runner's encode: the ragged last batch is
    uploaded and read back at its 96 valid rows, and nothing pads it."""
    images = np.zeros((3168, 32, 32, 3), np.uint8)
    labels = np.arange(3168, dtype=np.int32) % 11
    encode = make_encode_fns(tiny_cfg, device="cpu")[0]
    with _profile():
        feats, got = encode_loader(encode, ArrayLoader(images, labels, batch_size=1024))
    assert feats.shape == (3168, 32) and np.array_equal(got, labels)
    records = _by_name()
    assert "loader.pad" not in records
    (root,) = records["encode_loader"]
    readbacks, uploads = records["encode_loader.readback"], records["encode.upload"]
    assert [r.rows for r in readbacks] == [u.rows for u in uploads] == [1024, 1024, 1024, 96]
    assert [u.nbytes for u in uploads] == [u.rows * 32 * 32 * 3 for u in uploads]
    assert root.rows == 3168 and root.parent == 0
    totals = profiler.totals()
    assert totals[("encode.upload", "")][2] == totals[("encode_loader", "")][2] == 3168
    assert all(r.parent == root.id and r.request == root.id for r in readbacks + uploads)


def test_classifier_spans(classifier_env):
    cfg, _ = _configs(classifier_env)
    clf = ProtoClipClassifier(cfg, **_triple(classifier_env), device="cpu",
                              batch_buckets=(2, 8), max_batch=8)
    crops = _crops()
    calls = 2
    with _profile():
        for _ in range(calls):
            clf.classify_objects(crops)
    records = _by_name()
    roots = records["classify"]
    assert len(roots) == calls and all(r.rows == len(crops) and r.parent == 0 for r in roots)
    for name, rows in (("classify.preprocess", len(crops)), ("infer.issue", 8),
                       ("infer.readback", len(crops))):
        spans = records[name]
        assert len(spans) == calls and all(s.rows == rows for s in spans), name
        assert [s.parent for s in spans] == [r.id for r in roots]
        assert [s.request for s in spans] == [r.id for r in roots]
