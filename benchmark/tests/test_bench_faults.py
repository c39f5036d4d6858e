"""A run with its timed path broken underneath comes out not correct.

Each test skips nothing of a run but the look for a card: the tiny copy
of each cell runs on the CPU with a fault planted in the program where
the answer is produced, and ``correct`` must read false.  The faults that
these cells can have: half of a batch left out (its rows answered with
the other half's), and one answer altered.  They keep no state from step
to step and run on one chip, so a state left unchanged and an exchange
between chips left out have nothing to break here.
"""

import time

import numpy as np
import pytest
import torch

from benchmark import harness

HALF, ONE = "half of the batch left out", "one answer altered"


def _broken_rows(out, fault):
    out = out.clone()
    n = len(out)
    if fault == HALF:
        out[n - n // 2:] = out[:n // 2]
    else:
        out[0] = out[-1] if n > 1 else -out[0]
    return out


def _run(bench, workload):
    return harness.run_cell(workload, 2 ** 31 + 3, 1.0, False, t0=time.perf_counter(),
                            device="cpu", bench=bench)


def test_sound_runs_are_correct(tiny_bench):
    for w in ("vit-b16.bank-1024", "vit-l14.scene", "vit-b16.serve-encode"):
        assert _run(tiny_bench, w)["correct"], w


@pytest.mark.parametrize("fault", [HALF, ONE])
def test_bank_encode_broken(tiny_bench, monkeypatch, fault):
    from protoclip_tpu_torch.train import runner

    make = runner.make_encode_fns

    def broken(*args, **kwargs):
        fns = make(*args, **kwargs)
        return (lambda images: _broken_rows(fns[0](images), fault),) + fns[1:]

    monkeypatch.setattr(runner, "make_encode_fns", broken)
    assert not _run(tiny_bench, "vit-b16.bank-1024")["correct"]


@pytest.mark.parametrize("fault", [HALF, ONE])
def test_scene_classifier_broken(tiny_bench, monkeypatch, fault):
    from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier

    infer = ProtoClipClassifier.infer_canvases

    def broken(self, canvases):
        probs, ids = infer(self, canvases)
        if fault == ONE:
            ids = ids.copy()
            ids[:, 0] = (ids[:, 0] + 1) % self.model.n_class
            return probs, ids
        n = len(ids)
        out = [np.array(a) for a in (probs, ids)]
        for a in out:
            a[n - n // 2:] = a[:n // 2]
        return tuple(out)

    monkeypatch.setattr(ProtoClipClassifier, "infer_canvases", broken)
    assert not _run(tiny_bench, "vit-l14.scene")["correct"]


@pytest.mark.parametrize("fault", [HALF, ONE])
def test_served_bundle_broken(tiny_bench, monkeypatch, fault):
    from protoclip_tpu_torch.io import export

    load = export.load_serving_bundle

    def broken(*args, **kwargs):
        encode = load(*args, **kwargs)

        def run(images_u8):
            return _broken_rows(torch.from_numpy(encode(images_u8)), fault).numpy()

        run.__dict__.update(encode.__dict__)
        return run

    monkeypatch.setattr(export, "load_serving_bundle", broken)
    assert not _run(tiny_bench, "vit-b16.serve-encode")["correct"]
