"""The port's deployment toolkit (``protoclip_tpu_torch.toolkit`` and its
CLIs) against the JAX package's, on the CPU.

Both packages load the tiny torch-written CLIP and the ``_v/_t/_a`` triple
of tests/test_toolkit.py's ``classifier_env`` and classify the same crops.
Bars: fp32 top-k probabilities within 1e-5 with equal ids and names; bf16
features and class probabilities at K2's plain-version bars (max|diff| /
max|JAX| < 1e-2, cosine > 0.9999: JAX on the CPU runs its MLP in bf16
where the port's plain K2 keeps the fc bias and QuickGELU in fp32); equal
OOD accuracies; a bit-identical t-SNE embedding.  The classifier's crop
preprocess (one native batch call for its RGB uint8 arrays, PIL for the
rest) gives the serial PIL loop's bytes on a mixed list, with the native
library and without, and its span counts the crops the batch call served.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import protoclip_tpu.memory.banks as jbanks
import protoclip_tpu.tokenizer.bpe as jbpe
from protoclip_tpu.core.config import Config as JaxConfig
from protoclip_tpu.toolkit.classifier import ProtoClipClassifier as JaxClassifier

import protoclip_tpu_torch.memory.banks as banks
from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier, top_k
from tests.test_toolkit import classifier_env  # noqa: F401  (pytest fixture)
from tests.test_torch_runner import configs, env, paths_of  # noqa: F401  (env: pytest fixture)
from tests.test_torch_slice import EOT, _FakeVocab, fake_tokenize

BF16_BARS = (1e-2, 0.9999)  # max|diff| / max|ref|, flattened cosine


def _configs(classifier_env, **kw):
    """The fixture's operating point for both packages: (port, JAX)."""
    fields = {name: getattr(classifier_env["cfg"], name)
              for name in ("dataset", "shots", "backbone", "weights_path", "alpha", "beta",
                        "adapter", "top_k", "compute_dtype")}
    fields.update(kw)
    return Config(**fields), JaxConfig(**fields)


def _triple(classifier_env):
    return dict(splits_path=classifier_env["splits"],
                memory_bank_v_path=classifier_env["v"],
                memory_bank_t_path=classifier_env["t"],
                adapter_weights_path=classifier_env["a"])


def _crops(seed=1):
    rng = np.random.default_rng(seed)
    shapes = ((50, 60), (33, 80), (90, 41), (64, 64), (20, 25))
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for h, w in shapes]


@pytest.fixture(scope="module")
def fp32_pair(classifier_env):
    cfg, jcfg = _configs(classifier_env)
    return (ProtoClipClassifier(cfg, **_triple(classifier_env), device="cpu"),
            JaxClassifier(jcfg, **_triple(classifier_env)))


def _bars(ours, ref, bars):
    ours, ref = np.asarray(ours, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    rel = np.abs(ours - ref).max() / np.abs(ref).max()
    cos = ours @ ref / (np.linalg.norm(ours) * np.linalg.norm(ref))
    assert rel < bars[0] and cos > bars[1], (rel, cos)


def test_classifier_fp32_matches_jax(fp32_pair):
    clf, jclf = fp32_pair
    crops = _crops()
    np.testing.assert_array_equal(clf._preprocess_crops(crops), jclf._preprocess_crops(crops))
    names, probs = clf.classify_objects(crops)
    jnames, jprobs = jclf.classify_objects(crops)
    assert probs.shape == (5, 2) and probs.dtype == np.float32
    np.testing.assert_allclose(probs, jprobs, atol=1e-5, rtol=0)
    assert names == jnames
    assert all(n in ("red cup", "mug", "drill") for row in names for n in row)
    canvases = np.random.default_rng(4).integers(0, 256, (7, 32, 32, 3)).astype(np.uint8)
    (p, i), (jp, ji) = clf.infer_canvases(canvases), jclf.infer_canvases(canvases)
    np.testing.assert_allclose(p, jp, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(i, ji)
    assert i.dtype == np.int32


def _mixed_crops():
    """RGB uint8 arrays, a grayscale and an RGBA array, a non-contiguous
    view and a PIL image: (crops, how many are (H, W, 3) uint8 arrays)."""
    rng = np.random.default_rng(9)
    frame = rng.integers(0, 256, (120, 150, 3), np.uint8)
    crops = [rng.integers(0, 256, (50, 70, 3), np.uint8),
             rng.integers(0, 256, (40, 30), np.uint8),
             frame[10:90:2, 5:120],  # a strided view
             rng.integers(0, 256, (45, 64, 4), np.uint8),
             rng.integers(0, 256, (33, 33, 3), np.uint8),
             Image.fromarray(rng.integers(0, 256, (28, 36, 3), np.uint8))]
    assert not crops[2].flags.c_contiguous
    return crops, 3


@pytest.mark.parametrize("gate", ["unset", "0"])
def test_preprocess_crops_matches_the_serial_loop(fp32_pair, monkeypatch, gate):
    from protoclip_tpu_torch.data.transforms import clip_preprocess

    clf, _ = fp32_pair
    n_px = clf.clip_cfg.image_resolution
    crops, _ = _mixed_crops()
    monkeypatch.setenv("PROTOCLIP_NATIVE", "0")  # the reference: PIL, one crop at a time
    ref = np.stack([clip_preprocess(Image.fromarray(np.asarray(c)), n_px) for c in crops])
    if gate == "unset":
        monkeypatch.delenv("PROTOCLIP_NATIVE")
    got = clf._preprocess_crops(crops)
    assert got.dtype == np.uint8 and got.shape == (len(crops), n_px, n_px, 3)
    np.testing.assert_array_equal(got, ref)


def test_preprocess_native_span_counts_the_rgb_crops(fp32_pair, monkeypatch):
    from protoclip_tpu_torch import native
    from protoclip_tpu_torch.obs import profiler

    monkeypatch.delenv("PROTOCLIP_NATIVE", raising=False)
    if native.load() is None:
        pytest.skip("native preprocess unavailable (no g++)")
    clf, _ = fp32_pair
    crops, n_rgb = _mixed_crops()
    profiler.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            clf._preprocess_crops(crops)
            clf._preprocess_crops(_crops())
        by_name = {}
        for r in profiler.records():
            by_name.setdefault(r.name, []).append(r)
    finally:
        profiler.clear()
    outer, inner = by_name["classify.preprocess"], by_name["classify.preprocess.native"]
    assert [r.rows for r in outer] == [len(crops), len(_crops())]
    assert [r.rows for r in inner] == [n_rgb, len(_crops())]
    assert [r.parent for r in inner] == [r.id for r in outer]


def test_top_k_orders_ties_as_jax():
    p = np.asarray([[0.2, 0.3, 0.3, 0.1, 0.3, 0.3], [0.5, 0.1, 0.1, 0.1, 0.1, 0.1]], np.float32)
    for k in (1, 3, 5, 6):
        values, ids = top_k(torch.from_numpy(p), k)
        jvalues, jids = jax.lax.top_k(jnp.asarray(p), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(values.numpy(), np.asarray(jvalues))


def test_classifier_bf16_matches_jax_at_the_k2_bars(classifier_env):
    """Features and the full class probabilities of the bf16 classifiers."""
    from protoclip_tpu.data.transforms import normalize_batch as jax_normalize
    from protoclip_tpu.models import encode_image as jax_encode
    from protoclip_tpu.ops.proto import l2_normalize as jax_l2

    cfg, jcfg = _configs(classifier_env, compute_dtype="bfloat16")
    clf = ProtoClipClassifier(cfg, **_triple(classifier_env), device="cpu")
    jclf = JaxClassifier(jcfg, **_triple(classifier_env))
    canvases = clf._preprocess_crops(_crops(2))
    feats = clf._encode(torch.from_numpy(canvases))
    jfeats = jax_l2(jax_encode(jclf._clip_params, jax_normalize(jnp.asarray(canvases),
                                                                 jnp.bfloat16),
                               jclf.clip_cfg).astype(jnp.float32))
    _bars(feats.numpy(), jfeats, BF16_BARS)
    probs = clf.model.probs(feats, cfg.alpha, cfg.beta)
    _bars(probs.numpy(), jclf.model.probs(jfeats, cfg.alpha, cfg.beta), BF16_BARS)
    _bars(clf.classify_objects(_crops(2))[1], jclf.classify_objects(_crops(2))[1], BF16_BARS)


def test_classifier_buckets_keep_rows_and_validate(classifier_env):
    cfg, _ = _configs(classifier_env)
    clf = ProtoClipClassifier(cfg, **_triple(classifier_env), max_batch=8,
                              batch_buckets=(2,), device="cpu")
    assert clf.batch_buckets == [2, 8]
    n_px = clf.clip_cfg.image_resolution
    canvases = np.random.default_rng(4).integers(0, 256, (8, n_px, n_px, 3)).astype(np.uint8)
    full_p, full_i = clf.infer_canvases(canvases)
    for n in (1, 2, 3, 8):
        p, i = clf.infer_canvases(canvases[:n])
        assert p.shape == (n, 2)
        np.testing.assert_allclose(p, full_p[:n], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(i, full_i[:n])
    with pytest.raises(ValueError, match="1..8"):
        clf.infer_canvases(np.zeros((9, n_px, n_px, 3), np.uint8))
    with pytest.raises(ValueError, match="1..8"):
        clf.infer_canvases(np.zeros((0, n_px, n_px, 3), np.uint8))
    with pytest.raises(ValueError, match="at most 8 crops"):
        clf.classify_objects([np.zeros((9, 9, 3), np.uint8)] * 9)
    for buckets, max_batch in (((8,), 4), ((0,), 4)):
        with pytest.raises(ValueError, match="batch_buckets"):
            ProtoClipClassifier(cfg, **_triple(classifier_env), max_batch=max_batch,
                                batch_buckets=buckets, device="cpu")
    with pytest.raises(ValueError, match="splits_path or class_id_mapping"):
        ProtoClipClassifier(cfg, memory_bank_t_path=classifier_env["t"], device="cpu")


def test_classifier_reads_a_swapped_model_and_handles_no_crops(fp32_pair):
    clf, _ = fp32_pair
    crops = _crops()
    model = clf.model
    _, before = clf.classify_objects(crops)
    try:
        clf.model = dataclasses.replace(model, bank_t=torch.roll(model.bank_t, 1, dims=0))
        _, after = clf.classify_objects(crops)
    finally:
        clf.model = model
    assert not np.allclose(before, after)
    np.testing.assert_array_equal(clf.classify_objects(crops)[1], before)
    names, probs = clf.classify_objects([])
    assert names == [] and probs.shape == (0, 2) and probs.dtype == np.float32


def test_classifier_log_and_canvas_match_jax(fp32_pair, tmp_path):
    clf, jclf = fp32_pair
    crops = _crops()[:3]
    rgb = np.zeros((8, 8, 3), np.uint8)
    names, probs = clf.classify_objects(crops, log=True, rgb_image=rgb,
                                        log_dir=str(tmp_path / "logs"))
    (log,) = os.listdir(tmp_path / "logs")
    assert log.startswith("experiment_pred_") and log.endswith(".npy")
    saved = np.load(tmp_path / "logs" / log, allow_pickle=True).item()
    assert saved["top_k_classes"] == names
    np.testing.assert_array_equal(saved["top_k_probs"], probs)
    np.testing.assert_array_equal(saved["rgb_image"], rgb)
    assert all(np.array_equal(a, b) for a, b in zip(saved["cropped_images"], crops))
    gts = ["mug", "drill", "nothing"]
    canvas, texts = clf.draw_image_with_top_k_images(crops, names, probs, gts)
    jcanvas, jtexts = jclf.draw_image_with_top_k_images(crops, names, probs, gts)
    assert canvas.size == (650, 360) and texts == jtexts
    np.testing.assert_array_equal(np.asarray(canvas), np.asarray(jcanvas))


def _ood_tree(root, n_class=3, per_class=2):
    rng = np.random.default_rng(2)
    for cls in range(n_class):
        os.makedirs(os.path.join(root, str(cls)), exist_ok=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (32, 40, 3)).astype(np.uint8)).save(
                os.path.join(root, str(cls), f"{i}.jpg"))
    with open(os.path.join(root, "0", ".DS_Store"), "wb") as fh:
        fh.write(b"\x00junk")
    with open(os.path.join(root, "1", "README.txt"), "w") as fh:
        fh.write("not an image")
    return root


def _no_encode(*args, **kwargs):
    raise AssertionError("encoded although the OOD features are cached")


def test_ood_matches_jax_and_shares_its_cache(classifier_env, tmp_path):
    from protoclip_tpu.memory import FeatureCache as JaxCache
    from protoclip_tpu.toolkit.ood import test_ood_performance as jax_ood
    from protoclip_tpu.train.runner import make_encode_fns as jax_encode_fns

    from protoclip_tpu_torch.memory import FeatureCache
    from protoclip_tpu_torch.toolkit.ood import imagenet_v2_items, test_ood_performance
    from protoclip_tpu_torch.train.runner import make_encode_fns

    root = _ood_tree(str(tmp_path / "ood"))
    assert [(os.path.basename(d.impath), d.label) for d in imagenet_v2_items(root)] == [
        (f"{i}.jpg", c) for c in range(3) for i in range(2)]
    cfg, jcfg = _configs(classifier_env)
    triple = dict(memory_bank_v_path=classifier_env["v"], memory_bank_t_path=classifier_env["t"],
                  adapter_weights_path=classifier_env["a"], image_size=32)
    encode, _, _, _ = make_encode_fns(cfg, "cpu")
    jencode, _, _, _ = jax_encode_fns(jcfg)
    caches = {who: str(tmp_path / f"cache_{who}") for who in ("jax", "port")}
    acc = test_ood_performance(cfg, "imagenet_v2", encode, root, device="cpu",
                               cache=FeatureCache(caches["port"], cfg.backbone, cfg.shots),
                               **triple)
    jacc = jax_ood(jcfg, "imagenet_v2", jencode, root,
                   cache=JaxCache(caches["jax"], jcfg.backbone, jcfg.shots), **triple)
    assert 0.0 <= acc <= 100.0 and acc == pytest.approx(jacc, abs=1e-9)
    # each package scores the other's cache and encodes nothing
    assert test_ood_performance(cfg, "imagenet_v2", _no_encode, root, device="cpu",
                                cache=FeatureCache(caches["jax"], cfg.backbone, cfg.shots),
                                **triple) == pytest.approx(jacc, abs=1e-9)
    assert jax_ood(jcfg, "imagenet_v2", _no_encode, root,
                   cache=JaxCache(caches["port"], jcfg.backbone, jcfg.shots),
                   **triple) == pytest.approx(acc, abs=1e-9)
    with pytest.raises(ValueError, match="unknown OOD dataset"):
        test_ood_performance(cfg, "imagenet_r", encode, root, device="cpu", **triple)


def test_tsne_embedding_is_bit_identical_to_jax():
    """The port embeds in one OpenMP thread; JAX's copy runs here in one
    thread too (sklearn's pool spin-waits beside PyTorch's under the test
    workers' load), and gives the same bits."""
    from threadpoolctl import threadpool_limits

    from protoclip_tpu.toolkit.tsne import _tsne_embed as jax_embed

    from protoclip_tpu_torch.toolkit.tsne import _tsne_embed

    rng = np.random.default_rng(0)
    for n_class in (1, 5, 40):
        img, txt = rng.standard_normal((n_class, 16)), rng.standard_normal((n_class, 16))
        with threadpool_limits(limits=1, user_api="openmp"):
            ref_embedding = jax_embed(img, txt, 10.0)
        for ours, ref in zip(_tsne_embed(img, txt, 10.0), ref_embedding):
            assert ours.shape == (n_class, 2)
            np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("plot", ["scatter", "scatter_one_class", "thumbnails_after",
                                  "thumbnails_before"])
def test_tsne_plots_are_written(tmp_path, plot):
    from protoclip_tpu_torch.toolkit.tsne import (plot_prototype_tsne,
                                                  plot_prototype_tsne_thumbnails,
                                                  representative_images_from_split)

    rng = np.random.default_rng(0)
    n_class = 1 if plot == "scatter_one_class" else 4
    img, txt = rng.standard_normal((n_class, 16)), rng.standard_normal((n_class, 16))
    names = [f"class_{i}" for i in range(n_class)]
    out = str(tmp_path / f"{plot}.png")
    if plot.startswith("scatter"):
        assert plot_prototype_tsne(img, txt, names, out) == out
    else:
        rows = []
        for c in range(n_class):
            for k in range(2):
                rel = f"c{c}_{k}.jpg"
                Image.fromarray(rng.integers(0, 256, (24, 24, 3)).astype(np.uint8)).save(
                    tmp_path / rel)
                rows.append([rel, c, names[c]])
        (tmp_path / "split.json").write_text(json.dumps({"train": rows[::-1]}))
        paths = representative_images_from_split(str(tmp_path / "split.json"), str(tmp_path))
        assert [os.path.basename(p) for p in paths] == [f"c{c}_1.jpg" for c in range(n_class)]
        plot_prototype_tsne_thumbnails(img, txt, names, paths, out,
                                       after_train=plot.endswith("after"), figsize=6.0)
        with pytest.raises(ValueError, match="representative"):
            plot_prototype_tsne_thumbnails(img, txt, names, paths[:2], out)
    assert os.path.getsize(out) > 0


def _tiny_yaml(classifier_env, path):
    cfg, _ = _configs(classifier_env)
    keys = ("dataset", "shots", "backbone", "weights_path", "alpha", "beta", "adapter",
            "top_k", "compute_dtype")
    path.write_text("".join(f"{k}: {json.dumps(getattr(cfg, k))}\n" for k in keys))
    return str(path)


def test_tsne_cli_writes_the_plot(classifier_env, tmp_path, capsys):
    from protoclip_tpu_torch.cli import tsne

    out = str(tmp_path / "tsne.png")
    tsne.main(["--config", _tiny_yaml(classifier_env, tmp_path / "c.yml"),
               "--splits", classifier_env["splits"], "--memory_bank_v", classifier_env["v"],
               "--memory_bank_t", classifier_env["t"], "--out", out])
    assert capsys.readouterr().out.strip() == f"Wrote {out}" and os.path.getsize(out) > 0


def test_ood_cli_prints_the_jax_line(classifier_env, tmp_path, capsys, monkeypatch):
    from protoclip_tpu.cli import ood as jax_cli

    from protoclip_tpu_torch.cli import ood

    root = _ood_tree(str(tmp_path / "ood"))
    args = ["--config", _tiny_yaml(classifier_env, tmp_path / "c.yml"), "--ood", "imagenet_v2",
            "--data_root", root, "--memory_bank_v", classifier_env["v"],
            "--memory_bank_t", classifier_env["t"], "--adapter_weights", classifier_env["a"]]
    ood.main(args + ["--device", "cpu"])
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr("sys.argv", ["ood"] + args)
    jax_cli.main()
    assert ours.startswith("OOD imagenet_v2 accuracy: ")
    assert ours == capsys.readouterr().out.strip().splitlines()[-1]


def test_runner_writes_the_prototype_tsne(env, monkeypatch):  # noqa: F811
    """The tiny_env recipe: ``run(only_test=True)`` on a saved triple writes
    ``tsne_prototypes_<dataset>.png`` in the run's log directory."""
    from protoclip_tpu_torch.io.checkpoint import save_checkpoint_triple
    from protoclip_tpu_torch.models.adapters import adapter_to_torch_state, init_adapter
    from protoclip_tpu_torch.train import runner

    monkeypatch.setattr(jbanks, "tokenize", fake_tokenize)
    monkeypatch.setattr(banks, "tokenize", fake_tokenize)
    monkeypatch.setattr(jbpe, "_default_tokenizer", lambda: _FakeVocab())
    monkeypatch.setattr(banks, "EOT_ID", EOT)
    cfg, _ = configs(env, "tiny", "tsne_tree")
    setup = runner.prepare_experiment(cfg, progress=False, device="cpu")
    adapter = init_adapter(torch.Generator().manual_seed(3), setup.bank_t.shape[1], "fc")
    save_checkpoint_triple(*paths_of(cfg), setup.bank_v, setup.bank_t,
                           adapter_to_torch_state(adapter, "fc"))
    runner.run(cfg, progress=False, device="cpu")
    out = os.path.join(cfg.logs_dir_path, cfg.dataset, "tsne_prototypes_caltech101.png")
    assert os.path.getsize(out) > 0


def test_entry_points_default_to_the_card(classifier_env, tmp_path):
    """Without ``device``/``--device`` the classifier, the OOD scorer and the
    OOD and ROS CLIs run on the card, so where CUDA is absent they raise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device does not raise here")
    from protoclip_tpu_torch.cli import ood, ros_node
    from protoclip_tpu_torch.toolkit.ood import test_ood_performance

    cfg, _ = _configs(classifier_env)
    yml = _tiny_yaml(classifier_env, tmp_path / "c.yml")
    calls = [
        lambda: ProtoClipClassifier(cfg, **_triple(classifier_env)),
        lambda: test_ood_performance(cfg, "imagenet_v2", _no_encode, str(tmp_path),
                                     memory_bank_t_path=classifier_env["t"]),
        lambda: ood.main(["--config", yml, "--ood", "imagenet_v2", "--data_root",
                          str(tmp_path), "--memory_bank_t", classifier_env["t"]]),
        lambda: ros_node.build_classifier(ros_node.build_parser().parse_args(
            ["results", "--config", yml, "--splits", classifier_env["splits"],
             "--memory_bank_t", classifier_env["t"]])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_paper_figures_over_the_port_classifier(fp32_pair, tmp_path):
    from protoclip_tpu.toolkit.paper_figures import paper_set_groups as jax_groups

    from protoclip_tpu_torch.toolkit.paper_figures import (generate_prediction_figures,
                                                           paper_set_groups)

    clf, _ = fp32_pair
    split = {"test": [[f"img/{i}.png", i % 3, f"class_{i % 3}"] for i in range(32)]}
    assert paper_set_groups(split, "DATA") == jax_groups(split, "DATA")
    groups, gts = paper_set_groups(split, str(tmp_path))
    assert len(groups) == 8 and all(len(g) == 4 for g in groups)
    rng = np.random.default_rng(5)
    os.makedirs(tmp_path / "img")
    for row in split["test"]:
        Image.fromarray(rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)).save(
            tmp_path / row[0])
    out = generate_prediction_figures(clf, groups[:2], str(tmp_path / "figs"), gts[:2])
    assert [os.path.basename(p) for p in out] == ["prediction_group_0.png",
                                                  "prediction_group_1.png"]
    assert all(Image.open(p).size == (650, 360) for p in out)
