"""The port's test-only main path through its own entry points
(``train.runner.run`` and ``cli.main --only_test``), against the JAX
package's runner, on the CPU.

The recipe is tests/test_e2e.py's ``tiny_env``: a synthetic caltech101 tree
of class-coloured JPEGs and a tiny checkpoint written by torch, here with a
ViT and with a ResNet image tower (both share one text tower).  The BPE
vocab is not in the repository, so both packages get the fake tokenizer of
tests/test_torch_slice.py.  Both packages run in fp32.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import protoclip_tpu.memory.banks as jbanks
import protoclip_tpu.tokenizer.bpe as jbpe
from protoclip_tpu.core.config import Config as JaxConfig
from protoclip_tpu.io.checkpoint import checkpoint_paths as jax_checkpoint_paths
from protoclip_tpu.io.checkpoint import save_checkpoint_triple as jax_save_triple
from protoclip_tpu.models.adapters import adapter_to_torch_state as jax_adapter_to_torch
from protoclip_tpu.models.adapters import init_adapter as jax_init_adapter
from protoclip_tpu.obs.logging import MetricLogger as JaxMetricLogger
from protoclip_tpu.train import runner as jrunner

import protoclip_tpu_torch.memory.banks as banks
from protoclip_tpu_torch.cli import main as cli
from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.io.checkpoint import checkpoint_paths, save_checkpoint_triple
from protoclip_tpu_torch.models.adapters import adapter_to_torch_state, init_adapter
from protoclip_tpu_torch.train import runner
from tests.test_models import _tiny_torch_style_state_dict
from tests.test_resnet_parity import _rand_rn_state_dict
from tests.test_torch_slice import EOT, _FakeVocab, fake_tokenize

N_CLASS, N_TRAIN, N_EVAL, SHOTS = 3, 6, 4, 2  # per class
BACKBONES = ("tiny", "tiny-rn")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner")
    rng = np.random.default_rng(0)
    vit = _tiny_torch_style_state_dict(rng)
    # the ResNet checkpoint: an uneven (2, 1, 1, 2) width-8 tower at 64 px
    # under the ViT checkpoint's text tower, so one fake vocab serves both
    rn = {k: v for k, v in _rand_rn_state_dict(rng, 8, (2, 1, 1, 2)).items()
          if k.startswith("visual.")}
    rn.update({k: v for k, v in vit.items() if not k.startswith("visual.")})
    weights = {}
    for name, sd in (("tiny", vit), ("tiny-rn", rn)):
        weights[name] = str(tmp / f"{name}.pt")
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, weights[name])

    root = tmp / "DATA"
    img_dir = root / "caltech-101" / "101_ObjectCategories"
    rows = {"train": [], "val": [], "test": []}
    colors = [(200, 30, 30), (30, 200, 30), (30, 30, 200)]
    for c, cname in enumerate(["redthing", "greenthing", "bluething"]):
        (img_dir / cname).mkdir(parents=True)
        idx = 0
        for split, count in (("train", N_TRAIN), ("val", N_EVAL), ("test", N_EVAL)):
            for _ in range(count):
                rel = f"{cname}/{idx}.jpg"
                noise = rng.integers(0, 50, (40, 48, 3))
                img = np.clip(np.asarray(colors[c])[None, None] + noise, 0, 255).astype(np.uint8)
                Image.fromarray(img).save(img_dir / rel)
                rows[split].append([rel, c, cname])
                idx += 1
    with open(root / "caltech-101" / "split_zhou_Caltech101.json", "w") as fh:
        json.dump(rows, fh)
    return {"root": str(root), "weights": weights, "tmp": tmp}


@pytest.fixture(autouse=True)
def fake_tokenizer(monkeypatch):
    monkeypatch.setattr(jbanks, "tokenize", fake_tokenize)
    monkeypatch.setattr(banks, "tokenize", fake_tokenize)
    monkeypatch.setattr(jbpe, "_default_tokenizer", lambda: _FakeVocab())
    monkeypatch.setattr(banks, "EOT_ID", EOT)


def configs(env, backbone, tree, **kw):
    """The same operating point for both packages: (port Config, JAX Config)."""
    fields = dict(
        dataset="caltech101", root_path=env["root"], shots=SHOTS, backbone=backbone,
        weights_path=env["weights"][backbone], lr=1e-3, augment_epoch=2, train_epoch=3,
        alpha=0.5, beta=5.0, adapter="fc", batch_size=8, only_test=True,
        cache_root=str(env["tmp"] / tree / "caches"),
        logs_dir_path=str(env["tmp"] / tree / "logs"), compute_dtype="float32",
    )
    fields.update(kw)
    return Config(**fields), JaxConfig(**fields)


def paths_of(cfg):
    return checkpoint_paths(cfg.cache_dir, cfg.backbone, cfg.shots, cfg.alpha, cfg.beta,
                            cfg.lr, cfg.augment_epoch, cfg.train_epoch)


def jax_run(jcfg):
    logger = JaxMetricLogger(jcfg.logs_dir_path, use_tensorboard=False)
    try:
        return jrunner.run(jcfg, progress=False, logger=logger)
    finally:
        logger.close()


def assert_results_match(ours, ref):
    assert ours.zero_shot.keys() == ref.zero_shot.keys()
    for key, value in ref.zero_shot.items():
        assert ours.zero_shot[key] == pytest.approx(value, abs=1e-6), key
    assert ours.test_acc_fixed == pytest.approx(ref.test_acc_fixed, abs=1e-6)
    assert ours.test_acc_searched == pytest.approx(ref.test_acc_searched, abs=1e-6)
    assert (ours.searched_alpha, ours.searched_beta) == (ref.searched_alpha, ref.searched_beta)
    assert (ours.best_val_acc, ours.best_epoch) == (ref.best_val_acc, ref.best_epoch) == (0.0, -1)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_port_scores_a_jax_written_tree(env, backbone, monkeypatch):
    """JAX writes the caches, the zero-shot grids and a triple; the port's
    ``run(only_test=True)`` reads all of it (it encodes nothing) and gives
    JAX's grids exactly and its accuracies within 1e-6."""
    cfg, jcfg = configs(env, backbone, f"jax_tree_{backbone}")
    setup = jrunner.prepare_experiment(jcfg, progress=False)
    adapter = jax_init_adapter(jax.random.PRNGKey(7), setup.bank_t.shape[1], "fc")
    jax_save_triple(*jax_checkpoint_paths(jcfg.cache_dir, jcfg.backbone, jcfg.shots, jcfg.alpha,
                                          jcfg.beta, jcfg.lr, jcfg.augment_epoch,
                                          jcfg.train_epoch),
                    setup.bank_v, setup.bank_t, jax_adapter_to_torch(adapter, "fc"))
    ref = jax_run(jcfg)

    def no_encode(*args, **kwargs):
        raise AssertionError("the port encoded although every feature is cached")

    monkeypatch.setattr(runner, "encode_image", no_encode)
    monkeypatch.setattr(runner, "encode_text", no_encode)
    ours = runner.run(cfg, progress=False, device="cpu")
    assert ours.zero_shot == ref.zero_shot
    assert_results_match(ours, ref)
    assert 0.0 <= ours.test_acc_fixed <= 1.0


@pytest.mark.parametrize("backbone", BACKBONES)
def test_port_tree_matches_jax_and_jax_reads_it(env, backbone):
    """In fresh trees the port's caches hold JAX's features within 1e-5 and
    its zero-shot grids equal JAX's count for count; JAX's ``only_test``
    run on the port's tree (caches, grids and a port-written triple) gives
    the port's results."""
    cfg, _ = configs(env, backbone, f"port_tree_{backbone}")
    _, jcfg_own = configs(env, backbone, f"jax_fresh_{backbone}")
    setup = runner.prepare_experiment(cfg, progress=False, device="cpu")
    jsetup = jrunner.prepare_experiment(jcfg_own, progress=False)
    for name in ("bank_v", "bank_t", "val_feats", "test_feats"):
        np.testing.assert_allclose(getattr(setup, name), np.asarray(getattr(jsetup, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    for name in ("bank_values", "val_labels", "test_labels"):
        np.testing.assert_array_equal(getattr(setup, name), getattr(jsetup, name), err_msg=name)

    cache_root = os.path.join(cfg.cache_dir, "models", backbone.replace("-", "_"), "K-2")
    for stem in ("aug/visual_mb_keys_aug_2_2_shots", "aug/visual_mb_values_aug_2_2_shots",
                 f"text_mb_{backbone.replace('-', '_')}_K_2", "val_features", "val_labels",
                 "test_features", "test_labels"):
        assert os.path.exists(os.path.join(cache_root, stem + ".npz")), stem

    adapter = init_adapter(torch.Generator().manual_seed(7), setup.bank_t.shape[1], "fc")
    save_checkpoint_triple(*paths_of(cfg), setup.bank_v, setup.bank_t,
                           adapter_to_torch_state(adapter, "fc"))
    ours = runner.run(cfg, progress=False, device="cpu")
    jcfg = configs(env, backbone, f"port_tree_{backbone}")[1]
    ref = jax_run(jcfg)
    assert_results_match(ours, ref)

    logger = JaxMetricLogger(jcfg_own.logs_dir_path, use_tensorboard=False)
    try:
        jrunner.zero_shot_sweep_phase(jcfg_own, jsetup, logger, progress=False)
    finally:
        logger.close()
    n_queries = {"val": N_CLASS * N_EVAL, "test": N_CLASS * N_EVAL, "train": N_CLASS * SHOTS}
    for split, n in n_queries.items():
        stem = setup.cache.hp_search_stem(split)
        ours_grid = setup.cache.load(stem)["acc"]
        jax_grid = jsetup.cache.load(stem)["acc"]
        np.testing.assert_array_equal(np.rint(ours_grid * n), np.rint(jax_grid * n), err_msg=split)


def test_cli_only_test_prints_the_result_line(env, capsys):
    cfg, _ = configs(env, "tiny", "cli_tree")
    setup = runner.prepare_experiment(cfg, progress=False, device="cpu")
    adapter = init_adapter(torch.Generator().manual_seed(3), setup.bank_t.shape[1], "fc")
    save_checkpoint_triple(*paths_of(cfg), setup.bank_v, setup.bank_t,
                           adapter_to_torch_state(adapter, "fc"))
    yml = env["tmp"] / "cli.yml"
    yml.write_text("\n".join([
        "dataset: 'caltech101'", "shots: 2", "backbone: 'tiny'", "lr: 0.001",
        "augment_epoch: 2", "train_epoch: 3", "alpha: 0.5", "beta: 5.0", "adapter: 'fc'",
        "compute_dtype: 'float32'", "batch_size: 8", f"cache_root: '{cfg.cache_root}'",
        "search_scale: [12, 5]",  # a vestigial key of the reference: ignored
    ]) + "\n")
    expected = runner.run(cfg, progress=False, device="cpu")
    capsys.readouterr()
    cli.main(["--config", str(yml), "--root_path", env["root"], "--weights_path",
              env["weights"]["tiny"], "--logs", cfg.logs_dir_path, "--only_test",
              "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == (
        f"RESULT dataset=caltech101 test_acc_fixed={expected.test_acc_fixed*100:.2f}% "
        f"test_acc_searched={expected.test_acc_searched*100:.2f}%"
    )


def test_training_and_later_flags_raise(env, tmp_path):
    cfg, _ = configs(env, "tiny", "train_tree", only_test=False)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        runner.run(cfg, progress=False, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.run(configs(env, "tiny", "train_tree")[0], progress=False)
    yml = tmp_path / "c.yml"
    yml.write_text("dataset: 'caltech101'\n")
    with pytest.raises(SystemExit, match="training is not ported"):
        cli.main(["--config", str(yml), "--device", "cpu"])
    for flag in (["--qt"], ["--mesh", "4"], ["--multihost"], ["--resume"],
                 ["--snapshot_every", "5"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            cli.main(["--config", str(yml), "--only_test"] + flag)
