"""The port's training runners (``train.runner.run`` with ``only_test=False``,
``train.qt_runner.run_qt``) and ``cli.main``'s training flags, against the
JAX package's runners, on the CPU in fp32.

The recipe is tests/test_torch_runner.py's: the ``tiny_env`` caltech101
tree, the tiny ViT checkpoint and the fake tokenizer.  JAX draws the
adapter's initial weights from a JAX PRNG key, so the port's draw is patched
here (and only here) to JAX's, carried through the torch state-dict layout.
The trained parameters are compared in fp32 through the trainer snapshots
(within 1e-5 of the largest |parameter|); the triples are stored in fp16,
as the reference stores them, so there an fp32 difference of an ulp may
round to neighbouring fp16 values, and each triple is held to one fp16 step.
"""

import os

import numpy as np
import pytest

import jax

from protoclip_tpu.io.checkpoint import checkpoint_paths as jax_checkpoint_paths
from protoclip_tpu.io.torch_pt import load_pkl as jax_load_pkl
from protoclip_tpu.models.adapters import adapter_to_torch_state as jax_adapter_to_torch
from protoclip_tpu.models.adapters import init_adapter as jax_init_adapter
from protoclip_tpu.obs.logging import MetricLogger as JaxMetricLogger
from protoclip_tpu.train import qt_runner as jqt_runner
from protoclip_tpu.train import runner as jrunner

from protoclip_tpu_torch.cli import main as cli
from protoclip_tpu_torch.io.checkpoint import load_checkpoint_triple, load_pkl
from protoclip_tpu_torch.models.adapters import adapter_from_torch_state
from protoclip_tpu_torch.obs.logging import MetricLogger
from protoclip_tpu_torch.train import episodic, qt_runner, runner
from tests.test_torch_runner import configs, env, fake_tokenizer  # noqa: F401  (fixtures)

TRAIN = dict(only_test=False, train_epoch=3, snapshot_every=1)


@pytest.fixture(autouse=True)
def jax_adapter_draw(monkeypatch):
    def draw(generator, c_in, kind):
        state = jax_adapter_to_torch(
            jax_init_adapter(jax.random.PRNGKey(generator.initial_seed()), c_in, kind), kind)
        return adapter_from_torch_state(state, kind)

    monkeypatch.setattr(episodic, "init_adapter", draw)


def jax_call(fn, jcfg):
    logger = JaxMetricLogger(jcfg.logs_dir_path, use_tensorboard=False)
    try:
        return fn(jcfg, progress=False, logger=logger)
    finally:
        logger.close()


def triple_paths(cfg, qt=False):
    return jax_checkpoint_paths(cfg.cache_dir, cfg.backbone, cfg.shots, cfg.alpha, cfg.beta,
                                cfg.lr, cfg.augment_epoch, cfg.train_epoch, qt=qt)


def flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def assert_trained_alike(cfg, jcfg, ours, ref, qt=False):
    """Results equal, the final fp32 snapshots within 1e-5 of max|param|,
    the fp16 triples within one fp16 step."""
    assert ours.zero_shot == pytest.approx(ref.zero_shot, abs=1e-6)
    assert (ours.best_val_acc, ours.best_epoch) == pytest.approx((ref.best_val_acc, ref.best_epoch),
                                                                 abs=1e-6)
    assert ours.best_epoch >= 0
    assert ours.test_acc_fixed == pytest.approx(ref.test_acc_fixed, abs=1e-6)
    assert ours.test_acc_searched == pytest.approx(ref.test_acc_searched, abs=1e-6)
    assert (ours.searched_alpha, ours.searched_beta) == (ref.searched_alpha, ref.searched_beta)

    snap, jsnap = (runner.snapshot_path(triple_paths(c, qt)[0]) for c in (cfg, jcfg))
    got, want = load_pkl(snap), jax_load_pkl(jsnap)
    assert got["epoch"] == want["epoch"] == cfg.train_epoch
    assert got["kind"] == want["kind"]
    params, jparams = dict(flat(got["params"])), dict(flat(want["params"]))
    assert params.keys() == jparams.keys()
    scale = max(float(np.abs(v).max()) for v in jparams.values())
    for name, value in jparams.items():
        assert float(np.abs(params[name] - value).max()) <= 1e-5 * scale, name

    for a, b in zip(load_checkpoint_triple(*triple_paths(cfg, qt)),
                    load_checkpoint_triple(*triple_paths(jcfg, qt))):
        items = a.items() if isinstance(a, dict) else [("bank", a)]
        for key, value in items:
            other = b[key] if isinstance(b, dict) else b
            step = np.spacing(np.abs(other).astype(np.float16)).astype(np.float32)
            assert (np.abs(value - other) <= step).all(), key


@pytest.mark.parametrize("adapter,vis_only", [("fc", False), ("conv-3x", True)])
def test_run_trains_as_jax_and_each_scores_the_others_triple(env, adapter, vis_only):
    kw = dict(adapter=adapter, train_vis_mem_only=vis_only)
    cfg, _ = configs(env, "tiny", f"port_{adapter}", **kw, **TRAIN)
    _, jcfg = configs(env, "tiny", f"jax_{adapter}", **kw, **TRAIN)
    ours = runner.run(cfg, progress=False, device="cpu")
    ref = jax_call(jrunner.run, jcfg)
    assert_trained_alike(cfg, jcfg, ours, ref)

    # JAX's test phase scores the triple the port wrote, and the reverse
    _, jcfg_port_tree = configs(env, "tiny", f"port_{adapter}", **kw, only_test=True)
    cfg_jax_tree, _ = configs(env, "tiny", f"jax_{adapter}", **kw, only_test=True)
    jax_scores = jax_call(jrunner.run, jcfg_port_tree)
    assert jax_scores.test_acc_fixed == pytest.approx(ours.test_acc_fixed, abs=1e-6)
    assert jax_scores.test_acc_searched == pytest.approx(ours.test_acc_searched, abs=1e-6)
    port_scores = runner.run(cfg_jax_tree, progress=False, device="cpu")
    assert port_scores.test_acc_fixed == pytest.approx(ref.test_acc_fixed, abs=1e-6)
    assert port_scores.test_acc_searched == pytest.approx(ref.test_acc_searched, abs=1e-6)


def test_run_qt_trains_as_jax(env):
    kw = dict(TRAIN, train_epoch=2)
    cfg, _ = configs(env, "tiny", "port_qt", **kw)
    _, jcfg = configs(env, "tiny", "jax_qt", **kw)
    ours = qt_runner.run_qt(cfg, progress=False, device="cpu")
    ref = jax_call(jqt_runner.run_qt, jcfg)
    assert_trained_alike(cfg, jcfg, ours, ref, qt=True)
    assert os.path.exists(triple_paths(cfg, qt=True)[0])
    assert "best-alpha-beta" in triple_paths(cfg, qt=True)[0]


class _Preempted(Exception):
    pass


class _PreemptingLogger(MetricLogger):
    def scalar(self, tag, value, step):
        if tag == "Loss/train" and step == 2:
            raise _Preempted()
        super().scalar(tag, value, step)


@pytest.mark.parametrize("run_fn", [runner.run, qt_runner.run_qt], ids=["episodic", "qt"])
def test_resumed_run_repeats_the_uninterrupted_one(env, run_fn):
    """A run preempted after its epoch-2 snapshot and resumed ends in the
    uninterrupted run's state bit for bit, its best-val bookkeeping too."""
    qt = run_fn is qt_runner.run_qt
    kw = dict(only_test=False, train_epoch=4, snapshot_every=2)
    cfg, _ = configs(env, "tiny", f"straight_{qt}", **kw)
    straight = run_fn(cfg, progress=False, device="cpu")
    cfg_killed, _ = configs(env, "tiny", f"killed_{qt}", **kw)
    logger = _PreemptingLogger(cfg_killed.logs_dir_path)
    try:
        with pytest.raises(_Preempted):
            run_fn(cfg_killed, progress=False, device="cpu", logger=logger)
    finally:
        logger.close()
    snap = runner.snapshot_path(triple_paths(cfg_killed, qt)[0])
    assert load_pkl(snap)["epoch"] == 2
    cfg_resumed, _ = configs(env, "tiny", f"killed_{qt}", resume=True, **kw)
    resumed = run_fn(cfg_resumed, progress=False, device="cpu")
    assert (resumed.best_val_acc, resumed.best_epoch) == (straight.best_val_acc,
                                                          straight.best_epoch)
    assert resumed.test_acc_fixed == straight.test_acc_fixed
    a = load_pkl(runner.snapshot_path(triple_paths(cfg, qt)[0]))
    b = load_pkl(snap)
    assert a["epoch"] == b["epoch"] == 4
    for (name, x), (_, y) in zip(flat(a["params"]), flat(b["params"])):
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in a["optimizer"]:
        for moment in ("step", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(a["optimizer"][name][moment],
                                          b["optimizer"][name][moment], err_msg=name)


@pytest.mark.parametrize("qt", [False, True], ids=["episodic", "qt"])
def test_cli_trains_and_prints_the_result_line(env, capsys, qt):
    cfg, _ = configs(env, "tiny", f"cli_train_{qt}", only_test=False, train_epoch=2)
    yml = env["tmp"] / f"cli_train_{qt}.yml"
    yml.write_text("\n".join([
        "dataset: 'caltech101'", "shots: 2", "backbone: 'tiny'", "lr: 0.001",
        "augment_epoch: 2", "train_epoch: 2", "alpha: 0.5", "beta: 5.0", "adapter: 'fc'",
        "compute_dtype: 'float32'", "batch_size: 8", f"cache_root: '{cfg.cache_root}'",
    ]) + "\n")
    argv = ["--config", str(yml), "--root_path", env["root"], "--weights_path",
            env["weights"]["tiny"], "--logs", cfg.logs_dir_path, "--device", "cpu",
            "--snapshot_every", "1"] + (["--qt"] if qt else [])
    cli.main(argv)
    first = capsys.readouterr().out.splitlines()[-1]
    assert first.startswith("RESULT dataset=caltech101 test_acc_fixed=")
    assert os.path.exists(runner.snapshot_path(triple_paths(cfg, qt)[0]))
    # --resume with the finished run's snapshot trains no further epoch
    cli.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "[resume] restored" in out and out.splitlines()[-1] == first
