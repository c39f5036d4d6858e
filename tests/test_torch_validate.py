"""The port's validator scripts on the CPU: ``scripts.validate_accuracy``
against the JAX package's ``scripts/validate_accuracy.py``, and
``scripts.validate_experiment`` on a tiny backbone.

The recipe is tests/test_torch_runner.py's (tests/test_e2e.py's
``tiny_env``: a synthetic caltech101 tree, a tiny torch-written checkpoint,
the fake tokenizer in both packages), in fp32, with one config dir holding
one dataset.  Both packages train the adapter from JAX's initial draw (the
port's draw is patched to it, as tests/test_torch_train_runner.py does), so
their accuracies agree within 1e-6.  JAX on the CPU runs its int8 pass in
bf16, so the port's ``--int8`` column is held to K3's plain version and its
own cache tree instead of to JAX's column.
"""

import json
import os

import pytest
import yaml

import jax

from protoclip_tpu.io.checkpoint import checkpoint_paths as jax_checkpoint_paths
from protoclip_tpu.io.checkpoint import model_dir_root as jax_model_dir_root
from protoclip_tpu.models.adapters import adapter_to_torch_state as jax_adapter_to_torch
from protoclip_tpu.models.adapters import init_adapter as jax_init_adapter
from scripts import validate_accuracy as jax_va

from protoclip_tpu_torch.models import clip
from protoclip_tpu_torch.models.adapters import adapter_from_torch_state
from protoclip_tpu_torch.ops import kernels
from protoclip_tpu_torch.scripts import validate_accuracy as va
from protoclip_tpu_torch.scripts import validate_experiment as ve
from protoclip_tpu_torch.train import episodic, runner
from tests.test_models import TINY_VIT
from tests.test_torch_models import port_config
from tests.test_torch_runner import env, fake_tokenizer  # noqa: F401  (fixtures)

SCORES = ("test_acc_fixed", "test_acc_searched")


@pytest.fixture(autouse=True)
def jax_adapter_draw(monkeypatch):
    def draw(generator, c_in, kind):
        state = jax_adapter_to_torch(
            jax_init_adapter(jax.random.PRNGKey(generator.initial_seed()), c_in, kind), kind)
        return adapter_from_torch_state(state, kind)

    monkeypatch.setattr(episodic, "init_adapter", draw)


@pytest.fixture()
def config_dir(env, tmp_path):  # noqa: F811
    """One dataset's operating point, as tests/test_e2e.py's dry run writes it."""
    path = tmp_path / "configs"
    path.mkdir()
    with open(path / "caltech101.yml", "w") as fh:
        yaml.safe_dump(dict(dataset="caltech101", shots=2, backbone="tiny",
                            weights_path=env["weights"]["tiny"], lr=1e-3, augment_epoch=2,
                            train_epoch=3, alpha=0.5, beta=5.0, adapter="fc", batch_size=8,
                            compute_dtype="float32"), fh)
    return str(path)


def args_for(tree, config_dir, root, *extra):
    out = os.path.join(tree, "ACCURACY.md")
    return out, ["--only", "caltech101", "--data-root", root, "--config-dir", config_dir,
                 "--out", out, "--set", "train_epoch=1",
                 "--set", f"cache_root={os.path.join(tree, 'caches')}",
                 "--set", f"logs_dir_path={os.path.join(tree, 'logs')}", *extra]


def run_jax(monkeypatch, argv):
    monkeypatch.delenv("PROTOCLIP_INT8", raising=False)
    monkeypatch.setattr("sys.argv", ["validate_accuracy.py", *argv])
    jax_va.main()


def table_rows(path):
    """The table's data rows, split into cells."""
    with open(path) as fh:
        lines = [line for line in fh if line.startswith("| ")]
    return [[c.strip() for c in line.strip().strip("|").split("|")] for line in lines]


@pytest.fixture()
def block_calls(monkeypatch):
    """Calls of K2's and K3's plain versions, per ``runner.run`` call."""
    counts = {"K2": 0, "K3": 0}
    runs = []

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(kernels, "fused_transformer_block_plain",
                        counted(kernels.fused_transformer_block_plain, "K2"))
    monkeypatch.setattr(kernels, "fused_transformer_block_int8_plain",
                        counted(kernels.fused_transformer_block_int8_plain, "K3"))
    real_run = runner.run

    def run(cfg, *args, **kwargs):
        before = dict(counts)
        result = real_run(cfg, *args, **kwargs)
        runs.append({"cache_root": cfg.cache_root, "int8": kwargs.get("int8"),
                     **{k: counts[k] - before[k] for k in counts}})
        return result

    monkeypatch.setattr(runner, "run", run)
    return runs


def test_accuracy_table_matches_jax(env, config_dir, tmp_path, monkeypatch,  # noqa: F811
                                    block_calls):
    """``--int8`` on both: the records agree key for key and the fp32
    accuracies within 1e-6; the table rows agree but for the int8 columns
    and the wall time; the port's int8 pass ran K3's plain version only, in
    its own cache tree."""
    jax_out, jax_argv = args_for(str(tmp_path / "jax"), config_dir, env["root"], "--int8")
    run_jax(monkeypatch, jax_argv)
    out, argv = args_for(str(tmp_path / "port"), config_dir, env["root"], "--int8",
                         "--device", "cpu")
    va.main(argv)

    with open(jax_out + ".json") as fh:
        want = json.load(fh)
    with open(out + ".json") as fh:
        got = json.load(fh)
    assert len(got) == len(want) == 1
    got, want = got[0], want[0]
    assert got.keys() == want.keys() and "error" not in got
    for key in ("dataset", "backbone", "alpha", "beta", "adapter"):
        assert got[key] == want[key], key
    for key in SCORES:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert 0.0 <= got["test_acc_int8"] <= 1.0
    assert got["int8_delta"] == pytest.approx(got["test_acc_int8"] - got["test_acc_fixed"])

    rows, jax_rows = table_rows(out), table_rows(jax_out)
    assert rows[0] == jax_rows[0] and "test acc (int8 W8A8) %" in rows[0]
    assert [r[:7] for r in rows[1:]] == [r[:7] for r in jax_rows[1:]]
    assert "ERROR" not in open(out).read() and "skip" not in open(out).read()

    port_root = str(tmp_path / "port" / "caches")
    assert [(r["cache_root"], r["int8"]) for r in block_calls] == [
        (port_root, False), (port_root + "-int8", True)]
    bf16, int8 = block_calls
    assert bf16["K2"] > 0 and bf16["K3"] == 0, bf16
    assert int8["K3"] > 0 and int8["K2"] == 0, int8
    assert os.path.isdir(os.path.join(port_root + "-int8", "caltech101"))
    assert os.environ.get("PROTOCLIP_INT8") is None


@pytest.mark.parametrize("case", ["missing_data", "broken_config"])
def test_failed_datasets_are_rows_as_in_jax(env, config_dir, tmp_path, monkeypatch,  # noqa: F811
                                            case):
    """A missing data root is a ``skip`` row, any other failure (here a
    dataset name the registry does not know) an ``ERROR`` row; the run goes on and
    writes the table, as JAX's does."""
    root, extra = env["root"], []
    if case == "missing_data":
        root = str(tmp_path / "no_such_data")
    else:
        extra = ["--set", "dataset=no_such_dataset"]
    marker = "skip" if case == "missing_data" else "ERROR"
    jax_out, jax_argv = args_for(str(tmp_path / "jax"), config_dir, root, *extra)
    run_jax(monkeypatch, jax_argv)
    out, argv = args_for(str(tmp_path / "port"), config_dir, root, *extra, "--device", "cpu")
    va.main(argv)

    rows, jax_rows = table_rows(out), table_rows(jax_out)
    assert rows[0] == jax_rows[0]
    assert rows[1][:7] == jax_rows[1][:7]
    assert rows[1][5] == rows[1][6] == marker
    with open(out + ".json") as fh:
        (record,) = json.load(fh)
    with open(jax_out + ".json") as fh:
        (jax_record,) = json.load(fh)
    assert record.keys() == jax_record.keys()
    prefix = "missing data: " if case == "missing_data" else "KeyError: "
    assert record["error"].startswith(prefix) and jax_record["error"].startswith(prefix)


@pytest.fixture()
def tiny_backbone(monkeypatch):
    """``--backbone tiny``: the tiny ViT of the fake vocab, random-init."""
    monkeypatch.setitem(clip.BACKBONE_CONFIGS, "tiny", port_config(TINY_VIT))


def test_validate_experiment_writes_jax_artifacts_and_reproduces(tiny_backbone, monkeypatch,
                                                                 capsys):
    """``validate_experiment --device cpu``: the full run writes the bank,
    feature and triple files at the paths the JAX package computes, and the
    ``only_test`` rerun reproduces the fixed accuracy."""
    seen = []
    real_run = runner.run

    def run(cfg, *args, **kwargs):
        result = real_run(cfg, *args, **kwargs)
        cache = jax_model_dir_root(cfg.cache_dir, cfg.backbone, cfg.shots)
        paths = [os.path.join(cache, "aug", f"visual_mb_keys_aug_2_{cfg.shots}_shots.npz"),
                 os.path.join(cache, "val_features.npz"), os.path.join(cache, "test_features.npz"),
                 *jax_checkpoint_paths(cfg.cache_dir, cfg.backbone, cfg.shots, cfg.alpha,
                                       cfg.beta, cfg.lr, cfg.augment_epoch, cfg.train_epoch)]
        seen.append((cfg.only_test, [p for p in paths if not os.path.exists(p)], result))
        return result

    monkeypatch.setattr(runner, "run", run)
    assert ve.main(["--backbone", "tiny", "--train_epoch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert [(only_test, missing) for only_test, missing, _ in seen] == [(False, []), (True, [])]
    assert seen[0][2].best_epoch >= 0
    assert seen[1][2].test_acc_fixed == seen[0][2].test_acc_fixed
    assert "[validate] backend=cpu device=cpu" in out
    assert "[validate] only_test reload:" in out and "acc reproduced" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["ok"] is True and summary["backend"] == "cpu"
    assert summary["test_acc_fixed"] == seen[0][2].test_acc_fixed


def test_validate_experiment_fails_on_a_rerun_that_does_not_reproduce(tiny_backbone,
                                                                      monkeypatch, capsys):
    import dataclasses

    real_run = runner.run

    def run(cfg, *args, **kwargs):
        result = real_run(cfg, *args, **kwargs)
        if cfg.only_test:
            result = dataclasses.replace(result, test_acc_fixed=result.test_acc_fixed + 0.5)
        return result

    monkeypatch.setattr(runner, "run", run)
    assert ve.main(["--backbone", "tiny", "--train_epoch", "1", "--device", "cpu"]) == 1
    assert "[validate] FAIL: only_test acc" in capsys.readouterr().out


def test_the_scripts_default_to_the_card(config_dir, tmp_path, monkeypatch):
    """Without ``--device`` both run on the card: where CUDA is absent they
    raise before any work, and nothing runs on the CPU."""
    import torch

    def no_run(*args, **kwargs):
        raise AssertionError("a run started without the card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runner, "run", no_run)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ve.main(["--backbone", "tiny"])
    out = tmp_path / "ACCURACY.md"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        va.main(["--only", "caltech101", "--config-dir", config_dir, "--out", str(out)])
    assert not out.exists()
