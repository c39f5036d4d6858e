"""The port's quickstarts (``protoclip_tpu_torch/examples``) run as a user
runs them: real subprocesses, ``python -m ... --device cpu``.  Train:
synthetic data -> ``run()`` -> the written triple -> the deployment
classifier.  Serve: the export CLI -> the serve CLI -> ``ServeClient`` ->
SIGTERM; the served rows are held against the JAX package's encode of the
quickstart's own weights file at the bf16 bars.

The training quickstart's data tree and checkpoint also go through both
packages' ``run()`` and deployment classifiers in this process, and are
held within 1e-6.  The BPE vocab is not in the repository, so both
packages get the port's stand-in tokenizer (``scripts/_env.py``), which
keeps CLIP's SOT and EOT ids (the checkpoint has CLIP's 49408-token
vocabulary), and the port draws its adapter as JAX does (as
tests/test_torch_validate.py does).
"""

import ast
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import protoclip_tpu.memory.banks as jbanks
import protoclip_tpu.tokenizer.bpe as jbpe
from protoclip_tpu.core.config import Config as JaxConfig
from protoclip_tpu.data.transforms import clip_preprocess as jax_clip_preprocess
from protoclip_tpu.io.export import make_encode_fn as jax_make_encode_fn
from protoclip_tpu.models import load_clip as jax_load_clip
from protoclip_tpu.toolkit.classifier import ProtoClipClassifier as JaxClassifier

import protoclip_tpu_torch.memory.banks as banks
from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.examples import serving_quickstart, train_quickstart
from protoclip_tpu_torch.io import load_checkpoint_triple
from protoclip_tpu_torch.scripts._env import EOT_ID, synthetic_tokenize
from protoclip_tpu_torch.toolkit import ProtoClipClassifier
from protoclip_tpu_torch.train import runner
from tests.test_torch_export import BF16_BARS, _bars
from tests.test_torch_runner import jax_run
from tests.test_torch_validate import jax_adapter_draw  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("redthing", "greenthing", "bluething")


def run_example(name: str, tmp_path, timeout: int) -> str:
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("PROTOCLIP_BPE_PATH", None)  # the quickstart's own byte-level fallback
    proc = subprocess.run(
        [sys.executable, "-m", f"protoclip_tpu_torch.examples.{name}", "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr}"
    )
    return proc.stdout


def test_train_quickstart_runs(tmp_path):
    out = run_example("train_quickstart", tmp_path, timeout=300)
    assert "device cpu" in out
    fixed = re.search(r"trained test acc fixed\(a=0.5, b=5.0\): ([0-9.]+)  searched: ([0-9.]+)",
                      out)
    assert fixed and all(0.0 <= float(v) <= 1.0 for v in fixed.groups())
    triple = re.search(r"checkpoint triple: (\S+_v\.pt)", out).group(1)
    assert triple.startswith(str(tmp_path)) and "alpha-beta/0.5-5.0" in triple
    for suffix in ("_v.pt", "_t.pt", "_a.pt"):
        assert os.path.exists(triple.replace("_v.pt", suffix)), suffix
    names, probs = re.search(r"deploy classify: top-k (\[.*\]) probs (\[.*\])", out).groups()
    names, probs = ast.literal_eval(names), ast.literal_eval(probs)
    assert len(names) == len(probs) == 1  # the config's top_k
    assert names[0] in CLASSES and 0.0 < probs[0] <= 1.0


@pytest.fixture()
def clip_ids(monkeypatch):
    """The stand-in tokenizer in both packages, padding at CLIP's EOT id."""
    monkeypatch.setattr(jbanks, "tokenize", synthetic_tokenize)
    monkeypatch.setattr(banks, "tokenize", synthetic_tokenize)
    monkeypatch.setattr(jbpe, "_default_tokenizer", lambda: SimpleNamespace(eot_id=EOT_ID))
    assert banks.EOT_ID == EOT_ID


def test_train_quickstart_matches_jax(tmp_path, clip_ids):
    """The quickstart's data tree and 49408-token checkpoint through both
    packages' ``run()``: the zero-shot sweep, the trained accuracies and the
    searched point agree (accuracies within 1e-6); the two written triples
    (banks and trained adapter) agree within 1e-5, and each, loaded by its
    own package's deployment classifier, gives the same top-1 and
    probabilities within 1e-5."""
    rng = np.random.default_rng(0)
    weights = str(tmp_path / "tiny_clip.pt")
    torch.save(train_quickstart.tiny_clip_state_dict(rng), weights)
    root = str(tmp_path / "DATA")
    split_path = train_quickstart.build_synthetic_dataset(root, rng)
    cfg = Config(**train_quickstart.config_fields(str(tmp_path / "port"), root, weights))
    jcfg = JaxConfig(**train_quickstart.config_fields(str(tmp_path / "jax"), root, weights))

    ours = runner.run(cfg, progress=False, device="cpu")
    ref = jax_run(jcfg)
    assert ours.zero_shot.keys() == ref.zero_shot.keys()
    for key, value in ref.zero_shot.items():
        assert ours.zero_shot[key] == pytest.approx(value, abs=1e-6), key
    assert ours.test_acc_fixed == pytest.approx(ref.test_acc_fixed, abs=1e-6)
    assert ours.test_acc_searched == pytest.approx(ref.test_acc_searched, abs=1e-6)
    assert (ours.searched_alpha, ours.searched_beta) == (ref.searched_alpha, ref.searched_beta)
    assert ours.best_epoch == ref.best_epoch

    paths = [runner.checkpoint_paths(c.cache_dir, c.backbone, c.shots, c.alpha, c.beta, c.lr,
                                     c.augment_epoch, c.train_epoch) for c in (cfg, jcfg)]
    (bank_v, bank_t, state), (jbank_v, jbank_t, jstate) = map(
        lambda p: load_checkpoint_triple(*p), paths)
    np.testing.assert_allclose(bank_v, jbank_v, atol=1e-5, rtol=0)
    np.testing.assert_allclose(bank_t, jbank_t, atol=1e-5, rtol=0)
    assert state.keys() == jstate.keys()
    for key in state:
        np.testing.assert_allclose(state[key], jstate[key], atol=1e-5, rtol=0, err_msg=key)

    crop = np.clip(np.asarray((200, 30, 30), np.uint8)[None, None]
                   + rng.integers(0, 50, (40, 40, 3)), 0, 255).astype(np.uint8)
    classified = []
    for make, c, (path_v, path_t, path_a) in (
            (lambda c, **kw: ProtoClipClassifier(c, device="cpu", **kw), cfg, paths[0]),
            (JaxClassifier, jcfg, paths[1])):
        clf = make(c, splits_path=split_path, memory_bank_v_path=path_v,
                   memory_bank_t_path=path_t, adapter_weights_path=path_a, max_batch=4)
        classified.append(clf.classify_objects([crop]))
    (names, probs), (jnames, jprobs) = classified
    assert names == jnames and names[0][0] in CLASSES
    np.testing.assert_allclose(probs, jprobs, atol=1e-5, rtol=0)


def test_serving_quickstart_rows_equal_a_direct_encode(tmp_path):
    """The served rows equal the port's direct encode of the bundle (the
    quickstart checks that itself, to 0.0) and JAX's bf16 encode of the
    quickstart's weights file at the bf16 bars."""
    out = run_example("serving_quickstart", tmp_path, timeout=300)
    assert "encoded 3 images -> 32-d features" in out
    assert "served rows vs a direct encode: max |diff| = 0.0" in out
    assert "server exit code: 0" in out
    rows = re.search(r"served rows -> (\S+)", out).group(1)
    served = np.load(rows)
    first = ast.literal_eval(re.search(r"first row starts (\[.*\])", out).group(1))
    np.testing.assert_allclose(first, served[0, :4], atol=5e-5, rtol=0)

    jcfg, jparams = jax_load_clip("tiny", os.path.join(os.path.dirname(rows), "tiny_clip.pt"),
                                  dtype=jnp.bfloat16)
    block = np.stack([jax_clip_preprocess(Image.fromarray(c), serving_quickstart.N_PX)
                      for c in serving_quickstart.demo_crops()])
    want = np.asarray(jax_make_encode_fn(jcfg)(jparams, jnp.asarray(block)))
    assert served.shape == want.shape == (3, 32)
    _bars(served, want, BF16_BARS)


@pytest.mark.parametrize("name", ["train_quickstart", "serving_quickstart"])
def test_quickstarts_default_to_the_card(name):
    """Without ``--device`` a quickstart runs on the card, and raises where
    CUDA is absent before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default would run on it")
    module = {"train_quickstart": train_quickstart, "serving_quickstart": serving_quickstart}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module[name].main([])
