"""The port's main path as a whole against the JAX package, on the CPU.

Zero-shot Proto-CLIP on TINY_VIT with class-coloured uint8 images (as
tests/test_e2e.py builds them) and a fake tokenizer (as
tests/test_eval_memory.py does; the BPE vocab is not in the repository):
visual bank (2 augment passes), textual bank (with EOT-padded batches),
cached val/test features, prototypes, the 11 x 29 alpha/beta sweep, the
best operating point and the accuracy.  Both packages get the same images
and the same weights.
"""

import numpy as np
import pytest
import torch

import jax

import protoclip_tpu.memory.banks as jbanks
import protoclip_tpu.tokenizer.bpe as jbpe
from protoclip_tpu.core import protoclip as jcore
from protoclip_tpu.data.loader import ArrayLoader as JaxArrayLoader
from protoclip_tpu.data.transforms import normalize_batch as jax_normalize_batch
from protoclip_tpu.eval import gridsearch as jgrid
from protoclip_tpu.eval import metrics as jmetrics
from protoclip_tpu.models import clip as jclip

import protoclip_tpu_torch.memory.banks as banks
from protoclip_tpu_torch.core import protoclip as core
from protoclip_tpu_torch.data import ArrayLoader, normalize_batch
from protoclip_tpu_torch.eval import gridsearch, metrics
from protoclip_tpu_torch.models import clip
from tests.test_models import TINY_VIT

N_CLASS, SHOTS, N_EVAL, AUGMENT = 4, 2, 3, 2
CLASSNAMES = ["red_thing", "green thing", "blue_thing", "grey_thing"]
TEMPLATES = ["a photo of a {}.", "art of the {}.", "a {} in the wild."]
COLORS = [(200, 30, 30), (30, 200, 30), (30, 30, 200), (120, 120, 120)]
EOT = TINY_VIT.vocab_size - 1  # the tiny vocab's EOT: its largest id


def coloured_images(rng, per_class):
    images, labels = [], []
    for c, colour in enumerate(COLORS):
        for _ in range(per_class):
            noise = rng.integers(0, 50, (32, 32, 3))
            images.append(np.clip(np.asarray(colour)[None, None] + noise, 0, 255))
            labels.append(c)
    return np.asarray(images, np.uint8), np.asarray(labels, np.int64)


def fake_tokenize(prompts, context_length=77):
    """SOT, one id per word (< EOT), EOT; ids fit the tiny vocab."""
    out = np.zeros((len(prompts), TINY_VIT.context_length), np.int32)
    for i, p in enumerate(prompts):
        words = p.split()
        out[i, 0] = EOT - 1
        out[i, 1:1 + len(words)] = [sum(map(ord, w)) % (EOT - 2) + 1 for w in words]
        out[i, 1 + len(words)] = EOT
    return out


class _FakeVocab:
    eot_id = EOT


@pytest.fixture(scope="module")
def both():
    """Everything the main path produces, from both packages."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbanks, "tokenize", fake_tokenize)
    mp.setattr(banks, "tokenize", fake_tokenize)
    # pad rows take the EOT id: the tiny vocab's on both sides
    mp.setattr(jbpe, "_default_tokenizer", lambda: _FakeVocab())
    mp.setattr(banks, "EOT_ID", EOT)
    try:
        yield _run_both()
    finally:
        mp.undo()


def _run_both():
    rng = np.random.default_rng(0)
    train_x, train_y = coloured_images(rng, SHOTS)
    val_x, val_y = coloured_images(rng, N_EVAL)
    test_x, test_y = coloured_images(rng, N_EVAL)

    jparams = jclip.init_clip_params(jax.random.PRNGKey(0), TINY_VIT)
    cfg = clip.CLIPConfig(**{f: getattr(TINY_VIT, f) for f in TINY_VIT.__dataclass_fields__})
    params = clip.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")

    j_img = jax.jit(lambda u8: jclip.encode_image(jparams, jax_normalize_batch(u8), TINY_VIT))
    j_txt = jax.jit(lambda t: jclip.encode_text(jparams, t, TINY_VIT))

    @torch.inference_mode()
    def t_img(u8):
        return clip.encode_image(params, normalize_batch(torch.from_numpy(u8)), cfg)

    @torch.inference_mode()
    def t_txt(tokens):
        return clip.encode_text(params, torch.from_numpy(tokens), cfg)

    out = {}
    for name, pkg_banks, pkg_core, pkg_grid, loader_cls, enc_i, enc_t, dev in (
        ("jax", jbanks, jcore, jgrid, JaxArrayLoader, j_img, j_txt, {}),
        ("torch", banks, core, gridsearch, ArrayLoader, t_img, t_txt, {"device": "cpu"}),
    ):
        r = {}
        r["bank_v"], r["values"] = pkg_banks.build_visual_memory_bank(
            enc_i, loader_cls(train_x, train_y, batch_size=3), AUGMENT, progress=False
        )
        r["bank_t"] = pkg_banks.build_textual_memory_bank(
            enc_t, CLASSNAMES, TEMPLATES, batch_size=5
        )
        for split, (x, y) in (("val", (val_x, val_y)), ("test", (test_x, test_y))):
            r[split] = pkg_banks.pre_load_features(
                enc_i, loader_cls(x, y, batch_size=5), split, progress=False
            )
        model = pkg_core.from_arrays(r["bank_v"], r["bank_t"], {}, "fc", SHOTS, **dev)
        img_p, txt_p = model.prototypes()
        r["img_protos"], r["txt_protos"] = np.asarray(img_p), np.asarray(txt_p)
        r["probs"] = np.asarray(model.probs(r["test"][0], 0.5, 5.0))
        alphas, betas = pkg_grid.default_alpha_beta_grid()
        r["grid"] = pkg_grid.alpha_beta_sweep(r["val"][0], r["val"][1], img_p, txt_p, alphas, betas)
        r["best"] = pkg_grid.best_operating_point(r["grid"], alphas, betas)
        r["acc"] = pkg_core.accuracy(model, r["test"][0], r["test"][1], 0.5, 5.0)
        r["acc_best"] = pkg_core.accuracy(model, r["test"][0], r["test"][1], *r["best"][:2])
        labels, conf = pkg_core.predict(model, r["test"][0], 0.5, 5.0)
        r["pred"], r["conf"] = np.asarray(labels), np.asarray(conf)
        out[name] = r
    return out


def test_visual_bank_matches_jax(both):
    j, t = both["jax"], both["torch"]
    assert t["bank_v"].shape == (N_CLASS * SHOTS, TINY_VIT.embed_dim)
    np.testing.assert_allclose(t["bank_v"], j["bank_v"], atol=1e-5)
    np.testing.assert_array_equal(t["values"], j["values"])
    np.testing.assert_allclose(np.linalg.norm(t["bank_v"], axis=-1), 1.0, atol=1e-5)


def test_textual_bank_matches_jax(both):
    j, t = both["jax"], both["torch"]
    assert t["bank_t"].shape == (N_CLASS, TINY_VIT.embed_dim)
    np.testing.assert_allclose(t["bank_t"], j["bank_t"], atol=1e-5)


@pytest.mark.parametrize("split", ["val", "test"])
def test_split_features_match_jax(both, split):
    (jf, jl), (tf, tl) = both["jax"][split], both["torch"][split]
    np.testing.assert_allclose(tf, jf, atol=1e-5)
    np.testing.assert_array_equal(tl, jl)


def test_prototypes_and_probs_match_jax(both):
    j, t = both["jax"], both["torch"]
    np.testing.assert_allclose(t["img_protos"], j["img_protos"], atol=1e-5)
    np.testing.assert_allclose(t["txt_protos"], j["txt_protos"], atol=1e-5)
    np.testing.assert_allclose(t["probs"], j["probs"], atol=1e-5)
    np.testing.assert_allclose(t["probs"].sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(t["pred"], j["pred"])
    np.testing.assert_allclose(t["conf"], j["conf"], atol=1e-5)


def test_sweep_and_accuracy_match_jax_cell_for_cell(both):
    j, t = both["jax"], both["torch"]
    assert t["grid"].shape == (11, 29)
    # equal cell for cell as counts of correct queries; the fp32 means may
    # differ in the last bit (XLA and PyTorch divide by the count apiece)
    n_val = len(t["val"][1])
    np.testing.assert_array_equal(np.rint(t["grid"] * n_val), np.rint(j["grid"] * n_val))
    np.testing.assert_allclose(t["grid"], j["grid"], rtol=0, atol=1e-6)
    assert t["best"][:2] == j["best"][:2]
    assert t["best"][2] == pytest.approx(j["best"][2], abs=1e-6)
    n_test = len(t["test"][1])
    for key in ("acc", "acc_best"):
        assert round(t[key] * n_test) == round(j[key] * n_test), key
    assert t["acc_best"] > 1.0 / N_CLASS  # the coloured classes are told apart


def test_grid_helpers_match_jax(rng):
    alphas, betas = gridsearch.default_alpha_beta_grid()
    j_alphas, j_betas = jgrid.default_alpha_beta_grid()
    np.testing.assert_array_equal(alphas, j_alphas)
    np.testing.assert_array_equal(betas, j_betas)
    acc = rng.random((len(alphas), len(betas))).astype(np.float32)
    acc[3, 7] = acc[5, 2] = 2.0  # a tie: the earliest alpha-major cell wins
    assert gridsearch.best_cell(acc) == jgrid.best_cell(acc) == (3, 7)
    triples = gridsearch.sweep_to_triples(acc, alphas, betas)
    np.testing.assert_array_equal(triples, jgrid.sweep_to_triples(acc, alphas, betas))
    np.testing.assert_array_equal(gridsearch.triples_to_sweep(triples[::-1], alphas, betas), acc)
    with pytest.raises(ValueError):
        gridsearch.triples_to_sweep(triples[:-1], alphas, betas)


def test_top_k_accuracy_matches_jax(rng):
    scores = rng.standard_normal((20, 6)).astype(np.float32)
    scores[0, :2] = 5.0  # a tie at the top-1 boundary
    labels = rng.integers(0, 6, 20)
    for k in (1, 3, 10):
        assert metrics.top_k_accuracy(torch.from_numpy(scores), labels, k) == \
            jmetrics.top_k_accuracy(scores, labels, k)


def test_orient_rows_matches_jax(rng):
    bank = rng.standard_normal((6, 6)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    for mat, n_rows in ((bank, 6), (bank.T, 6), (bank[:4], 4), (bank[:4].T, 4)):
        ours = banks._orient_rows(mat, n_rows)
        np.testing.assert_array_equal(ours, jbanks._orient_rows(mat, n_rows))
        assert ours.shape[0] == n_rows


def test_from_arrays_defaults(rng):
    bank_t = rng.standard_normal((3, 8)).astype(np.float32)
    model = core.from_arrays(None, bank_t, None, "fc", 2, device="cpu")
    assert model.bank_v.shape == (6, 8) and not model.adapter
    q = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    # zero visual bank: uniform visual probabilities
    np.testing.assert_allclose(model.probs(q, 1.0, 5.0).numpy(), 1.0 / 3, atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            core.from_arrays(None, bank_t, None, "fc", 2)
