"""The port's reference encoder (``models/encoder.py``) and the four public
names it lacked (``available_backbones``, ``layers.causal_mask``,
``accuracy_from_probs``, ``models.multi_head_attention``), against the
JAX package's functions on the CPU in fp32 (bars: 1e-6 absolute where the
sums run in another order, exact where nothing is summed).

JAX draws its dropout mask with ``jax.random.bernoulli``; the port draws it
from a ``torch.Generator``.  To compare the two quirks with dropout on,
JAX's draw is patched to return the port's mask for the same shape."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import protoclip_tpu.models as jmodels
from protoclip_tpu.eval.metrics import accuracy_from_probs as jax_accuracy_from_probs
from protoclip_tpu.models import encoder as jenc
from protoclip_tpu.models.clip import available_backbones as jax_available_backbones
from protoclip_tpu.models.layers import causal_mask as jax_causal_mask

import protoclip_tpu_torch.models as models
from protoclip_tpu_torch.eval.metrics import accuracy_from_probs
from protoclip_tpu_torch.models import encoder as enc
from protoclip_tpu_torch.models.clip import available_backbones
from protoclip_tpu_torch.models.layers import causal_mask

V, D, HEADS, B, L = 20, 16, 4, 2, 5


def _both_inits(seed=1):
    emb = np.random.default_rng(0).standard_normal((V, D)).astype(np.float32)
    return (jenc.init_encoder(np.random.default_rng(seed), emb, HEADS),
            enc.init_encoder(np.random.default_rng(seed), emb, HEADS))


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def test_init_encoder_draws_as_jax():
    jparams, params = _both_inits()
    ours = dict(_leaves(params))
    for name, value in _leaves(jparams):
        np.testing.assert_array_equal(ours[name], value, err_msg=name)
    with pytest.raises(ValueError, match="not divisible by heads"):
        enc.init_encoder(np.random.default_rng(0), np.zeros((3, 6), np.float32), 4)


def test_encoder_from_torch_state_matches_jax():
    rng = np.random.default_rng(2)
    state = {"enc.embed.embed.weight": rng.standard_normal((V, D)).astype(np.float32)}
    for name in ("q_linear", "k_linear", "v_linear", "out"):
        state[f"enc.attn.{name}.weight"] = rng.standard_normal((D, D)).astype(np.float32)
        state[f"enc.attn.{name}.bias"] = rng.standard_normal(D).astype(np.float32)
    ours = dict(_leaves(enc.encoder_from_torch_state(
        {k: torch.from_numpy(v) for k, v in state.items()}, prefix="enc.")))
    for name, value in _leaves(jenc.encoder_from_torch_state(state, prefix="enc.")):
        np.testing.assert_array_equal(ours[name], value, err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["raw-scores", "mask-softmax"])
def test_encoder_apply_matches_jax_both_quirks(masked):
    """Without a mask the raw scaled scores mix the values (no softmax);
    with one, masked positions get -1e9 and a softmax; dropout off."""
    jparams, params = _both_inits()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, V, (B, L))
    mask = (rng.random((B, L, L)) > 0.3).astype(np.float32) if masked else None
    want = np.asarray(jenc.encoder_apply(jparams, tokens, HEADS,
                                         None if mask is None else jnp.asarray(mask)))
    got = enc.encoder_apply(params, tokens, HEADS,
                            None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if not masked:  # raw scores: rows are not convex mixtures of the values
        x = np.asarray(params["embed"])[tokens]
        assert np.abs(got).max() > np.abs(x @ np.asarray(params["v"]["w"])).max()


@pytest.mark.parametrize("masked", [False, True], ids=["raw-scores", "mask-softmax"])
def test_encoder_dropout_on_the_scores_matches_jax(monkeypatch, masked):
    """Dropout on the (post-softmax or raw) score matrix, kept entries
    scaled by 1 / (1 - rate): the same mask gives JAX's result."""
    jparams, params = _both_inits()
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, V, (B, L))
    mask = (rng.random((B, L, L)) > 0.3).astype(np.float32) if masked else None
    rate, seed = 0.25, 11
    keep = torch.rand((B, HEADS, L, L), generator=torch.Generator().manual_seed(seed)) < 1 - rate
    monkeypatch.setattr(jenc.jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep.numpy()))
    want = np.asarray(jenc.encoder_apply(jparams, tokens, HEADS,
                                         None if mask is None else jnp.asarray(mask),
                                         dropout_rate=rate, dropout_rng=jax.random.PRNGKey(0)))
    got = enc.encoder_apply(params, tokens, HEADS,
                            None if mask is None else torch.from_numpy(mask), dropout_rate=rate,
                            dropout_rng=torch.Generator().manual_seed(seed)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    off = enc.encoder_apply(params, tokens, HEADS,
                            None if mask is None else torch.from_numpy(mask)).numpy()
    assert not np.allclose(got, off)


def test_public_names_match_jax():
    assert available_backbones() == jax_available_backbones()
    assert models.available_backbones is available_backbones
    for length in (1, 5, 77):
        want = np.asarray(jax_causal_mask(length))
        got = causal_mask(length)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want)
    probs = np.random.default_rng(5).random((13, 7)).astype(np.float32)
    labels = np.random.default_rng(6).integers(0, 7, 13)
    assert accuracy_from_probs(probs, labels) == jax_accuracy_from_probs(probs, labels)
    assert accuracy_from_probs(torch.from_numpy(probs), torch.from_numpy(labels)) == \
        jax_accuracy_from_probs(probs, labels)
    # models' multi_head_attention is the reference encoder's, as JAX's is
    assert models.multi_head_attention is enc.multi_head_attention
    assert jmodels.multi_head_attention is jenc.multi_head_attention
    for name in ("init_encoder", "encoder_apply", "encoder_from_torch_state"):
        assert getattr(models, name) is getattr(enc, name)
