"""The port's losses, optimizer, episode sampler, trainers and snapshots
(``protoclip_tpu_torch.ops.losses`` and ``train/``) against the JAX
package's, on the CPU in fp32, from seeded numpy inputs.

Both trainers start from the same adapter: JAX draws it, and the port takes
it through the torch state-dict layout (``adapter_to_torch_state`` ->
``adapter_from_torch_state``) as ``adapter_init``.  Bars: loss values and
gradients 1e-6 relative; trained parameters within 1e-5 of the largest
|parameter| of the trainer, per-epoch loss and acc within 1e-5.  AdamW's
update (eps 1e-4) makes a parameter whose gradient is zero in exact
arithmetic (conv-2x's LayerNorm bias ahead of a LayerNorm over the whole
map) move by rounding noise in both packages, so a bar relative to that
parameter's own size would hold noise to noise.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protoclip_tpu.models.adapters import adapter_to_torch_state as jax_adapter_to_torch
from protoclip_tpu.models.clip import init_clip_params as jax_init_clip_params
from protoclip_tpu.ops import losses as jlosses
from protoclip_tpu.train import episodic as jepisodic
from protoclip_tpu.train.optim import cosine_lr as jax_cosine_lr
from protoclip_tpu.train.qt import QTTrainer as JaxQTTrainer

from protoclip_tpu_torch.models import clip
from protoclip_tpu_torch.models.adapters import adapter_from_torch_state
from protoclip_tpu_torch.ops import losses
from protoclip_tpu_torch.train import episodic
from protoclip_tpu_torch.train.episodic import EpisodicTrainer, named_leaves
from protoclip_tpu_torch.train.optim import cosine_lr
from protoclip_tpu_torch.train.qt import QTTrainer
from protoclip_tpu_torch.train.resume import load_train_state, save_train_state
from tests.test_models import TINY_VIT
from tests.test_torch_models import leaves, np_tree, port_config
from tests.test_train import _separable_problem


def jax_leaves(params):
    return dict(named_leaves(np_tree(params)))


def assert_params_match(port_params, jax_params, rel=1e-5):
    ref = jax_leaves(jax_params)
    ours = {name: t.detach().cpu().numpy() for name, t in named_leaves(port_params)}
    assert ours.keys() == ref.keys()
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for name, value in ref.items():
        err = float(np.abs(ours[name] - value).max()) if value.size else 0.0
        assert err <= rel * scale, f"{name}: max|diff| {err} > {rel} x {scale}"


def carried_adapter(jax_trainer, kind):
    return adapter_from_torch_state(jax_adapter_to_torch(jax_trainer.params["adapter"], kind),
                                    kind)


# -- losses ------------------------------------------------------------------------------


def _loss_inputs(rng, q=12, n=5, d=16, beta=8.0):
    logits = beta * rng.standard_normal((q, n)).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    labels = rng.integers(0, n, q).astype(np.int32)
    weights = (np.arange(q) < q - 3).astype(np.float32)
    # prototypes share a direction, as CLIP features do, so that no
    # InfoNCE term is a cancellation close to 0
    common = rng.standard_normal(d).astype(np.float32)
    img = (common + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    txt = (common + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    return p, labels, weights, img, txt


LOSS_CASES = {
    "nll": lambda m, p, l, w, i, t: m.nll_of_probs(p, l),
    "nll_weighted": lambda m, p, l, w, i, t: m.nll_of_probs(p, l, w),
    "info_nce": lambda m, p, l, w, i, t: m.info_nce(i, t),
    "info_nce_self": lambda m, p, l, w, i, t: m.info_nce(t, t),
    "L1-L3": lambda m, p, l, w, i, t: m.protoclip_loss(p, l, i, t, ("L1", "L2", "L3"), w)["total"],
    "L1-L5": lambda m, p, l, w, i, t: m.protoclip_loss(p, l, i, t, ("L1", "L2", "L3", "L4"),
                                                       w)["total"],
    "L2": lambda m, p, l, w, i, t: m.protoclip_loss(p, l, i, t, ("L2",), w)["total"],
    "none_is_L1": lambda m, p, l, w, i, t: m.protoclip_loss(p, l, i, t, (), w)["total"],
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_losses_and_gradients_match_jax(rng, case):
    p, labels, weights, img, txt = _loss_inputs(rng)
    fn = LOSS_CASES[case]
    ref, ref_grads = jax.value_and_grad(
        lambda a, b, c: fn(jlosses, a, jnp.asarray(labels), jnp.asarray(weights), b, c),
        argnums=(0, 1, 2))(jnp.asarray(p), jnp.asarray(img), jnp.asarray(txt))
    ins = [torch.tensor(x, requires_grad=True) for x in (p, img, txt)]
    out = fn(losses, ins[0], torch.from_numpy(labels), torch.from_numpy(weights), ins[1], ins[2])
    out.backward()
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-6)
    for t, g in zip(ins, ref_grads):
        got = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(np.asarray(g)).max() + 1e-30))


def test_loss_terms_are_keyed_as_jax(rng):
    p, labels, weights, img, txt = _loss_inputs(rng)
    for chosen in [("L1",), ("L1", "L2", "L3"), ("L2", "L4"), ()]:
        ref = jlosses.protoclip_loss(jnp.asarray(p), jnp.asarray(labels), jnp.asarray(img),
                                     jnp.asarray(txt), chosen, jnp.asarray(weights))
        ours = losses.protoclip_loss(torch.from_numpy(p), torch.from_numpy(labels),
                                     torch.from_numpy(img), torch.from_numpy(txt), chosen,
                                     torch.from_numpy(weights))
        assert ours.keys() == ref.keys()
        for key in ref:
            assert float(ours[key]) == pytest.approx(float(ref[key]), rel=1e-6), (chosen, key)


def test_masked_nll_is_nan_safe_at_beta_30(rng):
    """At beta = 30 the probability a padded row picks underflows to 0; its
    weight is 0, so the loss and every gradient stay finite and equal
    JAX's.  The info_nce of an all-zero bank is finite too."""
    q = rng.standard_normal((6, 16)).astype(np.float32)
    protos = rng.standard_normal((4, 16)).astype(np.float32)
    logits = 30.0 * (2.0 * q @ protos.T)
    labels = np.concatenate([logits[:4].argmax(-1), logits[4:].argmin(-1)]).astype(np.int32)
    weights = np.asarray([1, 1, 1, 1, 0, 0], np.float32)

    def jax_loss(qq):
        p = jax.nn.softmax(30.0 * (2.0 * qq @ jnp.asarray(protos).T), -1)
        return jlosses.nll_of_probs(p, jnp.asarray(labels), jnp.asarray(weights))

    q_t = torch.tensor(q, requires_grad=True)
    p = torch.softmax(30.0 * (2.0 * q_t @ torch.from_numpy(protos).T), -1)
    picked = p.detach()[torch.arange(6), torch.from_numpy(labels).long()]
    assert float(picked[4:].max()) == 0.0  # the padded rows underflowed
    out = losses.nll_of_probs(p, torch.from_numpy(labels), torch.from_numpy(weights))
    out.backward()
    ref, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(q))
    assert np.isfinite(float(out.detach())) and bool(torch.isfinite(q_t.grad).all())
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-6)
    np.testing.assert_allclose(q_t.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-6)
    zero = torch.zeros(4, 8, requires_grad=True)
    nce = losses.info_nce(zero, torch.eye(4, 8))
    nce.backward()
    assert np.isfinite(float(nce.detach())) and bool(torch.isfinite(zero.grad).all())


def test_cosine_lr_matches_jax():
    for epoch in (0, 1, 7, 1999, 320000):
        assert cosine_lr(1e-4, epoch, 2000 * 160) == jax_cosine_lr(1e-4, epoch, 2000 * 160)


# -- the sampler -------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(20, 4), (10, 1), (3, 2), (101, 16), (1000, 16)])
def test_episode_sampler_identical_to_jax(n, k):
    assert episodic.episode_bounds(n) == jepisodic.episode_bounds(n)
    assert episodic.max_episodes(n) == jepisodic.max_episodes(n)
    assert episodic.max_queries(n, k) == jepisodic.max_queries(n, k)
    for seed in (0, 1, 1 + 3 * 65537):
        for ours, ref in ((episodic.make_episode_queries(np.random.default_rng(seed), n, k),
                           jepisodic.make_episode_queries(np.random.default_rng(seed), n, k)),
                          (episodic.make_episode_masks(np.random.default_rng(seed), n, k),
                           jepisodic.make_episode_masks(np.random.default_rng(seed), n, k))):
            for a, b in zip(ours, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# -- the episodic trainer ----------------------------------------------------------------


def _trainers(rng, kind, vis_only, n_class=5, **kw):
    keys, bank_t, _ = _separable_problem(rng, N=n_class)
    args = dict(frozen_keys=keys, bank_t_init=bank_t, n_class=n_class, k_shots=4, adapter_kind=kind,
                alpha=0.5, beta=10.0, lr=1e-3, train_epoch=20, seed=0,
                train_vis_mem_only=vis_only, **kw)
    ref = jepisodic.EpisodicTrainer(**args)
    ours = EpisodicTrainer(**args, device="cpu", adapter_init=carried_adapter(ref, kind))
    return ours, ref, keys, bank_t


@pytest.mark.parametrize("vis_only", [False, True], ids=["banks", "vis_mem_only"])
@pytest.mark.parametrize("kind", ["fc", "conv-3x"])
def test_episodic_trainer_matches_jax(rng, kind, vis_only):
    ours, ref, keys, bank_t = _trainers(rng, kind, vis_only, n_class=20)
    assert ("bank_t" in ours.params) == (not vis_only)
    n_steps = 0
    for epoch in range(3):
        valid = jepisodic.make_episode_queries(np.random.default_rng(epoch * 65537), 20, 4)[3]
        n_steps += int(valid.sum())
        got, want = ours.run_epoch(), ref.run_epoch()
        assert got.keys() == want.keys() == {"loss", "acc", "lr", "L1", "L2", "L3"}
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=1e-5), (epoch, key)
    assert ours.epoch == ref.epoch == 3
    assert_params_match(ours.params, ref.params)
    # one AdamW step per valid episode: padded episodes advance no count
    assert n_steps < 3 * jepisodic.max_episodes(20)
    for _, p in named_leaves(ours.params):
        assert float(ours.optimizer.state[p]["step"]) == n_steps
    model = ours.model()
    np.testing.assert_allclose(model.bank_t.numpy(), np.asarray(ref.model().bank_t), atol=1e-5)
    if vis_only:
        np.testing.assert_array_equal(model.bank_t.numpy(), bank_t)
    # the caller's arrays are not trained in place
    assert not np.allclose(model.bank_v.numpy(), keys)


def test_episodic_trainer_conv2x_decays_its_unused_layer_as_jax(rng):
    """conv-2x skips conv2/ln2 in its forward; optax still decays them."""
    ours, ref, _, _ = _trainers(rng, "conv-2x", False, losses=("L1",))
    for _ in range(2):
        got, want = ours.run_epoch(), ref.run_epoch()
        assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)
    assert "L2" not in got and got["loss"] == pytest.approx(got["L1"], rel=1e-6)
    assert_params_match(ours.params, ref.params)
    assert float(ours.params["adapter"]["ln2"]["scale"].detach().max()) < 1.0


def test_load_model_restores_the_trainable_state(rng):
    ours, _, _, bank_t = _trainers(rng, "fc", True)
    ours.run_epoch()
    saved = ours.model()
    ours.run_epoch()
    fresh, _, _, _ = _trainers(np.random.default_rng(0), "fc", True)
    fresh.load_model(saved)
    after = fresh.model()
    for name, value in named_leaves({"bank_v": saved.bank_v, "bank_t": saved.bank_t,
                                     "adapter": saved.adapter}):
        other = dict(named_leaves({"bank_v": after.bank_v, "bank_t": after.bank_t,
                                   "adapter": after.adapter}))[name]
        assert torch.equal(value, other), name


# -- snapshots ---------------------------------------------------------------------------


def test_resume_is_bit_exact_and_mismatches_raise(rng, tmp_path):
    keys, bank_t, _ = _separable_problem(rng)

    def make(**kw):
        args = dict(frozen_keys=keys, bank_t_init=bank_t, n_class=5, k_shots=4,
                    adapter_kind="conv-3x", alpha=0.5, beta=10.0, lr=1e-3, train_epoch=20,
                    seed=0, device="cpu")
        args.update(kw)
        return EpisodicTrainer(**args)

    straight = make()
    for _ in range(4):
        straight.run_epoch()
    half = make()
    for _ in range(2):
        half.run_epoch()
    path = str(tmp_path / "state.pkl")
    save_train_state(path, half, extra={"best_val": 0.5, "best_epoch": 1})
    assert not (tmp_path / "state.pkl.tmp").exists()
    resumed = make()
    assert load_train_state(path, resumed) == (2, {"best_val": 0.5, "best_epoch": 1})
    for _ in range(2):
        resumed.run_epoch()
    for (name, a), (_, b) in zip(named_leaves(straight.params), named_leaves(resumed.params)):
        assert torch.equal(a, b), name
        sa, sb = straight.optimizer.state[a], resumed.optimizer.state[b]
        assert float(sa["step"]) == float(sb["step"]) == 16  # 4 episodes an epoch
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(
            sa["exp_avg_sq"], sb["exp_avg_sq"]), name

    with open(path, "rb") as fh:
        state = pickle.load(fh)
    assert set(state) == {"params", "optimizer", "epoch", "kind", "extra"}
    assert set(state["optimizer"]["adapter/conv1"]) == {"step", "exp_avg", "exp_avg_sq"}

    with pytest.raises(ValueError, match="structure"):  # no bank_t
        load_train_state(path, make(train_vis_mem_only=True))
    with pytest.raises(ValueError, match="structure"):
        load_train_state(path, make(adapter_kind="fc"))
    # a (4, 5) split has the same N*K = 20 rows as the (5, 4) snapshot
    with pytest.raises(ValueError, match="shape"):
        load_train_state(path, make(bank_t_init=bank_t[:4], n_class=4, k_shots=5))
    with pytest.raises(ValueError, match="QTTrainer"):
        state_qt = dict(state, kind="QTTrainer")
        other = str(tmp_path / "qt.pkl")
        with open(other, "wb") as fh:
            pickle.dump(state_qt, fh)
        load_train_state(other, make())
    wrong = dict(state, params={**state["params"],
                                "bank_v": state["params"]["bank_v"].astype(np.float64)})
    with open(str(tmp_path / "f64.pkl"), "wb") as fh:
        pickle.dump(wrong, fh)
    with pytest.raises(ValueError, match="dtype"):
        load_train_state(str(tmp_path / "f64.pkl"), make())


class _Evil:
    def __reduce__(self):
        return (print, ("the snapshot ran code",))


def test_snapshot_is_read_through_the_restricted_unpickler(tmp_path):
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as fh:
        pickle.dump({"kind": "EpisodicTrainer", "params": _Evil()}, fh)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        load_train_state(path, object())


# -- the Q^T trainer ---------------------------------------------------------------------


def test_qt_trainer_matches_jax(rng):
    """Two steps on the tiny ViT, the second a ragged batch (n_valid < B),
    then a finished epoch: the losses, accuracies and parameters as JAX's,
    and the CLIP parameters untouched."""
    jparams = jax_init_clip_params(jax.random.PRNGKey(0), TINY_VIT)
    cfg = port_config(TINY_VIT)
    params = clip.params_from_jax(np_tree(jparams), cfg, device="cpu")
    before = {name: t.clone() for name, t in leaves(params)}
    keys, bank_t, _ = _separable_problem(rng, N=3, K=2, d=TINY_VIT.embed_dim)
    args = dict(bank_v_init=keys, bank_t_init=bank_t, n_class=3, k_shots=2, adapter_kind="fc",
                alpha=0.5, beta=5.0, lr=1e-3, train_epoch=4, seed=0, compute_dtype="float32")
    ref = JaxQTTrainer(clip_params=jparams, clip_cfg=TINY_VIT, **args)
    ours = QTTrainer(clip_params=params, clip_cfg=cfg, **args, device="cpu",
                     adapter_init=carried_adapter(ref, "fc"))
    batches = [(rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
                np.asarray([0, 1, 2, 0, 1, 2], np.int32), 6),
               (rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
                np.asarray([2, 1, 0, 2, 0, 0], np.int32), 4)]
    for images, labels, n_valid in batches:
        zq = ours.encode(images)
        assert zq.dtype == torch.float32 and not zq.requires_grad
        got, want = ours.train_step(images, labels, n_valid), ref.train_step(images, labels, n_valid)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=1e-5), key
    ours.finish_epoch()
    ref.finish_epoch()
    assert ours.epoch == ref.epoch == 1
    assert ours._lr() == pytest.approx(jax_cosine_lr(1e-3, 1, 4 * 3 * 2))
    assert_params_match(ours.params, ref.params)
    for name, t in leaves(params):
        assert torch.equal(t, before[name]) and not t.requires_grad, name
