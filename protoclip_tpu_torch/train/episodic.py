"""The Proto-CLIP-F episodic trainer (counterpart of
``protoclip_tpu/train/episodic.py``).

Reference hot loop (``main.py:222-313``): each epoch chops a class
permutation into random chunks of 20-40% of the classes.  For each chunk
("episode") every chunk class's K support slots are split at random into
support and query; the *frozen* cached features of the query slots pass
through the adapter, and one AdamW step minimizes L1+L2+L3 against
prototypes built from the *trainable* banks (all N classes, all K slots,
``main.py:260-264``; the queries are the frozen keys, ``main.py:267``).

The sampler runs on the host in numpy, copied from the JAX package, and its
generator is seeded ``seed + epoch * 65537``: both packages train on the
same episodes, and a resumed run samples what an uninterrupted one would.
Each epoch's episodes are fixed-size buffers of ``Q`` query rows with 0/1
weights (the same loss as the reference's variable-length query sets);
trailing episodes that the sampler left empty (``valid == 0``) are skipped,
so they step neither the parameters nor AdamW's count.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.core.protoclip import ProtoClip
from protoclip_tpu_torch.device import DeviceLike, resolve_device
from protoclip_tpu_torch.models.adapters import apply_adapter, init_adapter
from protoclip_tpu_torch.ops.losses import protoclip_loss
from protoclip_tpu_torch.ops.proto import class_prototypes, l2_normalize, proto_probs
from protoclip_tpu_torch.train.optim import cosine_lr, make_optimizer, set_lr


def episode_bounds(n_class: int) -> Tuple[int, int]:
    """Class-chunk size bounds (ref ``main.py:218-220``)."""
    upper = max(int(n_class * 0.4), 2)
    lower = max(int(n_class * 0.2), 1)
    return lower, upper


def max_episodes(n_class: int) -> int:
    lower, _ = episode_bounds(n_class)
    return int(np.ceil(max(n_class - 1, 1) / lower))


def max_queries(n_class: int, k_shots: int) -> int:
    """Fixed per-episode query-buffer size: the largest possible episode
    (``upper`` classes, ``K-1`` queries each; K queries when K == 1)."""
    _, upper = episode_bounds(n_class)
    return upper * (k_shots - 1 if k_shots > 1 else 1)


def _sample_epoch(rng: np.random.Generator, n_class: int, k_shots: int):
    """One epoch of reference-style episodes as (class, slot) index lists.

    Mirrors the reference sampler (``main.py:235-258``): a class permutation
    chunked by ``randint(lower, upper)`` sizes over positions ``[0, N-1)``
    (the final permutation position never participates — reference quirk);
    per chunk class, ``n = randint(1, K)`` support slots, the remaining
    ``K - n`` are queries (all K slots when K == 1).
    """
    lower, upper = episode_bounds(n_class)
    episodes = []
    perm = rng.permutation(n_class)
    start = 0
    while start < n_class - 1:
        num = int(rng.integers(lower, upper)) if upper > lower else lower
        chunk = perm[start : min(start + num, n_class - 1)]
        if len(chunk) == 0:
            break
        queries = []  # (class, slot)
        for cls in chunk:
            if k_shots > 1:
                n_support = int(rng.integers(1, k_shots))
                slots = rng.permutation(k_shots)
                queries.extend((int(cls), int(s)) for s in slots[n_support:])
            else:
                queries.append((int(cls), 0))
        episodes.append(queries)
        start += len(chunk)
    return episodes


def make_episode_masks(
    rng: np.random.Generator, n_class: int, k_shots: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense-mask view of one epoch of episodes (used by tests/analysis).

    Returns ``class_mask (E, N)``, ``query_mask (E, N, K)``, ``valid (E,)``
    with E = :func:`max_episodes` (trailing episodes zero-padded).
    """
    E = max_episodes(n_class)
    class_mask = np.zeros((E, n_class), np.float32)
    query_mask = np.zeros((E, n_class, k_shots), np.float32)
    valid = np.zeros((E,), np.float32)
    for e, queries in enumerate(_sample_epoch(rng, n_class, k_shots)[:E]):
        for cls, slot in queries:
            class_mask[e, cls] = 1.0
            query_mask[e, cls, slot] = 1.0
        valid[e] = 1.0
    return class_mask, query_mask, valid


def make_episode_queries(
    rng: np.random.Generator, n_class: int, k_shots: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Gather-form episodes: fixed-size query index buffers.

    Returns ``query_idx (E, Q)`` (row indices into the (N*K) bank),
    ``query_labels (E, Q)``, ``query_w (E, Q)`` (1 for real queries, 0 for
    padding), ``valid (E,)``; Q = :func:`max_queries`.  The trainer runs the
    adapter/classifier only on these rows instead of the full N*K block —
    identical math (padded rows carry zero loss weight), ~2.5x less episode
    compute at the reference's 20-40% class-sampling rate.
    """
    E = max_episodes(n_class)
    Q = max_queries(n_class, k_shots)
    query_idx = np.zeros((E, Q), np.int32)
    query_labels = np.zeros((E, Q), np.int32)
    query_w = np.zeros((E, Q), np.float32)
    valid = np.zeros((E,), np.float32)
    for e, queries in enumerate(_sample_epoch(rng, n_class, k_shots)[:E]):
        for j, (cls, slot) in enumerate(queries[:Q]):
            query_idx[e, j] = cls * k_shots + slot
            query_labels[e, j] = cls
            query_w[e, j] = 1.0
        valid[e] = 1.0
    return query_idx, query_labels, query_w, valid


# -- the state both trainers share ----------------------------------------------------


def named_leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``("adapter/ln1/scale", tensor)`` pairs of a nested parameter dict."""
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from named_leaves(value, name + "/")
        else:
            yield name, value


def _tensor(x, device: torch.device) -> torch.Tensor:
    """An fp32 copy of an array or tensor on ``device``: the optimizer
    updates the leaves in place, and must not write into the caller's
    arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(x, np.float32), device=device)


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms for the conv adapters' backward on
    the card, so that a run resumed from a snapshot repeats an uninterrupted
    one bit for bit.  Set for the step only: the ResNet towers' forward
    convs keep cuDNN's free choice."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


class BankTrainer:
    """The trainable state of both trainers: the visual bank, the adapter,
    the textual bank unless ``train_vis_mem_only``, and AdamW over them.

    Subclasses are dataclasses with ``adapter_kind``, ``n_class``,
    ``k_shots``, ``alpha``, ``beta``, ``lr``, ``train_epoch``, ``losses``,
    ``train_vis_mem_only``, ``seed``, ``device`` and ``adapter_init``."""

    def _init_state(self, bank_v, bank_t) -> None:
        self.device = resolve_device(self.device)
        dev = self.device
        adapter = self.adapter_init
        if adapter is None:
            adapter = init_adapter(torch.Generator().manual_seed(self.seed), bank_v.shape[1],
                                   self.adapter_kind)

        def leaf(x):
            return _tensor(x, dev).requires_grad_(True)

        def leaves(tree):
            return {k: leaves(v) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}

        self.params: Dict = {"bank_v": leaf(bank_v), "adapter": leaves(adapter)}
        if not self.train_vis_mem_only:
            self.params["bank_t"] = leaf(bank_t)
        # bank_t stays out of the optimizer with train_vis_mem_only but is
        # still what the text prototypes are built from
        self._frozen_bank_t = _tensor(bank_t, dev)
        self.optimizer = make_optimizer([p for _, p in named_leaves(self.params)], self.lr)
        self.epoch = 0

    def _lr(self) -> float:
        return cosine_lr(self.lr, self.epoch, self.train_epoch * self.n_class * self.k_shots)

    def _probs(self, params: Dict, frozen_bank_t: torch.Tensor, zq_frozen: torch.Tensor):
        """(P, image prototypes, text prototypes): the adapter of ``params``
        on the frozen query features, against the prototypes of its banks
        (``frozen_bank_t`` where ``params`` holds no textual bank)."""
        img_proto = class_prototypes(params["bank_v"], self.n_class, self.k_shots)
        txt_proto = l2_normalize(params.get("bank_t", frozen_bank_t).float())
        zq = l2_normalize(apply_adapter(params["adapter"], zq_frozen, self.adapter_kind).float())
        return proto_probs(zq, img_proto, txt_proto, self.alpha, self.beta), img_proto, txt_proto

    def _loss(self, zq_frozen: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor):
        """(terms, matches) of one step: the adapter on the frozen query
        features, ``P`` against the prototypes of the trainable banks."""
        p, img_proto, txt_proto = self._probs(self.params, self._frozen_bank_t, zq_frozen)
        terms = protoclip_loss(p, labels, img_proto, txt_proto, self.losses, query_weights=weights)
        matches = ((p.argmax(dim=-1) == labels).float() * weights).sum()
        return terms, matches

    def _step(self, zq_frozen: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor):
        """One AdamW step; returns the detached (terms, matches)."""
        with _deterministic():
            terms, matches = self._loss(zq_frozen, labels, weights)
            self.optimizer.zero_grad(set_to_none=True)
            terms["total"].backward()
        for _, p in named_leaves(self.params):
            # a parameter outside the forward (conv-2x's conv2 and ln2) has
            # a zero gradient in JAX, and optax still decays it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return {k: v.detach() for k, v in terms.items()}, matches.detach()

    def model(self) -> ProtoClip:
        """A copy of the current state as a classifier."""

        def copy(tree):
            return {k: copy(v) if isinstance(v, dict) else v.detach().clone()
                    for k, v in tree.items()}

        bank_t = self.params.get("bank_t", self._frozen_bank_t)
        return ProtoClip(bank_v=self.params["bank_v"].detach().clone(),
                         bank_t=bank_t.detach().clone(), adapter=copy(self.params["adapter"]),
                         adapter_kind=self.adapter_kind, shots=self.k_shots)

    @torch.no_grad()
    def load_model(self, model: ProtoClip) -> None:
        """Restore the trainable parameters from a ProtoClip (e.g. the best
        checkpoint); with ``train_vis_mem_only`` its textual bank becomes
        the frozen one.  AdamW's state is kept, as in the JAX trainer."""
        self.params["bank_v"].copy_(_tensor(model.bank_v, self.device))
        if self.train_vis_mem_only:
            self._frozen_bank_t = _tensor(model.bank_t, self.device)
        else:
            self.params["bank_t"].copy_(_tensor(model.bank_t, self.device))
        source = dict(named_leaves(model.adapter))
        for name, p in named_leaves(self.params["adapter"]):
            p.copy_(_tensor(source[name], self.device))


@dataclasses.dataclass
class EpisodicTrainer(BankTrainer):
    """Owns the training state and runs an epoch of episodes at a time.

    ``alpha``/``beta`` are the fixed operating point used during training
    (``main.py:213-214``), ``train_vis_mem_only`` drops the textual bank from
    the optimizer (``main.py:127-132``), ``losses`` selects L1/L2/L3/L4.
    ``adapter_init`` (adapter parameters) replaces the adapter drawn by
    ``init_adapter`` from a generator seeded ``seed``.
    """

    frozen_keys: np.ndarray  # (N*K, d) cached support features (query source)
    bank_t_init: np.ndarray  # (N, d)
    n_class: int
    k_shots: int
    adapter_kind: str
    alpha: float
    beta: float
    lr: float = 1e-4
    train_epoch: int = 2000
    losses: Tuple[str, ...] = ("L1", "L2", "L3")
    train_vis_mem_only: bool = False
    seed: int = 1
    device: DeviceLike = None
    adapter_init: Optional[Dict] = None

    def __post_init__(self):
        self._init_state(self.frozen_keys, self.bank_t_init)
        self._frozen_keys = _tensor(self.frozen_keys, self.device)

    def run_epoch(self) -> Dict[str, float]:
        """Sample an epoch of episodes on the host and take one AdamW step
        per valid episode.  Returns the loss averaged over the episodes,
        ``acc`` = matches / queries, the learning rate and each loss term."""
        epoch_rng = np.random.default_rng(self.seed + self.epoch * 65537)
        query_idx, query_labels, query_w, valid = make_episode_queries(
            epoch_rng, self.n_class, self.k_shots
        )
        lr = self._lr()
        set_lr(self.optimizer, lr)
        dev = self.device
        live = np.flatnonzero(valid > 0)
        idx = torch.from_numpy(query_idx[live]).to(dev).long()
        labels = torch.from_numpy(query_labels[live]).to(dev).long()
        weights = torch.from_numpy(query_w[live]).to(dev)
        loss_sum = torch.zeros((), device=dev)
        matches_sum = torch.zeros((), device=dev)
        term_sums: Dict[str, torch.Tensor] = {}
        for e in range(len(live)):
            terms, matches = self._step(self._frozen_keys[idx[e]], labels[e], weights[e])
            loss_sum += terms.pop("total")
            matches_sum += matches
            for term, value in terms.items():
                term_sums[term] = term_sums.get(term, 0.0) + value
        self.epoch += 1
        n_ep = max(len(live), 1)
        out = {"loss": float(loss_sum) / n_ep,
               "acc": float(matches_sum) / max(float(query_w[live].sum()), 1.0), "lr": lr}
        out.update({term: float(value) / n_ep for term, value in term_sums.items()})
        return out

