"""The Proto-CLIP-F-Q^T trainer: live CLIP-encoded queries each step
(counterpart of ``protoclip_tpu/train/qt.py``).

Reference (``main.qt.py:184-260``): every batch of the shuffled, augmented
few-shot train loader is encoded by the *frozen* CLIP image tower under
``no_grad``, passed through the adapter and scored against the prototypes
of the trainable banks; one AdamW step per batch.  This is the trainer whose
hot loop crosses the CLIP encoder: on the card every step runs K2 (or K3
under ``$PROTOCLIP_INT8``) on each layer of the image tower.  The encode
has no backward and needs none: the CLIP parameters are outside the
optimizer.

With a ``mesh`` (``parallel.make_mesh``) the frozen encode, the only large
part of the step, shards the global batch over the mesh; the gathered
(B, d) features then go through the adapter, ``P``, the loss and AdamW on
the mesh's first device, the same on every process
(``parallel.shard_qt_step``): the loss of the whole global batch, as JAX's
sharded step computes it, with no gradient all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.data.transforms import normalize_batch
from protoclip_tpu_torch.device import DeviceLike
from protoclip_tpu_torch.models.clip import CLIPConfig, encode_image
from protoclip_tpu_torch.parallel import Mesh, process_device, replicated, shard_qt_step
from protoclip_tpu_torch.train.episodic import BankTrainer
from protoclip_tpu_torch.train.optim import set_lr


@dataclasses.dataclass
class QTTrainer(BankTrainer):
    """Q^T trainer; feed batches through :meth:`train_step`.

    ``clip_params`` must lie on ``device`` (with a ``mesh``: on its first
    device, which then holds the state; ``device`` may be left unset);
    ``compute_dtype`` is the pixel normalization's dtype, the one the bank
    and eval encodes use, so a query feature matches the cached feature of
    the same image.  ``adapter_init`` as in
    :class:`~protoclip_tpu_torch.train.episodic.EpisodicTrainer`.
    """

    clip_params: Dict
    clip_cfg: CLIPConfig
    bank_v_init: np.ndarray  # (N*K, d)
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
    compute_dtype: str = "bfloat16"
    device: DeviceLike = None
    adapter_init: Optional[Dict] = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.device = process_device(self.device, self.mesh)
        self._init_state(self.bank_v_init, self.bank_t_init)
        self._norm_dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        self._mesh_step = None
        if self.mesh is None:
            self._weights = self.clip_params
        else:
            # the weights copied to the mesh's devices once, not per step
            self._weights = replicated(self.mesh).put(self.clip_params)
            self._mesh_step = shard_qt_step(self.step_on_features, self._encode_batch,
                                            self.mesh)

    def _encode_batch(self, clip_params, images_u8: torch.Tensor) -> torch.Tensor:
        return encode_image(clip_params, normalize_batch(images_u8, self._norm_dtype),
                            self.clip_cfg)

    def encode(self, images_u8: np.ndarray) -> torch.Tensor:
        """The frozen tower's fp32 features of a uint8 (B, H, W, 3) batch
        (with a mesh: the global batch, sharded, gathered back)."""
        images_u8 = np.ascontiguousarray(images_u8)
        if self._mesh_step is not None:
            return self._mesh_step.encode(self._weights, images_u8)
        with torch.no_grad():
            return self._encode_batch(self._weights,
                                      torch.from_numpy(images_u8).to(self.device)).float()

    def train_step(self, images_u8: np.ndarray, labels: np.ndarray, n_valid: int) -> Dict[str, float]:
        """One step on a (possibly padded) batch: rows past ``n_valid`` carry
        weight 0.  Returns the loss, ``acc`` over the valid rows, the
        learning rate and each loss term.  With a mesh the batch is the
        global batch, the same on every process, its size a multiple of the
        mesh."""
        if self._mesh_step is not None:
            return self._mesh_step(self._weights, np.ascontiguousarray(images_u8), labels,
                                   n_valid)
        return self.step_on_features(self.encode(images_u8), labels, n_valid)

    def step_on_features(self, zq_frozen: torch.Tensor, labels: np.ndarray,
                         n_valid: int) -> Dict[str, float]:
        """:meth:`train_step` after the encode, on the batch's frozen fp32
        features (B, d) on ``device``."""
        lr = self._lr()
        set_lr(self.optimizer, lr)
        labels_t = torch.from_numpy(np.asarray(labels, np.int64)).to(self.device)
        weights = (torch.arange(len(labels_t), device=self.device) < n_valid).float()
        terms, matches = self._step(zq_frozen, labels_t, weights)
        out = {"loss": float(terms.pop("total")), "acc": float(matches) / max(float(n_valid), 1.0),
               "lr": lr}
        out.update({term: float(value) for term, value in terms.items()})
        return out

    def finish_epoch(self) -> None:
        self.epoch += 1
