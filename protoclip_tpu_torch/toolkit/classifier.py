"""Deployment classifier: crops -> CLIP features -> Proto-CLIP top-k
(counterpart of ``protoclip_tpu/toolkit/classifier.py``).

Equivalent of the reference's ``ProtoClipClassifier``
(``toolkit/.../proto_clip_classifier.py:24-158``): loads a CLIP backbone and
a trained ``_v/_t/_a`` checkpoint triple, builds prototypes once, and
classifies batches of RGB crops into top-k class names using the splits-file
id->classname mapping.  Prediction-canvas rendering and ``.npy`` logging are
kept for demo parity.

The infer path (normalize -> encode -> adapter -> P -> top-k) runs on the
classifier's device (default: the card) under ``torch.inference_mode``; on
the card every layer of a ViT image tower is the fused block K2 (K3 under
``$PROTOCLIP_INT8``).  Crops are resized and center-cropped on the host to
the backbone's resolution: the RGB uint8 arrays of a call by one native
call spread over the host's cores (``native.resize_shorter_center_crop_
batch``), any other crop, or one the native path declines, by
``clip_preprocess`` (PIL), with the same pixels.  Each call is zero-padded
to a batch bucket: the buckets keep the JAX API and its row-independence
contract, and are the fixed shapes a captured serving path can reuse.

Spans (``obs.profiler``): ``classify`` around ``classify_objects``, with
``classify.preprocess`` (rows: crops) and inside it
``classify.preprocess.native`` (rows: the crops the native batch call
served); ``infer.issue`` (rows: the bucket)
from the pad to the bucket until the last launch of the top-k returns, and
``infer.readback`` (rows: valid rows), the copies to the host, where the
host waits for the card.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from protoclip_tpu_torch import native
from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.core.protoclip import from_arrays
from protoclip_tpu_torch.data.transforms import clip_preprocess, normalize_batch
from protoclip_tpu_torch.device import DeviceLike, resolve_device
from protoclip_tpu_torch.io.checkpoint import checkpoint_paths, load_checkpoint_triple
from protoclip_tpu_torch.models import adapter_from_torch_state, encode_image, load_clip
from protoclip_tpu_torch.obs.profiler import span
from protoclip_tpu_torch.ops.proto import l2_normalize


def top_k(p: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, in descending order, with ties
    in ascending index order, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties) -> (values, int32 ids)."""
    values, ids = torch.sort(p, dim=-1, descending=True, stable=True)
    return values[:, :k], ids[:, :k].to(torch.int32)


class ProtoClipClassifier:
    """Few-shot object classifier over a trained Proto-CLIP checkpoint."""

    def __init__(
        self,
        cfg: Config,
        splits_path: Optional[str] = None,
        memory_bank_v_path: Optional[str] = None,
        memory_bank_t_path: Optional[str] = None,
        adapter_weights_path: Optional[str] = None,
        class_id_mapping: Optional[Dict[int, str]] = None,
        max_batch: int = 16,
        batch_buckets: Optional[Sequence[int]] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        # infer pads each call to the smallest bucket that fits, so a small
        # crop batch does not pay max_batch compute and every call runs one
        # of a few fixed shapes
        buckets = sorted({int(b) for b in (batch_buckets or ())} | {self.max_batch})
        if buckets[0] < 1 or buckets[-1] != self.max_batch:
            raise ValueError(
                f"batch_buckets must lie in [1, max_batch={max_batch}], got {buckets}"
            )
        self.batch_buckets = buckets
        self._dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.clip_cfg, self._clip_params = load_clip(
            cfg.backbone, cfg.weights_path, dtype=self._dtype, device=self.device
        )

        if class_id_mapping is not None:
            self.class_id_mapping = dict(class_id_mapping)
        elif splits_path is not None:
            self.class_id_mapping = self._parse_splits_file(splits_path)
        else:
            raise ValueError("provide splits_path or class_id_mapping")

        if memory_bank_v_path is None and memory_bank_t_path is None:
            # derive from the config-addressed cache tree (model_utils.py:12-28)
            memory_bank_v_path, memory_bank_t_path, adapter_weights_path = checkpoint_paths(
                cfg.cache_dir, cfg.backbone, cfg.shots, cfg.alpha, cfg.beta,
                cfg.lr, cfg.augment_epoch, cfg.train_epoch,
            )
        bank_v, bank_t, adapter_state = load_checkpoint_triple(
            memory_bank_v_path, memory_bank_t_path, adapter_weights_path
        )
        self.model = from_arrays(
            bank_v,
            bank_t,
            adapter_from_torch_state(adapter_state, cfg.adapter) if adapter_state else {},
            cfg.adapter,
            cfg.shots,
            device=self.device,
        )

    @staticmethod
    def _parse_splits_file(path: str) -> Dict[int, str]:
        """label id -> classname from a CoOp split JSON (train rows)."""
        with open(path) as fh:
            data = json.load(fh)
        return {int(row[1]): row[2] for row in data["train"]}

    # The infer path reads self._clip_params and self.model at every call,
    # so replacing either (a model swap) takes effect on the next call.

    @torch.inference_mode()
    def _encode(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (B, n_px, n_px, 3) on the device -> L2-normalized fp32
        image features (B, d)."""
        return self._features(normalize_batch(images_u8, self._dtype))

    @torch.inference_mode()
    def _features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images -> L2-normalized fp32 image features."""
        return l2_normalize(encode_image(self._clip_params, images, self.clip_cfg).float())

    @torch.inference_mode()
    def _top_k(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image features -> (top-k probabilities, top-k class ids)."""
        p = self.model.probs(feats, self.cfg.alpha, self.cfg.beta)
        return top_k(p, max(1, self.cfg.top_k))

    def _infer(self, images_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._top_k(self._encode(images_u8))

    def _preprocess_crops(self, crops: Sequence[np.ndarray]) -> np.ndarray:
        from PIL import Image

        n_px = self.clip_cfg.image_resolution
        # no truncation here: classify_objects raises for n > max_batch and
        # infer_canvases re-validates — a silent slice would misalign rows
        # with the caller's crop list
        with span("classify.preprocess", rows=len(crops)):
            out = np.zeros((len(crops), n_px, n_px, 3), np.uint8)
            rgb = [i for i, crop in enumerate(crops)
                   if isinstance(crop, np.ndarray) and crop.dtype == np.uint8
                   and crop.ndim == 3 and crop.shape[2] == 3]
            served = np.zeros(len(crops), bool)
            if rgb and native.load() is not None:
                with span("classify.preprocess.native") as sp:
                    block = out if len(rgb) == len(crops) else np.empty(
                        (len(rgb), n_px, n_px, 3), np.uint8)
                    status = native.resize_shorter_center_crop_batch(
                        [crops[i] for i in rgb], n_px, n_px, block)
                    ok = status == 0
                    served[rgb] = ok
                    if block is not out:
                        out[served] = block[ok]
                    sp.rows = int(ok.sum())
            for i in np.flatnonzero(~served):
                out[i] = clip_preprocess(Image.fromarray(np.asarray(crops[i])), n_px)
        return out

    def infer_canvases(self, canvases_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Device dispatch on already-preprocessed canvases (resize-shorter
        + center-crop, the reference CLIP preprocess): (n, n_px, n_px, 3)
        uint8, 1 <= n <= max_batch -> (top-k probs, top-k class ids), both
        (n, top_k).  The call is zero-padded to the smallest bucket
        (``batch_buckets``) that fits.  Rows are independent (the
        preprocess is per-crop), so callers may batch crops from unrelated
        requests."""
        canvases_u8 = np.asarray(canvases_u8)
        n = len(canvases_u8)
        if not 1 <= n <= self.max_batch:
            raise ValueError(
                f"expected 1..{self.max_batch} canvases, got {n}"
            )
        bucket = next(b for b in self.batch_buckets if b >= n)
        with span("infer.issue", rows=bucket):
            if n != bucket:
                block = np.zeros((bucket,) + canvases_u8.shape[1:], canvases_u8.dtype)
                block[:n] = canvases_u8
                canvases_u8 = block
            probs, idxs = self._infer(torch.from_numpy(canvases_u8).to(self.device))
        with span("infer.readback", rows=n):
            probs, idxs = probs.cpu().numpy(), idxs.cpu().numpy()
        return probs[:n], idxs[:n]

    def names_for_ids(self, idxs: np.ndarray) -> List[List[str]]:
        """Top-k id rows -> display classnames (splits-file mapping,
        underscores as spaces — ref ``proto_clip_classifier.py:120-128``)."""
        return [
            [self.class_id_mapping.get(int(i), str(int(i))).replace("_", " ") for i in row]
            for row in idxs
        ]

    def classify_objects(
        self,
        cropped_images: Sequence[np.ndarray],
        log: bool = False,
        rgb_image: Optional[np.ndarray] = None,
        log_dir: str = "./ros-demo-logs",
    ) -> Tuple[List[List[str]], np.ndarray]:
        """Crops -> (top-k class names per crop, top-k probabilities)."""
        n = len(cropped_images)
        if n == 0:
            return [], np.zeros((0, self.cfg.top_k), np.float32)
        if n > self.max_batch:
            raise ValueError(f"at most {self.max_batch} crops per call (got {n})")
        with span("classify", rows=n):
            batch = self._preprocess_crops(cropped_images)
            probs, idxs = self.infer_canvases(batch)
            names = self.names_for_ids(idxs)
        if log:
            os.makedirs(log_dir, exist_ok=True)
            np.save(
                os.path.join(log_dir, f"experiment_pred_{int(time.time())}.npy"),
                {
                    "rgb_image": rgb_image,
                    "cropped_images": list(cropped_images),
                    "top_k_classes": names,
                    "top_k_probs": probs,
                },
            )
        return names, probs

    def draw_image_with_top_k_images(
        self,
        image_list: Sequence[np.ndarray],
        top_k_classes: List[List[str]],
        top_k_probs: np.ndarray,
        ground_truth_classes: Optional[List[str]] = None,
    ):
        """Render the 2-column prediction canvas
        (ref ``proto_clip_classifier.py:82-129``)."""
        from PIL import Image, ImageDraw

        rows = (len(image_list) + 1) // 2
        img = Image.new("RGB", (650, max(325, 40 + rows * 160)), (255, 255, 255))
        draw = ImageDraw.Draw(img)
        percent = np.asarray(top_k_probs) * 100.0
        texts = []
        for i, crop in enumerate(image_list):
            x, y = 40 + (i % 2) * 300, 40 + (i // 2) * 160
            img.paste(Image.fromarray(np.asarray(crop)).resize((100, 100)), box=(x, y))
            lines = [
                f"{j + 1}. {top_k_classes[i][j]} ({percent[i][j]:.2f}%)"
                for j in range(len(top_k_classes[i]))
            ]
            gt = ground_truth_classes[i] if ground_truth_classes else None
            if gt is not None and gt not in top_k_classes[i]:
                draw.multiline_text((x + 110, y - 20), f"True class: {gt}", fill="green")
            for j, line in enumerate(lines):
                bold = gt is not None and top_k_classes[i][j] == gt
                draw.multiline_text(
                    (x + 110, y + j * 20), line, fill="blue" if bold else "black"
                )
            texts.append("\n".join(lines))
        return img, texts
