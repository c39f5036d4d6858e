#!/usr/bin/env bash
# Reproduce all 13 Proto-CLIP benchmark operating points (reference protocol:
# K=16 shots, tuned alpha/beta/adapter per configs/*.yml).
#
# Prerequisites: CLIP weights in $PROTOCLIP_WEIGHTS_DIR, datasets under
# $DATA_ROOT in the CoOp layout, BPE vocab via $PROTOCLIP_BPE_PATH.
set -euo pipefail
DATA_ROOT="${DATA_ROOT:-DATA}"
MESH="${MESH:-0}"   # e.g. MESH=8 to shard batches over 8 chips
DEVICE="${DEVICE:-cuda}"   # the torch device (cpu: the kernels' plain versions)

for ds in caltech101 dtd eurosat fgvc food101 oxford_flowers oxford_pets \
          stanford_cars sun397 ucf101 fewsol; do
    python -m protoclip_tpu_torch.cli.main --config "configs/${ds}.yml" \
        --dataset "${ds}" --root_path "${DATA_ROOT}" --mesh "${MESH}" --device "${DEVICE}"
done

# ImageNet (class-folder layout) and the FewSOL-198 deploy point (test-only,
# pretrained checkpoint in the cache tree or pretrained_ckpt/)
python -m protoclip_tpu_torch.cli.main --config configs/imagenet.yml \
    --dataset imagenet --root_path "${DATA_ROOT}" --mesh "${MESH}" --device "${DEVICE}"
python -m protoclip_tpu_torch.cli.main --config configs/fewsol_198.yml \
    --dataset fewsol_198 --root_path "${DATA_ROOT}" --only_test --device "${DEVICE}"
