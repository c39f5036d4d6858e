"""Dataset layer of the port: the 13 few-shot benchmarks behind
``build_dataset``, the CLIP image pipeline (PIL on the host, the
normalization on the tensor's device), the batch loaders and the
reference's binned-uniform query sampler."""

from protoclip_tpu_torch.data.loader import ArrayLoader, BatchLoader
from protoclip_tpu_torch.data.query import iter_query_batches, query_bin_data
from protoclip_tpu_torch.data.registry import available_datasets, build_dataset
from protoclip_tpu_torch.data.transforms import (
    CLIP_MEAN,
    CLIP_STD,
    EvalTransform,
    TrainTransform,
    center_crop,
    clip_preprocess,
    load_image,
    normalize_batch,
    random_train_transform,
    resize_shorter,
)
from protoclip_tpu_torch.data.types import Datum, FewShotDataset

__all__ = [
    "ArrayLoader",
    "BatchLoader",
    "CLIP_MEAN",
    "CLIP_STD",
    "Datum",
    "EvalTransform",
    "FewShotDataset",
    "TrainTransform",
    "available_datasets",
    "build_dataset",
    "center_crop",
    "clip_preprocess",
    "iter_query_batches",
    "load_image",
    "normalize_batch",
    "query_bin_data",
    "random_train_transform",
    "resize_shorter",
]
