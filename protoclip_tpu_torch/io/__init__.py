"""File IO of the port: checkpoint triples, torch and reference-pickle
readers, the MAT reader and writer, the checksum-verified downloader, the canonical serving encode
(:func:`make_encode_fn`) and the serving bundle (one CUDA graph per batch
bucket on the card)."""

from protoclip_tpu_torch.io.checkpoint import (
    checkpoint_paths,
    load_checkpoint_triple,
    load_pkl,
    load_pt,
    save_checkpoint_triple,
)
from protoclip_tpu_torch.io.download import (
    download_and_extract,
    download_weights,
    extract_archive,
)
from protoclip_tpu_torch.io.export import (
    load_serving_bundle,
    make_encode_fn,
    save_serving_bundle,
)
from protoclip_tpu_torch.io.mat import load_mat, save_mat

__all__ = [
    "checkpoint_paths",
    "download_and_extract",
    "download_weights",
    "extract_archive",
    "load_checkpoint_triple",
    "load_mat",
    "load_pkl",
    "load_pt",
    "load_serving_bundle",
    "make_encode_fn",
    "save_checkpoint_triple",
    "save_mat",
    "save_serving_bundle",
]
