"""File IO of the port: checkpoint triples, torch and reference-pickle
readers, the MAT reader and writer, and the canonical serving encode
(:func:`make_encode_fn`).  The exported bundles come with the serving
slice."""

from protoclip_tpu_torch.io.checkpoint import (
    checkpoint_paths,
    load_checkpoint_triple,
    load_pkl,
    load_pt,
    save_checkpoint_triple,
)
from protoclip_tpu_torch.io.export import make_encode_fn
from protoclip_tpu_torch.io.mat import load_mat, save_mat

__all__ = [
    "checkpoint_paths",
    "load_checkpoint_triple",
    "load_mat",
    "load_pkl",
    "load_pt",
    "make_encode_fn",
    "save_checkpoint_triple",
    "save_mat",
]
