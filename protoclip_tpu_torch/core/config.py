"""Config system: YAML + programmatic overrides, with validation (a copy of
``protoclip_tpu/core/config.py``; PyYAML is imported only by
:func:`load_config`, so the package imports without it).

The reference merges a flat YAML dict with argparse flags and injects derived
keys at runtime (``main.py:52-71,480-489``) with no schema; here the config is
a typed dataclass so typos fail loudly.  Field names and defaults mirror
``configs/master.yml`` and the per-dataset files.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

_ALLOWED_ADAPTERS = ("fc", "conv-2x", "conv-3x")
_ALLOWED_LOSSES = ("L1", "L2", "L3", "L4")

# Tip-Adapter (alpha, beta) hyper-parameter search geometry per dataset —
# the reference injects these into every run's cfg (``main.py:74-102,111``)
# and then deliberately never reads them: its own comment at ``main.py:141``
# says "tip-a search_scale is not helpful for proto-clip", and the test-phase
# re-search uses hardcoded ranges instead (``main.py:407-434``).  Carried
# for cfg-dict compatibility (a tool reading a dumped config sees the same
# keys) and for anyone layering Tip-Adapter-style search on top.
TIP_ADAPTER_SEARCH = {
    "caltech101": ([12, 5], [200, 20]),
    "dtd": ([13, 13], [200, 20]),
    "eurosat": ([12, 10], [200, 20]),
    "fgvc": ([30, 30], [200, 20]),
    "food101": ([10, 10], [200, 20]),
    "imagenet": ([7, 3], [200, 20]),
    "oxford_flowers": ([50, 50], [200, 20]),
    "oxford_pets": ([7, 3], [200, 20]),
    "stanford_cars": ([20, 10], [200, 20]),
    "sun397": ([12, 10], [200, 20]),
    "ucf101": ([7, 3], [200, 20]),
    "fewsol": ([13, 13], [200, 20]),
}


def search_scale_step(dataset: str):
    """``(search_scale, search_step)`` for ``dataset`` — ``(None, None)``
    when unlisted, exactly like the reference's ``dict.get`` fallback
    (``main.py:99``).  ``fewsol_198`` maps to the ``fewsol`` row (it is our
    alias; the reference runs both splits as dataset ``fewsol``)."""
    name = "fewsol" if dataset == "fewsol_198" else dataset
    return TIP_ADAPTER_SEARCH.get(name, (None, None))


@dataclasses.dataclass
class Config:
    """One Proto-CLIP operating point (ref ``configs/*.yml``)."""

    dataset: str = ""
    root_path: str = "DATA"
    shots: int = 16
    backbone: str = "RN50"
    lr: float = 1e-4
    augment_epoch: int = 10
    train_epoch: int = 2000
    losses: List[str] = dataclasses.field(default_factory=lambda: ["L1", "L2", "L3"])
    alpha: float = 0.5
    beta: float = 1.0
    adapter: str = "fc"
    train_vis_mem_only: bool = False
    only_test: bool = False
    top_k: int = 1
    logs_dir_path: str = "logs"
    cache_root: str = "./caches"
    seed: int = 1
    # knobs of this framework (no reference equivalent)
    batch_size: int = 1024  # eval/encode batch size (main.py:505)
    compute_dtype: str = "bfloat16"
    weights_path: Optional[str] = None
    # preemption recovery (train/resume.py; the reference has none):
    # snapshot the FULL trainer state (params + optimizer + epoch) every N
    # epochs, and resume from the snapshot when one exists.  The episodic
    # trainer derives episode RNG from (seed, epoch), so a resumed run is
    # replay-exact vs an uninterrupted one.
    snapshot_every: int = 0  # epochs; 0 = off
    resume: bool = False
    # Tip-Adapter search geometry, derived from `dataset` in __post_init__
    # so EVERY construction path carries it (the reference injects at run
    # time for every cfg, main.py:111); vestigial in the reference too —
    # see TIP_ADAPTER_SEARCH above.  Not settable from YAML/CLI (and any
    # constructor value is overwritten), matching the reference where
    # search_scale_step() clobbers incoming values.
    search_scale: Optional[List[int]] = dataclasses.field(default=None)
    search_step: Optional[List[int]] = dataclasses.field(default=None)

    def __post_init__(self):
        self.search_scale, self.search_step = search_scale_step(self.dataset)

    @property
    def cache_dir(self) -> str:
        # fewsol_198 is OUR alias for the 198-class split selection; the
        # reference runs it as dataset 'fewsol' (the reference's
        # configs/fewsol_198.yml sets dataset: 'fewsol'), so its cache/checkpoint
        # tree lives under caches/fewsol — map the alias there for artifact
        # interop (the reference's 52- and 198-class runs share that tree
        # too, disambiguated by backbone/shots in the stems).
        name = "fewsol" if self.dataset == "fewsol_198" else self.dataset
        return os.path.join(self.cache_root, name)

    def validate(self) -> "Config":
        if self.adapter not in _ALLOWED_ADAPTERS:
            raise ValueError(f"adapter must be one of {_ALLOWED_ADAPTERS}, got {self.adapter!r}")
        for loss in self.losses:
            if loss not in _ALLOWED_LOSSES:
                raise ValueError(f"unknown loss {loss!r}; allowed {_ALLOWED_LOSSES}")
        if self.shots < 1:
            raise ValueError("shots must be >= 1")
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        if self.beta <= 0:
            raise ValueError("beta must be > 0")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype must be 'bfloat16' or 'float32', got "
                f"{self.compute_dtype!r} (typos would silently fall back)"
            )
        if self.snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0 (0 disables snapshots)")
        if self.top_k < 1:
            raise ValueError("top_k must be >= 1")
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_config(path: Optional[str] = None, **overrides) -> Config:
    """Load a YAML config and apply keyword overrides (CLI flags).

    Unknown YAML keys are ignored with a warning (the reference carries a few
    vestigial keys like ``search_scale``).
    """
    data = {}
    if path is not None:
        import yaml

        with open(path, "r") as fh:
            data = yaml.safe_load(fh) or {}
    merged = {}
    valid_fields = {f.name for f in dataclasses.fields(Config)}
    # derived at load time from `dataset`, never from YAML/CLI (the
    # reference's search_scale_step() likewise overwrites incoming values)
    valid_fields -= {"search_scale", "search_step"}
    for key, value in data.items():
        if key in valid_fields:
            merged[key] = value
        else:
            # lenient for YAML only: the reference carries vestigial keys
            print(f"[protoclip_tpu_torch] ignoring unknown config key {key!r}", file=sys.stderr)
    for key, value in overrides.items():
        if value is None:
            continue
        if key not in valid_fields:
            # programmatic/CLI overrides are deliberate: a typo here must
            # fail loudly, not silently keep the YAML value
            raise TypeError(f"unknown config override {key!r}")
        merged[key] = value
    cfg = Config(**merged)
    return cfg.validate()
