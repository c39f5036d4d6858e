"""Dataset record types and the few-shot sampler (a copy of
``protoclip_tpu/data/types.py``).

Behavioral contract from the reference (``datasets/utils.py:71-285``):

- ``Datum`` = (impath, label, domain, classname).
- ``FewShotDataset`` exposes train/val/test item lists, ``classnames`` ordered
  by label, ``num_classes``, and the per-dataset prompt ``template``.
- Few-shot sampling picks K items per class without replacement, falling back
  to sampling with replacement when a class has fewer than K items.
"""

from __future__ import annotations

import dataclasses
import random as _random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Datum:
    impath: str
    label: int
    classname: str = ""
    domain: int = -1


class FewShotDataset:
    """Container for a few-shot classification benchmark."""

    def __init__(
        self,
        train_x: Sequence[Datum],
        val: Sequence[Datum],
        test: Sequence[Datum],
        template: Sequence[str],
        name: str = "",
    ):
        self.train_x = list(train_x)
        self.val = list(val)
        self.test = list(test)
        self.template = list(template)
        self.name = name
        self._lab2cname = self._build_lab2cname(self.train_x)

    @staticmethod
    def _build_lab2cname(items: Sequence[Datum]) -> Dict[int, str]:
        mapping: Dict[int, str] = {}
        for item in items:
            mapping.setdefault(item.label, item.classname)
        return mapping

    @property
    def num_classes(self) -> int:
        return max(self._lab2cname) + 1 if self._lab2cname else 0

    @property
    def lab2cname(self) -> Dict[int, str]:
        return dict(self._lab2cname)

    @property
    def classnames(self) -> List[str]:
        return [self._lab2cname[label] for label in sorted(self._lab2cname)]


def split_by_label(items: Sequence[Datum]) -> Dict[int, List[Datum]]:
    out: Dict[int, List[Datum]] = defaultdict(list)
    for item in items:
        out[item.label].append(item)
    return out


def generate_fewshot(
    items: Sequence[Datum],
    num_shots: int,
    seed: Optional[int] = None,
    repeat: bool = True,
) -> List[Datum]:
    """Per-class K-shot subsample (ref ``datasets/utils.py:215-257``).

    Uses ``random.sample`` semantics (without replacement) and
    ``random.choices`` (with replacement) when a class is smaller than K.
    Classes are visited in first-appearance order, like the reference's
    insertion-ordered dict.
    """
    if num_shots < 1:
        return list(items)
    rng = _random.Random(seed) if seed is not None else _random
    out: List[Datum] = []
    for _label, group in split_by_label(items).items():
        if len(group) >= num_shots:
            out.extend(rng.sample(group, num_shots))
        elif repeat:
            out.extend(rng.choices(group, k=num_shots))
        else:
            out.extend(group)
    return out
