"""Shared environment defaults for the port's validator scripts (the
port's copy of ``scripts/_env.py``).

The package only discovers the BPE vocab via ``$PROTOCLIP_BPE_PATH`` or
``~/.cache/clip/`` (it never hardcodes machine paths).  The validators
also look in ``reference/`` at the checkout's root: a user who has the
reference implementation's snapshot (the upstream Proto-CLIP repository,
whose ``clip/`` folder holds CLIP's ``bpe_simple_vocab_16e6.txt.gz``)
unpacks or links it there, and the textual-bank phase then works out of
the box.  Nothing creates ``reference/``, and ``.gitignore`` keeps it out
of commits.
"""

from __future__ import annotations

import os

_REF_VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "reference", "clip", "bpe_simple_vocab_16e6.txt.gz")


def ensure_bpe_vocab() -> None:
    """Point $PROTOCLIP_BPE_PATH at the reference snapshot's vocab when the
    caller hasn't configured one and the snapshot is there."""
    if "PROTOCLIP_BPE_PATH" not in os.environ and os.path.exists(_REF_VOCAB):
        os.environ["PROTOCLIP_BPE_PATH"] = _REF_VOCAB


SOT_ID, EOT_ID = 49406, 49407


def synthetic_tokenize(prompts, context_length=77):
    """Stands in for the BPE tokenizer, whose vocab file is not in the
    repository: SOT, one deterministic id per word, EOT."""
    import numpy as np

    out = np.zeros((len(prompts), context_length), np.int32)
    for i, prompt in enumerate(prompts):
        ids = [sum(ord(ch) * 31 ** k for k, ch in enumerate(w)) % 49000 + 1 for w in prompt.split()]
        row = [SOT_ID] + ids + [EOT_ID]
        out[i, :len(row)] = row
    return out
