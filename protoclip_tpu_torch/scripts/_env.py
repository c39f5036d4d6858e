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
