"""CLIP-compatible BPE tokenizer (pure Python, no framework)."""

from protoclip_tpu_torch.tokenizer.bpe import (
    EOT_ID,
    SOT_ID,
    ClipTokenizer,
    default_vocab_path,
    tokenize,
)

__all__ = ["EOT_ID", "SOT_ID", "ClipTokenizer", "default_vocab_path", "tokenize"]
