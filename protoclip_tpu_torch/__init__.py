"""Proto-CLIP on PyTorch and CUDA: the port of ``protoclip_tpu`` to an
NVIDIA H100.

Mirrors the JAX package's layout (``ops``, ``models``, ``memory``,
``core``, ``eval``, ``data``, ``io``, ``obs``, ``train``, ``cli``,
``tokenizer``).  The fused
transformer block, in bf16 and in the W8A8 serving mode
(``$PROTOCLIP_INT8``), is a chain of hand-written CUDA kernels
(``csrc/``, bound in ``ops/kernels.py``); everything else is plain PyTorch.
Entry points take an explicit ``device`` and default to the card.

This package imports neither JAX nor ``protoclip_tpu``.
"""

from protoclip_tpu_torch import device as _device  # noqa: F401  (sets the TF32 policy)

__version__ = "0.1.0"
