"""Device selection for the port, and its float32 matmul policy.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and without CUDA that raises instead of
carrying on on the CPU.

Importing this module (the package imports it) turns TF32 off for float32
matrix products and for cuDNN convolutions, so float32 runs in full float32
on the card as it does on the CPU.  PyTorch's default keeps matmuls in fp32
but lets cuDNN convolutions round their operands to TF32 (~3 decimal
digits).  It also keeps cuBLAS's bf16 products accumulating in fp32 through
any split-K reduction, as the JAX package's products accumulate: by default
cuBLAS may reduce split-K partials in bf16, and its choice of algorithm
depends on the number of rows, so a row's features would depend on the
batch it came in.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the card; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
