"""The plain reference: fp32 PyTorch with TF32 off, and PIL.

It imports nothing of the program (``protoclip_tpu_torch``), nor JAX nor
the JAX package, and works every answer out again from the benchmark's
own state dict and inputs.
"""
