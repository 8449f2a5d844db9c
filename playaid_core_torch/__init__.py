"""PyTorch and CUDA port of playaid_core_tpu.

The JAX package beside this one is the reference the port is held
against.  This package imports torch and numpy and nothing of JAX or of
playaid_core_tpu.  Its entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on the CPU every hand-written kernel is
replaced by its plain PyTorch version.
"""
