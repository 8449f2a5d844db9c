"""Fused identity ResNet BasicBlock: the CUDA kernel
``csrc/residual_block.cu``, its wrapper and its plain version.

Counterpart of ``playaid_core_tpu/ops/pallas_conv_block.py``.  The public
functions keep the JAX layouts: NHWC activations, HWIO weights, folded
batch-norm scale and bias ``[C]`` in float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from playaid_core_torch.ops import _build

_ENTRY = {torch.float32: "residual_block_f32", torch.bfloat16: "residual_block_bf16"}


def residual_block_ref(x, w1, s1, b1, w2, s2, b2):
    """Plain version: conv3x3, scale/bias, ReLU, round to ``x.dtype``,
    conv3x3, scale/bias, ``+ x``, ReLU, in ``x.dtype``.  Convolutions run
    in float32 on float32 copies of the inputs."""
    def conv(inp, w):
        out = F.conv2d(inp.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                       padding=1)
        return out.permute(0, 2, 3, 1)

    y = torch.relu(conv(x, w1) * s1 + b1)
    y = conv(y.to(x.dtype), w2) * s2 + b2
    return torch.relu(y + x.float()).to(x.dtype)


def _library(dtype):
    fn = getattr(_build.load("residual_block"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def residual_block(x, w1, s1, b1, w2, s2, b2):
    """Fused identity BasicBlock at inference.

    x ``[B, H, W, C]`` float32 or bfloat16; w1, w2 ``[3, 3, C, C]`` (cast
    to ``x.dtype``, as the TPU kernel casts them); s1, b1, s2, b2 ``[C]``
    folded batch-norm scale and bias.  Returns ``[B, H, W, C]`` in
    ``x.dtype``.  Any batch size works; on CUDA, C must divide by 16.
    No gradient: inference only.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[3]
    for w in (w1, w2):
        if tuple(w.shape) != (3, 3, c, c):
            raise ValueError(f"weights must be [3, 3, {c}, {c}], got {tuple(w.shape)}")
    for v in (s1, b1, s2, b2):
        if tuple(v.shape) != (c,):
            raise ValueError(f"scale and bias must be [{c}], got {tuple(v.shape)}")
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    if x.device.type == "cpu":
        return residual_block_ref(x, w1, s1, b1, w2, s2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"residual_block runs on CUDA or the CPU, not {x.device}")
    if c % 16:
        raise ValueError(f"the kernel takes channel counts that divide by 16, got {c}")
    x, w1, w2 = x.contiguous(), w1.contiguous(), w2.contiguous()
    s1, b1, s2, b2 = (v.float().contiguous() for v in (s1, b1, s2, b2))
    args = (x, w1, s1, b1, w2, s2, b2)
    if any(t.device != x.device for t in args):
        raise ValueError("all inputs must lie on the same CUDA device")
    mid = torch.empty_like(x)
    out = torch.empty_like(x)
    b, h, w, _ = x.shape
    status = _library(x.dtype)(
        *(t.data_ptr() for t in args), mid.data_ptr(), out.data_ptr(), b, h, w, c,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "residual_block launch")
    residual_block.launches += 1
    return out


residual_block.launches = 0
