"""Viterbi decode under a Potts prior: the CUDA kernel ``csrc/viterbi.cu``,
its wrapper and its plain version.

Counterpart of ``playaid_core_tpu/infer/pipeline.py``
``BatchedActionPipeline._viterbi_decode``, a ``lax.scan`` that XLA fused
on the TPU.  For a CUDA tensor :func:`viterbi_decode` launches the kernel
(one warp a sequence, every sequence of the batch in one launch; its rows
staged through the TMA, its backpointers in shared memory) or raises; for
a CPU tensor it runs :func:`viterbi_decode_ref`.  It counts its launches
in ``.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from playaid_core_torch.ops import _build

MAX_CLASSES = 1024            # 32 classes a lane of the warp
_SMEM_BYTES = 232448          # what an H100 block can have
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _lengths(true_len, b, device):
    """``true_len`` as an int64 tensor ``[B]`` on ``device``."""
    if isinstance(true_len, torch.Tensor):
        if tuple(true_len.shape) != (b,):
            raise ValueError(f"true_len must be an int or [B] for B={b}, "
                             f"got {tuple(true_len.shape)}")
        return true_len.to(device=device, dtype=torch.int64)
    return torch.full((b,), int(true_len), dtype=torch.int64, device=device)


def viterbi_decode_ref(log_probs, true_len, switch_cost):
    """MAP label paths ``[B, F]`` int64 of log-probs ``[B, F, A]`` under a
    uniform switching penalty of ``switch_cost`` nats (a Potts prior).

    Per sequence this is the JAX function's recursion in the same float32
    operations: ``carry`` starts at row 0; each step switches from the
    first index of the maximum at ``carry[from] - switch_cost`` (the cost
    rounded to float32 once), stays where ``carry >= switch_score``
    (staying wins ties), and adds the row.  Rows at or after
    ``true_len`` (an int, or one per sequence) are zero and frozen: they
    take the last valid row's label.  ``switch_cost=inf`` gives the global
    argmax of the summed evidence.
    """
    b, f, a = log_probs.shape
    dev = log_probs.device
    lens = _lengths(true_len, b, dev)
    valid = torch.arange(f, device=dev)[None, :] < lens[:, None]
    lp = torch.where(valid[..., None], log_probs, 0.0)
    n = torch.clamp(lens, 1, f)
    steps = int(n.max())
    cost = float(np.float32(switch_cost))
    idx = torch.arange(a, device=dev)[None, :]
    carry = lp[:, 0]
    ptrs = []
    for t in range(1, steps):
        switch_from = torch.argmax(carry, dim=1, keepdim=True)
        switch_score = torch.gather(carry, 1, switch_from) - cost
        take_stay = carry >= switch_score
        best = torch.where(take_stay, carry, switch_score)
        live = (t < n)[:, None]
        ptrs.append(torch.where(live & ~take_stay, switch_from, idx))
        carry = torch.where(live, lp[:, t] + best, carry)
    cur = torch.argmax(carry, dim=1, keepdim=True)
    labels = cur.expand(b, f).clone()
    for t in range(steps - 1, 0, -1):
        labels[:, t] = cur[:, 0]
        cur = torch.gather(ptrs[t - 1], 1, cur)
    labels[:, 0] = cur[:, 0]
    return labels


def _library():
    fn = _build.load("viterbi").viterbi_decode
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def scratch_layout(f, a):
    """Where the kernel keeps its rows and backpointers:
    ``(k, rows, cap, spill)``.

    A lane of the warp holds ``k`` = 1, 2, 4, ... 32 classes.  The rows
    arrive ``rows`` at a time (a tile of at most 32 KB) in a ring of two
    tiles in the block's shared memory.  Each group of 32 rows keeps, for
    the steps that produced them (rows 1..F-1), a 32-bit word of stay bits
    a class (``32 k`` words) and the 16-bit index each step switched from;
    the first ``cap`` groups fit the shared memory beside the ring, the
    other ``spill`` go to a scratch buffer in device memory."""
    k = 1
    while 32 * k < a:
        k *= 2
    rows = min(64, 256 // k)
    groups = (f + 31) // 32
    room = _SMEM_BYTES - 2 * (rows * a * 4 + 16) - 16
    cap = min(groups, room // (32 * (4 * k + 2)))
    return k, rows, cap, groups - cap


def launch(fn, log_probs, true_len, switch_cost):
    """Labels ``[B, F]`` of ``fn``, a build of the kernel's C entry point,
    on CUDA float32 log-probs ``[B, F, A]``: the scratch buffer allocated
    here, the launch on the current stream, its status checked."""
    b, f, a = log_probs.shape
    dev = log_probs.device
    lp = log_probs.contiguous()
    if isinstance(true_len, torch.Tensor):
        lens, length = _lengths(true_len, b, dev).to(torch.int32).contiguous(), 0
    else:
        lens, length = None, max(min(int(true_len), f), 0)
    k, _, cap, spill = scratch_layout(f, a)
    spill_words = torch.empty((b, spill, 32 * k), dtype=torch.int32, device=dev) if spill else None
    spill_from = torch.empty((b, spill, 32), dtype=torch.int16, device=dev) if spill else None
    labels = torch.empty((b, f), dtype=torch.int64, device=dev)
    status = fn(
        lp.data_ptr(), None if lens is None else lens.data_ptr(), length, float(switch_cost),
        labels.data_ptr(), None if spill == 0 else spill_words.data_ptr(),
        None if spill == 0 else spill_from.data_ptr(), b, f, a, cap, spill,
        _build.current_stream(dev),
    )
    _build.check(status, "viterbi_decode launch")
    return labels


def viterbi_decode(log_probs, true_len, switch_cost):
    """MAP label paths ``[B, F]`` int64 of float32 log-probs ``[B, F, A]``;
    see :func:`viterbi_decode_ref` for the semantics.  ``true_len`` is an
    int or an int tensor ``[B]``.  On the card every sequence decodes in
    one launch; the backpointers of the steps that do not fit the block's
    shared memory go to a scratch buffer allocated here."""
    if log_probs.dim() != 3 or 0 in log_probs.shape:
        raise ValueError(f"log_probs must be a non-empty [B, F, A], got {tuple(log_probs.shape)}")
    if log_probs.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 log-probs, got {log_probs.dtype}")
    b, f, a = log_probs.shape
    if a > MAX_CLASSES:
        raise ValueError(f"the kernel takes at most {MAX_CLASSES} classes, got {a}")
    if log_probs.device.type == "cpu":
        return viterbi_decode_ref(log_probs, true_len, switch_cost)
    if log_probs.device.type != "cuda":
        raise ValueError(f"log_probs must lie on the CPU or a CUDA device, not {log_probs.device}")
    labels = launch(_library(), log_probs, true_len, switch_cost)
    _build.count_launch(viterbi_decode)
    return labels


viterbi_decode.launches = 0
