"""The Mamba-2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` (K6),
its wrapper and its plain twin.

The JAX package has no state-space layer; this serves the Granite 4.0-H
head (``models/granite_hybrid.py``).  For a CUDA tensor :func:`ssd_scan`
launches K6 (four launches: ``C B^T`` of each chunk, the chunks' own
states, the state pass between chunks, the output) or raises; for a CPU
tensor it runs :func:`ssd_scan_ref`, the same chunked closed form in plain
PyTorch.  It counts its calls in ``.launches``, and each call that
launched K6 adds 1 to the counter ``ssd_layers`` (the twin adds nothing).

The scan, per batch row and head, from a zero state::

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t h_t + D x_t

with ``x`` ``[b, L, H, P]``, ``dt`` ``[b, L, H]`` (after the softplus and
its bias), ``A`` and ``D`` ``[H]``, ``B`` and ``C`` ``[b, L, G, N]``, head
``h`` reading group ``h // (H // G)``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from playaid_core_torch import profiling
from playaid_core_torch.ops import _build

CHUNK = 256       # positions a chunk (the published mamba_chunk_size)
HEAD_DIM = 64     # P, what K6 takes
STATE_DIM = 128   # N, what K6 takes
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
             + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(x, dt, A, B, C, D):
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"x must be [b, L, H, P] and B, C [b, L, G, N], got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, length, heads, _ = x.shape
    groups = B.shape[2]
    if (tuple(dt.shape) != (b, length, heads) or tuple(B.shape[:2]) != (b, length)
            or tuple(A.shape) != (heads,) or tuple(D.shape) != (heads,)
            or heads % groups):
        raise ValueError(f"dt must be [b, L, H], A and D [H] and the groups divide the heads; "
                         f"got x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, D {tuple(D.shape)}")


def _chunks(t, chunk):
    """``[b, L, ...]`` -> ``[b, L / chunk, chunk, ...]``, zeros appended to a
    whole chunk (a zero ``dt`` and ``x`` change no state)."""
    pad = -t.shape[1] % chunk
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, chunk, *t.shape[2:])


def _chunk_states(x, dt, acs, B):
    """Each chunk's own state ``[b, nc, H, P, N]``: ``sum_s exp(acs[last] -
    acs[s]) dt[s] x[s] B[s]^T``."""
    w = torch.exp(acs[:, :, -1:] - acs) * dt              # [b, nc, Q, H]
    return torch.einsum("bcsh,bcshp,bcshn->bchpn", w, x, B)


def _state_pass(states, acs):
    """The state entering each chunk, ``[b, nc, H, P, N]``: 0 for the first,
    then ``exp(acs_c[last]) S_in[c] + S_c``."""
    decay = torch.exp(acs[:, :, -1])                       # [b, nc, H]
    s_in = torch.zeros_like(states[:, 0])
    out = []
    for c in range(states.shape[1]):
        out.append(s_in)
        s_in = decay[:, c, :, None, None] * s_in + states[:, c]
    return torch.stack(out, dim=1)


def ssd_scan_ref(x, dt, A, B, C, D, chunk=CHUNK):
    """``y`` ``[b, L, H, P]`` of the scan (module docstring) in the chunked
    closed form that K6 computes, in plain PyTorch: within a chunk the
    masked ``(C B^T) exp(acs[l] - acs[s])`` product with ``dt x``; across
    chunks each chunk's state, the state pass, and ``exp(acs) C S_in``; then
    ``D x``.  ``acs`` is the running sum of ``dt A`` inside each chunk.  Any
    length: a short last chunk is padded with zeros."""
    _check(x, dt, A, B, C, D)
    length, heads = x.shape[1], x.shape[2]
    rep = heads // B.shape[2]
    xc, dtc = _chunks(x, chunk), _chunks(dt, chunk)        # [b, nc, Q, H, P], [b, nc, Q, H]
    Bc = _chunks(B, chunk).repeat_interleave(rep, dim=3)  # [b, nc, Q, H, N]
    Cc = _chunks(C, chunk).repeat_interleave(rep, dim=3)
    acs = torch.cumsum(dtc * A, dim=2)                     # [b, nc, Q, H]
    q = torch.arange(chunk, device=x.device)
    causal = q[:, None] >= q[None, :]                      # [l, s]
    a = acs.transpose(2, 3)                                # [b, nc, H, Q]
    diff = torch.where(causal, a[..., :, None] - a[..., None, :], float("-inf"))
    m = torch.einsum("bclhn,bcshn->bchls", Cc, Bc) * torch.exp(diff)
    y = torch.einsum("bchls,bcshp->bclhp", m, xc * dtc[..., None])
    s_in = _state_pass(_chunk_states(xc, dtc, acs, Bc), acs)
    y = y + torch.einsum("bclhn,bchpn->bclhp", Cc, s_in) * torch.exp(acs)[..., None]
    y = y.reshape(x.shape[0], -1, heads, x.shape[3])[:, :length]
    return y + D[:, None] * x


def _library():
    fn = _build.load("ssd_scan").ssd_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _rows(t):
    """``t`` ``[b, L, ...]`` as the kernel reads it: the heads or groups of a
    row contiguous, and one stride between the rows of ``[b, L]`` (a copy
    where not); and that stride."""
    inner = t.stride(-1) == 1 and (t.dim() == 3 or t.stride(2) == t.shape[3])
    rows = t.shape[0] == 1 or t.stride(0) == t.shape[1] * t.stride(1)
    if not (inner and rows):
        t = t.contiguous()
    return t, t.stride(1)


def ssd_scan(x, dt, A, B, C, D, chunk=CHUNK):
    """``y`` ``[b, L, H, P]`` float32 of the scan; see the module docstring
    and :func:`ssd_scan_ref`.  On the card K6 runs it at ``chunk`` 256,
    ``P`` 64 and ``N`` 128, a length rounded up to whole chunks with zeros;
    views of row-major tensors (the mixer's split of its row-major ``xBC``)
    are read in place, other layouts copied first."""
    _check(x, dt, A, B, C, D)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, D, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on the CPU or a CUDA device, not {x.device}")
    b, length, heads, p = x.shape
    groups, n = B.shape[2], B.shape[3]
    if chunk != CHUNK or p != HEAD_DIM or n != STATE_DIM:
        raise ValueError(f"K6 takes chunk {CHUNK}, head size {HEAD_DIM} and state size "
                         f"{STATE_DIM}; got {chunk}, {p}, {n}")
    if any(t.dtype != torch.float32 for t in (x, dt, A, B, C, D)):
        raise TypeError("K6 takes float32 inputs")
    pad = -length % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    full = length + pad
    x, x_row = _rows(x)
    dt, dt_row = _rows(dt)
    B, bc_row = _rows(B)
    C, c_row = _rows(C)
    if c_row != bc_row:  # one row stride for both
        (B, bc_row), (C, c_row) = _rows(B.contiguous()), _rows(C.contiguous())
    A, D = A.contiguous(), D.contiguous()
    nc = full // chunk
    dev = x.device
    y = torch.empty((b, full, heads, p), dtype=torch.float32, device=dev)
    acs = torch.empty((b, heads, nc, chunk), dtype=torch.float32, device=dev)
    cbt = torch.empty((b, groups, nc, chunk, chunk), dtype=torch.float32, device=dev)
    states = torch.empty((b, nc, heads, n, p), dtype=torch.float32, device=dev)
    status = _library()(x.data_ptr(), x_row, dt.data_ptr(), dt_row, A.data_ptr(), B.data_ptr(),
                        C.data_ptr(), bc_row, D.data_ptr(), y.data_ptr(), acs.data_ptr(),
                        cbt.data_ptr(), states.data_ptr(), b, full, heads, groups,
                        _build.current_stream(dev))
    _build.check(status, "ssd_scan launch")
    _build.count_launch(ssd_scan)
    profiling.count("ssd_layers", 1)
    return y[:, :length]


ssd_scan.launches = 0
