"""Peaks of one NVIDIA H100 80GB HBM3 (SXM), from NVIDIA's data sheet,
dense rates without sparsity, at its full 700 W power limit.  A card set
below 700 W runs slower under load: each run logs the card's power limit
beside its numbers, and a share of a peak is against these values.

Float32 work is divided by the TF32 tensor-core rate: it is the fastest
rate at which the card multiplies float32 inputs, so no implementation
that passes the correctness check can read over 100% against it.
"""

PEAK_TF32_FLOPS = 495e12     # FLOP/s, float32 inputs on the tensor cores
PEAK_HBM_BYTES = 3.35e12     # bytes/s
