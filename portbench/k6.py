"""K6 (``csrc/ssd_scan.cu``): the Mamba-2 SSD chunked scan of the Granite
hybrid family, its work from shapes, and the readers of ``k6_roofline``
and ``ssm_device_ms_per_vod``.

The port runs every Mamba-2 layer's scan on K6 on the card (four launches,
each kernel named ``ssd_scan_*``) and counts the layers that did
(``ssd_layers``) and the rows each head call ran (``positions``) on its
``playaid.head`` span.  Work is counted as ``roofline.py`` counts it: a
multiply-add is two operations, once, and each byte the scan reads or
writes at its interface is counted once (its own scratch, the chunks'
``C B^T`` and states, is not).
"""

from __future__ import annotations

import bisect

from portbench import program_spans, roofline

K6 = "ssd_scan_"


def mamba_layers(config):
    """The configuration's Mamba-2 layers; 0 for a family without them."""
    return sum(kind == "mamba" for kind in config.get("layer_types", ()))


def ssd_flops_per_row(config):
    """The SSD's operations a row (one position of one sequence) in one
    Mamba-2 layer, in the paper's chunked form at the configuration's chunk
    Q: the causal half of the chunk's ``C B^T`` (``N G (Q + 1)``: row l
    needs its l + 1 products, Q + 1 over 2 on average) and of its product
    with ``dt x`` (``H P (Q + 1)``), the row's share of its chunk's state
    (``2 H P N``), the output from the incoming state (``2 H P N``), the
    state pass (``2 H P N`` a chunk, over its Q rows) and the D skip
    (``2 H P``)."""
    c = config
    q, n, g = c["mamba_chunk_size"], c["mamba_d_state"], c["mamba_n_groups"]
    h, p = c["mamba_n_heads"], c["mamba_d_head"]
    return n * g * (q + 1) + h * p * (q + 1) + 4 * h * p * n + 2 * h * p * n / q + 2 * h * p


def ssd_counts(positions, config):
    """``(flops, bytes)`` of one layer's scan over ``positions`` rows: read
    ``x`` (H P), ``dt`` (H), ``B`` and ``C`` (G N each) a row, ``A`` and
    ``D``; write ``y`` (H P) a row; float32."""
    c = config
    h, p = c["mamba_n_heads"], c["mamba_d_head"]
    gn = c["mamba_n_groups"] * c["mamba_d_state"]
    nbytes = (positions * (2 * h * p + h + 2 * gn) + 2 * h) * roofline.F32
    return positions * ssd_flops_per_row(c), nbytes


def k6_roofline(ctx):
    """The least time of every traced head call's scans (``ssd_layers``
    layers at its ``positions``) over the device time of the ``ssd_scan_*``
    kernels in the traced window, percent.  None unless every
    ``playaid.head`` span counts the family's Mamba-2 layers in
    ``ssd_layers``, one span a finished VOD, so that a change to what K6
    runs silences the metric instead of misreading it."""
    layers = mamba_layers(ctx.config)
    positions = program_spans.counts_by_span(ctx, "playaid.head", "positions")
    ssd = program_spans.counts_by_span(ctx, "playaid.head", "ssd_layers")
    vods = sum(r.ok for r in ctx.traced)
    if not layers or not positions or ssd != [layers] * len(positions) or len(ssd) != vods:
        return None
    us = sum(ctx.trace.kernels(K6))
    if not us:
        return None
    least = sum(layers * roofline.least_s(*ssd_counts(n, ctx.config)) for n in positions)
    return 100.0 * least / (us / 1e6)


def span_kernel_us(ctx, name):
    """Device us of the kernels launched inside all spans ``name`` of the
    trace (a launch and its kernel share a correlation id); None without
    such spans or where they launched nothing."""
    spans = program_spans.spans(ctx, name)
    if not spans:
        return None
    starts = [ts for ts, _ in spans]
    total = 0.0
    for _, cat, _, dur, _, corr in ctx.trace.device:
        t = ctx.trace.launched.get(corr)
        if cat != "kernel" or t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= starts[i] + spans[i][1]:
            total += dur
    return total or None


def ssm_device_ms_per_vod(ctx):
    """Device ms of the kernels launched inside the port's ``playaid.ssm``
    spans (each Mamba-2 mixer, ``in_proj`` to ``out_proj``), over the
    traced VODs."""
    us = span_kernel_us(ctx, "playaid.ssm")
    vods = sum(r.ok for r in ctx.traced)
    return us / 1e3 / vods if us and vods else None
