#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device slice on one CUDA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

The slice is the device half of the headline configuration (CNN family,
63 classes, the committed weights playaid_core_tpu/assets/bench_cnn63.npz
read as a data file, T=7, delta 3, stride 2, chunk 48) on a synthetic
1080p clip: noise background with two discs on the fighter trajectories.
Video decode is not part of the slice; sampled frames come from pinned
host memory.

Phases (any failure exits non-zero, and no result line is printed):
1. build the CUDA kernels from playaid_core_torch/csrc with nvcc (sm_90a);
2. crop kernel (K1) against its plain version at the main-path shapes and
   on boxes that hang off every frame edge;
3. residual-block kernel (K2) against its plain version on the real
   layer4[1] weights and input, float32 (3xTF32) and bfloat16;
4. the slice, with PyTorch's default TF32 flags (the entry points set
   their own float32 numerics): per chunk upload -> preprocess_frames (K1)
   -> embed_crops (ResNet-18, layer4[1] through K2) -> scatter_embeddings,
   then classify_buffer (argmax and Viterbi) and the stride repeat; launch
   counts; the first 96 frames again on the CPU with the plain versions;
5. timings of each kernel: call time (CUDA events over back-to-back calls)
   and device time (torch.profiler, the kernels' own time over the same
   kind of window), its plain version and one library call that computes
   the same function, with the least time the card could take.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "playaid_core_tpu", "assets", "bench_cnn63.npz")

HEIGHT, WIDTH = 1080, 1920
NUM_FRAMES, CHUNK, STRIDE = 480, 48, 2
CROP, PADDING, BOX_PX, DISC_RADIUS = 128, 30, 260, 90
CPU_FRAMES = 96
SWITCH_COST = 16.0

# H100 SXM data-sheet peaks at 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12   # CUDA cores: K2's yardstick before the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

K1_TOL = 1e-5             # max abs, outputs in [0, 1]
K2_F32_REL_TOL = 1e-4     # of max|ref|: 3xTF32 products, summation order differs
K2_BF16_ULPS = 2          # bf16 ulps at max(|ref|, max|ref| / 64)
EMBED_REL_TOL = 1e-5      # card vs CPU embeddings, of max|cpu|
LABEL_AGREEMENT_MIN = 0.99


def log(msg):
    print(msg, flush=True)


def fighter_boxes(num_frames, width=WIDTH, height=HEIGHT, box_px=BOX_PX):
    boxes = np.zeros((num_frames, 2, 4), np.float32)
    for i in range(num_frames):
        x = 0.2 + 0.6 * (i / num_frames)
        boxes[i, 0] = (x, 0.5, box_px / width, box_px / height)
        boxes[i, 1] = (1.0 - x, 0.5 + 60 / 1080, box_px / width, box_px / height)
    return boxes


def render_frames(indices, num_frames, out):
    """BGR frames of the disc clip for the given frame indices, into out."""
    base = np.random.default_rng(0).integers(0, 60, (HEIGHT, WIDTH, 3), dtype=np.uint8)
    r = DISC_RADIUS
    yy, xx = np.ogrid[-r:r + 1, -r:r + 1]
    disc = yy ** 2 + xx ** 2 <= r * r
    for row, i in enumerate(indices):
        frame = out[row]
        frame[:] = base
        x = int((0.2 + 0.6 * (i / num_frames)) * WIDTH)
        for cx, cy, colour in ((x, HEIGHT // 2, (0, 200, 255)),
                               (WIDTH - x, HEIGHT // 2 + 60, (255, 80, 0))):
            frame[cy - r:cy + r + 1, cx - r:cx + r + 1][disc] = colour


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_cuda(torch, fn, iters, warmup=3):
    """Mean milliseconds per call of fn(it), timed with CUDA events."""
    for it in range(warmup):
        fn(it)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for it in range(iters):
        fn(it)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, iters, kernel_name, warmup=3):
    """Device milliseconds per call of fn(it) and kernel launches per call:
    the self device time of the kernels whose name holds kernel_name, over
    iters back-to-back calls under torch.profiler, divided by iters.
    (None, 0) when the profiler sees no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    for it in range(warmup):
        fn(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for it in range(iters):
            fn(it)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and kernel_name in e.key]
    if not rows:
        return None, 0
    return (sum(e.self_device_time_total for e in rows) / 1e3 / iters,
            sum(e.count for e in rows) / iters)


def crop_touched_bytes(boxes, h, w, size, padding):
    """Source bytes the crops need: per crop, the distinct rows times the
    distinct columns of in-frame bilinear taps, times 3 channels."""
    boxes = boxes.astype(np.float32)
    cx = np.floor(boxes[:, 0] * np.float32(w))
    cy = np.floor(boxes[:, 1] * np.float32(h))
    half = np.floor(np.maximum(np.floor(boxes[:, 2] * np.float32(w)),
                               np.floor(boxes[:, 3] * np.float32(h))) / 2)
    side = np.maximum(2 * (half + padding), 1)
    i = np.arange(size, dtype=np.float32)
    total = 0
    for q in range(len(boxes)):
        counts = []
        for origin, length in ((cy[q] - half[q] - padding, h), (cx[q] - half[q] - padding, w)):
            src = origin + (i + 0.5) * side[q] / size - 0.5
            src = src[(src >= -1) & (src <= length)]
            taps = np.concatenate([np.floor(src), np.floor(src) + 1])
            counts.append(len(np.unique(taps[(taps >= 0) & (taps < length)])))
        total += counts[0] * counts[1] * 3
    return total


def bf16_ulps(out, ref):
    """Largest |out - ref| in bf16 ulps of max(|ref|, max|ref| / 64)."""
    mag = np.maximum(np.abs(ref), np.abs(ref).max() / 64)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(out - ref) / ulp).max())


def profile_slice(torch, run_slice, slice_s):
    """Device time by kernel over one more run of the slice (a diagnostic:
    a profiler that cannot trace the card is reported, not fatal)."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_slice()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only (kernels, copies): the operators above
        # them carry the same time again.
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type != torch.autograd.DeviceType.CPU
                and e.self_device_time_total > 0]
    except Exception as e:  # noqa: BLE001 - diagnostic only, the checks do not depend on it
        log(f"profile: torch.profiler failed: {e!r}")
        return
    busy_ms = sum(ms for _, ms, _ in rows)
    log(f"profile: slice wall {wall_ms:.1f} ms under the profiler ({slice_s * 1e3:.1f} ms "
        f"without), device busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of wall")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:14]:
        log(f"profile: {ms:9.3f} ms {count:6d} x  {key[:100]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA "
              "device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.models.resnet import fold_batch_norm
    from playaid_core_torch.ops import _build
    from playaid_core_torch.ops.conv_block import (
        pack_block,
        residual_block,
        residual_block_packed,
        residual_block_ref,
    )
    from playaid_core_torch.ops.crop_kernel import square_crop_resize
    from playaid_core_torch.ops.preprocess import batched_square_crop_resize

    failures = []

    def check(ok, what):
        log(f"{'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failures.append(what)

    card = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("built in", "entry function", "registers", "spill")):
                log(f"  {name}: {line.strip()}")

    # ---- inputs: weights and the sampled frames of the disc clip ----
    state = from_jax_cnn(load_npz_tree(ASSET))
    pipe = BatchedActionPipeline(device=dev).load_state_dicts(state)
    boxes_all = fighter_boxes(NUM_FRAMES)
    sampled = np.arange(0, NUM_FRAMES, STRIDE)
    per_chunk = CHUNK // STRIDE
    host = torch.empty((len(sampled), HEIGHT, WIDTH, 3), dtype=torch.uint8, pin_memory=True)
    render_frames(sampled, NUM_FRAMES, host.numpy())
    boxes_dev = torch.from_numpy(boxes_all[sampled]).to(dev)  # [240, 2, 4]

    # ---- phase 2: K1 against its plain version ----
    frames0 = host[:per_chunk].to(dev)
    boxes0 = boxes_dev[:per_chunk]
    k1_out = square_crop_resize(frames0, boxes0, CROP, PADDING, True, True)
    k1_ref = batched_square_crop_resize(frames0, boxes0, CROP, PADDING, True, True)
    edge_boxes = torch.tensor(
        [[0, 0, .2, .3], [1, 1, .2, .3], [0, .5, .25, .25], [1, .5, .25, .25],
         [.5, 0, .25, .25], [.5, 1, .25, .25], [0, 1, .3, .3], [1, 0, .3, .3]],
        dtype=torch.float32, device=dev)
    edge_out = square_crop_resize(frames0[:8], edge_boxes, CROP, PADDING, True, True)
    edge_ref = batched_square_crop_resize(frames0[:8], edge_boxes, CROP, PADDING, True, True)
    torch.cuda.synchronize()
    k1_err = max(float((k1_out - k1_ref).abs().max()), float((edge_out - edge_ref).abs().max()))
    check(tuple(k1_out.shape) == (per_chunk, 2, CROP, CROP, 3) and k1_err <= K1_TOL,
          f"phase 2: K1 crop_resize {tuple(k1_out.shape)} + 8 edge boxes, max abs err "
          f"{k1_err:.3e} (tol {K1_TOL})")
    # Off the main path: 30-px crops (rows of 90 floats, no 16-byte stores),
    # windows wider and taller than a 90x160 frame, a degenerate box.  The
    # plain version runs on the CPU here: on the card its division by a
    # crop size that is not a power of two rounds differently (probably
    # through the reciprocal) from the true division that the kernel, the
    # CPU and JAX do.
    odd_frames = frames0[:3, :90, :160].contiguous()
    odd_boxes = torch.tensor([[0.5, 0.5, 1.5, 1.2], [0.02, 0.98, 0.8, 0.8], [0.5, 0.5, 0, 0]],
                             device=dev)
    odd_out = square_crop_resize(odd_frames, odd_boxes, 30, 6, False, True).cpu()
    odd_ref = batched_square_crop_resize(odd_frames.cpu(), odd_boxes.cpu(), 30, 6, False, True)
    odd_err = float((odd_out - odd_ref).abs().max())
    check(odd_err <= K1_TOL, f"phase 2: K1 crop_resize 30-px crops of oversized windows vs the "
          f"CPU plain version, max abs err {odd_err:.3e} (tol {K1_TOL})")

    # ---- phase 3: K2 on the real layer4[1] weights and input ----
    net = pipe.embed
    block = net.layer4[1]
    with torch.inference_mode(), full_float32():
        x = k1_out.reshape(-1, CROP, CROP, 3).permute(0, 3, 1, 2)
        x = net.maxpool(torch.relu(net.bn1(net.conv1(x))))
        x = net.layer4[0](net.layer3(net.layer2(net.layer1(x))))
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()  # [48, 4, 4, 512]
        s1, b1 = fold_batch_norm(block.bn1)
        s2, b2 = fold_batch_norm(block.bn2)
        w1 = block.conv1.weight.permute(2, 3, 1, 0).contiguous()
        w2 = block.conv2.weight.permute(2, 3, 1, 0).contiguous()
        k2_args = (x_nhwc, w1, s1, b1, w2, s2, b2)
        k2_out = residual_block(*k2_args)
        k2_ref = residual_block_ref(*k2_args)
        bf_args = (x_nhwc.bfloat16(), w1.bfloat16(), s1, b1, w2.bfloat16(), s2, b2)
        bf_out = residual_block(*bf_args).float().cpu().numpy()
        bf_ref = residual_block_ref(*bf_args).float().cpu().numpy()
    torch.cuda.synchronize()
    k2_err = float((k2_out - k2_ref).abs().max())
    k2_scale = float(k2_ref.abs().max())
    check(k2_err <= K2_F32_REL_TOL * k2_scale,
          f"phase 3: K2 residual_block f32 {tuple(x_nhwc.shape)} max abs err {k2_err:.3e} "
          f"(tol {K2_F32_REL_TOL} x max|ref| {k2_scale:.3f})")
    ulps = bf16_ulps(bf_out, bf_ref)
    check(ulps <= K2_BF16_ULPS,
          f"phase 3: K2 residual_block bf16 max {ulps:.2f} ulps (tol {K2_BF16_ULPS}), "
          f"max abs err {np.abs(bf_out - bf_ref).max():.3e}")
    # Off the main path: a batch whose last row tile is mostly masked, at
    # the smallest channel count the kernel takes.
    with torch.inference_mode():
        small = (x_nhwc[:5, ..., :64].contiguous(), w1[:, :, :64, :64].contiguous(), s1[:64],
                 b1[:64], w2[:, :, :64, :64].contiguous(), s2[:64], b2[:64])
        small_err = float((residual_block(*small) - residual_block_ref(*small)).abs().max())
        small_scale = float(residual_block_ref(*small).abs().max())
        small_bf = (small[0].bfloat16(), small[1].bfloat16(), *small[2:4], small[4].bfloat16(),
                    *small[5:])
        small_ulps = bf16_ulps(residual_block(*small_bf).float().cpu().numpy(),
                               residual_block_ref(*small_bf).float().cpu().numpy())
    check(small_err <= K2_F32_REL_TOL * small_scale and small_ulps <= K2_BF16_ULPS,
          f"phase 3: K2 residual_block B=5 C=64: f32 max abs err {small_err:.3e} (tol "
          f"{K2_F32_REL_TOL} x {small_scale:.3f}), bf16 max {small_ulps:.2f} ulps")

    # ---- phase 4: the slice ----
    num_chunks = (NUM_FRAMES + CHUNK - 1) // CHUNK
    stages = ("upload", "preprocess", "embed", "scatter", "classify_argmax",
              "classify_viterbi")

    def run_slice(stage_ms=None):
        events = []

        def mark():
            if stage_ms is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

        buf = pipe.make_embedding_buffer(num_chunks * per_chunk)
        mark()
        for c0 in range(0, NUM_FRAMES, CHUNK):
            rows = slice(c0 // STRIDE, (c0 + CHUNK) // STRIDE)
            frames = host[rows].to(dev, non_blocking=True)
            mark()
            crops = pipe.preprocess_frames(frames, boxes_dev[rows], padding=PADDING)
            mark()
            emb = pipe.embed_crops(crops.reshape(-1, CROP, CROP, 3))
            mark()
            pipe.scatter_embeddings(buf, emb, (c0 // STRIDE) * 2)
            mark()
        extent = len(sampled)
        lab_a, conf_a = pipe.classify_buffer(buf, extent, decode="argmax")
        mark()
        lab_v, conf_v = pipe.classify_buffer(buf, extent, decode="viterbi",
                                             switch_cost=SWITCH_COST)
        mark()
        torch.cuda.synchronize()
        if stage_ms is not None:
            for k in range(4 * num_chunks):
                stage_ms[stages[k % 4]] += events[k].elapsed_time(events[k + 1])
            for k, name in enumerate(stages[4:]):
                stage_ms[name] += events[4 * num_chunks + k].elapsed_time(
                    events[4 * num_chunks + k + 1])
        labels = {name: (np.repeat(lab.cpu().numpy(), STRIDE, axis=0)[:NUM_FRAMES],
                         np.repeat(conf.cpu().numpy(), STRIDE, axis=0)[:NUM_FRAMES])
                  for name, lab, conf in (("argmax", lab_a, conf_a), ("viterbi", lab_v, conf_v))}
        return buf, labels

    run_slice()  # warm-up: cuDNN plans, allocator
    square_crop_resize.launches = 0
    residual_block_packed.launches = 0
    stage_ms = dict.fromkeys(stages, 0.0)
    t0 = time.perf_counter()
    buf, labels = run_slice(stage_ms)
    slice_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    u8 = torch.from_numpy(rng.integers(0, 256, (48, CROP, CROP, 3), dtype=np.uint8)).to(dev)
    yuv = torch.from_numpy(rng.integers(0, 256, (48, CROP * CROP * 3 // 2),
                                        dtype=np.uint8)).to(dev)
    emb_u8 = pipe.embed_crops_u8(u8)
    emb_yuv = pipe.embed_crops_yuv(yuv)
    torch.cuda.synchronize()
    launches = {"crop_resize": square_crop_resize.launches,
                "residual_block": residual_block_packed.launches}
    log(f"phase 4: main-path launches {launches}; global TF32 flags left at cudnn "
        f"{torch.backends.cudnn.allow_tf32}, matmul {torch.backends.cuda.matmul.allow_tf32}")
    check(all(n > 0 for n in launches.values()), "phase 4: both kernels ran on the main path")
    fps = NUM_FRAMES / slice_s
    log(f"phase 4: slice {NUM_FRAMES} frames in {slice_s * 1e3:.1f} ms = {fps:.1f} frames/s "
        f"on the device side (decode excluded; host-to-device upload of the sampled frames, "
        f"both decodes included); stage ms {json.dumps({k: round(v, 3) for k, v in stage_ms.items()})}")
    for name, (lab, conf) in labels.items():
        check(lab.shape == (NUM_FRAMES, 2) and lab.min() >= 0 and lab.max() < 63
              and np.isfinite(conf).all(),
              f"phase 4: {name} labels {lab.shape} in [0, 63), confidences finite")
    buf_np = buf.cpu().numpy()
    check(bool(np.isfinite(buf_np).all()) and bool(np.isfinite(emb_u8.cpu().numpy()).all())
          and bool(np.isfinite(emb_yuv.cpu().numpy()).all())
          and tuple(emb_u8.shape) == tuple(emb_yuv.shape) == (48, 1000),
          "phase 4: embeddings finite, embed_crops_u8 and embed_crops_yuv [48, 1000]")

    # The first CPU_FRAMES frames again, on the CPU with the plain versions.
    cpu_pipe = BatchedActionPipeline(device="cpu").load_state_dicts(state)
    n_cpu = CPU_FRAMES // STRIDE
    cpu_buf = cpu_pipe.make_embedding_buffer(n_cpu)
    dev_buf = pipe.make_embedding_buffer(n_cpu)
    t0 = time.perf_counter()
    for c0 in range(0, CPU_FRAMES, CHUNK):
        rows = slice(c0 // STRIDE, (c0 + CHUNK) // STRIDE)
        crops = cpu_pipe.preprocess_frames(host[rows], boxes_dev[rows].cpu(), padding=PADDING)
        cpu_pipe.scatter_embeddings(cpu_buf, cpu_pipe.embed_crops(crops.reshape(-1, CROP, CROP, 3)),
                                    (c0 // STRIDE) * 2)
    log(f"phase 4: CPU rerun of {CPU_FRAMES} frames took {time.perf_counter() - t0:.1f} s")
    dev_buf[:n_cpu * 2] = buf[:n_cpu * 2]
    emb_rel = float(np.abs(buf_np[:n_cpu * 2] - cpu_buf[:n_cpu * 2].numpy()).max()
                    / np.abs(cpu_buf[:n_cpu * 2].numpy()).max())
    check(emb_rel <= EMBED_REL_TOL,
          f"phase 4: card vs CPU embeddings max abs err / max|cpu| = {emb_rel:.3e} "
          f"(tol {EMBED_REL_TOL})")
    for decode in ("argmax", "viterbi"):
        kw = {"decode": decode, "switch_cost": SWITCH_COST}
        on_card = pipe.classify_buffer(dev_buf, n_cpu, **kw)[0].cpu().numpy()
        on_cpu = cpu_pipe.classify_buffer(cpu_buf, n_cpu, **kw)[0].numpy()
        on_card = np.repeat(on_card, STRIDE, axis=0)[:CPU_FRAMES]
        on_cpu = np.repeat(on_cpu, STRIDE, axis=0)[:CPU_FRAMES]
        agree = float((on_card == on_cpu).mean())
        line = (f"phase 4: card vs CPU {decode} labels agree on {int((on_card == on_cpu).sum())}"
                f"/{on_cpu.size} = {agree:.4f}")
        if decode == "argmax":
            check(agree >= LABEL_AGREEMENT_MIN, line + f" (min {LABEL_AGREEMENT_MIN})")
        else:
            log(line)

    # ---- phase 5: timings at the main-path shapes ----
    n_sets = 8  # distinct frame batches, so the touched windows (~75 MB) exceed L2
    frame_sets = [host[k * per_chunk:(k + 1) * per_chunk].to(dev) for k in range(n_sets)]
    box_sets = [boxes_dev[k * per_chunk:(k + 1) * per_chunk] for k in range(n_sets)]

    def grid_inputs(k):
        frames = frame_sets[k].flip(-1).permute(0, 3, 1, 2).float() / 255.0
        frames = frames.repeat_interleave(2, dim=0)  # one input per crop
        b = box_sets[k].reshape(-1, 4)
        cx = torch.floor(b[:, 0] * WIDTH)
        cy = torch.floor(b[:, 1] * HEIGHT)
        half = torch.floor(torch.maximum(torch.floor(b[:, 2] * WIDTH),
                                         torch.floor(b[:, 3] * HEIGHT)) / 2)
        side = torch.clamp(2 * (half + PADDING), min=1.0)
        i = torch.arange(CROP, device=dev, dtype=torch.float32)
        sy = (cy - half - PADDING)[:, None] + (i + 0.5) * side[:, None] / CROP - 0.5
        sx = (cx - half - PADDING)[:, None] + (i + 0.5) * side[:, None] / CROP - 0.5
        gy = (2 * sy + 1) / HEIGHT - 1  # align_corners=False
        gx = (2 * sx + 1) / WIDTH - 1
        grid = torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]), dim=-1)
        return frames, grid

    lib_inputs = [grid_inputs(k) for k in range(n_sets)]
    lib_out = F.grid_sample(*lib_inputs[0], mode="bilinear", padding_mode="zeros",
                            align_corners=False).permute(0, 2, 3, 1)
    lib_err = float((lib_out.reshape(k1_ref.shape) - k1_ref).abs().max())
    log(f"phase 5: grid_sample yardstick vs K1 plain: max abs err {lib_err:.3e}")
    def k1_call(it):
        return square_crop_resize(frame_sets[it % n_sets], box_sets[it % n_sets], CROP,
                                  PADDING, True, True)

    with torch.inference_mode():
        k1_ms = time_cuda(torch, k1_call, 80)
        k1_dev_ms, k1_per_call = device_ms(torch, k1_call, 80, "crop_resize_kernel")
        k1_plain_ms = time_cuda(torch, lambda it: batched_square_crop_resize(
            frame_sets[it % n_sets], box_sets[it % n_sets], CROP, PADDING, True, True), 16)
        k1_lib_ms = time_cuda(torch, lambda it: F.grid_sample(
            *lib_inputs[it % n_sets], mode="bilinear", padding_mode="zeros",
            align_corners=False), 40)
    n_crops = per_chunk * 2
    k1_bytes = (crop_touched_bytes(boxes_all[sampled][:per_chunk].reshape(-1, 4), HEIGHT,
                                   WIDTH, CROP, PADDING)
                + n_crops * CROP * CROP * 3 * 4 + n_crops * 4 * 4)
    k1_bound_ms = k1_bytes / PEAK_BYTES_PER_S * 1e3

    bn = (block.bn1, block.bn2)
    x_nchw = x.contiguous()

    def cudnn_chain(_):
        y = F.conv2d(x_nchw, block.conv1.weight, padding=1)
        y = torch.relu(F.batch_norm(y, bn[0].running_mean, bn[0].running_var, bn[0].weight,
                                    bn[0].bias, False, 0.0, bn[0].eps))
        y = F.conv2d(y, block.conv2.weight, padding=1)
        y = F.batch_norm(y, bn[1].running_mean, bn[1].running_var, bn[1].weight, bn[1].bias,
                         False, 0.0, bn[1].eps)
        return torch.relu(y + x_nchw)

    # The main path's call: the block's cached pack, then the launch.
    with torch.inference_mode():
        pack_f32 = block.block_pack(torch.float32)
        pack_bf16 = pack_block(*bf_args[1:], dtype=torch.bfloat16)
        x_bf16 = bf_args[0]

        def k2_f32(_):
            return residual_block_packed(x_nhwc, pack_f32)

        def k2_bf16(_):
            return residual_block_packed(x_bf16, pack_bf16)

        with full_float32():  # the yardstick in float32 too
            lib2_err = float((cudnn_chain(0).permute(0, 2, 3, 1) - k2_ref).abs().max())
            k2_lib_ms = time_cuda(torch, cudnn_chain, 40)
        log(f"phase 5: cuDNN chain yardstick (TF32 off) vs K2 plain: max abs err {lib2_err:.3e}")
        k2_ms = time_cuda(torch, k2_f32, 40)
        k2_dev_ms, k2_per_call = device_ms(torch, k2_f32, 40, "conv3x3_wgmma_kernel")
        k2_bf16_ms = time_cuda(torch, k2_bf16, 40)
        k2_bf16_dev_ms, _ = device_ms(torch, k2_bf16, 40, "conv3x3_wgmma_kernel")
        k2_plain_ms = time_cuda(torch, lambda it: residual_block_ref(*k2_args), 40)
    m, c = x_nhwc.shape[0] * 16, x_nhwc.shape[3]
    k2_flops = 2 * 2 * m * c * 9 * c
    # Each input read once, the output written once: x, out, both weights, s/b.
    k2_bytes = 2 * m * c * 4 + 2 * 9 * c * c * 4 + 4 * c * 4
    k2_bf16_bytes = 2 * m * c * 2 + 2 * 9 * c * c * 2 + 4 * c * 4
    k2_bound_ms = max(3 * k2_flops / PEAK_TF32_FLOPS, k2_bytes / PEAK_BYTES_PER_S) * 1e3
    k2_bf16_bound_ms = max(k2_flops / PEAK_BF16_FLOPS, k2_bf16_bytes / PEAK_BYTES_PER_S) * 1e3
    k2_core_bound_ms = max(k2_flops / PEAK_FP32_FLOPS, k2_bytes / PEAK_BYTES_PER_S) * 1e3

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    log(f"phase 5: K1 call {k1_ms:.4f} ms, device {fmt(k1_dev_ms)} ({k1_per_call:g} kernel "
        f"a call), plain {k1_plain_ms:.4f} ms, grid_sample {k1_lib_ms:.4f} ms, bound "
        f"{k1_bound_ms:.4f} ms ({k1_bytes / 1e6:.2f} MB)")
    log(f"phase 5: K2 f32 (3xTF32) call {k2_ms:.4f} ms, device {fmt(k2_dev_ms)} "
        f"({k2_per_call:g} kernels a call; {k2_flops / k2_ms / 1e9:.2f} TFLOP/s of f32 work by "
        f"call time), bound {k2_bound_ms:.4f} ms (3 x {k2_flops / 1e9:.2f} GFLOP TF32; CUDA-core "
        f"f32 bound {k2_core_bound_ms:.4f} ms); bf16 call {k2_bf16_ms:.4f} ms, device "
        f"{fmt(k2_bf16_dev_ms)}, bound {k2_bf16_bound_ms:.4f} ms; plain {k2_plain_ms:.4f} ms, "
        f"cuDNN chain {k2_lib_ms:.4f} ms")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_slice(torch, run_slice, slice_s)

    kernels = [
        {"name": "crop_resize", "route": "cuda",
         "source": "playaid_core_torch/csrc/crop_resize.cu",
         "replaces": "playaid_core_tpu/ops/pallas_kernels.py:97",
         "launches": launches["crop_resize"], "max_abs_err": k1_err,
         "ms": k1_ms, "device_ms": k1_dev_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": "bytes", "library_ms": k1_lib_ms},
        {"name": "residual_block", "route": "cuda",
         "source": "playaid_core_torch/csrc/residual_block.cu",
         "replaces": "playaid_core_tpu/ops/pallas_conv_block.py:73",
         "launches": launches["residual_block"], "max_abs_err": k2_err,
         "ms": k2_ms, "device_ms": k2_dev_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound_ms, "bound_by": "operations", "library_ms": k2_lib_ms,
         "cuda_core_bound_ms": k2_core_bound_ms, "bf16_ms": k2_bf16_ms,
         "bf16_device_ms": k2_bf16_dev_ms, "bf16_bound_ms": k2_bf16_bound_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
