#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

The configuration is bench.py's headline (CNN family, 63 classes, the
committed weights playaid_core_tpu/assets/bench_cnn63.npz read as a data
file, T=7, delta 3, stride 2, chunk 48, 128-px crops, padding 30) on a
synthetic 1080p clip: noise background with two discs on the fighter
trajectories.

Phases (any failure exits non-zero, and no result line is printed):
1. build the CUDA kernels from playaid_core_torch/csrc with nvcc (sm_90a:
   K1 crop_resize, K2 residual_block, K3 viterbi, K4 yuv420_unpack, K5
   conv1x1_gemm, K6 ssd_scan and
   K3's chain floor, one nvcc each, all at once) and, at the same time,
   the native log parser (native/log_parser.cpp) with g++, which links no
   FFmpeg library;
2. crop kernel (K1) against its plain version at the main-path shapes and
   on boxes that hang off every frame edge; its window entry against
   batched_window_resize at the window route's shapes (96 windows of 384^2
   -> 128^2) and at edge origins (negative corners, side > W - 2, side 0);
   both entries' crops are views of channels-first storage;
3. residual-block kernel (K2) against its plain version on the real
   layer4[1] weights and input, float32 (3xTF32) and bfloat16; (b) K2 at
   every identity-block shape of the routes (K2_ROUTE_SHAPES) on seeded
   inputs: its launch (launch_shape), held against its plain version, its
   channels-first output equal to its NHWC one, its device ms (both
   outputs) beside the cuDNN chain's and its bound, and every launch's
   call ms (k2_launch_sweep) beside the rule's; (c) K5, the 1x1 kernel
   (csrc/conv1x1_gemm.cu), at every 1x1 shape of ResNet-50 at 128 px and
   batches 48, 24 and 7, random batch norm: held against its plain version
   and cuDNN's unfolded chain (max abs err over max|ref|, K5_TOL), its
   device ms beside the cuDNN chain's (TF32 off) and its bound, every
   launch's call ms beside the rule's; the ResNet-50 trunk at a 48-crop
   chunk with K5 and on cuDNN (call ms, device ms by kind of kernel); the
   embed's k5_convs (36 a ResNet-50
   call, 0 a ResNet-18 one), a replay against the eager call, and the
   replayed embed against the cuDNN chain's (python3 chip_smoke.py --k5
   runs phase 1's build and this alone); (d) K6, the Mamba-2 SSD scan
   (csrc/ssd_scan.cu), at the granite-h-micro.match-seq cell's shapes
   ([2, 5632] rows, 64 heads of 64, state 128, one group, views of one
   row-major xBC as the mixer hands them over) against its twin, at 700
   rows (padded) and on a [2, 1024] x 8-head slice against the
   reference's recurrence in float64 (K6_TOL of max|ref|); its call and
   device ms beside the eager chunked form's and its bound
   (portbench/k6.py); a small Granite head through classify_buffer with
   K6: ssd_layers on its playaid.head span, its Viterbi labels against the
   reference's decode and its confidences against the reference's
   (python3 chip_smoke.py --k6 runs phase 1's build and this alone);
4. the device slice from pinned frames, with PyTorch's default TF32 flags
   (the entry points set their own float32 numerics): per chunk upload ->
   preprocess_frames (K1) -> embed_crops (ResNet-18, its five identity blocks through K2)
   -> scatter_embeddings, then classify_buffer (argmax and Viterbi, both
   fighters in one K3 launch) and the stride repeat; launch counts (K3
   one, K4 none: the crops come from K1); the first 96 frames again on
   the CPU; the layout kernels' ms in a profiled slice (no nhwcToNchw or
   nchwToNhwc: K1's crops reach the stem channels first, and the last
   block of each fused run writes channels first); (b) K3 against
   viterbi_decode_ref on the slice's own
   [2, 256, 63] log-probs (true length 240), on a seeded 14,400-row match
   and on edge cases (lengths 0, 1 and F a sequence, F 1, A 1/33/64/1024,
   -inf rows, costs 0 and inf, 30,000 rows whose backpointers spill past
   shared memory, a length one 32-step group past what shared memory holds
   beside one that just fits, A 1024 spilling): labels identical; K4
   against yuv420_to_rgb_ref at [48, 24576] and [1, 24576]: max abs err 0;
5. timings of each kernel: call time (CUDA events over back-to-back calls)
   and device time (torch.profiler), its plain version and one library
   call that computes the same function (f32 and bf16), with the least
   time the card could take; K3 also at 14,400 rows, in us a step, with
   its latency bound beside: the chain floor (one warp running only the
   dependent chain, tools/torch_port_k3_chain_floor.cu, built in phase 1)
   times the steps, and the fraction of the device time it is; K4's
   plain version's device time too, and the embed of a chunk from K4's
   channels-first output against the same values stored channels last;
6. the VOD path, VodAnalyzer.analyze (decode -> pinned ring and copy
   stream -> embed_crops_yuv -> buffer -> labels), native backend, yuv420,
   stride 2, chunk 48, argmax then Viterbi (timed): K2 launches, weights on
   the card, host-to-device bytes per chunk under torch.profiler, the
   device's busy share and the layout conversions in its trace, K3 one
   launch and K4 one a chunk, K3 against its plain version on the run's
   own log-probs, decode-only frames/s, and the first 96 frames on the
   CPU; embed_crops_yuv's CUDA graph at a 48-crop chunk (graph_replay_check):
   each replay equal bit for bit to the eager call, and the launches and
   k2_blocks each replay counts against the K2 and K4 kernels that the
   profiler's trace shows under its cudaGraphLaunch (two kernels a K2
   call);
7. the ResFormer (ResNet-50 + 3 transformer layers) and RNN (ResNet-18 +
   3-layer LSTM) families at full width with seeded random weights through
   the same analyzer, against the CPU on the first 96 frames; the same
   graph check as phase 6 for each (with K5's 36 kernels a ResFormer
   replay);
8. the log path: a scripted ult_logger log of 480 frames (written here,
   with json) -> boxes_from_log through the native parser built in phase 1
   -> VodAnalyzer(host_resize=False), stride 1, chunk 48: 1080p frames from
   a stand-in capture -> 384-px windows cut on the host -> pinned ring ->
   K1's window entry -> ResNet-18 with K2 -> labels, argmax then Viterbi
   (timed): K1 (window entry), K2, K3 (one) and K4 (none) launches,
   host-to-device bytes per chunk (the windows and their origins, no
   weights), K3 against its plain version on the run's own log-probs, card
   vs CPU labels on the first 96 frames, frames/s and its split, the
   layout kernels' ms in the profiled run (no nhwcToNchw or
   nchwToNhwc); then the
   command line,
   main([...]) in this process, on the same log with a port checkpoint
   file made from the bench weights, --stride 2, through phase 6's decoder
   stand-in: one CSV row per frame, moves named by CLASS_ID_TO_MOVE;
9. the pixels-only path, no log: a stand-in capture of 240 1280x720 frames
   (two discs that cross the screen, both HUD damage counters painted with
   a 5x7 bitmap font, stepping every 30 frames) -> CharacterDetector with
   the CenterNet detector at full width and seeded weights, batches of 16
   (frames resized to 256x448 on the card, K2 in the trunk's five identity
   blocks, layer4[1]'s at 8x14x512 held against its plain version there) -> AIRunner cleanup ->
   run_action_recognition (the bench weights, K2 in the embed at
   239x4x4x512, held against its plain version on the inputs it ran) ->
   run_damage_detection (the conv digit net on the card) -> write_output:
   K2 launches (K3 and K4 none: argmax decode, host crops), weights on the
   card, host-to-device bytes of a detector batch, frames/s of each stage, card vs CPU detections, labels, readings
   and digit logits;
10. training: a ground-truth tree of .npy crops (the disc clip's crops, 63
   seeded classes) under build/smoke/ -> UltActionRecogDataset ->
   Trainer.fit for CNN-63 at full width (batch 8, T 7, 128 px, lr 3e-4,
   from the bench weights; 2 epochs of 16 steps, validation, checkpoints),
   then the RNN and ResFormer families from seeded init (2 epochs of 8
   steps): the JSONL records; K2 launches in train steps (0) and eval
   steps (> 0 for CNN and RNN); (a) one CNN step on the card against the
   CPU in float64: loss and every gradient; (b) after training, eval
   log-probs with layer4[1] on K2 vs on residual_block_ref, and K2 vs its
   plain version at 56x4x4x512, timed; (c) the epoch checkpoint through
   BatchedActionPipeline.load_checkpoint on the card; (d) the loss on one
   fixed batch falls over 20 steps; (e) under torch.profiler, in a fresh
   process (python3 chip_smoke.py --profile train), each step of a
   20-step epoch copies its uint8 batch (2,752,512 B), its labels and
   fighter ids, and no weights, with the device's busy share and K2's
   device time at 56x4x4x512; then per family the steady-state steps/s
   and crops/s of an epoch of 50 steps (timed from its third step), and a
   batch's assembly and a train step timed alone;
11. device-side synthetic training, in a fresh process (python3
   chip_smoke.py --synth): a clean-char tree of .npy stand-in sprites under
   build/smoke/synth/ (generate_sprite_set's layout: 6 fighters x 48 moves x
   16 frames x 2 facings, square BGRA sprites of 104-176 px drawn with
   numpy, as the card's machine has no cv2) and train_bench_weights.py's
   four stage textures as .npy -> DeviceSynthDataset with the arguments of
   tools/torch_port_train_bench_weights.py (the sprite and stage banks on
   the card; their copies at construction under torch.profiler, exactly
   their nbytes) -> Trainer.fit for CNN-63 (batch 16, T 7, 128 px, lr 3e-4
   decaying over the run, float32; 2 epochs of 20 steps): (a) K1's bank
   entry against batched_bank_resize at the phase's shapes and on edge
   windows, C=3 and 4, mirrored or not, its crops channels last; (b)
   synth_composite on the card
   against the CPU with the same noise and dropout draws; (c) launches in
   the fit: bank_resize 2 a step, no other kernel of the port's; (d) under
   torch.profiler, in a process of its own (python3 chip_smoke.py --profile
   synth, which builds its dataset while the first builds its own, then
   waits), a 20-step epoch copies only each batch's packed ints and floats
   and its labels to the card, and the busy share; (e) the loss
   on one fixed synthetic batch falls over 20 steps; (f) the JSONL
   records; then the bank entry's and the composite's times and the
   steady state of a 50-step epoch;
12. character-detector training: a YOLO tree under build/smoke/detector/
   (96 training and 64 validation 720x1280 BGR .npy composites of 1-4
   stand-in characters drawn with numpy, 50-150 px wide, one palette a
   class, placed as gen_synth_char_detection places them) ->
   DetectionDataset -> DetectorTrainer (CenterNet, 6 classes, 256x448,
   head 128, batch 8, AdamW lr 5e-4 wd 1e-4, float32 with TF32 off, Flax's
   seeded init): (a) one step of batch 2 against the CPU in float64: the
   card's float32 loss, its float64 gradients, and its float32 gradients'
   error beside the CPU float32's; (b) the command line, main([...]) in
   this process, 40 steps on the training split; (c) K1 and K2 launches 0
   in fit, K2 five a batch of 16 in evaluate(64); (d) after training, K2
   against its plain version on the trunk's layer4[1] input at
   16x8x14x512, timed, and evaluate's first batch with layer4[1] on K2 and
   on residual_block_ref; (e) the loss on one fixed batch falls over 20
   steps; (f) in a fresh process (python3 chip_smoke.py --profile
   detector) a 20-step epoch copies exactly its images and targets
   (5,275,648 B a step) and no weights, with the busy share and K2's device
   time; (g) the steady state of a 50-step fit, a batch assembled alone, a
   step alone, and evaluate's loc and loc_class.
13. the multi-device path (parallel/mesh.py): (a) an NCCL process group of
   world size 1 (a file store): the meshed Trainer's CNN-63 step (bench
   weights, phase 10's first batch) against the plain Trainer step, loss
   and grad norm within 2e-4 relative, and one meshed evaluate with K2 in layer4[1] held
   against residual_block_ref; (b) two gloo ranks sharing the card
   (python3 chip_smoke.py --mesh-rank 0|1, CUDA tensors): CNN-63 on a
   (2, 1) mesh, the ResFormer at full width (ResNet-50, 63 classes, T 7,
   128 px, batch 8) on a (1, 2) mesh and the RNN at full width (ResNet-18,
   63 classes, T 7, 128 px, hidden 512, 3 layers; its LSTM's gate rows
   split over model and stepped by hand) on a (1, 2) mesh, 3 steps each,
   against one process: loss and grad norm within 2e-4 relative (CNN-63 and
   the RNN in float32, the RNN's param norm too; the ResFormer in float64,
   and its float32 grad norm no farther from float64's than one process's
   is, plus 2e-4), CNN-63's batch-norm running statistics within 1e-5 of
   max|ref| after step 1 in float32 and after the last step on runs in
   float64 (two float32 runs, one process against itself too, drift apart
   through the Adam steps from the backward's rounding:
   tools/torch_port_mesh_bn.py), the float32 statistics after the last
   step logged beside, each rank's
   host-to-device bytes exactly its rows of a batch, step times, the number
   and bytes of each collective, the RNN's model-axis collectives a step
   and its LSTM's share of the step (the LSTM timed alone); (c)
   VodAnalyzer(mesh=make_mesh(devices=[cuda:0, cuda:0])) on phase 6's clip:
   labels identical to mesh=None, confidences within 1e-4, K2 launches 10
   a chunk (5 a replica) and K4 2, K3 one, and K2 held against its plain version in each replica,
   frames/s beside phase 6's; (d) the (1, 2) ResFormer's checkpoint after
   its first step, restored on one process: the next two losses within
   2e-4 relative, and BatchedActionPipeline.load_checkpoint reads it;
14. OCR training and the evaluation dashboards: (a) the port's OCR train
   step (DigitNet at PATCH 48, batch 128, fused Adam under optax's cosine
   decay, Flax's init from a seeded generator) on the committed fixture
   playaid_core_torch/assets/ocr_synth_batches.npz (8 batches rendered by
   tools/torch_port_ocr_fixture.py, as the card's machine cannot render):
   one step against the CPU in float64 (loss, every gradient), 50 steps
   whose float32 loss falls (steps 3-50 timed), each profiled step's
   host-to-device copies exactly its batch (python3 chip_smoke.py
   --profile ocr, which also times K2's device ms at 7x4x4x512 and at phase
   13's 24x4x4x512), save_params -> ConvDigitOCR(params=load_params(...))
   on the card against the trained model; (b) evaluate_samples with the
   CNN-63 from the bench weights in eval mode over 16 samples of phase
   10's validation tree: K2 five launches a sample, layer4[1]'s at 7x4x4x512 held against
   its plain version and timed, card vs CPU predictions, log-probs and
   accuracy; (c) write_vis_ai_report on phase 9's runner, its own labels as
   the first fighter's ground truth: the strip count, that fighter's
   agreement 1.0, and every inline PNG decoded with zlib to its crop
   file's RGB pixels;
15. the synthetic-training path on skeletal sprites drawn on the card's
   host, in a fresh process (python3 chip_smoke.py --sprites): (a) the
   sprite tree of playaid_core_torch/assets/sprite_digests.json's settings
   (6 fighters x 8 moves x 8 frames x variants 0-1 x 2 facings, 1,536
   sprites) drawn under build/smoke/sprites/ by the port's
   generate_sprite_set(fmt="npy") in one process a CPU, without cv2: the
   sprites/s, and the SHA-256 of 48 of them equal to those the JAX
   package's cv2 renderer gives (tools/torch_port_sprite_digests.py); the
   bench tool's four stage textures as .npy; (b) UltActionRecogDataset(
   split="synth") over them with the bench tool's arguments (fill
   0.70-0.98, jitter 10, middle-out, cycle repeats 1-2, difficulty 1, one
   batch at 2, no JPEG degrade): uint8 [16, 7, 128, 128, 3] frames, labels
   in [0, 63), a batch's assembly alone in crops/s; (c) Trainer.fit of
   CNN-63 from the bench weights (batch 16, T 7, 128 px, float32, TF32
   off) for 30 steps through BackgroundIterator, timed from its third step:
   no K1 or K2 launch in it; the busy share of a profiled 4-step epoch; the
   loss on one fixed batch falls over 20 steps; (d) Trainer.evaluate on the
   split: K2 five launches a batch, layer4[1]'s at 112x4x4x512 held against
   residual_block_ref on the input it ran, timed (call, device, plain,
   cuDNN chain, bound); (e) DeviceSynthDataset over the drawn tree, 10
   steps: K1's bank entry 2 launches a step, held against
   batched_bank_resize;
16. the annotated-match path: (a) Manuscript.render (graphs and summaries
   on, the summaries held 3 s each) on phase 8's scripted 480-frame log at
   1920x1080, its frames from a stand-in for the manuscript module's
   VideoReader (the log clip's noise and discs) and its output to a
   stand-in writer that hashes a fixed set of frames: those SHA-256, and
   those of every chart panel of the final stats, equal the ones
   tools/torch_port_manuscript_digests.py makes with the JAX package, cv2
   and PIL on the same frames (playaid_core_torch/assets/
   manuscript_digests.json); the render's frames/s and StageTimer's stages
   (decode, state+stats, charts, encode); (b) Manuscript(ai_output_path=)
   on the ai_output.yaml phase 9's AIRunner wrote, every label opening with
   the file's action; (c) batched_crop_resize_shared_frame on every 8th
   frame of the log clip through K1's frames entry (launches counted)
   against batched_square_crop_resize on the card within 1e-5, its call,
   device (through profiling.trace) and plain times, F.grid_sample at the
   same shape (one 1080p frame, two crops), and classify_chunked against
   classify_buffer;
17. ground truth from a (VOD, log) pair on the card's machine, under
   build/smoke/gt/: phase 8's log served at 1280x720 (the log's projection
   size) by a stand-in capture behind video/reader.open_capture;
   (a) gen_gt_action_detection.process_pairing(fmt="npy") writes the
   action tree (960 crops), whose crops and labels digest, per fighter, to
   what the JAX module gives on the same frames (playaid_core_torch/
   assets/gt_digests.json, from tools/torch_port_gt_digests.py), a second
   run writes nothing, then Trainer.fit trains CNN-63 from the bench
   weights 8 steps on the tree and evaluate runs 2 batches, K2 five launches
   a batch (none in train steps), held against residual_block_ref; (b)
   gen_gt_char_detection.generate_data(interval=10, fmt="npy") writes 48
   frames whose YOLO label files and frames equal the JAX module's, then
   DetectorTrainer.fit takes 8 steps and evaluate(32) runs with K2 (five a
   batch of 16), held against its plain version; (c) a raw animation dump
   written as PNG by imgcodec's own writer is cleaned by raw_anim_cleaner,
   whose PNGs decode to the JAX cleaner's, and read_sprite reads each as
   BGRA; (d) char_loader.CharacterLoader(seed=0)'s strips from PNG frames
   digest to the JAX loader's.

The card's machine has no FFmpeg libraries or headers
(tools/torch_port_probe_libav.sh), so the port's native decoder cannot be
built there: phases 6, 7 and 8's command line put a stand-in behind the
port's native_decoder.acquire/release/probe, in this script only.  Its
decode_crops returns the disc clip's packed YUV420 crops, made on the host
with numpy; everything after decode is the port's own.  The CPU tests hold
the port's decoder against the JAX package's, bit for bit.  It has no cv2
either, so phases 8 and 9 read their frames from stand-ins put behind
video/reader.open_capture (again in this script only): frames
with discs (and, in phase 9, the HUD counters), rendered with numpy.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import atexit
import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from portbench.constants import PEAK_HBM_BYTES, PEAK_TF32_FLOPS
from portbench.standin import bgr_crop, yuv420_crop

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "playaid_core_tpu", "assets", "bench_cnn63.npz")

HEIGHT, WIDTH = 1080, 1920
NUM_FRAMES, CHUNK, STRIDE = 480, 48, 2
CROP, PADDING, BOX_PX, DISC_RADIUS = 128, 30, 260, 90
WINDOW = 384  # the window route's host-side window (VodAnalyzer's default)
CPU_FRAMES = 96
SWITCH_COST = 16.0
MATCH_ROWS = 14400  # an 8-minute match at 60 fps, stride 2: K3's long case
FAMILY_SEED = 0

PROFILE_SETTLE_S = 0.05   # pause between a profile's first opening kernel and the rest
PROFILE_OPENERS = 8       # small kernels after the pause, before the work
TRACE_OPENERS = 64        # the same in traced_device_ms: late in this process a
                          # profiling.trace session lost its first 33 launches

# H100 SXM data-sheet peaks at 700 W, beside portbench/constants.py's TF32
# and HBM peaks.
PEAK_FP32_FLOPS = 67e12   # CUDA cores: K2's yardstick before the tensor cores
PEAK_BF16_FLOPS = 989e12

K1_TOL = 1e-5             # max abs, outputs in [0, 1]
LOG_PROB_TOL = 1e-4       # card vs CPU head log-probs, max abs
K2_F32_REL_TOL = 1e-4     # of max|ref|: 3xTF32 products, summation order differs
K2_BF16_ULPS = 2          # bf16 ulps at max(|ref|, max|ref| / 64)
K2_BLOCKS = 5             # fused identity blocks a ResNet-18 call: layer1[0], layer1[1],
                          # layer2[1], layer3[1], layer4[1]
# Every identity block a route of the port runs, [B, H, W, C]: ResNet-18's
# four stages at 128-px crops, in 48-crop chunks (the VOD path), 24 (a
# replica of VodAnalyzer(mesh=)), 7 (the dashboards' samples), 56 and 112
# (the training evaluate passes), and the detector's trunk at 256x448 in
# batches of 16.
K2_EMBED_MAPS = ((32, 32, 64), (16, 16, 128), (8, 8, 256), (4, 4, 512))
K2_ROUTE_SHAPES = (tuple((b,) + hwc for b in (48, 24, 7, 56, 112) for hwc in K2_EMBED_MAPS)
                   + ((16, 64, 112, 64), (16, 32, 56, 128), (16, 16, 28, 256), (16, 8, 14, 512)))
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


@functools.lru_cache(maxsize=1)
def noise_background():
    """The clips' 1080p BGR background, made once (read-only)."""
    base = np.random.default_rng(0).integers(0, 60, (HEIGHT, WIDTH, 3), dtype=np.uint8)
    base.flags.writeable = False
    return base


def render_frames(indices, num_frames, out):
    """BGR frames of the disc clip for the given frame indices, into out."""
    base = noise_background()
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


def grid_sample_inputs(torch, frames, boxes):
    """K1's yardstick: F.grid_sample's input (the uint8 BGR frames [N, H, W,
    3] as RGB floats in [0, 1], channels first, one copy a crop) and its
    grid, sampling each of the boxes [N, 2, 4] at K1's points (the window of
    side 2 * (max(w, h) // 2 + PADDING) around the integer centre, CROP^2,
    align_corners=False)."""
    height, width = frames.shape[1:3]
    x = frames.flip(-1).permute(0, 3, 1, 2).float() / 255.0
    x = x.repeat_interleave(2, dim=0)  # one input per crop
    b = boxes.reshape(-1, 4)
    cx = torch.floor(b[:, 0] * width)
    cy = torch.floor(b[:, 1] * height)
    half = torch.floor(torch.maximum(torch.floor(b[:, 2] * width),
                                     torch.floor(b[:, 3] * height)) / 2)
    side = torch.clamp(2 * (half + PADDING), min=1.0)
    i = torch.arange(CROP, device=frames.device, dtype=torch.float32)
    sy = (cy - half - PADDING)[:, None] + (i + 0.5) * side[:, None] / CROP - 0.5
    sx = (cx - half - PADDING)[:, None] + (i + 0.5) * side[:, None] / CROP - 0.5
    gy = (2 * sy + 1) / height - 1  # align_corners=False
    gx = (2 * sx + 1) / width - 1
    grid = torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]), dim=-1)
    return x, grid


class DiscClipDecoder:
    """Stand-in for the port's NativeVideoDecoder on the disc clip.

    decode_crops(start, boxes, ..., stride, fmt="yuv420", dense=True)
    returns (frames decoded, [ceil(n / stride), K, S*S*3//2] uint8) like
    the native one.  Crops are made from the rendered frames on the first
    request for a (frame, box) and kept, so a run after the first reads
    them from memory.  Safe to call from several threads.
    """

    def __init__(self, num_frames):
        self.num_frames = num_frames
        self.info = {"width": WIDTH, "height": HEIGHT, "fps": 60.0,
                     "num_frames": num_frames, "max_lowres": 0, "fast": 0}
        self._crops = {}
        self._frame = np.empty((1, HEIGHT, WIDTH, 3), np.uint8)
        self._rendered = None
        self._lock = threading.Lock()

    def _crop(self, i, box, size, padding):
        key = (i, box.tobytes(), size, padding)
        crop = self._crops.get(key)
        if crop is None:
            with self._lock:
                if self._rendered != i:
                    render_frames([i], self.num_frames, self._frame)
                    self._rendered = i
                crop = yuv420_crop(self._frame[0], box, size, padding)
            self._crops[key] = crop
        return crop

    def decode_crops(self, start, boxes, out_size=128, padding=30, stride=1, out=None,
                     fmt="bgr", dense=False):
        if fmt != "yuv420" or not dense or out is not None:
            raise ValueError("the stand-in gives dense yuv420 crops only")
        n = max(0, min(boxes.shape[0], self.num_frames - start))
        crops = np.zeros(((boxes.shape[0] + stride - 1) // stride, boxes.shape[1],
                          out_size * out_size * 3 // 2), np.uint8)
        for j in range(0, n, stride):
            for k in range(boxes.shape[1]):
                crops[j // stride, k] = self._crop(start + j, boxes[j, k], out_size, padding)
        return n, crops


def install_stand_in(native_decoder, stand_in):
    """Put the stand-in behind the port's decoder pool, in this process."""
    native_decoder.acquire = lambda path, lowres=0, fast=False: stand_in
    native_decoder.release = lambda dec: None
    native_decoder.probe = lambda path, fast="auto": stand_in.info


def trace_device_events(path):
    """Device-side events (kernels, copies, sets) of an exported chrome
    trace: (name, category, start us, duration us, bytes or None)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e.get("name", ""), e["cat"], float(e["ts"]), float(e["dur"]),
             e.get("args", {}).get("bytes"))
            for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "dur" in e]


def trace_copy_audit(path, kernel_key):
    """What an exported chrome trace says of its host-to-device copies:
    each copy's (bytes, stream); the streams of the kernels whose name holds
    kernel_key; the cudaMemcpy* calls traced on the host; and the records
    the trace itself shows lost: those calls whose copy is missing on the
    device side (matched by correlation id), with where they sit (their
    index among the calls in time order, ms after the trace's first
    event), and any note of dropped records that the profiler wrote
    beside the events."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    traced = {e.get("args", {}).get("correlation") for e in device}
    calls = sorted((float(e["ts"]), e.get("args", {}).get("correlation")) for e in events
                   if e.get("cat") == "cuda_runtime" and e.get("name", "").startswith("cudaMemcpy"))
    start = min((float(e["ts"]) for e in events if "ts" in e), default=0.0)
    return {
        "h2d": [(e.get("args", {}).get("bytes"), e.get("args", {}).get("stream"))
                for e in device if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", "")],
        "kernel_streams": {e.get("args", {}).get("stream") for e in device
                           if e["cat"] == "kernel" and kernel_key in e.get("name", "")},
        "calls": len(calls),
        "lost": [c for _, c in calls if c not in traced],
        "lost_at": [(i, round((ts - start) / 1e3, 3)) for i, (ts, c) in enumerate(calls)
                    if c not in traced],
        "notes": [f"{k}: {str(v)[:200]}" for k, v in trace.items()
                  if k != "traceEvents" and "drop" in str(v).lower()],
    }


@contextlib.contextmanager
def profiled(torch, cpu=True, settle_s=PROFILE_SETTLE_S):
    """A torch.profiler session of the card (and of the host, when cpu)
    that begins by running one small kernel to its end, then, after
    settle_s seconds, a few more, and ends with one too.
    Late in this script's process (after phases 1-8; not at its start) the
    profiler's trace missed device records of copies in every profile that
    began with the copies (a lone 44 MB copy, three detector batches), and
    in nearly none that began with such a kernel
    (tools/torch_port_trace_audit.py lead).  Phase 11's traces, in a young
    process, each missed one record at their end (the last of two bank
    copies; one of 160 bank_resize kernels) in a session without the
    closing kernel; a later run, in that process's second session, lost
    two (one step's ints and floats) with both kernels.  So phase 11's
    epoch is profiled as the first session of a process of its own.  Its
    next sessions, K1's bank timings, then lost one or two of 160 kernel
    records in each of three runs.  tools/torch_port_trace_audit.py settle
    found the lost launches at a session's start: its first three (the
    opening kernels and the first of the work), once 186; after the pause
    only the first launch of the openers that follow it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        if settle_s:
            time.sleep(settle_s)
            x = torch.ones(1, device="cuda")
            for _ in range(PROFILE_OPENERS):
                x.add_(1)
            torch.cuda.synchronize()
        yield prof
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def busy_us(events):
    """Length of the union of the events' intervals (streams overlap)."""
    total, end = 0.0, -1.0
    for _, _, ts, dur, _ in sorted(events, key=lambda e: e[2]):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


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


def device_ms(torch, fn, iters, kernel_name, per_call, warmup=3):
    """Device milliseconds per call of fn(it), and the kernel records traced
    per call: the durations of the kernels whose name holds kernel_name in
    the exported chrome trace of iters back-to-back calls under
    torch.profiler, divided by iters.  The exported trace, because
    key_averages() has held fewer records than it (159 of 160 bank_resize
    kernels in phase 11).  A call launches per_call such kernels; a
    trace that holds another count (none, or some records lost) is
    profiled again, once, and if that one too is short it measures
    nothing, and the time is None."""
    for it in range(warmup):
        fn(it)
    torch.cuda.synchronize()
    trace = os.path.join(ROOT, "build", "smoke", f"device_ms_{os.getpid()}.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    for _ in range(2):
        with profiled(torch) as prof:
            for it in range(iters):
                fn(it)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        durs = [dur for name, cat, _, dur, _ in trace_device_events(trace)
                if cat == "kernel" and kernel_name in name]
        launches, lost = lost_launches(trace)
        os.remove(trace)
        traced = len(durs) / iters
        if traced == per_call:
            return sum(durs) / 1e3 / iters, traced
        log(f"device_ms: {len(durs)} of {per_call * iters} {kernel_name} records; {len(lost)} of "
            f"{launches} launches with no kernel on the device (launch index, ms into the "
            f"trace: {lost[:12]})")
    return None, traced


def span_device_ms(torch, fn, iters, warmup=3):
    """Device milliseconds per call of every kernel that fn(it) launches (a
    plain version's many small kernels), and how many a call: the kernels
    whose launch the exported trace's host side places inside a
    record_function span around iters calls (not the session's opening and
    closing kernels).  A trace in which a launch of the span has no kernel
    on the device is profiled again, once; if that one loses one too, the
    time is None."""
    for it in range(warmup):
        fn(it)
    torch.cuda.synchronize()
    trace = os.path.join(ROOT, "build", "smoke", f"span_ms_{os.getpid()}.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    for _ in range(2):
        with profiled(torch) as prof:
            with torch.profiler.record_function("chip_smoke_span"):
                for it in range(iters):
                    fn(it)
                torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        os.remove(trace)
        span = next(e for e in events
                    if e.get("name") == "chip_smoke_span" and e.get("cat") == "user_annotation")
        lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
        launched = {e.get("args", {}).get("correlation") for e in events
                    if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")
                    and lo <= float(e["ts"]) <= hi}
        durs = [float(e["dur"]) for e in events if e.get("cat") == "kernel"
                and e.get("args", {}).get("correlation") in launched]
        if launched and len(durs) == len(launched):
            return sum(durs) / 1e3 / iters, len(durs) / iters
        log(f"span_device_ms: {len(durs)} kernels on the device for {len(launched)} launches")
    return None, len(durs) / iters


def traced_device_ms(torch, fn, iters, kernel_name, per_call, log_dir, warmup=3,
                     openers=TRACE_OPENERS):
    """device_ms through the port's own tracer: iters back-to-back calls of
    fn(it) under profiling.trace(log_dir), which opens with one kernel run
    to its end, then (as profiled opens a session) a pause and openers more
    small kernels before the work; the mean per call of the kernels whose
    name holds kernel_name in its trace.json.  A trace that holds another
    count than per_call a call is taken again, once; if that one is short
    too, the time is None (and the losses are logged)."""
    from playaid_core_torch import profiling

    for it in range(warmup):
        fn(it)
    torch.cuda.synchronize()
    for _ in range(2):
        with profiling.trace(log_dir):
            time.sleep(PROFILE_SETTLE_S)
            x = torch.ones(1, device="cuda")
            for _ in range(openers):
                x.add_(1)
            torch.cuda.synchronize()
            for it in range(iters):
                fn(it)
            torch.cuda.synchronize()
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        path = os.path.join(log_dir, profiling.TRACE_FILE)
        durs = [dur for name, cat, _, dur, _ in trace_device_events(path)
                if cat == "kernel" and kernel_name in name]
        if len(durs) == per_call * iters:
            return sum(durs) / 1e3 / iters
        launches, lost = lost_launches(path)
        log(f"traced_device_ms: {len(durs)} of {per_call * iters} {kernel_name} records; "
            f"{len(lost)} of {launches} launches with no kernel on the device (launch index, "
            f"ms into the trace: {lost[:12]})")
    return None


def lost_launches(path):
    """The kernel launches traced on the host in an exported chrome trace,
    and those with no kernel on the device (matched by correlation id):
    their index among the launches in time order, ms after the trace's
    first event."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    traced = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    launches = sorted((float(e["ts"]), e.get("args", {}).get("correlation")) for e in events
                      if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", ""))
    start = min(float(e["ts"]) for e in events if "ts" in e)
    return len(launches), [(i, round((ts - start) / 1e3, 3))
                           for i, (ts, c) in enumerate(launches) if c not in traced]


@contextlib.contextmanager
def capture_restored():
    """Put video/reader.open_capture back as it was when the block ends: a
    phase inside puts its own stand-in capture there."""
    from playaid_core_torch.video import reader

    real = reader.open_capture
    try:
        yield
    finally:
        reader.open_capture = real


@contextlib.contextmanager
def recorded_viterbi():
    """Record each call the pipeline makes to K3's wrapper (in this script
    only): a copy of its log-probs, its true length and cost, and a copy of
    the labels the wrapper gave."""
    from playaid_core_torch.infer import pipeline as pipeline_module

    wrapper = pipeline_module.viterbi_decode
    calls = []

    def recording(log_probs, true_len, switch_cost):
        lp = log_probs.clone()
        labels = wrapper(log_probs, true_len, switch_cost)
        calls.append((lp, true_len, switch_cost, labels.clone()))
        return labels

    pipeline_module.viterbi_decode = recording
    try:
        yield calls
    finally:
        pipeline_module.viterbi_decode = wrapper


def k3_against_plain(torch, calls):
    """Whether each recorded K3 launch's labels equal viterbi_decode_ref's
    on the same card tensors, and the launches' shapes."""
    from playaid_core_torch.ops.viterbi import viterbi_decode_ref

    same = all(torch.equal(viterbi_decode_ref(lp, n, cost), labels)
               for lp, n, cost, labels in calls)
    return same, [tuple(lp.shape) for lp, _, _, _ in calls]


def k3_edge_cases(torch, dev):
    """(what, log_probs, true_len, cost) of K3's edge cases on the card:
    per-sequence lengths 0, 1 and F, F = 1, A of 1, 33, 64 and 1024,
    entries, a class column and a whole row of -inf, costs 0 and inf, a
    match long enough that the backpointers spill past shared memory, one
    a group of 32 steps past what shared memory holds beside one that just
    fits, and A = 1024 spilling.  The log-probs are quantised to quarter
    nats, so maxima and scores tie."""
    from playaid_core_torch.ops.viterbi import scratch_layout

    rng = np.random.default_rng(7)
    past = 32 * scratch_layout(10**6, 63)[2] + 1  # its last row's group spills

    def lp(b, f, a, neg_inf=False):
        x = (np.round(rng.normal(-3.0, 2.0, (b, f, a)) * 4) / 4).astype(np.float32)
        if neg_inf:
            x[rng.random(x.shape) < 0.1] = -np.inf
            x[0, :, a // 2] = -np.inf
            x[-1, f // 2] = -np.inf
        return torch.from_numpy(x).to(dev)

    def lengths(*v):
        return torch.tensor(v, device=dev)

    return [("lengths 0/1/F/23, A 63", lp(4, 40, 63), lengths(0, 1, 40, 23), 4.0),
            ("A 1", lp(2, 40, 1), 40, 4.0),
            ("A 33, -inf, cost 0", lp(3, 40, 33, True), lengths(40, 17, 1), 0.0),
            ("A 64, -inf, cost inf", lp(2, 40, 64, True), lengths(40, 31), float("inf")),
            ("F 1", lp(2, 1, 63), 1, 4.0),
            ("F 1, true_len 0", lp(2, 1, 63), 0, 4.0),
            ("F 30000 (spills)", lp(2, 30000, 63), lengths(30000, 29000), SWITCH_COST),
            (f"F {past} (one group past shared memory; the other fits)", lp(2, past, 63),
             lengths(past, past - 1), SWITCH_COST),
            ("A 1024 (spills)", lp(2, 2000, 1024, True), lengths(2000, 1500), SWITCH_COST)]


CHAIN_FLOOR_SRC = os.path.join(ROOT, "tools", "torch_port_k3_chain_floor.cu")
# The chain floor's reductions, by chain_floor_run's variant; 0 is K3's.
CHAIN_FLOORS = ["redux.sync of the signed key, 32 lanes x 2",
                "redux.sync of an unsigned key, 32 lanes x 2", "shuffles, 32 lanes x 2",
                "shuffles, 16 lanes x 4", "shuffles, 8 lanes x 8", "shuffles, 4 lanes x 16"]


def start_chain_floor_build():
    """Start nvcc on K3's chain-floor kernel into build/kernels/; return
    (library path, process) for load_chain_floor."""
    from playaid_core_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "libviterbi_chain_floor.so"
    return lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                  CHAIN_FLOOR_SRC], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load_chain_floor(build):
    """chain_floor_run of the library start_chain_floor_build makes, once
    nvcc has ended; raises if it failed."""
    lib, proc = build
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {CHAIN_FLOOR_SRC}:\n{out}")
    fn = ctypes.CDLL(str(lib)).chain_floor_run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chain_floor(torch, fn, steps, variant=0, iters=20):
    """(cycles a step by clock64(), microseconds a step by CUDA events over
    iters launches) of one warp running steps - 1 dependent steps of the
    chain floor's reduction `variant` (0: K3's)."""
    from playaid_core_torch.ops import _build

    table = torch.log_softmax(torch.randn(64, 64, generator=torch.Generator().manual_seed(0)),
                              dim=1).cuda()
    out = torch.empty(32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(_):
        _build.check(fn(variant, table.data_ptr(), steps, SWITCH_COST, out.data_ptr(),
                        cycles.data_ptr(), stream), "chain_floor_run")

    ms = time_cuda(torch, run, iters)
    return int(cycles.item()) / (steps - 1), ms * 1e3 / (steps - 1)


def taps(origin, side, length, size):
    """The distinct in-source bilinear tap indices along one axis of a
    window (origin, side) resampled to size, side clamped to at least 1."""
    i = np.arange(size, dtype=np.float32)
    src = np.float32(origin) + (i + 0.5) * np.float32(max(side, 1)) / size - 0.5
    src = src[(src >= -1) & (src <= length)]
    t = np.concatenate([np.floor(src), np.floor(src) + 1])
    return np.unique(t[(t >= 0) & (t < length)]).astype(np.int64)


def touched_bytes(y0, x0, side, h, w, size):
    """Source bytes the crops of windows (y0, x0, side) of an h x w source
    need: per crop, the distinct rows times the distinct columns of
    in-frame bilinear taps, times 3 channels."""
    side = np.asarray(side, np.float32)
    return sum(len(taps(y0[q], side[q], h, size)) * len(taps(x0[q], side[q], w, size)) * 3
               for q in range(len(side)))


def bank_touched_bytes(rows, origins, flip, h, w, c, size):
    """Source bytes the bank entry needs: each distinct bank row's pixels
    that any of its crops taps (mirrored crops tap mirrored columns), read
    once, times c channels."""
    total = 0
    for row in np.unique(rows):
        mask = np.zeros((h, w), bool)
        for q in np.flatnonzero(rows == row):
            y0, x0, side = origins[q]
            xs = taps(x0, side, w, size)
            mask[np.ix_(taps(y0, side, h, size), w - 1 - xs if flip[q] else xs)] = True
        total += int(mask.sum()) * c
    return total


def crop_touched_bytes(boxes, h, w, size, padding):
    """touched_bytes of the boxes' square windows (square_window_params)."""
    boxes = boxes.astype(np.float32)
    cx = np.floor(boxes[:, 0] * np.float32(w))
    cy = np.floor(boxes[:, 1] * np.float32(h))
    half = np.floor(np.maximum(np.floor(boxes[:, 2] * np.float32(w)),
                               np.floor(boxes[:, 3] * np.float32(h))) / 2)
    return touched_bytes(cy - half - padding, cx - half - padding, 2 * (half + padding),
                         h, w, size)


# The scripted match of phase 8's log: motion kinds whose params_labels.csv
# entries name these moves (game_data/params_labels.csv), fighter enums
# (game_data/fighters.json), and the camera and stage of
# tests/synthlog.py's records.
MOTION_KIND = {"Wait": 19292652517, "ForwardSmash": 39434321014, "Jab": 44474425470,
               "DashAttack": 49064254701, "Damaged": 26068145260, "TechRoll": 65401729311,
               "LedgeHang": 45039193950, "LedgeNormalGetUp": 127456238928}
FIGHTER_ENUM = {"Byleth": 86, "Pikachu": 8}
LOG_STAGE = 86
LOG_GAP_AT, LOG_GAP_SIZE = 200, 2  # frames dropped from the file, repaired on parse
P0_MOVES = ("Wait", "ForwardSmash", "Wait", "Jab", "DashAttack", "Wait")
P1_MOVES = ("Wait", "Damaged", "TechRoll", "Wait", "LedgeHang", "LedgeNormalGetUp")


def log_record(i, fighter_id, name, action, pos_x, pos_y, damage):
    """One ult_logger line's record, with tests/synthlog.py's fields."""
    return {
        "animation_frame_num": 0, "attack_connected": False, "camera_fov": 30.0,
        "camera_position": {"x": 0.0, "y": 14.0, "z": 167.24},
        "camera_target_position": {"x": 0.0, "y": 11.85, "z": 0.0},
        "can_act": True, "damage": damage, "facing": 1.0 if fighter_id == 0 else -1.0,
        "fighter_id": fighter_id, "fighter_name": FIGHTER_ENUM[name], "hitstun_left": 0.0,
        "motion_kind": MOTION_KIND[action], "num_frames_left": 25200 - i, "pos_x": pos_x,
        "pos_y": pos_y, "shield_size": 50.0, "stage_id": LOG_STAGE, "status_kind": 0,
        "stock_count": 3,
    }


def write_match_log(path, num_frames):
    """A scripted two-fighter match, one JSON line per fighter per frame:
    the fighters walk towards each other and back, cycle through their
    moves every 40 frames, and frames LOG_GAP_AT.. are missing from the
    file while num_frames_left keeps counting (the parser repeats the
    frame before the gap)."""
    with open(path, "w") as f:
        for i in range(num_frames):
            if LOG_GAP_AT <= i < LOG_GAP_AT + LOG_GAP_SIZE:
                continue
            t = i / num_frames
            sway = 12.0 * np.sin(2 * np.pi * t)
            recs = (log_record(i, 0, "Byleth", P0_MOVES[(i // 40) % len(P0_MOVES)],
                               -30.0 + sway, 4.0 * abs(np.sin(6 * np.pi * t)), 0.0),
                    log_record(i, 1, "Pikachu", P1_MOVES[(i // 40) % len(P1_MOVES)],
                               30.0 - sway, 0.0, 2.5 * (i // 40)))
            for rec in recs:
                f.write(json.dumps(rec) + "\n")


class LogClipCapture:
    """Stand-in frame source behind video/reader.open_capture:
    1080p BGR frames of noise with two discs at the log's boxes, rendered
    into one buffer per capture (seek / read / release, as cv2's)."""

    def __init__(self, boxes):
        self.boxes = boxes
        self.pos = 0
        self.base = noise_background()
        self.frame = np.empty_like(self.base)
        r = DISC_RADIUS
        yy, xx = np.ogrid[-r:r + 1, -r:r + 1]
        self.disc = yy ** 2 + xx ** 2 <= r * r

    def seek(self, index):
        self.pos = index

    def read(self):
        if self.pos >= len(self.boxes):
            return False, None
        frame, r = self.frame, DISC_RADIUS
        frame[:] = self.base
        for box, colour in zip(self.boxes[self.pos], ((0, 200, 255), (255, 80, 0))):
            cx = min(max(int(box[0] * WIDTH), r), WIDTH - r - 1)
            cy = min(max(int(box[1] * HEIGHT), r), HEIGHT - r - 1)
            frame[cy - r:cy + r + 1, cx - r:cx + r + 1][self.disc] = colour
        self.pos += 1
        return True, frame

    def release(self):
        pass


def keep_input(seen):
    """A forward hook that keeps the module's first input of its first call
    in seen["x"].  It returns None: a hook's return value would replace the
    module's output."""
    def hook(module, inp, out):
        seen.setdefault("x", inp[0])
    return hook


def k2_ref_args(block, x_nchw):
    """residual_block_ref's arguments for a BasicBlock and its NCHW input:
    (x NHWC, conv1 HWIO, folded bn1 scale and bias, conv2, bn2)."""
    from playaid_core_torch.models.resnet import fold_batch_norm

    s1, b1 = fold_batch_norm(block.bn1)
    s2, b2 = fold_batch_norm(block.bn2)
    return (x_nchw.permute(0, 2, 3, 1).contiguous(),
            block.conv1.weight.permute(2, 3, 1, 0).contiguous(), s1, b1,
            block.conv2.weight.permute(2, 3, 1, 0).contiguous(), s2, b2)


def k2_yardsticks(torch, block, x, k2_args, pack):
    """K2's call ms on layer4[1]'s pack and input x (NCHW), its plain
    version's and the cuDNN chain's (conv -> bn -> relu -> conv -> bn -> add
    -> relu, TF32 off) on the same input, and the least time the card could
    take: 3xTF32 operations at the TF32 peak, or the bytes (each input read
    once, the output written once), the larger."""
    import torch.nn.functional as F

    from playaid_core_torch.device import full_float32
    from playaid_core_torch.ops.conv_block import residual_block_packed, residual_block_ref

    x_nhwc = k2_args[0]
    x_nchw = x.contiguous()
    bn = (block.bn1, block.bn2)

    def cudnn_chain(_):
        y = F.conv2d(x_nchw, block.conv1.weight, padding=1)
        y = torch.relu(F.batch_norm(y, bn[0].running_mean, bn[0].running_var, bn[0].weight,
                                    bn[0].bias, False, 0.0, bn[0].eps))
        y = F.conv2d(y, block.conv2.weight, padding=1)
        y = F.batch_norm(y, bn[1].running_mean, bn[1].running_var, bn[1].weight, bn[1].bias,
                         False, 0.0, bn[1].eps)
        return torch.relu(y + x_nchw)

    with torch.inference_mode():
        ms = time_cuda(torch, lambda _: residual_block_packed(x_nhwc, pack), 40)
        plain_ms = time_cuda(torch, lambda _: residual_block_ref(*k2_args), 20)
        with full_float32():
            library_ms = time_cuda(torch, cudnn_chain, 40)
    m, c = x_nhwc.shape[0] * x_nhwc.shape[1] * x_nhwc.shape[2], x_nhwc.shape[3]
    flops = 2 * 2 * m * c * 9 * c
    nbytes = 2 * m * c * 4 + 2 * 9 * c * c * 4 + 4 * c * 4
    bound_ms = max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "gflop": flops / 1e9}


def k2_shape_inputs(torch, shape, dev, seed=0):
    """residual_block_ref's float32 arguments for a block of ``shape``
    [B, H, W, C], drawn on ``dev`` from ``seed``: x as a ReLU's output, He-scaled
    weights, folded scales in [0.5, 1.5] and biases of 0.1."""
    b, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=g, device=dev))
    w1, w2 = (torch.randn((3, 3, c, c), generator=g, device=dev) * (2 / (9 * c)) ** 0.5
              for _ in range(2))
    s1, s2 = (torch.rand(c, generator=g, device=dev) + 0.5 for _ in range(2))
    b1, b2 = (torch.randn(c, generator=g, device=dev) * 0.1 for _ in range(2))
    return x, w1, s1, b1, w2, s2, b2


def k2_cudnn_chain(torch, x_nchw, args):
    """The block on cuDNN from residual_block_ref's arguments: conv -> bn ->
    relu -> conv -> bn -> add -> relu on the NCHW input, batch norm as the
    model runs it, on statistics that fold to the scales and biases."""
    import torch.nn.functional as F

    _, w1, s1, b1, w2, s2, b2 = args
    mean, var = torch.zeros_like(s1), torch.full_like(s1, 1 - 1e-5)
    y = F.conv2d(x_nchw, w1.permute(3, 2, 0, 1), padding=1)
    y = torch.relu(F.batch_norm(y, mean, var, s1, b1, False, 0.0, 1e-5))
    y = F.batch_norm(F.conv2d(y, w2.permute(3, 2, 0, 1), padding=1), mean, var, s2, b2, False,
                     0.0, 1e-5)
    return torch.relu(y + x_nchw)


def k2_launch_sweep(torch, x, pack):
    """Every launch K2 takes (tile rows, tile channels, depth split) on x
    [B, H, W, C] and its pack: mean ms a call by CUDA events over
    back-to-back calls, keyed "rowsxchannelsxsplit"."""
    from playaid_core_torch.ops import _build
    from playaid_core_torch.ops.conv_block import TILES, _library

    b, h, w, c = x.shape
    mid, out = torch.empty_like(x), torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, pack.w1, pack.s1, pack.b1, pack.w2, pack.s2, pack.b2,
                                   mid, out)]
    fn, stream = _library(x.dtype), _build.current_stream(x.device)
    times = {}
    for bm, bn in TILES:
        if c % bn:
            continue
        for split in (1, 2):
            def call(_):
                _build.check(fn(*ptrs, b, h, w, c, bm, bn, split, 0, stream), "residual_block")

            times[f"{bm}x{bn}x{split}"] = time_cuda(torch, call, 20)
    return times


def k2_route_shapes(torch, dev):
    """K2 at every identity-block shape of the routes (K2_ROUTE_SHAPES),
    on seeded inputs: its launch (launch_shape), held against
    residual_block_ref, and its device ms beside the cuDNN chain's (conv ->
    bn -> relu -> conv -> bn -> add -> relu on NCHW, TF32 off) and the
    least time the card could take (3xTF32 operations at the TF32 peak, or
    the bytes, the larger).  Returns one dict a shape."""
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.ops.conv_block import (
        launch_shape,
        pack_block,
        residual_block_packed,
        residual_block_ref,
    )

    rows = []
    for shape in K2_ROUTE_SHAPES:
        b, h, w, c = shape
        with torch.inference_mode():
            args = k2_shape_inputs(torch, shape, dev)
            x = args[0]
            pack = pack_block(*args[1:])
            out = residual_block_packed(x, pack)
            nchw = residual_block_packed(x, pack, channels_first=True)
            ref = residual_block_ref(*args)
            err = float((out - ref).abs().max()) / float(ref.abs().max())
            same = bool(torch.equal(nchw, out)) and nchw.permute(0, 3, 1, 2).is_contiguous()
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            dev_ms, _ = device_ms(torch, lambda _: residual_block_packed(x, pack), 20,
                                  "conv3x3_wgmma_kernel", 2)
            nchw_ms, _ = device_ms(
                torch, lambda _: residual_block_packed(x, pack, channels_first=True), 20,
                "conv3x3_wgmma_kernel", 2)
            sweep = k2_launch_sweep(torch, x, pack)
            with full_float32():
                lib_ms, lib_kernels = span_device_ms(
                    torch, lambda _: k2_cudnn_chain(torch, x_nchw, args), 10)
        m = b * h * w
        launch = launch_shape(c, m)
        fastest = min(sweep, key=sweep.get)
        flops = 2 * 2 * m * c * 9 * c
        nbytes = 2 * m * c * 4 + 2 * 9 * c * c * 4 + 4 * c * 4
        bound_ms = max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        rows.append({"shape": list(shape), "launch": list(launch), "rel_err": err,
                     "channels_first_equal": same, "device_ms": dev_ms,
                     "channels_first_device_ms": nchw_ms, "bound_ms": bound_ms,
                     "library_ms": lib_ms, "library_kernels": lib_kernels, "launches": sweep})
        log(f"K2 at {shape}: launch {launch}, max abs err / max|ref| {err:.3e}, channels-first "
            f"output equal {same}; device {'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
            f"ms ({'not measured' if nchw_ms is None else f'{nchw_ms:.4f}'} channels first), bound "
            f"{bound_ms:.4f} ms, cuDNN chain "
            f"{'not measured' if lib_ms is None else f'{lib_ms:.4f}'} ms; every launch's call ms "
            f"{json.dumps({k: round(v, 4) for k, v in sweep.items()})}, fastest {fastest} "
            f"({sweep['x'.join(map(str, launch))] / sweep[fastest] - 1:+.1%} for the rule's)")
    return rows


# ---- K5: ResNet-50's 1x1 convolutions (csrc/conv1x1_gemm.cu) ----

K5_BATCHES = (48, 24, 7)  # a VOD chunk, a mesh replica's half of one, a dashboard sample
K5_TOL = 1e-4             # of max|ref|: K2's float32 rule for 3xTF32 products
K5_CONVS = 36             # 1x1 convolutions a ResNet-50 call runs on K5
K5_KERNEL = "conv1x1_gemm_kernel"


def k5_shapes():
    """Each 1x1 convolution the port runs on K5 in ResNet-50 (the ResFormer
    family) at CROP px once: (c_in, c_out, stride, side in, epilogue), the
    epilogue "relu" (conv1), "residual" (conv3: the block's residual, then
    the ReLU) or "none" (the projection), from portbench/k5.py."""
    from portbench import k5
    from portbench.catalog import Catalog

    shapes = []
    for conv in k5.k5_convs(Catalog().family("resformer"), CROP):
        if conv not in shapes:
            shapes.append(conv)
    return shapes


def k5_inputs(torch, dev, shape, batch, seed=0):
    """A 1x1 conv of ``shape`` (k5_shapes) with random weights and a random
    eval batch norm (scales, biases, running means and variances), drawn on
    ``dev`` from ``seed``; its input as a ReLU's output and, for
    "residual", a residual.  Returns (conv, bn, pack, x, residual)."""
    from playaid_core_torch.models.resnet import BatchNorm2d, fold_batch_norm
    from playaid_core_torch.ops.conv1x1 import pack_conv1x1

    c_in, c_out, stride, side, epilogue = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    conv = torch.nn.Conv2d(c_in, c_out, 1, stride, bias=False).to(dev)
    bn = BatchNorm2d(c_out).to(dev).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, device=dev)
                          * (2 / c_in) ** 0.5)
        bn.weight.copy_(torch.rand(c_out, generator=g, device=dev) + 0.5)
        bn.bias.copy_(torch.randn(c_out, generator=g, device=dev) * 0.1)
        bn.running_mean.copy_(torch.randn(c_out, generator=g, device=dev) * 0.2)
        bn.running_var.copy_(torch.rand(c_out, generator=g, device=dev) + 0.5)
    x = torch.relu(torch.randn((batch, c_in, side, side), generator=g, device=dev))
    s_out = (side - 1) // stride + 1
    res = None
    if epilogue == "residual":
        res = torch.relu(torch.randn((batch, c_out, s_out, s_out), generator=g, device=dev))
    return conv, bn, pack_conv1x1(conv.weight, *fold_batch_norm(bn)), x, res


def k5_cudnn_chain(torch, conv, bn, x, res, relu):
    """The convolution as the model ran it on cuDNN: conv -> bn -> (add) ->
    (relu)."""
    import torch.nn.functional as F

    y = F.batch_norm(conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                     bn.eps)
    if res is not None:
        y = y + res
    return torch.relu(y) if relu else y


def k5_launch_sweep(torch, x, pack, stride, res, relu):
    """Every launch K5 takes (tile rows, tile channels, depth split) on x
    and its pack: mean ms a call by CUDA events over back-to-back calls,
    keyed "rowsxchannelsxsplit"."""
    from playaid_core_torch.ops import _build
    from playaid_core_torch.ops.conv1x1 import SLICE_CHANNELS, SPLITS, TILES, _library

    b, c_in, h, w = x.shape
    c_out = pack.w.shape[1]
    out = torch.empty((b, c_out, (h - 1) // stride + 1, (w - 1) // stride + 1), device=x.device)
    ptrs = [t.data_ptr() for t in (x, pack.w, pack.scale, pack.bias)]
    rp = None if res is None else res.data_ptr()
    fn, stream = _library(), _build.current_stream(x.device)
    times = {}
    for bm, bn in TILES:
        for split in SPLITS:
            if c_out % bn or (split > 1 and c_in // SLICE_CHANNELS < 2 * split):
                continue

            def call(_):
                _build.check(fn(*ptrs, rp, out.data_ptr(), b, h, w, c_in, c_out, stride, bm, bn,
                                split, int(relu), stream), "conv1x1")

            times[f"{bm}x{bn}x{split}"] = time_cuda(torch, call, 20)
    return times


def k5_route_shapes(torch, dev):
    """K5 at every 1x1 shape of ResNet-50 (k5_shapes) at each batch of
    K5_BATCHES, random batch norm: its launch (launch_shape), held against
    its plain version (conv1x1_ref on the original weights and the folded
    batch norm) and against cuDNN's unfolded chain; device ms beside the
    cuDNN chain's (TF32 off) and the least time the card could take (3xTF32
    operations at the TF32 peak, or the bytes, the larger); call ms; every
    launch's call ms."""
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.ops.conv1x1 import conv1x1_packed, conv1x1_ref, launch_shape
    from portbench.k5 import conv1x1_counts

    rows = []
    for shape in k5_shapes():
        c_in, c_out, stride, side, epilogue = shape
        relu = epilogue != "none"
        for batch in K5_BATCHES:
            with torch.inference_mode():
                conv, bn, pack, x, res = k5_inputs(torch, dev, shape, batch)
                out = conv1x1_packed(x, pack, stride, res, relu)
                with full_float32():
                    ref = conv1x1_ref(x, conv.weight, pack.scale, pack.bias, stride, res, relu)
                    chain = k5_cudnn_chain(torch, conv, bn, x, res, relu)
                scale = float(ref.abs().max())
                err = float((out - ref).abs().max()) / scale
                err_chain = float((out - chain).abs().max()) / scale
                dev_ms, _ = device_ms(torch, lambda _: conv1x1_packed(x, pack, stride, res, relu),
                                      20, K5_KERNEL, 1)
                ms = time_cuda(torch, lambda _: conv1x1_packed(x, pack, stride, res, relu), 20)
                with full_float32():
                    plain_ms = time_cuda(torch, lambda _: conv1x1_ref(
                        x, conv.weight, pack.scale, pack.bias, stride, res, relu), 20)
                sweep = k5_launch_sweep(torch, x, pack, stride, res, relu)
                with full_float32():
                    lib_ms, lib_kernels = span_device_ms(
                        torch, lambda _: k5_cudnn_chain(torch, conv, bn, x, res, relu), 10)
            s_out = (side - 1) // stride + 1
            launch = launch_shape(batch * s_out * s_out, c_out, c_in)
            fastest = min(sweep, key=sweep.get)
            flops, nbytes = conv1x1_counts(batch, c_in, c_out, stride, side, epilogue)
            bound_ms = max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
            rows.append({"shape": [batch, c_in, c_out, stride, side], "epilogue": epilogue,
                         "launch": list(launch), "rel_err": err,
                         "cudnn_chain_rel_err": err_chain, "device_ms": dev_ms, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "library_ms": lib_ms,
                         "library_kernels": lib_kernels, "launches": sweep})
            fmt = (lambda v: "not measured" if v is None else f"{v:.4f}")
            log(f"K5 at B={batch} {c_in}->{c_out} stride {stride} side {side} ({epilogue}): "
                f"launch {launch}, max abs err / max|ref| {err:.3e} (against cuDNN's unfolded "
                f"chain {err_chain:.3e}); device {fmt(dev_ms)} ms, call {ms:.4f} ms, plain "
                f"version {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms, cuDNN chain {fmt(lib_ms)} ms ({lib_kernels} kernels); every "
                f"launch's call ms {json.dumps({k: round(v, 4) for k, v in sweep.items()})}, "
                f"fastest {fastest} "
                f"({sweep['x'.join(map(str, launch))] / sweep[fastest] - 1:+.1%} for the rule's)")
    return rows


@contextlib.contextmanager
def cudnn_bottlenecks():
    """Every Bottleneck runs as before K5: its 1x1 convolutions, batch norms,
    ReLUs and residual add on cuDNN and PyTorch's kernels (the yardstick)."""
    from playaid_core_torch.models.resnet import Bottleneck

    fused = Bottleneck.forward

    def unfused(self, x):
        import torch

        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + y)

    Bottleneck.forward = unfused
    try:
        yield
    finally:
        Bottleneck.forward = fused


def kernel_buckets(path):
    """Device ms of an exported chrome trace's kernels by kind: K5, cuDNN's
    and PyTorch's batch norm, elementwise (ReLU, add), the convolutions and
    everything else."""
    buckets = {"k5": 0.0, "batch_norm": 0.0, "elementwise": 0.0, "conv": 0.0, "other": 0.0}
    for name, cat, _, dur, _ in trace_device_events(path):
        if cat != "kernel":
            continue
        low = name.lower()
        kind = ("k5" if K5_KERNEL in name else
                "batch_norm" if "bn_fw" in low or "batch_norm" in low else
                "elementwise" if "elementwise" in low else
                "conv" if any(k in low for k in ("conv", "gemm", "fft", "xmma", "sgemm"))
                else "other")
        buckets[kind] += dur / 1e3
    return buckets


def k5_trunk(torch, dev, check):
    """ResNet-50 at a 48-crop chunk of 128 px (seeded weights, random batch
    norm), eager: K5 against the cuDNN chain (cudnn_bottlenecks); call ms
    by CUDA events, device ms by kind in one profiled call, and the outputs
    against each other."""
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.models.resnet import BatchNorm2d, init_flax_, make_resnet

    torch.manual_seed(FAMILY_SEED)
    net = init_flax_(make_resnet("resnet50", num_classes=0))
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    net = net.to(dev).eval()
    x = torch.rand((CHUNK, 3, CROP, CROP), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev)
    out, res = {}, {}
    trace = os.path.join(ROOT, "build", "smoke", "k5_trunk_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    for route in ("k5", "cudnn"):
        with (cudnn_bottlenecks() if route == "cudnn" else contextlib.nullcontext()):
            with torch.inference_mode(), full_float32():
                out[route] = net(x)
                ms = time_cuda(torch, lambda _: net(x), 10)
                with profiled(torch) as prof:
                    net(x)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(trace)
                res[route] = {"ms": ms, "device_ms": kernel_buckets(trace)}
        kinds = {k: round(v, 4) for k, v in res[route]["device_ms"].items()}
        log(f"K5 trunk: ResNet-50 at {tuple(x.shape)} {route}: call {ms:.3f} ms; device ms by "
            f"kind {json.dumps(kinds)}")
    scale = float(out["cudnn"].abs().max())
    err = float((out["k5"] - out["cudnn"]).abs().max()) / scale
    check(err <= EMBED_REL_TOL,
          f"phase 3 (c): ResNet-50 features at a 48-crop chunk, K5 against cuDNN: max abs err "
          f"/ max|ref| {err:.3e} (tol {EMBED_REL_TOL})")
    res["rel_err"] = err
    return res


def k5_embed_check(torch, dev, check):
    """The VOD path's embed of a 48-crop chunk (embed_crops_yuv) on the
    ResFormer (ResNet-50) and the CNN (ResNet-18) families: k5_convs on each
    playaid.embed span (K5_CONVS, and 0), a replay against the eager call,
    and the replayed embed's device ms a chunk beside the cuDNN chain's."""
    from playaid_core_torch import profiling
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.ops.conv1x1 import conv1x1_packed

    gen = torch.Generator().manual_seed(3)
    crops = torch.randint(0, 256, (CHUNK, CROP * CROP * 3 // 2), dtype=torch.uint8,
                          generator=gen).to(dev)
    res = {}
    for family, convs in (("resformer", K5_CONVS), ("cnn", 0)):
        pipe = BatchedActionPipeline(family=family, device=dev).init(FAMILY_SEED)
        with torch.inference_mode():
            want = pipe._embed_yuv(crops)
        before = conv1x1_packed.launches
        with profiling.recording() as rec:
            outs = []
            for _ in range(4):
                with profiling.span("playaid.embed"):
                    outs.append(pipe.embed_crops_yuv(crops))
        counts = [s.counts.get("k5_convs", 0) for s in rec.spans if s.name == "playaid.embed"]
        replays = rec.summary()["playaid.embed"].get("graph_replays", 0)
        launched = conv1x1_packed.launches - before
        same = all(torch.equal(o, want) for o in outs)
        check(counts == [convs] * 4 and launched == 4 * convs and replays == 2 and same,
              f"phase 3 (c): {family}: k5_convs on 4 playaid.embed spans {counts} (want "
              f"{convs} each), K5 launches counted {launched}, graph replays {replays} (want "
              f"2), every call equal to the eager call bit for bit: {same}")
        if family == "resformer":
            ms = time_cuda(torch, lambda _: pipe.embed_crops_yuv(crops), 20)
            with cudnn_bottlenecks():
                plain = BatchedActionPipeline(family=family, device=dev).init(FAMILY_SEED)
                for _ in range(3):
                    plain.embed_crops_yuv(crops)
                cudnn_ms = time_cuda(torch, lambda _: plain.embed_crops_yuv(crops), 20)
                with torch.inference_mode():
                    plain_out = plain._embed_yuv(crops)
            rel = float((want - plain_out).abs().max() / plain_out.abs().max())
            check(rel <= EMBED_REL_TOL,
                  f"phase 3 (c): resformer: the embed with K5 against the cuDNN chain's, max "
                  f"abs err / max|ref| {rel:.3e} (tol {EMBED_REL_TOL}); a replayed 48-crop "
                  f"chunk {ms:.3f} ms ({ms / CHUNK * 1e3:.1f} us a crop) against "
                  f"{cudnn_ms:.3f} ms ({cudnn_ms / CHUNK * 1e3:.1f} us a crop) on cuDNN")
            res = {"embed_ms": ms, "cudnn_embed_ms": cudnn_ms, "embed_rel_err": rel}
    return res


def run_k5_phase(torch, dev, check):
    """Phase 3 (c): K5 at every ResNet-50 1x1 shape, the trunk, the embed's
    count and replay.  Returns K5's summary, which it also writes to
    build/smoke/k5_smoke.json."""
    rows = k5_route_shapes(torch, dev)
    for row in rows:
        check(max(row["rel_err"], row["cudnn_chain_rel_err"]) <= K5_TOL,
              f"phase 3 (c): K5 at {row['shape']} ({row['epilogue']}), launch "
              f"{tuple(row['launch'])}: max abs err / max|ref| {row['rel_err']:.3e}, against "
              f"cuDNN's unfolded chain {row['cudnn_chain_rel_err']:.3e} (tol {K5_TOL})")
    trunk = k5_trunk(torch, dev, check)
    embed = k5_embed_check(torch, dev, check)
    k5 = {"name": "K5 conv1x1_gemm", "source": "playaid_core_torch/csrc/conv1x1_gemm.cu",
          "replaces": None, "route_shapes": rows, "trunk": trunk, **embed}
    path = os.path.join(ROOT, "build", "smoke", "k5_smoke.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(k5, f)
    return k5


def k5_main():
    """``python3 chip_smoke.py --k5``: phase 1's kernel build and phase 3
    (c) alone; prints the card's line."""
    import torch

    sys.path.insert(0, ROOT)
    from playaid_core_torch.ops import _build

    failures = []

    def check(ok, what):
        log(f"{'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failures.append(what)

    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("built in", "entry function", "registers", "spill")):
                log(f"  {name}: {line.strip()}")
    run_k5_phase(torch, torch.device("cuda", 0), check)
    print(card, flush=True)
    if failures:
        print(f"chip_smoke --k5: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "k5_checks": "passed"}))
    return 0


# ---- K6: the Mamba-2 SSD scan (csrc/ssd_scan.cu) ----

K6_TOL = 1e-4            # of max|ref|: K6 against its twin and a float64 recurrence
K6_ROWS = 5632           # a fighter's 5,400 rows of a 10,800-frame VOD at stride 2, in 22 chunks
K6_KERNEL = "ssd_scan_"  # its four kernels
K6_SLICE = (1024, 8)     # rows (four chunks) and heads of the float64 recurrence's slice
K6_CONF_TOL = 3e-5       # points: the cell's conf_err limit (limits/granite-h-micro.match-seq.json)


def granite_config():
    with open(os.path.join(ROOT, "portbench", "configs", "granite-h-micro.json")) as f:
        return json.load(f)


def k6_inputs(torch, dev, rows=K6_ROWS, seed=0):
    """The scan's inputs at the cell's widths (64 heads of 64, state 128,
    one group), as the Granite mixer hands them to K6: x, B and C strided
    views of one [2, rows, 4352] SiLU output; dt the softplus of a draw
    plus Mamba-2's initial dt_bias; A uniform in [-16, -1]; D 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    heads, p, n = 64, 64, 128
    xbc = torch.nn.functional.silu(torch.randn(2, rows, heads * p + 2 * n, generator=gen,
                                               device=dev))
    xs, bm, cm = xbc.split([heads * p, n, n], dim=-1)
    u = torch.rand(2, heads, generator=gen, device=dev)
    dt0 = torch.exp(u[1] * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.nn.functional.softplus(
        torch.randn(2, rows, heads, generator=gen, device=dev) * 0.5 + dt_bias)
    return (xs.view(2, rows, heads, p), dt, -(1 + 15 * u[0]), bm.view(2, rows, 1, n),
            cm.view(2, rows, 1, n), torch.ones(heads, device=dev))


def _rel(out, ref):
    return float((out.double() - ref.double()).abs().max() / ref.double().abs().max())


def k6_checks(torch, dev, check):
    """Phase 3 (d) (a)-(c): K6 against its twin at the cell's shapes, at a
    length that is no whole chunk, and on a slice against the reference's
    recurrence in float64."""
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.ops.ssd_scan import ssd_scan, ssd_scan_ref
    from portbench.catalog import Catalog

    family = Catalog().family("granite_hybrid")
    out = {}
    with torch.no_grad(), full_float32():
        args = k6_inputs(torch, dev)
        k6 = ssd_scan(*args)
        twin = ssd_scan_ref(*args)
        out["twin_rel_err"] = _rel(k6, twin)
        check(out["twin_rel_err"] <= K6_TOL,
              f"phase 3 (d): K6 at [2, {K6_ROWS}] x 64 heads x 64, state 128: max abs err / "
              f"max|twin| {out['twin_rel_err']:.3e} (tol {K6_TOL}); max|y| "
              f"{float(twin.abs().max()):.3f}")
        short = k6_inputs(torch, dev, rows=700, seed=1)
        out["padded_rel_err"] = _rel(ssd_scan(*short), ssd_scan_ref(*short))
        check(out["padded_rel_err"] <= K6_TOL,
              f"phase 3 (d): K6 at 700 rows (padded to 768): max abs err / max|twin| "
              f"{out['padded_rel_err']:.3e} (tol {K6_TOL})")
        rows, heads = K6_SLICE
        x, dt, a, b, c, d = args
        sl = (x[:, :rows, :heads], dt[:, :rows, :heads], a[:heads], b[:, :rows], c[:, :rows],
              d[:heads])
        ref64 = family.ssd_recurrence(*(t.double() for t in sl))
        out["slice_k6_rel_err"] = _rel(ssd_scan(*sl), ref64)
        out["slice_twin_rel_err"] = _rel(ssd_scan_ref(*sl), ref64)
        out["slice_ref32_rel_err"] = _rel(family.ssd_recurrence(*sl), ref64)
        check(max(out["slice_k6_rel_err"], out["slice_twin_rel_err"]) <= K6_TOL,
              f"phase 3 (d): the slice [2, {rows}] x {heads} heads against the reference's "
              f"recurrence in float64: K6 {out['slice_k6_rel_err']:.3e}, twin "
              f"{out['slice_twin_rel_err']:.3e}, the float32 recurrence "
              f"{out['slice_ref32_rel_err']:.3e} of max|ref| (tol {K6_TOL})")
    return out


def k6_timing(torch, dev):
    """Phase 3 (d) (d): K6 at the cell's shapes beside the eager chunked
    form (its twin): call ms (CUDA events), device ms (the trace), and the
    least time from shapes (portbench/k6.py)."""
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.ops.ssd_scan import ssd_scan, ssd_scan_ref
    from portbench import k6, roofline

    args = k6_inputs(torch, dev)
    flops, nbytes = k6.ssd_counts(2 * K6_ROWS, granite_config())
    with torch.no_grad(), full_float32():
        k6_call = time_cuda(torch, lambda _: ssd_scan(*args), 20)
        k6_dev, per_call = device_ms(torch, lambda _: ssd_scan(*args), 10, K6_KERNEL, 4)
        twin_call = time_cuda(torch, lambda _: ssd_scan_ref(*args), 5, warmup=1)
        twin_dev, twin_kernels = span_device_ms(torch, lambda _: ssd_scan_ref(*args), 3, warmup=1)
    least = roofline.least_s(flops, nbytes) * 1e3
    res = {"k6_call_ms": k6_call, "k6_device_ms": k6_dev, "k6_kernels_per_call": per_call,
           "twin_call_ms": twin_call, "twin_device_ms": twin_dev,
           "twin_kernels_per_call": twin_kernels, "bound_ms": least,
           "bound": "bytes" if nbytes / PEAK_HBM_BYTES > flops / PEAK_TF32_FLOPS else "operations",
           "flops": flops, "bytes": nbytes,
           "roofline_pct": 100 * least / k6_dev if k6_dev else None}
    log(f"K6 at [2, {K6_ROWS}] x 64 x 64, state 128 (one layer): call {k6_call:.4f} ms, device "
        f"{k6_dev} ms ({per_call} kernels a call); the eager chunked form: call "
        f"{twin_call:.4f} ms, device {twin_dev} ms ({twin_kernels} kernels a call); bound "
        f"{least:.4f} ms ({res['bound']}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return res


@contextlib.contextmanager
def granite_sizes(sizes):
    """``models/granite_hybrid.PUBLISHED`` updated with ``sizes`` while the
    block runs: the head that ``BatchedActionPipeline`` makes then."""
    from playaid_core_torch.models import granite_hybrid

    published = granite_hybrid.PUBLISHED
    granite_hybrid.PUBLISHED = dict(published, **sizes)
    try:
        yield granite_hybrid.PUBLISHED
    finally:
        granite_hybrid.PUBLISHED = published


def k6_head_check(torch, dev, check):
    """Phase 3 (d) (e): a small Granite head whose Mamba-2 layers have the
    published head and state sizes (so K6 runs them), through
    ``classify_buffer`` on the card: ssd_layers on its playaid.head span,
    its labels against the reference's Viterbi decode of the reference's
    log-probs, and its confidences against 100 exp of those log-probs."""
    from playaid_core_torch import profiling
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from portbench.catalog import Catalog
    from portbench.reference import ops as ref_ops

    rows = 600
    with granite_sizes({"hidden_size": 256, "layer_types": ["mamba", "attention", "mamba"],
                        "shared_intermediate_size": 512, "num_attention_heads": 4,
                        "num_key_value_heads": 2, "mamba_n_heads": 8}) as small:
        pipe = BatchedActionPipeline(family="granite_hybrid", device=dev)
    config = dict(granite_config(), **small)
    family = Catalog().family("granite_hybrid")
    sd = family.weights(config, 7, dev, ROOT)
    pipe.load_state_dicts(sd)
    seq = 3 * torch.randn(2, rows, 512, generator=torch.Generator(device=dev).manual_seed(8),
                          device=dev)
    buf = pipe.make_embedding_buffer(rows)
    buf[:2 * rows] = seq.transpose(0, 1).reshape(-1, 512)
    with torch.no_grad():
        ref = family.sequence_head(seq, sd["head"], config).cpu().numpy()
    out = {}
    for cost in (0.05, 16.0):
        with profiling.recording() as rec:
            labels, conf = pipe.classify_buffer(buf, rows, decode="viterbi", switch_cost=cost)
        head = [s.counts for s in rec.spans if s.name == "playaid.head"]
        want = ref_ops.viterbi(ref, cost).T
        labels = labels.cpu().numpy()
        mismatch = int((labels != want).sum())
        at = ref[np.arange(2)[None, :], np.arange(rows)[:, None], labels]
        conf_err = float(np.abs(conf.cpu().numpy() - 100 * np.exp(at.astype(np.float64))).max())
        check(head == [{"windows": 2 * 768, "positions": 2 * 768, "ssd_layers": 2}],
              f"phase 3 (d): a small Granite head through classify_buffer on the card: its "
              f"playaid.head counts {head} (want 768 positions a fighter and 2 Mamba-2 layers "
              f"on K6)")
        check(mismatch == 0 and conf_err <= K6_CONF_TOL,
              f"phase 3 (d): its Viterbi labels at {cost} nats against the reference's decode "
              f"of the reference's log-probs: {mismatch} of {labels.size} differ "
              f"({int((np.diff(want, axis=0) != 0).sum())} label changes in the reference's); "
              f"confidence max abs err {conf_err:.3e} points (tol {K6_CONF_TOL})")
        out[f"head_counts_{cost:g}"] = head
        out[f"head_label_mismatch_{cost:g}"] = mismatch
        out[f"head_conf_err_{cost:g}"] = conf_err
    return out


def run_k6_phase(torch, dev, check):
    """Phase 3 (d): K6 against its twin and the reference's recurrence, its
    timing beside the eager chunked form, and a small head through it.
    Returns K6's summary, which it also writes to build/smoke/k6_smoke.json."""
    res = {"name": "K6 ssd_scan", "source": "playaid_core_torch/csrc/ssd_scan.cu",
           **k6_checks(torch, dev, check), **k6_timing(torch, dev),
           **k6_head_check(torch, dev, check)}
    path = os.path.join(ROOT, "build", "smoke", "k6_smoke.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f)
    return res


def k6_main():
    """``python3 chip_smoke.py --k6``: phase 1's kernel build and phase 3
    (d) alone; prints the card's line and K6's summary."""
    import torch

    sys.path.insert(0, ROOT)
    from playaid_core_torch.ops import _build

    failures = []

    def check(ok, what):
        log(f"{'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failures.append(what)

    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("built in", "entry function", "registers", "spill")):
                log(f"  {name}: {line.strip()}")
    res = run_k6_phase(torch, torch.device("cuda", 0), check)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    if failures:
        print(f"chip_smoke --k6: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "k6_checks": "passed"}))
    return 0


def bf16_ulps(out, ref):
    """Largest |out - ref| in bf16 ulps of max(|ref|, max|ref| / 64)."""
    mag = np.maximum(np.abs(ref), np.abs(ref).max() / 64)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(out - ref) / ulp).max())


LAYOUT_KEYS = ("nhwcToNchw", "nchwToNhwc", "NHWC", "yuv420_unpack_kernel", "crop_resize_kernel")


def layout_ms(ms_by_name):
    """Device ms of the layout conversions cuDNN runs, and of K1 and K4 that
    feed the stem, by fragment of the kernels' names."""
    return {key: sum(ms for name, ms in ms_by_name.items() if key in name)
            for key in LAYOUT_KEYS}


def profile_slice(torch, run_slice, slice_s):
    """Device time by kernel over one more run of the slice, and the layout
    kernels' ms by name fragment (None when the profiler cannot trace the
    card; reported here)."""
    try:
        with profiled(torch) as prof:
            t0 = time.perf_counter()
            run_slice()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only (kernels, copies): the operators above
        # them carry the same time again.
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type != torch.autograd.DeviceType.CPU
                and e.self_device_time_total > 0]
    except Exception as e:  # noqa: BLE001 - reported; the layout check then fails
        log(f"profile: torch.profiler failed: {e!r}")
        return None
    busy_ms = sum(ms for _, ms, _ in rows)
    log(f"profile: slice wall {wall_ms:.1f} ms under the profiler ({slice_s * 1e3:.1f} ms "
        f"without), device busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of wall")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:14]:
        log(f"profile: {ms:9.3f} ms {count:6d} x  {key[:100]}")
    layout = layout_ms({key: ms for key, ms, _ in rows})
    log(f"phase 4 profile: ms by name fragment over the slice {json.dumps(layout)}")
    return layout


GRAPH_CALLS = 6  # replays of graph_replay_check's profiled run
K2_KERNELS = 2   # kernels a K2 call launches: its two convolutions


def graph_kernels(path):
    """What an exported chrome trace says of CUDA graph launches: how many
    cudaGraphLaunch calls, and the K2, K4 and K5 kernels that carry the
    correlation id of one of them or of any other call."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    graph = {e.get("args", {}).get("correlation") for e in events
             if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaGraphLaunch"}
    found = {"launches": len(graph), "k2": 0, "k4": 0, "k5": 0, "k2_other": 0, "k4_other": 0,
             "k5_other": 0}
    for e in events:
        name = e.get("name", "")
        kind = ("k2" if "conv3x3_wgmma_kernel" in name else
                "k4" if "yuv420_unpack_kernel" in name else
                "k5" if K5_KERNEL in name else None)
        if e.get("cat") == "kernel" and kind:
            under = e.get("args", {}).get("correlation") in graph
            found[kind if under else kind + "_other"] += 1
    return found


def graph_replay_check(torch, check, phase, pipe, crops, blocks, convs=0):
    """embed_crops_yuv's CUDA graph at the shape of crops: GRAPH_CALLS
    replays under the profiler, each equal bit for bit to the eager call,
    and what they count (graph_replays, k2_blocks, k5_convs, the wrappers'
    launches: the capture's tally, re-added at each replay) held against
    the K2, K4 and K5 kernels that the trace shows under the graph's
    launches: a K2 call (one block, one count) is K2_KERNELS kernels, a K5
    call (one 1x1 convolution) one."""
    from playaid_core_torch import profiling
    from playaid_core_torch.ops.conv1x1 import conv1x1_packed
    from playaid_core_torch.ops.conv_block import residual_block_packed
    from playaid_core_torch.ops.yuv import yuv420_to_rgb

    with torch.inference_mode():
        want = pipe._embed_yuv(crops)
    for _ in range(2):  # the shape twice in a row: held, or captured now
        pipe.embed_crops_yuv(crops)
    before = (yuv420_to_rgb.launches, residual_block_packed.launches, conv1x1_packed.launches)
    trace = os.path.join(ROOT, "build", "smoke", f"graph_trace_{phase.replace(' ', '_')}.json")
    with profiled(torch) as prof, profiling.recording() as rec:
        outs = []
        for _ in range(GRAPH_CALLS):
            with profiling.span("playaid.embed"):
                outs.append(pipe.embed_crops_yuv(crops))
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    summary = rec.summary()["playaid.embed"]
    counted = {"graph_replays": summary.get("graph_replays", 0),
               "k2_blocks": summary.get("k2_blocks", 0),
               "k5_convs": summary.get("k5_convs", 0),
               "k4_launches": yuv420_to_rgb.launches - before[0],
               "k2_launches": residual_block_packed.launches - before[1],
               "k5_launches": conv1x1_packed.launches - before[2]}
    traced = graph_kernels(trace)
    n = GRAPH_CALLS
    same = all(torch.equal(out, want) for out in outs)
    check(same, f"{phase}: {n} replays of embed_crops_yuv's graph at {tuple(crops.shape)} "
          f"equal to the eager call bit for bit")
    check(counted == {"graph_replays": n, "k2_blocks": blocks * n, "k5_convs": convs * n,
                      "k4_launches": n, "k2_launches": blocks * n, "k5_launches": convs * n}
          and traced == {"launches": n, "k2": K2_KERNELS * blocks * n, "k4": n,
                         "k5": convs * n, "k2_other": 0, "k4_other": 0, "k5_other": 0},
          f"{phase}: the replays counted {counted}; their trace shows {traced} (K2, K4, K5 "
          f"kernels under a cudaGraphLaunch's correlation id, and under any other call); "
          f"{blocks} K2 calls of {K2_KERNELS} kernels, {convs} K5 calls and 1 K4 a replay")


def run_vod_phase(torch, dev, check, boxes_all, stand_in, wrappers):
    """Phase 6: VodAnalyzer.analyze on the headline configuration.  Returns
    each wrapper's launches during the timed run."""
    from playaid_core_torch import profiling
    from playaid_core_torch.convert import load_npz_tree
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.infer.vod_pipeline import VodAnalyzer

    clip = "disc_clip.mp4"  # the stand-in serves it; no file is read
    kw = dict(decode_backend="native", transfer_format="yuv420", stride=STRIDE, chunk=CHUNK,
              switch_cost=SWITCH_COST)
    log("phase 6: decoder: stand-in (the card's machine has no libavcodec)")
    t0 = time.perf_counter()
    stand_in.decode_crops(0, boxes_all, CROP, PADDING, stride=STRIDE, fmt="yuv420", dense=True)
    log(f"phase 6: stand-in crops of {NUM_FRAMES} frames made in "
        f"{time.perf_counter() - t0:.1f} s (set-up, not timed)")

    pipe = BatchedActionPipeline(device=dev)
    argmax = VodAnalyzer(pipe, variables=load_npz_tree(ASSET), decode="argmax", **kw)
    tensors = (list(pipe.embed.parameters()) + list(pipe.embed.buffers())
               + list(pipe.head.parameters()) + list(pipe.head.buffers()))
    check(all(t.is_cuda for t in tensors) and not any(
        isinstance(v, np.ndarray) for v in vars(argmax).values()),
        f"phase 6: all {len(tensors)} weight tensors of the pipeline on {dev}, no host copy kept")
    viterbi = VodAnalyzer(pipe, decode="viterbi", **kw)
    first = argmax.analyze(clip, boxes_all)
    for w in wrappers:
        w.launches = 0
    with profiling.recording() as rec:
        timed = viterbi.analyze(clip, boxes_all)
    launches = [w.launches for w in wrappers]
    num_chunks = (NUM_FRAMES + CHUNK - 1) // CHUNK
    embeds = rec.summary()["playaid.embed"]
    check(embeds["count"] == num_chunks and embeds.get("k2_blocks") == K2_BLOCKS * num_chunks
          == launches[1],
          f"phase 6: k2_blocks {embeds.get('k2_blocks')} over {embeds['count']} playaid.embed "
          f"spans ({K2_BLOCKS} a chunk's embed), K2 launches {launches[1]}")
    log(f"phase 6: launches during the timed analyze: crop_resize {launches[0]} (crops are "
        f"made on the host on this path), residual_block {launches[1]}, viterbi {launches[2]}, "
        f"yuv420_unpack {launches[3]}")
    check(launches[1] > 0, "phase 6: K2 (residual_block) ran during VodAnalyzer.analyze")
    check(launches[2] == 1 and launches[3] == num_chunks,
          f"phase 6: K3 (viterbi) launched once for the one classify_buffer (both fighters), "
          f"K4 (yuv420_unpack) once a chunk: {launches[2]} and {launches[3]} of {num_chunks}")
    _, chunk_yuv = stand_in.decode_crops(0, boxes_all[:CHUNK], CROP, PADDING, stride=STRIDE,
                                         fmt="yuv420", dense=True)
    graph_replay_check(torch, check, "phase 6", pipe,
                       torch.from_numpy(chunk_yuv.reshape(CHUNK // STRIDE * 2, -1)).to(dev),
                       K2_BLOCKS)
    for name, res in (("argmax", first), ("viterbi", timed)):
        check(res["labels"].shape == (NUM_FRAMES, 2) and res["frames"] == NUM_FRAMES
              and 0 <= res["labels"].min() and res["labels"].max() < 63
              and np.isfinite(res["confidences"]).all() and res["backend"] == "native",
              f"phase 6: {name} labels {res['labels'].shape} in [0, 63), {res['frames']} frames, "
              f"backend {res['backend']}")

    # Decode alone, as bench.py's measure_decode_only_fps does.
    t0 = time.perf_counter()
    total = 0
    for c0 in range(0, NUM_FRAMES, CHUNK):
        stop = min(c0 + CHUNK, NUM_FRAMES)
        cb = np.zeros((CHUNK, 2, 4), np.float32)
        cb[:stop - c0] = boxes_all[c0:stop]
        n, _ = stand_in.decode_crops(c0, cb, CROP, PADDING, stride=STRIDE, fmt="yuv420",
                                     dense=True)
        total += min(n, stop - c0)
    decode_fps = total / (time.perf_counter() - t0)

    # One more run under the profiler: bytes sent to the card, busy share.
    trace = os.path.join(ROOT, "build", "smoke", "vod_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with profiled(torch) as prof:
        t0 = time.perf_counter()
        argmax.analyze(clip, boxes_all)
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(trace)
    events = trace_device_events(trace)
    h2d = [b for name, cat, _, _, b in events if cat == "gpu_memcpy" and "HtoD" in name]
    chunk_bytes = (CHUNK // STRIDE) * 2 * CROP * CROP * 3 // 2
    big = [b for b in h2d if b is not None and b >= 65536]
    small = sum(b for b in h2d if b is not None and b < 65536)
    check(None not in h2d and big == [chunk_bytes] * num_chunks and small < 65536,
          f"phase 6: host-to-device copies under torch.profiler: {len(big)} of >= 64 KiB "
          f"totalling {sum(big)} B = {sum(big) / num_chunks:.0f} B a chunk (the chunk's crops: "
          f"{chunk_bytes} B), {len(h2d) - len(big)} smaller ones totalling {small} B")
    busy = busy_us(events)
    by_name = {}
    for name, _, _, dur, _ in events:
        by_name[name] = by_name.get(name, 0.0) + dur
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"phase 6 profile: {us / 1e3:9.3f} ms  {name[:100]}")
    # What K4's channels-first output changes in cuDNN's choice of kernels.
    layout = layout_ms({name: us / 1e3 for name, us in by_name.items()})
    log(f"phase 6 profile: ms by name fragment over the argmax run {json.dumps(layout)}")

    # Where the Viterbi run's wall goes: a run with the card synchronised
    # where classify_buffer starts and ends (in this script only), and one
    # with a single decode worker.
    marks = {}
    classify = pipe.classify_buffer

    def timed_classify(*args, **kwargs):
        torch.cuda.synchronize()
        marks["classify_start"] = time.perf_counter()
        out = classify(*args, **kwargs)
        torch.cuda.synchronize()
        marks["classify_end"] = time.perf_counter()
        return out

    pipe.classify_buffer = timed_classify
    t0 = time.perf_counter()
    viterbi.analyze(clip, boxes_all)
    t1 = time.perf_counter()
    del pipe.classify_buffer
    log(f"phase 6: Viterbi run split at classify_buffer (card synchronised there): decode, "
        f"staging and embed of all chunks {(marks['classify_start'] - t0) * 1e3:.1f} ms, "
        f"classify_buffer {(marks['classify_end'] - marks['classify_start']) * 1e3:.1f} ms, "
        f"the rest {(t1 - marks['classify_end']) * 1e3:.1f} ms")
    with recorded_viterbi() as k3_calls:
        one = VodAnalyzer(pipe, decode="viterbi", decode_workers=1, **kw).analyze(clip,
                                                                                boxes_all)
    log(f"phase 6: the same Viterbi run with one decode worker: "
        f"{one['seconds'] * 1e3:.1f} ms = {one['fps']:.1f} frames/s")
    same, shapes = k3_against_plain(torch, k3_calls)
    check(len(k3_calls) == 1 and same,
          f"phase 6: K3 labels identical to viterbi_decode_ref on the card's own log-probs "
          f"{shapes} (that run's one launch): {same}")

    e2e_fps = timed["fps"]
    log(f"phase 6: VodAnalyzer.analyze {NUM_FRAMES} frames (Viterbi run) in "
        f"{timed['seconds'] * 1e3:.1f} ms = {e2e_fps:.1f} frames/s end to end with decode; "
        f"decode only {decode_fps:.1f} frames/s (stand-in: crops read from memory, not a "
        f"decode); ratio {e2e_fps / decode_fps:.4f}; device busy {busy / 1e3:.1f} ms of "
        f"{wall_us / 1e3:.1f} ms wall under the profiler = {busy / wall_us:.3f}; decoder stand-in")

    # The first CPU_FRAMES frames on the card and on the CPU.
    cpu_pipe = BatchedActionPipeline(device="cpu").load_variables(load_npz_tree(ASSET))
    for decode in ("argmax", "viterbi"):
        on_card = VodAnalyzer(pipe, decode=decode, **kw).analyze(clip, boxes_all[:CPU_FRAMES])
        on_cpu = VodAnalyzer(cpu_pipe, decode=decode, **kw).analyze(clip, boxes_all[:CPU_FRAMES])
        same = on_card["labels"] == on_cpu["labels"]
        line = (f"phase 6: card vs CPU {decode} labels over {CPU_FRAMES} frames agree on "
                f"{int(same.sum())}/{same.size} = {same.mean():.4f}")
        if decode == "argmax":
            check(same.mean() >= LABEL_AGREEMENT_MIN, line + f" (min {LABEL_AGREEMENT_MIN})")
        else:
            log(line)
    return launches, e2e_fps


def run_family_phase(torch, dev, check, boxes_all, stand_in, k2_wrapper):
    """Phase 7: the ResFormer and RNN families at full width, seeded random
    weights, through VodAnalyzer.analyze; card against CPU on the first
    CPU_FRAMES frames."""
    from playaid_core_torch import profiling
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.infer.vod_pipeline import VodAnalyzer

    clip = "disc_clip.mp4"
    kw = dict(decode_backend="native", transfer_format="yuv420", stride=STRIDE, chunk=CHUNK)
    n_rows = CPU_FRAMES // STRIDE
    _, yuv = stand_in.decode_crops(0, boxes_all[:CPU_FRAMES], CROP, PADDING, stride=STRIDE,
                                   fmt="yuv420", dense=True)
    flat = torch.from_numpy(yuv.reshape(n_rows * 2, -1))
    for family in ("resformer", "rnn"):
        pipe = BatchedActionPipeline(family=family, device=dev).init(FAMILY_SEED)
        cpu_pipe = BatchedActionPipeline(family=family, device="cpu").init(FAMILY_SEED)
        analyzer = VodAnalyzer(pipe, **kw)
        analyzer.analyze(clip, boxes_all)
        k2_wrapper.launches = 0
        with profiling.recording() as rec:
            res = analyzer.analyze(clip, boxes_all)
        k2 = k2_wrapper.launches
        embeds = rec.summary()["playaid.embed"]
        convs = K5_CONVS if family == "resformer" else 0
        check(embeds.get("k2_blocks", 0) == (K2_BLOCKS if family == "rnn" else 0) * embeds["count"]
              == k2 and embeds.get("k5_convs", 0) == convs * embeds["count"],
              f"phase 7: {family}: k2_blocks {embeds.get('k2_blocks', 0)} and k5_convs "
              f"{embeds.get('k5_convs', 0)} over {embeds['count']} playaid.embed spans "
              f"(ResNet-18: {K2_BLOCKS} K2 blocks a span; ResNet-50: {K5_CONVS} K5 "
              f"convolutions), K2 launches {k2}")
        check(res["labels"].shape == (NUM_FRAMES, 2) and 0 <= res["labels"].min()
              and res["labels"].max() < 63 and np.isfinite(res["confidences"]).all(),
              f"phase 7: {family}: {NUM_FRAMES} frames in {res['seconds'] * 1e3:.1f} ms = "
              f"{res['fps']:.1f} frames/s end to end; labels {res['labels'].shape} in [0, 63); "
              f"K2 launches {k2}")
        if family == "rnn":
            check(k2 > 0, "phase 7: rnn: K2 (residual_block) ran during VodAnalyzer.analyze")
        graph_replay_check(torch, check, f"phase 7: {family}", pipe,
                           flat[:CHUNK // STRIDE * 2].to(dev),
                           K2_BLOCKS if family == "rnn" else 0, convs)
        emb_card = pipe.embed_crops_yuv(flat.to(dev)).cpu()
        emb_cpu = cpu_pipe.embed_crops_yuv(flat)
        rel = float((emb_card - emb_cpu).abs().max() / emb_cpu.abs().max())
        check(tuple(emb_cpu.shape) == (n_rows * 2, pipe.embed_dim) and rel <= EMBED_REL_TOL,
              f"phase 7: {family}: card vs CPU embeddings {tuple(emb_cpu.shape)} max abs err / "
              f"max|cpu| = {rel:.3e} (tol {EMBED_REL_TOL})")
        seq = emb_cpu.reshape(n_rows, 2, -1)
        with torch.inference_mode():
            lp_card = pipe._window_log_probs(seq.to(dev), n_rows, 0).cpu()
            lp_cpu = cpu_pipe._window_log_probs(seq, n_rows, 0)
        lp_err = float((lp_card - lp_cpu).abs().max())
        check(lp_err <= LOG_PROB_TOL,
              f"phase 7: {family}: card vs CPU head log-probs {tuple(lp_cpu.shape)} from the "
              f"same embeddings, max abs err {lp_err:.3e} (tol {LOG_PROB_TOL})")


def run_log_phase(torch, dev, check, wrappers):
    """Phase 8: the log path through VodAnalyzer(host_resize=False), then
    the command line.  Returns each wrapper's launches during the timed
    analyze."""
    from playaid_core_torch.convert import load_npz_tree
    from playaid_core_torch.infer import vod_pipeline
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.infer.vod_pipeline import VodAnalyzer, boxes_from_log
    from playaid_core_torch.ontology import CLASS_ID_TO_MOVE
    from playaid_core_torch.parallel.staging import PinnedStager
    from playaid_core_torch.video import reader

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    log_path = os.path.join(work, "match_log.txt")
    write_match_log(log_path, NUM_FRAMES)
    t0 = time.perf_counter()
    boxes = boxes_from_log(log_path, parser="native")
    parse_ms = (time.perf_counter() - t0) * 1e3
    same = np.array_equal(boxes, boxes_from_log(log_path, parser="python"))
    check(boxes.shape == (NUM_FRAMES, 2, 4) and same and 0 < boxes[..., 2:].min()
          and boxes[..., :2].min() > 0 and boxes[..., :2].max() < 1,
          f"phase 8: boxes_from_log {boxes.shape} through the native parser in {parse_ms:.1f} ms "
          f"(gap of {LOG_GAP_SIZE} frames repaired), equal to the Python parser's: {same}")

    # The card's machine has no cv2: frames come from the stand-in capture.
    reader.open_capture = lambda path: LogClipCapture(boxes)
    clip = "log_clip.mp4"  # the stand-in serves it; no file is read
    win = WINDOW
    kw = dict(host_resize=False, window=win, stride=1, chunk=CHUNK, switch_cost=SWITCH_COST)
    pipe = BatchedActionPipeline(device=dev)
    argmax = VodAnalyzer(pipe, variables=load_npz_tree(ASSET), decode="argmax", **kw)
    viterbi = VodAnalyzer(pipe, decode="viterbi", **kw)
    first = argmax.analyze(clip, boxes)
    for w in wrappers:
        w.launches = 0
    timed = viterbi.analyze(clip, boxes)
    launches = [w.launches for w in wrappers]
    num_chunks = (NUM_FRAMES + CHUNK - 1) // CHUNK
    check(launches[0] == num_chunks and launches[1] > 0 and launches[2] == 1
          and launches[3] == 0,
          f"phase 8: launches during the timed analyze: K1 window entry {launches[0]} (one a "
          f"chunk: {num_chunks}), K2 residual_block {launches[1]}, K3 viterbi {launches[2]} (one "
          f"classify_buffer), K4 yuv420_unpack {launches[3]} (none on the window route)")
    for name, res in (("argmax", first), ("viterbi", timed)):
        check(res["labels"].shape == (NUM_FRAMES, 2) and res["frames"] == NUM_FRAMES
              and 0 <= res["labels"].min() and res["labels"].max() < 63
              and np.isfinite(res["confidences"]).all() and res["backend"] == "cv2",
              f"phase 8: {name} labels {res['labels'].shape} in [0, 63), {res['frames']} frames, "
              f"backend {res['backend']} (frames from the capture)")

    # Bytes sent to the card under the profiler: per chunk the windows and
    # their origins, nothing else of size, all on the staging ring's copy
    # stream (not K1's).  What the ring was handed is the cross-check.  A
    # trace short of a copy is profiled once more only when the trace shows
    # that it lost the record (a traced cudaMemcpy call with no copy on the
    # device, or a note of dropped records); a short trace without such a
    # sign fails the check.
    trace = os.path.join(work, "window_trace.json")
    win_bytes = CHUNK * 2 * win * win * 3
    org_bytes = CHUNK * 2 * 3 * 4
    to_device = PinnedStager.to_device
    for attempt in (1, 2):
        staged = []

        def counted(stager, *arrays):
            staged.append(sum(a.nbytes for a in arrays))
            return to_device(stager, *arrays)

        PinnedStager.to_device = counted
        try:
            with profiled(torch) as prof:
                t0 = time.perf_counter()
                argmax.analyze(clip, boxes)
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            PinnedStager.to_device = to_device
        prof.export_chrome_trace(trace)
        audit = trace_copy_audit(trace, "crop_resize")
        h2d = [b for b, _ in audit["h2d"]]
        big = [b for b in h2d if b is not None and b >= 65536]
        org = [b for b in h2d if b == org_bytes]
        win_streams = {s for b, s in audit["h2d"] if b == win_bytes}
        log(f"phase 8: profiled run {attempt}: {len(h2d)} host-to-device copies in the trace "
            f"({h2d.count(None)} without a size, {len(big)} of >= 64 KiB, {len(org)} of "
            f"{org_bytes} B); {audit['calls']} cudaMemcpy calls traced on the host, "
            f"{len(audit['lost'])} of them with no copy on the device; profiler notes of "
            f"dropped records: {audit['notes'] or 'none'}; the staging ring was handed "
            f"{len(staged)} chunks of {sorted(set(staged))} B")
        if len(big) == len(org) == num_chunks or not (audit["lost"] or audit["notes"]):
            break
    rest = sum(b for b in h2d if b is not None and b < 65536 and b != org_bytes)
    check(staged == [win_bytes + org_bytes] * num_chunks and None not in h2d
          and big == [win_bytes] * num_chunks and org == [org_bytes] * num_chunks
          and rest < 65536,
          f"phase 8: host-to-device copies under torch.profiler: {len(big)} of >= 64 KiB "
          f"totalling {sum(big)} B = {sum(big) / num_chunks:.0f} B a chunk (the chunk's windows: "
          f"{win_bytes} B), {len(org)} of {org_bytes} B (the origins), the rest {rest} B; "
          f"staged {len(staged)} chunks of windows and origins")
    check(len(win_streams) == 1 and audit["kernel_streams"]
          and not win_streams & audit["kernel_streams"],
          f"phase 8: the window copies ran on stream {sorted(win_streams, key=str)}, K1 on "
          f"{sorted(audit['kernel_streams'], key=str)}: the staging ring's copy stream, not K1's")
    events = trace_device_events(trace)
    busy = busy_us(events)
    by_name = {}
    for name, _, _, dur, _ in events:
        by_name[name] = by_name.get(name, 0.0) + dur
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"phase 8 profile: {us / 1e3:9.3f} ms  {name[:100]}")
    layout = layout_ms({name: us / 1e3 for name, us in by_name.items()})
    log(f"phase 8 profile: ms by name fragment over the argmax run {json.dumps(layout)}")
    check(layout["nhwcToNchw"] == 0 and layout["nchwToNhwc"] == 0
          and layout["crop_resize_kernel"] > 0,
          f"phase 8: no nhwcToNchw or nchwToNhwc kernel in the window route's trace "
          f"({layout['nhwcToNchw']:.3f}, {layout['nchwToNhwc']:.3f} ms): K1's window entry hands "
          f"the stem channels-first crops and each run of fused blocks hands cuDNN "
          f"channels-first maps ({layout['crop_resize_kernel']:.3f} ms of K1 traced)")

    # The Viterbi run split where classify_buffer starts and ends.
    marks = {}
    classify = pipe.classify_buffer

    def timed_classify(*args, **kwargs):
        torch.cuda.synchronize()
        marks["classify_start"] = time.perf_counter()
        out = classify(*args, **kwargs)
        torch.cuda.synchronize()
        marks["classify_end"] = time.perf_counter()
        return out

    pipe.classify_buffer = timed_classify
    with recorded_viterbi() as k3_calls:
        t0 = time.perf_counter()
        viterbi.analyze(clip, boxes)
        t1 = time.perf_counter()
    del pipe.classify_buffer
    same, shapes = k3_against_plain(torch, k3_calls)
    check(len(k3_calls) == 1 and same,
          f"phase 8: K3 labels identical to viterbi_decode_ref on the card's own log-probs "
          f"{shapes} (the split run's one launch): {same}")
    log(f"phase 8: Viterbi run split at classify_buffer (card synchronised there; K3's input "
        f"and labels copied by the check's recorder): decode "
        f"(stand-in capture), windows, staging, K1 and embed of all chunks "
        f"{(marks['classify_start'] - t0) * 1e3:.1f} ms, classify_buffer "
        f"{(marks['classify_end'] - marks['classify_start']) * 1e3:.1f} ms, the rest "
        f"{(t1 - marks['classify_end']) * 1e3:.1f} ms")
    # The frame source alone: the stand-in's frames and the windows cut from
    # them, on one thread.
    cap = LogClipCapture(boxes)
    t0 = time.perf_counter()
    for i in range(NUM_FRAMES):
        vod_pipeline.extract_windows(cap.read()[1], boxes[i], win, PADDING)
    source_fps = NUM_FRAMES / (time.perf_counter() - t0)
    fps = timed["fps"]
    log(f"phase 8: VodAnalyzer(host_resize=False).analyze {NUM_FRAMES} frames (Viterbi run) in "
        f"{timed['seconds'] * 1e3:.1f} ms = {fps:.1f} frames/s end to end; stand-in frames + "
        f"extract_windows alone on one thread {source_fps:.1f} frames/s; device busy "
        f"{busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall under the profiler = "
        f"{busy / wall_us:.3f}; {num_chunks} chunks of {win_bytes} B of windows")

    # The first CPU_FRAMES frames on the card and on the CPU.
    cpu_pipe = BatchedActionPipeline(device="cpu").load_variables(load_npz_tree(ASSET))
    for decode in ("argmax", "viterbi"):
        on_card = VodAnalyzer(pipe, decode=decode, **kw).analyze(clip, boxes[:CPU_FRAMES])
        on_cpu = VodAnalyzer(cpu_pipe, decode=decode, **kw).analyze(clip, boxes[:CPU_FRAMES])
        same = on_card["labels"] == on_cpu["labels"]
        line = (f"phase 8: card vs CPU {decode} labels over {CPU_FRAMES} frames agree on "
                f"{int(same.sum())}/{same.size} = {same.mean():.4f}")
        if decode == "argmax":
            check(same.mean() >= LABEL_AGREEMENT_MIN, line + f" (min {LABEL_AGREEMENT_MIN})")
        else:
            log(line)

    # The command line, in this process, through phase 6's decoder stand-in.
    ckpt = os.path.join(work, "cnn63_state.pt")
    BatchedActionPipeline(device="cpu").load_variables(load_npz_tree(ASSET)).save_checkpoint(ckpt)
    out_csv = os.path.join(work, "labels.csv")
    t0 = time.perf_counter()
    vod_pipeline.main(["--video", "disc_clip.mp4", "--log", log_path, "--checkpoint", ckpt,
                       "--stride", "2", "--out", out_csv])
    cli_s = time.perf_counter() - t0
    with open(out_csv) as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    moves = set(CLASS_ID_TO_MOVE.values())
    check(rows[0] == ["frame", "p0_action", "p0_conf", "p1_action", "p1_conf"]
          and [r[0] for r in rows[1:]] == [str(i) for i in range(NUM_FRAMES)]
          and all(r[1] in moves and r[3] in moves and 0 <= float(r[2]) <= 100
                  and 0 <= float(r[4]) <= 100 for r in rows[1:]),
          f"phase 8: command line (--stride 2, --checkpoint {os.path.basename(ckpt)}) wrote "
          f"{len(rows) - 1} CSV rows for {NUM_FRAMES} frames in {cli_s:.1f} s, moves named by "
          f"CLASS_ID_TO_MOVE ({len({r[1] for r in rows[1:]} | {r[3] for r in rows[1:]})} "
          f"distinct)")
    return launches


# The pixels-only clip of phase 9: 1280x720 frames of noise, two discs that
# cross the screen, and both HUD damage counters drawn with a 5x7 bitmap
# font (whole part large, the decimal digit small, as on the real HUD).
PIX_W, PIX_H, PIX_FRAMES, PIX_BATCH = 1280, 720, 240, 16
PIX_DISC_RADIUS, PIX_STEP = 48, 30
PIX_CPU_FRAMES = 8        # frames of the card-vs-CPU detection check
PIX_MAX_DET = 1024        # peaks a frame: class 3's best ranks 29-61 of a seeded heatmap
PIX_SEED_BOX_CELLS = 16.0  # the seeded size head's bias, in output cells
# imgproc.linear_u8_tables from 720x1280 to 256x448: column taps (int64) and
# weights (int32), 448 each; row taps and weights, 256 each.
PIX_TABLE_COPIES = [448 * 8] * 2 + [448 * 4] * 2 + [256 * 8] * 2 + [256 * 4] * 2
BOX_TOL = 1e-4            # card vs CPU detection boxes, max abs (normalised)
GLYPHS = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    "3": ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
}


def hud_values(i):
    """Both players' damage at frame i: it steps every PIX_STEP frames."""
    k = i // PIX_STEP
    return (round(4.7 * k, 1), round(12.3 + 9.1 * k, 1))


def paint_hud(frame, x0, y0, value):
    """Draw a damage value into the 133x60 HUD box at (x0, y0): the whole
    part at scale 5, the decimal digit at scale 3 on the same baseline."""
    whole, frac = f"{value:.1f}".split(".")
    x, base = x0 + 6, y0 + 50
    for text, scale in ((whole, 5), (frac, 3)):
        for ch in text:
            glyph = np.array([[c == "1" for c in row] for row in GLYPHS[ch]])
            big = np.kron(glyph, np.ones((scale, scale), bool))
            frame[base - big.shape[0]:base, x:x + big.shape[1]][big] = 255
            x += big.shape[1] + scale
        x += 4


class PixelsClipCapture:
    """Stand-in frame source behind video/reader.open_capture for
    phase 9 (seek / read / release and the stream's fps and size): each
    read renders a new frame, which the caller may keep."""

    fps, width, height, frame_count = 60.0, PIX_W, PIX_H, PIX_FRAMES

    def __init__(self):
        self.pos = 0
        self.base = np.random.default_rng(2).integers(0, 50, (PIX_H, PIX_W, 3), dtype=np.uint8)
        r = PIX_DISC_RADIUS
        yy, xx = np.ogrid[-r:r + 1, -r:r + 1]
        self.disc = yy ** 2 + xx ** 2 <= r * r

    def seek(self, index):
        self.pos = index

    def read(self):
        if self.pos >= PIX_FRAMES:
            return False, None
        from playaid_core_torch.infer.ocr import PLAYER_DAMAGE_CROPS

        i, r = self.pos, PIX_DISC_RADIUS
        frame = self.base.copy()
        x = int((0.2 + 0.6 * i / PIX_FRAMES) * PIX_W)
        for cx, cy, colour in ((x, 400, (0, 200, 255)), (PIX_W - x, 430, (255, 80, 0))):
            frame[cy - r:cy + r + 1, cx - r:cx + r + 1][self.disc] = colour
        for player, value in enumerate(hud_values(i)):
            p = PLAYER_DAMAGE_CROPS[player]
            paint_hud(frame, int((p["center_x"] - p["crop_width"] / 2) * PIX_W),
                      int((p["center_y"] - p["crop_height"] / 2) * PIX_H), value)
        self.pos += 1
        return True, frame

    def release(self):
        pass


def seeded_detector(trainer):
    """Phase 9's detector: Flax's seeded init (DetectorTrainer.init(0)), with
    two biases moved.  The seeded size head predicts boxes of about 0 cells
    (its bias is 0, as in the JAX init); a bias of 16 output cells (64 px at
    the 256x448 input) gives boxes that the character detector can cut
    crops from.  Flax zeroes each residual block's last batch-norm scale,
    which would leave layer4[1]'s second convolution out of everything K2
    is held to here; that scale is set to 1."""
    import torch

    trainer.init(0)
    with torch.no_grad():
        trainer.model.heads["size"][2].bias.fill_(PIX_SEED_BOX_CELLS)
        trainer.model.trunk.layer4[1].bn2.weight.fill_(1.0)
    return trainer


def run_pixels_phase(torch, dev, check, card, k2_wrapper):
    """Phase 9: the pixels-only path, AIRunner on frames with no log.
    Returns K2's numbers at the detector's shape and its launches, and the
    completed AIRunner (phase 14 reports on it)."""
    import shutil

    from playaid_core_torch import constants
    from playaid_core_torch.convert import load_npz_tree
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.infer.detection import CharacterDetector
    from playaid_core_torch.infer.ocr import PLAYER_DAMAGE_CROPS, segment_digit_components
    from playaid_core_torch.infer.ocr_conv import ConvDigitOCR, patch_from_component
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.infer.runner import AIRunner
    from playaid_core_torch.geometry import YoloCrop
    from playaid_core_torch.ops.conv_block import residual_block_packed, residual_block_ref
    from playaid_core_torch.train.detector_train import DetectorTrainer
    from playaid_core_torch.video import reader

    work = os.path.join(ROOT, "build", "smoke")
    constants.AI_CACHE = os.path.join(work, "ai_cache")
    shutil.rmtree(constants.AI_CACHE, ignore_errors=True)
    os.makedirs(work, exist_ok=True)
    reader.open_capture = lambda path: PixelsClipCapture()
    clip, exp = os.path.join("pixels", "clip.mp4"), os.path.join("pixels", "clip")
    det_kw = dict(classes=(2, 3), max_det=PIX_MAX_DET, batch_size=PIX_BATCH)
    # Seeded weights: every heatmap logit sits near the -2.19 prior (a
    # sigmoid of about 0.1), so the default threshold of 0.3 finds nothing;
    # 0.0 with PIX_MAX_DET candidates gives both classes their best peak.
    threshold = 0.0
    cap = PixelsClipCapture()
    frames = np.stack([cap.read()[1] for _ in range(PIX_BATCH)])
    rgb = np.ascontiguousarray(frames[..., ::-1])

    trainer = seeded_detector(DetectorTrainer(device=dev))
    cpu_trainer = seeded_detector(DetectorTrainer(device="cpu"))
    params = list(trainer.model.parameters())
    check(all(p.device.type == "cuda" for p in params),
          f"phase 9: all {len(params)} detector weight tensors on {dev} after init")

    # K2 at the detector's shape: layer4[1]'s input from this batch.
    block = trainer.model.trunk.layer4[1]
    seen = {}
    hook = block.register_forward_hook(keep_input(seen))
    trainer.detect(rgb, max_det=PIX_MAX_DET, score_threshold=threshold, classes=(2, 3))
    hook.remove()
    with torch.inference_mode(), full_float32():
        k2_args = k2_ref_args(block, seen["x"])
        x_nhwc = k2_args[0]  # [16, 8, 14, 512]
        pack = block.block_pack(torch.float32)
        k2_out = residual_block_packed(x_nhwc, pack)
        k2_ref = residual_block_ref(*k2_args)
    torch.cuda.synchronize()
    k2_err = float((k2_out - k2_ref).abs().max())
    k2_scale = float(k2_ref.abs().max())
    check(tuple(x_nhwc.shape) == (PIX_BATCH, 8, 14, 512) and k2_err <= K2_F32_REL_TOL * k2_scale,
          f"phase 9: K2 residual_block f32 at the detector's layer4[1] {tuple(x_nhwc.shape)}: "
          f"max abs err {k2_err:.3e} (tol {K2_F32_REL_TOL} x max|ref| {k2_scale:.3f})")
    k2 = k2_yardsticks(torch, block, seen["x"], k2_args, pack)
    with torch.inference_mode():
        k2_dev_ms, k2_per_call = device_ms(torch, lambda _: residual_block_packed(x_nhwc, pack),
                                           40, "conv3x3_wgmma_kernel", 2)
    log(f"phase 9: K2 f32 at {tuple(x_nhwc.shape)}: call {k2['ms']:.4f} ms, device "
        f"{'not measured' if k2_dev_ms is None else f'{k2_dev_ms:.4f} ms'} "
        f"({k2_per_call:g} of 2 kernel records a call traced), plain "
        f"{k2['plain_ms']:.4f} ms, cuDNN chain {k2['library_ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.4f} ms (3 x {k2['gflop']:.2f} GFLOP TF32); {card}")

    # Card against CPU: the same frames and seeded weights.
    on_card = trainer.detect(rgb[:PIX_CPU_FRAMES], max_det=PIX_MAX_DET, score_threshold=threshold,
                             classes=(2, 3))
    on_cpu = cpu_trainer.detect(rgb[:PIX_CPU_FRAMES], max_det=PIX_MAX_DET, score_threshold=threshold,
                                classes=(2, 3))
    # The 16 best peaks of each frame, and each class's best (the one the
    # character detector crops): identical classes, boxes within BOX_TOL.
    def best(dets):
        return [next(bx for c, _, bx in dets if c == k) for k in (2, 3)]

    same_cls = all([c for c, _, _ in a[:16]] == [c for c, _, _ in b[:16]]
                   for a, b in zip(on_card, on_cpu))
    box_err = max(float(np.abs(np.array([bx for _, _, bx in a[:16]] + best(a))
                               - np.array([bx for _, _, bx in b[:16]] + best(b))).max())
                  for a, b in zip(on_card, on_cpu))
    check(same_cls and box_err <= BOX_TOL and all(len(d) == PIX_MAX_DET for d in on_card),
          f"phase 9: card vs CPU detections on {PIX_CPU_FRAMES} frames: the 16 best peaks' "
          f"classes identical {same_cls}; their boxes and each class's best box max abs err "
          f"{box_err:.3e} (tol {BOX_TOL})")

    # Host-to-device bytes of two detect() batches of a frame size that the
    # trainer has not resized before: the frames each time, the resize
    # tables (8 small copies) only with the first, no weights and no class
    # mask (kept on the card since the warm-up); profiled in a fresh process
    # (profile_in_fresh_process).
    audit = profile_in_fresh_process("detect")
    h2d = audit["h2d"]
    big = [b for b in h2d if b is not None and b >= 65536]
    small = [b for b in h2d if b is not None and b < 65536]
    log(f"phase 9: detect() profiled in a fresh process: {len(h2d)} host-to-device copies in "
        f"the trace ({h2d.count(None)} without a size); {audit['calls']} cudaMemcpy calls "
        f"traced on the host, {audit['lost']} with no copy on the device; profiler notes of "
        f"dropped records: {audit['notes'] or 'none'}")
    check(big == [rgb.nbytes] * 2 and None not in h2d
          and sorted(small) == sorted(PIX_TABLE_COPIES),
          f"phase 9: host-to-device copies of two detect() batches under torch.profiler: "
          f"{len(big)} of >= 64 KiB = {big} B (the frames: {rgb.nbytes} B each), and "
          f"{sum(small)} B in {len(small)} small copies {sorted(small)} (the resize tables "
          f"from {PIX_H}x{PIX_W}, once: {sorted(PIX_TABLE_COPIES)})")

    # detect() alone on batches of 16.
    batches = [np.ascontiguousarray(np.stack([cap.read()[1] for _ in range(PIX_BATCH)])[..., ::-1])
               for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.detect(b, max_det=PIX_MAX_DET, score_threshold=threshold, classes=(2, 3))
    detect_fps = len(batches) * PIX_BATCH / (time.perf_counter() - t0)

    # The character detector over the clip: frames through the capture seam.
    detector = CharacterDetector(trainer, score_threshold=threshold, **det_kw)
    k2_wrapper.launches = 0
    t0 = time.perf_counter()
    detector.run(clip, exp)
    detector_s = time.perf_counter() - t0
    det_launches = k2_wrapper.launches
    check(det_launches == K2_BLOCKS * (PIX_FRAMES // PIX_BATCH),
          f"phase 9: CharacterDetector {PIX_FRAMES} frames in {detector_s * 1e3:.1f} ms = "
          f"{PIX_FRAMES / detector_s:.1f} frames/s (detect() alone {detect_fps:.1f} frames/s); K2 "
          f"launches in the trunk {det_launches} ({K2_BLOCKS} a batch of {PIX_BATCH}, one a "
          f"fused block); {card}")

    # The runner: cleanup, recognition (bench weights, crop 128), OCR, output.
    tree = load_npz_tree(ASSET)
    pipe = BatchedActionPipeline(device=dev)
    runner = AIRunner(clip, detector=detector, pipeline=pipe, variables=tree)
    t0 = time.perf_counter()
    runner.run_detection_setup()
    cleanup_s = time.perf_counter() - t0
    # The embed's layer4[1] inputs during recognition: one call a fighter.
    embed_block = pipe.embed.layer4[1]
    embed_inputs = []
    hook = embed_block.register_forward_hook(lambda m, inp, out: embed_inputs.append(inp[0]))
    k2_wrapper.launches = 0
    t0 = time.perf_counter()
    runner.run_action_recognition()
    torch.cuda.synchronize()
    recog_s = time.perf_counter() - t0
    rec_launches = k2_wrapper.launches
    hook.remove()

    # K2 at the embed's shape, 239 crops a call: 3,824 rows of 64-row tiles
    # end in a partial tile at C=512.
    embed_err, embed_shapes = 0.0, []
    with torch.inference_mode(), full_float32():
        embed_pack = embed_block.block_pack(torch.float32)
        for x in embed_inputs:
            args = k2_ref_args(embed_block, x)
            ref = residual_block_ref(*args)
            err = float((residual_block_packed(args[0], embed_pack) - ref).abs().max())
            embed_err = max(embed_err, err / float(ref.abs().max()))
            embed_shapes.append(tuple(args[0].shape))
    check(len(embed_inputs) == 2 and embed_err <= K2_F32_REL_TOL,
          f"phase 9: K2 residual_block f32 at the embed's layer4[1] {embed_shapes}: max abs err "
          f"/ max|ref| {embed_err:.3e} (tol {K2_F32_REL_TOL})")
    ocr = ConvDigitOCR(device=dev)
    t0 = time.perf_counter()
    confident = runner.run_damage_detection(ocr=ocr)
    ocr_s = time.perf_counter() - t0
    runner.write_output()
    n = runner.max_frames
    data = runner.ai_output_data
    fighters = sorted(runner.fighters)
    actions = {f: [data[f][i].action for i in range(n - 1)] for f in fighters}
    check(fighters == ["Joker", "Pikachu"] and rec_launches > 0
          and all(a in runner.actions for f in fighters for a in actions[f])
          and os.path.exists(runner.ai_output_file),
          f"phase 9: AIRunner on {n} frames: cleanup {n / cleanup_s:.1f} frames/s, recognition "
          f"{n / recog_s:.1f} frames/s (K2 launches {rec_launches}), OCR {n / ocr_s:.1f} frames/s "
          f"({confident} confident readings of {2 * n}); {card}")

    # Card against CPU: labels from the same crops, readings and digit logits.
    cpu_runner = AIRunner(clip, detector=detector,
                          pipeline=BatchedActionPipeline(device="cpu"), variables=tree)
    cpu_runner.fighters, cpu_runner.max_frames = runner.fighters, n
    cpu_runner.run_action_recognition(overwrite=True)
    cpu_data = cpu_runner.ai_output_data
    same = [data[f][i].action == cpu_data[f][i].action for f in fighters for i in range(n - 1)]
    check(np.mean(same) >= LABEL_AGREEMENT_MIN,
          f"phase 9: card vs CPU action labels agree on {sum(same)}/{len(same)} = "
          f"{np.mean(same):.4f} (min {LABEL_AGREEMENT_MIN})")
    cpu_ocr = ConvDigitOCR(device="cpu")
    reader = PixelsClipCapture()
    readings_same, patches = True, []
    for i in range(n):
        frame = reader.read()[1]
        for params in PLAYER_DAMAGE_CROPS.values():
            img = YoloCrop(**params).crop_img(frame)
            a, b = ocr(img), cpu_ocr(img)
            readings_same &= a[0] == b[0] and a[1][:2] == b[1][:2]
            patches += [patch_from_component(c) for c in segment_digit_components(img)[0]]
    patches = np.stack(patches)[..., None]
    logit_err = float(np.abs(ocr.logits(patches) - cpu_ocr.logits(patches)).max())
    values = sorted({data[f][i].damage for f in fighters for i in range(n)})
    check(readings_same and logit_err <= LOG_PROB_TOL,
          f"phase 9: card vs CPU readings of {2 * n} HUD crops identical {readings_same}; digit "
          f"logits of {len(patches)} patches max abs err {logit_err:.3e} (tol {LOG_PROB_TOL}); "
          f"smoothed values read {values[:8]}")
    return {"launches": det_launches + rec_launches, "max_abs_err": k2_err,
            "shape": list(x_nhwc.shape), "ms": k2["ms"], "device_ms": k2_dev_ms,
            "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "library_ms": k2["library_ms"],
            "embed_shapes": [list(s) for s in embed_shapes], "embed_rel_err": embed_err}, runner


# Phase 10: training on the card.  A ground-truth tree of .npy crops (the
# disc clip's BGR crops around the fighters' boxes) with seeded labels over
# the 63 classes, in runs of TRAIN_RUN frames.
TRAIN_FRAMES = {"train": 96, "validation": 48}
TRAIN_RUN = 8
TRAIN_BATCH, TRAIN_T = 8, 7
TRAIN_EPOCHS, TRAIN_STEPS = 2, 16
FAMILY_EPOCHS, FAMILY_STEPS = 2, 8
LEARN_STEPS = 20
TRAIN_LR = 3e-4
GRAD_REL_TOL = 1e-4       # card vs float64 gradients, of max|g| per tensor
LOSS_REL_TOL = 1e-5       # card vs float64 loss, relative
CKPT_LOG_PROB_TOL = 1e-5  # the checkpoint through the pipeline vs the trainer's model


TRAIN_ROOT = os.path.join(ROOT, "build", "smoke", "train_gt")
WIRE_STEPS = 20           # train steps of the profiled epoch
STEADY_STEPS = 50         # steps of the epoch that gives the steady-state rate
HOST_BATCHES = 8          # batches assembled, and steps run, alone to split a fit step


def train_actions():
    from playaid_core_torch.ontology import MOVE_TO_CLASS_ID

    return list(MOVE_TO_CLASS_ID)


def train_dataset(split, seed=0):
    """Phase 10's dataset over the tree at TRAIN_ROOT: T 7, frame deltas
    1-3, both fighters, no augmentation."""
    from playaid_core_torch.train.dataset import UltActionRecogDataset

    return UltActionRecogDataset(
        split=split, num_samples=TRAIN_BATCH * TRAIN_STEPS, img_dimension=CROP,
        anim_subset=train_actions(), num_frames_per_sample=[TRAIN_T], frame_delta=[1, 2, 3],
        char_subset=["Byleth", "Pikachu"], num_preceding_actions=0, crop_size=CROP, seed=seed,
        gt_root_train=os.path.join(TRAIN_ROOT, "train"),
        gt_root_val=os.path.join(TRAIN_ROOT, "validation"),
        gt_root_test=os.path.join(TRAIN_ROOT, "validation"))


def train_config(family, **kw):
    from playaid_core_torch.train.train import TrainerConfig

    args = dict(family=family, num_actions=len(train_actions()), sequence_length=TRAIN_T,
                batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, crop_size=CROP, warmup_steps=0)
    args.update(kw)
    return TrainerConfig(**args)


def load_bench(model, bench):
    model.embed.load_state_dict(bench["embed"])
    model.head.load_state_dict(bench["head"])


def profile_h2d(torch, run, trace):
    """Profile run() and its device work (through profiled); the trace's
    host-to-device copies, the cudaMemcpy calls traced on the host and how
    many of them have no copy on the device, notes of dropped records, and
    the device's busy time against the wall."""
    with profiled(torch) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(trace)
    audit = trace_copy_audit(trace, "conv3x3_wgmma")
    return {"h2d": [b for b, _ in audit["h2d"]], "calls": audit["calls"],
            "lost": len(audit["lost"]), "lost_at": audit["lost_at"], "notes": audit["notes"],
            "busy_us": busy_us(trace_device_events(trace)), "wall_us": wall_us}


def profile_main(kind):
    """python3 chip_smoke.py --profile detect|train|synth|detector|ocr:
    profile two detect() batches of phase 9 (after one at another frame
    size), or an epoch of WIRE_STEPS train steps of phase 10 (CNN-63 from
    the bench weights on the tree at TRAIN_ROOT), of phase 11
    (profile_synth) or of phase 12 (profile_detector), or OCR steps of phase
    14 (profile_ocr), after one unprofiled run, in this fresh
    process; print profile_h2d's result as JSON, for train and detector
    with K2's device time at the path's eval shape (k2_device_ms,
    k2_records_per_call).  Late in this
    script's long process the profiler lost the device records of large
    copies and kernels even after a leading kernel (phases 9 and 10,
    PERF.md); early in a process it had lost none
    (tools/torch_port_trace_audit.py lead)."""
    import torch

    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    work = os.path.join(ROOT, "build", "smoke")
    if kind == "detect":
        from playaid_core_torch.train.detector_train import DetectorTrainer

        trainer = seeded_detector(DetectorTrainer(device=dev))
        cap = PixelsClipCapture()
        rgb = np.ascontiguousarray(np.stack([cap.read()[1] for _ in range(PIX_BATCH)])[..., ::-1])
        kw = dict(max_det=PIX_MAX_DET, score_threshold=0.0, classes=(2, 3))
        warm = [rgb[:, :PIX_H // 2, :PIX_W // 2]]  # another size: its own tables

        def run():
            if warm:  # the unprofiled run: cuDNN, the class mask
                trainer.detect(warm.pop(), **kw)
                return
            for _ in range(2):
                trainer.detect(rgb, **kw)
    elif kind == "train":
        from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
        from playaid_core_torch.train.train import Trainer

        trainer = Trainer(train_config("cnn"), train_dataset("train"))
        trainer.init_state(0)
        load_bench(trainer.model, from_jax_cnn(load_npz_tree(ASSET)))

        def run():
            trainer.fit(num_epochs=1, steps_per_epoch=WIRE_STEPS)
    elif kind == "synth":
        return profile_synth(torch, dev, work)
    elif kind == "detector":
        print(json.dumps(profile_detector(torch, dev, work)))
        return 0
    elif kind == "ocr":
        print(json.dumps(profile_ocr(torch, dev)))
        return 0
    else:
        raise ValueError(f"--profile takes detect, train, synth, detector or ocr, not {kind!r}")
    run()
    result = profile_h2d(torch, run, os.path.join(work, f"{kind}_trace.json"))
    if kind == "train":
        from playaid_core_torch.ops.conv_block import residual_block_packed

        frames, _, _ = next(train_dataset("train", seed=1).batches(TRAIN_BATCH, 1))
        model = trainer.model.eval()
        block = model.embed.layer4[1]
        seen = {}
        hook = block.register_forward_hook(keep_input(seen))
        with torch.no_grad():
            model(torch.from_numpy(frames).to(dev).float() / 255.0)
        hook.remove()
        with torch.inference_mode():
            x_nhwc = k2_ref_args(block, seen["x"])[0]
            pack = block.block_pack(torch.float32)
            ms, traced = device_ms(torch, lambda _: residual_block_packed(x_nhwc, pack), 40,
                                   "conv3x3_wgmma_kernel", 2)
        result.update({"k2_device_ms": ms, "k2_records_per_call": traced,
                       "k2_shape": list(x_nhwc.shape)})
    print(json.dumps(result))
    return 0


def synth_profile_trainer(dev):
    """A seeded CNN-63 Trainer of 1 epoch of WIRE_STEPS steps on phase
    11's dataset, on the tree that write_synth_tree left."""
    from playaid_core_torch.train.train import Trainer

    tool = bench_tool()
    data = tool.bench_dataset(os.path.join(SYNTH_ROOT, "clean"),
                              os.path.join(SYNTH_ROOT, "stages"), SYNTH_STEPS, SYNTH_BATCH,
                              device=dev)
    trainer = Trainer(tool.bench_config(1, WIRE_STEPS, SYNTH_BATCH, device=dev,
                                        warmup_steps=SYNTH_WARMUP, verbose=False), data)
    trainer.init_state(0)
    return trainer


def profile_synth(torch, dev, work):
    """profile_main's synth kind: synth_profile_trainer, built, then a wait
    for a line "go" on stdin (so the caller can build its own meanwhile and
    keep the card to itself while this process profiles); then one
    unprofiled epoch and that epoch under profile_h2d, profiled again, up
    to SYNTH_PROFILES times, only while the trace shows a lost record.
    Prints a line an attempt and the last one's result as JSON."""
    trainer = synth_profile_trainer(dev)
    if sys.stdin.readline().strip() != "go":
        return 1

    def run():
        trainer.fit(num_epochs=1, steps_per_epoch=WIRE_STEPS)

    run()
    for attempt in range(1, SYNTH_PROFILES + 1):
        result = profile_h2d(torch, run, os.path.join(work, "synth_trace.json"))
        log(f"phase 11: profiled epoch {attempt}: {result['lost']} of {result['calls']} "
            f"cudaMemcpy calls with no copy on the device (call index, ms into the trace: "
            f"{result['lost_at']}), notes of dropped records: {result['notes'] or 'none'}")
        if not result["lost"] and not result["notes"]:
            break
    print(json.dumps(result))
    return 0


def profile_in_fresh_process(kind):
    """profile_main(kind) in a child process, waited for; its result."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile", kind],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"--profile {kind} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def write_train_tree(root, actions):
    """<root>/<split>/disc_clip/{0_byleth,1_pikachu}/{images,labels}: .npy
    BGR crops of 128 px cut from the disc clip around each fighter's box,
    and one label file a crop."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(FAMILY_SEED)
    frame = np.empty((1, HEIGHT, WIDTH, 3), np.uint8)
    for split, n in TRAIN_FRAMES.items():
        boxes = fighter_boxes(n)
        labels = rng.integers(0, len(actions), (2, (n + TRAIN_RUN - 1) // TRAIN_RUN))
        dirs = []
        for k, name in enumerate(("0_byleth", "1_pikachu")):
            base = os.path.join(root, split, "disc_clip", name)
            for sub in ("images", "labels"):
                os.makedirs(os.path.join(base, sub))
            dirs.append(base)
        for i in range(n):
            render_frames([i], n, frame)
            for k, base in enumerate(dirs):
                np.save(os.path.join(base, "images", f"{i:06d}.npy"),
                        bgr_crop(frame[0], boxes[i, k], CROP, PADDING))
                with open(os.path.join(base, "labels", f"{i:06d}.txt"), "w") as f:
                    f.write(actions[labels[k, i // TRAIN_RUN]])


def steady_steps_per_sec(torch, trainer, steps, run):
    """The steady state of ``run()``, a fit of ``steps`` calls of
    ``trainer.train_step``: timed from the call of its third step to the end
    of its last on the card."""
    step, calls = trainer.train_step, []

    def timed(*args):
        calls.append(time.perf_counter())
        out = step(*args)
        if len(calls) == steps:
            torch.cuda.synchronize()
            calls.append(time.perf_counter())
        return out

    trainer.train_step = timed
    try:
        run()
    finally:
        trainer.train_step = step
    return (steps - 2) / (calls[-1] - calls[2])


def epoch_without_validation(trainer, steps):
    """Trainer.fit for one epoch of ``steps`` steps, its validation left out."""
    val, trainer.val_dataset = trainer.val_dataset, None
    try:
        trainer.fit(num_epochs=1, steps_per_epoch=steps)
    finally:
        trainer.val_dataset = val


def run_train_phase(torch, dev, check, card, k2_wrapper):
    """Phase 10: Trainer.fit on the card for the three families at full
    width.  Returns K2's numbers at the training path's eval shape."""
    from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.ops.conv_block import residual_block_packed, residual_block_ref
    from playaid_core_torch.profiling import StageTimer
    from playaid_core_torch.train.train import (
        Trainer,
        build_model,
        create_train_state,
        make_train_step,
    )

    work = os.path.join(ROOT, "build", "smoke")
    actions = train_actions()
    t0 = time.perf_counter()
    write_train_tree(TRAIN_ROOT, actions)
    log(f"phase 10: ground-truth tree of .npy crops ({sum(TRAIN_FRAMES.values()) * 2} crops of "
        f"{CROP} px, labels over {len(actions)} classes) written in "
        f"{time.perf_counter() - t0:.1f} s")

    bench = from_jax_cnn(load_npz_tree(ASSET))
    batch_u8, _, labels = next(train_dataset("train", seed=1).batches(TRAIN_BATCH, 1))
    check(batch_u8.dtype == np.uint8 and batch_u8.nbytes == TRAIN_BATCH * TRAIN_T * CROP * CROP * 3,
          f"phase 10: a batch is {batch_u8.shape} uint8, {batch_u8.nbytes} B")

    # (a) One CNN step from the bench weights on one batch, on the card
    # against the CPU in float64, each gradient within GRAD_REL_TOL of its
    # max|g|.  The CPU in float32 is no reference: the step is
    # ill-conditioned there (PERF.md).
    runs = {}
    for key, where, dtype in (("card", dev, torch.float32),
                              ("float64", torch.device("cpu"), torch.float64)):
        model, loss_fn = build_model("cnn", len(actions), TRAIN_T)
        load_bench(model, bench)
        model.to(where, dtype)
        x_in = torch.from_numpy(batch_u8).to(where)
        if dtype == torch.float64:
            x_in = x_in.to(dtype) / 255.0
        state = create_train_state(model, TRAIN_LR, warmup_steps=0)
        out = make_train_step(model, loss_fn)(state, x_in, torch.from_numpy(labels).to(where))
        runs[key] = (float(out[0]), {n: p.grad.detach().cpu().double()
                                     for n, p in model.named_parameters()})
    ref_loss, ref_grads = runs["float64"]

    def grad_errs(key):
        return {n: float((runs[key][1][n] - g).abs().max() / g.abs().max())
                for n, g in ref_grads.items() if g.abs().max() > 0}

    card_err = grad_errs("card")
    over = [n for n, e in card_err.items() if e > GRAD_REL_TOL]
    worst = max(card_err, key=card_err.get)
    loss_rel = abs(runs["card"][0] - ref_loss) / abs(ref_loss)
    check(loss_rel <= LOSS_REL_TOL and not over,
          f"phase 10: one CNN-63 step from the bench weights, card vs the CPU in float64: loss "
          f"{runs['card'][0]:.6f} vs {ref_loss:.6f}, rel err {loss_rel:.3e} (tol {LOSS_REL_TOL}); "
          f"gradients max err / max|g| worst {card_err[worst]:.3e} on {worst}, median "
          f"{np.median(list(card_err.values())):.3e}; the card's tensors over {GRAD_REL_TOL}: {over} of {len(card_err)}")

    def count_k2(trainer):
        launches = {"train": 0, "eval": 0}

        def counted(fn, key):
            def run(*args):
                before = k2_wrapper.launches
                out = fn(*args)
                launches[key] += k2_wrapper.launches - before
                return out
            return run

        trainer.train_step = counted(trainer.train_step, "train")
        trainer.eval_step = counted(trainer.eval_step, "eval")
        return launches

    results, trainers = {}, {}

    def fit(family, epochs, steps, init, ckpt=None):
        log_path = os.path.join(work, f"train_{family}.jsonl")
        if os.path.exists(log_path):
            os.remove(log_path)
        config = train_config(family, checkpoint_dir=ckpt, log_path=log_path)
        trainer = Trainer(config, train_dataset("train"), train_dataset("validation"))
        init(trainer)
        params = list(trainer.model.parameters())
        launches = count_k2(trainer)
        k2_wrapper.launches = 0
        t0 = time.perf_counter()
        trainer.fit(num_epochs=epochs, steps_per_epoch=steps)
        fit_s = time.perf_counter() - t0
        fit_launches = k2_wrapper.launches
        last = trainer.metrics_log[-1]
        results[family] = {"last_epoch_steps_per_sec": last["steps_per_sec"],
                           "last_epoch_crops_per_sec": last["crops_per_sec"], "fit_s": fit_s,
                           "k2_train": launches["train"], "k2_eval": launches["eval"]}
        for rec in trainer.metrics_log:
            log(f"phase 10: {family} JSONL {json.dumps(rec)}")
        finite = all(np.isfinite(rec[k]) for rec in trainer.metrics_log
                     for k in ("train_loss", "val_loss", "grad_norm", "param_norm"))
        check(finite and all(p.device.type == "cuda" for p in params)
              and trainer.state.step == epochs * steps and launches["train"] == 0
              and (launches["eval"] > 0) == (family != "resformer")
              and fit_launches == launches["train"] + launches["eval"],
              f"phase 10: {family}: Trainer.fit {epochs} epochs x {steps} steps (batch "
              f"{TRAIN_BATCH}, T {TRAIN_T}, {CROP} px) in {fit_s:.2f} s; last epoch "
              f"{last['steps_per_sec']} steps/s = {last['crops_per_sec']} crops/s; K2 launches "
              f"in the fit {fit_launches}: in train steps {launches['train']} (must be 0), in "
              f"eval steps {launches['eval']} "
              f"({'none: ResNet-50' if family == 'resformer' else 'must be > 0'})"
              f"; losses finite; {card}")
        trainers[family] = trainer
        return trainer

    def steady_rate(family):
        """Trainer.fit's steady-state rate (steady_steps_per_sec; by the
        third step the producer's queue and the two staged copies are
        full)."""
        trainer = trainers[family]
        rate = steady_steps_per_sec(
            torch, trainer, STEADY_STEPS,
            lambda: epoch_without_validation(trainer, STEADY_STEPS))
        results[family].update({"steps_per_sec": rate,
                                "crops_per_sec": rate * TRAIN_BATCH * TRAIN_T})
        log(f"phase 10: {family}: steady state over steps 3-{STEADY_STEPS} of an epoch of "
            f"{STEADY_STEPS}: {rate:.3f} steps/s = {rate * TRAIN_BATCH * TRAIN_T:.1f} crops/s "
            f"(the epoch's JSONL record: {trainer.metrics_log[-1]['steps_per_sec']} steps/s, "
            f"the fill included); {card}")

    def split_step(family):
        """Where a fit step's time goes: the producer's batch assembly alone
        (the dataset, on the host) and the train step alone on a batch
        already on the card (dispatch and device), each a mean over
        HOST_BATCHES, beside the steady-state rate."""
        trainer = trainers[family]
        timer = StageTimer()
        wire = train_dataset("train", seed=2).batches(TRAIN_BATCH, HOST_BATCHES)
        for _ in range(HOST_BATCHES):
            with timer.stage("assemble"):
                next(wire)
        on_card = (torch.from_numpy(batch_u8).to(dev), torch.from_numpy(labels).to(dev))
        trainer.train_step(trainer.state, *on_card)
        torch.cuda.synchronize()
        with timer.stage("steps"):
            for _ in range(HOST_BATCHES):
                trainer.train_step(trainer.state, *on_card)
            torch.cuda.synchronize()
        assemble_ms = 1e3 * timer.totals["assemble"] / HOST_BATCHES
        step_ms = 1e3 * timer.totals["steps"] / HOST_BATCHES
        fit_ms = 1e3 / results[family]["steps_per_sec"]
        results[family].update({"assemble_ms": assemble_ms, "step_ms": step_ms})
        log(f"phase 10: {family}: a batch assembled alone on the host {assemble_ms:.2f} ms, a "
            f"train step alone on a batch on the card {step_ms:.2f} ms (means of {HOST_BATCHES}), "
            f"the steady state {fit_ms:.2f} ms a step; {card}")

    def from_bench(trainer):
        trainer.init_state(0)
        load_bench(trainer.model, bench)

    ckpt_dir = os.path.join(work, "train_ckpt")
    trainer = fit("cnn", TRAIN_EPOCHS, TRAIN_STEPS, from_bench, ckpt=ckpt_dir)

    # (b) K2 after training: eval log-probs through K2 against the same
    # model with layer4[1] on the plain version; K2 against its plain
    # version on that block's own input (56 x 4 x 4 x 512).
    model = trainer.model.eval()
    block = model.embed.layer4[1]
    x = torch.from_numpy(batch_u8).to(dev).float() / 255.0
    seen = {}
    hook = block.register_forward_hook(keep_input(seen))
    with torch.no_grad():
        before = k2_wrapper.launches
        lp_k2 = model(x)
        k2_in_eval = k2_wrapper.launches - before
        hook.remove()
        block.forward = lambda t: residual_block_ref(*k2_ref_args(block, t)).permute(0, 3, 1, 2)
        lp_ref = model(x)
        del block.forward  # the class's forward again
    lp_err = float((lp_k2 - lp_ref).abs().max())
    check(k2_in_eval == K2_BLOCKS and lp_err <= LOG_PROB_TOL,
          f"phase 10: after training, eval log-probs {tuple(lp_k2.shape)} with layer4[1] on K2 "
          f"({k2_in_eval} launches, one a fused block) vs on residual_block_ref: max abs err "
          f"{lp_err:.3e} "
          f"(tol {LOG_PROB_TOL})")
    with torch.inference_mode(), full_float32():
        k2_args = k2_ref_args(block, seen["x"])
        x_nhwc = k2_args[0]
        pack = block.block_pack(torch.float32)
        k2_out = residual_block_packed(x_nhwc, pack)
        k2_ref = residual_block_ref(*k2_args)
    k2_err = float((k2_out - k2_ref).abs().max())
    k2_scale = float(k2_ref.abs().max())
    check(tuple(x_nhwc.shape) == (TRAIN_BATCH * TRAIN_T, 4, 4, 512)
          and k2_err <= K2_F32_REL_TOL * k2_scale,
          f"phase 10: K2 residual_block f32 at the trained layer4[1] {tuple(x_nhwc.shape)}: max "
          f"abs err {k2_err:.3e} (tol {K2_F32_REL_TOL} x max|ref| {k2_scale:.3f})")
    k2 = k2_yardsticks(torch, block, seen["x"], k2_args, pack)
    log(f"phase 10: K2 f32 at {tuple(x_nhwc.shape)}: call {k2['ms']:.4f} ms, plain "
        f"{k2['plain_ms']:.4f} ms, cuDNN chain {k2['library_ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.4f} ms (3 x {k2['gflop']:.2f} GFLOP TF32); {card}")

    # (c) The last epoch's checkpoint through BatchedActionPipeline.load_checkpoint.
    path = os.path.join(ckpt_dir, f"step_{TRAIN_EPOCHS - 1}.pt")
    pipe = BatchedActionPipeline(device=dev).load_checkpoint(path)
    with torch.inference_mode():
        emb = pipe.embed_crops(x.reshape(-1, CROP, CROP, 3)).reshape(TRAIN_BATCH, TRAIN_T, -1)
        lp_pipe = pipe.head(emb)
    ckpt_err = float((lp_pipe - lp_k2).abs().max())
    check(ckpt_err <= CKPT_LOG_PROB_TOL,
          f"phase 10: {os.path.relpath(path, ROOT)} through BatchedActionPipeline.load_checkpoint "
          f"on the card: log-probs vs the trainer's model max abs err {ckpt_err:.3e} "
          f"(tol {CKPT_LOG_PROB_TOL})")

    # (e) The wire format: an epoch of WIRE_STEPS steps, profiled in a fresh
    # process (profile_in_fresh_process), copies each step's uint8 batch, its
    # labels and fighter ids, and no weights.  K2's device time at the same
    # shape is taken there too.
    audit = profile_in_fresh_process("train")
    k2_dev_ms = audit["k2_device_ms"]
    log(f"phase 10: K2 f32 at {tuple(audit['k2_shape'])} in the fresh process: device "
        f"{'not measured' if k2_dev_ms is None else f'{k2_dev_ms:.4f} ms'} "
        f"({audit['k2_records_per_call']:g} of 2 kernel records a call traced); {card}")
    h2d = audit["h2d"]
    big = [b for b in h2d if b is not None and b >= 65536]
    small = [b for b in h2d if b is not None and b < 65536]
    per_step_small = TRAIN_BATCH * TRAIN_T * 4 + TRAIN_BATCH * 4  # labels, fighter ids
    busy_share = audit["busy_us"] / audit["wall_us"]
    log(f"phase 10: an epoch of {WIRE_STEPS} train steps profiled in a fresh process: "
        f"{len(h2d)} host-to-device copies in the trace ({h2d.count(None)} without a size); "
        f"{audit['calls']} cudaMemcpy calls traced on the host, {audit['lost']} with no copy on "
        f"the device; profiler notes of dropped records: {audit['notes'] or 'none'}")
    check(big == [batch_u8.nbytes] * WIRE_STEPS and None not in h2d
          and sum(small) == WIRE_STEPS * per_step_small,
          f"phase 10: host-to-device copies of {WIRE_STEPS} profiled train steps: {big} B (the "
          f"uint8 batches, {batch_u8.nbytes} B each) and {sum(small)} B in {len(small)} small "
          f"copies (labels and fighter ids, {per_step_small} B a step); no weights; device busy "
          f"{audit['busy_us'] / 1e3:.1f} ms of {audit['wall_us'] / 1e3:.1f} ms wall = "
          f"{busy_share:.3f}")
    results["cnn"]["busy_share"] = busy_share

    # (d) Learning: 20 steps on one fixed batch.
    fixed = (torch.from_numpy(batch_u8).to(dev), torch.from_numpy(labels).to(dev))
    losses = [float(trainer.train_step(trainer.state, *fixed)[0]) for _ in range(LEARN_STEPS)]
    check(losses[-1] < losses[0],
          f"phase 10: loss on one fixed batch over {LEARN_STEPS} steps: {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")

    # The RNN and the ResFormer at full width from seeded init.
    for family in ("rnn", "resformer"):
        fit(family, FAMILY_EPOCHS, FAMILY_STEPS, lambda t: t.init_state(FAMILY_SEED))
    for family in trainers:
        steady_rate(family)
        split_step(family)
    log(f"phase 10: families {json.dumps(results)}; {card}")
    launches = sum(r["k2_train"] + r["k2_eval"] for r in results.values())
    return {"launches": launches, "eval_launches": {f: r["k2_eval"] for f, r in results.items()},
            "train_step_launches": sum(r["k2_train"] for r in results.values()),
            "max_abs_err": k2_err, "shape": list(x_nhwc.shape), "ms": k2["ms"],
            "device_ms": k2_dev_ms, "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "library_ms": k2["library_ms"], "families": results}


# ---- phase 11: device-side synthetic training ----

SYNTH_ROOT = os.path.join(ROOT, "build", "smoke", "synth")
SYNTH_FRAMES = 16         # frames a move and facing, as the JAX tool renders them
SYNTH_SIDES = (104, 177)  # square tight sprites of 104-176 px, as tight_crop leaves them
SYNTH_BATCH, SYNTH_T = 16, 7
SYNTH_EPOCHS, SYNTH_STEPS = 2, 20
SYNTH_WARMUP = 3          # the JAX tool's 200 warmup steps of 3,000, scaled to this run's 40
BANK_TOL = 2.55e-3        # max abs on the 0-255 scale: K1's 1e-5 gate on /255 values
COMPOSITE_SAME_MIN = 0.999  # card vs CPU frames: at most 1 apart, this share identical
BANK_SETS = 8             # batches of parameters the bank entry is timed over
SYNTH_PROFILES = 3        # profiled epochs at most, while a trace shows a lost record
# Row-relative (y0, x0, side) of the bank entry's edge cases, on a 24 x 20
# source: negative origins, side < 1, side over ten times the source, a
# window wholly outside.
BANK_EDGES = [(-6.0, -3.5, 30.0), (3.0, -12.25, 18.0), (4.0, 6.0, 0.25), (10.0, 2.0, 0.0),
              (-150.0, -120.0, 320.0), (-400.0, -380.0, 900.0), (40.0, 3.0, 10.0),
              (-80.0, -80.0, 30.0)]


@functools.lru_cache(maxsize=None)
def pixel_grid(side):
    """Row and column coordinates of a side x side image, float32 (read only)."""
    return np.mgrid[0:side, 0:side].astype(np.float32)


def stand_in_sprite(side, style, move_idx, phase, facing):
    """A BGRA sprite drawn with numpy, as a tight-cropped skeletal sprite is
    laid out: a square of side px, transparent around an opaque figure
    (body, head, one limb whose angle follows the move and the frame's
    phase) in the fighter's BGR colours, mirrored for facing left."""
    yy, xx = pixel_grid(side)
    if facing < 0:
        xx = side - 1 - xx
    c = side / 2.0
    a = 2 * np.pi * (move_idx / 48.0 + phase)
    body = ((xx - c) / (0.16 * side)) ** 2 + ((yy - 0.58 * side) / (0.26 * side)) ** 2 <= 1
    head = (xx - c - 0.05 * side * np.sin(a)) ** 2 + (yy - 0.22 * side) ** 2 <= (0.12 * side) ** 2
    ex, ey = 0.38 * side * np.sin(a), -0.38 * side * np.cos(a)  # the limb's end, from (c, side / 2)
    t = np.clip(((xx - c) * ex + (yy - side / 2) * ey) / (ex * ex + ey * ey), 0, 1)
    limb = (xx - c - t * ex) ** 2 + (yy - side / 2 - t * ey) ** 2 <= (0.04 * side) ** 2
    img = np.zeros((side, side, 4), np.uint8)
    for mask, color in ((body, style.body_color), (limb, style.limb_color),
                        (head, style.head_color)):
        img[mask] = (*color, 255)
    return img


def write_synth_tree(root):
    """<root>/clean: generate_sprite_set's layout and names for 6 fighters x
    48 moves x SYNTH_FRAMES frames x 2 facings, variant 0, with .npy
    stand-in sprites of SYNTH_SIDES px (the card's machine has no cv2 to
    draw skeletal sprites); <root>/stages: train_bench_weights.py's four
    540 x 960 stage textures as .npy (BGR), where the tool writes jpg.
    A tree whose stamp file records the same seed, settings and drawing
    code is kept as it is.  Returns the two
    directories, the number of sprites and whether the tree was written."""
    import hashlib
    import inspect
    import shutil

    from playaid_core_torch.datagen.skeletal_sprites import EXTRA_MOVES, FIGHTER_STYLES, MOVES

    tool = bench_tool()
    jobs = [(os.path.join(root, "clean", fighter, move,
                          f"{fighter.lower().replace(' ', '-')}_c00_{move.lower()}_frame_"
                          f"{cam}_{i}.npy"), style, k, i / SYNTH_FRAMES, facing)
            for fighter, style in FIGHTER_STYLES.items()
            for k, move in enumerate(MOVES + EXTRA_MOVES)
            for facing, cam in ((1, 90), (-1, 270)) for i in range(SYNTH_FRAMES)]
    clean, stages = os.path.join(root, "clean"), os.path.join(root, "stages")
    stamp_file = os.path.join(root, "stamp.txt")
    stamp = hashlib.sha256(repr((
        FAMILY_SEED, SYNTH_FRAMES, SYNTH_SIDES, [j[:2] for j in jobs],
        [(name, inspect.getsource(draw)) for name, draw in tool.STAGE_SPECS],
        inspect.getsource(stand_in_sprite), inspect.getsource(write_synth_tree),
    )).encode()).hexdigest()
    if os.path.exists(stamp_file):
        with open(stamp_file) as f:
            if f.read() == stamp:
                return clean, stages, len(jobs), False
    shutil.rmtree(root, ignore_errors=True)
    for d in {os.path.dirname(j[0]) for j in jobs} | {stages}:
        os.makedirs(d)
    rng = np.random.default_rng(FAMILY_SEED)
    for path, *args in jobs:
        np.save(path, stand_in_sprite(int(rng.integers(*SYNTH_SIDES)), *args))
    rng = np.random.default_rng(0)
    for name, draw_stage in tool.STAGE_SPECS:
        np.save(os.path.join(stages, f"{name}.npy"), draw_stage(rng).astype(np.uint8))
    with open(stamp_file, "w") as f:
        f.write(stamp)
    return clean, stages, len(jobs), True


def bench_tool():
    """tools/torch_port_train_bench_weights.py, the port's bench-weights
    trainer, whose dataset and trainer arguments phase 11 runs."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_port_train_bench_weights

    return torch_port_train_bench_weights


def synth_main():
    """python3 chip_smoke.py --synth: phase 11 in a fresh process (its banks
    are built once, and its profiles run young in a process; check (d)'s
    epoch in a process it starts, profile_synth).  Prints its lines, then
    one JSON line: the failed checks and the numbers."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, ROOT)
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.ops.conv_block import residual_block_packed
    from playaid_core_torch.ops.crop_kernel import bank_resize, square_crop_resize, window_resize
    from playaid_core_torch.ops.preprocess import batched_bank_resize
    from playaid_core_torch.train.device_synth import synth_composite
    from playaid_core_torch.train.train import Trainer

    failures = []

    def check(ok, what):
        log(f"{'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failures.append(what)

    card = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    work = os.path.join(ROOT, "build", "smoke")
    b, t, s = SYNTH_BATCH, SYNTH_T, CROP
    t0 = time.perf_counter()
    clean, stages, n_sprites, written = write_synth_tree(SYNTH_ROOT)
    log(f"phase 11: {n_sprites} stand-in sprites (.npy BGRA, {SYNTH_SIDES[0]}-"
        f"{SYNTH_SIDES[1] - 1} px) and 4 stage textures "
        f"{'written' if written else 'kept (same stamp)'} in {time.perf_counter() - t0:.1f} s")
    # (d)'s process builds its own dataset and trainer alongside this one's.
    with open(os.path.join(work, "profile_synth.err"), "w") as err:
        profiler = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--profile", "synth"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True)
    atexit.register(lambda: profiler.poll() is None and (profiler.kill(), profiler.wait()))

    # The dataset as train_bench_weights.py builds it; the banks' copies to
    # the card under torch.profiler (device activity only: the host's bank
    # assembly runs thousands of small torch ops).
    trace = os.path.join(work, "synth_banks_trace.json")
    with profiled(torch, cpu=False) as prof:
        t0 = time.perf_counter()
        data = bench_tool().bench_dataset(clean, stages, SYNTH_STEPS, b, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    bank_h2d = trace_copy_audit(trace, "crop_resize")["h2d"]
    sprites, stage_bank = data.sprites, data.stages
    bank_bytes = sprites.nbytes + stage_bank.nbytes
    check(sum(n for n, _ in bank_h2d if n) == bank_bytes and None not in [n for n, _ in bank_h2d]
          and sprites.bank.device == dev and stage_bank.bank.device == dev,
          f"phase 11: banks built in {build_s:.1f} s: sprites {tuple(sprites.bank.shape)} uint8 "
          f"({sprites.nbytes} B), stages {tuple(stage_bank.bank.shape)} ({stage_bank.nbytes} B) "
          f"on {dev}; host-to-device copies at construction {[n for n, _ in bank_h2d]} B, "
          f"sum {sum(n for n, _ in bank_h2d if n)} = the banks' nbytes {bank_bytes}; {card}")

    # Batches of parameters drawn from a probe generator; the dataset's own
    # stream starts afresh from its seed afterwards.
    data.rng = np.random.default_rng(1)
    params = [data._sample_batch_params(b) for _ in range(BANK_SETS)]
    data.synth_difficulty = 2
    hard = data._sample_batch_params(b)
    data.synth_difficulty = 1
    data.rng = np.random.default_rng(0)

    def on_card(p):
        return (torch.from_numpy(p["ints"]).to(dev), torch.from_numpy(p["floats"]).to(dev))

    def batch_bank_args(ints, floats, mirror=False):
        return bank_args(sprites, stage_bank, ints, floats, b, t, s, mirror)

    # (a) K1's bank entry against its plain version on the card.
    errs = {}
    with torch.inference_mode(), full_float32():
        for key, mirror in (("sprites", False), ("sprites, every other row mirrored", True)):
            sp, st = batch_bank_args(*on_card(params[0]), mirror)
            errs[key] = float((bank_resize(*sp) - batched_bank_resize(*sp)).abs().max())
        errs["stages"] = float((bank_resize(*st) - batched_bank_resize(*st)).abs().max())
        channels_last = bank_resize(*sp).is_contiguous() and bank_resize(*st).is_contiguous()
        rng = np.random.default_rng(2)
        for c in (3, 4):
            edge_bank = torch.from_numpy(rng.integers(0, 256, (5, 24, 20, c), np.uint8)).to(dev)
            e_rows = torch.arange(len(BANK_EDGES), device=dev) % 5
            e_org = torch.tensor(BANK_EDGES, device=dev)
            for mirror in (None, torch.arange(len(BANK_EDGES), device=dev) % 2):
                e = (edge_bank, e_rows, e_org, 16, mirror)
                errs[f"edges C={c}{' mirrored' if mirror is not None else ''}"] = float(
                    (bank_resize(*e) - batched_bank_resize(*e)).abs().max())
    bank_err = max(errs.values())
    check(bank_err <= BANK_TOL and channels_last,
          f"phase 11: K1 bank_resize vs batched_bank_resize on the card (full float32): "
          f"{b * t} sprite rows {tuple(sprites.bank.shape[1:])} and {b} stage rows -> {s}^2, "
          f"and 8 edge windows (negative origins, side < 1, side 45x the source, wholly "
          f"outside) at C=3 and 4: max abs err {json.dumps(errs)} (tol {BANK_TOL}); the "
          f"crops in channels-last storage, as synth_composite takes them: {channels_last}")

    # (b) synth_composite on the card against the CPU with the same draws.
    bank_cpu, stage_cpu = sprites.bank.cpu(), stage_bank.bank.cpu()
    for name, p in (("difficulty 1", params[1]), ("difficulty 2", hard)):
        ints, floats = on_card(p)
        gen = torch.Generator(device=dev).manual_seed(3)
        noise = torch.randn((b, 1, s, s, 3), generator=gen, device=dev)
        drop_u = torch.rand((b, 1, s, s, 1), generator=gen, device=dev)
        out = synth_composite(sprites.bank, stage_bank.bank, ints, floats, s, t,
                              noise=noise, drop_u=drop_u).cpu()
        ref = synth_composite(bank_cpu, stage_cpu, torch.from_numpy(p["ints"]),
                              torch.from_numpy(p["floats"]), s, t, noise=noise.cpu(),
                              drop_u=drop_u.cpu())
        diff = (out.int() - ref.int()).abs()
        same = float((diff == 0).float().mean())
        check(out.shape == (b, t, s, s, 3) and int(diff.max()) <= 1
              and same >= COMPOSITE_SAME_MIN,
              f"phase 11: synth_composite {name} on the card vs the CPU with the same draws: "
              f"max diff {int(diff.max())} (tol 1), identical {same:.6f} (min "
              f"{COMPOSITE_SAME_MIN})")
    del bank_cpu, stage_cpu

    # (c), (f) Trainer.fit as train_bench_weights.py drives it, cut to
    # SYNTH_EPOCHS x SYNTH_STEPS steps: launch counts set to 0 before, read after.
    log_path = os.path.join(work, "train_synth.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    config = bench_tool().bench_config(SYNTH_EPOCHS, SYNTH_STEPS, b, device=dev,
                                     warmup_steps=SYNTH_WARMUP, log_path=log_path, verbose=False)
    trainer = Trainer(config, data)
    trainer.init_state(0)
    wrappers = {"bank_resize": bank_resize, "crop_resize": square_crop_resize,
                "window_resize": window_resize, "residual_block": residual_block_packed}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    trainer.fit(num_epochs=SYNTH_EPOCHS, steps_per_epoch=SYNTH_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    steps = SYNTH_EPOCHS * SYNTH_STEPS
    check(launches == {"bank_resize": 2 * steps, "crop_resize": 0, "window_resize": 0,
                       "residual_block": 0} and trainer.state.step == steps,
          f"phase 11: Trainer.fit on DeviceSynthDataset, {SYNTH_EPOCHS} epochs x {SYNTH_STEPS} "
          f"steps (CNN-63, batch {b}, T {t}, {s} px, float32) in {fit_s:.2f} s: launches "
          f"{json.dumps(launches)} (bank_resize 2 a step, no other kernel of the port's)")
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    for rec in records:
        log(f"phase 11: JSONL {json.dumps(rec)}")
    check(len(records) == SYNTH_EPOCHS and all(
        np.isfinite(r[k]) for r in records for k in ("train_loss", "grad_norm", "param_norm")),
          f"phase 11: {os.path.relpath(log_path, ROOT)} holds {len(records)} records, losses "
          f"and norms finite")

    # (d) A profiled epoch in a fresh process, whose first profile it is:
    # per step only the packed parameters and the labels cross to the card
    # (the fighter ids stay on the host).
    out, _ = profiler.communicate("go\n", timeout=600)
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if profiler.returncode != 0 or not lines:
        with open(os.path.join(work, "profile_synth.err")) as f:
            raise RuntimeError(f"--profile synth exited {profiler.returncode}:\n"
                               f"{f.read()[-4000:]}")
    audit = json.loads(lines[-1])
    h2d = audit["h2d"]
    per_step = b * (t + 2) * 4 + b * (3 * t + 25) * 4 + b * t * 4  # ints, floats, labels
    busy_share = audit["busy_us"] / audit["wall_us"]
    check(None not in h2d and sum(h2d) == WIRE_STEPS * per_step and len(h2d) == 3 * WIRE_STEPS,
          f"phase 11: an epoch of {WIRE_STEPS} train steps under torch.profiler: {len(h2d)} "
          f"host-to-device copies, {sum(x for x in h2d if x)} B = {WIRE_STEPS} x {per_step} B "
          f"(ints {b * (t + 2) * 4}, floats {b * (3 * t + 25) * 4}, labels {b * t * 4}); no "
          f"pixel or weight bytes; {audit['lost']} of {audit['calls']} cudaMemcpy calls with no "
          f"copy on the device (at {audit['lost_at']}); device busy "
          f"{audit['busy_us'] / 1e3:.1f} ms of {audit['wall_us'] / 1e3:.1f} ms wall = "
          f"{busy_share:.3f}")

    # Timings of the bank entry: a batch's two launches (sprites, stages).
    sets = [batch_bank_args(*on_card(p)) for p in params]

    def bank_call(it):
        sp, st = sets[it % BANK_SETS]
        return bank_resize(*sp), bank_resize(*st)

    def grid_inputs(bank, rows, origins, size, flip):
        src = bank.index_select(0, rows.long()).float()
        if flip is not None:
            src = torch.where(flip.bool()[:, None, None, None], src.flip(2), src)
        i = torch.arange(size, device=dev, dtype=torch.float32)
        side = torch.clamp(origins[:, 2], min=1.0)
        sy = origins[:, 0, None] + (i + 0.5) * side[:, None] / size - 0.5
        sx = origins[:, 1, None] + (i + 0.5) * side[:, None] / size - 0.5
        gy = (2 * sy + 1) / bank.shape[1] - 1  # align_corners=False
        gx = (2 * sx + 1) / bank.shape[2] - 1
        return (src.permute(0, 3, 1, 2).contiguous(),
                torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]), -1))

    with torch.inference_mode():
        grids = [[grid_inputs(*a) for a in pair] for pair in sets]
        lib_out = F.grid_sample(*grids[0][0], mode="bilinear", padding_mode="zeros",
                                align_corners=False).permute(0, 2, 3, 1)
        with full_float32():
            lib_err = float((lib_out - batched_bank_resize(*sets[0][0])).abs().max())
        bank_ms = time_cuda(torch, bank_call, 80)
        bank_dev_ms, bank_per_call = device_ms(torch, bank_call, 80, "crop_resize_kernel", 2)
        with full_float32():
            bank_plain_ms = time_cuda(torch, lambda it: [batched_bank_resize(*a)
                                                         for a in sets[it % BANK_SETS]], 8)
        bank_lib_ms = time_cuda(torch, lambda it: [
            F.grid_sample(*g, mode="bilinear", padding_mode="zeros", align_corners=False)
            for g in grids[it % BANK_SETS]], 40)
    del grids, lib_out
    p0 = params[0]
    sp_org = np.stack([p0["floats"][:, :t].ravel(), p0["floats"][:, t:2 * t].ravel(),
                       p0["floats"][:, 2 * t:3 * t].ravel()], 1)
    bank_bytes_read = (
        bank_touched_bytes(p0["ints"][:, :t].ravel(), sp_org, np.zeros(b * t, bool), s, s, 4, s)
        + bank_touched_bytes(p0["ints"][:, t], p0["floats"][:, 3 * t:3 * t + 3],
                             np.zeros(b, bool), stage_bank.patch, stage_bank.patch, 3, s))
    bank_io = bank_bytes_read + b * t * s * s * 4 * 4 + b * s * s * 3 * 4 + b * (t + 1) * 16
    bank_bound_ms = bank_io / PEAK_HBM_BYTES * 1e3
    fmt = "not measured" if bank_dev_ms is None else f"{bank_dev_ms:.4f} ms"
    log(f"phase 11: K1 bank_resize, a batch's two launches ({b * t} RGBA sprite rows and {b} "
        f"RGB stage rows -> {s}^2): call {bank_ms:.4f} ms, device {fmt} ({bank_per_call:g} "
        f"kernel records a call traced), plain {bank_plain_ms:.4f} ms, grid_sample on the "
        f"gathered rows {bank_lib_ms:.4f} ms (vs plain max abs err {lib_err:.3e}), bound "
        f"{bank_bound_ms:.4f} ms ({bank_io / 1e6:.2f} MB: {bank_bytes_read / 1e6:.2f} MB of "
        f"taps read); {card}")

    # The composite's device time and launches a batch.
    ints0, floats0 = on_card(params[0])

    def composite(_):
        return synth_composite(sprites.bank, stage_bank.bank, ints0, floats0, s, t,
                               generator=data.generator)

    def kernel_work(prof, name):
        """Kernel records and their device ms in a profile's exported trace."""
        path = os.path.join(work, name)
        prof.export_chrome_trace(path)
        durs = [dur for _, cat, _, dur, _ in trace_device_events(path) if cat == "kernel"]
        return len(durs), sum(durs) / 1e3

    composite(0)
    torch.cuda.synchronize()
    with profiled(torch) as lead:  # the opening and closing kernels alone
        pass
    with profiled(torch) as prof:
        for it in range(10):
            composite(it)
        torch.cuda.synchronize()
    (n_lead, ms_lead) = kernel_work(lead, "lead_trace.json")
    (n_all, ms_all) = kernel_work(prof, "composite_trace.json")
    comp_launches, comp_dev_ms = (n_all - n_lead) / 10, (ms_all - ms_lead) / 10
    comp_ms = time_cuda(torch, composite, 20)
    log(f"phase 11: synth_composite (a batch of {b} x {t} x {s}^2): call {comp_ms:.4f} ms, "
        f"device {comp_dev_ms:.4f} ms in {comp_launches:g} kernel launches (K1's two "
        f"included); {card}")

    # (e) Learning: 20 steps on one fixed synthetic batch.
    frames, _, labels = next(data.device_batches(b, 1))
    labels = torch.from_numpy(labels).to(dev)
    losses = [float(trainer.train_step(trainer.state, frames, labels)[0])
              for _ in range(LEARN_STEPS)]
    check(losses[-1] < losses[0],
          f"phase 11: loss on one fixed synthetic batch over {LEARN_STEPS} steps: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")

    # The steady state.
    rate = steady_steps_per_sec(torch, trainer, STEADY_STEPS,
                                lambda: epoch_without_validation(trainer, STEADY_STEPS))
    log(f"phase 11: steady state over steps 3-{STEADY_STEPS} of an epoch of {STEADY_STEPS}: "
        f"{rate:.3f} steps/s = {rate * b * t:.1f} crops/s (the epoch's JSONL record: "
        f"{trainer.metrics_log[-1]['steps_per_sec']} steps/s, the fill included); {card}")
    print(json.dumps({
        "failures": failures, "bank_build_s": build_s, "bank_bytes": bank_bytes,
        "sprites": n_sprites, "launches": launches, "fit_s": fit_s,
        "steps_per_sec": rate, "crops_per_sec": rate * b * t, "busy_share": busy_share,
        "bank_max_abs_err": bank_err, "bank_ms": bank_ms, "bank_device_ms": bank_dev_ms,
        "bank_plain_ms": bank_plain_ms, "bank_bound_ms": bank_bound_ms,
        "bank_library_ms": bank_lib_ms, "composite_ms": comp_ms,
        "composite_device_ms": comp_dev_ms, "composite_launches": comp_launches}), flush=True)
    return 0


def run_synth_phase(check):
    """Phase 11 through synth_main in a child process: its lines are shown
    here and each of its failed checks fails here too.  Returns its numbers."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--synth"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0 or not lines:
        check(False, f"phase 11: chip_smoke.py --synth exited {proc.returncode}:\n"
                     f"{proc.stderr[-4000:]}")
        return None
    res = json.loads(lines[-1])
    for what in res["failures"]:
        check(False, what)
    return res


# ---- phase 15: the synth split on skeletal sprites drawn on the card's host ----
SPRITE_ROOT = os.path.join(ROOT, "build", "smoke", "sprites")
SPRITE_DIGESTS = os.path.join(ROOT, "playaid_core_torch", "assets", "sprite_digests.json")
SPRITE_SERIAL = 24        # sprites drawn again in this process alone: the one-core rate
HOST_EPOCH_STEPS = 30     # steps of the epoch that gives the host split's steady state
HOST_PROFILE_STEPS = 4    # steps of the profiled epoch (the busy share)
HOST_TIMED_BATCHES = 2    # batches assembled alone, after a warm one
DEVICE_SYNTH_STEPS = 10   # DeviceSynthDataset steps on the drawn tree


def bank_args(sprites, stage_bank, ints, floats, b, t, s, mirror=False):
    """The two bank_resize launches' arguments of a DeviceSynthDataset batch:
    its sprite rows (flipped as their clip, or every other row when mirror)
    and its stage rows."""
    import torch

    flip = ints[:, t + 1, None].expand(b, t).reshape(-1)
    if mirror:
        flip = (torch.arange(b * t, device=ints.device) % 2).int()
    sp = (sprites.bank, ints[:, :t].reshape(-1),
          torch.stack([floats[:, :t].reshape(-1), floats[:, t:2 * t].reshape(-1),
                       floats[:, 2 * t:3 * t].reshape(-1)], 1), s, flip)
    st = (stage_bank.bank, ints[:, t], floats[:, 3 * t:3 * t + 3], s, None)
    return sp, st


def sprite_split(clean, stages, difficulty, seed, num_batches):
    """The synth split with the bench tool's arguments (fill 0.70-0.98,
    jitter 10, middle-out windows, cycle repeats 1-2) over the drawn tree,
    no JPEG degrade: batch SYNTH_BATCH, T SYNTH_T, 128 px, the 63 classes."""
    from playaid_core_torch.train.dataset import UltActionRecogDataset

    none = os.path.join(SPRITE_ROOT, "none")
    return UltActionRecogDataset(
        split="synth", num_samples=num_batches * SYNTH_BATCH, img_dimension=CROP,
        anim_subset=train_actions(), num_frames_per_sample=SYNTH_T, frame_delta=[3],
        num_preceding_actions=0, crop_size=CROP, seed=seed, gt_root_train=none,
        gt_root_val=none, gt_root_test=none, stages_dir=stages, clean_char_dir=clean,
        synth_sprite_fill=(0.70, 0.98), synth_center_jitter=10, synth_frame_degrade=0.0,
        synth_window="middleout", synth_cycle_repeats=(1, 2), synth_difficulty=difficulty)


def sprites_main():
    """python3 chip_smoke.py --sprites: phase 15 in a fresh process.  Prints
    its lines, then one JSON line: the failed checks and the numbers."""
    import shutil

    import torch

    sys.path.insert(0, ROOT)
    from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
    from playaid_core_torch.datagen import skeletal_sprites as sk
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.ops.conv_block import residual_block_packed, residual_block_ref
    from playaid_core_torch.ops.crop_kernel import bank_resize, square_crop_resize, window_resize
    from playaid_core_torch.ops.preprocess import batched_bank_resize
    from playaid_core_torch.train.train import Trainer

    failures = []

    def check(ok, what):
        log(f"{'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failures.append(what)

    card = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    work = os.path.join(ROOT, "build", "smoke")
    b, t, s = SYNTH_BATCH, SYNTH_T, CROP
    wrappers = {"crop_resize": square_crop_resize, "window_resize": window_resize,
                "bank_resize": bank_resize, "residual_block": residual_block_packed}

    # (a) The sprite tree of sprite_digests.json's settings, drawn with the
    # port's generate_sprite_set(fmt="npy") in one process a CPU, and its
    # digests against those cv2 gave.
    with open(SPRITE_DIGESTS) as f:
        spec = json.load(f)
    cfg = spec["settings"]
    clean, stages = os.path.join(SPRITE_ROOT, "clean"), os.path.join(SPRITE_ROOT, "stages")
    shutil.rmtree(SPRITE_ROOT, ignore_errors=True)
    workers = min(os.cpu_count() or 1, spec["sprites"] // sk.SPRITES_A_PROCESS)
    t0 = time.perf_counter()
    n = sk.generate_sprite_set(clean, fighters=cfg["fighters"], moves=cfg["moves"],
                               frames_per_move=cfg["frames_per_move"],
                               variant_seeds=tuple(cfg["variant_seeds"]), seed=cfg["seed"],
                               fmt="npy")
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(SPRITE_SERIAL):
        sk.render_sprite(cfg["fighters"][k % 6], cfg["moves"][k % 8], k / SPRITE_SERIAL,
                         facing=1 - 2 * (k % 2), variant_seed=k % 2)
    serial_rate = SPRITE_SERIAL / (time.perf_counter() - t0)
    differ = [name for name, digest in spec["digests"].items()
              if sk.sprite_digest(np.load(os.path.join(clean, name + ".npy"))) != digest]
    check(n == spec["sprites"] and len(spec["digests"]) >= 48 and not differ,
          f"phase 15 (a): {n} skeletal sprites ({len(cfg['fighters'])} fighters x "
          f"{len(cfg['moves'])} moves x {cfg['frames_per_move']} frames x variants "
          f"{cfg['variant_seeds']} x 2 facings) drawn as .npy in {draw_s:.2f} s with {workers} "
          f"processes = {n / draw_s:.1f} sprites/s ({serial_rate:.1f} sprites/s in one); "
          f"SHA-256 of {len(spec['digests'])} against cv2's "
          f"(playaid_core_torch/assets/sprite_digests.json): {len(differ)} differ {differ[:4]}; "
          f"{card}")
    os.makedirs(stages)
    rng = np.random.default_rng(0)
    for name, draw_stage in bench_tool().STAGE_SPECS:
        np.save(os.path.join(stages, f"{name}.npy"), draw_stage(rng).astype(np.uint8))

    # (b) The synth split over the tree: batch assembly alone.
    data = sprite_split(clean, stages, 1, 0, HOST_EPOCH_STEPS)
    t0 = time.perf_counter()
    first = next(data.batches(b, 1))
    first_s = time.perf_counter() - t0
    wire = sprite_split(clean, stages, 1, 1, HOST_TIMED_BATCHES).batches(b, HOST_TIMED_BATCHES)
    t0 = time.perf_counter()
    batches = list(wire)
    assemble_s = (time.perf_counter() - t0) / HOST_TIMED_BATCHES
    hard = next(sprite_split(clean, stages, 2, 2, 1).batches(b, 1))
    shapes_ok = all(f.dtype == np.uint8 and f.shape == (b, t, s, s, 3)
                    and lab.min() >= 0 and lab.max() < len(train_actions())
                    and f.std() > 1.0
                    for f, _, lab in [first, hard] + batches)
    crops_per_s = b * t / assemble_s
    check(shapes_ok,
          f"phase 15 (b): the synth split (difficulty 1, one batch at 2) gives uint8 "
          f"[{b}, {t}, {s}, {s}, 3] frames and labels in [0, {len(train_actions())}); a batch "
          f"assembled alone in {assemble_s * 1e3:.1f} ms = {crops_per_s:.1f} crops/s (mean of "
          f"{HOST_TIMED_BATCHES}; the first, reading the sprites, {first_s * 1e3:.1f} ms); {card}")

    # (c) Trainer.fit, CNN-63 from the bench weights, through
    # BackgroundIterator, timed from its third step: no K1 or K2 launch in
    # a train step.
    log_path = os.path.join(work, "train_sprites.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    trainer = Trainer(train_config("cnn", batch_size=b, log_path=log_path), data)
    trainer.init_state(0)
    load_bench(trainer.model, from_jax_cnn(load_npz_tree(ASSET)))
    launches = {"train": {}, "eval": {}}

    def counted(fn, key):
        def run(*args):
            before = {k: w.launches for k, w in wrappers.items()}
            out = fn(*args)
            for k, w in wrappers.items():
                launches[key][k] = launches[key].get(k, 0) + w.launches - before[k]
            return out
        return run

    trainer.train_step = counted(trainer.train_step, "train")
    trainer.eval_step = counted(trainer.eval_step, "eval")
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rate = steady_steps_per_sec(
        torch, trainer, HOST_EPOCH_STEPS,
        lambda: trainer.fit(num_epochs=1, steps_per_epoch=HOST_EPOCH_STEPS))
    fit_s = time.perf_counter() - t0
    fit_launches = {k: w.launches for k, w in wrappers.items()}
    rec = trainer.metrics_log[-1]
    log(f"phase 15: JSONL {json.dumps(rec)}")
    check(all(v == 0 for v in launches["train"].values()) and launches["eval"] == {}
          and all(v == 0 for v in fit_launches.values())
          and all(np.isfinite(rec[k]) for k in ("train_loss", "grad_norm", "param_norm")),
          f"phase 15 (c): Trainer.fit on the synth split, 1 epoch x {HOST_EPOCH_STEPS} steps "
          f"(CNN-63 from the bench weights, batch {b}, T {t}, {s} px, float32, TF32 off) in "
          f"{fit_s:.2f} s: launches in train steps {json.dumps(launches['train'])} and over "
          f"the fit {json.dumps(fit_launches)} (all must be 0); losses finite")
    audit = profile_h2d(torch, lambda: epoch_without_validation(trainer, HOST_PROFILE_STEPS),
                        os.path.join(work, "sprites_trace.json"))
    busy_share = audit["busy_us"] / audit["wall_us"]
    log(f"phase 15: steady state over steps 3-{HOST_EPOCH_STEPS} of an epoch of "
        f"{HOST_EPOCH_STEPS}: {rate:.3f} steps/s = {rate * b * t:.1f} crops/s; a profiled epoch "
        f"of {HOST_PROFILE_STEPS}: device busy {audit['busy_us'] / 1e3:.1f} ms of "
        f"{audit['wall_us'] / 1e3:.1f} ms wall = {busy_share:.3f} ({len(audit['h2d'])} "
        f"host-to-device copies traced); {card}")
    frames, _, labels = first
    fixed = (torch.from_numpy(frames).to(dev), torch.from_numpy(labels).to(dev))
    losses = [float(trainer.train_step(trainer.state, *fixed)[0]) for _ in range(LEARN_STEPS)]
    check(losses[-1] < losses[0],
          f"phase 15 (c): loss on one fixed synth batch over {LEARN_STEPS} steps: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")

    # (d) Trainer.evaluate on the split: K2 five times an eval batch, layer4[1]'s
    # at 112x4x4x512 held against residual_block_ref on the input it ran.
    model = trainer.model
    block = model.embed.layer4[1]
    seen = {}
    hook = block.register_forward_hook(keep_input(seen))
    for w in wrappers.values():
        w.launches = 0
    ev = trainer.evaluate(sprite_split(clean, stages, 1, 4, 2), num_batches=2)
    eval_counts = {k: w.launches for k, w in wrappers.items()}
    eval_launches = eval_counts["residual_block"]
    hook.remove()
    with torch.inference_mode(), full_float32():
        k2_args = k2_ref_args(block, seen["x"])
        x_nhwc = k2_args[0]
        pack = block.block_pack(torch.float32)
        k2_out = residual_block_packed(x_nhwc, pack)
        k2_ref = residual_block_ref(*k2_args)
    k2_err = float((k2_out - k2_ref).abs().max())
    k2_scale = float(k2_ref.abs().max())
    check(eval_counts == {"crop_resize": 0, "window_resize": 0, "bank_resize": 0,
                          "residual_block": 2 * K2_BLOCKS}
          and tuple(x_nhwc.shape) == (b * t, 4, 4, 512)
          and k2_err <= K2_F32_REL_TOL * k2_scale and np.isfinite(ev["loss"]),
          f"phase 15 (d): Trainer.evaluate, 2 batches: launches {json.dumps(eval_counts)} (K2 "
          f"{K2_BLOCKS} a batch) at layer4[1] {tuple(x_nhwc.shape)}; K2 vs residual_block_ref there: max abs "
          f"err {k2_err:.3e} (tol {K2_F32_REL_TOL} x max|ref| {k2_scale:.3f}); loss "
          f"{ev['loss']:.4f}, acc {ev['acc']:.3f}")
    k2 = k2_yardsticks(torch, block, seen["x"], k2_args, pack)
    with torch.inference_mode():
        k2_dev_ms, k2_traced = device_ms(torch, lambda _: residual_block_packed(x_nhwc, pack),
                                         40, "conv3x3_wgmma_kernel", 2)
    log(f"phase 15: K2 f32 at {tuple(x_nhwc.shape)}: call {k2['ms']:.4f} ms, device "
        f"{'not measured' if k2_dev_ms is None else f'{k2_dev_ms:.4f} ms'} ({k2_traced:g} of 2 "
        f"kernel records a call traced), plain {k2['plain_ms']:.4f} ms, cuDNN chain "
        f"{k2['library_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms (3 x {k2['gflop']:.2f} "
        f"GFLOP TF32); {card}")

    # (e) DeviceSynthDataset on the drawn tree: K1's bank entry, 2 launches a
    # step, held against batched_bank_resize on a batch's arguments.
    ds = bench_tool().bench_dataset(clean, stages, DEVICE_SYNTH_STEPS, b, device=dev)
    p = ds._sample_batch_params(b)
    ints, floats = torch.from_numpy(p["ints"]).to(dev), torch.from_numpy(p["floats"]).to(dev)
    ds.rng = np.random.default_rng(0)
    with torch.inference_mode(), full_float32():
        bank_err = max(float((bank_resize(*a) - batched_bank_resize(*a)).abs().max())
                       for a in bank_args(ds.sprites, ds.stages, ints, floats, b, t, s))
    dtrainer = Trainer(train_config("cnn", batch_size=b), ds)
    dtrainer.init_state(0)
    load_bench(dtrainer.model, from_jax_cnn(load_npz_tree(ASSET)))
    for w in wrappers.values():
        w.launches = 0
    dtrainer.fit(num_epochs=1, steps_per_epoch=DEVICE_SYNTH_STEPS)
    torch.cuda.synchronize()
    dev_launches = {k: w.launches for k, w in wrappers.items()}
    check(bank_err <= BANK_TOL and dev_launches == {
        "crop_resize": 0, "window_resize": 0, "bank_resize": 2 * DEVICE_SYNTH_STEPS,
        "residual_block": 0},
          f"phase 15 (e): DeviceSynthDataset on the drawn tree ({ds.sprites.num_sprites} "
          f"sprites in the bank): K1 bank_resize vs batched_bank_resize on a batch's sprite and "
          f"stage rows, max abs err {bank_err:.3e} (tol {BANK_TOL}); Trainer.fit "
          f"{DEVICE_SYNTH_STEPS} steps: launches {json.dumps(dev_launches)} (bank_resize 2 a "
          f"step)")
    print(json.dumps({
        "failures": failures, "sprites": n, "draw_s": draw_s, "sprites_per_sec": n / draw_s,
        "draw_workers": workers, "sprites_per_sec_one_process": serial_rate,
        "digests_checked": len(spec["digests"]), "digests_differ": len(differ),
        "assemble_ms": assemble_s * 1e3, "crops_per_sec": crops_per_s, "fit_s": fit_s,
        "train_launches": launches["train"], "steps_per_sec": rate, "fit_crops_per_sec": rate * b * t, "busy_share": busy_share,
        "k2_launches": eval_launches,
        "k2_max_abs_err": k2_err, "k2_shape": list(x_nhwc.shape), "k2_ms": k2["ms"],
        "k2_device_ms": k2_dev_ms, "k2_plain_ms": k2["plain_ms"],
        "k2_bound_ms": k2["bound_ms"], "k2_library_ms": k2["library_ms"],
        "bank_launches": dev_launches["bank_resize"], "bank_max_abs_err": bank_err}),
        flush=True)
    return 0


def run_sprites_phase(check):
    """Phase 15 through sprites_main in a child process: its lines are shown
    here and each of its failed checks fails here too.  Returns its numbers."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--sprites"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0 or not lines:
        check(False, f"phase 15: chip_smoke.py --sprites exited {proc.returncode}:\n"
                     f"{proc.stderr[-4000:]}")
        return None
    res = json.loads(lines[-1])
    for what in res["failures"]:
        check(False, what)
    return res


# ---- phase 12: character-detector training ----

DET_ROOT = os.path.join(ROOT, "build", "smoke", "detector")
DET_IMAGES = {"train": 96, "validation": 64}
DET_FRAME_H, DET_FRAME_W = 720, 1280   # composites at the stage screenshots' size
DET_CLASSES = 6                         # len(CHAR_LIST)
DET_HW = (256, 448)
DET_BATCH = 8
DET_GRAD_BATCH = 2        # the card-vs-float64 step
DET_CLI_STEPS = 40
DET_FIT_STEPS = 60        # the trainer that evaluate and the K2 checks read
DET_EVAL_IMAGES = 64      # evaluate's draws: 4 batches of 16
DET_MAX_DET = 8
DET_STEP_BYTES = 5_275_648  # a step's uint8 images and float32 heat, size, offset, mask
# One BGR palette a class (body, head): the stand-ins' colours.
DET_PALETTE = [((70, 60, 185), (200, 190, 240)), ((40, 150, 230), (30, 60, 120)),
               ((30, 210, 240), (20, 20, 20)), ((40, 40, 40), (230, 230, 230)),
               ((40, 80, 130), (60, 140, 200)), ((200, 170, 250), (150, 120, 210))]


def stand_in_character(rng, cls):
    """A BGRA stand-in sprite drawn with numpy: basewidth 50-150 px as the
    generator draws it, a body ellipse and a head disc in the class's
    palette; the alpha is the figure."""
    w = int(rng.integers(50, 151))
    h = int(w * rng.uniform(1.1, 1.6))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    body = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - 0.62 * h) / (0.38 * h)) ** 2) <= 1.0
    head = ((xx - w / 2) ** 2 + (yy - 0.2 * h) ** 2) <= (0.2 * min(w, h)) ** 2
    sprite = np.zeros((h, w, 4), np.uint8)
    sprite[body, :3] = DET_PALETTE[cls][0]
    sprite[head, :3] = DET_PALETTE[cls][1]
    sprite[body | head, 3] = 255
    return sprite


def write_detector_tree(root):
    """<root>/{train,validation}/{images,labels}: 720x1280 BGR .npy
    composites (a noise background and 1-4 stand-in characters placed as
    composite_chars_onto_stage places them: centres Gaussian about the
    frame's centre, sigma a sixth of its size, a centre off the frame moved
    to the middle; the sprite pasted at the centre less half its size, cut
    at the frame's edges) and their YOLO labels, written as
    write_yolo_output writes them.  A tree whose stamp file records the same
    seed, settings and drawing code is kept as it is.  Returns whether the
    tree was written."""
    import hashlib
    import inspect
    import shutil

    stamp_file = os.path.join(root, "stamp.txt")
    stamp = hashlib.sha256(repr((
        FAMILY_SEED, DET_IMAGES, DET_FRAME_H, DET_FRAME_W, DET_CLASSES, DET_PALETTE,
        inspect.getsource(stand_in_character), inspect.getsource(write_detector_tree),
    )).encode()).hexdigest()
    if os.path.exists(stamp_file):
        with open(stamp_file) as f:
            if f.read() == stamp:
                return False
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(FAMILY_SEED)
    hh, ww = DET_FRAME_H, DET_FRAME_W
    for split, n in DET_IMAGES.items():
        images, labels = (os.path.join(root, split, d) for d in ("images", "labels"))
        os.makedirs(images)
        os.makedirs(labels)
        for i in range(n):
            frame = rng.integers(0, 256, (hh, ww, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 5))):
                cls = int(rng.integers(0, DET_CLASSES))
                sprite = stand_in_character(rng, cls)
                sh, sw = sprite.shape[:2]
                cx = int(rng.normal(ww / 2, ww / 6))
                cy = int(rng.normal(hh / 2, hh / 6))
                cx = ww // 2 if cx < 0 or cx > ww else cx
                cy = hh // 2 if cy < 0 or cy > hh else cy
                x0, y0 = int(cx - sw / 2), int(cy - sh / 2)
                fy0, fx0 = max(y0, 0), max(x0, 0)
                fy1, fx1 = min(y0 + sh, hh), min(x0 + sw, ww)
                part = sprite[fy0 - y0:fy1 - y0, fx0 - x0:fx1 - x0]
                on = part[..., 3] > 0
                frame[fy0:fy1, fx0:fx1][on] = part[..., :3][on]
                rows.append((cls, (cx / ww, cy / hh, sw / ww, sh / hh)))
            np.save(os.path.join(images, f"comp-{i}.npy"), frame)
            with open(os.path.join(labels, f"comp-{i}.txt"), "w") as f:
                for cls, bbox in rows:
                    f.write(f"{cls} {bbox[0]} {bbox[1]} {bbox[2]} {bbox[3]}\n")
    with open(stamp_file, "w") as f:
        f.write(stamp)
    return True


def detector_dataset(split, seed):
    from playaid_core_torch.train.detector_train import DetectionDataset

    return DetectionDataset(os.path.join(DET_ROOT, split), input_hw=DET_HW,
                            num_classes=DET_CLASSES, seed=seed)


def detector_trainer(dev, seed):
    """A seeded DetectorTrainer (Flax's init) on phase 12's training split."""
    from playaid_core_torch.train.detector_train import DetectorTrainer

    return DetectorTrainer(detector_dataset("train", seed), num_classes=DET_CLASSES,
                           input_hw=DET_HW, device=dev).init(0)


def k2_block_input(torch, trainer, images):
    """layer4[1]'s input in the trunk of trainer's model for one detect()
    batch of images (eval mode)."""
    block = trainer.model.trunk.layer4[1]
    seen = {}
    hook = block.register_forward_hook(keep_input(seen))
    try:
        trainer.detect(images, max_det=DET_MAX_DET, score_threshold=0.0)
    finally:
        hook.remove()
    return block, seen["x"]


def profile_detector(torch, dev, work):
    """profile_main's detector kind: an epoch of WIRE_STEPS steps of
    phase 12's training, once unprofiled and once under profile_h2d; then
    K2's device time at the trunk's 16x8x14x512 on a validation batch."""
    from playaid_core_torch.ops.conv_block import residual_block_packed

    trainer = detector_trainer(dev, 5)

    def run():
        trainer.fit(WIRE_STEPS, batch_size=DET_BATCH, log_every=WIRE_STEPS)

    run()
    result = profile_h2d(torch, run, os.path.join(work, "detector_trace.json"))
    val = detector_dataset("validation", 6)
    images = np.stack([val.sample(uint8=True)[0] for _ in range(16)])
    block, x = k2_block_input(torch, trainer, images)
    with torch.inference_mode():
        x_nhwc = k2_ref_args(block, x)[0]
        pack = block.block_pack(torch.float32)
        ms, traced = device_ms(torch, lambda _: residual_block_packed(x_nhwc, pack), 40,
                               "conv3x3_wgmma_kernel", 2)
    result.update({"k2_device_ms": ms, "k2_records_per_call": traced,
                   "k2_shape": list(x_nhwc.shape)})
    return result


def run_detector_phase(torch, dev, check, card, k1_wrappers, k2_wrapper):
    """Phase 12: character-detector training on the card at full width.
    Returns K2's numbers at the trunk's shape and the launches."""
    import ast
    import io

    from playaid_core_torch.device import full_float32
    from playaid_core_torch.models.resnet import BasicBlock
    from playaid_core_torch.ops.conv_block import residual_block_packed, residual_block_ref
    from playaid_core_torch.profiling import StageTimer
    from playaid_core_torch.train.detector_train import DetectorTrainer, main as detector_main

    work = os.path.join(ROOT, "build", "smoke")
    t0 = time.perf_counter()
    written = write_detector_tree(DET_ROOT)
    log(f"phase 12: YOLO tree of {sum(DET_IMAGES.values())} composites ({DET_FRAME_H}x"
        f"{DET_FRAME_W} BGR .npy, 1-4 stand-in characters of {DET_CLASSES} classes) "
        f"{'written' if written else 'kept (same stamp)'} in {time.perf_counter() - t0:.1f} s")

    def k1_launches():
        return sum(w.launches for w in k1_wrappers)

    # (a) One step of batch DET_GRAD_BATCH from the seeded init, with every
    # residual block's last batch-norm scale set to 1 (Flax zeroes it, which
    # would give the convolutions and norm before it no gradient at all),
    # against the CPU in float64: the loss of the card's float32 step within
    # LOSS_REL_TOL, and every gradient of the card's step in float64 within
    # GRAD_REL_TOL of its max|g|.  In float32 this step's gradients are
    # ill-conditioned at full width: a few ReLU inputs within rounding of 0
    # take the other branch, and every batch norm's backward spreads the
    # change, so the CPU's own float32 lies about 1e-3 of max|g| (median over
    # the tensors) off float64 (PERF.md).  The card's float32 is held to at
    # most three times the CPU float32's error, the median over the tensors
    # and the worst tensor each.
    init = DetectorTrainer(num_classes=DET_CLASSES, input_hw=DET_HW, device="cpu").init(0)
    with torch.no_grad():
        for m in init.model.modules():
            if isinstance(m, BasicBlock):
                m.bn2.weight.fill_(1.0)
    state = init.model.state_dict()
    images, targets = next(detector_dataset("train", 1).batches(DET_GRAD_BATCH, 1))
    runs = {}
    for key, where, dtype in (("card", dev, torch.float32), ("card64", dev, torch.float64),
                              ("cpu", torch.device("cpu"), torch.float32),
                              ("float64", torch.device("cpu"), torch.float64)):
        trainer = DetectorTrainer(num_classes=DET_CLASSES, input_hw=DET_HW,
                                  device=where).load_variables(state)
        trainer.model.to(dtype)
        loss, _ = trainer.train_step(torch.from_numpy(images).to(where),
                                     tuple(torch.from_numpy(t).to(where, dtype) for t in targets))
        runs[key] = (float(loss), {n: p.grad.detach().cpu().double()
                                   for n, p in trainer.model.named_parameters()})
    ref_loss, ref_grads = runs["float64"]
    # up.{0,3,6}.bias feed a train-mode batch norm, whose mean takes them out:
    # their gradient is 0 in exact arithmetic, held against its conv's scale.
    scale = {n: float(g.abs().max()) for n, g in ref_grads.items()}
    for n in ref_grads:
        if n.startswith("up.") and n.endswith(".bias"):
            scale[n] = scale[n.replace("bias", "weight")]

    def grad_errs(key):
        return {n: float((runs[key][1][n] - g).abs().max()) / scale[n]
                for n, g in ref_grads.items() if scale[n] > 0}

    errs = {key: grad_errs(key) for key in ("card", "card64", "cpu")}
    median = {key: float(np.median(list(e.values()))) for key, e in errs.items()}
    worst = {key: max(e, key=e.get) for key, e in errs.items()}
    top = {key: errs[key][worst[key]] for key in errs}
    over = [n for n, e in errs["card64"].items() if e > GRAD_REL_TOL]
    loss_rel = abs(runs["card"][0] - ref_loss) / abs(ref_loss)
    check(loss_rel <= LOSS_REL_TOL and not over and len(errs["card64"]) == len(ref_grads)
          and median["card"] <= 3 * median["cpu"] and top["card"] <= 3 * top["cpu"],
          f"phase 12: one detector step (batch {DET_GRAD_BATCH}, {DET_HW[0]}x{DET_HW[1]}, "
          f"{DET_CLASSES} classes) from the seeded init with the blocks' bn2 scales at 1, against "
          f"the CPU in float64: the card's float32 loss {runs['card'][0]:.6f} vs {ref_loss:.6f}, "
          f"rel err {loss_rel:.3e} (tol {LOSS_REL_TOL}); the card's float64 gradients max err / "
          f"max|g| worst {top['card64']:.3e} on {worst['card64']} (tol {GRAD_REL_TOL}; the gate "
          f"covers {len(errs['card64'])} of {len(ref_grads)} tensors, over: {over}); float32 "
          f"gradients, the card's median {median['card']:.3e} and worst {top['card']:.3e} on "
          f"{worst['card']} against the CPU float32's {median['cpu']:.3e} and {top['cpu']:.3e} on "
          f"{worst['cpu']} (tol 3 x each)")

    # (b) The command line, in this process, on the training split.
    out = io.StringIO()
    k2_before, k1_before = k2_wrapper.launches, k1_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = detector_main(["--data-root", os.path.join(DET_ROOT, "train"),
                            "--num-steps", str(DET_CLI_STEPS)])
    cli_s = time.perf_counter() - t0
    printed = out.getvalue().strip().splitlines()
    record = ast.literal_eval(printed[-1]) if printed else {}
    cli_launches = (k1_launches() - k1_before, k2_wrapper.launches - k2_before)
    check(rc == 0 and record.get("step") == DET_CLI_STEPS - 1
          and all(np.isfinite(record[k]) for k in ("loss", "heatmap", "offset", "size"))
          and cli_launches == (0, 0),
          f"phase 12: python -m playaid_core_torch.train.detector_train --data-root "
          f"build/smoke/detector/train --num-steps {DET_CLI_STEPS} (in this process, on the "
          f"card by default) in {cli_s:.1f} s printed {printed[-1] if printed else None}; K1 "
          f"and K2 launches {cli_launches}")

    # (c) Launches: none in fit; K2 once a batch of 16 in evaluate.
    trainer = detector_trainer(dev, 0)
    log_path = os.path.join(work, "detector_train.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    k2_wrapper.launches, k1_before = 0, k1_launches()
    t0 = time.perf_counter()
    trainer.fit(DET_FIT_STEPS, batch_size=DET_BATCH, log_path=log_path)
    fit_s = time.perf_counter() - t0
    fit_launches = (k1_launches() - k1_before, k2_wrapper.launches)
    for rec in trainer.metrics_log:
        log(f"phase 12: JSONL {json.dumps(rec)}")
    params = list(trainer.model.parameters())
    finite = all(np.isfinite(rec[k]) for rec in trainer.metrics_log
                 for k in ("loss", "heatmap", "offset", "size"))
    eval_batches = []
    detect = trainer.detect

    def recording(images, **kw):
        eval_batches.append(images)
        return detect(images, **kw)

    trainer.detect = recording
    k2_wrapper.launches = 0
    try:
        scores = trainer.evaluate(detector_dataset("validation", 2), num_images=DET_EVAL_IMAGES)
    finally:
        del trainer.detect  # the class's method again
    eval_launches = k2_wrapper.launches
    check(finite and all(p.device.type == "cuda" for p in params) and fit_launches == (0, 0)
          and eval_launches == K2_BLOCKS * len(eval_batches)
          and len(eval_batches) == DET_EVAL_IMAGES // 16,
          f"phase 12: DetectorTrainer.fit {DET_FIT_STEPS} steps (batch {DET_BATCH}) in "
          f"{fit_s:.2f} s, losses finite, weights on the card; K1 and K2 launches in the fit "
          f"{fit_launches} (must be 0); evaluate({DET_EVAL_IMAGES}) K2 launches {eval_launches} "
          f"in {len(eval_batches)} batches ({K2_BLOCKS} a batch); {scores}; {card}")

    # (d) K2 after training at the trunk's shape, and evaluate's first batch
    # with layer4[1] on K2 and on residual_block_ref.
    batch16 = eval_batches[0]
    block, x = k2_block_input(torch, trainer, batch16)
    with torch.inference_mode(), full_float32():
        k2_args = k2_ref_args(block, x)
        x_nhwc = k2_args[0]
        pack = block.block_pack(torch.float32)
        k2_out = residual_block_packed(x_nhwc, pack)
        k2_ref = residual_block_ref(*k2_args)
    torch.cuda.synchronize()
    k2_err = float((k2_out - k2_ref).abs().max())
    k2_scale = float(k2_ref.abs().max())
    check(tuple(x_nhwc.shape) == (16, DET_HW[0] // 32, DET_HW[1] // 32, 512)
          and k2_err <= K2_F32_REL_TOL * k2_scale,
          f"phase 12: K2 residual_block f32 at the trained trunk's layer4[1] "
          f"{tuple(x_nhwc.shape)}: max abs err {k2_err:.3e} (tol {K2_F32_REL_TOL} x max|ref| "
          f"{k2_scale:.3f})")
    k2_wrapper.launches = 0
    on_k2 = trainer.detect(batch16, max_det=DET_MAX_DET, score_threshold=0.0)
    k2_in_detect = k2_wrapper.launches
    block.forward = lambda t: residual_block_ref(*k2_ref_args(block, t)).permute(0, 3, 1, 2)
    try:
        on_ref = trainer.detect(batch16, max_det=DET_MAX_DET, score_threshold=0.0)
    finally:
        del block.forward  # the class's forward again
    same_cls = all([c for c, _, _ in a] == [c for c, _, _ in b] for a, b in zip(on_k2, on_ref))
    box_err = max(float(np.abs(np.array([bx for _, _, bx in a]) - np.array([bx for _, _, bx in b]))
                        .max()) for a, b in zip(on_k2, on_ref))
    check(k2_in_detect == K2_BLOCKS and same_cls and box_err <= BOX_TOL
          and all(len(d) == DET_MAX_DET for d in on_k2),
          f"phase 12: evaluate's first batch of 16 with layer4[1] on K2 ({k2_in_detect} launches, "
          f"one a fused block) "
          f"vs on residual_block_ref: the {DET_MAX_DET} best peaks' classes identical "
          f"{same_cls}, boxes max abs err {box_err:.3e} (tol {BOX_TOL})")
    k2 = k2_yardsticks(torch, block, x, k2_args, pack)

    # (e) Learning: 20 steps on one fixed batch.
    images, targets = next(detector_dataset("train", 2).batches(DET_BATCH, 1))
    fixed = (torch.from_numpy(images).to(dev), tuple(torch.from_numpy(t).to(dev) for t in targets))
    losses = [float(trainer.train_step(*fixed)[0]) for _ in range(LEARN_STEPS)]
    check(losses[-1] < losses[0],
          f"phase 12: loss on one fixed batch over {LEARN_STEPS} steps: {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")

    # (f) The wire: an epoch of WIRE_STEPS steps profiled in a fresh process
    # copies each step's images and targets, and no weights.
    audit = profile_in_fresh_process("detector")
    k2_dev_ms = audit["k2_device_ms"]
    h2d = audit["h2d"]
    wire = [images.nbytes] + [t.nbytes for t in targets]
    busy_share = audit["busy_us"] / audit["wall_us"]
    log(f"phase 12: an epoch of {WIRE_STEPS} steps profiled in a fresh process: {len(h2d)} "
        f"host-to-device copies in the trace ({h2d.count(None)} without a size); "
        f"{audit['calls']} cudaMemcpy calls traced on the host, {audit['lost']} with no copy on "
        f"the device; profiler notes of dropped records: {audit['notes'] or 'none'}; K2 f32 at "
        f"{tuple(audit['k2_shape'])} device "
        f"{'not measured' if k2_dev_ms is None else f'{k2_dev_ms:.4f} ms'} "
        f"({audit['k2_records_per_call']:g} of 2 kernel records a call traced); {card}")
    check(sum(wire) == DET_STEP_BYTES and None not in h2d
          and sorted(h2d) == sorted(wire * WIRE_STEPS),
          f"phase 12: host-to-device copies of {WIRE_STEPS} profiled train steps: {len(h2d)} "
          f"copies, {sum(b for b in h2d if b)} B = {WIRE_STEPS} x {DET_STEP_BYTES} B (a step's "
          f"uint8 images and float32 heat, size, offset and mask; no weights); device busy "
          f"{audit['busy_us'] / 1e3:.1f} ms of {audit['wall_us'] / 1e3:.1f} ms wall = "
          f"{busy_share:.3f}")

    # (g) The steady state, a batch assembled alone, a step alone.
    rate = steady_steps_per_sec(
        torch, trainer, STEADY_STEPS,
        lambda: trainer.fit(STEADY_STEPS, batch_size=DET_BATCH, log_every=STEADY_STEPS))
    timer = StageTimer()
    wire_batches = detector_dataset("train", 3).batches(DET_BATCH, HOST_BATCHES)
    for _ in range(HOST_BATCHES):
        with timer.stage("assemble"):
            next(wire_batches)
    trainer.train_step(*fixed)
    torch.cuda.synchronize()
    with timer.stage("steps"):
        for _ in range(HOST_BATCHES):
            trainer.train_step(*fixed)
        torch.cuda.synchronize()
    assemble_ms = 1e3 * timer.totals["assemble"] / HOST_BATCHES
    step_ms = 1e3 * timer.totals["steps"] / HOST_BATCHES
    final = trainer.evaluate(detector_dataset("validation", 4), num_images=DET_EVAL_IMAGES)
    log(f"phase 12: steady state over steps 3-{STEADY_STEPS} of a fit of {STEADY_STEPS}: "
        f"{rate:.3f} steps/s = {rate * DET_BATCH:.1f} images/s; a batch assembled alone on the "
        f"host {assemble_ms:.2f} ms, a train step alone on a batch on the card {step_ms:.2f} ms "
        f"(means of {HOST_BATCHES}); evaluate after {DET_FIT_STEPS + LEARN_STEPS + STEADY_STEPS} "
        f"steps: {final}; K2 f32 at {tuple(x_nhwc.shape)}: call {k2['ms']:.4f} ms, plain "
        f"{k2['plain_ms']:.4f} ms, cuDNN chain {k2['library_ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.4f} ms (3 x {k2['gflop']:.2f} GFLOP TF32); {card}")
    return {"launches": eval_launches, "eval_launches": eval_launches,
            "train_step_launches": fit_launches[1], "k1_launches": fit_launches[0],
            "max_abs_err": k2_err, "shape": list(x_nhwc.shape), "ms": k2["ms"],
            "device_ms": k2_dev_ms, "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "library_ms": k2["library_ms"], "steps_per_sec": rate, "images_per_sec": rate * DET_BATCH,
            "busy_share": busy_share, "assemble_ms": assemble_ms, "step_ms": step_ms,
            "evaluate": final, "cli_s": cli_s, "fit_s": fit_s}


# ---- phase 13: the multi-device path ----
MESH_STEPS = 2             # steps after the first in each meshed run (phase 13's depth)
MESH_REL_TOL = 2e-4        # meshed against one process: the JAX dry run's bound
MESH_STATS_REL_TOL = 1e-5  # batch-norm running statistics, of max|ref| per tensor
MESH_CONF_TOL = 1e-4       # VodAnalyzer(mesh=) confidences against mesh=None, abs
MESH_TIMEOUT_S = 420       # (b)'s two gloo ranks, together
MESH_WORK = os.path.join(ROOT, "build", "smoke", "mesh")
MESH_STORE_ENV = "CHIP_SMOKE_MESH_STORE"


def mesh_cases(dev):
    """Phase 13's training runs, as parallel/dryrun.run_train_case cases,
    and phase 10's first batch (frames, chars, labels) that they train on:
    CNN-63 from the bench weights, and the ResFormer at full width (63
    classes, T 7, 128 px, batch 8) from seeded weights, checkpointed after
    its first step; the ResFormer's one step on dryrun_multichip's input
    (uniform frames and labels from seed 0); and the RNN at full width
    (hidden 512, 3 layers) from seeded weights."""
    from playaid_core_torch.convert import from_jax_cnn, load_npz_tree

    batch = next(train_dataset("train", seed=1).batches(TRAIN_BATCH, 1))
    base = {"num_actions": len(train_actions()), "sequence_length": TRAIN_T, "crop_size": CROP,
            "device": str(dev), "lr": TRAIN_LR, "frames": batch[0],
            "labels": batch[2].astype(np.int64), "seed": FAMILY_SEED, "steps": 1 + MESH_STEPS}
    cnn = dict(base, family="cnn", init=from_jax_cnn(load_npz_tree(ASSET)))
    resformer = dict(base, family="resformer", save=os.path.join(MESH_WORK, "ckpt"), save_at=1)
    gen = np.random.default_rng(0)
    uniform = dict(base, family="resformer", steps=1,
                   frames=gen.integers(0, 256, batch[0].shape, dtype=np.uint8),
                   labels=gen.integers(0, len(train_actions()), batch[2].shape).astype(np.int64))
    rnn = dict(base, family="rnn")
    return cnn, resformer, uniform, rnn, batch


def lstm_ms(torch, dev, model_parallel, reps=6):
    """The RNN's 3-layer LSTM (300 -> 512) alone, forward and backward at a
    step's shape [TRAIN_BATCH, TRAIN_T, 300] in full float32: the median ms
    of reps - 1 synchronised runs after one, whole (cuDNN's nn.LSTM) or on
    a (1, model_parallel) mesh of the world's ranks (this rank's gate rows,
    hand-stepped; every rank calls it)."""
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.models.rnn_action_detector import StackedLSTM
    from playaid_core_torch.parallel.mesh import attach_mesh, make_mesh

    holder = torch.nn.Module()
    holder.lstm = StackedLSTM(300, 512, 3)
    holder.to(dev)
    if model_parallel > 1:
        attach_mesh(holder, make_mesh(model_parallel=model_parallel, device=dev),
                    split_batch=False)
    x = torch.randn((TRAIN_BATCH, TRAIN_T, 300), generator=torch.Generator().manual_seed(0))
    x = x.to(dev).requires_grad_(True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with full_float32():
            holder.lstm(x).sum().backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def mesh_rank_main(rank):
    """python3 chip_smoke.py --mesh-rank R: rank R of phase 13 (b)'s two gloo
    ranks on cuda:0 (the file store in $CHIP_SMOKE_MESH_STORE).  CNN-63 on a
    (2, 1) mesh, this rank's rows of a batch through device_prefetch under
    torch.profiler, the ResFormer on a (1, 2) mesh; one JSON line."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from playaid_core_torch.parallel.dryrun import run_train_case
    from playaid_core_torch.parallel.mesh import batch_sharding, make_mesh
    from playaid_core_torch.parallel.staging import device_prefetch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=os.environ[MESH_STORE_ENV], world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        cnn, resformer, uniform, rnn, batch = mesh_cases(dev)
        out = {"rank": rank}
        out["cnn"] = run_train_case(dict(cnn, model_parallel=1,
                                         out=os.path.join(MESH_WORK, "cnn_2x1_step{step}.pt")))
        run_train_case(dict(cnn, model_parallel=1, double=True,
                            out=os.path.join(MESH_WORK, "cnn64_2x1_step{step}.pt")))
        mesh = make_mesh(device=dev)
        # CNN-63's gradient all-reduce alone: one flat float32 buffer of its
        # parameters' size over data, after a warm-up.
        flat = torch.zeros(sum(v.numel() for part in cnn["init"].values()
                               for k, v in part.items()
                               if not k.endswith(("running_mean", "running_var",
                                                  "num_batches_tracked"))), device=dev)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh.all_reduce_(flat, "data")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["grad_all_reduce_ms"] = times[1:]
        out["grad_all_reduce_bytes"] = flat.numel() * 4
        rows = batch_sharding(mesh)
        trace = os.path.join(MESH_WORK, f"h2d_rank{rank}.json")
        prof = profile_h2d(torch, lambda: list(device_prefetch([batch], 1, dev, rows)), trace)
        out["h2d"] = prof["h2d"]
        out["row_bytes"] = [int(rows(a).nbytes) for a in batch]
        out["resformer"] = run_train_case(dict(resformer, model_parallel=2))
        out["resformer64"] = run_train_case(dict(resformer, model_parallel=2, double=True,
                                                 save=None, steps=1))
        out["uniform"] = run_train_case(dict(uniform, model_parallel=2))
        out["rnn"] = run_train_case(dict(rnn, model_parallel=2))
        out["rnn_lstm_ms"] = lstm_ms(torch, dev, 2)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def run_gloo_ranks(check):
    """Phase 13 (b): start both ranks, wait for both (MESH_TIMEOUT_S), and
    return their JSON results (None where a rank failed)."""
    store = os.path.join(MESH_WORK, "gloo_store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, **{MESH_STORE_ENV: "file://" + store})
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    results = []
    deadline = time.monotonic() + MESH_TIMEOUT_S
    for r, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            check(False, f"phase 13: the gloo ranks did not finish within {MESH_TIMEOUT_S} s")
            return [None, None]
        ok = proc.returncode == 0
        check(ok, f"phase 13: gloo rank {r} exited {proc.returncode}"
              + ("" if ok else f":\n{stderr[-3000:]}"))
        results.append(json.loads(stdout.strip().splitlines()[-1]) if ok else None)
    return results


def rel_err(a, b):
    return abs(a - b) / abs(b)


def stats_rel_err(got, ref):
    """The worst batch-norm running statistic of two whole state files, as
    max|got - ref| / max|ref| per tensor."""
    worst = 0.0
    for part in ("embed", "head"):
        for k, v in ref[part].items():
            if k.endswith(("running_mean", "running_var")):
                worst = max(worst, float((got[part][k] - v).abs().max() / v.abs().max()))
    return worst


def run_mesh_phase(torch, dev, check, card, k2_wrapper, boxes_all, stand_in, vod_fps):
    """Phase 13: the meshed Trainer over NCCL at world size 1, two gloo ranks
    sharing the card, VodAnalyzer on a mesh of two replicas on the card, and
    the checkpoint across meshes.  Returns K2's numbers of the phase."""
    import datetime

    import torch.distributed as dist

    from playaid_core_torch.device import full_float32
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.infer.vod_pipeline import VodAnalyzer
    from playaid_core_torch.ops.conv_block import residual_block_packed, residual_block_ref
    from playaid_core_torch.ops.viterbi import viterbi_decode
    from playaid_core_torch.ops.yuv import yuv420_to_rgb
    from playaid_core_torch.parallel.dryrun import run_train_case
    from playaid_core_torch.parallel.mesh import make_mesh
    from playaid_core_torch.train.train import Trainer

    os.makedirs(MESH_WORK, exist_ok=True)
    t_phase = time.perf_counter()
    cnn, resformer, uniform, rnn, batch = mesh_cases(dev)
    k2 = {}

    def k2_against_plain(block, x):
        with torch.inference_mode(), full_float32():
            args = k2_ref_args(block, x)
            out = residual_block_packed(args[0], block.block_pack(torch.float32))
            ref = residual_block_ref(*args)
        return float((out - ref).abs().max()), float(ref.abs().max()), tuple(args[0].shape)

    # (a) One rank over NCCL: the meshed step against the plain one.
    store = os.path.join(MESH_WORK, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method="file://" + store, world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        one = {"steps": 1}
        meshed = run_train_case(dict(cnn, model_parallel=1, **one))
        plain = run_train_case(dict(cnn, devices=[str(dev)], **one))
        errs = [rel_err(meshed[k][0], plain[k][0]) for k in ("losses", "grad_norms")]
        check(tuple(meshed["mesh"]) == (1, 1) and max(errs) <= MESH_REL_TOL,
              f"phase 13 (a): CNN-63 step on a {tuple(meshed['mesh'])} NCCL mesh (world size 1, "
              f"file store) vs the plain Trainer step: loss {meshed['losses'][0]:.6f} vs "
              f"{plain['losses'][0]:.6f} (rel {errs[0]:.3e}), grad norm "
              f"{meshed['grad_norms'][0]:.6f} vs {plain['grad_norms'][0]:.6f} (rel {errs[1]:.3e}); "
              f"tol {MESH_REL_TOL}; step {meshed['seconds'][0] * 1e3:.1f} ms (plain "
              f"{plain['seconds'][0] * 1e3:.1f} ms, first steps); collectives "
              f"{json.dumps(meshed['bytes'])}; {card}")
        trainer = Trainer(train_config("cnn", device=str(dev)), None)
        trainer.init_state(FAMILY_SEED)
        trainer.load_whole(cnn["init"])
        block = trainer.model.embed.layer4[1]
        seen = {}
        hook = block.register_forward_hook(keep_input(seen))
        k2_wrapper.launches = 0
        result = trainer.evaluate(train_dataset("validation", seed=2), num_batches=1)
        k2["evaluate_launches"] = k2_wrapper.launches
        hook.remove()
        err, scale, shape = k2_against_plain(block, seen["x"])
        k2["evaluate_max_abs_err"] = err
        check(trainer.mesh.distributed and k2["evaluate_launches"] == K2_BLOCKS
              and err <= K2_F32_REL_TOL * scale and np.isfinite(result["loss"]),
              f"phase 13 (a): meshed evaluate on {trainer.mesh}: loss {result['loss']:.4f}, "
              f"K2 launches {k2['evaluate_launches']}; K2 at layer4[1] {shape} vs "
              f"residual_block_ref: max abs err {err:.3e} (tol {K2_F32_REL_TOL} x max|ref| "
              f"{scale:.3f}); {card}")
    finally:
        dist.destroy_process_group()

    # (b) Two gloo ranks sharing the card: CNN-63 on (2, 1), the ResFormer on (1, 2).
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_gloo_ranks(check)
    log(f"phase 13 (b): both gloo ranks (python3 chip_smoke.py --mesh-rank 0|1) took "
        f"{time.perf_counter() - t0:.1f} s; gloo takes the CUDA tensors as they are "
        f"(tools/torch_port_gloo_cuda_probe.py); {card}")
    ref_cnn = run_train_case(dict(cnn, devices=[str(dev)],
                                  out=os.path.join(MESH_WORK, "cnn_1x1_step{step}.pt")))
    run_train_case(dict(cnn, devices=[str(dev)], double=True,
                        out=os.path.join(MESH_WORK, "cnn64_1x1_step{step}.pt")))
    ref_res = run_train_case(dict(resformer, devices=[str(dev)], save=None, steps=1))
    ref_res64 = run_train_case(dict(resformer, devices=[str(dev)], save=None, steps=1,
                                    double=True))
    ref_uniform = run_train_case(dict(uniform, devices=[str(dev)]))
    ref_rnn = run_train_case(dict(rnn, devices=[str(dev)]))
    ref_rnn_lstm_ms = lstm_ms(torch, dev, 1)
    if None not in ranks:
        for family, key, ref, shape, what in (
                ("cnn", "cnn", ref_cnn, (2, 1), "phase 10's batch, float32"),
                ("resformer", "uniform", ref_uniform, (1, 2),
                 "dryrun_multichip's uniform frames, float32"),
                ("resformer", "resformer64", ref_res64, (1, 2), "phase 10's batch, float64")):
            for r, res in enumerate(ranks):
                got = res[key]
                errs = [rel_err(got[k][0], ref[k][0]) for k in ("losses", "grad_norms")]
                check(tuple(got["mesh"]) == shape and max(errs) <= MESH_REL_TOL,
                      f"phase 13 (b): rank {r} {family} on {shape} ({what}): first-step loss "
                      f"{got['losses'][0]:.9f} vs one process {ref['losses'][0]:.9f} (rel "
                      f"{errs[0]:.3e}), grad norm {got['grad_norms'][0]:.9f} vs "
                      f"{ref['grad_norms'][0]:.9f} (rel {errs[1]:.3e}); tol {MESH_REL_TOL}; {card}")
        # On phase 10's batch one float32 ReLU input of the last encoder
        # layer lies within rounding of 0, and its sign follows the summation
        # order (tools/torch_port_resformer_f32_probe.py): there the float32
        # grad norms are read beside float64's, and the loss is held.
        g64 = ref_res64["grad_norms"][0]
        for r, res in enumerate(ranks):
            got = res["resformer"]
            loss_err = rel_err(got["losses"][0], ref_res["losses"][0])
            check(tuple(got["mesh"]) == (1, 2) and loss_err <= MESH_REL_TOL,
                  f"phase 13 (b): rank {r} resformer on (1, 2) (phase 10's batch, float32): "
                  f"first-step loss rel {loss_err:.3e} to one process (tol {MESH_REL_TOL}); "
                  f"grad norm {got['grad_norms'][0]:.9f}, one process "
                  f"{ref_res['grad_norms'][0]:.9f}, float64 {g64:.9f}: rel to float64 "
                  f"{rel_err(got['grad_norms'][0], g64):.3e} on the mesh, "
                  f"{rel_err(ref_res['grad_norms'][0], g64):.3e} on one process; {card}")
        # The RNN at full width with its LSTM split over model (this rank's
        # gate rows, stepped by hand, h gathered at every step).
        for r, res in enumerate(ranks):
            got = res["rnn"]
            errs = [rel_err(got[k][0], ref_rnn[k][0])
                    for k in ("losses", "grad_norms", "param_norms")]
            check(tuple(got["mesh"]) == (1, 2) and max(errs) <= MESH_REL_TOL,
                  f"phase 13 (b): rank {r} rnn on (1, 2) (LSTM gate rows split over model; "
                  f"phase 10's batch, float32): first-step loss {got['losses'][0]:.9f} vs one "
                  f"process {ref_rnn['losses'][0]:.9f} (rel {errs[0]:.3e}), grad norm rel "
                  f"{errs[1]:.3e}, param norm rel {errs[2]:.3e}; tol {MESH_REL_TOL}; {card}")
        got = ranks[0]["rnn"]
        steps = len(got["seconds"])
        step_ms = float(np.median(got["seconds"][1:])) * 1e3
        model_calls = {k: v / steps for k, v in got["calls"].items() if k.endswith("/model")}
        model_bytes = {k: v / steps for k, v in got["bytes"].items() if k.endswith("/model")}
        log(f"phase 13 (b): rnn on (1, 2): step ms {[round(v * 1e3, 1) for v in got['seconds']]}"
            f" (one process {[round(v * 1e3, 1) for v in ref_rnn['seconds']]}); model-axis "
            f"collectives a step {json.dumps(model_calls)}, their bytes a step "
            f"{json.dumps(model_bytes)}; all collectives over {steps} steps "
            f"{json.dumps(got['calls'])}; the LSTM alone, forward and backward: "
            f"{ranks[0]['rnn_lstm_ms']:.1f} ms on the mesh = "
            f"{ranks[0]['rnn_lstm_ms'] / step_ms:.3f} of the median later step "
            f"({step_ms:.1f} ms), {ref_rnn_lstm_ms:.1f} ms whole on one process (cuDNN); {card}")
        log(f"phase 13 (b): CNN-63's gradient all-reduce alone over gloo (one flat float32 "
            f"buffer of {ranks[0]['grad_all_reduce_bytes']} B, CUDA tensors): ms "
            f"{[round(t, 1) for t in ranks[0]['grad_all_reduce_ms']]} on rank 0; {card}")
        for family, ref, shape in (("cnn", ref_cnn, (2, 1)), ("resformer", ref_res, (1, 2))):
            got = ranks[0][family]
            log(f"phase 13 (b): {family} on {shape}: step ms "
                f"{[round(s * 1e3, 1) for s in got['seconds']]} (one process "
                f"{[round(s * 1e3, 1) for s in ref['seconds']]}); bytes each collective moved "
                f"over {len(got['seconds'])} steps, rank 0: {json.dumps(got['bytes'])}; {card}")
        # The batch-norm running statistics after step 1 (the batch's statistics
        # over the mesh alone) and after the last.  Two float32 runs drift
        # apart through the Adam steps from the backward's rounding, one
        # process against itself too (its step-1 gradients differ by up to
        # 1.7e-5 of max|g|, deterministic algorithms or not), so the later
        # steps' statistics measure that drift, not the mesh
        # (tools/torch_port_mesh_bn.py).  After the last step they are held on
        # runs in float64, where two runs agree to about 1e-15.
        def stats_after(prefix, step):
            paths = [os.path.join(MESH_WORK, f"{prefix}_{m}_step{step}.pt") for m in ("2x1", "1x1")]
            return stats_rel_err(*(torch.load(p, weights_only=True) for p in paths))

        last = 1 + MESH_STEPS
        f32 = [stats_after("cnn", step) for step in (1, last)]
        f64 = [stats_after("cnn64", step) for step in (1, last)]
        check(f32[0] <= MESH_STATS_REL_TOL,
              f"phase 13 (b): CNN-63 on (2, 1) after step 1 in float32: batch-norm running "
              f"statistics vs one process, worst max err / max|ref| {f32[0]:.3e} (tol "
              f"{MESH_STATS_REL_TOL}); after step {last} {f32[1]:.3e}, not held; {card}")
        check(f64[1] <= MESH_STATS_REL_TOL,
              f"phase 13 (b): CNN-63 on (2, 1) after {last} steps in float64: batch-norm running "
              f"statistics vs one process, worst max err / max|ref| {f64[1]:.3e} (tol "
              f"{MESH_STATS_REL_TOL}); after step 1 {f64[0]:.3e}; {card}")
        for r, res in enumerate(ranks):
            check(sorted(res["h2d"]) == sorted(res["row_bytes"]),
                  f"phase 13 (b): rank {r}: host-to-device copies of a batch through "
                  f"device_prefetch(sharding=batch_sharding) under torch.profiler: "
                  f"{sorted(res['h2d'])} B = its rows {sorted(res['row_bytes'])} B (the whole "
                  f"batch: {sorted(int(a.nbytes) for a in batch)} B); {card}")

        # (d) The (1, 2) ResFormer's checkpoint (after its first step) on one process.
        path = ranks[0]["resformer"]["checkpoint"]
        resumed = run_train_case(dict(resformer, devices=[str(dev)], save=None, restore=path,
                                      steps=MESH_STEPS))
        cont = ranks[0]["resformer"]["losses"][1:]
        err = max(rel_err(a, b) for a, b in zip(resumed["losses"], cont))
        check(err <= MESH_REL_TOL,
              f"phase 13 (d): {os.path.relpath(path, ROOT)} written on (1, 2), restored on one "
              f"process: continuation losses {[round(v, 6) for v in resumed['losses']]} vs "
              f"{[round(v, 6) for v in cont]} on the mesh, worst rel {err:.3e} (tol "
              f"{MESH_REL_TOL}); {card}")
        pipe = BatchedActionPipeline("resformer", len(train_actions()), TRAIN_T,
                                     device=dev).load_checkpoint(path)
        whole = pipe.head.layers[0].linear1.weight.shape == (2048, 256)
        check(whole, f"phase 13 (d): BatchedActionPipeline.load_checkpoint read it on {dev} "
              f"(whole tensors: linear1 {tuple(pipe.head.layers[0].linear1.weight.shape)}); "
              f"{card}")

    # (c) VodAnalyzer on a single-process mesh of two replicas on the card.
    from playaid_core_torch.convert import load_npz_tree

    kw = dict(decode_backend="native", transfer_format="yuv420", stride=STRIDE, chunk=CHUNK,
              switch_cost=SWITCH_COST, decode="viterbi")
    pipe = BatchedActionPipeline(device=dev)
    single = VodAnalyzer(pipe, variables=load_npz_tree(ASSET), **kw)
    meshed = VodAnalyzer(pipe, mesh=make_mesh(devices=[dev, dev]), **kw)
    single.analyze("disc_clip.mp4", boxes_all)  # warm-up: the stand-in's crops, cuDNN plans
    meshed.analyze("disc_clip.mp4", boxes_all)
    blocks = [p.embed.layer4[1] for p, _ in meshed._replicas]
    seen = [{} for _ in blocks]
    hooks = [b.register_forward_hook(keep_input(s)) for b, s in zip(blocks, seen)]
    k2_wrapper.launches = viterbi_decode.launches = yuv420_to_rgb.launches = 0
    res_mesh = meshed.analyze("disc_clip.mp4", boxes_all)
    k2["vod_launches"] = k2_wrapper.launches
    k2["vod_k3_launches"] = viterbi_decode.launches
    k2["vod_k4_launches"] = yuv420_to_rgb.launches
    for h in hooks:
        h.remove()
    res_single = single.analyze("disc_clip.mp4", boxes_all)
    num_chunks = (NUM_FRAMES + CHUNK - 1) // CHUNK
    same = bool(np.array_equal(res_mesh["labels"], res_single["labels"]))
    conf = float(np.abs(res_mesh["confidences"] - res_single["confidences"]).max())
    check(same and conf <= MESH_CONF_TOL and k2["vod_launches"] == 2 * K2_BLOCKS * num_chunks
          and k2["vod_k4_launches"] == 2 * num_chunks and k2["vod_k3_launches"] == 1
          and blocks[0] is not blocks[1],
          f"phase 13 (c): VodAnalyzer(mesh=make_mesh(devices=[{dev}, {dev}])) over "
          f"{NUM_FRAMES} frames: labels identical to mesh=None {same}, confidences max abs "
          f"diff {conf:.3e} (tol {MESH_CONF_TOL}); K2 launches {k2['vod_launches']} = 2 "
          f"replicas x {num_chunks} chunks x {K2_BLOCKS} fused blocks, K4 (yuv420_unpack) "
          f"{k2['vod_k4_launches']} = 2 replicas x {num_chunks} chunks, K3 "
          f"(viterbi) {k2['vod_k3_launches']} (one classify_buffer); {card}")
    errs = []
    for r, (block, s) in enumerate(zip(blocks, seen)):
        err, scale, shape = k2_against_plain(block, s["x"])
        errs.append(err)
        check(err <= K2_F32_REL_TOL * scale,
              f"phase 13 (c): replica {r}: K2 at layer4[1] {shape} vs residual_block_ref: max "
              f"abs err {err:.3e} (tol {K2_F32_REL_TOL} x max|ref| {scale:.3f}); {card}")
    k2["vod_max_abs_err"] = max(errs)
    with torch.inference_mode(), full_float32():
        args = k2_ref_args(blocks[0], seen[0]["x"])
    yard = k2_yardsticks(torch, blocks[0], seen[0]["x"], args,
                         blocks[0].block_pack(torch.float32))
    k2.update({f"vod_{k}": v for k, v in yard.items() if k != "gflop"})
    k2["vod_shape"] = list(args[0].shape)
    log(f"phase 13 (c): K2 f32 at {tuple(args[0].shape)} (a replica's half of a chunk): call "
        f"{yard['ms']:.4f} ms, plain {yard['plain_ms']:.4f} ms, cuDNN chain "
        f"{yard['library_ms']:.4f} ms, bound {yard['bound_ms']:.4f} ms (3 x "
        f"{yard['gflop']:.2f} GFLOP TF32); {card}")
    log(f"phase 13 (c): frames/s with two replicas on the card {res_mesh['fps']:.1f}, one "
        f"{res_single['fps']:.1f} in this phase, phase 6's {vod_fps:.1f} (Viterbi runs, decode "
        f"stand-in); {card}")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s; {card}")
    return k2


# ---- phase 14: OCR training and the evaluation dashboards ----
# The card's machine has no PIL, cv2 or matplotlib: the OCR batches are the
# committed fixture that tools/torch_port_ocr_fixture.py renders with the
# port's synth_batch on a machine that has them.
OCR_FIXTURE = os.path.join(ROOT, "playaid_core_torch", "assets", "ocr_synth_batches.npz")
OCR_STEPS = 50            # cycling the fixture's 8 batches of 128
OCR_LR = 2e-3             # ocr_conv.train's default
OCR_SEED = 0
OCR_WIRE_STEPS = 5        # steps of the profiled run (--profile ocr)
OCR_LOGIT_TOL = 1e-4      # the saved weights through ConvDigitOCR vs the model, abs
DASH_SAMPLES = 16         # evaluate_samples over phase 10's validation tree
DASH_SEED = 3
VIS_EVERY = 10            # write_vis_ai_report's sample_every on phase 9's runner
MESH_ROWS = 24            # a VOD replica's rows (phase 13 (c)): K2's device ms there


def ocr_fixture():
    """The fixture's patches [8, 128, 48, 48, 1] float32, labels [8, 128]
    int32 and provenance."""
    with np.load(OCR_FIXTURE) as z:
        return z["x"], z["y"], json.loads(str(z["provenance"]))


def cnn63(torch, where):
    """The CNN-63 from the bench weights, in eval mode on ``where``."""
    from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
    from playaid_core_torch.train.train import build_model

    model, _ = build_model("cnn", len(train_actions()), TRAIN_T)
    load_bench(model, from_jax_cnn(load_npz_tree(ASSET)))
    return model.to(where).eval()


def cnn63_apply(torch, model, where, outputs=None):
    """evaluate_samples' model_apply for ``model``: the uint8 sample to
    ``where``, /255 there, log-probs in full float32 (kept in ``outputs``)."""
    from playaid_core_torch.device import full_float32

    def apply(frames):
        with full_float32():
            out = model(frames.to(where).float() / 255.0)
        if outputs is not None:
            outputs.append(out.cpu())
        return out
    return apply


def png_pixels(b64):
    """An inline PNG of the port's writer (8-bit grey, RGB or RGBA, unfiltered
    rows) decoded with zlib alone: the pixels as a uint8 array."""
    import base64
    import struct
    import zlib

    data, pos, idat, header = base64.b64decode(b64), 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, colour = header[:4]
    channels = {0: 1, 2: 3, 6: 4}[colour]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    if depth != 8 or rows[:, 0].any():
        raise ValueError("not a PNG of unfiltered 8-bit rows")
    return rows[:, 1:].reshape((h, w) if channels == 1 else (h, w, channels))


def k2_dashboard_input(torch, model, dataset, samples=1):
    """layer4[1] of the CNN-63 ``model`` and its input on ``samples`` samples
    of ``dataset`` (T rows each)."""
    block = model.embed.layer4[1]
    seen = {}
    hook = block.register_forward_hook(keep_input(seen))
    frames = np.stack([dataset[i][0] for i in range(samples)])
    with torch.no_grad():
        cnn63_apply(torch, model, block.conv1.weight.device)(torch.from_numpy(frames))
    hook.remove()
    return block, seen["x"]


def profile_ocr(torch, dev):
    """profile_main's ocr kind: OCR_WIRE_STEPS of the port's OCR train steps
    on the fixture, once unprofiled and once under profile_h2d; then K2's
    device time at the dashboard's 7x4x4x512 (one sample of phase 10's
    validation tree) and at a VOD replica's 24x4x4x512 (the first 24 rows
    of four samples), on the bench weights' layer4[1]."""
    from playaid_core_torch.infer.ocr_conv import init_model, make_optimizer, train_step
    from playaid_core_torch.ops.conv_block import residual_block_packed

    xs, ys, _ = ocr_fixture()
    model = init_model(OCR_SEED, dev)
    optimizer, scheduler = make_optimizer(model, OCR_LR, OCR_STEPS)

    def run():
        for i in range(OCR_WIRE_STEPS):
            train_step(model, optimizer, scheduler, xs[i], ys[i])

    run()
    result = profile_h2d(torch, run, os.path.join(ROOT, "build", "smoke", "ocr_trace.json"))
    net = cnn63(torch, dev)
    for key, samples, rows in (("dashboard", 1, TRAIN_T), ("mesh", 4, MESH_ROWS)):
        block, x = k2_dashboard_input(torch, net, train_dataset("validation", seed=DASH_SEED),
                                      samples)
        with torch.inference_mode():
            x_nhwc = k2_ref_args(block, x[:rows])[0]
            pack = block.block_pack(torch.float32)
            ms, traced = device_ms(torch, lambda _: residual_block_packed(x_nhwc, pack), 40,
                                   "conv3x3_wgmma_kernel", 2)
        result.update({f"k2_{key}_device_ms": ms, f"k2_{key}_records_per_call": traced,
                       f"k2_{key}_shape": list(x_nhwc.shape)})
    return result


def run_ocr_viz_phase(torch, dev, check, card, k2_wrapper, runner):
    """Phase 14: OCR training (the port's step, schedule and optimizer on the
    fixture's batches), evaluate_samples with the CNN-63 on the card, and
    write_vis_ai_report on phase 9's runner.  Returns K2's numbers at the
    dashboard's shape and its launches."""
    import re

    from playaid_core_torch import imgcodec
    from playaid_core_torch.convert import to_jax_digits
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.infer.ocr_conv import (
        ConvDigitOCR,
        init_model,
        load_params,
        make_optimizer,
        save_params,
        train_step,
    )
    from playaid_core_torch.ops.conv_block import residual_block_packed, residual_block_ref
    from playaid_core_torch.viz.eval_dashboard import evaluate_samples
    from playaid_core_torch.viz.vis_ai import collect_vis_records, write_vis_ai_report

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "smoke", "ocr")
    os.makedirs(work, exist_ok=True)
    xs, ys, prov = ocr_fixture()
    log(f"phase 14: not run on this machine, which has no PIL, cv2 or matplotlib: rendering "
        f"(render_hud_text, synth_batch), train()'s loop over it, the template reader's "
        f"templates and the matplotlib figures (confusion matrix, training report); the OCR "
        f"batches are {os.path.relpath(OCR_FIXTURE, ROOT)}, {xs.shape[0]} x {xs.shape[1]} "
        f"patches rendered by {prov['tool']} (seed {prov['seed']}, {len(prov['fonts'])} fonts, "
        f"PIL {prov['PIL']}, cv2 {prov['cv2']})")

    # (a) One step on the card against the CPU in float64, from one init.
    runs = {}
    for key, where, dtype in (("card", dev, torch.float32), ("float64", "cpu", torch.float64)):
        model = init_model(OCR_SEED, where).to(dtype)
        optimizer, scheduler = make_optimizer(model, OCR_LR, OCR_STEPS)
        loss, _ = train_step(model, optimizer, scheduler, xs[0], ys[0])
        runs[key] = (float(loss), {n: p.grad.detach().cpu().double()
                                   for n, p in model.named_parameters()})
    ref_loss, ref_grads = runs["float64"]
    errs = {n: float((runs["card"][1][n] - g).abs().max() / g.abs().max())
            for n, g in ref_grads.items()}
    loss_rel = abs(runs["card"][0] - ref_loss) / abs(ref_loss)
    worst = max(errs, key=errs.get)
    check(loss_rel <= LOSS_REL_TOL and errs[worst] <= GRAD_REL_TOL,
          f"phase 14 (a): one OCR step (DigitNet, batch {xs.shape[1]}, {OCR_LR} lr) on the card "
          f"vs the CPU in float64: loss {runs['card'][0]:.6f} vs {ref_loss:.6f}, rel err "
          f"{loss_rel:.3e} (tol {LOSS_REL_TOL}); gradients max err / max|g| worst "
          f"{errs[worst]:.3e} on {worst} (tol {GRAD_REL_TOL})")

    # OCR_STEPS steps cycling the fixture; steps 3-OCR_STEPS timed on the card.
    model = init_model(OCR_SEED, dev)
    optimizer, scheduler = make_optimizer(model, OCR_LR, OCR_STEPS)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    for i in range(OCR_STEPS):
        if i == 2:
            start.record()
        losses.append(train_step(model, optimizer, scheduler, xs[i % len(xs)],
                                 ys[i % len(xs)])[0])
    stop.record()
    torch.cuda.synchronize()
    steps_per_s = (OCR_STEPS - 2) / (start.elapsed_time(stop) / 1e3)
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()) and losses[-10:].mean() < losses[:10].mean()
          and scheduler.last_epoch == OCR_STEPS,
          f"phase 14 (a): {OCR_STEPS} OCR steps on the card: float32 loss of the first 10 "
          f"{losses[:10].mean():.4f}, of the last 10 {losses[-10:].mean():.4f} (must fall); "
          f"steady {steps_per_s:.1f} steps/s = {steps_per_s * xs.shape[1]:.0f} patches/s "
          f"(steps 3-{OCR_STEPS}, CUDA events); {card}")

    audit = profile_in_fresh_process("ocr")
    want = [xs[0].nbytes, ys[0].nbytes] * OCR_WIRE_STEPS
    check(audit["h2d"] == want,
          f"phase 14 (a): host-to-device copies of {OCR_WIRE_STEPS} profiled OCR steps (python3 "
          f"chip_smoke.py --profile ocr): {audit['h2d'][:6]}... ({len(audit['h2d'])} copies, "
          f"{sum(b or 0 for b in audit['h2d'])} B); each step's batch is {xs[0].nbytes} B of "
          f"patches and {ys[0].nbytes} B of labels; busy {audit['busy_us'] / audit['wall_us']:.3f}")

    path = os.path.join(work, "ocr_digits.npz")
    save_params(to_jax_digits(model.state_dict()), path)
    reader = ConvDigitOCR(params=load_params(path), device=dev)
    model.eval()
    with torch.no_grad(), full_float32():
        ref = model(torch.from_numpy(xs[0]).to(dev)).cpu().numpy()
    logit_err = float(np.abs(reader.logits(xs[0]) - ref).max())
    check(logit_err <= OCR_LOGIT_TOL and reader.model.c1.weight.is_cuda,
          f"phase 14 (a): save_params -> {os.path.relpath(path, ROOT)} -> ConvDigitOCR("
          f"params=load_params(...)) on {dev}: logits of batch 0 max abs err {logit_err:.3e} "
          f"against the trained model (tol {OCR_LOGIT_TOL})")

    # (b) evaluate_samples: the CNN-63 from the bench weights, eval mode.
    card_model, cpu_model = cnn63(torch, dev), cnn63(torch, "cpu")
    evaluate_samples(cnn63_apply(torch, card_model, dev),
                     train_dataset("validation", seed=DASH_SEED + 1), 2)  # warm-up
    block = card_model.embed.layer4[1]
    seen = {}
    hook = block.register_forward_hook(keep_input(seen))
    outputs = {"card": [], "cpu": []}
    k2_wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records, agg = evaluate_samples(cnn63_apply(torch, card_model, dev, outputs["card"]),
                                    train_dataset("validation", seed=DASH_SEED), DASH_SAMPLES)
    dash_s = time.perf_counter() - t0
    launches = k2_wrapper.launches
    hook.remove()
    _, cpu_agg = evaluate_samples(cnn63_apply(torch, cpu_model, "cpu", outputs["cpu"]),
                                  train_dataset("validation", seed=DASH_SEED), DASH_SAMPLES)
    lp_err = float(max((a - b).abs().max() for a, b in zip(outputs["card"], outputs["cpu"])))
    check(launches == K2_BLOCKS * DASH_SAMPLES and agg["preds"] == cpu_agg["preds"]
          and agg["accuracy"] == cpu_agg["accuracy"] and lp_err <= LOG_PROB_TOL
          and len(records) == DASH_SAMPLES,
          f"phase 14 (b): evaluate_samples with the CNN-63 (bench weights) on {DASH_SAMPLES} "
          f"samples of phase 10's validation tree (T {TRAIN_T}, {CROP} px): "
          f"{DASH_SAMPLES / dash_s:.1f} samples/s; K2 launches {launches} ({K2_BLOCKS} a "
          f"sample); card "
          f"vs CPU predicted ids identical {agg['preds'] == cpu_agg['preds']}, accuracy "
          f"{agg['accuracy']:.4f} vs {cpu_agg['accuracy']:.4f}, log-probs max abs err "
          f"{lp_err:.3e} (tol {LOG_PROB_TOL}); {card}")
    with torch.inference_mode(), full_float32():
        args = k2_ref_args(block, seen["x"])
        pack = block.block_pack(torch.float32)
        k2_out = residual_block_packed(args[0], pack)
        k2_ref = residual_block_ref(*args)
    k2_err = float((k2_out - k2_ref).abs().max())
    k2_scale = float(k2_ref.abs().max())
    check(tuple(args[0].shape) == (TRAIN_T, 4, 4, 512) and k2_err <= K2_F32_REL_TOL * k2_scale,
          f"phase 14 (b): K2 residual_block f32 at the dashboard's layer4[1] "
          f"{tuple(args[0].shape)}: max abs err {k2_err:.3e} (tol {K2_F32_REL_TOL} x max|ref| "
          f"{k2_scale:.3f})")
    k2 = k2_yardsticks(torch, block, seen["x"], args, pack)
    k2["cuda_core_bound_ms"] = k2["gflop"] * 1e9 / PEAK_FP32_FLOPS * 1e3
    dev_ms = audit["k2_dashboard_device_ms"]
    log(f"phase 14 (b): K2 f32 at {tuple(args[0].shape)}: call {k2['ms']:.4f} ms, device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (--profile ocr, "
        f"{audit['k2_dashboard_records_per_call']:g} of 2 records a call), plain "
        f"{k2['plain_ms']:.4f} ms, cuDNN chain {k2['library_ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.4f} ms (3 x {k2['gflop']:.3f} GFLOP TF32; CUDA-core f32 bound "
        f"{k2['cuda_core_bound_ms']:.4f} ms); at {tuple(audit['k2_mesh_shape'])} (phase 13 "
        f"(c)'s shape) device {audit['k2_mesh_device_ms']} ms; {card}")

    # (c) write_vis_ai_report on phase 9's runner: ground truth is its own
    # labels for the first fighter, a move no model predicts for the second.
    f0, f1 = runner.fighters
    n = runner.max_frames - 1
    gt = {f0: [runner.ai_output_data[f0][i].action for i in range(n)], f1: ["__none__"] * n}
    t0 = time.perf_counter()
    path, vis_agg = write_vis_ai_report(os.path.join(work, "vis_ai.html"), runner, gt,
                                        sample_every=VIS_EVERY)
    vis_s = time.perf_counter() - t0
    records, _ = collect_vis_records(runner, gt, sample_every=VIS_EVERY)
    frames = list(range(1, runner.max_frames, VIS_EVERY))[:40]
    with open(path, encoding="utf-8") as f:
        text = f.read()
    pngs = re.findall(r"data:image/png;base64,([A-Za-z0-9+/=]+)", text)
    want = [imgcodec.read_crop(runner.get_crop_path(f, i))[:, :, ::-1]
            for i in frames for f in runner.fighters]
    decoded = len(pngs) == len(want) and all(np.array_equal(png_pixels(b), w)
                                             for b, w in zip(pngs, want))
    f0_agree = all(r["fighters"][0]["correct"] for r in records)
    check(text.count("<div class='strip'>") == len(frames) == vis_agg["sampled"]
          and f0_agree and vis_agg["full_agreement"] == 0.5 and decoded,
          f"phase 14 (c): write_vis_ai_report on phase 9's runner ({n} frames, every "
          f"{VIS_EVERY}th) in {vis_s * 1e3:.1f} ms: {vis_agg['sampled']} strips (expected "
          f"{len(frames)}); {f0} agreement 1.0 {f0_agree}, all frames {vis_agg['full_agreement']} "
          f"(the other fighter's labels are a move no model predicts); {len(pngs)} inline PNGs "
          f"decode with zlib to their crop files' RGB pixels {decoded}")
    rates = {"ocr_steps_per_s": steps_per_s, "dashboard_samples_per_s": DASH_SAMPLES / dash_s}
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s; {json.dumps(rates)}; {card}")
    return {"launches": launches, "max_abs_err": k2_err, "shape": list(args[0].shape),
            "ms": k2["ms"], "device_ms": dev_ms, "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"], "cuda_core_bound_ms": k2["cuda_core_bound_ms"],
            "library_ms": k2["library_ms"], "mesh_device_ms": audit["k2_mesh_device_ms"]}


# ---- phase 16: the annotated-match path (Manuscript) ----

MANUSCRIPT_DIGESTS = os.path.join(ROOT, "playaid_core_torch", "assets", "manuscript_digests.json")
# Output frames whose SHA-256 is held: the render's first frames, the move
# changes every 40 frames, the log's repaired gap at 200, the last frame,
# and the first frame of each of the five post-game summary cards (held
# SUMMARY_FRAMES each).
SUMMARY_FRAMES = 180
MS_DIGEST_FRAMES = tuple(sorted(
    {0, 1, 39, 40, 41, 120, 199, 200, 201, 202, 203, 280, 360, 440, NUM_FRAMES - 1}
    | {NUM_FRAMES + k * SUMMARY_FRAMES for k in range(5)}
    | {NUM_FRAMES + 5 * SUMMARY_FRAMES - 1}))
SHARED_FRAME_STEP = 8   # (c): every 8th frame of the log clip, both fighters' crops


def manuscript_reader(boxes):
    """A stand-in for VideoReader in a manuscript module: the log clip's
    1080p BGR frames (noise, a disc at each fighter's box), rendered with
    numpy in order, as phase 8's capture renders them."""

    class ClipReader:
        fps, width, height, frame_count = 60.0, WIDTH, HEIGHT, len(boxes)

        def __init__(self, path):
            self.cap = LogClipCapture(boxes)

        def iter_frames(self, start=0, stop=None):
            self.cap.seek(start)
            for i in range(start, self.frame_count if stop is None else stop):
                ok, frame = self.cap.read()
                if not ok:
                    return
                yield i, frame

        def release(self):
            pass

    return ClipReader


class HashingWriter:
    """A stand-in for the annotator's VideoWriter: counts every frame and
    keeps the SHA-256 of those at the indices in ``wanted`` (no codec)."""

    last = None
    wanted = frozenset(MS_DIGEST_FRAMES)

    def __init__(self, path, fps, width, height, codec=None):
        import hashlib

        self.sha = hashlib.sha256
        self.size, self.count, self.digests = (width, height), 0, {}
        HashingWriter.last = self

    def write(self, frame, copy=True):
        if self.count in self.wanted:
            self.digests[str(self.count)] = self.sha(
                np.ascontiguousarray(frame).tobytes()).hexdigest()
        self.count += 1

    def release(self):
        pass


def chart_panel_digests(charts, fighters, stats, canvas_w):
    """SHA-256 of every chart panel the annotator draws for these stats: the
    two history strips, the damage graph and the outcome bars of the side
    and bottom panels, the onscreen pie, and the five summary cards."""
    import hashlib

    half = canvas_w // 2
    out = {}
    for f in fighters:
        panels = {
            "disadvantage_ledge_history": charts.disadvantage_ledge_history(f, stats),
            "disadvantage_tech_history": charts.disadvantage_tech_history(f, stats),
            "move_damage_graph": charts.move_damage_graph(f, stats, width=400, height=480)[1],
            "move_success_punished_missed_bar_graph":
                charts.move_success_punished_missed_bar_graph(f, stats, height=400,
                                                              width=half)[1],
            "move_pie_chart_history": charts.move_pie_chart_history(f, stats, 60)[1],
        }
        for fn in (charts.move_success_punished_missed_bar_graph, charts.move_damage_graph,
                   charts.defensive_option_chart, charts.disadvantage_tech_option_chart,
                   charts.disadvantage_ledge_option_chart):
            panels[f"summary_{fn.__name__}"] = fn(f, stats, width=half, height=HEIGHT + 400)[1]
        for name, img in panels.items():
            if img is not None:
                out[f"{f.fighter_id}/{name}"] = hashlib.sha256(
                    np.ascontiguousarray(img).tobytes()).hexdigest()
    return out


def render_manuscript(ms_module, ann_module, charts, log_path, boxes):
    """Manuscript.render on the log with graphs and summaries on, frames
    from manuscript_reader and output to HashingWriter, both put into the
    given package's modules.  Returns the writer, the Manuscript and the
    render's seconds."""
    ms_module.VideoReader = manuscript_reader(boxes)
    ann_module.VideoWriter = HashingWriter
    m = ms_module.Manuscript("clips/match.mp4", "build/smoke/manuscript/out.mp4",
                             ground_truth_path=log_path, include_audio=False,
                             progress=False, profile=False)
    t0 = time.perf_counter()
    m.render()
    return HashingWriter.last, m, time.perf_counter() - t0


def run_manuscript_phase(torch, dev, check, card, runner):
    """Phase 16: (a) Manuscript.render on phase 8's scripted log at 1080p,
    digests against the JAX package's; (b) Manuscript(ai_output_path=) on
    phase 9's ai_output.yaml; (c) batched_crop_resize_shared_frame through
    K1 and classify_chunked.  Returns K1's shared-frame numbers."""
    from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.infer.ai_output import read as read_ai_output
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.infer.vod_pipeline import boxes_from_log
    from playaid_core_torch.ops.crop_kernel import square_crop_resize
    from playaid_core_torch.ops.preprocess import (
        batched_crop_resize_shared_frame,
        batched_square_crop_resize,
    )
    import torch.nn.functional as F

    from playaid_core_torch.pipeline import manuscript
    from playaid_core_torch.render import annotator, charts

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "smoke", "manuscript")
    os.makedirs(work, exist_ok=True)
    log_path = os.path.join(work, "match_log.txt")
    write_match_log(log_path, NUM_FRAMES)
    boxes = boxes_from_log(log_path)
    with open(MANUSCRIPT_DIGESTS) as f:
        ref = json.load(f)

    # (a) the log route at 1080p.
    writer, m, seconds = render_manuscript(manuscript, annotator, charts, log_path, boxes)
    canvas = (writer.size[1], writer.size[0])
    frames_ok = writer.digests == ref["frames"]
    check(frames_ok and writer.count == ref["frame_count"] and list(canvas) == ref["canvas"],
          f"phase 16 (a): Manuscript.render on the {NUM_FRAMES}-frame log at {WIDTH}x{HEIGHT} "
          f"(graphs and summaries on): {writer.count} frames of {canvas[1]}x{canvas[0]}, "
          f"{sum(writer.digests.get(k) == v for k, v in ref['frames'].items())}/"
          f"{len(ref['frames'])} frame digests equal the JAX package's")
    panels = chart_panel_digests(charts, m.fighters, m.stats, writer.size[0])
    check(panels == ref["panels"],
          f"phase 16 (a): {sum(panels.get(k) == v for k, v in ref['panels'].items())}/"
          f"{len(ref['panels'])} chart panel digests equal the JAX package's")
    stages = m.timer.summary()
    rate = NUM_FRAMES / seconds
    log(f"phase 16 (a): render {seconds:.2f} s for {NUM_FRAMES} frames + "
        f"{writer.count - NUM_FRAMES} summary frames = {rate:.1f} frames/s of the match; "
        f"stages {json.dumps(stages)}; {card}")

    # (b) the AI route on phase 9's ai_output.yaml.
    if runner is None:
        check(False, "phase 16 (b): phase 9 left no AIRunner")
        ai = {}
    else:
        tree = read_ai_output(runner.ai_output_file)
        cap = PixelsClipCapture()
        clip = [cap.read()[1].copy() for _ in range(PIX_FRAMES)]

        class PixelsReader:
            fps, width, height, frame_count = 60.0, PIX_W, PIX_H, PIX_FRAMES

            def __init__(self, path):
                pass

            def iter_frames(self, start=0, stop=None):
                for i in range(start, PIX_FRAMES if stop is None else stop):
                    yield i, clip[i]

            def release(self):
                pass

        labels = []
        manuscript.VideoReader = PixelsReader
        annotator.VideoWriter = HashingWriter
        ms = manuscript.Manuscript("clips/pixels.mp4", os.path.join(work, "ai.mp4"),
                                   ai_output_path=runner.ai_output_file, skip_summaries=True,
                                   include_audio=False, progress=False)
        plain_label = ms.fighter_label

        def recording_label(fighter, i):
            label = plain_label(fighter, i)
            labels.append((fighter.fighter_name, i, label))
            return label

        ms.fighter_label = recording_label
        t0 = time.perf_counter()
        ms.render()
        ai_s = time.perf_counter() - t0
        n = min(len(tree[name]) for name in tree)
        # A frame's label opens with the file's action for it ("" for
        # "Undefined"); a frame the file gives no action keeps the log's.
        same = [label.split(" | ")[0] == tree[name][i]["action"].replace("Undefined", "")
                for name, i, label in labels if "action" in tree[name][i]]
        ai = {"frames": HashingWriter.last.count, "labels": len(labels)}
        check(HashingWriter.last.count == n and len(labels) == 2 * n and all(same)
              and len(same) >= 2 * (n - 1),
              f"phase 16 (b): Manuscript(ai_output_path=phase 9's ai_output.yaml) rendered "
              f"{HashingWriter.last.count} frames of {n} at {PIX_W}x{PIX_H} in {ai_s:.2f} s "
              f"({n / ai_s:.1f} frames/s); {sum(same)}/{len(same)} labels carry the file's "
              f"action")

    # (c) the small APIs: K1 on the shared-frame route, classify_chunked.
    frames_cpu = LogClipCapture(boxes)
    picks = list(range(0, NUM_FRAMES, SHARED_FRAME_STEP))
    frames = []
    for i in range(NUM_FRAMES):
        ok, frame = frames_cpu.read()
        if i in picks:
            frames.append(torch.from_numpy(frame.copy()).to(dev))
    boxes_dev = torch.from_numpy(boxes[picks]).to(dev)
    square_crop_resize.launches = 0
    outs = [batched_crop_resize_shared_frame(f, b, CROP, PADDING, True) for f, b in
            zip(frames, boxes_dev)]
    torch.cuda.synchronize()
    launches = square_crop_resize.launches
    with full_float32():
        err = max(float((o - batched_square_crop_resize(f[None], b[None], CROP, PADDING,
                                                        True)[0]).abs().max())
                  for o, f, b in zip(outs, frames, boxes_dev))
    def shared_frame(_):
        return batched_crop_resize_shared_frame(frames[0], boxes_dev[0], CROP, PADDING, True)

    ms_k1 = time_cuda(torch, shared_frame, 50)
    dev_ms_k1 = traced_device_ms(torch, shared_frame, 50, "crop_resize_kernel", 1,
                                 os.path.join(work, "shared_frame_trace"))
    plain_ms = time_cuda(torch, lambda _: batched_square_crop_resize(
        frames[0][None], boxes_dev[0][None], CROP, PADDING, True), 20)
    # The library yardstick at the same shape: one 1080p frame, two crops.
    lib_in = grid_sample_inputs(torch, frames[0][None], boxes_dev[0][None])
    lib_err = float((F.grid_sample(*lib_in, mode="bilinear", padding_mode="zeros",
                                   align_corners=False).permute(0, 2, 3, 1)
                     - outs[0].reshape(2, CROP, CROP, 3)).abs().max())
    lib_ms = time_cuda(torch, lambda _: F.grid_sample(*lib_in, mode="bilinear",
                                                      padding_mode="zeros",
                                                      align_corners=False), 50)
    k1_bytes = (crop_touched_bytes(boxes[picks[0]], HEIGHT, WIDTH, CROP, PADDING)
                + 2 * CROP * CROP * 3 * 4 + 2 * 4 * 4)
    bound_ms = k1_bytes / PEAK_HBM_BYTES * 1e3
    check(launches == len(picks) and err <= 1e-5 and dev_ms_k1 is not None,
          f"phase 16 (c): batched_crop_resize_shared_frame on {len(picks)} 1080p frames "
          f"(2 crops each) through K1: {launches} launches, max abs err {err:.3g} against "
          f"batched_square_crop_resize on the card (limit 1e-5); call {ms_k1:.4f} ms, device "
          f"{'not measured' if dev_ms_k1 is None else f'{dev_ms_k1:.4f} ms'} "
          f"(profiling.trace), plain {plain_ms:.4f} ms, grid_sample {lib_ms:.4f} ms (max abs "
          f"diff {lib_err:.3g} from K1), bound {bound_ms:.4f} ms ({k1_bytes / 1e6:.3f} MB)")
    pipe = BatchedActionPipeline(device=dev).load_state_dicts(
        from_jax_cnn(load_npz_tree(ASSET)))
    emb = torch.randn((50, 2, pipe.embed_dim), generator=torch.Generator().manual_seed(3)) * 1.5
    emb = emb.to(dev)
    chunks = [emb[s:s + 16].reshape(-1, pipe.embed_dim) for s in range(0, 50, 16)]
    chunks[-1] = torch.cat([chunks[-1], torch.zeros((2 * 16 - chunks[-1].shape[0],
                                                     pipe.embed_dim), device=dev)])
    with full_float32():
        lab_c, conf_c = pipe.classify_chunked(chunks, 50 % 16)
        buf = torch.zeros((128, pipe.embed_dim), device=dev)
        buf[:100] = emb.reshape(100, -1)
        lab_b, conf_b = pipe.classify_buffer(buf, 50)
    check(torch.equal(lab_c, lab_b) and torch.allclose(conf_c, conf_b, rtol=1e-4, atol=0),
          f"phase 16 (c): classify_chunked over {len(chunks)} chunks of 16 frames equals "
          f"classify_buffer on the card: labels identical, confidences within 1e-4")
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s; {card}")
    return {"launches": launches, "max_abs_err": err, "ms": ms_k1, "device_ms": dev_ms_k1,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "library_ms": lib_ms,
            "render_fps": rate, "stages": stages, "ai_route": ai}


# ---- phase 17: ground truth from a (VOD, log) pair on the card's machine ----
# Phase 8's scripted log served at the log's projection size through a
# stand-in capture; the action tree, the character-detection tree, a raw
# animation dump cleaned through the PNG codec and char_loader's strips,
# each held to what the JAX package's modules give on the same inputs
# (tools/torch_port_gt_digests.py writes GT_DIGESTS with them, cv2 and PIL).

GT_DIGESTS = os.path.join(ROOT, "playaid_core_torch", "assets", "gt_digests.json")
GT_WORK = os.path.join(ROOT, "build", "smoke", "gt")
GT_W, GT_H = 1280, 720     # the log's projection size (precompute_timeline_projection)
GT_DISC_RADIUS = 60
GT_PAIRING = ("match_1", "match.mp4", "match_log.txt", 0)
GT_CHAR_INTERVAL = 10      # gen_gt_char_detection's interval: 48 of the 480 frames
GT_FIT_STEPS = 8           # CNN-63 steps on the action tree (from the bench weights)
GT_EVAL_BATCHES = 2
GT_DET_STEPS = 8           # detector steps on the character-detection tree
GT_DET_EVAL_IMAGES = 32    # evaluate's draws: 2 batches of 16
RAW_ANIMS = {"byleth": ("c00attack1", "c00attackdash"), "pikachu": ("c00attack1", "c00wait1")}
RAW_FRAMES, RAW_H, RAW_W = 4, 270, 360
CHAR_LABELS = ("byleth_pikachu", "pikachu_byleth")
CHAR_FRAMES = 3            # frames a label in char_loader's tree
CHAR_DRAWS = 8             # CharacterLoader(seed=0) draws digested


class GtClipCapture:
    """Stand-in frame source behind video/reader.open_capture for
    phase 17 (and, in tools/torch_port_gt_digests.py, behind the JAX
    package's VideoReader): 1280x720 BGR frames of seeded noise with a disc
    at each fighter's box of the log; each read renders a new frame, which
    the caller may keep."""

    fps, width, height = 60.0, GT_W, GT_H

    def __init__(self, boxes):
        self.boxes = boxes
        self.frame_count = len(boxes)
        self.pos = 0
        self.base = np.random.default_rng(4).integers(0, 60, (GT_H, GT_W, 3), dtype=np.uint8)
        r = GT_DISC_RADIUS
        yy, xx = np.ogrid[-r:r + 1, -r:r + 1]
        self.disc = yy ** 2 + xx ** 2 <= r * r

    def seek(self, index):
        self.pos = index

    def read(self):
        if self.pos >= len(self.boxes):
            return False, None
        frame, r = self.base.copy(), GT_DISC_RADIUS
        for box, colour in zip(self.boxes[self.pos], ((0, 200, 255), (255, 80, 0))):
            cx = min(max(int(box[0] * GT_W), r), GT_W - r - 1)
            cy = min(max(int(box[1] * GT_H), r), GT_H - r - 1)
            frame[cy - r:cy + r + 1, cx - r:cx + r + 1][self.disc] = colour
        self.pos += 1
        return True, frame

    def release(self):
        pass


def write_gt_pairing(root):
    """Phase 8's scripted log as the ground-truth pairing GT_PAIRING under
    root (the video is the stand-in capture; its file is never opened) and
    a pairings CSV of it.  Returns (the log's boxes, the CSV's path)."""
    from playaid_core_torch.infer.vod_pipeline import boxes_from_log

    d = os.path.join(root, GT_PAIRING[0])
    os.makedirs(d, exist_ok=True)
    log_path = os.path.join(d, GT_PAIRING[2])
    write_match_log(log_path, NUM_FRAMES)
    csv = os.path.join(root, "pairings.csv")
    with open(csv, "w") as f:
        f.write("dir,video,log,offset\n" + ",".join(str(v) for v in GT_PAIRING) + "\n")
    return boxes_from_log(log_path), csv


def digest_arrays(items):
    """SHA-256 over (name, array) pairs in name order: each name, then the
    array's dtype, shape and bytes."""
    import hashlib

    h = hashlib.sha256()
    for name, a in sorted(items, key=lambda item: item[0]):
        a = np.ascontiguousarray(a)
        h.update(f"{name}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def action_tree_digests(crops, labels):
    """Per fighter directory of an action tree: the number of crops, the
    digest of the crops ({path without suffix: array}) and of the labels
    ({path without suffix: text})."""
    out = {}
    for name in sorted({os.path.dirname(k) for k in crops}):
        mine = [(k, a) for k, a in crops.items() if k.startswith(name + os.sep)]
        texts = [(k, np.frombuffer(t.encode(), np.uint8)) for k, t in labels.items()
                 if k.startswith(name + os.sep)]
        out[name] = {"crops": len(mine), "crop_sha256": digest_arrays(mine),
                     "labels": len(texts), "label_sha256": digest_arrays(texts)}
    return out


def write_raw_dump(root, write):
    """A raw animation dump under root/<fighter>/<animation>/frame_<i>.png:
    RAW_H x RAW_W BGR frames of a seeded-colour figure on black (a body
    and a head that move, a row of 1s that the cleaner keeps transparent),
    written with write(path, image)."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:RAW_H, :RAW_W]
    for fighter, anims in RAW_ANIMS.items():
        for anim in anims:
            d = os.path.join(root, fighter, anim)
            os.makedirs(d, exist_ok=True)
            for i in range(RAW_FRAMES):
                img = np.zeros((RAW_H, RAW_W, 3), np.uint8)
                x0, y0 = 60 + 25 * i, 80 + 10 * i
                img[y0:y0 + 120, x0:x0 + 70] = rng.integers(2, 256, (120, 70, 3), dtype=np.uint8)
                head = (yy - (y0 - 25)) ** 2 + (xx - (x0 + 35)) ** 2 <= 22 ** 2
                img[head] = rng.integers(2, 256, 3, dtype=np.uint8)
                img[y0 + 60, x0:x0 + 70] = 1
                write(os.path.join(d, f"frame_{i}.png"), img)


def write_char_frames(root, boxes, write):
    """char_loader's tree: root/<label>/<frame>.png of the stand-in's
    frames, CHAR_FRAMES a label, written with write(path, image)."""
    cap = GtClipCapture(boxes)
    for k, label in enumerate(CHAR_LABELS):
        d = os.path.join(root, label)
        os.makedirs(d, exist_ok=True)
        for j in range(CHAR_FRAMES):
            index = 150 * j + 40 * k
            cap.seek(index)
            write(os.path.join(d, f"{index:06d}.png"), cap.read()[1])


def char_strip_digest(loader_module, table):
    """The digest of CHAR_DRAWS (feature, label) draws of
    loader_module.CharacterLoader(table, seed=0)."""
    loader = loader_module.CharacterLoader(table, seed=0)
    draws = [loader[i] for i in range(CHAR_DRAWS)]
    return digest_arrays([(f"{i:02d}/{label}", feature)
                          for i, (feature, label) in enumerate(draws)])


def port_gt_trees(work):
    """The port's side of phase 17's trees, under work (emptied first):
    the action tree and the character-detection tree of GT_PAIRING with
    fmt="npy", frames from GtClipCapture behind
    video/reader.open_capture; the raw dump written by imgcodec
    and cleaned; char_loader's strips.  Returns the digests in
    GT_DIGESTS's layout and what the phase reads of the run."""
    import shutil

    from playaid_core_torch import char_loader, imgcodec
    from playaid_core_torch.datagen import gen_gt_action_detection as gt_action
    from playaid_core_torch.datagen import gen_gt_char_detection as gt_char
    from playaid_core_torch.datagen import raw_anim_cleaner
    from playaid_core_torch.video import reader

    shutil.rmtree(work, ignore_errors=True)
    vods = os.path.join(work, "vods")
    boxes, csv = write_gt_pairing(vods)
    run = {"action_root": os.path.join(work, "action", "train"),
           "char_dir": os.path.join(work, "char", "train")}
    real_capture = reader.open_capture
    reader.open_capture = lambda path: GtClipCapture(boxes)
    try:
        t0 = time.perf_counter()
        run["written"] = gt_action.process_pairing(run["action_root"], GT_PAIRING,
                                                   ground_truth_dir=vods, fmt="npy")
        run["write_s"] = time.perf_counter() - t0
        run["again"] = gt_action.process_pairing(run["action_root"], GT_PAIRING,
                                                 ground_truth_dir=vods, fmt="npy")
        t0 = time.perf_counter()
        run["char_frames"] = gt_char.generate_data(
            csv, "train", interval=GT_CHAR_INTERVAL, output_root=os.path.join(work, "char"),
            ground_truth_dir=vods, fmt="npy")
        run["char_s"] = time.perf_counter() - t0
    finally:
        reader.open_capture = real_capture

    crops, labels = {}, {}
    for dirpath, _, files in os.walk(run["action_root"]):
        for name in files:
            path = os.path.join(dirpath, name)
            parts = os.path.relpath(path, run["action_root"]).split(os.sep)
            key = "/".join(parts[:2] + [name[:-4]])  # <video>/<id>_<fighter>/<frame>
            if name.endswith(".npy"):
                crops[key] = np.load(path)
            else:
                with open(path) as fh:
                    labels[key] = fh.read()
    char_names = sorted(f[:-4] for f in os.listdir(os.path.join(run["char_dir"], "images")))
    char_labels = {}
    for name in char_names:
        with open(os.path.join(run["char_dir"], "labels", name + ".txt")) as fh:
            char_labels[name] = fh.read()
    char_frames = [(n, np.load(os.path.join(run["char_dir"], "images", n + ".npy")))
                   for n in char_names]

    raw, clean = os.path.join(work, "raw"), os.path.join(work, "clean")
    write_raw_dump(raw, imgcodec.write_image)
    t0 = time.perf_counter()
    run["cleaned"] = sum(raw_anim_cleaner.clean_all_raw_fighter_anim_data(
        f, raw_dir=raw, clean_dir=clean) for f in RAW_ANIMS)
    run["clean_s"] = time.perf_counter() - t0
    cleaned, run["sprites_ok"] = {}, True
    for dirpath, _, files in os.walk(clean):
        for name in files:
            path = os.path.join(dirpath, name)
            img = imgcodec.read_image(path, imgcodec.IMREAD_UNCHANGED)
            cleaned["/".join(os.path.relpath(path, clean).split(os.sep))] = digest_arrays(
                [("png", img)])
            sprite = imgcodec.read_sprite(path)
            run["sprites_ok"] &= sprite.shape[2] == 4 and np.array_equal(sprite, img)

    chars = os.path.join(work, "chars")
    write_char_frames(chars, boxes, imgcodec.write_image)
    run["digests"] = {
        "action": action_tree_digests(crops, labels), "char_labels": char_labels,
        "char_frames_sha256": digest_arrays(char_frames), "cleaned": cleaned,
        "strips_sha256": char_strip_digest(char_loader,
                                           char_loader.dataframe_from_directory(chars))}
    return run


def run_gt_phase(torch, dev, check, card, k2_wrapper):
    """Phase 17: (a) gen_gt_action_detection.process_pairing(fmt="npy") on
    the stand-in VOD and phase 8's log, its crops and labels held to the
    JAX module's, then Trainer.fit (CNN-63 from the bench weights) and
    evaluate on the tree with K2; (b) gen_gt_char_detection.generate_data(
    fmt="npy"), its frames and YOLO rows held to the JAX module's, then
    DetectorTrainer.fit and evaluate with K2; (c) a raw dump written as PNG
    by imgcodec, cleaned by raw_anim_cleaner, the cleaned PNGs held to the
    JAX cleaner's, read back by read_sprite; (d) char_loader's strips.
    Returns the phase's numbers."""
    from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.ops.conv_block import residual_block_packed, residual_block_ref
    from playaid_core_torch.train.dataset import UltActionRecogDataset
    from playaid_core_torch.train.detector_train import DetectionDataset, DetectorTrainer
    from playaid_core_torch.train.train import Trainer

    t_phase = time.perf_counter()
    with open(GT_DIGESTS) as f:
        ref = json.load(f)
    run = port_gt_trees(GT_WORK)
    got = run["digests"]
    out = {"crops_per_sec": run["written"] / run["write_s"],
           "char_frames_per_sec": run["char_frames"] / run["char_s"]}
    check(got["action"] == ref["action"] and run["again"] == 0,
          f"phase 17 (a): gen_gt_action_detection.process_pairing(fmt=\"npy\") on the "
          f"{NUM_FRAMES}-frame log at {GT_W}x{GT_H}: {run['written']} crops in "
          f"{run['write_s']:.2f} s = {out['crops_per_sec']:.1f} crops/s; the digests of crops "
          f"and labels per fighter equal the JAX module's: {got['action'] == ref['action']} "
          f"({json.dumps(got['action'])}); a second run writes {run['again']}; {card}")
    check(got["char_labels"] == ref["char_labels"]
          and got["char_frames_sha256"] == ref["char_frames_sha256"],
          f"phase 17 (b): gen_gt_char_detection.generate_data(interval={GT_CHAR_INTERVAL}, "
          f"fmt=\"npy\"): {run['char_frames']} frames in {run['char_s']:.2f} s; "
          f"{sum(got['char_labels'].get(k) == v for k, v in ref['char_labels'].items())}/"
          f"{len(ref['char_labels'])} YOLO label files equal the JAX module's; frame digest "
          f"equal: {got['char_frames_sha256'] == ref['char_frames_sha256']}; {card}")
    check(got["cleaned"] == ref["cleaned"] and run["sprites_ok"],
          f"phase 17 (c): raw_anim_cleaner on {len(RAW_ANIMS)} fighters' PNG dumps (written by "
          f"imgcodec): {run['cleaned']} sprites cleaned in {run['clean_s']:.2f} s; "
          f"{sum(got['cleaned'].get(k) == v for k, v in ref['cleaned'].items())}/"
          f"{len(ref['cleaned'])} decoded digests equal the JAX cleaner's; read_sprite gives "
          f"each as BGRA: {run['sprites_ok']}")
    check(got["strips_sha256"] == ref["strips_sha256"],
          f"phase 17 (d): char_loader.CharacterLoader(seed=0): the digest of {CHAR_DRAWS} "
          f"strips and labels equals the JAX loader's: "
          f"{got['strips_sha256'] == ref['strips_sha256']}")

    def k2_against_plain(block, x):
        with torch.inference_mode(), full_float32():
            args = k2_ref_args(block, x)
            y = residual_block_packed(args[0], block.block_pack(torch.float32))
            want = residual_block_ref(*args)
        return float((y - want).abs().max()), float(want.abs().max()), tuple(args[0].shape)

    # (a) training on the action tree: CNN-63 from the bench weights.
    def action_dataset(seed):
        root = run["action_root"]
        return UltActionRecogDataset(
            split="train", num_samples=TRAIN_BATCH * GT_FIT_STEPS, img_dimension=CROP,
            anim_subset=train_actions(), num_frames_per_sample=[TRAIN_T], frame_delta=[1, 2, 3],
            char_subset=["Byleth", "Pikachu"], num_preceding_actions=0, crop_size=CROP,
            seed=seed, gt_root_train=root, gt_root_val=root, gt_root_test=root)

    trainer = Trainer(train_config("cnn", device=str(dev)), action_dataset(0))
    trainer.init_state(FAMILY_SEED)
    load_bench(trainer.model, from_jax_cnn(load_npz_tree(ASSET)))
    k2_wrapper.launches = 0
    trainer.fit(num_epochs=1, steps_per_epoch=GT_FIT_STEPS)
    fit_launches = k2_wrapper.launches
    record = trainer.metrics_log[-1]
    block = trainer.model.embed.layer4[1]
    seen = {}
    hook = block.register_forward_hook(keep_input(seen))
    k2_wrapper.launches = 0
    result = trainer.evaluate(action_dataset(1), num_batches=GT_EVAL_BATCHES)
    eval_launches = k2_wrapper.launches
    hook.remove()
    err, scale, shape = k2_against_plain(block, seen["x"])
    out.update({"action_steps_per_sec": record["steps_per_sec"],
                "action_crops_per_sec": record["crops_per_sec"],
                "k2_action_train_launches": fit_launches, "k2_action_launches": eval_launches,
                "k2_action_max_abs_err": err, "k2_action_shape": list(shape)})
    check(np.isfinite(record["train_loss"]) and np.isfinite(result["loss"])
          and trainer.state.step == GT_FIT_STEPS and fit_launches == 0
          and eval_launches == K2_BLOCKS * GT_EVAL_BATCHES and err <= K2_F32_REL_TOL * scale,
          f"phase 17 (a): Trainer.fit CNN-63 (bench weights) {GT_FIT_STEPS} steps on the tree "
          f"(batch {TRAIN_BATCH}, T {TRAIN_T}): {record['steps_per_sec']} steps/s = "
          f"{record['crops_per_sec']} crops/s, loss {record['train_loss']:.4f}; K2 launches "
          f"in train steps {fit_launches} (must be 0), in evaluate({GT_EVAL_BATCHES}) "
          f"{eval_launches}: loss {result['loss']:.4f}, acc {result['acc']:.3f}; K2 at "
          f"layer4[1] {shape} vs residual_block_ref: max abs err {err:.3e} (tol "
          f"{K2_F32_REL_TOL} x max|ref| {scale:.3f}); {card}")

    # (b) training on the character-detection tree.
    def det_dataset(seed):
        return DetectionDataset(run["char_dir"], input_hw=DET_HW, num_classes=DET_CLASSES,
                                seed=seed)

    det = DetectorTrainer(det_dataset(0), num_classes=DET_CLASSES, input_hw=DET_HW,
                          device=dev).init(0)
    k2_wrapper.launches = 0
    t0 = time.perf_counter()
    det.fit(GT_DET_STEPS, batch_size=DET_BATCH)
    det_s = time.perf_counter() - t0
    det_fit_launches = k2_wrapper.launches
    k2_wrapper.launches = 0
    scores = det.evaluate(det_dataset(1), num_images=GT_DET_EVAL_IMAGES)
    det_eval_launches = k2_wrapper.launches
    block, x = k2_block_input(torch, det, next(det_dataset(2).batches(16, 1))[0])
    err, scale, shape = k2_against_plain(block, x)
    out.update({"detector_steps_per_sec": GT_DET_STEPS / det_s,
                "k2_detector_train_launches": det_fit_launches,
                "k2_detector_launches": det_eval_launches, "k2_detector_max_abs_err": err,
                "k2_detector_shape": list(shape)})
    losses = [rec["loss"] for rec in det.metrics_log]
    check(all(np.isfinite(losses)) and det_fit_launches == 0
          and det_eval_launches == K2_BLOCKS * (GT_DET_EVAL_IMAGES // 16)
          and err <= K2_F32_REL_TOL * scale,
          f"phase 17 (b): DetectorTrainer.fit {GT_DET_STEPS} steps (batch {DET_BATCH}) on the "
          f"{run['char_frames']} frames in {det_s:.2f} s = {GT_DET_STEPS / det_s:.2f} steps/s, "
          f"losses {[round(v, 4) for v in losses]}; K2 launches in the fit {det_fit_launches} "
          f"(must be 0), in evaluate({GT_DET_EVAL_IMAGES}) {det_eval_launches}: {scores}; K2 "
          f"at the trunk's layer4[1] {shape} vs residual_block_ref: max abs err {err:.3e} "
          f"(tol {K2_F32_REL_TOL} x max|ref| {scale:.3f}); {card}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 17: {out['seconds']:.1f} s; {card}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA "
              "device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--profile"]:
        return profile_main(sys.argv[2])
    if sys.argv[1:2] == ["--synth"]:
        return synth_main()
    if sys.argv[1:2] == ["--sprites"]:
        return sprites_main()
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank_main(int(sys.argv[2]))
    if sys.argv[1:2] == ["--k5"]:
        return k5_main()
    if sys.argv[1:2] == ["--k6"]:
        return k6_main()
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from playaid_core_torch.convert import from_jax_cnn, load_npz_tree
    from playaid_core_torch.device import full_float32
    from playaid_core_torch.infer.pipeline import BatchedActionPipeline
    from playaid_core_torch.ops import _build
    from playaid_core_torch.ops.conv_block import (
        pack_block,
        residual_block,
        residual_block_packed,
        residual_block_ref,
    )
    from playaid_core_torch.infer.vod_pipeline import extract_windows
    from playaid_core_torch.ops.crop_kernel import bank_resize, square_crop_resize, window_resize
    from playaid_core_torch.ops.preprocess import (
        batched_square_crop_resize,
        batched_window_resize,
    )
    from playaid_core_torch.ops.viterbi import viterbi_decode, viterbi_decode_ref
    from playaid_core_torch.ops.yuv import yuv420_to_rgb, yuv420_to_rgb_ref
    from playaid_core_torch.video import _native

    failures = []

    def check(ok, what):
        log(f"{'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failures.append(what)

    card = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- phase 1: build (nvcc for the kernels, g++ for the log parser, at once) ----
    t0 = time.perf_counter()
    parser_build = {}

    def build_parser():
        t = time.perf_counter()
        try:
            parser_build["lib"] = _native.build("log_parser")
        except Exception as e:  # noqa: BLE001 - reported by the check below
            parser_build["error"] = e
        parser_build["s"] = time.perf_counter() - t

    parser_thread = threading.Thread(target=build_parser)
    parser_thread.start()
    floor_build = start_chain_floor_build()
    logs = _build.build()
    chain_floor_fn = load_chain_floor(floor_build)
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s (with K3's chain floor, "
        f"{os.path.relpath(CHAIN_FLOOR_SRC, ROOT)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("built in", "entry function", "registers", "spill")):
                log(f"  {name}: {line.strip()}")
    parser_thread.join()
    cmd = _native.command("log_parser", _native.BUILD_DIR / "liblog_parser.so")
    libav = subprocess.run(["sh", "-c", "ldconfig -p | grep -c libavcodec"],
                           capture_output=True, text=True).stdout.strip()
    shown = " ".join(os.path.relpath(c, ROOT) if c.startswith(ROOT) else c for c in cmd)
    check("lib" in parser_build and not [f for f in cmd if f.startswith("-l")],
          f"phase 1: native/log_parser.cpp built with g++ in {parser_build['s']:.1f} s "
          f"({parser_build.get('error', 'ok')}) by `{shown}`, which links no library; "
          f"libavcodec entries in this machine's ldconfig cache: {libav or 0}")

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
    check(k1_out.permute(0, 1, 4, 2, 3).is_contiguous() and not k1_out.is_contiguous(),
          f"phase 2: K1 crop_resize's {tuple(k1_out.shape)} is a view of channels-first "
          f"storage (strides {k1_out.stride()})")
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

    # K1's window entry at the window route's shapes: a chunk's 96 windows
    # of 384^2, cut on the host around the disc clip's boxes, -> 128^2.
    def window_set(k):
        wins = np.empty((CHUNK, 2, WINDOW, WINDOW, 3), np.uint8)
        origins = np.empty((CHUNK, 2, 3), np.float32)
        for j in range(CHUNK):
            row = k * CHUNK + j
            wins[j], origins[j] = extract_windows(host[row].numpy(), boxes_all[sampled[row]],
                                                  WINDOW, PADDING)
        return (torch.from_numpy(wins.reshape(-1, WINDOW, WINDOW, 3)).to(dev),
                torch.from_numpy(origins.reshape(-1, 3)).to(dev))

    def window_plain(wins, origins):
        return batched_window_resize(wins.flip(-1), origins[:, 0], origins[:, 1], origins[:, 2],
                                     CROP)

    win_sets = [window_set(k) for k in range(3)]  # 127 MB of windows: past the 50 MB L2
    wins0, org0 = win_sets[0]
    kw_out = window_resize(wins0, org0, CROP, bgr_to_rgb=True)
    kw_ref = window_plain(wins0, org0)
    # Edge origins: negative corners, a side wider than the window less 2,
    # side 0 (clamped to 1), a window mostly outside.
    edge_org = torch.tensor([[-20.0, -35.5, 300.0], [10.0, 5.0, 400.0], [0.0, 0.0, 0.0],
                             [-100.0, 250.0, 200.0]], device=dev)
    edge_wins = wins0[:4].contiguous()
    kw_edge = window_resize(edge_wins, edge_org, CROP, bgr_to_rgb=True)
    kw_edge_ref = window_plain(edge_wins, edge_org)
    torch.cuda.synchronize()
    kw_err = max(float((kw_out - kw_ref).abs().max()), float((kw_edge - kw_edge_ref).abs().max()))
    check(kw_out.permute(0, 3, 1, 2).is_contiguous() and not kw_out.is_contiguous(),
          f"phase 2: K1 window entry's {tuple(kw_out.shape)} is a view of channels-first "
          f"storage (strides {kw_out.stride()})")
    check(tuple(kw_out.shape) == (2 * CHUNK, CROP, CROP, 3) and kw_err <= K1_TOL,
          f"phase 2: K1 window entry {tuple(wins0.shape)} -> {tuple(kw_out.shape)} + 4 edge "
          f"origins, max abs err {kw_err:.3e} (tol {K1_TOL}); sides "
          f"{float(org0[:, 2].min()):.0f}-{float(org0[:, 2].max()):.0f} px")

    # ---- phase 3: K2 on the real layer4[1] weights and input ----
    net = pipe.embed
    block = net.layer4[1]
    with torch.inference_mode(), full_float32():
        x = k1_out.reshape(-1, CROP, CROP, 3).permute(0, 3, 1, 2)
        x = net.maxpool(torch.relu(net.bn1(net.conv1(x))))
        x = net.layer4[0](net.layer3(net.layer2(net.layer1(x))))
        k2_args = k2_ref_args(block, x)
        x_nhwc, w1, s1, b1, w2, s2, b2 = k2_args  # x_nhwc [48, 4, 4, 512]
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

    # ---- phase 3 (b): K2 at every identity-block shape of the routes ----
    k2_routes = k2_route_shapes(torch, dev)
    for row in k2_routes:
        check(row["rel_err"] <= K2_F32_REL_TOL and row["channels_first_equal"],
              f"phase 3 (b): K2 at {tuple(row['shape'])}, launch {tuple(row['launch'])}: max "
              f"abs err / max|ref| {row['rel_err']:.3e} (tol {K2_F32_REL_TOL}); its "
              f"channels-first output equal and channels first {row['channels_first_equal']}")

    # ---- phase 3 (c): K5 at every 1x1 shape of ResNet-50, its trunk, its count ----
    k5 = run_k5_phase(torch, dev, check)

    # ---- phase 3 (d): K6, the Mamba-2 scan, against its twin and the recurrence ----
    k6 = run_k6_phase(torch, dev, check)

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
    slice_wrappers = {"crop_resize": square_crop_resize, "residual_block": residual_block_packed,
                      "viterbi": viterbi_decode, "yuv420_unpack": yuv420_to_rgb}
    for wrapper in slice_wrappers.values():
        wrapper.launches = 0
    stage_ms = dict.fromkeys(stages, 0.0)
    t0 = time.perf_counter()
    buf, labels = run_slice(stage_ms)
    slice_s = time.perf_counter() - t0
    launches = {name: wrapper.launches for name, wrapper in slice_wrappers.items()}
    log(f"phase 4: main-path launches {launches}; global TF32 flags left at cudnn "
        f"{torch.backends.cudnn.allow_tf32}, matmul {torch.backends.cuda.matmul.allow_tf32}")
    check(launches["crop_resize"] > 0 and launches["residual_block"] > 0
          and launches["viterbi"] == 1 and launches["yuv420_unpack"] == 0,
          "phase 4: K1 and K2 ran on the main path, K3 once (one classify_buffer with "
          "Viterbi, both fighters in one launch), K4 not (the crops come from K1)")
    rng = np.random.default_rng(1)
    u8 = torch.from_numpy(rng.integers(0, 256, (48, CROP, CROP, 3), dtype=np.uint8)).to(dev)
    yuv = torch.from_numpy(rng.integers(0, 256, (48, CROP * CROP * 3 // 2),
                                        dtype=np.uint8)).to(dev)
    emb_u8 = pipe.embed_crops_u8(u8)
    emb_yuv = pipe.embed_crops_yuv(yuv)
    torch.cuda.synchronize()
    check(yuv420_to_rgb.launches == 1,
          f"phase 4: embed_crops_yuv on a chunk launched K4 {yuv420_to_rgb.launches} time(s)")
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

    # ---- phase 4 (b): K3 and K4 against their plain versions ----
    with recorded_viterbi() as k3_calls:  # the slice's launch again, on its log-probs
        pipe.classify_buffer(buf, len(sampled), decode="viterbi", switch_cost=SWITCH_COST)
    k3_lp, k3_len, k3_cost, _ = k3_calls[0]
    match_lp = torch.log_softmax(torch.from_numpy(np.random.default_rng(3).normal(
        0.0, 3.0, (2, MATCH_ROWS, 63)).astype(np.float32)), dim=2).to(dev)
    k3_inputs = ([("phase 4's log-probs", k3_lp, k3_len, k3_cost),
                  ("a seeded match", match_lp, MATCH_ROWS, SWITCH_COST)]
                 + k3_edge_cases(torch, dev))
    k3_err, k3_bad = 0, []
    with torch.inference_mode():
        for what, lp_in, n, cost in k3_inputs:
            diff = int((viterbi_decode(lp_in, n, cost)
                        - viterbi_decode_ref(lp_in, n, cost)).abs().max())
            k3_err = max(k3_err, diff)
            if diff:
                k3_bad.append(what)
    check(not k3_bad, f"phase 4 (b): K3 labels identical to viterbi_decode_ref on the card for "
          f"{', '.join(f'{w} {tuple(x.shape)}' for w, x, _, _ in k3_inputs)}; differing: "
          f"{k3_bad or 'none'}")
    k4_err, k4_views = 0.0, True
    with torch.inference_mode():
        for crops_in in (yuv, yuv[:1]):
            got = yuv420_to_rgb(crops_in, CROP)
            k4_err = max(k4_err, float((got - yuv420_to_rgb_ref(crops_in, CROP)).abs().max()))
            k4_views &= (tuple(got.shape) == (crops_in.shape[0], CROP, CROP, 3)
                         and got.permute(0, 3, 1, 2).is_contiguous())
        k4_cpu_err = float((yuv420_to_rgb(yuv, CROP).cpu()
                            - yuv420_to_rgb_ref(yuv.cpu(), CROP)).abs().max())
    check(k4_err == 0 and k4_views,
          f"phase 4 (b): K4 vs yuv420_to_rgb_ref on the card at {tuple(yuv.shape)} and "
          f"{tuple(yuv[:1].shape)}: max abs err {k4_err:.3e} (must be 0); [N, S, S, 3] views of "
          f"[N, 3, S, S] storage {k4_views}; against the CPU's plain version {k4_cpu_err:.3e} (it "
          f"divides by 255 where PyTorch on the card multiplies by 1/255)")

    # ---- phase 5: timings at the main-path shapes ----
    n_sets = 8  # distinct frame batches, so the touched windows (~75 MB) exceed L2
    frame_sets = [host[k * per_chunk:(k + 1) * per_chunk].to(dev) for k in range(n_sets)]
    box_sets = [boxes_dev[k * per_chunk:(k + 1) * per_chunk] for k in range(n_sets)]

    lib_inputs = [grid_sample_inputs(torch, frame_sets[k], box_sets[k]) for k in range(n_sets)]
    lib_out = F.grid_sample(*lib_inputs[0], mode="bilinear", padding_mode="zeros",
                            align_corners=False).permute(0, 2, 3, 1)
    lib_err = float((lib_out.reshape(k1_ref.shape) - k1_ref).abs().max())
    log(f"phase 5: grid_sample yardstick vs K1 plain: max abs err {lib_err:.3e}")
    def k1_call(it):
        return square_crop_resize(frame_sets[it % n_sets], box_sets[it % n_sets], CROP,
                                  PADDING, True, True)

    with torch.inference_mode():
        k1_ms = time_cuda(torch, k1_call, 80)
        k1_dev_ms, k1_per_call = device_ms(torch, k1_call, 80, "crop_resize_kernel", 1)
        k1_plain_ms = time_cuda(torch, lambda it: batched_square_crop_resize(
            frame_sets[it % n_sets], box_sets[it % n_sets], CROP, PADDING, True, True), 16)
        k1_lib_ms = time_cuda(torch, lambda it: F.grid_sample(
            *lib_inputs[it % n_sets], mode="bilinear", padding_mode="zeros",
            align_corners=False), 40)
    n_crops = per_chunk * 2
    k1_bytes = (crop_touched_bytes(boxes_all[sampled][:per_chunk].reshape(-1, 4), HEIGHT,
                                   WIDTH, CROP, PADDING)
                + n_crops * CROP * CROP * 3 * 4 + n_crops * 4 * 4)
    k1_bound_ms = k1_bytes / PEAK_HBM_BYTES * 1e3

    # K1's window entry at the route's shapes, and its yardstick: grid_sample
    # on the same windows (as floats, channels first) at the same points.
    def window_grid_inputs(k):
        wins, origins = win_sets[k]
        frames = wins.flip(-1).permute(0, 3, 1, 2).float() / 255.0
        i = torch.arange(CROP, device=dev, dtype=torch.float32)
        side = torch.clamp(origins[:, 2], min=1.0)
        sy = origins[:, 0, None] + (i + 0.5) * side[:, None] / CROP - 0.5
        sx = origins[:, 1, None] + (i + 0.5) * side[:, None] / CROP - 0.5
        gy = (2 * sy + 1) / WINDOW - 1  # align_corners=False
        gx = (2 * sx + 1) / WINDOW - 1
        return frames, torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]), -1)

    win_lib_inputs = [window_grid_inputs(k) for k in range(len(win_sets))]
    wlib_out = F.grid_sample(*win_lib_inputs[0], mode="bilinear", padding_mode="zeros",
                             align_corners=False).permute(0, 2, 3, 1)
    log(f"phase 5: grid_sample yardstick vs K1 window plain: max abs err "
        f"{float((wlib_out - kw_ref).abs().max()):.3e}")
    del wlib_out

    def kw_call(it):
        return window_resize(*win_sets[it % len(win_sets)], CROP, bgr_to_rgb=True)

    with torch.inference_mode():
        kw_ms = time_cuda(torch, kw_call, 60)
        kw_dev_ms, kw_per_call = device_ms(torch, kw_call, 60, "crop_resize_kernel", 1)
        kw_plain_ms = time_cuda(torch, lambda it: window_plain(*win_sets[it % len(win_sets)]), 6)
        kw_lib_ms = time_cuda(torch, lambda it: F.grid_sample(
            *win_lib_inputs[it % len(win_sets)], mode="bilinear", padding_mode="zeros",
            align_corners=False), 30)
    del win_lib_inputs
    org_np = org0.cpu().numpy()
    kw_bytes = (touched_bytes(org_np[:, 0], org_np[:, 1], org_np[:, 2], WINDOW, WINDOW, CROP)
                + 2 * CHUNK * CROP * CROP * 3 * 4 + 2 * CHUNK * 3 * 4)
    kw_bound_ms = kw_bytes / PEAK_HBM_BYTES * 1e3

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
        # A call launches two kernels: the block's two convolutions.
        k2_dev_ms, k2_per_call = device_ms(torch, k2_f32, 40, "conv3x3_wgmma_kernel", 2)
        k2_bf16_ms = time_cuda(torch, k2_bf16, 40)
        k2_bf16_dev_ms, k2_bf16_per_call = device_ms(torch, k2_bf16, 40,
                                                     "conv3x3_wgmma_kernel", 2)
        k2_plain_ms = time_cuda(torch, lambda it: residual_block_ref(*k2_args), 40)

        # The bf16 yardsticks: the same cuDNN chain on bf16 activations and
        # weights (batch norm keeps its float32 statistics, as under
        # autocast), and the plain version on the bf16 arguments.
        x_bf_nchw = x_nchw.bfloat16()
        w_bf = (block.conv1.weight.bfloat16(), block.conv2.weight.bfloat16())

        def cudnn_chain_bf16(_):
            y = F.conv2d(x_bf_nchw, w_bf[0], padding=1)
            y = torch.relu(F.batch_norm(y, bn[0].running_mean, bn[0].running_var,
                                        bn[0].weight, bn[0].bias, False, 0.0, bn[0].eps))
            y = F.conv2d(y, w_bf[1], padding=1)
            y = F.batch_norm(y, bn[1].running_mean, bn[1].running_var, bn[1].weight,
                             bn[1].bias, False, 0.0, bn[1].eps)
            return torch.relu(y + x_bf_nchw)

        lib_bf_ulps = bf16_ulps(cudnn_chain_bf16(0).permute(0, 2, 3, 1).float().cpu().numpy(),
                                bf_ref)
        log(f"phase 5: cuDNN bf16 chain yardstick vs K2 bf16 plain: max {lib_bf_ulps:.2f} ulps")
        k2_bf16_lib_ms = time_cuda(torch, cudnn_chain_bf16, 40)
        k2_bf16_plain_ms = time_cuda(torch, lambda it: residual_block_ref(*bf_args), 40)
    m, c = x_nhwc.shape[0] * 16, x_nhwc.shape[3]
    k2_flops = 2 * 2 * m * c * 9 * c
    # Each input read once, the output written once: x, out, both weights, s/b.
    k2_bytes = 2 * m * c * 4 + 2 * 9 * c * c * 4 + 4 * c * 4
    k2_bf16_bytes = 2 * m * c * 2 + 2 * 9 * c * c * 2 + 4 * c * 4
    k2_bound_ms = max(3 * k2_flops / PEAK_TF32_FLOPS, k2_bytes / PEAK_HBM_BYTES) * 1e3
    k2_bf16_bound_ms = max(k2_flops / PEAK_BF16_FLOPS, k2_bf16_bytes / PEAK_HBM_BYTES) * 1e3
    k2_core_bound_ms = max(k2_flops / PEAK_FP32_FLOPS, k2_bytes / PEAK_HBM_BYTES) * 1e3

    # K3 on phase 4's launch and on the seeded match; K4 on a chunk beside
    # its plain version's call and device time, and the embed of its output
    # in the NCHW storage it writes against the same values stored NHWC.
    with torch.inference_mode():
        def k3_call(_):
            return viterbi_decode(k3_lp, k3_len, k3_cost)

        def k3_match(_):
            return viterbi_decode(match_lp, MATCH_ROWS, SWITCH_COST)

        k3_ms = time_cuda(torch, k3_call, 100)
        k3_dev_ms, k3_per_call = device_ms(torch, k3_call, 40, "viterbi_kernel", 1)
        k3_plain_ms = time_cuda(torch, lambda it: viterbi_decode_ref(k3_lp, k3_len, k3_cost), 3,
                                warmup=1)
        k3_match_ms = time_cuda(torch, k3_match, 6, warmup=1)
        k3_match_dev_ms, _ = device_ms(torch, k3_match, 4, "viterbi_kernel", 1, warmup=1)
        floor_cycles, floor_us = chain_floor(torch, chain_floor_fn, MATCH_ROWS)
        yuv_sets = [torch.from_numpy(rng.integers(0, 256, tuple(yuv.shape), dtype=np.uint8)).to(dev)
                    for _ in range(n_sets)]

        def k4_call(it):
            return yuv420_to_rgb(yuv_sets[it % n_sets], CROP)

        def k4_plain(it):
            return yuv420_to_rgb_ref(yuv_sets[it % n_sets], CROP)

        k4_ms = time_cuda(torch, k4_call, 200)
        k4_dev_ms, k4_per_call = device_ms(torch, k4_call, 80, "yuv420_unpack_kernel", 1)
        k4_plain_ms = time_cuda(torch, k4_plain, 40)
        k4_plain_dev_ms, k4_plain_kernels = span_device_ms(torch, k4_plain, 20)
        rgb_nchw = k4_call(0)
        rgb_nhwc = rgb_nchw.contiguous()
        embed_ms = {"nchw": [], "nhwc": []}
        for order in ("nchw", "nhwc", "nhwc", "nchw"):
            x_rgb = rgb_nchw if order == "nchw" else rgb_nhwc
            embed_ms[order].append(time_cuda(torch, lambda it: pipe.embed(x_rgb), 20))
    k3_rows = int(min(max(k3_len, 1), k3_lp.shape[1]))
    # Rows the true length needs read once, every label written once.
    k3_bytes = k3_lp.shape[0] * k3_rows * k3_lp.shape[2] * 4 + k3_lp.shape[0] * k3_lp.shape[1] * 8
    k3_bound_ms = k3_bytes / PEAK_HBM_BYTES * 1e3
    # The latency bound: the chain floor's time a step times the steps.
    k3_floor_ms = floor_us * (k3_rows - 1) / 1e3
    k3_match_floor_ms = floor_us * (MATCH_ROWS - 1) / 1e3
    k4_bytes = yuv.numel() + yuv.shape[0] * 3 * CROP * CROP * 4
    k4_bound_ms = k4_bytes / PEAK_HBM_BYTES * 1e3

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    def per_step_us(ms, steps):
        return "not measured" if ms is None else f"{ms * 1e3 / steps:.4f} us"

    def of_floor(floor_ms, ms):
        return "not measured" if ms is None else f"{floor_ms / ms:.3f}"

    log(f"phase 5: K1 call {k1_ms:.4f} ms, device {fmt(k1_dev_ms)} ({k1_per_call:g} kernel "
        f"a call), plain {k1_plain_ms:.4f} ms, grid_sample {k1_lib_ms:.4f} ms, bound "
        f"{k1_bound_ms:.4f} ms ({k1_bytes / 1e6:.2f} MB)")
    log(f"phase 5: K1 window entry (96 windows of {WINDOW}^2 -> {CROP}^2) call {kw_ms:.4f} ms, "
        f"device {fmt(kw_dev_ms)} ({kw_per_call:g} kernel a call), plain {kw_plain_ms:.4f} ms, "
        f"grid_sample {kw_lib_ms:.4f} ms, bound {kw_bound_ms:.4f} ms ({kw_bytes / 1e6:.2f} MB)")
    log(f"phase 5: K2 f32 (3xTF32) call {k2_ms:.4f} ms, device {fmt(k2_dev_ms)} "
        f"({k2_per_call:g} kernels a call; {k2_flops / k2_ms / 1e9:.2f} TFLOP/s of f32 work by "
        f"call time), bound {k2_bound_ms:.4f} ms (3 x {k2_flops / 1e9:.2f} GFLOP TF32; CUDA-core "
        f"f32 bound {k2_core_bound_ms:.4f} ms); bf16 call {k2_bf16_ms:.4f} ms, device "
        f"{fmt(k2_bf16_dev_ms)} ({k2_bf16_per_call:g} kernels a call), bound "
        f"{k2_bf16_bound_ms:.4f} ms; plain {k2_plain_ms:.4f} ms, "
        f"cuDNN chain {k2_lib_ms:.4f} ms; bf16 plain {k2_bf16_plain_ms:.4f} ms, bf16 cuDNN "
        f"chain {k2_bf16_lib_ms:.4f} ms")
    log(f"phase 5: K3 viterbi {tuple(k3_lp.shape)} (true length {k3_len}) call {k3_ms:.4f} ms, "
        f"device {fmt(k3_dev_ms)} ({k3_per_call:g} kernel a call) = "
        f"{per_step_us(k3_dev_ms, k3_rows)} a step, plain {k3_plain_ms:.4f} ms, bound "
        f"{k3_bound_ms:.5f} ms (bytes, {k3_bytes} B), chain floor {k3_floor_ms:.4f} ms "
        f"({of_floor(k3_floor_ms, k3_dev_ms)} of the device time); the chain: "
        f"{tuple(match_lp.shape)} call {k3_match_ms:.4f} ms, device {fmt(k3_match_dev_ms)} = "
        f"{per_step_us(k3_match_dev_ms, MATCH_ROWS)} a step, chain floor "
        f"{k3_match_floor_ms:.4f} ms ({of_floor(k3_match_floor_ms, k3_match_dev_ms)} of the "
        f"device time); no library call computes it")
    log(f"phase 5: K3's chain floor ({CHAIN_FLOORS[0]}, one warp, {MATCH_ROWS - 1} dependent "
        f"steps): {floor_cycles:.1f} cycles a step (clock64), {floor_us:.4f} us a step (CUDA "
        f"events)")
    log(f"phase 5: K4 yuv420_unpack {tuple(yuv.shape)} call {k4_ms:.4f} ms, device "
        f"{fmt(k4_dev_ms)} ({k4_per_call:g} kernel a call), bound {k4_bound_ms:.4f} ms (bytes, "
        f"{k4_bytes} B); plain call {k4_plain_ms:.4f} ms, plain device {fmt(k4_plain_dev_ms)} "
        f"({k4_plain_kernels:g} kernels a call); no library call computes it")
    log(f"phase 5: embed of a chunk from K4's output, NCHW storage (what the pipeline runs) "
        f"{', '.join(f'{v:.4f}' for v in embed_ms['nchw'])} ms, the same values stored NHWC "
        f"{', '.join(f'{v:.4f}' for v in embed_ms['nhwc'])} ms (order nchw, nhwc, nhwc, nchw)")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    layout = profile_slice(torch, run_slice, slice_s)
    check(layout is not None and layout["nhwcToNchw"] == 0 and layout["nchwToNhwc"] == 0
          and layout["crop_resize_kernel"] > 0,
          f"phase 4: no nhwcToNchw or nchwToNhwc kernel in the slice's trace "
          f"({'no trace' if layout is None else '%.3f, %.3f ms' % (layout['nhwcToNchw'], layout['nchwToNhwc'])}): "
          f"K1's frames entry hands the stem channels-first crops and each run of fused "
          f"blocks hands cuDNN channels-first maps")

    # ---- phases 6 and 7: VodAnalyzer.analyze, the CNN headline and the families ----
    from playaid_core_torch.video import native_decoder

    # The choice of decoder, fixed from the probe of the card's machine.
    stand_in = DiscClipDecoder(NUM_FRAMES)
    install_stand_in(native_decoder, stand_in)
    vod_launches, vod_fps = run_vod_phase(torch, dev, check, boxes_all, stand_in,
                                          [square_crop_resize, residual_block_packed,
                                           viterbi_decode, yuv420_to_rgb])
    run_family_phase(torch, dev, check, boxes_all, stand_in, residual_block_packed)

    # ---- phase 8: the log path, the window route and the command line ----
    with capture_restored():
        log_launches = run_log_phase(torch, dev, check, [window_resize, residual_block_packed,
                                                         viterbi_decode, yuv420_to_rgb])

    # ---- phase 9: the pixels-only path, AIRunner ----
    viterbi_decode.launches = yuv420_to_rgb.launches = 0
    with capture_restored():
        pixels, pixels_runner = run_pixels_phase(torch, dev, check, card, residual_block_packed)
    pixels_k3k4 = [viterbi_decode.launches, yuv420_to_rgb.launches]
    check(pixels_k3k4 == [0, 0],
          f"phase 9: K3 and K4 launches {pixels_k3k4}: none (the runner decodes by argmax, its "
          f"crops are float crops cut on the host)")

    # ---- phase 10: training on the card ----
    training = run_train_phase(torch, dev, check, card, residual_block_packed)

    # ---- phase 11: device-side synthetic training, in a fresh process ----
    synth = run_synth_phase(check) or {}
    log(f"phase 11: {json.dumps({k: v for k, v in synth.items() if k != 'failures'})}; {card}")

    # ---- phase 12: character-detector training ----
    detector = run_detector_phase(torch, dev, check, card,
                                  [square_crop_resize, window_resize, bank_resize],
                                  residual_block_packed)
    log(f"phase 12: {json.dumps(detector)}; {card}")

    # ---- phase 13: the multi-device path ----
    square_crop_resize.launches = 0
    mesh = run_mesh_phase(torch, dev, check, card, residual_block_packed, boxes_all, stand_in,
                          vod_fps)
    k1_mesh_launches = square_crop_resize.launches

    # ---- phase 14: OCR training and the evaluation dashboards ----
    k1_wrappers = (square_crop_resize, window_resize, bank_resize)
    for wrapper in k1_wrappers:
        wrapper.launches = 0
    dashboards = run_ocr_viz_phase(torch, dev, check, card, residual_block_packed, pixels_runner)
    k1_dashboard_launches = sum(wrapper.launches for wrapper in k1_wrappers)

    # ---- phase 15: the synth split on drawn skeletal sprites, in a fresh process ----
    t0 = time.perf_counter()
    sprites = run_sprites_phase(check) or {}
    log(f"phase 15 in {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps({k: v for k, v in sprites.items() if k != 'failures'})}; {card}")

    # ---- phase 16: the annotated-match path (Manuscript) ----
    t0 = time.perf_counter()
    manuscript_res = run_manuscript_phase(torch, dev, check, card, pixels_runner)
    log(f"phase 16 in {time.perf_counter() - t0:.1f} s: {json.dumps(manuscript_res)}; {card}")

    # ---- phase 17: ground truth from a (VOD, log) pair, both trainings on it ----
    k1_wrappers = (square_crop_resize, window_resize, bank_resize)
    for wrapper in k1_wrappers:
        wrapper.launches = 0
    gt = run_gt_phase(torch, dev, check, card, residual_block_packed)
    k1_gt_launches = sum(wrapper.launches for wrapper in k1_wrappers)
    log(f"phase 17: {json.dumps(gt)}; {card}")

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
         "bf16_device_ms": k2_bf16_dev_ms, "bf16_bound_ms": k2_bf16_bound_ms,
         "bf16_plain_ms": k2_bf16_plain_ms, "bf16_library_ms": k2_bf16_lib_ms},
    ]
    # K1's window entry (phase 8's path), beside the frame entry's numbers.
    # K3 and K4: launches of the path that runs each (phase 4's slice for
    # K3, phase 6's yuv420 route for K4), then every phase's.
    kernels += [
        {"name": "viterbi", "route": "cuda", "source": "playaid_core_torch/csrc/viterbi.cu",
         "replaces": "playaid_core_tpu/infer/pipeline.py:356",
         "launches": launches["viterbi"], "max_abs_err": float(k3_err),
         "ms": k3_ms, "device_ms": k3_dev_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound_ms, "bound_by": "bytes", "library_ms": None,
         "shape": list(k3_lp.shape), "true_len": k3_len,
         "device_us_per_step": None if k3_dev_ms is None else k3_dev_ms * 1e3 / k3_rows,
         "match_shape": list(match_lp.shape), "match_ms": k3_match_ms,
         "match_device_ms": k3_match_dev_ms,
         "match_device_us_per_step": (None if k3_match_dev_ms is None
                                      else k3_match_dev_ms * 1e3 / MATCH_ROWS),
         "chain_floor_cycles_per_step": floor_cycles, "chain_floor_us_per_step": floor_us,
         "chain_floor_ms": k3_floor_ms, "match_chain_floor_ms": k3_match_floor_ms},
        {"name": "yuv420_unpack", "route": "cuda",
         "source": "playaid_core_torch/csrc/yuv420_unpack.cu",
         "replaces": "playaid_core_tpu/infer/pipeline.py:246",
         "launches": vod_launches[3], "max_abs_err": k4_err,
         "ms": k4_ms, "device_ms": k4_dev_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound_ms, "bound_by": "bytes", "library_ms": None,
         "shape": list(yuv.shape), "plain_device_ms": k4_plain_dev_ms,
         "plain_kernels": k4_plain_kernels, "embed_nchw_ms": embed_ms["nchw"],
         "embed_nhwc_ms": embed_ms["nhwc"]},
    ]
    for kernel, n_slice, n_pixels, n_mesh in zip(kernels[2:], (launches["viterbi"],
                                                                launches["yuv420_unpack"]),
                                                 pixels_k3k4, (mesh.pop("vod_k3_launches"),
                                                               mesh.pop("vod_k4_launches"))):
        kernel.update({"slice_launches": n_slice, "pixels_launches": n_pixels,
                       "mesh_launches": n_mesh})
    for kernel, n, n_window in zip(kernels, vod_launches, log_launches):
        kernel["vod_launches"] = n
        kernel["window_launches"] = n_window
    kernels[0].update({"window_max_abs_err": kw_err, "window_ms": kw_ms,
                       "window_device_ms": kw_dev_ms, "window_plain_ms": kw_plain_ms,
                       "window_bound_ms": kw_bound_ms, "window_library_ms": kw_lib_ms})
    # K2 in the detector's trunk and the action embed of phase 9.
    kernels[1]["route_shapes"] = k2_routes
    kernels[1].update({f"pixels_{k}": v for k, v in pixels.items()})
    # K2 in the eval steps of phase 10's training (none in its train steps).
    kernels[1].update({f"train_{k}": v for k, v in training.items() if k != "families"})
    # K1's bank entry in phase 11's synthetic training (and K2, none there).
    synth_launches = synth.get("launches", {})
    kernels[0].update({k: synth.get(k) for k in (
        "bank_max_abs_err", "bank_ms", "bank_device_ms", "bank_plain_ms", "bank_bound_ms",
        "bank_library_ms")})
    kernels[0]["bank_launches"] = synth_launches.get("bank_resize")
    kernels[1]["synth_launches"] = synth_launches.get("residual_block")
    # Phase 12: no K1 on the detector-training path; K2 in evaluate's trunk.
    kernels[0]["detector_train_launches"] = detector["k1_launches"]
    kernels[1].update({f"detector_train_{k}": detector[k] for k in (
        "launches", "train_step_launches", "max_abs_err", "shape", "ms", "device_ms",
        "plain_ms", "bound_ms", "library_ms")})
    # Phase 13: K2 in the meshed evaluate and in each replica of
    # VodAnalyzer(mesh=); K1 not on the path (host crops).
    kernels[0]["mesh_launches"] = k1_mesh_launches
    kernels[1].update({f"mesh_{k}": v for k, v in mesh.items()})
    # Phase 14: K2 in evaluate_samples at 7x4x4x512 (one a sample); K1 (any
    # entry) not on the path (cut crops); K2's device ms at phase 13's
    # replica shape.
    kernels[0]["dashboard_launches"] = k1_dashboard_launches
    kernels[1]["mesh_vod_device_ms"] = dashboards.pop("mesh_device_ms")
    kernels[1].update({f"dashboard_{k}": v for k, v in dashboards.items()})
    # Phase 15: K1's bank entry in DeviceSynthDataset's steps on the drawn
    # tree; K2 in the host split's evaluation (none in its train steps).
    kernels[0].update({"sprites_bank_launches": sprites.get("bank_launches"),
                       "sprites_bank_max_abs_err": sprites.get("bank_max_abs_err"),
                       "sprites_train_step_launches": sum(
                           v for k, v in sprites.get("train_launches", {}).items()
                           if k != "residual_block")})
    kernels[1].update({f"sprites_{k[3:]}": sprites.get(k) for k in (
        "k2_launches", "k2_max_abs_err", "k2_shape", "k2_ms", "k2_device_ms", "k2_plain_ms",
        "k2_bound_ms", "k2_library_ms")})
    kernels[1]["sprites_train_step_launches"] = sprites.get("train_launches", {}).get(
        "residual_block")
    # Phase 16: K1's frames entry on the shared-frame route (one frame, two
    # crops a launch); K2 not on the manuscript's path (its input is phase
    # 9's ai_output.yaml).
    kernels[0].update({f"shared_frame_{k}": manuscript_res[k] for k in (
        "launches", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "library_ms")})
    # Phase 17: K2 in the evaluations of both trainings on the generated
    # trees (none in their train steps); K1 (any entry) not on the path
    # (ground-truth crops are square_crop on the host).
    kernels[0]["gt_launches"] = k1_gt_launches
    kernels[1].update({f"gt_{k[3:]}": v for k, v in gt.items() if k.startswith("k2_")})
    kernels.append(k5)
    kernels.append(k6)
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
