"""End-to-end VOD analysis: decode -> staging -> embed -> buffer -> labels.

Counterpart of ``playaid_core_tpu/infer/vod_pipeline.py``, with its
command line (:func:`main`) and :func:`boxes_from_log`, which projects the
fighters' boxes from an ult_logger log.  Its layers:

* **host decode**: a pool of decode workers (:class:`_DecodePool`, one
  or more threads) takes the chunks in any order and hands each to the
  dispatcher.  On the native route the libavcodec crop extractor
  (``video/native_decoder.py``) turns a chunk of frames into packed
  YUV420 (or BGR) uint8 crops of model size in one C call that releases
  the interpreter lock.  The cv2 route (``decode_backend="cv2"``) reads
  frames through ``video/reader.open_capture`` (``cv2.VideoCapture`` by
  default) and crops on the host with :func:`extract_crops`.  The window
  route (``host_resize=False``) reads frames the same way but cuts a fixed
  window around each box with :func:`extract_windows` and leaves the
  resize to the device;
* **staging**: one dispatcher thread per analysis copies each chunk into
  a small ring of pinned host buffers (``parallel/staging.PinnedStager``)
  and issues the host-to-device copy on its own CUDA stream; the compute
  stream waits for the copy, and a slot is refilled only after its last
  copy has finished;
* **embed**: ``embed_crops_yuv`` / ``embed_crops_u8`` of the pipeline, or
  ``embed_windows`` on the window route (the crop kernel's window entry,
  then the same embed), on cuDNN and the residual-block kernel in
  ResNet-18;
* **buffer**: ``scatter_embeddings`` into one embedding buffer;
* **head and decode**: ``classify_buffer`` (argmax or Viterbi), then each
  sampled frame's label is repeated over the ``stride`` frames it stands
  for.

Weights are loaded into the pipeline's modules on its device once, when
the analyzer is made.  With ``mesh=`` (a single-process
``parallel.mesh.make_mesh(devices=...)``), each device of the mesh's
``data`` axis holds a replica of the embed, made there once; each chunk's
rows are split over the replicas, each staged and embedded on its device,
and the embeddings gathered into the buffer on the first device (the
pipeline's), where the head and the label decode run.

Command line (the card unless ``--device cpu``)::

    python -m playaid_core_torch.infer.vod_pipeline --video V --log L \
        [--checkpoint C] [--stride N] [--out labels.csv] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from playaid_core_torch import profiling
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.parallel.staging import PinnedStager
from playaid_core_torch.video import native_decoder, reader


def extract_windows(frame, boxes, window, padding):
    """Slice per-box square windows out of one BGR frame.

    boxes: ``[K, 4]`` normalised yolo.  Returns (windows ``[K, window,
    window, 3]`` uint8 BGR with black out-of-frame fill, origins ``[K, 3]``
    = window-relative (y0, x0, side) for the device resample), matching
    YoloCrop.square_crop geometry (reference: fighter.py:323-344).
    """
    h, w = frame.shape[:2]
    k = boxes.shape[0]
    wins = np.zeros((k, window, window, 3), np.uint8)
    origins = np.zeros((k, 3), np.float32)
    for j in range(k):
        cx, cy, bw, bh = boxes[j]
        cxp, cyp = int(cx * w), int(cy * h)
        half = int(max(int(bw * w), int(bh * h)) / 2)
        side = 2 * (half + padding)
        if side > window - 2:
            # The crop exceeds the window: shrink it around the same centre
            # rather than truncate its bottom and right.
            half = (window - 2) // 2 - padding
            side = 2 * (half + padding)
        ys = cyp - half - padding
        xs = cxp - half - padding
        vy0, vy1 = max(0, ys), min(h, ys + window)
        vx0, vx1 = max(0, xs), min(w, xs + window)
        if vy1 > vy0 and vx1 > vx0:
            wins[j, vy0 - ys:vy1 - ys, vx0 - xs:vx1 - xs] = frame[vy0:vy1, vx0:vx1]
        origins[j] = (0.0, 0.0, float(side))
    return wins, origins


def extract_crops(frame, boxes, out_size, padding):
    """Host-side square letterboxed crops (YoloCrop.square_crop semantics)
    for each box of one BGR frame -> ``[K, out_size, out_size, 3]`` uint8,
    resized with ``cv2.INTER_AREA``."""
    import cv2

    h, w = frame.shape[:2]
    k = boxes.shape[0]
    out = np.zeros((k, out_size, out_size, 3), np.uint8)
    for j in range(k):
        cx, cy, bw, bh = boxes[j]
        cxp, cyp = int(cx * w), int(cy * h)
        half = int(max(int(bw * w), int(bh * h)) / 2)
        side = 2 * (half + padding)
        if side <= 0:
            continue
        y0, x0 = cyp - half - padding, cxp - half - padding
        canvas = np.zeros((side, side, 3), np.uint8)
        vy0, vy1 = max(0, y0), min(h, y0 + side)
        vx0, vx1 = max(0, x0), min(w, x0 + side)
        if vy1 > vy0 and vx1 > vx0:
            canvas[vy0 - y0:vy1 - y0, vx0 - x0:vx1 - x0] = frame[vy0:vy1, vx0:vx1]
        out[j] = cv2.resize(canvas, (out_size, out_size), interpolation=cv2.INTER_AREA)
    return out


def boxes_from_log(label_path, num_frames=None, log_offset=0, parser="auto"):
    """Per-frame two-fighter boxes ``[F, 2, 4]`` (normalised yolo) from an
    ult_logger log via batched camera projection (no detector needed).
    ``parser``: "auto" or "native" (the C++ parser, built on first use)
    or "python"."""
    from playaid_core_torch.timeline import (
        load_ground_truth_from_path,
        precompute_timeline_projection,
        update_fighters_from_timeline,
    )

    timeline = load_ground_truth_from_path(label_path, log_offset=log_offset, parser=parser)
    precompute_timeline_projection(timeline)
    f_total = len(timeline) if num_frames is None else min(num_frames, len(timeline))
    boxes = np.zeros((f_total, 2, 4), np.float32)
    fighters = []
    for i in range(f_total):
        fighters = update_fighters_from_timeline(i, timeline[i], fighters)
        for k, fighter in enumerate(fighters[:2]):
            c = fighter.crop
            boxes[i, k] = (c.center_x, c.center_y, c.crop_width, c.crop_height)
    return boxes


def auto_lowres(boxes, video_w, video_h, crop_size, padding, max_lowres=2):
    """The largest fractional-decode factor at which the smallest real
    box's crop side (``2 * (max(bw, bh) // 2 + padding)``, as the native
    extractor computes it) still decodes to at least ``crop_size`` pixels,
    capped at ``max_lowres``.  Zero-size boxes are ignored."""
    b = np.asarray(boxes, np.float32).reshape(-1, 4)
    bw = (b[:, 2] * video_w).astype(np.int64)
    bh = (b[:, 3] * video_h).astype(np.int64)
    half = np.maximum(bw, bh) // 2
    side = 2 * (half + int(padding))
    real = side[half > 0]
    if real.size == 0:
        return 0
    min_side = int(real.min())
    lowres = 0
    while lowres < max_lowres and (min_side >> (lowres + 1)) >= crop_size:
        lowres += 1
    return lowres


def resolve_padding(boxes, padding):
    """``(boxes, int padding)`` for the chunked decode paths.

    An integer padding (pixels) passes through.  A float in (0, 1) is a
    fraction of each box's square side, realised exactly by inflating each
    box's w and h by ``1 + 2 * padding`` with padding 0.  Anything else
    raises.
    """
    if hasattr(padding, "item"):  # numpy scalars from a config parse
        padding = padding.item()
    if isinstance(padding, float) and 0.0 < padding < 1.0:
        out = np.array(boxes, np.float32, copy=True)
        out[..., 2:4] *= 1.0 + 2.0 * padding
        return out, 0
    if float(padding) != int(padding):
        raise ValueError(f"padding must be an int pixel pad or a fraction in (0,1); "
                         f"got {padding!r}")
    return boxes, int(padding)


class _DecodePool:
    """The chunk producer of every decode route: ``workers`` daemon threads
    take chunk indices from a shared queue, in no set order.

    Each thread enters ``route()`` once, a context manager that opens its
    source and gives the route's per-chunk function ``decode(start, stop)
    -> (n, *arrays)``, and hands ``(start, n, *arrays)`` to ``sink``.  Order
    does not matter: the sink writes each chunk at its own offset.
    :meth:`wait` blocks until every chunk has been through the sink and
    re-raises the first error of a worker or of the sink; :meth:`close`
    drops the chunks not yet taken.  The workers' spans belong to
    ``analysis``.
    """

    def __init__(self, num_frames, chunk, route, sink, workers, analysis=None):
        self.num_frames = num_frames
        self.chunk = chunk
        self.route = route
        self.sink = sink
        self.analysis = analysis
        self.num_chunks = (num_frames + chunk - 1) // chunk
        self._error = None
        self._closed = False
        self._cond = threading.Condition()
        self._done = 0
        self._tasks = queue.Queue()
        for t in range(self.num_chunks):
            self._tasks.put(t)
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(min(workers, self.num_chunks))]
        for t in self._threads:
            t.start()

    def wait(self):
        """Block until every chunk has been through the sink, or a worker
        failed or the pool was closed; re-raise the first error."""
        with self._cond:
            while self._done < self.num_chunks and self._error is None and not self._closed:
                self._cond.wait()
            if self._error is not None:
                raise self._error

    def close(self):
        """Drop the chunks not yet taken and wake the waiter.  Safe to call
        from the caller's error path."""
        with self._cond:
            self._closed = True
            try:
                while True:
                    self._tasks.get_nowait()
            except queue.Empty:
                pass
            self._cond.notify_all()

    def _worker(self):
        profiling.bind(self.analysis)
        try:
            with self.route() as decode:
                while not self._closed:
                    try:
                        chunk_idx = self._tasks.get_nowait()
                    except queue.Empty:
                        return
                    start = chunk_idx * self.chunk
                    self.sink(start, *decode(start, min(start + self.chunk, self.num_frames)))
                    with self._cond:
                        self._done += 1
                        if self._done >= self.num_chunks:
                            self._cond.notify_all()
        except BaseException as e:  # handed to the waiter, which raises it
            with self._cond:
                if self._error is None:
                    self._error = e
                self._cond.notify_all()


class _ChunkDispatcher:
    """The one thread of an analysis that touches the devices: for each
    chunk handed to :meth:`sink` it splits the chunk's arrays (``[rows, 2,
    ...]`` each: the crops, or the windows and their origins), two
    fighters to a row, over the ``replicas`` (``(embed, stager)`` pairs,
    one per device), stages and embeds each part
    (``embed(*arrays)``) on its device, and scatters the embeddings, in row
    order, into the buffer.  An error stops the decode at the next chunk
    and is raised again by :meth:`finish`.  Its spans belong to
    ``analysis``."""

    QUEUE_CHUNKS = 8
    JOIN_TIMEOUT_S = 600.0

    def __init__(self, pipeline, replicas, buf, stride, analysis=None):
        self.pipeline = pipeline
        self.analysis = analysis
        self.replicas = replicas
        self.buf = buf
        self.stride = stride
        self.decoded = 0
        self.extent = 0  # highest sampled row written + 1, not a count
        self.error = None
        self._queue = queue.Queue(maxsize=self.QUEUE_CHUNKS)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def sink(self, start, n, *arrays):
        """Hand over one decoded chunk (from any decode thread); blocks
        while the queue is full, and returns once the run is stopping."""
        if self.error is not None:
            raise self.error
        with profiling.span("playaid.sink_wait"):
            while not self._stop.is_set():
                try:
                    self._queue.put((start, n, arrays), timeout=0.25)
                    return
                except queue.Full:
                    continue

    def _run(self):
        profiling.bind(self.analysis)
        dev = self.pipeline.device
        device_ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        # inference_mode is per thread: this thread enters it itself.
        with device_ctx, torch.inference_mode():
            while True:
                with profiling.span("playaid.dispatch_wait"):
                    item = self._queue.get()
                if item is None:
                    return
                start, n, arrays = item
                if self.error is not None or n == 0:
                    continue  # keep draining so producers never block
                try:
                    flat = [a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:]) for a in arrays]
                    emb = self._embed(flat)
                    with profiling.span("playaid.scatter"):
                        self.pipeline.scatter_embeddings(self.buf, emb,
                                                         (start // self.stride) * 2)
                    self.decoded += n
                    self.extent = max(self.extent, (start + n + self.stride - 1) // self.stride)
                except BaseException as e:  # raised again on the analyzing thread
                    self.error = e

    def _embed(self, flat):
        if len(self.replicas) == 1:
            return self._embed_on(*self.replicas[0], flat)
        parts = zip(*(np.array_split(a, len(self.replicas)) for a in flat))
        embs = [self._embed_on(embed, stager, part)
                for (embed, stager), part in zip(self.replicas, parts)]
        return torch.cat([e.to(self.buf.device) for e in embs])

    @staticmethod
    def _embed_on(embed, stager, arrays):
        """Stage ``arrays`` and embed them on one replica's device."""
        staged = stager.to_device(*arrays)
        with profiling.span("playaid.embed", crops=arrays[0].shape[0]):
            return embed(*staged)

    def finish(self):
        """Stop producers blocked in :meth:`sink`, let the dispatcher run
        the chunks it holds, wait for it, and raise its error if any."""
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=self.JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            raise RuntimeError(f"the dispatcher did not finish within {self.JOIN_TIMEOUT_S} s")
        if self.error is not None:
            raise self.error


class VodAnalyzer:
    """Analyze a VOD: per-frame action labels for both fighters.

    ``pipeline`` defaults to the CNN family on the CUDA device (and raises
    without one).  ``variables`` are weights as the JAX package's numpy
    tree or the port's state dicts; they are loaded into the pipeline's
    modules on its device here, once, and not kept.  With
    ``variables=None`` a pipeline that holds no weights yet gets seeded
    random ones (seed 0), with a warning.

    ``decode_backend``: "native" (the libavcodec crop extractor; a failed
    build raises), "cv2" (``cv2.VideoCapture`` and host-side crops), or
    "auto", which means "native".  ``host_resize=False`` takes the window
    route instead: frames from ``video/reader.open_capture``, a
    ``window``-pixel square window around each box cut out on the host,
    and the resize to the model's crops on the device (the crop kernel's
    window entry); it ships BGR windows, decodes every frame (``stride``
    1) and takes ``decode_backend`` "auto" or "cv2".  ``transfer_format``:
    "yuv420" ships packed 4:2:0 crops (half the bytes; converted to RGB on
    the device), "bgr" ships BGR24, "auto" picks yuv420 on the native
    backend.
    ``decode_workers``: the decode pool's threads (default the host's
    cores, at most 6).
    ``stride``: classify every stride-th frame and repeat its label over
    the frames in between; ``chunk`` must divide by it.  ``lowres`` (0, 1,
    2 or "auto", see :func:`auto_lowres`) and ``fast_decode`` (True, False
    or "auto") set the native decode mode.  ``decode``, ``smooth_radius``
    and ``switch_cost`` set the label decode of ``classify_buffer``.
    ``mesh``: a single-process mesh whose ``data`` axis lists the devices
    of the embed's replicas, the first being the pipeline's (see the module
    docstring); None embeds on the pipeline's device alone.
    """

    def __init__(self, pipeline: BatchedActionPipeline | None = None, variables=None,
                 window=384, padding=30, chunk=48, decode_workers=None, host_resize=True,
                 mesh=None, decode_backend="auto", lowres=0, stride=1, transfer_format="auto",
                 fast_decode="auto", decode="argmax", smooth_radius=0, switch_cost=4.0):
        if not host_resize and stride > 1:
            raise ValueError("stride>1 requires host_resize=True")
        if not host_resize and decode_backend == "native":
            raise ValueError("the native decoder makes crops on the host; host_resize=False "
                             "cuts windows from decoded frames (decode_backend 'auto' or 'cv2')")
        if decode_backend not in ("auto", "native", "cv2"):
            raise ValueError(f"decode_backend must be auto, native or cv2, got "
                             f"{decode_backend!r}")
        if transfer_format not in ("auto", "yuv420", "bgr"):
            raise ValueError(f"transfer_format must be auto, yuv420 or bgr, got "
                             f"{transfer_format!r}")
        if stride > 1 and chunk % stride != 0:
            raise ValueError(f"chunk ({chunk}) must be divisible by stride ({stride})")
        self.pipeline = pipeline or BatchedActionPipeline(family="cnn")
        if variables is not None:
            self.pipeline.load_variables(variables)
        elif not self.pipeline.initialized:
            print("WARNING: no trained weights provided; using random initialization "
                  "(labels will be meaningless). Pass variables= or a --checkpoint.",
                  file=sys.stderr)
            self.pipeline.init(0)
        self.window = window
        self.padding = padding
        self.chunk = chunk
        self.host_resize = host_resize
        self.decode_workers = decode_workers or max(1, min((os.cpu_count() or 1), 6))
        self.decode_backend = decode_backend
        self.lowres = lowres
        self.fast_decode = fast_decode
        self.stride = stride
        self.transfer_format = transfer_format
        self.label_decode = decode
        self.smooth_radius = smooth_radius
        self.switch_cost = switch_cost
        self._replicas = self._make_replicas(mesh)

    def _make_replicas(self, mesh):
        """``(pipeline, stager)`` per device of the ``data`` axis: the
        pipeline itself first, then copies that share its head and hold an
        embed of their own on their device."""
        if mesh is None:
            return [(self.pipeline, PinnedStager(self.pipeline.device))]
        if mesh.distributed:
            raise ValueError("VodAnalyzer runs in one process: give it a single-process mesh "
                             "(make_mesh(devices=[...]))")
        devices = list(mesh.devices[:, 0])
        if devices[0] != self.pipeline.device:
            raise ValueError(f"the mesh's first device {devices[0]} must be the pipeline's "
                             f"({self.pipeline.device}): its buffer and head live there")
        replicas = [(self.pipeline, PinnedStager(devices[0]))]
        for dev in devices[1:]:
            replica = copy.copy(self.pipeline)
            replica.embed = copy.deepcopy(self.pipeline.embed).to(dev)
            replica.device = dev
            replicas.append((replica, PinnedStager(dev)))
        return replicas

    def analyze(self, video_path, boxes, num_frames=None):
        """boxes: ``[F, 2, 4]`` normalised yolo boxes per frame.

        Returns a dict: ``labels`` and ``confidences`` ``[F, 2]`` (numpy),
        ``frames`` decoded, ``seconds`` and ``fps`` by wall clock from the
        start of decode to the labels on the host, and the effective
        ``lowres``, ``fast`` and ``backend``.

        The call is the root span ``playaid.analyze`` of a fresh analysis
        (counts ``frames`` and ``chunks``), whose id the dispatcher and
        decode threads are given (:mod:`playaid_core_torch.profiling`).
        """
        analysis = profiling.new_analysis()
        with profiling.span("playaid.analyze", analysis=analysis):
            return self._analyze(analysis, video_path, boxes, num_frames)

    def _analyze(self, analysis, video_path, boxes, num_frames):
        boxes, padding = resolve_padding(boxes, self.padding)
        f_total = boxes.shape[0] if num_frames is None else num_frames
        chunk, stride = self.chunk, self.stride
        crop_size = self.pipeline.crop_size
        use_native = self.host_resize and self.decode_backend in ("auto", "native")
        fmt = self.transfer_format
        if fmt == "auto":
            fmt = "yuv420" if use_native else "bgr"
        if fmt == "yuv420" and not use_native:
            raise ValueError("transfer_format='yuv420' requires the native decoder")

        lowres = self.lowres if isinstance(self.lowres, int) else 0
        eff_fast = 1 if self.fast_decode is True else 0
        if use_native and (self.lowres == "auto" or lowres > 0 or self.fast_decode == "auto"):
            # Cached probe; its handle parks in the pool for the decoder.
            info = native_decoder.probe(video_path, fast=self.fast_decode)
            eff_fast = info["fast"]
            if self.lowres == "auto":
                lowres = auto_lowres(boxes[:f_total], info["width"], info["height"],
                                     crop_size, padding, max_lowres=info["max_lowres"])
            elif self.lowres:
                lowres = min(self.lowres, info["max_lowres"])

        if not self.host_resize:
            embed = "embed_windows"
        elif fmt == "yuv420":
            embed = "embed_crops_yuv"
        else:
            embed = "embed_crops_u8"
        num_chunks = (f_total + chunk - 1) // chunk
        t0 = time.time()
        buf = self.pipeline.make_embedding_buffer(num_chunks * (chunk // stride))
        replicas = [(getattr(pipe, embed), stager) for pipe, stager in self._replicas]
        if use_native:
            route = functools.partial(self._native_route, video_path, boxes, padding, lowres, fmt)
        elif self.host_resize:
            route = functools.partial(self._crop_route, video_path, boxes, padding)
        else:
            route = functools.partial(self._window_route, video_path, boxes, padding)
        with profiling.span("playaid.chunk_loop"):
            dispatcher = _ChunkDispatcher(self.pipeline, replicas, buf, stride, analysis)
            try:
                pool = _DecodePool(f_total, chunk, route, dispatcher.sink, self.decode_workers,
                                   analysis)
                try:
                    pool.wait()
                finally:
                    pool.close()
            finally:
                # Producers blocked in sink() return once the dispatcher stops;
                # it runs what it holds, then ends at the sentinel.
                dispatcher.finish()
        profiling.count("frames", dispatcher.decoded)
        profiling.count("chunks", num_chunks)

        labels, conf = self.pipeline.classify_buffer(
            buf, dispatcher.extent, decode=self.label_decode,
            smooth_radius=self.smooth_radius, switch_cost=self.switch_cost)
        with profiling.span("playaid.labels_to_host"):
            labels, conf = labels.cpu().numpy(), conf.cpu().numpy()
        if stride > 1:
            labels = np.repeat(labels, stride, axis=0)[:f_total]
            conf = np.repeat(conf, stride, axis=0)[:f_total]
        elapsed = time.time() - t0
        return {
            "labels": labels,
            "confidences": conf,
            "frames": dispatcher.decoded,
            "seconds": elapsed,
            "fps": dispatcher.decoded / elapsed if elapsed > 0 else 0.0,
            "lowres": lowres if use_native else 0,
            "fast": eff_fast if use_native else 0,
            "backend": "native" if use_native else "cv2",
        }

    @contextlib.contextmanager
    def _native_route(self, video_path, boxes, padding, lowres, fmt):
        """The native route of one decode worker: dense crops of a chunk
        from one ``decode_crops`` call."""
        chunk, crop_size = self.chunk, self.pipeline.crop_size
        # A pooled handle: the analyzer's probe (or an earlier run) has
        # usually opened this file already.
        dec = native_decoder.acquire(video_path, lowres=lowres, fast=self.fast_decode)

        def decode(start, stop):
            # Every chunk has the full shape; the tail is zero boxes.
            chunk_boxes = np.zeros((chunk, boxes.shape[1], 4), np.float32)
            chunk_boxes[:stop - start] = boxes[start:stop]
            with profiling.span("playaid.decode"):
                n, crops = dec.decode_crops(start, chunk_boxes, crop_size, padding,
                                            stride=self.stride, fmt=fmt, dense=True)
            return min(n, stop - start), crops

        try:
            yield decode
        finally:
            native_decoder.release(dec)

    @staticmethod
    @contextlib.contextmanager
    def _frame_route(video_path, transform, collate):
        """A frame route of one decode worker: a chunk's frames from its
        capture (``reader.open_capture``; no seek when the chunk follows
        the worker's last), each through ``transform(i, frame)``, then
        ``collate(items) -> (n, *arrays)``."""
        cap = reader.open_capture(video_path)
        pos = -1

        def decode(start, stop):
            nonlocal pos
            with profiling.span("playaid.decode"):
                if start != pos:
                    cap.seek(start)
                items = []
                for i in range(start, stop):
                    ok, frame = cap.read()
                    if not ok:
                        break
                    items.append(transform(i, frame))
            pos = stop
            return collate(items)

        try:
            yield decode
        finally:
            cap.release()

    def _crop_route(self, video_path, boxes, padding):
        """The cv2 route: host crops of the sampled frames."""
        chunk, stride, crop_size = self.chunk, self.stride, self.pipeline.crop_size

        def transform(i, frame):
            if i % stride != 0:
                return None
            return extract_crops(frame, boxes[i], crop_size, padding)

        def collate(items):
            # Dense, as the native decoder's dense=True: sampled frame j in
            # row j // stride.
            crops = np.zeros((chunk // stride, 2, crop_size, crop_size, 3), np.uint8)
            for j, c in enumerate(items):
                if c is not None:
                    crops[j // stride] = c
            return len(items), crops

        return self._frame_route(video_path, transform, collate)

    def _window_route(self, video_path, boxes, padding):
        """The window route: a window around each box of every frame."""
        window = self.window

        def transform(i, frame):
            return extract_windows(frame, boxes[i], window, padding)

        def collate(items):
            # The frames read, not the full chunk: the device embeds no
            # padding rows.
            n = len(items)
            wins = np.empty((n, boxes.shape[1], window, window, 3), np.uint8)
            origins = np.empty((n, boxes.shape[1], 3), np.float32)
            for j, (w, o) in enumerate(items):
                wins[j] = w
                origins[j] = o
            return n, wins, origins

        return self._frame_route(video_path, transform, collate)


def analyze_many(jobs, pipeline=None, variables=None, workers=None, **analyzer_kwargs):
    """Analyze several VODs concurrently through one pipeline.

    ``jobs``: ``(video_path, boxes)`` pairs, or ``(video_path, boxes,
    kwargs)`` triples whose dict overrides ``analyzer_kwargs`` for that
    job.  The weights are loaded once; each job gets its own
    :class:`VodAnalyzer` (decoder, dispatcher, staging ring, buffer).
    Returns the results in job order; a failed job's slot holds its
    exception.
    """
    from concurrent.futures import ThreadPoolExecutor

    pipe = pipeline or BatchedActionPipeline(family="cnn")
    VodAnalyzer(pipe, variables=variables, **analyzer_kwargs)  # loads the weights once

    def run_one(job):
        video_path, boxes, *rest = job
        kwargs = {**analyzer_kwargs, **(rest[0] if rest else {})}
        return VodAnalyzer(pipe, **kwargs).analyze(video_path, boxes)

    workers = workers or min(len(jobs), max(os.cpu_count() or 1, 1))
    results = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(run_one, job) for job in jobs]
        for fut in futures:
            try:
                results.append(fut.result())
            except Exception as e:  # noqa: BLE001 - each job's failure is its result
                results.append(e)
    return results


def main(argv=None):
    """``analyze-vod``: per-frame action labels over a whole VOD, with the
    fighters' boxes projected from the ult_logger log (no detector), on the
    card unless ``--device cpu``."""
    parser = argparse.ArgumentParser(
        prog="python -m playaid_core_torch.infer.vod_pipeline",
        description="Batched action recognition over a full VOD, with fighter boxes "
                    "projected from the log (detection-free).")
    parser.add_argument("--video", "-v", required=True, help="Path to the VOD")
    parser.add_argument("--log", "-l", dest="log_path", required=True,
                        help="ult_logger log path")
    parser.add_argument("--family", default="cnn", choices=["cnn", "resformer", "rnn"])
    parser.add_argument("--frames", default=None, type=int, help="limit analyzed frames")
    parser.add_argument("--out", "-o", default=None, help="write labels CSV here")
    parser.add_argument("--checkpoint", "-c", default=None,
                        help="reference Lightning .ckpt, or a state-dict file of "
                             "BatchedActionPipeline.save_checkpoint")
    parser.add_argument("--backend", default="auto", choices=["auto", "native", "cv2"],
                        help="decode backend (native = libavcodec crop extractor)")
    parser.add_argument("--lowres", default="auto",
                        help="fractional decode: 0/1/2, or 'auto' to pick the largest "
                             "label-safe factor from the box sizes")
    parser.add_argument("--stride", default=1, type=int,
                        help="classify every stride-th frame, propagate labels")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; 'cpu' runs the plain "
                             "PyTorch versions)")
    args = parser.parse_args(argv)
    from playaid_core_torch.ontology import CLASS_ID_TO_MOVE

    lowres = args.lowres if args.lowres == "auto" else int(args.lowres)
    boxes = boxes_from_log(args.log_path, num_frames=args.frames)
    pipe = BatchedActionPipeline(family=args.family, device=args.device)
    if args.checkpoint:
        pipe.load_checkpoint(args.checkpoint)
    analyzer = VodAnalyzer(pipe, decode_backend=args.backend, lowres=lowres,
                           stride=args.stride)
    result = analyzer.analyze(args.video, boxes)
    print(f"{result['frames']} frames in {result['seconds']:.2f}s "
          f"({result['fps']:.1f} fps)")
    if args.out:
        with open(args.out, "w") as f:
            f.write("frame,p0_action,p0_conf,p1_action,p1_conf\n")
            for i in range(result["frames"]):
                l0, l1 = result["labels"][i]
                c0, c1 = result["confidences"][i]
                f.write(f"{i},{CLASS_ID_TO_MOVE.get(int(l0), l0)},{c0:.2f},"
                        f"{CLASS_ID_TO_MOVE.get(int(l1), l1)},{c1:.2f}\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
