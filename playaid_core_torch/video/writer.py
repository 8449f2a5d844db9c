"""Video encode + audio remux seam.

The port's own copy of ``playaid_core_tpu/video/writer.py``, over the
port's libavcodec encoder (:mod:`.native_encoder`) instead of cv2: the
annotated canvas goes to the encoder as RGBA, converted to YUV420 there,
on a background thread.  The audio remux keeps the reference's ffmpeg
subprocess seam (reference: manuscript.py:249-279) and, without an ffmpeg
binary, the in-process libavformat remuxer (:mod:`.native_remux`); it
degrades to the silent video with a warning when neither can remux.
"""

from __future__ import annotations

import os
import queue
import shutil
import subprocess
import tempfile
import threading
import uuid

ENCODERS = ("mpeg4", "native")


class _EncodeThread:
    """Background encode stage: ``write`` enqueues a frame copy and
    returns; a dedicated thread feeds the encoder (which releases the GIL
    inside libavcodec), so encoding overlaps the render loop."""

    def __init__(self, inner, maxsize=4):
        self.inner = inner
        self._q = queue.Queue(maxsize=maxsize)
        self._error = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            frame = self._q.get()
            if frame is None:
                return
            try:
                self.inner.write(frame)
            except BaseException as e:  # surface on the next write/release
                self._error = e
                # keep consuming so a producer blocked in put() never hangs
                while self._q.get() is not None:
                    pass
                return

    def write(self, frame, copy=True):
        if self._error is not None:
            raise self._error
        # copy=False: the caller hands over a frame it will not touch again.
        self._q.put(frame.copy() if copy else frame)

    def release(self):
        self._q.put(None)
        self._thread.join()
        self.inner.release()
        if self._error is not None:
            raise self._error


class VideoWriter:
    """Threaded encode seam for rendered output.

    ``PLAYAID_ENCODER`` (or ``codec``) picks the encoder: "mpeg4" (mp4v, the
    reference's own output codec, annotator.py:72, in constant-quantiser
    mode ``PLAYAID_MPEG4_Q``, default 8; the default) or "native" (libx264
    at ``PLAYAID_X264_PRESET``/``PLAYAID_X264_CRF``, default ultrafast/26).
    Width and height must be even (YUV420).  ``PLAYAID_ENCODER_SYNC=1``
    encodes on the calling thread (debugging).
    """

    def __init__(self, path, fps, width, height, codec=None):
        from playaid_core_torch.video.native_encoder import NativeVideoWriter

        self.path = path
        self.width = width
        self.height = height
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        prefer = codec or os.environ.get("PLAYAID_ENCODER", "mpeg4")
        if prefer == "mpeg4":
            inner = NativeVideoWriter(path, fps, (width, height), codec="mpeg4", preset=None,
                                      crf=int(os.environ.get("PLAYAID_MPEG4_Q", "8")),
                                      threads=0)
        elif prefer == "native":
            inner = NativeVideoWriter(path, fps, (width, height), codec="libx264",
                                      preset=os.environ.get("PLAYAID_X264_PRESET", "ultrafast"),
                                      crf=int(os.environ.get("PLAYAID_X264_CRF", "26")),
                                      threads=0)
        else:
            raise ValueError(f"PLAYAID_ENCODER must be one of {ENCODERS}, got {prefer!r}")
        if os.environ.get("PLAYAID_ENCODER_SYNC", "0") == "1":
            self.writer = inner
        else:
            self.writer = _EncodeThread(inner)

    def write(self, frame, copy=True):
        """Write a [h, w, 3] BGR or [h, w, 4] RGBA uint8 frame."""
        assert frame.shape[0] == self.height and frame.shape[1] == self.width, (
            f"Incorrect frame size, expected {self.width}x{self.height} "
            f"got {frame.shape[1]}x{frame.shape[0]}"
        )
        if isinstance(self.writer, _EncodeThread):
            self.writer.write(frame, copy=copy)
        else:
            self.writer.write(frame)

    def release(self):
        self.writer.release()


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _tmp_path(output_video_path):
    return os.path.join(tempfile.gettempdir(),
                        f"{uuid.uuid4().hex}_{os.path.basename(output_video_path)}")


def add_audio(output_video_path, input_video_path):
    """Remux the source audio track into the rendered video (reference:
    manuscript.py:249-279).  Prefers the ffmpeg binary (the reference's
    exact seam); without one, uses the in-process libavformat remuxer.
    No remux backend, or a source with no audio stream, leaves the silent
    video in place with a warning instead of failing a finished render."""
    if not ffmpeg_available():
        return _add_audio_native(output_video_path, input_video_path)
    tmp_path = _tmp_path(output_video_path)
    command = [
        "ffmpeg", "-y",
        "-i", output_video_path,
        "-i", input_video_path,
        "-c:v", "copy",
        "-c:a", "aac",
        "-strict", "experimental",
        "-map", "0:v:0",
        "-map", "1:a:0",
        "-shortest",
        tmp_path,
    ]
    result = subprocess.run(command, capture_output=True)
    if result.returncode != 0:
        print("audio remux failed (source may have no audio stream); "
              f"keeping silent video: {result.stderr.decode(errors='replace')[-200:]}")
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        return False
    shutil.move(tmp_path, output_video_path)
    return True


def _add_audio_native(output_video_path, input_video_path):
    """In-process remux via libavformat (native/audio_remux.cpp) for hosts
    without an ffmpeg binary — same -shortest stream-copy semantics."""
    from playaid_core_torch.video import native_remux

    if not native_remux.available():
        print("no ffmpeg binary and native remuxer unavailable; skipping audio remux")
        return False
    tmp_path = _tmp_path(output_video_path)
    try:
        ok = native_remux.remux(output_video_path, input_video_path, tmp_path)
    except Exception as e:  # noqa: BLE001 - a finished render keeps its silent video
        print(f"native audio remux failed ({e}); keeping silent video")
        return False
    if not ok:
        print("audio remux failed (source may have no audio stream); keeping silent video")
        return False
    shutil.move(tmp_path, output_video_path)
    return True
