"""The VOD route: ``VodAnalyzer.analyze`` of ``playaid_core_torch`` over
VODs made of the pool's scenes, on the native route:
:class:`~portbench.standin.CropSource` stands behind the native decoder and
hands out packed YUV420 crops, which K4 unpacks on the card.

Correctness compares every VOD the window finished with the reference:

* ``lp_err``: the widest gap between the head's log-probs that K3 took
  (recorded where ``classify_buffer`` hands them to it) and the
  reference's, over every row, fighter and class;
* ``label_mismatch``: frames whose label differs from the reference's
  Viterbi decode of those same log-probs, repeated over the stride;
* ``conf_err``: the widest gap, in percentage points, between a frame's
  confidence and ``100 exp`` of the reference's log-prob of its label.

The reference is the configuration's family's (``families/<family>.py``,
handed to the route with the configuration).  It embeds each scene's crop
once and gathers the embeddings in each VOD's order; the program embedded
every crop of every VOD.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import standin
from portbench.reference import models as ref_models
from portbench.reference import ops as ref_ops

CHECK_BLOCK = 2048  # windows a reference head call


class VodRun:
    """One analysis: the VOD, host-clock marks, the program's outputs."""

    def __init__(self, vod, frames):
        self.vod, self.frames = vod, frames
        self.start = self.end = None
        self.classify = None       # (start, end) of classify_buffer, traced runs
        self.embeds = []           # crops of each embed call, traced runs
        self.labels = self.conf = None
        self.lp = None             # K3's input rows [2, rows, A], on the host
        self.error = None

    @property
    def ok(self):
        return self.error is None


class Route:
    def __init__(self, config, family, traffic, seed, device, root, log):
        self.config, self.family, self.traffic, self.seed = config, family, traffic, seed
        self.device = torch.device(device)
        self.root, self.log = root, log
        kw = dict(config["analyzer"], **traffic["analyzer"])
        self.stride = kw["stride"]
        self.chunk = kw["chunk"]
        self.kwargs = kw
        self.frames = traffic["frames_per_vod"]
        self.rows = -(-self.frames // self.stride)
        self.chunks = -(-self.frames // self.chunk)

    # ---- set-up ----

    def setup(self):
        from playaid_core_torch.convert import load_npz_tree
        from playaid_core_torch.infer import pipeline as pipeline_mod
        from playaid_core_torch.infer import vod_pipeline
        from playaid_core_torch.infer.pipeline import BatchedActionPipeline
        from playaid_core_torch.video import native_decoder

        c, t = self.config, self.traffic
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from playaid_core_torch.ops import _build

            _build.build()  # every kernel at once; a no-op once built
        t1 = time.perf_counter()
        self.pipe = BatchedActionPipeline(family=c["family"], num_actions=c["num_actions"],
                                          sequence_length=c["sequence_length"],
                                          frame_delta=c["frame_delta"],
                                          crop_size=c["crop_size"], device=self.device)
        if c["weights"] == "seeded":
            self.weights = self.family.weights(c, self.seed, self.device, self.root)
            self.pipe.load_state_dicts(self.weights)
        else:
            self.weights = None  # the reference reads the file itself, after the window
            self.pipe.load_variables(load_npz_tree(f"{self.root}/{c['weights']}"))
        t2 = time.perf_counter()
        self.pool = standin.Pool(t, self.seed)
        self.schedule = standin.Schedule(t, self.seed)
        self.registry = standin.Registry()
        self.scene_crops = self.pool.crops(c["crop_size"], self.kwargs["padding"])
        self.registry.install_native(native_decoder)

        # K3's input, as classify_buffer hands it over.
        self._k3 = []
        self._pipeline_mod = pipeline_mod
        self._k3_entry = k3 = pipeline_mod.viterbi_decode

        def recorded(log_probs, true_len, switch_cost):
            self._k3.append(log_probs)
            return k3(log_probs, true_len, switch_cost)

        pipeline_mod.viterbi_decode = recorded
        self.analyzer = vod_pipeline.VodAnalyzer(self.pipe, **self.kwargs)
        t3 = time.perf_counter()
        self._warm()
        self.log(f"set-up: kernels {t1 - t0:.3f} s, model and weights {t2 - t1:.3f} s, "
                 f"inputs {t3 - t2:.3f} s, warm-up {time.perf_counter() - t3:.3f} s")

    def _warm(self):
        """Every shape of the cell: chunks through the embed, and
        ``classify_buffer`` at the VOD's buffer size."""
        warm = min(self.frames, self.traffic["warm_frames"])
        self.analyze(-1, num_frames=warm)
        if warm < self.frames:
            buf = self.pipe.make_embedding_buffer(self.chunks * (self.chunk // self.stride))
            self.pipe.classify_buffer(buf, self.rows, decode=self.kwargs["decode"],
                                      switch_cost=self.kwargs["switch_cost"])
        self._sync()
        self._k3.clear()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the timed path ----

    def _register(self, vod):
        name = f"vod{vod}.mp4"
        self.registry.sources[name] = standin.CropSource(
            self.scene_crops, self.schedule, vod, self.config["crop_size"], self.kwargs["padding"])
        return name

    def analyze(self, vod, num_frames=None, traced=False):
        """One ``VodAnalyzer.analyze`` of VOD ``vod``, timed by the host
        clock from the call to the labels on the host."""
        name = self._register(vod)
        boxes = standin.vod_boxes(self.pool, self.schedule, vod)
        run = VodRun(vod, num_frames or self.frames)
        if traced:
            self._wrap_embed(run)
            self._wrap_classify(run)
        run.start = time.perf_counter()
        try:
            res = self.analyzer.analyze(name, boxes, num_frames=num_frames)
            run.end = time.perf_counter()
            run.labels, run.conf = res["labels"], res["confidences"]
            if res["frames"] != run.frames:
                run.error = f"{res['frames']} frames analysed of {run.frames}"
            # After the VOD's end: its labels are on the host, the card is idle.
            rows = -(-run.frames // self.stride)
            run.lp = self._k3.pop()[:, :rows].cpu().numpy()
        except Exception as e:  # noqa: BLE001 - a failed analysis is counted, not fatal
            run.end = time.perf_counter()
            run.error = repr(e)
        finally:
            self._k3.clear()
            del self.registry.sources[name]
            if traced:
                del self.pipe.classify_buffer, self.pipe.embed_crops_yuv
        return run

    def _wrap_embed(self, run):
        """Each embed call inside the span ``portbench.embed``, its crops
        recorded (traced runs only)."""
        embed = type(self.pipe).embed_crops_yuv.__get__(self.pipe)

        def spanned(crops):
            run.embeds.append(crops.shape[0])
            with torch.profiler.record_function("portbench.embed"):
                return embed(crops)

        self.pipe.embed_crops_yuv = spanned

    def _wrap_classify(self, run):
        """``classify_buffer`` with the card synchronised at its start and
        end, inside the span ``portbench.classify`` (traced runs only)."""
        classify = type(self.pipe).classify_buffer.__get__(self.pipe)

        def timed(*args, **kwargs):
            self._sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function("portbench.classify"):
                out = classify(*args, **kwargs)
                self._sync()
            run.classify = (t0, time.perf_counter())
            return out

        self.pipe.classify_buffer = timed

    def run_window(self, seconds):
        """VODs back to back, one client, until ``seconds`` have passed;
        each VOD started runs to its end."""
        runs = []
        deadline = time.perf_counter() + seconds
        while not runs or time.perf_counter() < deadline:
            runs.append(self.analyze(len(runs)))
        return runs

    def run_traced(self):
        """The traced sub-window's VODs, each in a span ``portbench.analyze``."""
        runs = []
        for v in range(self.traffic["trace_vods"]):
            with torch.profiler.record_function("portbench.analyze"):
                runs.append(self.analyze(v, traced=True))
        return runs

    # ---- after the window ----

    def release(self, runs):
        """Free the program's state on the card."""
        self._pipeline_mod.viterbi_decode = self._k3_entry
        del self.analyzer, self.pipe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_log_probs(self, mode="float32"):
        """A function ``vod -> [2, rows, A]``: the reference's float32
        log-probs of a VOD's rows under ``mode``, from each scene's crops
        embedded once."""
        c = self.config
        if self.weights is None:
            self.weights = self.family.weights(c, self.seed, self.device, self.root)
        with torch.no_grad(), ref_models.precision(mode):
            emb = self._scene_embeddings()  # [Q, 2, D]
        idx = ref_ops.middle_out_indices(self.rows, c["sequence_length"], c["frame_delta"])

        def log_probs(vod):
            scenes = self.schedule.scenes(vod, np.arange(self.rows) * self.stride)
            seq = emb[torch.as_tensor(scenes, device=self.device)]       # [rows, 2, D]
            out = []
            with torch.no_grad(), ref_models.precision(mode):
                for f in range(2):
                    for b0 in range(0, self.rows, CHECK_BLOCK):
                        w = seq[torch.as_tensor(idx[b0:b0 + CHECK_BLOCK], device=self.device), f]
                        out.append(self.family.head(w, self.weights["head"], c))
            return torch.cat(out).reshape(2, self.rows, -1).cpu().numpy()

        return log_probs

    def _scene_embeddings(self):
        c = self.config
        crops = torch.from_numpy(self.scene_crops.reshape(-1, self.scene_crops.shape[-1]))
        rgb = ref_ops.yuv420_to_rgb(crops.to(self.device), c["crop_size"])
        feats = torch.cat([self.family.embed(rgb[b0:b0 + 128], self.weights["embed"], c)
                           for b0 in range(0, rgb.shape[0], 128)])
        return feats.reshape(-1, 2, feats.shape[-1])

    def check(self, runs, mode="float32"):
        """The correctness numbers of every finished run.  With ``mode``
        "tf32" (the control), the reference in TF32 stands in the program's
        place: its log-probs, its Viterbi labels and their confidences are
        judged against the float32 reference."""
        reference = self.reference_log_probs()
        control = self.reference_log_probs("tf32") if mode == "tf32" else None
        numbers = {"lp_err": 0.0, "label_mismatch": 0, "conf_err": 0.0}
        cost = self.kwargs["switch_cost"]
        frame_row = np.arange(self.frames) // self.stride
        for run in runs:
            if not run.ok:
                continue
            ref = reference(run.vod)
            if control is None:
                lp, labels, conf = run.lp, run.labels, run.conf
            else:
                lp = control(run.vod)
                labels = ref_ops.viterbi(lp, cost)[:, frame_row].T
                conf = np.exp(_at(lp, labels, frame_row)) * np.float32(100.0)
            numbers["lp_err"] = max(numbers["lp_err"], float(np.abs(lp - ref).max()))
            k3 = ref_ops.viterbi(lp, cost)[:, frame_row].T
            numbers["label_mismatch"] += int((labels != k3).sum())
            conf_ref = 100.0 * np.exp(_at(ref.astype(np.float64), labels, frame_row))
            numbers["conf_err"] = max(numbers["conf_err"], float(np.abs(conf - conf_ref).max()))
        return numbers


def _at(lp, labels, frame_row):
    """``lp[k, frame_row[f], labels[f, k]]`` as ``[F, 2]``."""
    k = np.arange(lp.shape[0])[None, :]
    return lp[k, frame_row[:, None], labels]
