"""Batched two-fighter action-recognition pipeline: the CNN, ResFormer and
RNN families, and the Granite 4.0-H hybrid family.

Counterpart of ``playaid_core_tpu/infer/pipeline.py``.  Every crop goes
through the family's frame encoder once; middle-out windows are then
gathered over the embedding sequence and classified by the temporal head:

1. ``preprocess_frames``: frames + boxes -> crops (CUDA kernel
   ``csrc/crop_resize.cu`` on the card);
2. ``embed_crops`` / ``embed_crops_u8`` / ``embed_crops_yuv`` (the YUV420
   unpack is the CUDA kernel ``csrc/yuv420_unpack.cu`` on the card) /
   ``embed_windows`` (windows cut out on the host, resized by the same
   crop kernel's window entry on the card): crops ->
   per-frame embeddings: ResNet-18 -> 1000 (CNN), ResNet-50 -> 2048 -> 247
   (ResFormer), ResNet-18 -> 512 -> 300 (RNN), ResNet-18 -> 512 (Granite).
   ResNet-18's identity blocks are the CUDA kernel ``csrc/residual_block.cu`` on the card, and
   ``embed_crops_yuv`` replays the unpack and the embed as one CUDA graph
   for each chunk shape there (``infer/graph_cache.py``);
3. ``make_embedding_buffer`` + ``scatter_embeddings``: embeddings
   accumulate, interleaved by fighter, in one ``[F_pad * 2, D]`` buffer;
4. ``classify_buffer`` / ``classify_sequence``: windows -> temporal head
   (dense head; transformer; LSTM) -> log-probs -> argmax or Viterbi
   (the CUDA kernel ``csrc/viterbi.cu`` on the card, both fighters in one
   launch) labels and confidences.  The transformer and LSTM heads give a
   prediction per step; the window's centre step labels its frame.  The
   Granite head (``models/granite_hybrid.py``) reads no windows: it runs
   once over each fighter's rows in frame order, causally, over the true
   rows rounded up to its SSD chunk, and labels every row.

Weights live in the pipeline's modules: load them with
:meth:`BatchedActionPipeline.load_variables` (a JAX-layout numpy tree or
the port's state dicts, see ``convert.py``) or
:meth:`BatchedActionPipeline.load_checkpoint` (a reference Lightning
``.ckpt`` or a file of :meth:`BatchedActionPipeline.save_checkpoint`), or
draw seeded random ones with :meth:`BatchedActionPipeline.init`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from playaid_core_torch import profiling
from playaid_core_torch.convert import split_monolithic, to_state_dicts
from playaid_core_torch.device import full_float32, resolve_device
from playaid_core_torch.infer.graph_cache import GraphCache
from playaid_core_torch.models.granite_hybrid import GraniteHybridHead, padded_length
from playaid_core_torch.models.resnet import ResNet18, ResNet50, at_least_float32
from playaid_core_torch.models.resnet_transformer import TransformerEncoderLayer, time_encoding
from playaid_core_torch.models.rnn_action_detector import StackedLSTM
from playaid_core_torch.models.lightning_ckpt import (
    convert_state_dict,
    extract_state_dict,
    load_lightning_checkpoint,
)
from playaid_core_torch.ops.crop_kernel import square_crop_resize, window_resize
from playaid_core_torch.ops.preprocess import middle_out_frame_indices
from playaid_core_torch.ops.viterbi import viterbi_decode
from playaid_core_torch.ops.yuv import yuv420_to_rgb
from playaid_core_torch.parallel.mesh import parallel_linear

FAMILIES = ("cnn", "resformer", "rnn")  # heads over middle-out windows
SEQUENCE_FAMILIES = ("granite_hybrid",)  # heads over each fighter's whole sequence


class CNNEmbed(ResNet18):
    """ResNet-18 trunk of the CNN family: NHWC crops ``[N, S, S, 3]`` in
    [0, 1] -> ``[N, 1000]`` per-frame features, in full float32 whatever
    the caller's TF32 flags."""

    def forward(self, crops):
        with full_float32():
            return super().forward(crops.permute(0, 3, 1, 2))


class CNNTemporalHead(nn.Module):
    """Dense head over a window of embeddings ``[B, T, D]`` -> log-probs
    ``[B, A]`` (float32), in full float32 whatever the caller's TF32
    flags.  The window flattens t-major, ``[B, T * D]``.

    On a mesh (``parallel.mesh.attach_mesh``) that splits ``model``,
    ``temporal_dense`` (and ``classifier`` when the actions divide) hold
    rows of their weights; their outputs are gathered over ``model``
    before the whole-width layer that follows."""

    mesh = None

    def __init__(self, num_actions, sequence_length, resnet_features=1000):
        super().__init__()
        self.temporal_dense = nn.Linear(sequence_length * resnet_features, 512)
        self.mlp_hidden = nn.Linear(512, 128)
        self.classifier = nn.Linear(128, num_actions)

    def logits(self, window_feats):
        y = window_feats.reshape(window_feats.shape[0], -1)
        with full_float32():
            y = torch.relu(parallel_linear(self.temporal_dense, y, self.mesh, gather=True))
            y = torch.relu(self.mlp_hidden(y))
            return at_least_float32(parallel_linear(self.classifier, y, self.mesh, gather=True))

    def forward(self, window_feats):
        return torch.log_softmax(self.logits(window_feats), dim=1)


class ResFormerEmbed(nn.Module):
    """ResNet-50 trunk (pooled 2048-d features) + ``resnet_ffn``
    projection to 247: ``[N, S, S, 3]`` -> ``[N, 247]``."""

    def __init__(self, hidden_dim=247):
        super().__init__()
        self.resnet = ResNet50(num_classes=0)
        self.resnet_ffn = nn.Linear(2048, hidden_dim)

    def forward(self, crops):
        with full_float32():
            return self.resnet_ffn(self.resnet(crops.permute(0, 3, 1, 2)))


class ResFormerTemporalHead(nn.Module):
    """Time-encoding concat (9-d) + post-LN transformer (d_model 256, 8
    heads) + per-step classifier: ``[B, T, 247]`` -> log-probs ``[B, T, A]``.
    On a mesh that splits ``model``, the classifier holds rows of its
    weight when the actions divide, and its output is gathered."""

    mesh = None

    def __init__(self, num_actions, sequence_length=7, hidden_dim=247, num_heads=8,
                 num_layers=3, num_freq=4):
        super().__init__()
        # float64 in numpy, then float32, in the JAX package's order.
        freq = time_encoding(np.linspace(0, 1, sequence_length).reshape(-1, 1),
                             num_freq).astype(np.float32)
        self.register_buffer("time_features", torch.from_numpy(freq), persistent=False)
        d_model = hidden_dim + freq.shape[1]
        self.layers = nn.ModuleList(TransformerEncoderLayer(d_model, num_heads)
                                    for _ in range(num_layers))
        self.classifier = nn.Linear(d_model, num_actions)

    def logits(self, window_feats):
        b = window_feats.shape[0]
        freq = self.time_features.to(window_feats.dtype).expand(b, -1, -1)
        with full_float32():
            y = torch.cat([window_feats, freq], dim=2)
            for layer in self.layers:
                y = layer(y)
            return at_least_float32(parallel_linear(self.classifier, y, self.mesh, gather=True))

    def forward(self, window_feats):
        return torch.log_softmax(self.logits(window_feats), dim=2)


class RNNEmbed(nn.Module):
    """ResNet-18 trunk (pooled 512-d features) + ``encoder_proj`` to 300:
    ``[N, S, S, 3]`` -> ``[N, 300]``."""

    def __init__(self, encoder_features=300):
        super().__init__()
        self.resnet = ResNet18(num_classes=0)
        self.encoder_proj = nn.Linear(512, encoder_features)

    def forward(self, crops):
        with full_float32():
            return self.encoder_proj(self.resnet(crops.permute(0, 3, 1, 2)))


class RNNTemporalHead(nn.Module):
    """3-layer LSTM (hidden 512) + MLP decoder (128, then A) over a window:
    ``[B, T, 300]`` -> per-step log-probs ``[B, T, A]``."""

    def __init__(self, num_actions, input_size=300, hidden_size=512, num_layers=3):
        super().__init__()
        self.lstm = StackedLSTM(input_size, hidden_size, num_layers)
        self.decoder_hidden = nn.Linear(hidden_size, 128)
        self.decoder_out = nn.Linear(128, num_actions)

    def forward(self, window_feats):
        with full_float32():
            y = torch.relu(self.decoder_hidden(self.lstm(window_feats)))
            return torch.log_softmax(at_least_float32(self.decoder_out(y)), dim=2)


class SequenceEmbed(nn.Module):
    """ResNet-18's pooled features: ``[N, S, S, 3]`` -> ``[N, 512]``, the
    Granite head's input."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet18(num_classes=0)

    def forward(self, crops):
        with full_float32():
            return self.resnet(crops.permute(0, 3, 1, 2))


class BatchedActionPipeline:
    """Fused preprocess -> embed-once -> window-gather -> classify.

    ``device=None`` means the CUDA device, and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU.  The
    ``granite_hybrid`` family's head (``models/granite_hybrid.PUBLISHED``)
    is made on the pipeline's device.
    """

    # Embedding buffers round up to powers of two below this many frames
    # and to multiples of it above, as in the JAX package.
    BUFFER_BUCKET_FRAMES = 4096

    def __init__(self, family="cnn", num_actions=63, sequence_length=7, frame_delta=3,
                 crop_size=128, device=None):
        if family not in FAMILIES + SEQUENCE_FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES + SEQUENCE_FAMILIES}, "
                             f"got {family!r}")
        self.family = family
        self.num_actions = num_actions
        self.sequence_length = sequence_length
        self.frame_delta = frame_delta
        self.crop_size = crop_size
        self.device = resolve_device(device)
        if family == "cnn":
            embed = CNNEmbed()
            head = CNNTemporalHead(num_actions, sequence_length)
        elif family == "resformer":
            embed = ResFormerEmbed()
            head = ResFormerTemporalHead(num_actions, sequence_length)
        elif family == "granite_hybrid":
            embed = SequenceEmbed()
            with torch.device(self.device):  # 3 billion parameters: made in place
                head = GraniteHybridHead(num_actions)
        else:
            embed = RNNEmbed()
            head = RNNTemporalHead(num_actions)
        self.embed = embed.to(self.device).eval()
        self.head = head.to(self.device).eval()
        self._graphs = GraphCache()  # embed_crops_yuv's CUDA graphs
        # False until weights are loaded or drawn: the modules' own
        # initialisation is not seeded.
        self.initialized = False

    @property
    def embed_dim(self):
        return {"cnn": 1000, "resformer": 247, "rnn": 300, "granite_hybrid": 512}[self.family]

    def load_state_dicts(self, state):
        """Load ``{"embed": ..., "head": ...}`` state dicts (strictly)."""
        self.embed.load_state_dict(state["embed"])
        self.head.load_state_dict(state["head"])
        self.initialized = True
        return self

    def load_variables(self, variables):
        """Load weights given as the JAX package's ``{embed, head}`` numpy
        tree (as ``convert.load_npz_tree`` reads one) or as the port's
        state dicts, into the modules on this pipeline's device.  Nothing
        of ``variables`` is kept."""
        return self.load_state_dicts(to_state_dicts(self.family, variables))

    def save_checkpoint(self, path):
        """Save the modules' weights as ``{"embed": ..., "head": ...}``
        state dicts (CPU tensors) with ``torch.save``: the port's
        checkpoint file, read back by :meth:`load_checkpoint`."""
        cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
        torch.save({"embed": cpu(self.embed.state_dict()),
                    "head": cpu(self.head.state_dict())}, path)

    def load_checkpoint(self, path):
        """Load weights from ``path`` into this pipeline's modules.

        ``path`` is a reference Lightning ``.ckpt`` container (its state
        dict goes through the same name maps as the JAX package's,
        ``models/torch_convert.py``, then :meth:`from_monolithic`, then
        ``convert.py``) or a file of :meth:`save_checkpoint`.  Either is
        read with ``torch.load(weights_only=True)`` first and a restricted
        unpickler second (``models/lightning_ckpt.py``).  An orbax
        directory (the JAX Trainer's) raises: the port does not read
        orbax.
        """
        if os.path.isdir(path):
            raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX "
                             "Trainer?); the port reads reference .ckpt files and its own "
                             "state-dict files, not orbax")
        container = load_lightning_checkpoint(path)
        if isinstance(container, dict) and set(container) == {"embed", "head"}:
            return self.load_state_dicts(container)
        monolithic = convert_state_dict(extract_state_dict(container), self.family,
                                        self.sequence_length)
        return self.load_variables(self.from_monolithic(monolithic))

    @torch.no_grad()
    def init(self, seed=0):
        """Seeded random weights, drawn on the CPU from one
        ``torch.Generator`` in parameter order, so every device gets the
        same ones: weights ~ N(0, 1/fan_in), biases 0, norm scales 1,
        running mean 0 and variance 1."""
        gen = torch.Generator().manual_seed(seed)
        for module in (self.embed, self.head):
            for name, p in module.named_parameters():
                if "bias" in name.rsplit(".", 1)[-1]:  # bias, in_proj_bias, bias_ih_l0, ...
                    value = torch.zeros(p.shape)
                elif p.dim() == 1:  # batch-norm and layer-norm scales
                    value = torch.ones(p.shape)
                else:
                    fan_in = p[0].numel()
                    value = torch.randn(p.shape, generator=gen) / fan_in ** 0.5
                p.copy_(value)
            for name, buf in module.named_buffers():
                if name.endswith("running_mean"):
                    buf.zero_()
                elif name.endswith("running_var"):
                    buf.fill_(1.0)
        self.initialized = True
        return self

    def from_monolithic(self, variables):
        """Split a trained monolithic model's numpy tree (``{"params": ...,
        "batch_stats": ...}`` of the JAX package's models) into this
        family's ``{embed, head}`` trees, as the JAX package does."""
        return split_monolithic(self.family, variables)

    # ---- embedding ----

    @torch.inference_mode()
    def embed_crops(self, crops):
        """crops ``[N, S, S, 3]`` float in [0, 1] -> ``[N, embed_dim]``."""
        return self.embed(crops)

    @torch.inference_mode()
    def embed_crops_u8(self, crops_u8):
        """BGR uint8 crops ``[N, S, S, 3]`` -> RGB / 255 -> embeddings."""
        return self.embed(crops_u8.flip(-1).float() / 255.0)

    @torch.inference_mode()
    def embed_crops_yuv(self, crops_yuv):
        """Packed planar YUV420 uint8 crops ``[N, S*S*3//2]`` (Y, then U,
        then V) -> BT.601 limited-range RGB / 255 (the CUDA kernel
        ``csrc/yuv420_unpack.cu`` on the card, channels first underneath)
        -> embeddings.  Chroma is upsampled 2x by nearest neighbour.  On
        the card the unpack and the embed run as one CUDA graph for each
        input shape from that shape's third call on
        (``infer/graph_cache.py``); the same kernels, the same bits."""
        return self._graphs(self.embed, self._embed_yuv, crops_yuv)

    def _embed_yuv(self, crops_yuv):
        return self.embed(yuv420_to_rgb(crops_yuv, self.crop_size))

    @torch.inference_mode()
    def embed_windows(self, wins_u8, origins):
        """BGR uint8 windows ``[M, W, W, 3]`` + window-relative origins
        ``[M, 3]`` (y0, x0, side) -> RGB crops resized to ``crop_size``
        and /255 (the crop kernel's window entry on the card, its plain
        version on the CPU) -> embeddings ``[M, embed_dim]``."""
        return self.embed(window_resize(wins_u8, origins, out_size=self.crop_size,
                                        bgr_to_rgb=True))

    @torch.inference_mode()
    def preprocess_frames(self, frames_u8, boxes, padding=30):
        """BGR frames ``[B, H, W, 3]`` uint8 + boxes ``[B, 4]`` or
        ``[B, K, 4]`` -> RGB crops ``boxes.shape[:-1] + (S, S, 3)`` float32.
        The CUDA kernel on the card, its plain version on the CPU."""
        return square_crop_resize(frames_u8, boxes, out_size=self.crop_size,
                                  padding=padding, bgr_to_rgb=True)

    # ---- embedding buffer ----

    def make_embedding_buffer(self, num_frames):
        """Zeroed interleaved ``[F_pad * 2, D]`` float32 buffer; F_pad is
        the next power of two up to BUFFER_BUCKET_FRAMES and a multiple
        of it above."""
        cap = self.BUFFER_BUCKET_FRAMES
        if num_frames <= cap:
            f_pad = 1
            while f_pad < num_frames:
                f_pad *= 2
        else:
            f_pad = cap * ((num_frames + cap - 1) // cap)
        return torch.zeros((f_pad * 2, self.embed_dim), dtype=torch.float32,
                           device=self.device)

    @staticmethod
    def scatter_embeddings(buf, emb_chunk, row_offset):
        """Write one chunk's ``[rows, D]`` embeddings at ``row_offset``.

        Writes into ``buf`` in place and returns it (the JAX version
        donated the buffer to get the same effect).  A chunk that does
        not fit raises, where the JAX version clamped the offset.
        """
        rows = emb_chunk.shape[0]
        if row_offset < 0 or row_offset + rows > buf.shape[0]:
            raise IndexError(f"rows [{row_offset}, {row_offset + rows}) outside a "
                             f"buffer of {buf.shape[0]}")
        buf[row_offset:row_offset + rows] = emb_chunk
        return buf

    # ---- classification ----

    @staticmethod
    def _smooth_log_probs(log_probs, true_len, radius):
        """Mean log-probs over frames ``[i - radius, i + radius]``, clamped
        to the true sequence."""
        f = log_probs.shape[0]
        i = torch.arange(f, device=log_probs.device)
        lp = torch.where((i < true_len)[:, None], log_probs, 0.0)
        csum = torch.cat([lp.new_zeros((1, lp.shape[1])), torch.cumsum(lp, dim=0)])
        lo = torch.clamp(i - radius, min=0)
        hi = torch.clamp(i + radius, max=max(true_len - 1, 0))
        summed = csum[hi + 1] - csum[lo]
        count = torch.clamp(hi + 1 - lo, min=1).to(lp.dtype)
        return summed / count[:, None]

    @staticmethod
    def _viterbi_decode(log_probs, true_len, switch_cost):
        """MAP label path ``[F]`` of one sequence's log-probs ``[F, A]``
        under a uniform switching penalty of ``switch_cost`` nats (a Potts
        prior): :func:`~playaid_core_torch.ops.viterbi.viterbi_decode` on a
        batch of one (the CUDA kernel ``csrc/viterbi.cu`` on the card)."""
        return viterbi_decode(log_probs[None], true_len, switch_cost)[0]

    def _head_apply(self, windows):
        """Windows ``[B, T, D]`` -> log-probs ``[B, A]``; the per-step heads
        give their centre step's prediction, as the JAX package does.  The
        head's call is the span ``playaid.head``, counting ``windows``."""
        with profiling.span("playaid.head", windows=windows.shape[0]):
            out = self.head(windows)
        if self.family != "cnn":
            out = out[:, self.sequence_length // 2, :]
        return out

    def _window_log_probs(self, seq, true_len, min_frame):
        """Middle-out windows over ``seq`` ``[F, ..., D]`` -> head log-probs
        ``[F, ..., A]``.  Windows are clamped to ``true_len`` so padding
        rows never feed real frames."""
        f = seq.shape[0]
        idx = middle_out_frame_indices(
            torch.arange(f, device=seq.device), self.sequence_length, self.frame_delta,
            max(int(true_len), 1), min_frame=min_frame,
        )  # [F, T]
        windows = seq[idx]  # [F, T, ..., D]
        windows = windows.movedim(1, -2)  # [F, ..., T, D]
        lead = windows.shape[:-2]
        windows = windows.reshape(-1, self.sequence_length, windows.shape[-1])
        return self._head_apply(windows).reshape(lead + (-1,))

    def _decode(self, log_probs, true_len, smooth_radius, decode, switch_cost):
        """Log-probs ``[B, F, A]`` of B sequences of one true length ->
        (labels ``[B, F]``, confidence ``[B, F]``).  Viterbi decodes every
        sequence in one kernel launch on the card."""
        if smooth_radius:
            log_probs = torch.stack([self._smooth_log_probs(lp, true_len, smooth_radius)
                                     for lp in log_probs])
        if decode == "viterbi":
            with profiling.span("playaid.viterbi"):
                labels = viterbi_decode(log_probs, true_len, switch_cost)
            conf = torch.exp(torch.gather(log_probs, 2, labels[..., None]))[..., 0] * 100.0
        elif decode == "argmax":
            labels = torch.argmax(log_probs, dim=-1)
            conf = torch.exp(torch.max(log_probs, dim=-1).values) * 100.0
        else:
            raise ValueError(f"decode must be 'argmax' or 'viterbi', got {decode!r}")
        return labels, conf

    def _sequence_log_probs(self, seqs, true_len, min_frame):
        """Sequences ``[B, F, D]`` -> the sequence head's log-probs ``[B, L,
        A]`` of their first L rows, L ``true_len`` rounded up to the head's
        SSD chunk (zero rows appended where F is shorter).  The head is
        causal, so rows at or past ``true_len`` change no earlier row.  Its
        call is the span ``playaid.head``, counting ``positions`` (B x L, the
        rows it ran) and ``windows`` (the same: each position is the causal
        window of its prefix); the head adds ``ssd_layers``."""
        if min_frame:
            raise ValueError(f"the {self.family} head reads each sequence from its first row; "
                             f"min_frame must be 0, got {min_frame}")
        length = padded_length(int(true_len), self.head.chunk)
        seqs = seqs[:, :length]
        if seqs.shape[1] < length:
            seqs = torch.nn.functional.pad(seqs, (0, 0, 0, length - seqs.shape[1]))
        n = seqs.shape[0] * length
        with profiling.span("playaid.head", windows=n, positions=n):
            return self.head(seqs.contiguous())

    def _two_fighter_tail(self, per_fighter, true_len, min_frame, smooth_radius=0,
                          decode="argmax", switch_cost=4.0):
        """Interleaved ``[F, 2, D]`` embeddings -> (labels ``[F, 2]``,
        confidence ``[F, 2]``); both fighters decode together.  A sequence
        family labels ``[L, 2]``, L the rows its head ran."""
        if self.family in SEQUENCE_FAMILIES:
            log_probs = self._sequence_log_probs(per_fighter.transpose(0, 1), true_len,
                                                 min_frame)  # [2, L, A]
        else:
            log_probs = self._window_log_probs(per_fighter, true_len,
                                               min_frame).transpose(0, 1)  # [2, F, A]
        labels, conf = self._decode(log_probs, true_len, smooth_radius, decode, switch_cost)
        return labels.t(), conf.t()

    @torch.inference_mode()
    def classify_buffer(self, buf, true_len, min_frame=0, smooth_radius=0,
                        decode="argmax", switch_cost=4.0):
        """Embedding buffer ``[F_pad * 2, D]`` -> (labels ``[true_len, 2]``,
        confidence ``[true_len, 2]``, in percent), in the span
        ``playaid.classify`` counting ``rows``; the head's call is its child
        ``playaid.head``, counting the ``windows`` of the padded buffer (a
        sequence family's: :meth:`_sequence_log_probs`)."""
        with profiling.span("playaid.classify", rows=true_len):
            per_fighter = buf.reshape(buf.shape[0] // 2, 2, -1).float()
            labels, conf = self._two_fighter_tail(per_fighter, true_len, min_frame,
                                                  smooth_radius, decode, switch_cost)
            return labels[:true_len], conf[:true_len]

    @torch.inference_mode()
    def classify_chunked(self, emb_chunks, n_last, min_frame=0):
        """Embedding chunks ``[2 * C, D]`` (two fighters interleaved a
        frame), the last holding ``n_last`` frames -> (labels ``[F, 2]``,
        confidence ``[F, 2]``): the chunk-list form of
        :meth:`classify_buffer`, as the JAX pipeline keeps it for small batch
        counts (its ``variables`` live in this pipeline's modules)."""
        parts = list(emb_chunks[:-1]) + [emb_chunks[-1][: n_last * 2]]
        emb_all = torch.cat(parts, dim=0)
        f = emb_all.shape[0] // 2
        return self._two_fighter_tail(emb_all.reshape(f, 2, -1).float(), f, min_frame)

    @torch.inference_mode()
    def classify_sequence(self, embeddings, min_frame=0, smooth_radius=0,
                          decode="argmax", switch_cost=4.0, return_raw=False):
        """One fighter's embeddings ``[F, D]`` -> (labels ``[F]``,
        confidence ``[F]``) from middle-out windows.

        ``smooth_radius`` > 0 pools log-probs over ``[i - r, i + r]``
        first; ``decode="viterbi"`` decodes the MAP path under a
        ``switch_cost``-nat switching penalty.  ``return_raw=True`` also
        returns the per-window argmax labels from the same head pass.
        (The JAX version padded to a bucket to share compiled programs;
        eager PyTorch needs no padding.)
        """
        f = embeddings.shape[0]
        if self.family in SEQUENCE_FAMILIES:
            log_probs = self._sequence_log_probs(embeddings.float()[None], f, min_frame)[0, :f]
        else:
            log_probs = self._window_log_probs(embeddings.float(), f, min_frame)
        labels, conf = (a[0] for a in self._decode(log_probs[None], f, smooth_radius, decode,
                                                    switch_cost))
        if return_raw:
            return labels, conf, torch.argmax(log_probs, dim=-1)
        return labels, conf
