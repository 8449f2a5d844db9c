"""Device-side synthetic training batches.

The port's counterpart of ``playaid_core_tpu/train/device_synth.py``.  The
split of labour is the JAX module's:

* **Host (integers and a few floats a clip)**: :class:`DeviceSynthDataset`
  assembles clips as the host synth split does (mini-timelines of repeated
  move cycles, middle-out or consecutive windows, per-clip fill, jitter and
  difficulty draws) over sprite-bank ROW INDICES, and packs each batch's
  parameters into two arrays, ``ints [B, T+2]`` and ``floats [B, 3T+25]``.
  Every draw comes from ``numpy.random.default_rng(seed)`` with the JAX
  module's calls in its order, so a seed gives its ``ints``, ``floats``,
  labels and fighter ids bit for bit.
* **Device (all pixel work)**: :func:`synth_composite` gathers the window's
  sprite rows from a resident uint8 bank (:class:`SpriteBank`), mirrors and
  places them, and cuts each clip's stage patch (:class:`StageBank`), both
  through the crop kernel's bank entry (``ops/crop_kernel.bank_resize``,
  two launches a batch); then, in plain PyTorch on the device, the clip's
  3x3 colour matrix and bias, noise, pixel dropout, the coarse hole,
  channel keep, the alpha composite over the stage and the 3x3 box blur,
  clipped and truncated to uint8.  The pixels never exist on the host.

The noise and the dropout uniforms come from a ``torch.Generator`` on the
device, so they are not JAX's draws; :func:`synth_composite` also takes
them as arguments, which is how the tests hand it the draws JAX made.

Colour order, kept from the reference: the sprite bank holds sprites as
``cv2.imread`` returns them, BGRA, while the stage bank converts its
patches to RGB, so sprites are pasted in BGR onto RGB stages (ROADMAP
queue 3 logs it).  The ground-truth dataset and the serving path feed RGB.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from playaid_core_torch import imgproc
from playaid_core_torch.device import full_float32, resolve_device
from playaid_core_torch.imgcodec import read_crop, read_sprite
from playaid_core_torch.ops.crop_kernel import bank_resize
from playaid_core_torch.train.dataset import get_character_actions_animations_dict


# ---------------------------------------------------------------------------
# Asset banks
# ---------------------------------------------------------------------------


def _normalize_sprite(rgba, size):
    """Tight sprite -> ``[size, size, 4]``: long side scaled to ``size`` with
    OpenCV's ``INTER_AREA`` (``imgproc.resize``, bit for bit), centred."""
    h, w = rgba.shape[:2]
    if h >= w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    resized = imgproc.resize(rgba, (nw, nh), "area")
    canvas = np.zeros((size, size, 4), np.uint8)
    y0 = (size - nh) // 2
    x0 = (size - nw) // 2
    canvas[y0 : y0 + nh, x0 : x0 + nw] = resized
    return canvas


class SpriteBank:
    """All sprite frames as one uint8 tensor ``[M, S, S, 4]`` (BGRA) on the
    device, plus the host-side index: ``sequences`` is a list of dicts with
    keys ``char``/``body``/``move``/``anim``/``cam``/``rows`` (bank rows in
    cycle order), one (char, body, anim, cam) sequence of
    :func:`get_character_actions_animations_dict` each, and
    ``by_char_move_body`` maps char -> move -> body -> [sequence index]."""

    def __init__(self, clean_char_dir, characters, sprite_size=128, device=None):
        self.sprite_size = sprite_size
        anim_dict = get_character_actions_animations_dict(clean_char_dir)
        rows = []
        self.sequences = []
        self.by_char_move_body = {}
        for char in characters:
            if char not in anim_dict:
                continue
            for move, bodies in sorted(anim_dict[char].items()):
                for body, anims in sorted(bodies.items()):
                    for anim, cams in sorted(anims.items()):
                        for cam, paths in sorted(cams.items()):
                            row_ids = []
                            for p in paths:
                                img = read_sprite(p)
                                if img is None:
                                    continue
                                rows.append(_normalize_sprite(img, sprite_size))
                                row_ids.append(len(rows) - 1)
                            if not row_ids:
                                continue
                            seq_id = len(self.sequences)
                            self.sequences.append({
                                "char": char, "move": move, "body": body,
                                "anim": anim, "cam": cam, "rows": row_ids,
                            })
                            self.by_char_move_body.setdefault(
                                char, {}
                            ).setdefault(move, {}).setdefault(body, []).append(seq_id)
        if not rows:
            raise RuntimeError(f"no sprites found under {clean_char_dir!r}")
        bank = np.stack(rows)
        self.num_sprites = bank.shape[0]
        self.nbytes = bank.nbytes
        self.bank = torch.from_numpy(bank).to(resolve_device(device))

    def chars(self):
        return sorted(self.by_char_move_body.keys())

    def moves_for(self, char):
        return sorted(self.by_char_move_body[char].keys())


class StageBank:
    """Random stage patches as a uint8 tensor ``[K, P, P, 3]`` (RGB) on the
    device (the device cuts each clip's canvas out of a patch).  Textures
    are ``**/*.jpg`` (through cv2) or ``**/*.npy`` (BGR, as cv2 reads a
    jpg) under ``stages_dir``, in sorted path order; a texture no larger
    than the patch is resized to it (``INTER_LINEAR``), a larger one gives
    ``patches_per_stage`` random patches drawn from
    ``numpy.random.default_rng(seed)``."""

    def __init__(self, stages_dir, patch=192, patches_per_stage=48, seed=0, device=None):
        paths = sorted(glob.glob(os.path.join(stages_dir, "**/*.jpg"), recursive=True)
                       + glob.glob(os.path.join(stages_dir, "**/*.npy"), recursive=True))
        if not paths:
            raise RuntimeError(f"no stage textures under {stages_dir!r}")
        rng = np.random.default_rng(seed)
        out = []
        for p in paths:
            img = np.ascontiguousarray(read_crop(p)[..., ::-1])  # BGR -> RGB
            h, w = img.shape[:2]
            for _ in range(patches_per_stage):
                if h <= patch or w <= patch:
                    crop = imgproc.resize(img, (patch, patch), "linear")
                else:
                    y = int(rng.integers(0, h - patch))
                    x = int(rng.integers(0, w - patch))
                    crop = img[y : y + patch, x : x + patch]
                out.append(crop)
        bank = np.stack(out)
        self.patch = patch
        self.num_patches = bank.shape[0]
        self.nbytes = bank.nbytes
        self.bank = torch.from_numpy(bank).to(resolve_device(device))


# ---------------------------------------------------------------------------
# The device-side composite
# ---------------------------------------------------------------------------


def synth_composite(sprite_bank, stage_bank, ints, floats, out_size=128, t=7, generator=None,
                    noise=None, drop_u=None):
    """One training batch of composited clips, on the banks' device.

    ``ints [B, T+2]`` (bank rows [T], stage index, flip) and ``floats
    [B, 3T+25]`` (sprite origins y, x and sides [T each], the stage window,
    the colour matrix and bias, noise sigma / pixel dropout / blur, the
    coarse hole, channel keep), on the banks' device, as
    :meth:`DeviceSynthDataset._sample_batch_params` packs them.  ``noise``
    ``[B, 1, S, S, 3]`` standard normal and ``drop_u [B, 1, S, S, 1]``
    uniform in [0, 1) are drawn from ``generator`` when not given.
    Returns frames ``[B, T, S, S, 3]`` uint8.
    """
    dev = sprite_bank.device
    b, s = ints.shape[0], out_size
    rows, stage_idx, flip = ints[:, :t], ints[:, t], ints[:, t + 1]
    o = 0
    sp_oy, o = floats[:, o : o + t], o + t
    sp_ox, o = floats[:, o : o + t], o + t
    sp_side, o = floats[:, o : o + t], o + t
    st_origin, o = floats[:, o : o + 3], o + 3
    color_mat, o = floats[:, o : o + 9].reshape(-1, 3, 3), o + 9
    color_bias, o = floats[:, o : o + 3], o + 3
    noise_sigma, pix_drop, blur_amt = floats[:, o], floats[:, o + 1], floats[:, o + 2]
    o += 3
    coarse_rect, o = floats[:, o : o + 4], o + 4
    chan_keep = floats[:, o : o + 3]

    def per_clip(v):
        return v[:, None, None, None, None]

    # Geometric placement: a resample of a (possibly out-of-canvas) window
    # of each mirrored sprite row; outside contributes zero = transparent.
    sp_origins = torch.stack([sp_oy.reshape(-1), sp_ox.reshape(-1), sp_side.reshape(-1)], 1)
    canvas = bank_resize(sprite_bank, rows.reshape(-1), sp_origins, s,
                         flip[:, None].expand(b, t).reshape(-1))  # [B*T, S, S, 4]
    rgb = canvas[..., :3].reshape(b, t, s, s, 3)
    alpha = torch.clamp(canvas[..., 3:4].reshape(b, t, s, s, 1) / 255.0, 0.0, 1.0)

    # Per-clip photometrics as one matrix product plus a bias, the same
    # for all the clip's frames.
    with full_float32():
        rgb = torch.einsum("bthwc,bdc->bthwd", rgb, color_mat)
    rgb = rgb + color_bias[:, None, None, None, :]

    # Per-clip noise and masks, the same for all the clip's frames.
    if noise is None:
        noise = torch.randn((b, 1, s, s, 3), generator=generator, device=dev)
    rgb = rgb + noise * per_clip(noise_sigma)
    if drop_u is None:
        drop_u = torch.rand((b, 1, s, s, 1), generator=generator, device=dev)
    keep = drop_u >= per_clip(pix_drop)
    yy = torch.arange(s, dtype=torch.float32, device=dev)
    in_y = (yy[None, :] >= coarse_rect[:, 0:1]) & (
        yy[None, :] < coarse_rect[:, 0:1] + coarse_rect[:, 2:3])
    in_x = (yy[None, :] >= coarse_rect[:, 1:2]) & (
        yy[None, :] < coarse_rect[:, 1:2] + coarse_rect[:, 3:4])
    hole = in_y[:, None, :, None, None] & in_x[:, None, None, :, None]
    keep = keep & ~hole
    rgb = torch.where(keep, rgb, 0.0)
    alpha = torch.where(keep, alpha, 0.0)
    rgb = rgb * chan_keep[:, None, None, None, :]

    # Stage patch -> canvas, one crop a clip, the same for all its frames.
    stc = bank_resize(stage_bank, stage_idx, st_origin, s)  # [B, S, S, 3]
    out = rgb * alpha + stc[:, None] * (1.0 - alpha)

    # Codec-degrade approximation: a 3x3 box blur with wrap-around, mixed
    # in per clip (the same sums in the same order as the JAX function).
    def roll(dy, dx):
        return torch.roll(out, (dy, dx), (2, 3))

    blurred = (
        out
        + torch.roll(out, 1, 2) + torch.roll(out, -1, 2)
        + torch.roll(out, 1, 3) + torch.roll(out, -1, 3)
        + roll(1, 1) + roll(1, -1) + roll(-1, 1) + roll(-1, -1)
    ) / 9.0
    mix = per_clip(blur_amt)
    out = out * (1.0 - mix) + blurred * mix
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def _hue_sat_matrix(hue_rad, sat, contrast):
    """3x3 colour matrix: rotation by ``hue_rad`` about the grey axis,
    saturation scale, contrast scale (numpy, one a clip on the host)."""
    c, s = np.cos(hue_rad), np.sin(hue_rad)
    one3 = np.full((3, 3), 1.0 / 3.0)
    ident = np.eye(3)
    cross = np.array([
        [0.0, -1.0, 1.0],
        [1.0, 0.0, -1.0],
        [-1.0, 1.0, 0.0],
    ]) / np.sqrt(3.0)
    rot = one3 + c * (ident - one3) + s * cross
    gray = np.array([0.299, 0.587, 0.114])
    sat_m = sat * ident + (1.0 - sat) * np.outer(np.ones(3), gray)
    return contrast * (rot @ sat_m)


class DeviceSynthDataset:
    """The synth split with its batches made on the device.

    It has the Trainer's protocol (``num_frames_per_sample``,
    ``synth_difficulty``, the curriculum hooks, ``batches``) and
    ``device_batches``, which ``Trainer.fit`` takes when present: it yields
    (frames ``[B, T, S, S, 3]`` uint8 on the device, char ids ``[B]`` and
    labels ``[B, T]`` on the host), and the host's work a batch is the clip
    assembly.  ``device=None`` means the CUDA device, and raises without
    one; ``device="cpu"`` runs the plain versions on the CPU.
    """

    def __init__(self, anim_subset, characters, clean_char_dir, stages_dir,
                 num_samples=1024, num_frames_per_sample=7,
                 synth_sprite_fill=(0.70, 0.98), synth_center_jitter=10,
                 synth_frame_degrade=0.0, synth_window="middleout",
                 synth_window_delta=1, synth_cycle_repeats=(1, 2),
                 synth_difficulty=1, crop_size=128, seed=0,
                 stage_patch=192, identity_safe=False, device=None):
        self.animations = list(anim_subset)
        self.characters = list(characters)
        self.num_samples = num_samples
        self.num_frames_per_sample = num_frames_per_sample
        self.num_frames_per_sample_options = [num_frames_per_sample]
        self.synth_sprite_fill = synth_sprite_fill
        self.synth_center_jitter = synth_center_jitter
        self.synth_frame_degrade = synth_frame_degrade
        self.synth_window = synth_window
        self.synth_window_delta = synth_window_delta
        self.synth_cycle_repeats = synth_cycle_repeats
        self.synth_difficulty = synth_difficulty
        self.crop_size = crop_size
        self.identity_safe = identity_safe
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.sprites = SpriteBank(clean_char_dir, self.characters, sprite_size=crop_size,
                                  device=self.device)
        self.stages = StageBank(stages_dir, patch=stage_patch, seed=seed, device=self.device)
        self._avail_chars = [c for c in self.characters
                             if c in self.sprites.by_char_move_body]
        if not self._avail_chars:
            raise RuntimeError("no sprite assets for requested characters")

    # ---- curriculum hooks (Trainer protocol) ----

    def make_synth_more_challenging(self):
        if self.synth_difficulty < 2:
            self.synth_difficulty += 1

    def switch_num_frames_per_sample(self):
        pass  # one T: the CNN's and the ResFormer's heads are sized to it

    def __len__(self):
        return self.num_samples

    # ---- clip assembly (host, integers only) ----

    def _label_id(self, action):
        if action in self.animations:
            return self.animations.index(action)
        return self.animations.index("Unknown")

    def _sample_clip_rows(self):
        """One clip's (window bank rows [T], labels [T], char): the synth
        split's mini-timeline over row indices."""
        rng = self.rng
        char = rng.choice(self._avail_chars)
        char_moves = self.sprites.by_char_move_body[char]
        body_types = sorted({b for m in char_moves.values() for b in m})
        body = rng.choice(body_types)

        t = self.num_frames_per_sample
        mid = t // 2
        max_off = self.synth_window_delta * mid * mid
        min_len = (2 * max_off + 1) if self.synth_window == "middleout" else t

        mini_rows, mini_labels = [], []
        i = 0
        while i < 2 or len(mini_rows) < min_len:
            action = None
            while not action:
                selected = rng.choice(self.animations)
                if selected == "Unknown":
                    extra = sorted(set(char_moves) - set(self.animations))
                    if extra:
                        action = rng.choice(extra)
                elif selected in char_moves:
                    action = selected
            node = char_moves[action]
            if body not in node:
                body = rng.choice(sorted(node.keys()))
            seq_ids = node[body]
            seq = self.sprites.sequences[seq_ids[int(rng.integers(0, len(seq_ids)))]]
            rows = seq["rows"]
            lo, hi = self.synth_cycle_repeats
            repeats = (int(rng.integers(lo, hi + 1))
                       if self.synth_window == "middleout" and hi > lo else 1)
            label = action if action in self.animations else "Unknown"
            for _ in range(repeats):
                mini_rows.extend(rows)
                mini_labels.extend([label] * len(rows))
            i += 1

        n = len(mini_rows)
        if self.synth_window == "middleout":
            center = int(rng.integers(max_off, n - max_off))
            offs = [self.synth_window_delta * (mid - j) ** 2 for j in range(t)]
            idx = [center - offs[j] if j <= mid else center + offs[j] for j in range(t)]
        else:
            last = int(rng.integers(t, n + 1))
            idx = list(range(last - t, last))
        clip_rows = [mini_rows[j] for j in idx]
        clip_labels = [self._label_id(mini_labels[j]) for j in idx]
        return clip_rows, clip_labels, char

    def _sample_batch_params(self, batch_size):
        """A batch's host sampling: bank rows and augmentation parameters,
        packed as ``ints`` and ``floats``, with ``labels`` and ``chars``."""
        rng = self.rng
        b, t, s = batch_size, self.num_frames_per_sample, self.crop_size
        d = self.synth_difficulty

        rows = np.zeros((b, t), np.int32)
        labels = np.zeros((b, t), np.int32)
        chars = np.zeros((b,), np.int32)
        for i in range(b):
            r, lab, char = self._sample_clip_rows()
            rows[i] = r
            labels[i] = lab
            chars[i] = self.characters.index(char)

        fill_lo, fill_hi = self.synth_sprite_fill
        fill = rng.uniform(fill_lo, fill_hi, b)
        # difficulty "shrink-in-canvas" (p=0.4, x0.75-1.0) folds into fill
        if d:
            shrink = np.where(rng.random(b) < 0.4, rng.uniform(0.75, 1.0, b), 1.0)
            fill = fill * shrink
        # random_sized_crop zoom fold (p = 0.1 at d1 / 0.3 at d2)
        if d:
            rp = 0.1 if d < 2 else 0.3
            zoom = np.where(rng.random(b) < rp, 1.0 / rng.uniform(0.55, 1.0, b), 1.0)
            fill = np.clip(fill * zoom, 0.05, 3.0)
        # per-frame fill jitter (host: +/-0.04 around the clip base)
        if fill_hi > fill_lo:
            fill_t = np.clip(fill[:, None] + rng.uniform(-0.04, 0.04, (b, t)), 0.03, 3.5)
        else:
            fill_t = np.repeat(fill[:, None], t, axis=1)

        jit_lim = self.synth_center_jitter if self.synth_center_jitter else (40 if d else 0)
        base_jit = (rng.integers(-jit_lim, jit_lim + 1, (b, 2)) if jit_lim else np.zeros((b, 2)))
        drift = rng.integers(-3, 4, (b, t, 2))
        jy = base_jit[:, None, 0] + drift[..., 0]
        jx = base_jit[:, None, 1] + drift[..., 1]

        # output pixel -> sprite canvas: src = (p - c(1-sigma) - j) / sigma,
        # as the resampler's origin/side form src = o + (p + 0.5) * side / S
        # - 0.5.
        sigma = fill_t
        side = s / sigma
        sp_oy = (s / 2.0) - (s / 2.0 + jy) / sigma - 0.5 / sigma + 0.5
        sp_ox = (s / 2.0) - (s / 2.0 + jx) / sigma - 0.5 / sigma + 0.5

        flip = np.zeros(b, bool)  # facing is carried by the cam sequences

        stage_idx = rng.integers(0, self.stages.num_patches, b).astype(np.int32)
        margin = self.stages.patch - s
        st_oy = rng.uniform(0, max(margin, 1), b)
        st_ox = rng.uniform(0, max(margin, 1), b)
        st_side = np.full(b, float(s))

        # photometrics (difficulty-gated, the host pipeline's probabilities;
        # one draw a clip)
        contrast = np.ones(b)
        bias = np.zeros((b, 3))
        hue = np.zeros(b)
        sat = np.ones(b)
        if d:
            bc = rng.random(b) < 0.3
            contrast = np.where(bc, 1.0 + rng.uniform(-0.2, 0.2, b), 1.0)
            blim = 0.3 if self.identity_safe else 0.6
            bright = np.where(bc, rng.uniform(-0.2, blim, b), 0.0)
            bias = np.repeat((bright * 255.0)[:, None], 3, axis=1)
            if self.identity_safe:
                hue = rng.uniform(-0.3, 0.3, b)
                sat = 1.0 + rng.uniform(-0.12, 0.12, b)
            else:
                hue = rng.uniform(-np.pi, np.pi, b)
                sat = 1.0 + rng.uniform(-0.26, 0.26, b)
        color_mat = np.stack(
            [_hue_sat_matrix(hue[i], sat[i], contrast[i]) for i in range(b)]
        ).astype(np.float32)

        noise_sigma = np.zeros(b)
        if d:
            noise_sigma = np.where(rng.random(b) < 0.2, np.sqrt(rng.uniform(427.63, 500.0, b)),
                                   0.0)
        pix_drop = np.zeros(b)
        coarse = np.zeros((b, 4))
        chan_keep = np.ones((b, 3))
        if d >= 2:
            pix_drop = np.where(rng.random(b) < 0.2, 0.1, 0.0)
            cd = rng.random(b) < 0.2
            hgt = rng.integers(8, 96, b)
            wdt = rng.integers(8, 96, b)
            coarse = np.stack([
                rng.integers(0, s - 8, b), rng.integers(0, s - 8, b),
                np.where(cd, hgt, 0), np.where(cd, wdt, 0),
            ], axis=1).astype(np.float32)
            if not self.identity_safe:
                ch = rng.random(b) < 0.2
                which = rng.integers(0, 3, b)
                chan_keep = np.ones((b, 3))
                chan_keep[np.arange(b)[ch], which[ch]] = 0.0

        blur_amt = np.zeros(b)
        if d:
            dsp = 0.1 if d < 2 else 0.3
            blur_amt = np.where(rng.random(b) < dsp, rng.uniform(0.5, 1.0, b), 0.0)
        if self.synth_frame_degrade:
            deg = rng.random(b) < self.synth_frame_degrade
            blur_amt = np.maximum(blur_amt, np.where(deg, rng.uniform(0.3, 0.9, b), 0.0))

        # The two arrays synth_composite unpacks: two copies a batch.
        ints = np.concatenate(
            [rows, stage_idx[:, None], flip.astype(np.int32)[:, None]], axis=1,
        ).astype(np.int32)
        floats = np.concatenate([
            sp_oy, sp_ox, side,
            np.stack([st_oy, st_ox, st_side], axis=1),
            color_mat.reshape(b, 9), bias,
            np.stack([noise_sigma, pix_drop, blur_amt], axis=1),
            coarse, chan_keep,
        ], axis=1).astype(np.float32)
        return dict(ints=ints, floats=floats, labels=labels, chars=chars)

    # ---- batch iterators ----

    def device_batches(self, batch_size, num_batches=None):
        """Yield (frames on the device, char ids, labels): a batch copies its
        packed ``ints`` and ``floats`` to the device and nothing else."""
        total = num_batches if num_batches is not None else max(self.num_samples // batch_size, 1)
        for _ in range(total):
            p = self._sample_batch_params(batch_size)
            ints = torch.from_numpy(p["ints"]).to(self.device, non_blocking=True)
            floats = torch.from_numpy(p["floats"]).to(self.device, non_blocking=True)
            frames = synth_composite(self.sprites.bank, self.stages.bank, ints, floats,
                                     out_size=self.crop_size, t=self.num_frames_per_sample,
                                     generator=self.generator)
            yield frames, p["chars"], p["labels"]

    def batches(self, batch_size, num_batches=None):
        """The Trainer protocol's host arrays: the device frames copied back
        (for inspection, not the training path)."""
        for frames, chars, labels in self.device_batches(batch_size, num_batches):
            yield frames.cpu().numpy(), chars, labels
