"""Learned HUD digit reader: a small conv classifier over segmented
components, and its training on synthetic HUD renders.

Counterpart of ``playaid_core_tpu/infer/ocr_conv.py``.  At inference the
digit net (three 3x3 stride-2 convs with Flax's SAME padding, 0 before and
1 after at these even sizes, then two dense layers on the NHWC-flattened
map) runs on the card; segmentation and the letterboxed 48-px patches
(``INTER_AREA``, through ``imgproc.resize``) are made on the host.  The
weights are the port's own copy of the committed ``ocr_digits.npz``
(``assets/``), loaded into the module on its device once.

Training renders styled digits in the font pools of matplotlib's fonts
with PIL and cv2 (:func:`synth_batch`) on the host, and takes the steps on
the card (:func:`train_step`: cross-entropy, fused Adam under optax's
cosine decay to 5%).  PIL, cv2 and matplotlib are imported inside the
functions that render: the module imports on a machine without them (the
card's), and rendering there raises an ``ImportError`` that names the
package.  Regenerate the port's weights with ``python -m
playaid_core_torch.infer.ocr_conv`` (``OCR_STEPS``, default 1200).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playaid_core_torch import imgproc
from playaid_core_torch.convert import _flatten, from_jax_digits, to_jax_digits
from playaid_core_torch.device import full_float32, resolve_device
from playaid_core_torch.infer.ocr import assemble_reading, segment_digit_components
from playaid_core_torch.models.resnet import init_flax_
from playaid_core_torch.train.schedules import cosine_decay_schedule

PATCH = 48
WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "ocr_digits.npz")


def patch_from_component(comp, size=PATCH):
    """Letterbox a component's grayscale patch to ``[size, size]`` float
    in [0, 1], aspect kept."""
    patch = comp["patch"]
    h, w = patch.shape
    scale = (size - 2) / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    resized = imgproc.resize(patch, (nw, nh), "area")
    out = np.zeros((size, size), np.float32)
    y0, x0 = (size - nh) // 2, (size - nw) // 2
    out[y0:y0 + nh, x0:x0 + nw] = resized / 255.0
    return out


def _mpl_ttf_dir():
    import matplotlib

    return os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf")


def train_fonts():
    """The training pool: the DejaVu and STIX faces of matplotlib that have
    digits.  Computer Modern, and the DejaVu serif faces next to the
    held-out style extremes, are left out so that :func:`heldout_fonts`
    tests a foreign foundry."""
    d = _mpl_ttf_dir()
    candidates = [
        "DejaVuSans.ttf",
        "DejaVuSans-Bold.ttf",
        "DejaVuSans-Oblique.ttf",
        "DejaVuSansDisplay.ttf",
        "DejaVuSansMono.ttf",
        "DejaVuSansMono-Bold.ttf",
        "DejaVuSansMono-Oblique.ttf",
        "DejaVuSansMono-BoldOblique.ttf",
        "DejaVuSerif.ttf",
        "STIXGeneral.ttf",
        "STIXGeneralBol.ttf",
        "STIXGeneralItalic.ttf",
        "STIXGeneralBolIta.ttf",
        "STIXNonUni.ttf",
        "STIXNonUniBol.ttf",
        "STIXNonUniIta.ttf",
        "STIXNonUniBolIta.ttf",
    ]
    return [p for p in (os.path.join(d, c) for c in candidates)
            if os.path.exists(p) and _has_digits(p)]


def _has_digits(font_path):
    """False for a face without digit glyphs (DejaVuSerifDisplay), whose
    'digits' render as empty boxes, or one PIL cannot open."""
    from PIL import ImageFont

    try:
        box = ImageFont.truetype(font_path, 32).getbbox("5")
    except Exception:  # noqa: BLE001 - any face PIL cannot read has no digits for us
        return False
    return box is not None and box[3] > box[1]


def heldout_fonts():
    """Held out on two axes: a foreign foundry (Computer Modern) and heavy
    style extremes of the training families."""
    d = _mpl_ttf_dir()
    return [os.path.join(d, name) for name in (
        "cmr10.ttf", "cmb10.ttf", "cmss10.ttf", "DejaVuSans-BoldOblique.ttf",
        "DejaVuSerif-Bold.ttf", "DejaVuSerif-BoldItalic.ttf")]


def render_hud_text(text, font_path, height=44, outline=2, shadow=2,
                    rotation=0.0, damage=0.0, noise=12, blur=0, seed=0,
                    bg_level=28):
    """A HUD-style damage string as a BGR crop: a bright fill that turns
    from white to red with ``damage`` in [0, 1], a dark outline, a drop
    shadow, a slight rotation and a noisy dark background."""
    import cv2
    from PIL import Image, ImageDraw, ImageFont

    rng = np.random.default_rng(seed)
    font = ImageFont.truetype(font_path, height)
    pad = height
    w = int(height * (0.75 * len(text) + 2))
    h = int(height * 2.2)
    img = Image.new("RGB", (w, h), (0, 0, 0))
    draw = ImageDraw.Draw(img)
    fill = (255, int(255 * (1 - 0.85 * damage)), int(255 * (1 - 0.95 * damage)))  # RGB
    x0, y0 = pad // 2, h // 4
    if shadow:
        draw.text((x0 + shadow, y0 + shadow), text, font=font, fill=(15, 10, 10))
    draw.text((x0, y0), text, font=font, fill=fill, stroke_width=outline,
              stroke_fill=(25, 20, 30))
    arr = np.array(img)[:, :, ::-1].copy()  # -> BGR
    if rotation:
        m = cv2.getRotationMatrix2D((w / 2, h / 2), rotation, 1.0)
        arr = cv2.warpAffine(arr, m, (w, h))
    bg = rng.integers(0, bg_level, arr.shape, dtype=np.uint8)
    arr = np.maximum(arr, bg)
    if noise:
        arr = np.clip(arr.astype(np.int16)
                      + rng.integers(-noise, noise + 1, arr.shape, dtype=np.int16),
                      0, 255).astype(np.uint8)
    if blur:
        arr = cv2.GaussianBlur(arr, (2 * blur + 1, 2 * blur + 1), 0)
    return arr


def _same_pad(x, kernel=3, stride=2):
    """Flax's SAME padding for a strided conv: the odd pixel goes after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class DigitNet(nn.Module):
    """Patches ``[B, PATCH, PATCH, 1]`` -> digit logits ``[B, 10]``."""

    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(1, 24, 3, stride=2)
        self.c2 = nn.Conv2d(24, 48, 3, stride=2)
        self.c3 = nn.Conv2d(48, 96, 3, stride=2)
        self.d1 = nn.Linear(6 * 6 * 96, 96)
        self.out = nn.Linear(96, 10)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in (self.c1, self.c2, self.c3):
            x = torch.relu(conv(_same_pad(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as Flax
        return self.out(torch.relu(self.d1(x)))


def load_params(path=WEIGHTS_PATH):
    """The npz of '/'-joined tree paths -> a nested dict of arrays."""
    params = {}
    with np.load(path) as data:
        for key in data.files:
            node = params
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return params


class ConvDigitOCR:
    """Damage reader: ``(bgr_crop) -> (ok, (value, raw, confidence,
    details))``, the learned classifier on the components of the shared
    segmentation.  ``params`` is the digit net's tree (the committed
    weights by default); ``device=None`` means the CUDA device."""

    def __init__(self, params=None, threshold=128, min_area=12, device=None):
        self.device = resolve_device(device)
        self.model = DigitNet()
        self.model.load_state_dict(from_jax_digits(params if params is not None
                                                   else load_params()))
        self.model = self.model.to(self.device).eval()
        self.threshold = threshold
        self.min_area = min_area

    @torch.inference_mode()
    def logits(self, patches):
        """Patches ``[B, PATCH, PATCH, 1]`` float32 (numpy) -> logits
        ``[B, 10]`` (numpy), computed on the reader's device."""
        with full_float32():
            x = torch.from_numpy(np.ascontiguousarray(patches, np.float32)).to(self.device)
            return self.model(x).cpu().numpy()

    def __call__(self, bgr_crop):
        comps, _ = segment_digit_components(bgr_crop, self.threshold, self.min_area)
        if not comps:
            return False, (-1, "", 0.0, {"components": 0})
        patches = np.stack([patch_from_component(c) for c in comps])[..., None]
        logits = self.logits(patches)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        digits = [str(int(i)) for i in probs.argmax(-1)]
        scores = [float(p.max()) for p in probs]
        return assemble_reading(comps, digits, scores)


# ---- training ----


def synth_batch(rng, fonts, batch=128, threshold=128):
    """Render random styled digits, segment them as the reader does, and
    return (patches ``[B, PATCH, PATCH, 1]`` float32, labels ``[B]``
    int32).  The draws from ``rng`` are the JAX package's, one for one: a
    render whose segmentation is not exactly one component is skipped."""
    import cv2

    xs, ys = [], []
    while len(xs) < batch:
        d = int(rng.integers(0, 10))
        crop = render_hud_text(
            str(d), fonts[int(rng.integers(0, len(fonts)))],
            height=int(rng.integers(30, 64)),
            outline=int(rng.integers(0, 4)),
            shadow=int(rng.integers(0, 4)),
            rotation=float(rng.uniform(-10, 10)),
            damage=float(rng.uniform(0, 1)),
            noise=int(rng.integers(0, 25)),
            blur=int(rng.integers(0, 2)),
            seed=int(rng.integers(0, 2**31)),
        )
        # Shape augmentation beyond one font family: shear, aspect squeeze,
        # stroke weight, near-shut gaps, terminal dabs, an elastic warp.
        if rng.random() < 0.4:
            shear = float(rng.uniform(-0.35, 0.35))
            h_, w_ = crop.shape[:2]
            m = np.float32([[1, shear, -shear * h_ / 2], [0, 1, 0]])
            crop = cv2.warpAffine(crop, m, (w_, h_))
        if rng.random() < 0.4:
            h_, w_ = crop.shape[:2]
            sx = float(rng.uniform(0.75, 1.2))
            crop = cv2.resize(crop, (max(8, int(w_ * sx)), h_), interpolation=cv2.INTER_AREA)
        if rng.random() < 0.35:
            k = np.ones((int(rng.integers(2, 4)),) * 2, np.uint8)
            crop = cv2.dilate(crop, k) if rng.random() < 0.5 else cv2.erode(crop, k)
        if rng.random() < 0.35:
            k = np.ones((int(rng.integers(2, 6)),) * 2, np.uint8)
            crop = cv2.morphologyEx(crop, cv2.MORPH_CLOSE, k)
        if rng.random() < 0.4:
            ink_y, ink_x = np.nonzero(crop.max(axis=2) > 128)
            if len(ink_y):
                for _ in range(int(rng.integers(1, 4))):
                    j = int(rng.integers(0, len(ink_y)))
                    r_ = int(rng.integers(2, max(3, crop.shape[0] // 10)))
                    cv2.circle(crop, (int(ink_x[j]), int(ink_y[j])), r_,
                               tuple(int(v) for v in crop[ink_y[j], ink_x[j]]), -1)
        if rng.random() < 0.35:
            h_, w_ = crop.shape[:2]
            gx = cv2.resize(rng.uniform(-1, 1, (4, 4)).astype(np.float32),
                            (w_, h_)) * float(rng.uniform(2, 6))
            gy = cv2.resize(rng.uniform(-1, 1, (4, 4)).astype(np.float32),
                            (w_, h_)) * float(rng.uniform(2, 6))
            mx, my = np.meshgrid(np.arange(w_, dtype=np.float32),
                                 np.arange(h_, dtype=np.float32))
            crop = cv2.remap(crop, mx + gx, my + gy, cv2.INTER_LINEAR)
        comps, _ = segment_digit_components(crop, threshold=threshold)
        if len(comps) != 1:
            continue  # a glyph broken under this style
        xs.append(patch_from_component(comps[0]))
        ys.append(d)
    return np.stack(xs)[..., None].astype(np.float32), np.asarray(ys, np.int32)


def init_model(seed=0, device=None):
    """A ``DigitNet`` with Flax's initialisers (lecun-normal kernels, zero
    biases), drawn from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (``None``: the CUDA device).  JAX's PRNG cannot be
    reproduced, so the draws are not the JAX package's
    ``model.init(PRNGKey(seed))``; their distribution is."""
    model = DigitNet()
    init_flax_(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device))


def make_optimizer(model, lr, steps):
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, fused, as
    ``train.create_train_state``) under ``optax.cosine_decay_schedule(lr,
    steps, alpha=0.05)``, the count 0 at the first update."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 fused=True)
    schedule = cosine_decay_schedule(lr, steps, alpha=0.05)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: schedule(count) / lr)
    return optimizer, scheduler


def train_step(model, optimizer, scheduler, x, y):
    """One update on the host batch ``x`` ``[B, PATCH, PATCH, 1]`` float,
    ``y`` ``[B]`` int: the batch is copied to the model's device (in the
    model's dtype), the mean softmax cross-entropy of the logits is
    minimised by one Adam step, and the schedule advances.  Returns the
    loss and the accuracy of the logits before the update, 0-d tensors on
    the device; the gradients stay in ``.grad``."""
    p = next(model.parameters())
    x = torch.from_numpy(np.ascontiguousarray(x)).to(p.device, p.dtype)
    y = torch.from_numpy(np.ascontiguousarray(y)).to(p.device).long()
    model.train()
    with full_float32():
        logits = model(x)
        loss = F.cross_entropy(logits, y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    optimizer.step()
    scheduler.step()
    with torch.no_grad():
        acc = (logits.argmax(-1) == y).to(logits.dtype).mean()
    return loss.detach(), acc


def train(steps=400, batch=128, lr=2e-3, seed=0, fonts=None, log_every=50, device=None):
    """Train the digit classifier on batches of :func:`synth_batch` (drawn
    from ``np.random.default_rng(seed)``) and return ``(params, history)``:
    ``params`` the JAX package's tree (:func:`convert.to_jax_digits`), which
    :func:`save_params` and ``ConvDigitOCR(params=...)`` take, ``history``
    a ``{"step", "loss", "acc"}`` record every ``log_every`` steps and at
    the last.  ``device=None`` means the CUDA device; the initial weights
    come from :func:`init_model` (not JAX's draws)."""
    device = resolve_device(device)
    fonts = fonts or train_fonts()
    rng = np.random.default_rng(seed)
    model = init_model(seed, device)
    optimizer, scheduler = make_optimizer(model, lr, steps)
    history = []
    for i in range(steps):
        x, y = synth_batch(rng, fonts, batch)
        loss, acc = train_step(model, optimizer, scheduler, x, y)
        if (i + 1) % log_every == 0 or i == steps - 1:
            rec = {"step": i + 1, "loss": float(loss), "acc": float(acc)}
            history.append(rec)
            print(f"ocr train step {rec['step']}: loss {rec['loss']:.4f} acc {rec['acc']:.3f}")
    return to_jax_digits(model.state_dict()), history


def save_params(params, path=WEIGHTS_PATH):
    """Write the digit net's tree as ``ocr_digits.npz`` holds it: one array
    a '/'-joined path, compressed (the JAX package's ``load_params`` reads
    it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{"/".join(k): np.asarray(v) for k, v in sorted(_flatten(params))})


def main():
    """Train on the card for ``OCR_STEPS`` steps (default 1200) and write the
    port's ``assets/ocr_digits.npz``."""
    params, _ = train(steps=int(os.environ.get("OCR_STEPS", "1200")))
    save_params(params)
    print(f"saved {WEIGHTS_PATH}")


if __name__ == "__main__":
    main()
