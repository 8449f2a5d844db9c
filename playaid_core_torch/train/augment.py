"""RNG-keyed image augmentation.

The port's copy of ``playaid_core_tpu/train/augment.py`` (the reference's
albumentations pipelines, reference: dataset_utils.py:141-378): horizontal
flip, brightness/contrast, blur, full-range hue shift, gaussian noise,
pixel dropout, coarse dropout, channel dropout, downscale and random-sized
crop, plus the RGBA (alpha-aware) variant used on synthetic sprites.  All
randomness flows through an explicit ``numpy.random.Generator``, in the
JAX package's order, so the same seed gives the same pixels.

Every image op runs through ``imgproc``, which reproduces the OpenCV and
PIL calls of the JAX module bit for bit (``INTER_AREA``, ``INTER_LINEAR``
and ``INTER_NEAREST`` resizes, ``cv2.blur``, the HSV conversions, and
``ImageOps.pad`` of RGB crops and of premultiplied RGBA sprites), so the
augmentation runs at every difficulty on a machine without cv2 or PIL
(the card's).
"""

from __future__ import annotations

import numpy as np

from playaid_core_torch import imgproc
from playaid_core_torch.geometry import aspect_resize


def hflip(img):
    return img[:, ::-1]


def brightness_contrast(img, rng, brightness_limit=(-0.2, 0.4), contrast_limit=(-0.2, 0.2)):
    alpha = 1.0 + rng.uniform(*contrast_limit)
    beta = rng.uniform(*brightness_limit)
    out = img.astype(np.float32) * alpha + beta * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def blur(img, rng, limit=(2, 3)):
    k = int(rng.integers(limit[0], limit[1] + 1))
    return imgproc.blur(img, (k, k))


def hue_saturation_value(img, rng, hue_limit=(-256, 256), sat_limit=(-67, 67),
                         val_limit=(-5, 5)):
    hsv = imgproc.rgb_to_hsv(img).astype(np.int32)
    hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(*hue_limit))) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + int(rng.uniform(*sat_limit)), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + int(rng.uniform(*val_limit)), 0, 255)
    return imgproc.hsv_to_rgb(hsv.astype(np.uint8))


def gauss_noise(img, rng, var_limit=(10.0, 200.0)):
    var = rng.uniform(*var_limit)
    noise = rng.normal(0.0, var**0.5, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def pixel_dropout(img, rng, dropout_prob, drop_value=0):
    mask = rng.random(img.shape[:2]) < dropout_prob
    out = img.copy()
    out[mask] = drop_value
    return out


def coarse_dropout(img, rng, max_holes, max_height, max_width, min_holes=1,
                   fill_value=0):
    out = img.copy()
    h, w = img.shape[:2]
    holes = int(rng.integers(min_holes, max(max_holes, min_holes) + 1))
    for _ in range(holes):
        hh = max(1, int(max_height))
        ww = max(1, int(max_width))
        y = int(rng.integers(0, max(h - hh, 1)))
        x = int(rng.integers(0, max(w - ww, 1)))
        out[y : y + hh, x : x + ww] = fill_value
    return out


def channel_dropout(img, rng, channel_drop_range=(1, 2), fill_value=0):
    out = img.copy()
    n = int(rng.integers(channel_drop_range[0], channel_drop_range[1] + 1))
    chans = rng.choice(img.shape[2], size=min(n, img.shape[2] - 1), replace=False)
    out[..., chans] = fill_value
    return out


def _nearest(img, size):
    return imgproc.resize_nearest(img, size)


def downscale(img, rng, scale_min=0.7, scale_max=0.9):
    scale = rng.uniform(scale_min, scale_max)
    h, w = img.shape[:2]
    small = _nearest(img, (max(1, int(w * scale)), max(1, int(h * scale))))
    return _nearest(small, (w, h))


def random_sized_crop(img, rng, min_height, max_height, out_size):
    h, w = img.shape[:2]
    crop = int(rng.integers(min_height, max(max_height, min_height + 1)))
    crop = min(crop, h, w)
    y = int(rng.integers(0, max(h - crop, 1)))
    x = int(rng.integers(0, max(w - crop, 1)))
    patch = img[y : y + crop, x : x + crop]
    return _nearest(patch, (out_size, out_size))


def augment_char_crop(
    char_crop,
    rng=None,
    horizontal_flip=0.5,
    hard_mode=0.1,
    downscale_p=0.2,
    resize=0.2,
    output_size=128,
    course_dropout=0.1,
    channel_dropout_p=0.0,
    pixel_dropout_p=0.1,
    gauss_noise_p=0.5,
):
    """RGB crop augmentation (reference: dataset_utils.py:141-252)."""
    rng = rng or np.random.default_rng()
    if output_size:
        char_crop = aspect_resize(char_crop, width=output_size)
        char_crop = imgproc.pad(char_crop, (output_size, output_size))

    img = char_crop[..., :3]

    if rng.random() < horizontal_flip:
        img = hflip(img)
    if rng.random() < 0.3:
        img = brightness_contrast(img, rng)
    if rng.random() < 0.05:
        img = blur(img, rng)
    img = hue_saturation_value(img, rng)  # p=1.0 in the reference
    if rng.random() < gauss_noise_p:
        img = gauss_noise(img, rng, (10.0, 200.0))
    if rng.random() < pixel_dropout_p:
        img = pixel_dropout(img, rng, rng.uniform(0.0, 0.3))
    if rng.random() < course_dropout:
        side = min(4, img.shape[0] // 8)
        img = coarse_dropout(img, rng, max_holes=int(rng.uniform(1, 8)),
                             max_height=side, max_width=side)
    if rng.random() < channel_dropout_p:
        img = channel_dropout(img, rng)
    if rng.random() < downscale_p:
        img = downscale(img, rng)
    if resize and output_size and rng.random() < resize:
        img = random_sized_crop(img, rng, int(output_size * 0.7), output_size - 2, output_size)

    if output_size:
        img = aspect_resize(img, width=output_size)
    return np.ascontiguousarray(img)


def augment_synth_char_crop(
    char_crop,
    rng=None,
    horizontal_flip=0.5,
    hard_mode=0.1,
    downscale_p=0.2,
    resize=0.2,
    output_size=128,
    identity_safe=False,
):
    """RGBA (alpha-aware) augmentation for synthetic character sprites
    (reference: dataset_utils.py:255-378).  ``identity_safe`` bounds the
    hue/saturation jitter so a palette-coded identity survives."""
    rng = rng or np.random.default_rng()
    if output_size:
        char_crop = aspect_resize(char_crop, width=output_size)
        char_crop = imgproc.pad(char_crop, (output_size, output_size))

    if resize and output_size and rng.random() > 0.6:
        # Shrink the sprite inside the canvas to simulate a loose crop
        # (PIL's ImageOps.expand with a transparent border).
        new_scale = int(output_size * rng.uniform(0.75, 1.0))
        shrunk = aspect_resize(char_crop, width=new_scale)
        border = output_size - new_scale
        char_crop = np.pad(shrunk, ((border, border), (border, border), (0, 0)))

    rgb = char_crop[..., :3]
    alpha = char_crop[..., 3]

    if rng.random() < horizontal_flip:
        rgb, alpha = hflip(rgb), alpha[:, ::-1]
    if rng.random() < 0.3:
        rgb = brightness_contrast(
            rgb, rng,
            brightness_limit=(-0.2, 0.3) if identity_safe else (-0.2, 0.6))
    if rng.random() < 0.05:
        rgb = blur(rgb, rng)
    if identity_safe:
        rgb = hue_saturation_value(rgb, rng, hue_limit=(-8, 8),
                                   sat_limit=(-30, 30), val_limit=(-10, 10))
    else:
        rgb = hue_saturation_value(rgb, rng, val_limit=(-10, 10))
    if rng.random() < 0.2:
        rgb = gauss_noise(rgb, rng, (427.63, 500.0))
    if rng.random() < hard_mode:
        mask = rng.random(rgb.shape[:2]) < 0.1
        rgb = rgb.copy()
        rgb[mask] = 0
        alpha = alpha.copy()
        alpha[mask] = 0
    if rng.random() < hard_mode:
        side = min(96, rgb.shape[0] // 3)
        rgb = coarse_dropout(rgb, rng, max_holes=2, max_height=side, max_width=side)
    if not identity_safe and rng.random() < hard_mode:
        rgb = channel_dropout(rgb, rng)
    if rng.random() < downscale_p:
        rgb = downscale(rgb, rng)
    if resize and output_size and rng.random() < resize:
        crop = int(rng.integers(int(output_size * 0.3), output_size - 2))
        crop = min(crop, rgb.shape[0], rgb.shape[1])
        y = int(rng.integers(0, max(rgb.shape[0] - crop, 1)))
        x = int(rng.integers(0, max(rgb.shape[1] - crop, 1)))
        rgb = _nearest(rgb[y : y + crop, x : x + crop], (output_size, output_size))
        alpha = _nearest(alpha[y : y + crop, x : x + crop], (output_size, output_size))

    rgba = np.dstack([rgb, alpha])
    if output_size:
        rgba = aspect_resize(rgba, width=output_size)
    return np.ascontiguousarray(rgba)


SYNTH_DIFFICULTY_REAL = {
    1: dict(horizontal_flip=0.0, hard_mode=0.0, downscale_p=0.1, resize=0.4,
            course_dropout=0.9, channel_dropout_p=0.0, pixel_dropout_p=0.1,
            gauss_noise_p=0.4),
    2: dict(horizontal_flip=0.0, hard_mode=0.2, downscale_p=0.3, resize=0.3,
            course_dropout=0.2, channel_dropout_p=0.01, pixel_dropout_p=0.1,
            gauss_noise_p=0.8),
}

SYNTH_DIFFICULTY_SPRITE = {
    1: dict(horizontal_flip=0.0, hard_mode=0.0, downscale_p=0.1, resize=0.1),
    2: dict(horizontal_flip=0.0, hard_mode=0.2, downscale_p=0.3, resize=0.3),
}
