#!/usr/bin/env python3
"""Write playaid_core_torch/assets/text_atlas.npz, the glyph atlas that
playaid_core_torch/text.py draws Pillow's text from, and check it.

    python3 tools/torch_port_text_atlas.py [--check]

Pillow renders each glyph hinted at a whole-pixel pen position, so a glyph
unit's mask is the same wherever it lands.  For each font below the tool
records, with Pillow and the font file: every printable ASCII character
(and, for the built-in font, the non-ASCII characters the annotator's
counters write) with its 26.6 advance (``getlength`` * 64), its mask and
offset (``getmask2``), its box (``getbbox``) and the right edge of its ink;
the ligatures raqm forms (found as the pairs, and then the triples around a
ligature, whose whole-string mask the per-unit layout does not reproduce);
and the kerning of every pair of units (``getlength`` of the pair less both
advances).  Then it holds text.py's masks and boxes against Pillow's on
seeded strings and on the strings the charts draw, and exits non-zero on
any difference.  ``--check`` only checks the committed atlas.  Needs Pillow
and DejaVuSans; rerun it when either changes.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "playaid_core_torch", "assets", "text_atlas.npz")
DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
# The charts draw DejaVuSans at 10 (labels), 11 (the label default), 12
# (titles) and 15 (the history strips); the annotator's PIL labels use the
# built-in font.
SIZES = (10, 11, 12, 15)
ASCII = [chr(c) for c in range(32, 127)]
DEFAULT_EXTRAS = ["✅", "❌", "⭕", "️", "é"]
CHECK_STRINGS = 400
# The strings the charts draw on the scripted match (titles, tick labels,
# legends, scales, history strips), for the fighters of constants.CHAR_LIST.
NAMES = ("Byleth", "Pikachu", "Joker", "Diddy Kong", "Donkey Kong", "Jigglypuff")
CHART_STRINGS = sorted(
    {"Actions", "AirDodgeDefensive", "Attack", "BAir", "BThrow", "DAir", "DSmash", "DSpecial",
     "DThrow", "DTilt", "Dash", "DownWait", "FAir", "FSmash", "FSpecial", "FThrow", "FTilt",
     "Get", "GetUpAttack", "Grab", "Hang", "Jab", "Jump", "JumpMovement", "NAir", "NJab",
     "NSpecial", "Normal", "NormalGetUp", "ParryDefensive", "Roll", "RollDefensive",
     "RunMovement", "ShieldDefensive", "ShortHopMovement", "SpotDodgeDefensive",
     "SquatMovement", "Tech", "TechInPlace", "TechRoll", "UAir", "USmash", "USpecial",
     "UThrow", "UTilt", "Up", "WaitMovement", "WalkMovement", "ZAir", "damage output",
     "damaged received", "missed", "punished", "success", "actions", "test",
     "MissedTech"}
    | {f"#{i}" for i in range(1, 6)}
    | {str(i) for i in range(0, 120)}
    | {"200", "500", "1000", "2000", "5000", "10000"}
    | {f"{n} {what}" for n in NAMES for what in (
        "Defensive Options", "Disadvantage Ledge History", "Disadvantage Ledge Options",
        "Disadvantage Tech History", "Disadvantage Tech Options",
        "Successful / Punished / Missed Count",
        "Sum damage output for move / sum damage received for move")})


def fonts():
    from PIL import ImageFont

    out = {f"DejaVuSans_{size}": (ImageFont.truetype(DEJAVU, size), ASCII) for size in SIZES}
    out["pil_default_10"] = (ImageFont.load_default(), ASCII + DEFAULT_EXTRAS)
    return out


def pil_mask(font, s):
    mask, offset = font.getmask2(s, mode="L")
    w, h = mask.size
    return np.array(mask, np.uint8).reshape(h, w), offset


def unit_record(font, unit):
    mask, (ox, oy) = pil_mask(font, unit)
    adv = round(font.getlength(unit) * 64)
    left, top, right, bottom = font.getbbox(unit)
    if right > (adv + 32) >> 6:
        ink_right = right
    else:
        cols = np.nonzero(mask.any(0))[0]
        ink_right = int(cols.max()) + 1 + ox if len(cols) else -(1 << 15)
    return [adv, ox, oy, left, top, right, bottom, ink_right], mask


def pack(font, units):
    metrics, masks = [], []
    for unit in units:
        m, mask = unit_record(font, unit)
        metrics.append(m)
        masks.append(mask)
    return metrics, masks


def segment(units, s):
    """Greedy longest-first split of s into units (text.Font._units)."""
    longest = max(len(u) for u in units)
    out, i = [], 0
    while i < len(s):
        for n in range(min(longest, len(s) - i), 0, -1):
            if s[i:i + n] in units:
                out.append(s[i:i + n])
                i += n
                break
        else:
            return None
    return out


def build_font(key, font, chars):
    """The atlas arrays of one font: units, metrics, masks, kerning."""
    from playaid_core_torch import text

    visible = [c for c in chars if c.strip()]

    def kerning(units, metrics):
        index = {u: i for i, u in enumerate(units)}
        rows = []
        for a in units:
            for b in units:
                if segment(index, a + b) != [a, b]:
                    continue
                v = round(font.getlength(a + b) * 64) - metrics[index[a]][0] - metrics[index[b]][0]
                if v:
                    rows.append((index[a], index[b], v))
        return rows

    def arrays(units, metrics, masks):
        return {
            f"{key}/units": np.array(units),
            f"{key}/metrics": np.array(metrics, np.int32),
            f"{key}/shapes": np.array([m.shape for m in masks], np.int32).reshape(-1, 2),
            f"{key}/masks": np.concatenate([m.ravel() for m in masks]).astype(np.uint8),
            f"{key}/kern": np.array(kerning(units, metrics), np.int32).reshape(-1, 3),
            f"{key}/ascender": np.array(font.getbbox(" ")[1], np.int32),
        }

    def model(arrs):
        text._atlas = arrs
        text._fonts.clear()
        return text.Font(key)

    def resolve_right(units, metrics, masks):
        """A glyph whose box ends at its rounded advance may have a control
        box that ends one or more columns past its ink: try each right edge
        from the ink to the advance on the glyph after every character."""
        arrs = arrays(units, metrics, masks)
        for i, u in enumerate(units):
            adv_px = (metrics[i][0] + 32) >> 6
            lo, hi = metrics[i][7], metrics[i][5]
            if metrics[i][5] > adv_px or lo >= hi or lo < -1000:
                continue
            probes = [p + u for p in visible if segment(set(units), p + u) == [p, u]]
            for cand in range(hi, lo - 1, -1):
                arrs[f"{key}/metrics"][i, 7] = cand
                f = model(arrs)
                if all(tuple(font.getbbox(s)) == f.getbbox(s) for s in probes):
                    metrics[i][7] = cand
                    break
            else:
                raise RuntimeError(f"{key}: no right edge of {u!r} matches Pillow's boxes")
        return arrays(units, metrics, masks)

    units = list(chars)
    metrics, masks = pack(font, units)
    arrs = resolve_right(units, metrics, masks)
    # Ligatures: pairs whose layout as two units is not Pillow's, then the
    # triples around a ligature.
    f = model(arrs)
    ligatures = [a + b for a in visible for b in visible if not same(font, f, a + b)]
    if ligatures:
        m2, k2 = pack(font, ligatures)
        units, metrics, masks = units + ligatures, metrics + m2, masks + k2
        f = model(resolve_right(units, metrics, masks))
        triples = []
        for lig in ligatures:
            for c in visible:
                for s in (c + lig, lig + c):
                    if not same(font, f, s) and s not in triples:
                        triples.append(s)
        if triples:
            m3, k3 = pack(font, triples)
            units, metrics, masks = units + triples, metrics + m3, masks + k3
            ligatures += triples
        arrs = resolve_right(units, metrics, masks)
    print(f"{key}: {len(chars)} characters, ligatures {ligatures}, "
          f"{len(arrs[f'{key}/kern'])} kerning pairs", flush=True)
    return arrs


def same(pil_font, font, s):
    ref, off = pil_mask(pil_font, s)
    got, got_off = font.getmask(s)
    return (ref.shape == got.shape and np.array_equal(ref, got) and tuple(off) == got_off
            and tuple(pil_font.getbbox(s)) == font.getbbox(s))


def check(seed=0):
    """Hold the committed atlas against Pillow; returns the mismatches."""
    from playaid_core_torch import text

    text._atlas = None
    text._fonts.clear()
    rng = np.random.default_rng(seed)
    bad = []
    for key, (pil_font, chars) in fonts().items():
        font = text._font(key)
        strings = CHART_STRINGS + [
            "".join(rng.choice(chars, int(rng.integers(1, 30)))) for _ in range(CHECK_STRINGS)]
        for s in strings:
            if not same(pil_font, font, s):
                bad.append((key, s))
    return bad


def main():
    if "--check" not in sys.argv[1:]:
        arrays = {}
        for key, (font, chars) in fonts().items():
            arrays.update(build_font(key, font, chars))
        np.savez_compressed(OUT, **arrays)
        print(f"wrote {os.path.relpath(OUT, ROOT)} ({os.path.getsize(OUT)} bytes)")
    bad = check()
    for key, s in bad[:20]:
        print(f"differs from Pillow: {key} {s!r}")
    print(f"{len(bad)} strings differ from Pillow")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
