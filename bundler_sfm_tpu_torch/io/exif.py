"""EXIF focal-length extraction → initial focal estimate in pixels.

Re-implements the logic of `bin/extract_focal.pl:346-412` /
`utils/bundler.py extract_focal_length`:

    focal_px = focal_mm * max_resolution_px / ccd_width_mm

The full camera-model → CCD-width database is ported in `ccd_widths.py`
(every entry of `bin/extract_focal.pl:30-305`), keyed the way the perl builds
its lookup string: `"$make $model"`, trimmed (`extract_focal.pl:353-358`).
Fallbacks, in order: substring match against the compact legacy table below,
the `FocalLengthIn35mmFilm` tag (36 mm frame width), and the EXIF focal-plane
resolution (how jhead derives the "CCD width" tag the perl falls back to,
`extract_focal.pl:361-371`).  A user-supplied database can be layered on via
`load_ccd_database`.  Requires Pillow only when actually called.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from bundler_sfm_tpu_torch.io.ccd_widths import CCD_WIDTHS_DB

# model substring (lowercase) -> CCD width in mm
CCD_WIDTHS: Dict[str, float] = {
    "canon powershot a10": 5.23, "canon powershot s100": 5.23,
    "canon powershot s40": 7.11, "canon powershot g1": 7.11,
    "canon powershot g2": 7.11, "canon powershot g3": 7.18,
    "canon powershot g5": 7.18, "canon powershot g6": 7.18,
    "canon powershot g9": 7.60, "canon powershot sd500": 7.18,
    "canon eos 350d": 22.2, "canon eos digital rebel xt": 22.2,
    "canon eos 400d": 22.2, "canon eos 5d": 35.8, "canon eos 10d": 22.7,
    "canon eos 20d": 22.5, "canon eos 30d": 22.5, "canon eos 40d": 22.2,
    "nikon d40": 23.7, "nikon d50": 23.7, "nikon d70": 23.7,
    "nikon d80": 23.6, "nikon d200": 23.6, "nikon d300": 23.6,
    "nikon coolpix 4500": 7.11, "nikon coolpix 5000": 8.80,
    "nikon e995": 7.11,
    "sony dsc-p10": 7.11, "sony dsc-w1": 7.11, "sony dsc-r1": 21.5,
    "olympus c3000z": 7.11, "olympus c750uz": 5.27,
    "fujifilm finepix s5000": 5.27, "fujifilm finepix s7000": 7.60,
    "panasonic dmc-fz30": 7.11, "panasonic dmc-lx1": 8.50,
    "kodak cx7330": 5.27,
}


def load_ccd_database(path: str) -> None:
    """Augment the CCD table from a file of `model_substring;width_mm` lines."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            model, width = line.rsplit(";", 1)
            CCD_WIDTHS[model.strip().lower()] = float(width)


def _exif_tags(image_path: str) -> Dict[str, object]:
    from PIL import Image, ExifTags  # lazy import

    with Image.open(image_path) as img:
        raw = img._getexif() or {}
        size = img.size
    named = {}
    for tag_id, value in raw.items():
        name = ExifTags.TAGS.get(tag_id, str(tag_id))
        named[name] = value
    named["__size__"] = size
    return named


def _to_float(v) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError):
        pass
    if isinstance(v, tuple) and len(v) == 2 and v[1]:
        return v[0] / v[1]
    return None


def extract_focal_pixels(image_path: str) -> float:
    """Return the initial focal estimate in pixels, or 0.0 if unavailable.

    0.0 means "no estimate" — same sentinel as a 0-focal list.txt line
    (`src/ImageData.cpp:211-220`).
    """
    try:
        tags = _exif_tags(image_path)
    except Exception:
        return 0.0
    width, height = tags["__size__"]
    res = max(width, height)

    focal_mm = _to_float(tags.get("FocalLength"))
    model = str(tags.get("Model", "")).strip()
    make = str(tags.get("Make", "")).strip()

    if focal_mm:
        # Exact "make model" lookup against the full ported database — the
        # same sprintf("%s %s", make, model) + trim key extract_focal.pl
        # builds (`:353-358`); normalized by lowercasing + collapsing runs
        # of whitespace.
        full_exact = " ".join(f"{make} {model}".lower().split())
        ccd = CCD_WIDTHS_DB.get(full_exact)
        if ccd:
            return focal_mm * res / ccd

        # Legacy substring matching against the compact table.
        model_l = model.lower()
        make_l = make.lower()
        full = model_l if model_l.startswith(make_l.split(" ")[0]) \
            else f"{make_l} {model_l}".strip()
        if full:
            for key, ccd in CCD_WIDTHS.items():
                if key in full or full in key:
                    return focal_mm * res / ccd

    # Fall back to the 35mm-equivalent tag (36mm frame width).
    f35 = _to_float(tags.get("FocalLengthIn35mmFilm"))
    if f35 and f35 > 0:
        return f35 * res / 36.0

    # Last resort: derive the sensor width from the focal-plane resolution
    # tags — this is exactly where jhead's "CCD width" output (the perl's
    # own fallback, `extract_focal.pl:361-371`) comes from.
    if focal_mm:
        fpx = _to_float(tags.get("FocalPlaneXResolution"))
        unit = tags.get("FocalPlaneResolutionUnit", 2)
        exif_w = _to_float(tags.get("ExifImageWidth")) or float(width)
        if fpx and fpx > 0:
            mm_per_unit = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.0254}.get(
                int(unit) if unit else 2, 25.4)
            ccd = exif_w * mm_per_unit / fpx
            if 1.0 < ccd < 60.0:
                return focal_mm * res / ccd
    return 0.0


def build_list_entry(image_path: str) -> Tuple[str, float]:
    """(name, focal_px) pair for a list.txt line, as extract_focal.pl emits."""
    return os.path.basename(image_path), extract_focal_pixels(image_path)
