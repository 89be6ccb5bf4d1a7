"""SVG debug overlays of features and matches (counterpart of
coloc_tpu.io.svg).

Reference parity: the #ifdef DEBUG artifacts — SVG overlays of detected
features and putative / inlier matches at every stage (coloc.hpp:153-159
et al., drawn by colocUtils.hpp:148-182 through OpenMVG's svg helpers). A
self-contained SVG writer on host numpy arrays; PIL is optional and only
embeds the image, which is left out without it.
"""

from __future__ import annotations

import base64
import io
from typing import Optional

import numpy as np


def _image_data_uri(image: np.ndarray) -> Optional[str]:
    try:
        from PIL import Image
    except ImportError:
        return None
    buf = io.BytesIO()
    Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).save(buf, "PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def draw_features(path: str, image: np.ndarray, xy: np.ndarray, valid: np.ndarray,
                  radius: float = 3.0, color: str = "green", stroke: float = 1.5):
    """drawFeatures parity (colocUtils.hpp:157-182): circles on the image."""
    h, w = image.shape[:2]
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}">']
    uri = _image_data_uri(image)
    if uri:
        parts.append(f'<image href="{uri}" width="{w}" height="{h}"/>')
    for (x, y), v in zip(np.asarray(xy), np.asarray(valid)):
        if v:
            parts.append(
                f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{radius}" '
                f'fill="none" stroke="{color}" stroke-width="{stroke}"/>'
            )
    parts.append("</svg>")
    with open(path, "w") as fh:
        fh.write("\n".join(parts))


def draw_matches(path: str, image1: np.ndarray, image2: np.ndarray, xy1: np.ndarray,
                 xy2: np.ndarray, idx: np.ndarray, mask: np.ndarray,
                 color: str = "yellow"):
    """drawMatches / Matches2SVG parity: the pair side by side with a line
    for each match."""
    h = max(image1.shape[0], image2.shape[0])
    w = image1.shape[1] + image2.shape[1]
    off = image1.shape[1]
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}">']
    for img, dx in ((image1, 0), (image2, off)):
        uri = _image_data_uri(img)
        if uri:
            parts.append(
                f'<image href="{uri}" x="{dx}" width="{img.shape[1]}" '
                f'height="{img.shape[0]}"/>'
            )
    xy1 = np.asarray(xy1)
    xy2 = np.asarray(xy2)
    idx = np.asarray(idx)
    for q in np.nonzero(np.asarray(mask))[0]:
        x1, y1 = xy1[q]
        x2, y2 = xy2[idx[q]]
        parts.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2 + off:.1f}" '
            f'y2="{y2:.1f}" stroke="{color}" stroke-width="0.8"/>'
        )
        parts.append(
            f'<circle cx="{x1:.1f}" cy="{y1:.1f}" r="2.5" fill="none" '
            f'stroke="cyan"/>'
        )
        parts.append(
            f'<circle cx="{x2 + off:.1f}" cy="{y2:.1f}" r="2.5" fill="none" '
            f'stroke="cyan"/>'
        )
    parts.append("</svg>")
    with open(path, "w") as fh:
        fh.write("\n".join(parts))
