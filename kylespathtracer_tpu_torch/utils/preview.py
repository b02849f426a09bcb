"""Terminal live preview (NumPy only).

Copy of kylespathtracer_tpu/utils/preview.py. The reference is a windowed
interactive app (render.cpp:231-278 blits to screen every frame,
main.cpp:328-357). The renderer here is headless, so the display path
becomes: device renders → host downsamples → ANSI truecolor half-block
cells in the terminal (two pixels per character row). Good enough to
*watch* an animation converge over SSH; PNG export remains the
high-fidelity path (utils/image_io.py). Callers pass host arrays (a tensor
on the card goes through `.cpu().numpy()`).
"""

from __future__ import annotations

import sys

import numpy as np

_RESET = "\x1b[0m"


def _downsample(img: np.ndarray, max_w: int, max_h: int) -> np.ndarray:
    """Box-average to at most (max_h, max_w); img f32[H,W,3] in [0,1],
    row 0 = bottom (GL convention) — flipped here for display."""
    img = img[::-1]
    H, W, _ = img.shape
    fy = max(1, -(-H // max_h))
    fx = max(1, -(-W // max_w))
    Hc, Wc = H // fy * fy, W // fx * fx
    img = img[:Hc, :Wc].reshape(Hc // fy, fy, Wc // fx, fx, 3).mean((1, 3))
    return img


def frame_to_ansi(img: np.ndarray, max_w: int = 100, max_h: int = 56) -> str:
    """Render an image to an ANSI half-block string (▀ fg=top bg=bottom)."""
    img = _downsample(np.asarray(img, np.float32), max_w, max_h * 2)
    q = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.int32)
    rows, W, _ = q.shape
    if rows % 2:
        q = np.concatenate([q, np.zeros((1, W, 3), np.int32)], 0)
        rows += 1
    lines = []
    for r in range(0, rows, 2):
        top, bot = q[r], q[r + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + _RESET)
    return "\n".join(lines)


class TerminalPreview:
    """Redraws frames in place (cursor-up rewrite); falls back to plain
    sequential printing when stdout is not a TTY."""

    def __init__(self, max_w: int = 100, max_h: int = 48, stream=None):
        self.max_w = max_w
        self.max_h = max_h
        self.stream = stream or sys.stdout
        self._lines = 0

    def show(self, img, caption: str = "") -> None:
        text = frame_to_ansi(img, self.max_w, self.max_h)
        n = text.count("\n") + 1 + (1 if caption else 0)
        out = self.stream
        if self._lines and out.isatty():
            out.write(f"\x1b[{self._lines}F\x1b[0J")
        out.write(text + "\n")
        if caption:
            out.write(caption + "\n")
        out.flush()
        self._lines = n
