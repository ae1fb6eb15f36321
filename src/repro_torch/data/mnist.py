"""Synthetic MNIST, the port's copy of ``repro.data.mnist`` (numpy only).

The port imports nothing of ``repro``; this copy is the same code, so the
same seed gives bit-identical arrays in both packages and the port's
evaluation compares with the reference's image for image.


The real MNIST files are not available offline, so we *synthesize* a
drop-in replacement with the same interface and statistics: 60k train /
10k test, 28x28 grayscale in [0, 1], 10 balanced classes.  Digits are
rendered procedurally from per-digit stroke templates (polylines in the
unit square) with random affine warps, stroke-thickness jitter, blur and
pixel noise — enough intra-class variation that the paper's CNN does not
trivially memorize.

``canvas_digits`` reproduces the paper's §III.A distribution shift
(97.45% test accuracy vs 74% on digitally drawn canvas input): thicker
strokes drawn on a large canvas then harshly box-downsampled to 28x28,
exactly the degradation the paper blames ("extreme down-sampling ...
causes a loss of feature generality").
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Per-digit stroke templates: list of polylines, coords in [0,1]^2 (x, y
# with y down).  Deliberately simple — the affine warps provide variation.
_T = {
    0: [[(0.5, 0.12), (0.78, 0.3), (0.78, 0.7), (0.5, 0.88), (0.22, 0.7),
         (0.22, 0.3), (0.5, 0.12)]],
    1: [[(0.35, 0.3), (0.55, 0.12), (0.55, 0.88)],
        [(0.35, 0.88), (0.75, 0.88)]],
    2: [[(0.25, 0.3), (0.45, 0.12), (0.7, 0.25), (0.68, 0.45), (0.25, 0.88),
         (0.78, 0.88)]],
    3: [[(0.25, 0.18), (0.7, 0.15), (0.5, 0.45), (0.75, 0.65), (0.55, 0.88),
         (0.25, 0.8)]],
    4: [[(0.65, 0.88), (0.65, 0.12), (0.22, 0.6), (0.8, 0.6)]],
    5: [[(0.75, 0.12), (0.3, 0.12), (0.28, 0.45), (0.6, 0.42), (0.75, 0.65),
         (0.6, 0.88), (0.25, 0.82)]],
    6: [[(0.65, 0.12), (0.35, 0.4), (0.25, 0.7), (0.45, 0.88), (0.7, 0.75),
         (0.65, 0.52), (0.3, 0.58)]],
    7: [[(0.22, 0.15), (0.78, 0.15), (0.45, 0.88)],
        [(0.35, 0.5), (0.68, 0.5)]],
    8: [[(0.5, 0.12), (0.72, 0.28), (0.5, 0.47), (0.28, 0.28), (0.5, 0.12)],
        [(0.5, 0.47), (0.76, 0.68), (0.5, 0.88), (0.24, 0.68), (0.5, 0.47)]],
    9: [[(0.7, 0.42), (0.4, 0.48), (0.3, 0.25), (0.55, 0.12), (0.72, 0.3),
         (0.68, 0.6), (0.5, 0.88)]],
}

_GRID = None


def _grid(size: int):
    global _GRID
    if _GRID is None or _GRID[0].shape[0] != size:
        ys, xs = np.mgrid[0:size, 0:size]
        _GRID = ((xs + 0.5) / size, (ys + 0.5) / size)
    return _GRID


def _render(digit: int, rng: np.random.Generator, size: int = 28,
            thickness: float = 0.045) -> np.ndarray:
    """Rasterize one digit with a random affine warp."""
    xs, ys = _grid(size)
    ang = rng.uniform(-0.25, 0.25)
    sx, sy = rng.uniform(0.75, 1.05, 2)
    shear = rng.uniform(-0.18, 0.18)
    tx, ty = rng.uniform(-0.06, 0.06, 2)
    ca, sa = np.cos(ang), np.sin(ang)
    th = thickness * rng.uniform(0.75, 1.45)

    img = np.zeros((size, size), np.float32)
    for stroke in _T[digit]:
        pts = np.asarray(stroke, np.float32) - 0.5
        # affine: rotate, shear, scale, translate
        x = (pts[:, 0] * ca - pts[:, 1] * sa)
        y = (pts[:, 0] * sa + pts[:, 1] * ca)
        x = (x + shear * y) * sx + 0.5 + tx
        y = y * sy + 0.5 + ty
        for i in range(len(x) - 1):
            ax, ay, bx, by = x[i], y[i], x[i + 1], y[i + 1]
            dx, dy = bx - ax, by - ay
            L2 = dx * dx + dy * dy + 1e-9
            t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / L2, 0.0, 1.0)
            d2 = (xs - ax - t * dx) ** 2 + (ys - ay - t * dy) ** 2
            img = np.maximum(img, np.exp(-d2 / (2 * th * th)))
    return img


def _finish(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    img = np.clip(img * rng.uniform(0.85, 1.0) + rng.normal(0, 0.03, img.shape),
                  0.0, 1.0)
    return img.astype(np.float32)


def make_split(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> images (n, 28, 28, 1) float32 in [0,1], labels (n,) int32.
    Classes are balanced and shuffled."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n, dtype=np.int32) % 10
    rng.shuffle(labels)
    images = np.empty((n, 28, 28, 1), np.float32)
    for i in range(n):
        images[i, :, :, 0] = _finish(_render(int(labels[i]), rng), rng)
    return images, labels


def canvas_digits(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The paper's 'digitally drawn' shift: thick strokes on a 112x112
    canvas, box-downsampled 4x to 28x28 (heavy aliasing), then binarized-ish
    contrast.  Reproduces the §III.A accuracy drop qualitatively."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n, dtype=np.int32) % 10
    rng.shuffle(labels)
    images = np.empty((n, 28, 28, 1), np.float32)
    for i in range(n):
        big = _render(int(labels[i]), rng, size=112, thickness=0.085)
        big = (big > rng.uniform(0.2, 0.4)).astype(np.float32)  # hard pen
        # off-center drawing (nobody centers their mouse strokes)
        big = np.roll(big, rng.integers(-8, 9, 2), axis=(0, 1))
        small = big.reshape(28, 4, 28, 4).mean(axis=(1, 3))       # box filter
        images[i, :, :, 0] = np.clip(small * 1.6, 0, 1)
    return images, labels


def load(train_n: int = 60_000, test_n: int = 10_000, seed: int = 0
         ) -> Dict[str, np.ndarray]:
    """Keras-loader-shaped entry point (paper Sec. II-C)."""
    xtr, ytr = make_split(train_n, seed)
    xte, yte = make_split(test_n, seed + 1)
    return {"x_train": xtr, "y_train": ytr, "x_test": xte, "y_test": yte}


def batches(x, y, batch_size: int, seed: int, epochs: int = 1):
    """Shuffled minibatch iterator (drops the ragged tail, like tf.data)."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i : i + batch_size]
            yield x[idx], y[idx]
