"""MNIST without torchvision (copy of ``vargp_tpu/data/mnist.py``).

Search order:
  1. Raw IDX files (train-images-idx3-ubyte etc., optionally .gz) in the
     given ``data_dir`` or ``$VARGP_TPU_DATA_DIR`` (or their
     ``MNIST/raw``).  The JAX package also looks in a few fixed
     directories of its host; this package reads only where it is told.
  2. The deterministic synthetic MNIST surrogate (class-conditional blob
     images, 784-d, the same shapes and splits), so every experiment runs
     with no dataset and no network.

Images are flattened to 784 and scaled to [0, 1].  The IDX files are read
with numpy (the JAX package's optional C++ parser gives the same arrays).
"""

import functools
import gzip
import os
import struct
from pathlib import Path

import numpy as np

from vargp_tpu_torch.data.core import ArrayDataset

_IDX_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        _, dtype_code, ndim = magic
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        assert dtype_code == 0x08, "only ubyte IDX supported"
        buf = f.read()
    return np.frombuffer(buf, dtype=np.uint8).reshape(dims)


def _find_idx(data_dir: str | None, train: bool):
    img_name, lbl_name = _IDX_FILES[train]
    dirs = []
    if data_dir:
        dirs += [data_dir, os.path.join(data_dir, "MNIST", "raw")]
    env = os.environ.get("VARGP_TPU_DATA_DIR")
    if env:
        dirs += [env, os.path.join(env, "MNIST", "raw")]
    for d in dirs:
        for suffix in ("", ".gz"):
            img = Path(d) / (img_name + suffix)
            lbl = Path(d) / (lbl_name + suffix)
            if img.exists() and lbl.exists():
                return img, lbl
    return None


def mnist_available(data_dir: str | None = None) -> bool:
    """True only when BOTH splits' IDX files are present: a host with only
    train (or only t10k) files must not be treated as having real MNIST —
    mixing a real train split with surrogate test data (or vice versa)
    would mint garbage accuracies under a 'idx' provenance label."""
    return (
        _find_idx(data_dir, True) is not None
        and _find_idx(data_dir, False) is not None
    )


@functools.lru_cache(maxsize=4)
def _synthetic_mnist(train: bool, seed: int = 1234) -> ArrayDataset:
    """Deterministic NON-SATURATING MNIST surrogate, calibrated to be
    *trainable by the reference model at its default initialization*.

    Three calibration targets (all matter; see tests/test_data.py):

    1. Distance scale — the RBF kernel at the reference's lengthscale init
       (0.5, kernels.py:14-16) sees exp(-2*d^2) of raw pairwise d^2: the
       Gram flushes to zero (f32) once d^2 is a few tens and NO gradient
       reaches the hyperparameters — the model provably flatlines (round-2
       measurement: intra d^2 ~ 104 -> 10% accuracy after 470 epochs).
       Split-Digits, where BOTH the torch reference and this repo train to
       ~95%+, sits at NN-intra d^2 ~ 1, intra ~ 5, inter ~ 10; the
       surrogate targets that *demonstrably trainable* regime (global
       intensity scale + sparse strokes), not raw-MNIST d^2 (which the
       1-GPU reference protocol handled only via torchvision-era budgets
       we cannot replicate without the data).
    2. Class structure — intra-class d^2 must sit well below inter-class
       (real-image geometry); the class core stroke outweighs the
       style strokes.
    3. Difficulty — the round-1 surrogate was nearest-centroid separable
       to ~100%, so every continual metric saturated (acc 1.0, BWT 0.0).
       Hybrid samples (an alpha-mix with a partner class 3 ahead — across
       Split-MNIST task boundaries — labeled by the mixture weights) give
       ~2.5% irreducible error, and style/jitter variance keeps 1-NN near
       real MNIST's ~96-97%: accuracy matrices get off-diagonal structure
       and BWT moves.
    """
    n = 60000 if train else 10000
    rng = np.random.default_rng(seed)  # same prototypes for train & test
    N_STYLES = 5
    # Hybrid fraction and mixing range set the irreducible (Bayes) error:
    # ~= P_HYBRID * E[1-alpha] ~= 0.10 * 0.25 = 2.5%, so the accuracy
    # ceiling sits near the paper's ~97% S-MNIST instead of 100%.
    P_HYBRID = 0.10
    ALPHA_LO, ALPHA_HI = 0.55, 0.95
    partner = (np.arange(10) + 3) % 10  # crosses {2t,2t+1} task pairs
    SCALE = 0.33  # global intensity -> d^2 into the digits-like regime

    def smooth(img):
        k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
        for _ in range(2):
            img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), -1, img)
            img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), -2, img)
        return img

    def stroke_mask(n_px):
        """A connected-ish blob of ~n_px active pixels."""
        field = smooth(rng.random((28, 28)).astype(np.float32))
        thresh = np.quantile(field, 1.0 - n_px / 784.0)
        return (field >= thresh).astype(np.float32)

    shared = stroke_mask(90)  # common "ink" every class shares
    core = np.stack([stroke_mask(55) for _ in range(10)])  # class identity
    # styles: class core dominates; style strokes add bounded intra-class
    # variance (weight chosen so intra d^2 ~ 0.5x inter d^2)
    protos = np.empty((10, N_STYLES, 28, 28), np.float32)
    for c in range(10):
        for s in range(N_STYLES):
            style = stroke_mask(40)
            protos[c, s] = (
                np.clip(0.6 * shared + core[c] + 0.45 * style, 0.0, 1.0) * SCALE
            )

    sample_rng = np.random.default_rng(seed + (0 if train else 1))
    labels = sample_rng.integers(0, 10, size=n).astype(np.int32)
    styles = sample_rng.integers(0, N_STYLES, size=n)
    imgs = protos[labels, styles]

    # hybrids: convex mix with a partner-class style -> real class overlap,
    # with the label drawn from the mixture weights (irreducible error)
    is_hyb = sample_rng.random(n) < P_HYBRID
    alpha1 = (
        ALPHA_LO + (ALPHA_HI - ALPHA_LO) * sample_rng.random(n)
    ).astype(np.float32)
    alpha = alpha1[:, None, None]
    partner_imgs = protos[partner[labels], sample_rng.integers(0, N_STYLES, n)]
    imgs = np.where(is_hyb[:, None, None], alpha * imgs + (1 - alpha) * partner_imgs, imgs)
    flip = is_hyb & (sample_rng.random(n) > alpha1)
    labels = np.where(flip, partner[labels], labels).astype(np.int32)

    # per-sample +-1px translation (9 variants, vectorized per group)
    shifts = sample_rng.integers(-1, 2, size=(n, 2))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            m = (shifts[:, 0] == dy) & (shifts[:, 1] == dx)
            if m.any():
                imgs[m] = np.roll(imgs[m], (dy, dx), axis=(1, 2))

    # ink dropout + intensity jitter + background noise (absolute noise
    # scaled with SCALE so it perturbs, not dominates, the stroke signal)
    keep = (sample_rng.random(imgs.shape) < 0.92).astype(np.float32)
    gain = 0.85 + 0.3 * sample_rng.random((n, 1, 1)).astype(np.float32)
    noise = (
        0.02 * SCALE * np.abs(sample_rng.standard_normal(imgs.shape))
    ).astype(np.float32)
    imgs = np.clip(imgs * keep * gain + noise, 0.0, 1.0)
    return ArrayDataset(imgs.reshape(n, 784).astype(np.float32), labels)


_warned_synthetic = False


def mnist_source(data_dir: str | None = None) -> str:
    """The data source load_mnist would use: 'idx' (real MNIST) or
    'synthetic' (the surrogate), for a run's logs."""
    return "idx" if mnist_available(data_dir) else "synthetic"


def load_mnist(data_dir: str | None = None, train: bool = True) -> ArrayDataset:
    found = _find_idx(data_dir, train)
    if found is None:
        if _find_idx(data_dir, not train) is not None:
            # the OTHER split exists as real IDX: silently mixing real and
            # surrogate splits poisons every accuracy downstream — refuse
            raise FileNotFoundError(
                f"MNIST IDX files found for the {'test' if train else 'train'} "
                f"split but not the {'train' if train else 'test'} split — "
                "refusing to mix real and synthetic data. Provide both "
                "splits (or neither, to use the surrogate)."
            )
        global _warned_synthetic
        if not _warned_synthetic:
            import warnings

            warnings.warn(
                "MNIST IDX files not found — using the synthetic MNIST "
                "surrogate (calibrated distances, NOT real digits). Put "
                "train-images-idx3-ubyte etc. under $VARGP_TPU_DATA_DIR "
                "to run on real data.",
                stacklevel=2,
            )
            _warned_synthetic = True
        return _synthetic_mnist(train)
    img_path, lbl_path = found
    imgs = _read_idx(img_path).astype(np.float32) / 255.0
    labels = _read_idx(lbl_path).astype(np.int32)
    return ArrayDataset(imgs.reshape(imgs.shape[0], -1), labels)
