"""The port's data layer (``vargp_tpu_torch/data``, a numpy copy of
``vargp_tpu/data``) against the JAX package's, bitwise, for the same
seeds: the synthetic MNIST surrogate, the IDX reader, Split-Digits, the
toy clusters, the task transforms and the fixed-shape batches."""

import gzip
import struct

import numpy as np
import pytest

from vargp_tpu import data as jdata
from vargp_tpu.data import mnist as jmnist
from vargp_tpu_torch import data as tdata
from vargp_tpu_torch.data import mnist as tmnist


def _equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "ArrayDataset"
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("train", [False, True])
def test_synthetic_mnist_matches_jax(train):
    got = tmnist._synthetic_mnist(train)
    want = jmnist._synthetic_mnist(train)
    assert got.data.shape == ((60000 if train else 10000), 784)
    _equal(got, want)


def _write_idx(path, arr, gz):
    header = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def _idx_dir(root, gz, splits=(True, False)):
    rng = np.random.default_rng(3)
    sfx = ".gz" if gz else ""
    for train in splits:
        img, lbl = tmnist._IDX_FILES[train]
        n = 7 if train else 5
        _write_idx(root / (img + sfx), rng.integers(0, 256, (n, 28, 28)), gz)
        _write_idx(root / (lbl + sfx), rng.integers(0, 10, n), gz)
    return root


@pytest.mark.parametrize("train", [True, False])
def test_idx_files_read_as_the_jax_package_reads_them(tmp_path, train):
    """Gzipped IDX files in an explicit ``data_dir`` (the JAX package reads
    them with numpy too), and the same files uncompressed."""
    for name, gz in (("gz", True), ("raw", False)):
        (tmp_path / name).mkdir()
        _idx_dir(tmp_path / name, gz)
    want = jdata.load_mnist(str(tmp_path / "gz"), train=train)
    _equal(tdata.load_mnist(str(tmp_path / "gz"), train=train), want)
    _equal(tdata.load_mnist(str(tmp_path / "raw"), train=train), want)
    assert want.data.max() <= 1.0 and want.data.shape[1] == 784
    assert tdata.mnist_available(str(tmp_path / "raw"))
    assert tdata.mnist_source(str(tmp_path / "raw")) == "idx"


def test_one_split_alone_is_refused_and_none_means_the_surrogate(tmp_path, monkeypatch):
    monkeypatch.delenv("VARGP_TPU_DATA_DIR", raising=False)
    d = tmp_path / "half"
    d.mkdir()
    _idx_dir(d, False, splits=(True,))
    assert not tdata.mnist_available(str(d))
    with pytest.raises(FileNotFoundError, match="refusing to mix"):
        tdata.load_mnist(str(d), train=False)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tdata.mnist_source(str(empty)) == "synthetic"
    monkeypatch.setenv("VARGP_TPU_DATA_DIR", str(tmp_path / "env"))
    (tmp_path / "env").mkdir()
    _idx_dir(tmp_path / "env", False)
    assert tdata.mnist_source(None) == "idx"


@pytest.mark.parametrize("train", [True, False])
def test_digits_match_jax(train):
    _equal(tdata.load_digits_dataset(train=train, seed=0),
           jdata.load_digits_dataset(train=train, seed=0))


@pytest.mark.parametrize("seed", [0, 3])
def test_toy_matches_jax(seed):
    _equal(tdata.make_toy_dataset(seed=seed), jdata.make_toy_dataset(seed=seed))


def test_task_transforms_match_jax():
    """filter_by_class, split_train_val, make_permutations and
    apply_permutation on the same data with generators of one seed."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((50, 6)).astype(np.float32)
    y = rng.integers(0, 5, 50).astype(np.int32)
    tds, jds = tdata.ArrayDataset(X, y), jdata.ArrayDataset(X, y)
    for classes in ([1, 3], None, [], [4]):
        _equal(tdata.filter_by_class(tds, classes), jdata.filter_by_class(jds, classes))
    for n_val in (0, 10):
        got = tdata.split_train_val(tds, n_val, np.random.default_rng(1))
        want = jdata.split_train_val(jds, n_val, np.random.default_rng(1))
        for a, b in zip(got, want):
            _equal(a, b)
    tp = tdata.make_permutations(4, 6, np.random.default_rng(2))
    jp = jdata.make_permutations(4, 6, np.random.default_rng(2))
    assert len(tp) == 4
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
        _equal(tdata.apply_permutation(tds, a), jdata.apply_permutation(jds, b))


@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (3, 8)])
def test_batches_match_jax(n, batch):
    """Fixed-shape batches: the same rows, the padding zero-weighted."""
    rng = np.random.default_rng(n)
    ds = (rng.standard_normal((n, 3)).astype(np.float32), rng.integers(0, 3, n).astype(np.int32))
    tb = list(tdata.eval_batches(tdata.ArrayDataset(*ds), batch))
    jb = list(jdata.eval_batches(jdata.ArrayDataset(*ds), batch))
    tb += list(tdata.batch_iter(tdata.ArrayDataset(*ds), batch, np.random.default_rng(5)))
    jb += list(jdata.batch_iter(jdata.ArrayDataset(*ds), batch, np.random.default_rng(5)))
    assert len(tb) == len(jb) == 2 * -(-n // batch)
    for a, b in zip(tb, jb):
        for u, v in zip(a, b):
            assert u.shape[0] == batch
            np.testing.assert_array_equal(u, v)
    assert sum(float(b.w.sum()) for b in tb) == 2 * n
