"""The port's threaded C++ bag reader (``data/native_io.py`` over its copy
``csrc/dmlt_io.cpp``) against the JAX package's readers on the CPU,
bitwise: ``.npy`` bags (f32, f64, short, exact, long) against JAX's numpy
reading (``native_io._numpy_load_bag``), packed shards against JAX's
``NumpyPackReader``, a cohort's batches against the numpy path; a file the
C++ parser refuses going to numpy, ``DMLT_NO_NATIVE`` reading with numpy,
and a failed build raising (the ports of ``tests/test_native_io.py``'s
cases, with the port's read counts)."""

import numpy as np
import pytest
import torch

from disentangled_multimodal_learning_tpu.data import native_io as jnative
from disentangled_multimodal_learning_tpu.data.packing import NumpyPackReader
from disentangled_multimodal_learning_tpu_torch.data import native_io
from disentangled_multimodal_learning_tpu_torch.data.demo_cohort import (
    write_cohort)
from disentangled_multimodal_learning_tpu_torch.data.packing import (
    PackFile, pack_bags)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (as every port test file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counts():
    """The reader's counts, zeroed for the test."""
    before = dict(native_io.reads)
    native_io.reads.update(native=0, numpy=0)
    yield native_io.reads
    native_io.reads.update(before)


@pytest.fixture
def bag_files(tmp_path, rng):
    paths = []
    for i, rows in enumerate([10, 32, 50]):  # short, exact, long
        p = str(tmp_path / f"bag{i}.npy")
        np.save(p, rng.normal(size=(rows, 16)).astype(np.float32))
        paths.append(p)
    p64 = str(tmp_path / "bag64.npy")
    np.save(p64, rng.normal(size=(8, 16)))  # float64, converted to f32
    return paths + [p64]


def test_native_builds_and_loads_bitwise(bag_files, counts):
    """Each bag, and the batch on 3 threads, equals JAX's numpy reading
    bitwise (f64 rounds to nearest in both), all read natively."""
    assert native_io.native_available()
    for p in bag_files:
        np.testing.assert_array_equal(native_io.load_bag(p, 32, 16),
                                      jnative._numpy_load_bag(p, 32, 16))
    got = native_io.load_bag_batch(bag_files, 32, 16, n_threads=3)
    want = np.stack([jnative._numpy_load_bag(p, 32, 16) for p in bag_files])
    np.testing.assert_array_equal(got, want)
    assert counts == {"native": 8, "numpy": 0}


def test_refused_file_goes_to_numpy(tmp_path, bag_files, counts):
    """A bag the parser refuses (float16) is read with numpy, the others
    natively, with JAX's numpy result (``native_io.py:103-104``)."""
    p16 = str(tmp_path / "bag16.npy")
    np.save(p16, np.arange(48, dtype=np.float16).reshape(3, 16))
    paths = [bag_files[0], p16, bag_files[2]]
    got = native_io.load_bag_batch(paths, 20, 16)
    want = np.stack([jnative._numpy_load_bag(p, 20, 16) for p in paths])
    np.testing.assert_array_equal(got, want)
    assert counts == {"native": 2, "numpy": 1}


def test_no_native_reads_with_numpy(bag_files, counts, monkeypatch):
    """``DMLT_NO_NATIVE=1``: every bag, and every pack, with numpy."""
    monkeypatch.setenv("DMLT_NO_NATIVE", "1")
    got = native_io.load_bag_batch(bag_files, 32, 16)
    want = np.stack([jnative._numpy_load_bag(p, 32, 16) for p in bag_files])
    np.testing.assert_array_equal(got, want)
    assert counts == {"native": 0, "numpy": 4}
    assert native_io.pack_open(bag_files[0]) is None


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises, naming the build and the
    opt-out; no bag is read with numpy in its place."""
    bad = tmp_path / "dmlt_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_io, "SOURCE", bad)
    monkeypatch.setattr(native_io, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native_io, "_lib", None)
    with pytest.raises(RuntimeError, match="does not build.*DMLT_NO_NATIVE"):
        native_io.native_available()
    with pytest.raises(RuntimeError, match="does not build"):
        native_io.load_bag_batch([str(bad)], 4, 16)


def test_pack_native_reader_matches_jax(tmp_path, rng, counts):
    """A shard packed by the port reads natively bitwise as JAX's
    ``NumpyPackReader`` reads it, true row counts kept, into whole batches
    and into row blocks shorter than ``fixdim``; a missing name raises
    ``KeyError``."""
    src = tmp_path / "feats"
    src.mkdir()
    names = []
    for i, rows in enumerate([3, 20, 40, 64]):
        np.save(src / f"W{i}.npy", rng.normal(size=(rows, 8)).astype(
            np.float32))
        names.append(f"W{i}")
    out = str(tmp_path / "feats.dmltpack")
    assert pack_bags(str(src), out) == 4
    pf, rd = PackFile(out), NumpyPackReader(out)
    assert pf.native
    for n in names:
        assert pf.rows(n) == rd.rows(n)
        np.testing.assert_array_equal(pf.get(n, 32, 8), rd.get(n, 32, 8))
    np.testing.assert_array_equal(pf.get_batch(names, 32, 8),
                                  rd.get_batch(names, 32, 8))
    block = np.zeros((2, 40, 8), np.float32)
    pf.read_bags(names[2:], [block[0, :25], block[1, :25]])
    np.testing.assert_array_equal(block[:, :25],
                                  rd.get_batch(names[2:], 25, 8))
    assert not block[:, 25:].any()
    assert counts == {"native": 4 + 4 + 2, "numpy": 0}
    assert pf.rows("missing") == -1
    with pytest.raises(KeyError, match="missing"):
        pf.get("missing", 32, 8)
    pf.close()
    assert not pf.native


def test_cohort_batches_native_equal_numpy(tmp_path, monkeypatch, counts):
    """A co-training batch of two small cohorts (IvYGAP's 20x bags from its
    pack, the rest from ``.npy`` files; bags shorter and longer than
    fixdim 16, padded to 25) is bitwise the same read natively and with
    numpy."""
    from disentangled_multimodal_learning_tpu_torch.config import Config
    from disentangled_multimodal_learning_tpu_torch.data.cohorts import (
        read_manifest)
    from disentangled_multimodal_learning_tpu_torch.data.datasets import (
        ConcatDataset, IvYGAP_Dataset, TCGA_Dataset)

    write_cohort(str(tmp_path), "TCGA", [0, 1, 2], [10, 16, 30], feat_dim=8)
    write_cohort(str(tmp_path), "IvYGAP", [3, 4], [12, 40], feat_dim=8,
                 seed=1, pack=("feats20",))
    cfg = Config(dataDir=str(tmp_path) + "/", fixdim=16,
                 input_path_dim=8).validate()

    def batch():
        both = ConcatDataset([
            IvYGAP_Dataset(read_manifest(cfg, "IvYGAP"), cfg),
            TCGA_Dataset(read_manifest(cfg, "TCGA"), cfg)])
        return both.batch([0, 3, 1, 4], pad_to=25)

    native = batch()
    assert counts["native"] == 8 and counts["numpy"] == 0
    monkeypatch.setenv("DMLT_NO_NATIVE", "1")
    plain = batch()
    assert counts["numpy"] == 8
    for name in ("x_path10", "x_path20", "x_omic", "label"):
        np.testing.assert_array_equal(getattr(native, name),
                                      getattr(plain, name), err_msg=name)
