"""The port's real-data path against the JAX package on the CPU: manifests
read without pandas (column types as pandas infers them), patient k-folds,
labels, batches from ``.npy`` bags and from packs, bucketed batch order,
the split dumps, packs written by one package and read by the other, the
prefetching loader, and the entries on a tiny cohort.

Each test writes its own cohort (``data/demo_cohort.py write_cohort``):
fixdim 64, ``input_path_dim`` 16, 20 gene columns (5 tumor, 12 immune),
bags of 40 to 90 rows, so that some are padded and some truncated.  JAX
reads the same files with pandas (and its native bag reader where it
builds).  Everything here is compared exactly: folds, labels, batches and
bucket plans bitwise or by equality; the served logits bitwise the
training run's final evaluation.
"""

import os
import re
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from disentangled_multimodal_learning_tpu import config as jconfig
from disentangled_multimodal_learning_tpu.data import bucketing as jbucketing
from disentangled_multimodal_learning_tpu.data import datasets as jdatasets
from disentangled_multimodal_learning_tpu.data import packing as jpacking
from disentangled_multimodal_learning_tpu.data import splits as jsplits
from disentangled_multimodal_learning_tpu.data.loader import (
    PrefetchLoader as JPrefetchLoader)
from disentangled_multimodal_learning_tpu_torch import inference
from disentangled_multimodal_learning_tpu_torch import main as tmain
from disentangled_multimodal_learning_tpu_torch.config import Config
from disentangled_multimodal_learning_tpu_torch.data import (
    bucketing, datasets, packing, splits)
from disentangled_multimodal_learning_tpu_torch.data.contract import LabelCol
from disentangled_multimodal_learning_tpu_torch.data.demo_cohort import (
    write_cohort)
from disentangled_multimodal_learning_tpu_torch.data.loader import (
    BagLoader, PrefetchLoader)
from disentangled_multimodal_learning_tpu_torch.data.manifest import Table

FIXDIM, DIM = 64, 16
SMALL = dict(feat_dim=DIM, genes=20, tumor=5, immune=12)
FIELDS = ("x_path10", "x_path20", "x_omic", "x_omic_tumor", "x_omic_immune",
          "label", "wsi_id")
# TCGA: 8 slides of 6 patients (two with two slides), integer patient ids
TCGA_IDS = [7, 2, 2, 10, 1, 11, 11, 3]
LENS = [40, 64, 90, 10, 64, 77, 33, 64]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: under the suite's parallel
    workers a pool of one thread per core oversubscribes the CPU, and these
    small models' steps (~1,000 ops each) then wait at every op's barrier
    (measured: the real-data fold tests 40-100x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcga(tmp_path, pack=(), cells=None, ids=TCGA_IDS):
    write_cohort(str(tmp_path), "TCGA", ids, LENS[:len(ids)], seed=1,
                 pack=pack, cells=cells, **SMALL)
    return str(tmp_path / "TCGA" / "multimodal_diag_survival_TCGA.csv")


def _cfgs(tmp_path, **kw):
    """The port's and JAX's configs on the tiny cohort."""
    kw = dict(fixdim=FIXDIM, input_path_dim=DIM, dataDir=str(tmp_path),
              batch_size=2, **kw)
    return Config(debug=True, **kw).validate(), jconfig.Config(**kw)


def _same_batch(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_manifest_columns_are_typed_as_pandas_types_them(tmp_path):
    """Each column's dtype and values as ``pandas.read_csv`` gives them:
    int64, float64 with NaN for empty and NA cells, bool, and str with NaN
    for empty cells; the same for a file saved with a UTF-8 byte-order mark
    (Excel's "CSV UTF-8") and blank lines, which pandas drops and skips; a
    ragged row raises."""
    path = tmp_path / "m.csv"
    body = ("pid,ints,floats,gaps,flags,names,mixed,odd\n"
            "10,1,0.5,,True,TCGA-01,WT,1_0\n"
            "2,-3,1e-3,NA,false,TCGA-02,1,inf\n"
            "1,007,-2,4.25,TRUE,,Mutant,x\n")
    for text, encoding in ((body, "utf-8"),
                           ("\n" + body.replace("\n", "\n\n", 2) + "  \n",
                            "utf-8-sig")):
        path.write_text(text, encoding=encoding)
        got, want = Table.read_csv(str(path)), pd.read_csv(path)
        assert got.columns == list(want.columns)
        assert len(got) == len(want) == 3
        for c in want.columns:
            w = want[c].to_numpy()
            assert got[c].dtype == w.dtype, c
            assert [repr(x) for x in got[c]] == [repr(x) for x in w], c
        np.testing.assert_array_equal(got.select(got["ints"] > 0)["pid"],
                                      [10, 1])
    path.write_text("a,b\n1,2\n3\n")
    with pytest.raises(ValueError, match="row 2 has 1 cells"):
        Table.read_csv(str(path))


@pytest.mark.parametrize("as_str", [False, True])
@pytest.mark.parametrize("k", [2, 3])
def test_patient_folds_match_jax(tmp_path, as_str, k):
    """``kfold_patient_split`` on column 0 as the port reads it and as
    pandas does: the same masks for integer ids (sorted 1, 2, 10) and for
    string ids (sorted "1", "10", "2"); every patient in one half of a
    fold; and the two typings give other folds."""
    ids = [f"P{p}" for p in TCGA_IDS] if as_str else TCGA_IDS
    path = _tcga(tmp_path, ids=ids)
    col = Table.read_csv(path).column_at(0)
    jcol = pd.read_csv(path).iloc[:, 0].to_numpy()
    assert col.dtype == jcol.dtype
    got = list(splits.kfold_patient_split(col, k, 42))
    want = list(jsplits.kfold_patient_split(jcol, k, 42))
    assert len(got) == len(want) == k
    for (f, tr, te), (jf, jtr, jte) in zip(got, want):
        assert f == jf
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)
        assert not set(col[tr]) & set(col[te])
        assert (tr | te).all()
    other = list(splits.kfold_patient_split(col.astype(str), 3, 42))
    if not as_str:  # "10" sorts before "2": the folds move
        assert any((a[2] != b[2]).any() for a, b in zip(
            other, splits.kfold_patient_split(col, 3, 42)))


def test_labels_match_jax_including_its_idh_quirk(tmp_path):
    """Labels of rows with an empty ``Diag`` (the WHO-2021 rule), ``IDH``
    given as "WT", "Mutant", 0 and 1, ``His`` as "G4", against JAX's
    ``_label_row``; "Mutant" reads as wild type (IDH 0, derived diagnosis
    0), as in JAX."""
    cells = {0: {"IDH": "WT", "Diag": ""},
             1: {"IDH": "Mutant", "1p19q": "0", "Diag": ""},
             2: {"IDH": "1", "1p19q": "codel", "Diag": ""},
             3: {"IDH": "1", "1p19q": "0", "CDKN": "-1", "Diag": ""},
             4: {"IDH": "1", "1p19q": "0", "CDKN": "0", "His": "G4",
                 "Diag": ""},
             5: {"IDH": "1", "1p19q": "0", "CDKN": "0", "His": "2",
                 "Diag": ""},
             6: {"IDH": "0", "Diag": "3"}}
    path = _tcga(tmp_path, cells=cells)
    cfg, jcfg = _cfgs(tmp_path)
    ds = datasets.TCGA_Dataset(Table.read_csv(path), cfg)
    jds = jdatasets.TCGA_Dataset(pd.read_csv(path), jcfg)
    got = ds.batch(range(len(ds))).label
    want = np.stack([jds[i][5] for i in range(len(jds))])
    np.testing.assert_array_equal(got, want)
    assert got[:7, LabelCol.IDH].tolist() == [0, 0, 1, 1, 1, 1, 0]
    assert got[:7, LabelCol.DIAG].tolist() == [0, 0, 3, 1, 1, 2, 3]
    assert got[4, LabelCol.HIS] == 4
    sizes = ("input_size_omic", "input_size_omic_tumor",
             "input_size_omic_immune")
    assert (tuple(ds.omic_sizes[k] for k in sizes) == (20, 5, 12)
            == tuple(getattr(jcfg, k) for k in sizes))
    # JAX's dataset writes its sizes into the config; the port's leaves it
    assert tuple(getattr(cfg, k) for k in sizes) == (431, 59, 361)


@pytest.mark.parametrize("pack", [(), ("feats10", "feats20")])
def test_batches_match_jax(tmp_path, pack):
    """The same rows through the port's datasets and JAX's, from ``.npy``
    bags and from packs: every field bitwise at fixdim (bags of 10 to 90
    rows padded or truncated to 64) and at a bucket's ``pad_to``, for one
    cohort and for ``ConcatDataset([ivy, tcga])`` (rows of both members in
    any order, repeated rows, one member's rows); the bag lengths too."""
    path = _tcga(tmp_path, pack=pack)
    write_cohort(str(tmp_path), "IvYGAP", [1, 2, 3], [50, 70, 64], seed=2,
                 pack=pack, **SMALL)
    ivy = str(tmp_path / "IvYGAP" / "multimodal_diag_survival_IvY.csv")
    cfg, jcfg = _cfgs(tmp_path)
    tcga = datasets.TCGA_Dataset(Table.read_csv(path), cfg)
    jtcga = jdatasets.TCGA_Dataset(pd.read_csv(path), jcfg)
    both = datasets.ConcatDataset(
        [datasets.IvYGAP_Dataset(Table.read_csv(ivy), cfg), tcga])
    jboth = jdatasets.ConcatDataset(
        [jdatasets.IvYGAP_Dataset(pd.read_csv(ivy), jcfg), jtcga])
    assert [tcga.bag_len(i) for i in range(len(tcga))] == LENS
    assert [both.bag_len(i) for i in range(len(both))] == [
        jboth.bag_len(i) for i in range(len(jboth))]
    for ds, jds, rows in ((tcga, jtcga, [2, 0, 3, 2]),
                          (both, jboth, [9, 0, 4, 1]),
                          (both, jboth, [10, 1, 1, 1]),  # a padded batch
                          (both, jboth, [5, 8])):  # one member's rows
        for pad_to in (None, 36, 81):
            _same_batch(ds.batch(rows, pad_to=pad_to),
                        jds.batch(rows, pad_to=pad_to))
    x10 = tcga.batch([2, 3]).x_path10
    raw = [np.load(tmp_path / "TCGA" / "feats10" / f"TCGA-00{i}.npy")
           for i in (2, 3)]
    np.testing.assert_array_equal(x10[0], raw[0][:FIXDIM])
    np.testing.assert_array_equal(x10[1, :10], raw[1])
    assert not x10[1, 10:].any()


@pytest.mark.parametrize("drop_last", [True, False])
def test_bucketed_loader_matches_jax(tmp_path, drop_last):
    """``BucketedBagLoader`` over the same dataset and seed: for epochs 0
    and 1 the same batches in the same order, each of one bucket, with
    JAX's ``pad`` and ``indices`` and the same length."""
    path = _tcga(tmp_path)
    cfg, jcfg = _cfgs(tmp_path)
    ds = datasets.TCGA_Dataset(Table.read_csv(path), cfg)
    jds = jdatasets.TCGA_Dataset(pd.read_csv(path), jcfg)
    kw = dict(buckets=(16, 49, 64), shuffle=True, drop_last=drop_last,
              seed=3)
    loader = bucketing.BucketedBagLoader(ds, 2, **kw)
    jloader = jbucketing.BucketedBagLoader(jds, 2, **kw)
    assert len(loader) == len(jloader)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            assert (g.pad, g.indices.tolist()) == (w.pad, w.indices.tolist())
            assert g.x_path10.shape[1] in (16, 49, 64)
            _same_batch(g, w)
    with pytest.raises(ValueError, match="perfect square"):
        bucketing.validate_buckets([16, 50])
    with pytest.raises(ValueError, match="perfect square"):
        Config(buckets="400,500").validate()


def test_split_dumps_read_back_equal(tmp_path):
    """``printDataSplit``'s per-fold CSVs written by the port equal JAX's
    (both read back with pandas), empty cells included."""
    path = _tcga(tmp_path, cells={1: {"Diag": ""}, 2: {"IDH": "WT"}})
    table, df = Table.read_csv(path), pd.read_csv(path)
    for fold, tr, te in splits.kfold_patient_split(table.column_at(0), 2, 0):
        got = splits.dump_split_csvs(str(tmp_path / "port"), "TCGA", fold,
                                     table, tr, te)
        want = jsplits.dump_split_csvs(str(tmp_path / "jax"), "TCGA", fold,
                                       df, tr, te)
        for tag in ("train", "test"):
            assert os.path.basename(got[tag]) == os.path.basename(want[tag])
            pd.testing.assert_frame_equal(pd.read_csv(got[tag]),
                                          pd.read_csv(want[tag]))
            back = Table.read_csv(got[tag])
            assert len(back) == int((tr if tag == "train" else te).sum())


def test_packs_read_across_packages(tmp_path, rng):
    """A pack written by the port reads in JAX and one written by JAX reads
    in the port, bitwise, padded and truncated; the two files are
    byte-equal; a missing bag has -1 rows."""
    bags = tmp_path / "bags"
    bags.mkdir()
    want = {}
    for name, n in (("a", 5), ("b", 70), ("c", 64)):
        want[name] = rng.normal(size=(n, DIM)).astype(np.float32)
        np.save(bags / f"{name}.npy", want[name])
    np.save(bags / "d.npy", rng.normal(size=(3, DIM)))  # f64 -> f32
    want["d"] = np.load(bags / "d.npy").astype(np.float32)
    port, jax_ = str(tmp_path / "port.dmltpack"), str(tmp_path / "jax.dmltpack")
    assert packing.pack_bags(str(bags), port) == 4
    assert jpacking.pack_bags(str(bags), jax_) == 4
    with open(port, "rb") as f, open(jax_, "rb") as g:
        assert f.read() == g.read()
    readers = (jpacking.NumpyPackReader(port), packing.PackFile(jax_))
    for reader in readers:
        assert reader.rows("e") == -1
        for name, arr in want.items():
            assert reader.rows(name) == len(arr)
            got = reader.get(name, FIXDIM, DIM)
            n = min(len(arr), FIXDIM)
            np.testing.assert_array_equal(got[:n], arr[:n])
            assert not got[n:].any()
    np.testing.assert_array_equal(
        readers[1].get_batch(["b", "a"], 8, DIM),
        readers[0].get_batch(["b", "a"], 8, DIM))


class _Failing:
    """A loader whose third batch fails to build."""

    def __init__(self):
        self.built = 0

    def __iter__(self):
        for i in range(5):
            if i == 2:
                raise OSError("bag 2 is unreadable")
            self.built += 1
            yield i


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_prefetch_loader_reraises_what_jax_loses():
    """The port's ``PrefetchLoader`` yields the loader's batches in order
    and raises a batch's exception in the consumer; JAX's ends the epoch
    early without a word.  A consumer that stops early joins the
    producer."""
    ds_cfg = dict(size=5, fixdim=16, path_dim=8, omic_dim=40,
                  omic_tumor_dim=7, omic_immune_dim=30)
    from disentangled_multimodal_learning_tpu_torch.data.synthetic import (
        SyntheticBagDataset)
    plain = BagLoader(SyntheticBagDataset(**ds_cfg), 2)
    got = list(PrefetchLoader(plain, depth=1))
    assert [b.indices.tolist() for b in got] == [[0, 1], [2, 3], [4, 4]]
    for g, w in zip(got, plain):
        _same_batch(g, w)
    seen = []
    with pytest.raises(OSError, match="bag 2 is unreadable"):
        for item in PrefetchLoader(_Failing()):
            seen.append(item)
    assert seen == [0, 1]
    assert list(JPrefetchLoader(_Failing())) == [0, 1]  # JAX: no error
    before = threading.active_count()
    it = iter(PrefetchLoader(plain, depth=1))
    next(it)
    it.close()
    assert threading.active_count() == before


def test_entries_raise_for_a_missing_cohort(tmp_path):
    """No silent fallback to synthetic bags: the training entry and the
    serving entry raise ``FileNotFoundError`` naming the cohort directory
    they looked for (TCGA, IvYGAP under co-training, CPTAC under
    ``external_eval``)."""
    cfg, _ = _cfgs(tmp_path, kfold=2)
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(tmp_path / "TCGA"))):
        tmain.main(cfg, device="cpu")
    _tcga(tmp_path)
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(tmp_path / "IvYGAP"))):
        tmain.main(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(tmp_path / "CPTAC"))):
        inference.build_fold0_test_loader(cfg.replace(external_eval=True))


def _cohorts(tmp_path):
    _tcga(tmp_path)
    write_cohort(str(tmp_path), "IvYGAP", [1, 2, 3, 4], [50, 70, 64, 20],
                 seed=2, pack=("feats20",), **SMALL)
    write_cohort(str(tmp_path), "CPTAC", [5, 6, 7, 8, 9], [64, 30, 99, 64, 12],
                 seed=3, **SMALL)


@pytest.mark.parametrize("setting", ["cotraining", "buckets", "cptac"])
def test_real_data_teacher_fold_runs_and_serves(tmp_path, capsys, setting):
    """The port's training entry on the tiny cohorts (teacher, divisor 1,
    2 folds, 1 epoch): TCGA + IvYGAP co-training with the split dumps
    (patients never in both halves, the rows of each cohort's fold),
    bucketed bags, or CPTAC under ``external_eval``; the omic sizes come
    from the gene lists (on the fold's config; the given one stays as it
    is); then the serving entry rebuilds fold 0's test set
    from the seed and gives fold 0's final evaluation logits bitwise."""
    _cohorts(tmp_path)
    ckpts = tmp_path / "ckpt"
    kw = dict(kfold=2, epochs=1, cpb_table_divisor=1, checkpoints=str(ckpts),
              input_size_omic=1, input_size_omic_tumor=1,
              input_size_omic_immune=1)
    kw.update({"cotraining": dict(printDataSplit=True),
               "buckets": dict(buckets="36,64", coTraining=False),
               "cptac": dict(external_eval=True)}[setting])
    cfg, _ = _cfgs(tmp_path, **kw)
    results = tmain.main(cfg, device="cpu")
    assert sorted(results) == [0, 1]
    # the fold's config takes the omic sizes from the cohort (a model of
    # the given 1, 1, 1 would not take its omics); the given one stays
    assert (cfg.input_size_omic, cfg.input_size_omic_tumor,
            cfg.input_size_omic_immune) == (1, 1, 1)
    assert next(tmain.fold_datasets(cfg))[1].omic_sizes == dict(
        input_size_omic=20, input_size_omic_tumor=5,
        input_size_omic_immune=12)
    for m in results.values():
        assert np.isfinite(m["train_losses"]).all() and m["train_losses"]
    if setting == "cotraining":
        for cohort, n in (("tcga", 8), ("ivygap", 4)):
            for fold in (0, 1):
                halves = [pd.read_csv(ckpts / f"split_{cohort}_fold{fold}_"
                                      f"{tag}.csv") for tag in ("train",
                                                                "test")]
                assert len(halves[0]) + len(halves[1]) == n
                assert not (set(halves[0]["patient_id"])
                            & set(halves[1]["patient_id"]))
    ckpt = sorted(ckpts.glob("teacher_fold_1_epoch_1_*.pt"))[0]
    serve = cfg.replace(checkpoints_teacher=str(ckpt))
    _, logits = inference.main(serve, device="cpu")
    for k, v in logits.items():
        np.testing.assert_array_equal(v, results[0]["logits"][k])
    out = capsys.readouterr().out
    assert ("Now Training CPTAC!" in out) == (setting == "cptac")
