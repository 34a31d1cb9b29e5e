"""The port's attention-heatmap renderer (``utils/heatmap.py``) against the
JAX package's (``utils/heatmap.py``, ``tools/attention_heatmap.py``) on the
same synthetic export npz: the float maps equal, the PNGs' decoded pixels
bitwise equal (the port writes its PNG with ``zlib``, JAX with PIL: their
bytes differ), ``summary.csv`` equal as text, in grid and coords modes,
with the key filter and through both CLIs; and JAX's own heatmap tests on
the port's functions.  numpy only, no model; PIL decodes both PNGs.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from disentangled_multimodal_learning_tpu.utils import heatmap as jheatmap
from disentangled_multimodal_learning_tpu_torch.utils.heatmap import (
    coords_heatmap, grid_heatmap, load_export, render_export, summary_rows,
    to_png)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (the suite's workers would
    oversubscribe the CPU otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _export_npz(tmp_path, n_bags=3, N=16, n_keys=2, pad_last=4):
    """JAX ``tests/test_heatmap.py``'s export: ``att_att<k>_tea10`` maps,
    the last bag NaN-padded past ``N - pad_last``."""
    rng = np.random.default_rng(0)
    data = {
        "scores": rng.normal(size=(n_bags, 4)).astype(np.float32),
        "labels": np.arange(n_bags) % 4,
        "wsi_ids": np.asarray([f"TCGA-{i:02d}" for i in range(n_bags)]),
    }
    for k in range(n_keys):
        att = rng.uniform(size=(n_bags, N)).astype(np.float32)
        if pad_last:
            att[-1, N - pad_last:] = np.nan
        data[f"att_att{k + 1}_tea10"] = att
    path = os.path.join(tmp_path, "attention_fold1.npz")
    np.savez(path, **data)
    return path, data


def _coords_csv(tmp_path):
    path = os.path.join(tmp_path, "coords.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["wsi_id", "x", "y"])
        for x, y in [(10, 5), (11, 5), (10, 6), (13, 5)]:
            w.writerow(["TCGA-00", x, y])
    return path


def _same_outputs(mine: list, theirs: list) -> None:
    """The same file names; PNG pixels bitwise equal; CSVs equal text."""
    assert [os.path.basename(f) for f in mine] == [
        os.path.basename(f) for f in theirs]
    for a, b in zip(mine, theirs):
        if a.endswith(".png"):
            ia, ib = Image.open(a), Image.open(b)
            assert (ia.mode, ia.size) == (ib.mode, ib.size) == ("RGB",
                                                                ib.size)
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        else:
            assert Path(a).read_text() == Path(b).read_text()


def test_grid_heatmap_shape_and_range():
    att = np.arange(25.0)
    img = grid_heatmap(att, upsample=4)
    assert img.shape == (20, 20)
    assert img.min() == 0.0 and img.max() == 1.0
    assert img[-1, -1] == 1.0 and img[0, 0] == 0.0
    np.testing.assert_array_equal(img, jheatmap.grid_heatmap(att, 4))


def test_grid_heatmap_nan_padding_stripped():
    att = np.concatenate([np.arange(16.0), np.full(9, np.nan)])
    img = grid_heatmap(att, upsample=1)
    assert img.shape == (4, 4)
    np.testing.assert_array_equal(img, jheatmap.grid_heatmap(att, 1))


def test_coords_heatmap_places_values():
    att = np.asarray([0.0, 0.5, 1.0])
    xy = np.asarray([[0, 0], [2, 0], [1, 1]])
    img = coords_heatmap(att, xy, upsample=1)
    assert img.shape == (2, 3)
    assert img[0, 0] == 0.0 and img[0, 2] == 0.5 and img[1, 1] == 1.0
    assert img[1, 0] == 0.0
    np.testing.assert_array_equal(img, jheatmap.coords_heatmap(att, xy, 1))


def test_summary_rows_entropy_ordering(tmp_path):
    path, _ = _export_npz(tmp_path, n_bags=2, N=16, pad_last=0)
    data = load_export(path)
    data["att_att1_tea10"][0] = np.eye(1, 16, 3)[0] * 10.0
    data["att_att1_tea10"][1] = np.ones(16)
    rows = summary_rows(data)
    assert rows[0]["entropy_att1_tea10"] < rows[1]["entropy_att1_tea10"]
    assert {"wsi_id", "label", "pred", "prob"} <= set(rows[0])
    assert rows == jheatmap.summary_rows(data)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (40, 40)])
def test_png_pixels_equal_jax_pil_png(tmp_path, shape):
    """The zlib PNG decodes (PIL) to the pixels of JAX's PIL-written one,
    the colormap included (matplotlib's inferno, which JAX's renderer uses
    where matplotlib imports: it does here)."""
    img = np.random.default_rng(sum(shape)).uniform(-0.1, 1.1, size=shape)
    (tmp_path / "mine").mkdir()
    (tmp_path / "theirs").mkdir()
    mine = to_png(img, str(tmp_path / "mine" / "map.png"))
    theirs = jheatmap.to_png(img, str(tmp_path / "theirs" / "map.png"))
    _same_outputs([mine], [theirs])
    with open(mine, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("mode", ["grid", "coords", "keys"])
def test_render_export_equals_jax(tmp_path, mode):
    """``render_export`` in grid mode (NaN padding on the last bag), in
    coords mode (a bounding box 4 wide and 2 tall) and with the key filter:
    the files JAX writes, pixels bitwise, summary.csv as text."""
    kw = {"grid": dict(upsample=2), "keys": dict(keys=["att1_tea10"])}.get(
        mode, {})
    if mode == "coords":
        path, _ = _export_npz(tmp_path, n_bags=1, N=4, n_keys=1, pad_last=0)
        kw = dict(coords_csv=_coords_csv(tmp_path), upsample=1)
    else:
        path, _ = _export_npz(tmp_path)
    mine = render_export(path, str(tmp_path / "mine"), **kw)
    theirs = jheatmap.render_export(path, str(tmp_path / "theirs"), **kw)
    _same_outputs(mine, theirs)
    pngs = [f for f in mine if f.endswith(".png")]
    if mode == "grid":
        assert len(pngs) == 3 * 2
        assert Image.open(pngs[0]).size == (8, 8)
        with open(tmp_path / "mine" / "summary.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 3 and rows[1]["wsi_id"] == "TCGA-01"
    elif mode == "coords":
        assert Image.open(pngs[0]).size == (4, 2)
    else:
        assert len(pngs) == 3


def test_cli_equals_jax_tool(tmp_path):
    """``python -m ...utils.heatmap`` and JAX's ``tools/attention_heatmap.py``
    with the same arguments write the same files."""
    path, _ = _export_npz(tmp_path)
    runs = {}
    for name, cmd in (
            ("mine", [sys.executable, "-m",
                      "disentangled_multimodal_learning_tpu_torch.utils."
                      "heatmap"]),
            ("theirs", [sys.executable,
                        str(REPO / "tools" / "attention_heatmap.py")])):
        out = tmp_path / name
        r = subprocess.run(cmd + [path, str(out), "--upsample", "2"],
                           capture_output=True, text=True, cwd=REPO,
                           env=dict(os.environ, PYTHONPATH=str(REPO)),
                           timeout=120)
        assert r.returncode == 0, r.stderr
        assert r.stdout.startswith(f"wrote 7 files to {out}")
        runs[name] = sorted(str(p) for p in out.iterdir())
    _same_outputs(runs["mine"], runs["theirs"])
