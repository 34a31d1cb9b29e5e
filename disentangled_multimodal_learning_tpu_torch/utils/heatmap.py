"""Attention heatmaps from the serving entry's attention-map export
(counterpart of ``disentangled_multimodal_learning_tpu/utils/heatmap.py``
and its CLI ``tools/attention_heatmap.py``).

It reads the ``attention_fold<k>.npz`` that ``inference.main`` writes with
``save4visualization`` (``train/evaluation.py export_attention_maps``:
``att_<name> [n_bags, N]``, NaN-padded past a bucketed bag's end, and
``scores``, ``labels``, ``wsi_ids``) and renders one PNG per (slide, map):

- grid mode (default): the patches on the model's own ``sqrt(N) x
  sqrt(N)`` attention grid, upsampled;
- coords mode: a ``wsi_id,x,y`` CSV (patch units, bag order) puts each
  patch's value at its slide position, over the bounding box.

plus ``summary.csv`` (prediction, probability, each map's entropy).
numpy and the standard library only: the PNG is written with ``zlib``
(8-bit RGB, filter 0 on every row), so no PIL is needed.

    python -m disentangled_multimodal_learning_tpu_torch.utils.heatmap \\
        CKPTDIR/attention_fold0.npz out_dir/ [--coords patches.csv] \\
        [--upsample 16] [--keys att1_tea10 att2_tea10]
"""

from __future__ import annotations

import argparse
import csv
import os
import struct
import zlib

import numpy as np

__all__ = ["load_export", "grid_heatmap", "coords_heatmap", "to_png",
           "read_coords_csv", "render_export", "summary_rows"]

# matplotlib's "inferno" at 256 evenly spaced points, times 255, truncated
# to uint8: the colormap JAX's renderer uses where matplotlib imports
# (its ``_colormap``, heatmap.py:37); 256 RGB triples as hex
_INFERNO_HEX = (
    "00000300000400000601000701010901010b02010e020210030212040314040316050418"
    "06041b07051d08061f0906210a07230b07260d08280e082a0f092d10092f120a32130a34"
    "140b36160b39170b3b190b3e1a0b401c0c431d0c451f0c47200c4a220b4c240b4e260b50"
    "270b52290b542b0a562d0a582e0a5a300a5c32095d34095f3509603709613909623b0964"
    "3c09653e0966400966410967430a68450a69460a69480b6a4a0b6a4b0c6b4d0c6b4f0d6c"
    "500d6c520e6c530e6d550f6d570f6d58106d5a116d5b116e5d126e5f126e60136e62146e"
    "63146e65156e66156e68166e6a176e6b176e6d186e6e186e70196e72196d731a6d751b6d"
    "761b6d781c6d7a1c6d7b1d6c7d1d6c7e1e6c801f6b811f6b83206b85206a86216a88216a"
    "8922698b22698d23698e24689024689125679325679526669626669827659928649b2864"
    "9c29639e2963a02a62a12b61a32b61a42c60a62c5fa72d5fa92e5eab2e5dac2f5cae305b"
    "af315bb1315ab23259b43358b53357b73456b83556ba3655bb3754bd3753be3852bf3951"
    "c13a50c23b4fc43c4ec53d4dc73e4cc83e4bc93f4acb4049cc4148cd4247cf4446d04544"
    "d14643d24742d44841d54940d64a3fd74b3ed94d3dda4e3bdb4f3adc5039dd5238de5337"
    "df5436e05634e25733e35832e45a31e55b30e65c2ee65e2de75f2ce8612be9622aea6428"
    "eb6527ec6726ed6825ed6a23ee6c22ef6d21f06f1ff0701ef1721df2741cf2751af37719"
    "f37918f47a16f57c15f57e14f68012f68111f78310f7850ef8870df8880cf88a0bf98c09"
    "f98e08f99008fa9107fa9306fa9506fa9706fb9906fb9b06fb9d06fb9e07fba007fba208"
    "fba40afba60bfba80dfbaa0efbac10fbae12fbb014fbb116fbb318fbb51afbb71cfbb91e"
    "fabb21fabd23fabf25fac128f9c32af9c52cf9c72ff8c931f8cb34f8cd37f7cf3af7d13c"
    "f6d33ff6d542f5d745f5d948f4db4bf4dc4ff3de52f3e056f3e259f2e45df2e660f1e864"
    "f1e968f1eb6cf1ed70f1ee74f1f079f1f27df2f381f2f485f3f689f4f78df5f891f6fa95"
    "f7fb99f9fc9dfafda0fcfea4"
)


def _colormap() -> np.ndarray:
    return np.frombuffer(bytes.fromhex(_INFERNO_HEX),
                         np.uint8).reshape(256, 3)


def load_export(path: str) -> dict:
    """An ``export_attention_maps`` npz as plain arrays."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _valid(att_row: np.ndarray) -> np.ndarray:
    """The row without the NaN padding of a bucketed export."""
    return att_row[~np.isnan(att_row)]


def _normalize(x: np.ndarray) -> np.ndarray:
    lo, hi = float(np.min(x)), float(np.max(x))
    if hi <= lo:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def grid_heatmap(att_row: np.ndarray, upsample: int = 8) -> np.ndarray:
    """One bag's attention ``[N]`` (NaN padding allowed) -> a map in
    [0, 1] of ``[side * upsample, side * upsample]``, row-major on the
    square grid of side ``floor(sqrt(valid N))``; patches past the square
    are dropped, as the 2-D attention sees only the square."""
    v = _valid(np.asarray(att_row, np.float64))
    side = int(np.sqrt(v.size))
    if side < 1:
        return np.zeros((upsample, upsample))
    img = _normalize(v[: side * side].reshape(side, side))
    return np.repeat(np.repeat(img, upsample, 0), upsample, 1)


def coords_heatmap(att_row: np.ndarray, xy: np.ndarray,
                   upsample: int = 8) -> np.ndarray:
    """One bag's attention ``[N]`` and integer patch coordinates ``[N, 2]``
    -> a map in [0, 1] over their bounding box (empty positions 0)."""
    v = _valid(np.asarray(att_row, np.float64))
    xy = np.asarray(xy, np.int64)[: v.size]
    if v.size == 0:
        return np.zeros((upsample, upsample))
    xy = xy - xy.min(axis=0)
    w, h = int(xy[:, 0].max()) + 1, int(xy[:, 1].max()) + 1
    img = np.zeros((h, w))
    img[xy[:, 1], xy[:, 0]] = _normalize(v)
    return np.repeat(np.repeat(img, upsample, 0), upsample, 1)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_png(img: np.ndarray, path: str) -> str:
    """Colormap a map in [0, 1] and write it as an 8-bit RGB PNG."""
    idx = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    rgb = np.ascontiguousarray(_colormap()[idx])
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_png_chunk(b"IEND", b""))
    return path


def read_coords_csv(path: str) -> dict[str, np.ndarray]:
    """``wsi_id,x,y`` rows -> ``{wsi_id: [N, 2]}`` in row order."""
    out: dict[str, list] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out.setdefault(str(row["wsi_id"]), []).append(
                (int(float(row["x"])), int(float(row["y"]))))
    return {k: np.asarray(v, np.int64) for k, v in out.items()}


def summary_rows(data: dict) -> list[dict]:
    """Per bag: id, label, predicted class, its softmax probability, and
    each map's entropy (of its values shifted to 0 and normalized; lower
    means a more focused map)."""
    scores = np.asarray(data.get("scores", np.zeros((0, 1))), np.float64)
    labels = np.asarray(data.get("labels", np.zeros((0,))))
    ids = data.get("wsi_ids", np.asarray([]))
    att_keys = sorted(k for k in data if k.startswith("att_"))
    rows = []
    for i in range(scores.shape[0]):
        e = np.exp(scores[i] - scores[i].max())
        p = e / e.sum()
        row = {"wsi_id": str(ids[i]) if i < len(ids) else str(i),
               "label": int(labels[i]) if i < len(labels) else -1,
               "pred": int(np.argmax(scores[i])),
               "prob": float(p.max())}
        for k in att_keys:
            v = _valid(np.asarray(data[k][i], np.float64))
            if v.size:
                q = v - v.min()
                q = q / q.sum() if q.sum() > 0 else np.full_like(v, 1 / v.size)
                ent = float(-(q * np.log(np.clip(q, 1e-12, None))).sum())
            else:
                ent = float("nan")
            row[f"entropy_{k[4:]}"] = ent
        rows.append(row)
    return rows


def render_export(npz_path: str, out_dir: str, coords_csv: str | None = None,
                  upsample: int = 8, keys: list[str] | None = None) -> list[str]:
    """Every (bag, attention map) of an export npz as
    ``<wsi_id>__<map>.png`` (coords mode for the slides ``coords_csv``
    lists, grid mode for the others), then ``summary.csv``; ``keys``
    (``att_<name>`` or ``<name>``) keeps only those maps.  Returns the
    files written."""
    data = load_export(npz_path)
    os.makedirs(out_dir, exist_ok=True)
    coords = read_coords_csv(coords_csv) if coords_csv else {}
    ids = [str(s) for s in data.get("wsi_ids", [])]
    att_keys = sorted(k for k in data if k.startswith("att_"))
    if keys:
        att_keys = [k for k in att_keys if k in keys or k[4:] in keys]
    written = []
    for k in att_keys:
        maps = data[k]
        for i in range(maps.shape[0]):
            wid = ids[i] if i < len(ids) else str(i)
            if wid in coords:
                img = coords_heatmap(maps[i], coords[wid], upsample)
            else:
                img = grid_heatmap(maps[i], upsample)
            safe = "".join(c if c.isalnum() or c in "-_." else "_"
                           for c in wid)
            written.append(to_png(
                img, os.path.join(out_dir, f"{safe}__{k[4:]}.png")))
    rows = summary_rows(data)
    if rows:
        spath = os.path.join(out_dir, "summary.csv")
        with open(spath, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        written.append(spath)
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz", help="attention export npz")
    ap.add_argument("out_dir", help="output directory for PNGs + summary.csv")
    ap.add_argument("--coords", default=None,
                    help="patch-coordinate CSV (wsi_id,x,y)")
    ap.add_argument("--upsample", type=int, default=8,
                    help="pixels per patch (default 8)")
    ap.add_argument("--keys", nargs="*", default=None,
                    help="subset of attention keys (default: all)")
    args = ap.parse_args(argv)
    files = render_export(args.npz, args.out_dir, coords_csv=args.coords,
                          upsample=args.upsample, keys=args.keys)
    print(f"wrote {len(files)} files to {args.out_dir}")
    for f in files[:10]:
        print(" ", f)
    if len(files) > 10:
        print(f"  ... {len(files) - 10} more")


if __name__ == "__main__":
    main()
