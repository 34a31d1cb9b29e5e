"""Cohort manifests: a small column table read from CSV with the stdlib
``csv`` module (the port's stand-in for the ``pandas.read_csv`` calls of
``disentangled_multimodal_learning_tpu/data/datasets.py:64-92`` and of the
root ``main.py`` / ``inference.py``, so that the port needs no pandas).

Each column gets the type pandas would infer for it, because what is
computed from a column depends on it: ``kfold_patient_split`` sorts the
unique patient ids, and integer ids sort 1, 2, 10 where the same ids as
strings sort "1", "10", "2", which gives other folds.  A column is

- int64 when every cell parses as an integer (no empty cell);
- float64 when every cell parses as a number, empty and NA cells (pandas'
  default NA strings) becoming NaN;
- bool when every cell is a pandas boolean string (no empty cell);
- object (Python str) otherwise, NA cells as NaN as pandas gives them.
"""

from __future__ import annotations

import csv
import math
import re

import numpy as np

# pandas' default NA strings (``pandas.read_csv`` ``na_values``)
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_TRUE = frozenset(("True", "TRUE", "true"))
_FALSE = frozenset(("False", "FALSE", "false"))
_INT = re.compile(r"[+-]?\d+")


def _as_float(cell: str):
    if "_" in cell:  # Python's float() reads "1_0"; pandas does not
        return None
    try:
        return float(cell)
    except ValueError:
        return None


def infer_column(cells: list[str]) -> np.ndarray:
    """A column's raw cells -> the numpy array pandas would hold for it."""
    na = [c in NA_STRINGS for c in cells]
    present = [c for c, n in zip(cells, na) if not n]
    if not any(na) and present and all(_INT.fullmatch(c) for c in present):
        return np.array([int(c) for c in present], dtype=np.int64)
    if not any(na) and present and all(c in _TRUE or c in _FALSE
                                       for c in present):
        return np.array([c in _TRUE for c in present], dtype=bool)
    floats = [_as_float(c) for c in present]
    if all(f is not None for f in floats):
        it = iter(floats)
        return np.array([math.nan if n else next(it) for n in na],
                        dtype=np.float64)
    return np.array([math.nan if n else c for c, n in zip(cells, na)],
                    dtype=object)


class Table:
    """Named columns of equal length, in their CSV order."""

    def __init__(self, columns: dict[str, np.ndarray]):
        self.data = dict(columns)
        self.columns = list(self.data)
        lengths = {len(v) for v in self.data.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
        self._n = lengths.pop() if lengths else 0

    @classmethod
    def read_csv(cls, path: str) -> "Table":
        """The header row names the columns; every other row is data.  As
        in pandas, a UTF-8 byte-order mark is dropped and blank lines
        (empty or only spaces) are skipped."""
        with open(path, newline="", encoding="utf-8-sig") as f:
            rows = [r for r in csv.reader(f)
                    if r and not (len(r) == 1 and not r[0].strip())]
        if not rows:
            raise ValueError(f"{path}: no header row")
        header, body = rows[0], rows[1:]
        for i, r in enumerate(body):
            if len(r) != len(header):
                raise ValueError(f"{path}: row {i + 1} has {len(r)} cells, "
                                 f"the header {len(header)}")
        return cls({name: infer_column([r[j] for r in body])
                    for j, name in enumerate(header)})

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def column_at(self, i: int) -> np.ndarray:
        """The ``i``-th column (``df.iloc[:, i].to_numpy()``)."""
        return self.data[self.columns[i]]

    def select(self, rows) -> "Table":
        """The rows picked by a boolean mask or an index array, in order."""
        rows = np.asarray(rows)
        return Table({k: v[rows] for k, v in self.data.items()})

    def row(self, i: int) -> dict:
        """Row ``i`` as ``{column: value}``."""
        return {k: v[i] for k, v in self.data.items()}

    def matrix(self, names, dtype=np.float32) -> np.ndarray:
        """The columns ``names`` as a ``[rows, len(names)]`` array."""
        if not names:
            return np.zeros((self._n, 0), dtype=dtype)
        return np.stack([self.data[k].astype(dtype) for k in names], axis=1)

    def to_csv(self, path: str) -> None:
        """Write the header and the rows as ``DataFrame.to_csv(path,
        index=False)`` does: NaN as an empty cell, floats by ``repr``."""
        def cell(v):
            if isinstance(v, (float, np.floating)):
                return "" if math.isnan(v) else repr(float(v))
            if isinstance(v, (bool, np.bool_)):
                return str(bool(v))
            if isinstance(v, (int, np.integer)):
                return str(int(v))
            return str(v)

        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            for i in range(self._n):
                w.writerow([cell(self.data[k][i]) for k in self.columns])
