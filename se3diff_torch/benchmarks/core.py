"""Benchmark registry, vendored asset paths and the CSV tables.

Counterpart of ``se3diff_tpu/benchmarks/core.py`` (the reference's
`bioemu-benchmarks/bioemu_benchmarks/benchmarks.py` and `paths.py`), without
pandas: a table is a list of row dicts read and written with :mod:`csv`.
:func:`read_csv` types each column as pandas' ``read_csv`` does (int, float,
bool or str; an empty cell is NaN) and :func:`write_csv` writes the bytes
pandas' ``to_csv`` writes for the same values, so the results files of both
packages can be compared line for line.
"""

from __future__ import annotations

import csv
import io
import math
import os
from enum import Enum
from functools import cached_property

import numpy as np

ASSET_DIR = os.environ.get(
    "SE3DIFF_BENCHMARK_ASSETS",
    os.path.normpath(
        os.path.join(os.path.dirname(__file__), "..", "..", "assets", "benchmarks")
    ),
)
MULTICONF_ASSET_DIR = os.path.join(ASSET_DIR, "multiconf_benchmark_0.1")
FOLDING_FREE_ENERGY_ASSET_DIR = os.path.join(
    ASSET_DIR, "folding_free_energies_benchmark_0.1"
)
MD_EMULATION_ASSET_DIR = os.path.join(ASSET_DIR, "md_emulation_benchmark_0.1")


# --------------------------------------------------------------------- #
# Tables                                                                 #
# --------------------------------------------------------------------- #


def _parse_column(cells: list[str]) -> list:
    """One column's cells as the type pandas infers for it: all integers
    -> int, all numbers -> float (empty cells NaN), all True/False -> bool,
    else str."""
    filled = [c for c in cells if c != ""]
    if filled and all(c in ("True", "False") for c in filled) and len(filled) == len(cells):
        return [c == "True" for c in cells]
    try:
        if len(filled) == len(cells):
            return [int(c) for c in cells]
    except ValueError:
        pass
    try:
        return [float(c) if c != "" else math.nan for c in cells]
    except ValueError:
        return list(cells)


def read_csv(path) -> list[dict]:
    """The rows of a CSV file as dicts, each column typed as pandas would."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        raw = list(reader)
    columns = [_parse_column([r[k] for r in raw]) for k in range(len(header))]
    return [dict(zip(header, values)) for values in zip(*columns)] if raw else []


def rows_where(rows: list[dict], column: str, value) -> list[dict]:
    """The rows whose ``column`` equals ``value``, in order."""
    return [r for r in rows if r[column] == value]


def table_columns(rows: list[dict]) -> list[str]:
    """The columns of a table of rows: every key, in order of first use (as
    pandas orders a DataFrame built from records)."""
    return list(dict.fromkeys(k for r in rows for k in r))


def _cell(v) -> str:
    """A value as pandas' ``to_csv`` writes it."""
    if v is None:
        return ""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    return str(v)


def write_csv(path, rows: list[dict], columns: list[str], index: str | None = None) -> str:
    """Write ``rows`` (missing cells empty) under ``columns`` and return the
    text. With ``index``, each row's ``index`` value leads its line, under
    that header, as pandas writes a named index."""
    out = io.StringIO()
    writer = csv.writer(out, lineterminator="\n")
    head = ([index] if index else []) + list(columns)
    writer.writerow(head)
    for r in rows:
        writer.writerow([_cell(r.get(c)) for c in head])
    text = out.getvalue()
    if path is not None:
        with open(path, "w", newline="") as f:
            f.write(text)
    return text


# --------------------------------------------------------------------- #
# Registry                                                               #
# --------------------------------------------------------------------- #


class Benchmark(str, Enum):
    """The seven benchmarks (benchmarks.py:17-80)."""

    MULTICONF_OOD60 = "multiconf_ood60"
    MULTICONF_OODVAL = "multiconf_oodval"
    MULTICONF_DOMAINMOTION = "multiconf_domainmotion"
    MULTICONF_CRYPTICPOCKET = "multiconf_crypticpocket"
    SINGLECONF_LOCALUNFOLDING = "singleconf_localunfolding"
    FOLDING_FREE_ENERGIES = "folding_free_energies"
    MD_EMULATION = "md_emulation"

    @cached_property
    def asset_dir(self) -> str:
        if self in MULTICONF_BENCHMARKS or self == Benchmark.SINGLECONF_LOCALUNFOLDING:
            return os.path.join(MULTICONF_ASSET_DIR, self.value.split("_")[1])
        if self == Benchmark.FOLDING_FREE_ENERGIES:
            return os.path.join(FOLDING_FREE_ENERGY_ASSET_DIR, "folding_free_energies")
        if self == Benchmark.MD_EMULATION:
            return os.path.join(MD_EMULATION_ASSET_DIR, "md_emulation")
        raise ValueError(f"benchmark not recognised: {self}")

    @cached_property
    def metadata(self) -> list[dict]:
        """``testcases.csv``: one row (``test_case``, ``sequence``) a test case."""
        return read_csv(os.path.join(self.asset_dir, "testcases.csv"))

    @cached_property
    def default_samplesize(self) -> list[int]:
        """Recommended samples per test case (benchmarks.py:49-72)."""
        if self in MULTICONF_BENCHMARKS or self == Benchmark.SINGLECONF_LOCALUNFOLDING:
            return [4000] * len(self.metadata)
        if self == Benchmark.MD_EMULATION:
            return [10000] * len(self.metadata)
        info = read_csv(os.path.join(self.asset_dir, "system_info.csv"))
        return [
            int(rows_where(info, "sequence", row["sequence"])[0]["num_samples"])
            for row in self.metadata
        ]


MULTICONF_BENCHMARKS: list[Benchmark] = [
    Benchmark.MULTICONF_OOD60,
    Benchmark.MULTICONF_OODVAL,
    Benchmark.MULTICONF_DOMAINMOTION,
    Benchmark.MULTICONF_CRYPTICPOCKET,
]

ALL_BENCHMARKS: list[Benchmark] = list(Benchmark)

SPECS_COLUMNS = ["benchmark", "test_case", "sequence", "default_samplesize"]


def benchmark_specs_frame() -> list[dict]:
    """Specs table for the CLI (benchmarks.py:83-112): one row a test case
    of every benchmark, with ``SPECS_COLUMNS``."""
    rows = []
    for bm in ALL_BENCHMARKS:
        for row, size in zip(bm.metadata, bm.default_samplesize):
            rows.append({"benchmark": bm.value, "test_case": row["test_case"],
                         "sequence": row["sequence"], "default_samplesize": size})
    return rows


class BenchmarkResults:
    """Shared results behavior (results.py:10-64): pickle round-trip plus the
    ``save_results`` / ``plot`` / ``get_aggregate_metrics`` contract the
    benchmark runners implement. The concrete classes are dataclasses; pickle
    preserves their numpy payloads exactly."""

    def to_pickle(self, outfile) -> None:
        import pickle

        with open(outfile, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def from_pickle(cls, infile):
        import pickle

        with open(infile, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, cls):
            raise TypeError(f"{infile} holds {type(obj).__name__}, not {cls.__name__}")
        return obj
