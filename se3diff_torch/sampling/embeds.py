"""Evoformer embedding providers: cache + pluggable backends.

Counterpart of `bioemu/src/bioemu/get_embeds.py`: embeddings for a sequence
are cached under sha256(seq)-keyed npy files
(``{sha}_single.npy [L, 384]``, ``{sha}_pair.npy [L, L, 128]``) and computed
on cache miss by a backend. Backends:

* ``colabfold`` — shells out to a patched ``colabfold_batch`` exactly like
  the reference (get_embeds.py:138-174); requires a ColabFold install
  (``SE3DIFF_COLABFOLD_DIR`` or ``BIOEMU_COLABFOLD_DIR``) and runs as its
  own process.
* ``dummy`` — deterministic pseudo-random embeddings derived from the
  sequence hash; used for tests and benchmarks where a ColabFold install is
  unavailable (mirrors the reference's mocked-subprocess test strategy,
  tests/test_embeds.py).

The provider returns file paths (like the reference) so callers can mmap.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from se3diff_torch.sampling.seq_io import SeqRecord, StrPath, write_fasta

logger = logging.getLogger(__name__)

SINGLE_DIM = 384
PAIR_DIM = 128


def shahexencode(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


def default_embeds_dir() -> str:
    return os.environ.get(
        "SE3DIFF_EMBEDS_CACHE",
        os.path.join(os.path.expanduser("~"), ".se3diff_embeds_cache"),
    )


def _colabfold_bin_dir() -> str:
    colabfold_dir = os.environ.get(
        "SE3DIFF_COLABFOLD_DIR",
        os.environ.get(
            "BIOEMU_COLABFOLD_DIR",
            os.path.join(os.path.expanduser("~"), ".se3diff_colabfold"),
        ),
    )
    return os.path.join(colabfold_dir, "bin")


def merge_a3ms(input_paths: list[StrPath], output_path: StrPath) -> None:
    """Merge multiple A3M files for the same query into one A3M.

    The first file is kept whole (query header + query sequence + hits);
    subsequent files contribute only their hit lines — their first two lines
    (the repeated query header/sequence) are dropped (get_embeds.py:50-70).
    """
    with open(output_path, "w") as out:
        for i, a3m_path in enumerate(input_paths):
            with open(a3m_path) as src:
                if i > 0:
                    next(src)
                    next(src)
                out.writelines(src)


def replace_query_in_a3m(a3m_file: StrPath, new_seq: str) -> None:
    """Overwrite the query sequence (line 2) of an A3M file with ``new_seq``.

    This is how a wild-type MSA is reused for point mutants: the alignment
    rows stay, only the query row changes (get_embeds.py:72-91).
    """
    with open(a3m_file) as src:
        lines = src.readlines()
    if len(lines) < 2:
        raise ValueError(f"{a3m_file} appears too short to be a valid A3M.")
    lines[1] = f"{new_seq}\n"
    with open(a3m_file, "w") as dst:
        dst.writelines(lines)


def run_colabfold(
    input_file: StrPath, res_dir: StrPath, env: dict[str, str], msa_host_url: str | None = None
) -> subprocess.CompletedProcess:
    """Invoke ``colabfold_batch`` with the evoformer-representation flags
    (get_embeds.py:140-174)."""
    assert str(input_file).endswith((".fasta", ".a3m"))
    cmd = [
        "colabfold_batch",
        str(input_file),
        str(res_dir),
        "--num-models", "1",
        "--model-order", "3",
        "--model-type", "alphafold2",
        "--num-recycle", "0",
        "--save-single-representations",
        "--save-pair-representations",
    ]
    if msa_host_url is not None:
        cmd.extend(["--host-url", msa_host_url])
    return subprocess.run(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _compute_colabfold(
    seq: str,
    out_single: Path,
    out_pair: Path,
    msa_file: StrPath | None = None,
    msa_host_url: str | None = None,
) -> None:
    """Cache-miss path shelling out to ColabFold (get_embeds.py:177-266).

    With ``msa_file`` set, the A3M is used as the ColabFold input instead of
    hitting an MSA server: the query row is replaced by ``seq`` so a single
    wild-type MSA serves every point mutant. Unlike the reference (which
    edits the user's file in place, get_embeds.py:232-233), the query
    replacement happens on a private copy. Alongside the npy embeddings, the
    MSA actually used is cached as ``{sha}.a3m`` (and the fasta as
    ``{sha}.fasta``) for reproducibility, matching the reference cache layout.
    """
    seqsha = shahexencode(seq)
    env = os.environ.copy()
    env["PATH"] = f"{_colabfold_bin_dir()}:{env['PATH']}"
    env.pop("MPLBACKEND", None)
    with tempfile.TemporaryDirectory() as tempdir:
        fasta_file = os.path.join(tempdir, f"{seqsha}.fasta")
        res_dir = os.path.join(tempdir, "results")
        os.makedirs(res_dir, exist_ok=True)
        # colabfold_batch derives its output prefix from the fasta HEADER,
        # not the filename — write the record id as the seqsha so the
        # `{seqsha}__unknown_description_` outputs below exist (mirrors the
        # reference's write_fasta(..., ids=[seqsha]), get_embeds.py:215).
        write_fasta([SeqRecord(id=seqsha, seq=seq)], fasta_file)
        if msa_file is not None:
            logger.info(
                "Using user-provided MSA %s; embeddings may differ from "
                "ColabFold-server MSAs.", msa_file
            )
            src = Path(msa_file).expanduser().resolve()
            a3m_input = os.path.join(tempdir, src.name)
            shutil.copy(src, a3m_input)
            replace_query_in_a3m(a3m_input, seq)
            res = run_colabfold(a3m_input, res_dir, env)
            prefix = Path(a3m_input).stem
            used_msa = a3m_input
        else:
            res = run_colabfold(fasta_file, res_dir, env, msa_host_url)
            prefix = f"{seqsha}__unknown_description_"
            # ColabFold splits the server MSA across per-database a3ms;
            # merge them into one record of what was used.
            import glob as _glob

            a3m_parts = _glob.glob(os.path.join(res_dir, f"{prefix}_env", "*.a3m"))
            used_msa = os.path.join(res_dir, f"{seqsha}.a3m")
            if a3m_parts:
                merge_a3ms(a3m_parts, used_msa)
            else:
                used_msa = None
        if res.returncode != 0:
            raise RuntimeError(
                f"{res.stdout.decode()}\nFailed to run colabfold_batch due to the above error."
            )
        suffix = "evo_rank_001_alphafold2_model_3_seed_000.npy"
        shutil.copy(os.path.join(res_dir, f"{prefix}_single_repr_{suffix}"), out_single)
        shutil.copy(os.path.join(res_dir, f"{prefix}_pair_repr_{suffix}"), out_pair)
        cache_dir = out_single.parent
        shutil.copy(fasta_file, cache_dir / f"{seqsha}.fasta")
        if used_msa is not None and os.path.exists(used_msa):
            shutil.copy(used_msa, cache_dir / f"{seqsha}.a3m")


def _compute_dummy(seq: str, out_single: Path, out_pair: Path) -> None:
    """Deterministic stand-in embeddings keyed by the sequence hash."""
    seed = int.from_bytes(hashlib.sha256(seq.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    L = len(seq)
    np.save(out_single, rng.standard_normal((L, SINGLE_DIM)).astype(np.float32) * 0.5)
    np.save(out_pair, rng.standard_normal((L, L, PAIR_DIM)).astype(np.float32) * 0.2)


def _a3m_rows_match(a3m_a: Path, a3m_b: Path) -> bool:
    """True when two A3Ms have identical alignment rows below the query
    (the query row is swapped per mutant, so it is excluded)."""
    try:
        rows_a = a3m_a.read_text().splitlines()[2:]
        rows_b = a3m_b.read_text().splitlines()[2:]
    except OSError:
        return False
    return rows_a == rows_b


def get_embeds(
    seq: str,
    cache_embeds_dir: StrPath | None = None,
    backend: str = "colabfold",
    msa_file: StrPath | None = None,
    msa_host_url: str | None = None,
) -> tuple[str, str]:
    """Return paths to cached (single, pair) embedding npy files for ``seq``.

    Cache layout and naming match the reference (get_embeds.py:197-210) so
    existing BioEmu embedding caches can be pointed at directly. ``msa_file``
    supplies a user A3M (its query row is swapped for ``seq``); it takes
    precedence over ``msa_host_url`` (sample.py:260-261).
    """
    if msa_file is not None and msa_host_url is not None:
        logger.warning("msa_host_url is ignored because MSA file %s is provided.", msa_file)
    seqsha = shahexencode(seq)
    cache_dir = Path(os.path.expanduser(str(cache_embeds_dir or default_embeds_dir())))
    cache_dir.mkdir(parents=True, exist_ok=True)
    single_file = cache_dir / f"{seqsha}_single.npy"
    pair_file = cache_dir / f"{seqsha}_pair.npy"

    if single_file.exists() and pair_file.exists():
        logger.info("Using cached embeddings in %s", cache_dir)
        if msa_file is not None:
            # The cache is keyed by sequence only (reference behavior,
            # get_embeds.py:197-210): a hit silently ignores --msa_file. Be
            # loud about which MSA actually backs these embeddings.
            cached_a3m = cache_dir / f"{seqsha}.a3m"
            if cached_a3m.exists():
                provided = Path(msa_file).expanduser()
                same = provided.exists() and _a3m_rows_match(cached_a3m, provided)
                if same:
                    logger.info(
                        "Cache hit backed by %s (matches the provided MSA's "
                        "alignment rows).", cached_a3m
                    )
                else:
                    logger.warning(
                        "Cache hit: returning embeddings computed from %s, "
                        "NOT from the provided --msa_file %s. Delete the "
                        "cached %s_* files to recompute.",
                        cached_a3m, msa_file, seqsha[:12]
                    )
            else:
                logger.warning(
                    "Cache hit for %s has no recorded MSA; the provided "
                    "--msa_file %s is ignored.", seqsha[:12], msa_file
                )
        return str(single_file), str(pair_file)

    if backend == "colabfold":
        _compute_colabfold(seq, single_file, pair_file, msa_file, msa_host_url)
    elif backend == "dummy":
        _compute_dummy(seq, single_file, pair_file)
    else:
        raise ValueError(f"unknown embeds backend {backend!r}")
    return str(single_file), str(pair_file)


def load_embeds(single_file: StrPath, pair_file: StrPath) -> tuple[np.ndarray, np.ndarray]:
    """Load and shape-check embedding arrays.

    Memory-mapped: the pair file is [L, L, 128] f32 — 512 MB at L=1024 —
    so opening it costs nothing, and `stage_conditioning` copies it to the
    device once per run.
    ``astype(..., copy=False)`` keeps the mmap when the file is already f32
    (both backends save f32) and only copies for foreign dtypes.
    """
    single = np.load(single_file, mmap_mode="r").astype(np.float32, copy=False)
    pair = np.load(pair_file, mmap_mode="r").astype(np.float32, copy=False)
    L = single.shape[0]
    assert single.shape == (L, SINGLE_DIM), single.shape
    assert pair.shape == (L, L, PAIR_DIM), pair.shape
    return single, pair
