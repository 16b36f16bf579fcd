"""FASTA I/O and sequence validation (no BioPython dependency).

Counterpart of `bioemu/src/bioemu/seq_io.py`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

StrPath = str | os.PathLike

IUPACPROTEIN = frozenset("ACDEFGHIKLMNPQRSTVWY")


@dataclass
class SeqRecord:
    id: str
    seq: str


def write_fasta(sequences: list[str | SeqRecord], fasta_file: StrPath) -> None:
    """Write sequences (strings or records) as FASTA."""
    Path(fasta_file).parent.mkdir(parents=True, exist_ok=True)
    with open(fasta_file, "w") as f:
        for i, s in enumerate(sequences):
            rec = SeqRecord(id=str(i), seq=s) if isinstance(s, str) else s
            f.write(f">{rec.id}\n")
            for j in range(0, len(rec.seq), 60):
                f.write(rec.seq[j : j + 60] + "\n")


def read_fasta(fasta_file: StrPath) -> list[SeqRecord]:
    """Parse a FASTA (or a3m: same header/sequence layout) file."""
    records: list[SeqRecord] = []
    header: str | None = None
    chunks: list[str] = []
    with open(fasta_file) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if header is not None:
                    records.append(SeqRecord(id=header, seq="".join(chunks)))
                header = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif header is not None:
                chunks.append(line.strip())
    if header is not None:
        records.append(SeqRecord(id=header, seq="".join(chunks)))
    return records


def parse_sequence(sequence: StrPath) -> str:
    """Return the sequence, reading the first FASTA record if given a path
    (seq_io.py:45-55)."""
    try:
        if Path(sequence).is_file():
            return read_fasta(sequence)[0].seq
    except OSError:
        pass  # name too long to be a path -> treat as a literal sequence
    return str(sequence)


def check_protein_valid(seq: str) -> None:
    """Assert the sequence uses only the 20 standard amino acids."""
    for aa in seq:
        assert aa in IUPACPROTEIN, f"Sequence contains non-valid protein character: {aa}"
