"""CLI: sidechain reconstruction + MD relaxation of sampled ensembles.

Counterpart of `python -m bioemu.sidechain_relax`
(`bioemu/src/bioemu/sidechain_relax.py:249-309`):

    python -m se3diff_torch.sidechain_relax --xtc_path samples.xtc \\
        --pdb_path topology.pdb [--no-md_equil] \\
        [--md_protocol local_minimization|md_equil] [--simtime_ns N] \\
        [--device cuda|cpu]

Writes ``{prefix}_sidechain_rec.{pdb,xtc}`` and, with MD,
``{prefix}_md_equil.{pdb,xtc}``. Requires host-side hpacker (conda env) and,
for MD, OpenMM, whose CUDA platform runs it unless ``--device cpu``.

Counterpart of ``se3diff_tpu/sidechain_relax.py``, with ``--device``.
"""

from __future__ import annotations

import argparse
import logging
import os
from tempfile import TemporaryDirectory

import numpy as np

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from se3diff_torch.relax.md import MDProtocol

    p = argparse.ArgumentParser(
        prog="python -m se3diff_torch.sidechain_relax", description=__doc__
    )
    p.add_argument("--xtc_path", required=True)
    p.add_argument("--pdb_path", required=True)
    p.add_argument("--md_equil", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--md_protocol", default=MDProtocol.LOCAL_MINIMIZATION.value,
                   choices=[m.value for m in MDProtocol])
    p.add_argument("--simtime_ns", type=float, default=0.0)
    p.add_argument("--outpath", default=".")
    p.add_argument("--prefix", default="samples")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="OpenMM platform of the MD relax (cuda raises where "
                        "OpenMM has no CUDA platform)")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from se3diff_torch.relax.hpacker import reconstruct_sidechains
    from se3diff_torch.relax.md import MDProtocol, run_all_md
    from se3diff_torch.struct import xtc as xtcio
    from se3diff_torch.struct.pdb import Structure, read_pdb, write_pdb

    md_protocol = MDProtocol(args.md_protocol)
    if args.simtime_ns > 0:
        assert md_protocol == MDProtocol.MD_EQUIL, (
            "unconstrained MD can only be run using equilibrated structures."
        )

    top = read_pdb(args.pdb_path)
    coords_nm = xtcio.read_xtc(args.xtc_path)[0]
    F = coords_nm.shape[0]
    atom37 = np.zeros((F, top.mask.shape[0], 37, 3), np.float32)
    flat = top.atom_order  # topology-file atom order
    atom37[:, flat[:, 0], flat[:, 1]] = np.asarray(coords_nm) * 10.0
    samples = Structure(
        atom37=atom37, mask=top.mask, aatype=top.aatype, resseq=top.resseq
    )

    frames = reconstruct_sidechains(samples)
    if not frames:
        raise SystemExit("sidechain reconstruction produced no frames")

    os.makedirs(args.outpath, exist_ok=True)
    rec_pdb = os.path.join(args.outpath, f"{args.prefix}_sidechain_rec.pdb")
    write_pdb(frames[0], rec_pdb)
    rec_coords = np.stack([f.atom37[0][f.mask.astype(bool)] for f in frames])
    xtcio.write_xtc(
        os.path.join(args.outpath, f"{args.prefix}_sidechain_rec.xtc"),
        rec_coords / 10.0,
    )
    logger.info("Wrote sidechain-reconstructed ensemble (%d frames)", len(frames))

    if args.md_equil:
        with TemporaryDirectory() as tmp:
            pdb_paths = []
            for n, frame in enumerate(frames):
                path = os.path.join(tmp, f"frame_{n}.pdb")
                write_pdb(frame, path)
                pdb_paths.append(path)
            equil = run_all_md(
                pdb_paths, md_protocol, outpath=args.outpath,
                simtime_ns=args.simtime_ns, device=args.device,
            )
        # Heavy-atom coords per frame (nm); frames may differ in atom count
        # only if topologies diverged, which reconstruct_sidechains prevents.
        equil_arr = np.stack(equil)
        xtcio.write_xtc(
            os.path.join(args.outpath, f"{args.prefix}_md_equil.xtc"), equil_arr
        )
        logger.info("Wrote MD-equilibrated ensemble (%d frames)", len(equil))


if __name__ == "__main__":
    main()
