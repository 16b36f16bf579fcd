"""OpenMM MD-relax protocol (host-side, optional dependency).

Counterpart of `bioemu/src/bioemu/md_utils.py` + `sidechain_relax.py:116-246`:
amber99sb + TIP3P solvated system, backbone restraints, staged equilibration
(growing timesteps -> high-friction NVT -> NPT barostat), restraint ramp-down
and optional free MD. OpenMM is imported lazily; hosts without it get a clear
ImportError from :func:`require_openmm` while the rest of the package stays
importable.

Counterpart of ``se3diff_tpu/relax/md.py``. One difference: the simulation
runs on OpenMM's CUDA platform unless the caller asks for the CPU
(``device="cpu"``), and raises where that platform is missing; JAX's falls
back to OpenMM's default platform with a warning.
"""

from __future__ import annotations

import logging
import os
from enum import Enum

import numpy as np

logger = logging.getLogger(__name__)

# Fixed protocol constants (sidechain_relax.py:143-147).
INTEGRATOR_TIMESTEP_PS = 0.001
INIT_TIMESTEPS_PS = [1e-6, 1e-5, 1e-4]
TEMPERATURE_K = 300.0
CONSTRAINT_FORCE_CONST = 1000.0


class MDProtocol(str, Enum):
    """(sidechain_relax.py:38-41)"""

    LOCAL_MINIMIZATION = "local_minimization"
    MD_EQUIL = "md_equil"


def require_openmm():
    try:
        import openmm as mm
        import openmm.app as app
        import openmm.unit as u
    except ImportError as exc:
        raise ImportError(
            "OpenMM is required for MD relaxation but is not installed in "
            "this environment; install openmm or skip --md_equil."
        ) from exc
    return mm, app, u


def _add_oxt_to_terminus(topology, positions):
    """OXT heuristic on the C-terminus (md_utils.py:16-59)."""
    mm, app, u = require_openmm()
    new_topology = app.Topology()
    new_positions = []
    for chain in topology.chains():
        new_chain = new_topology.addChain(chain.id)
        last_id = list(chain.residues())[-1].id
        for residue in chain.residues():
            new_residue = new_topology.addResidue(residue.name, new_chain)
            for atom in residue.atoms():
                new_topology.addAtom(atom.name, atom.element, new_residue)
                new_positions.append(positions[atom.index])
            if residue.id == last_id:
                new_topology.addAtom("OXT", app.element.oxygen, new_residue)
                atom_positions = {a.name: positions[a.index] for a in residue.atoms()}
                d_ca_o = atom_positions["O"] - atom_positions["CA"]
                d_ca_c = atom_positions["C"] - atom_positions["CA"]
                d_ca_c /= u.sqrt(u.dot(d_ca_c, d_ca_c))
                v = d_ca_o - u.dot(d_ca_c, d_ca_o) * d_ca_c
                new_positions.append(atom_positions["O"] + 2 * v)
    new_topology.createStandardBonds()
    return new_topology, u.Quantity(new_positions)


def _is_protein_noh(atom) -> bool:
    """(md_utils.py:62-75)"""
    _, _, u = require_openmm()
    if atom.residue.name in ("HOH", "NA", "CL"):
        return False
    return atom.element.mass.value_in_unit(u.dalton) > 2.0


def _prepare_system(pdb_path: str, padding_nm: float = 1.0):
    """amber99sb + TIP3P solvated system from a heavy-atom PDB
    (md_utils.py:78-114)."""
    mm, app, u = require_openmm()
    pdb = app.PDBFile(pdb_path)
    topology, positions = _add_oxt_to_terminus(pdb.topology, pdb.positions)
    modeller = app.Modeller(topology, positions)
    modeller.addHydrogens()
    forcefield = app.ForceField("amber99sb.xml", "tip3p.xml")
    modeller.addSolvent(
        forcefield,
        padding=padding_nm * u.nanometers,
        ionicStrength=0.1 * u.molar,
        positiveIon="Na+",
        negativeIon="Cl-",
    )
    system = forcefield.createSystem(
        modeller.topology,
        nonbondedMethod=app.PME,
        nonbondedCutoff=1.0 * u.nanometers,
        constraints=app.HBonds,
        rigidWater=True,
    )
    return system, modeller


def _add_constraint_force(system, modeller, k: float) -> int:
    """Backbone position restraints (md_utils.py:117-140)."""
    mm, _, _ = require_openmm()
    force = mm.CustomExternalForce("k*periodicdistance(x, y, z, x0, y0, z0)^2")
    force.addGlobalParameter("k", k)
    for p in ("x0", "y0", "z0"):
        force.addPerParticleParameter(p)
    for atom in modeller.topology.atoms():
        if atom.name in ("C", "CA", "N", "O"):
            force.addParticle(atom.index, modeller.positions[atom.index])
    return system.addForce(force)


def _do_equilibration(
    simulation,
    integrator,
    init_timesteps_ps,
    integrator_timestep_ps,
    simtime_ns_nvt_equil,
    simtime_ns_npt_equil,
    temperature_K,
) -> None:
    """Staged equilibration (md_utils.py:143-195)."""
    mm, _, u = require_openmm()
    for ts in list(init_timesteps_ps) + [integrator_timestep_ps]:
        integrator.setStepSize(ts * u.picosecond)
        simulation.step(int(0.1 / ts))

    simulation.integrator.setFriction(10.0 / u.picoseconds)
    for _ in range(100):
        simulation.step(int(1000 * simtime_ns_nvt_equil / integrator_timestep_ps / 100))

    simulation.system.addForce(mm.MonteCarloBarostat(1 * u.bar, temperature_K))
    simulation.integrator.setFriction(1.0 / u.picoseconds)
    simulation.context.reinitialize(preserveState=True)
    for _ in range(100):
        simulation.step(int(1000 * simtime_ns_npt_equil / integrator_timestep_ps / 100))


def _switch_off_constraints(simulation, ext_force_id, integrator_timestep_ps, init_k):
    """Restraint ramp-down (md_utils.py:198-219)."""
    for k in [init_k / 10, 0]:
        if k > 0:
            simulation.context.setParameter("k", k)
        else:
            simulation.system.removeForce(ext_force_id)
        simulation.context.reinitialize(preserveState=True)
        simulation.step(int(10 / integrator_timestep_ps))


_PLATFORMS = {"cuda": "CUDA", "cpu": "CPU"}


def get_platform(device: str = "cuda"):
    """OpenMM's platform for ``device`` ("cuda" or "cpu"); raises where
    OpenMM has no such platform."""
    if device not in _PLATFORMS:
        raise ValueError(f"device must be one of {sorted(_PLATFORMS)}, not {device!r}")
    mm, _, _ = require_openmm()
    try:
        return mm.Platform.getPlatformByName(_PLATFORMS[device])
    except Exception as exc:
        raise RuntimeError(
            f"OpenMM has no {_PLATFORMS[device]} platform here"
            + ("; pass device='cpu' to run on the CPU" if device == "cuda" else "")
        ) from exc


def run_one_md(
    pdb_path: str,
    only_energy_minimization: bool = False,
    simtime_ns_nvt_equil: float = 0.1,
    simtime_ns_npt_equil: float = 0.4,
    simtime_ns: float = 0.0,
    outpath: str = ".",
    file_prefix: str = "",
    device: str = "cuda",
) -> tuple[np.ndarray, list[str]]:
    """Restraint-equilibrate one heavy-atom structure
    (sidechain_relax.py:116-211) on OpenMM's platform for ``device``.

    Returns heavy-atom positions (nm, [A, 3]) and their atom names.
    """
    mm, app, u = require_openmm()
    platform = get_platform(device)
    system, modeller = _prepare_system(pdb_path)
    ext_force_id = _add_constraint_force(system, modeller, CONSTRAINT_FORCE_CONST)

    integrator = mm.LangevinIntegrator(
        TEMPERATURE_K * u.kelvin, 200.0 / u.picoseconds,
        INIT_TIMESTEPS_PS[0] * u.picosecond,
    )
    integrator.setConstraintTolerance(1e-5)
    simulation = app.Simulation(modeller.topology, system, integrator, platform=platform)
    simulation.context.setPositions(modeller.positions)
    simulation.context.setVelocitiesToTemperature(TEMPERATURE_K * u.kelvin)
    simulation.context.applyConstraints(1e-7)

    idx = [a.index for a in modeller.topology.atoms() if _is_protein_noh(a)]
    names = [
        a.name for a in modeller.topology.atoms() if _is_protein_noh(a)
    ]

    simulation.minimizeEnergy()
    if not only_energy_minimization:
        _do_equilibration(
            simulation, integrator, INIT_TIMESTEPS_PS, INTEGRATOR_TIMESTEP_PS,
            simtime_ns_nvt_equil, simtime_ns_npt_equil,
            TEMPERATURE_K * u.kelvin,
        )

    positions = simulation.context.getState(positions=True).getPositions()

    if simtime_ns > 0.0:
        _switch_off_constraints(
            simulation, ext_force_id, INTEGRATOR_TIMESTEP_PS, CONSTRAINT_FORCE_CONST
        )
        from se3diff_torch.struct import xtc as xtcio

        traj_frames = []
        n_report = int(100 / INTEGRATOR_TIMESTEP_PS)
        n_total = int(1000 * simtime_ns / INTEGRATOR_TIMESTEP_PS)
        for _ in range(max(n_total // n_report, 1)):
            simulation.step(n_report)
            state = simulation.context.getState(positions=True)
            pos = np.asarray(state.getPositions().value_in_unit(u.nanometer))
            traj_frames.append(pos[idx])
        xtcio.write_xtc(
            os.path.join(outpath, f"{file_prefix}_md_traj.xtc"),
            np.asarray(traj_frames),
        )

    pos = np.asarray(positions.value_in_unit(u.nanometer))
    return pos[idx], names


def run_all_md(
    pdb_paths: list[str],
    md_protocol: MDProtocol,
    outpath: str,
    simtime_ns: float = 0.0,
    device: str = "cuda",
) -> list[np.ndarray]:
    """Per-frame MD with failure skipping (sidechain_relax.py:214-246)."""
    out = []
    for n, pdb_path in enumerate(pdb_paths):
        try:
            pos, _ = run_one_md(
                pdb_path,
                only_energy_minimization=md_protocol == MDProtocol.LOCAL_MINIMIZATION,
                simtime_ns=simtime_ns,
                outpath=outpath,
                file_prefix=f"frame{n}",
                device=device,
            )
            out.append(pos)
        except ValueError as err:
            logger.warning("Skipping sample %d for MD setup: %s", n, err)
    if not out:
        raise RuntimeError(
            "Could not create MD setups for given system. Try running MD "
            "setup on reconstructed samples manually."
        )
    return out
