"""The sidechain-relax subsystem of the PyTorch port, with mocked tools.

``tests/test_relax.py``'s cases against the port: hpacker never runs, its
subprocess is replaced by a fake that adds CB atoms, and the port's
reconstruction and CLI flow must give what the JAX package's give on the
same fake. OpenMM is not installed here: the port's ``run_one_md`` must
refuse a mocked OpenMM that has no CUDA platform when asked for the card,
and take the CPU platform when asked for the CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from se3diff_torch.relax import hpacker as hp
from se3diff_torch.relax import md
from se3diff_torch.struct.pdb import Structure, read_pdb, write_pdb
from se3diff_torch.struct.residues import ATOM37_C, ATOM37_CA, ATOM37_CB, ATOM37_N, ATOM37_O, RESTYPES
from se3diff_tpu.relax import hpacker as jax_hp


def _backbone_structure(n_frames: int, n_res: int, seed=0) -> Structure:
    rng = np.random.default_rng(seed)
    atom37 = np.zeros((n_frames, n_res, 37, 3), np.float32)
    mask = np.zeros((n_res, 37), bool)
    x = np.arange(n_res) * 3.8
    for k, a in enumerate([ATOM37_N, ATOM37_CA, ATOM37_C, ATOM37_O]):
        atom37[:, :, a, 0] = x + k * 0.8
        atom37[:, :, a, 1] = k * 0.5
        mask[:, a] = True
    atom37 += rng.standard_normal(atom37.shape) * 0.02
    aatype = np.asarray([RESTYPES.index("A")] * n_res)
    return Structure(atom37=atom37, mask=mask, aatype=aatype)


def _fake_hpacker(read, write, add_cb=True):
    def fake_run(pdb_in, pdb_out):
        struct = read(pdb_in)
        struct.mask[:, ATOM37_CB] = add_cb
        struct.atom37[:, :, ATOM37_CB] = struct.atom37[:, :, ATOM37_CA] + 1.0
        write(struct, pdb_out)

    return fake_run


class TestHPackerAdapter:
    def test_reconstruct_sidechains_mocked_matches_jax(self, monkeypatch):
        from se3diff_tpu.struct.pdb import read_pdb as jax_read, write_pdb as jax_write

        monkeypatch.setattr(hp, "run_hpacker", _fake_hpacker(read_pdb, write_pdb))
        monkeypatch.setattr(jax_hp, "run_hpacker", _fake_hpacker(jax_read, jax_write))
        struct = _backbone_structure(3, 8)
        frames = hp.reconstruct_sidechains(struct)
        want = jax_hp.reconstruct_sidechains(struct)
        assert len(frames) == len(want) == 3
        assert all(f.mask[:, ATOM37_CB].all() for f in frames)
        for f, w in zip(frames, want):
            np.testing.assert_array_equal(f.mask, w.mask)
            np.testing.assert_array_equal(f.atom37, w.atom37)

    def test_topology_mismatch_skipped(self, monkeypatch):
        calls = {"n": 0}

        def fake_run(pdb_in, pdb_out):
            struct = read_pdb(pdb_in)
            if calls["n"] == 1:  # the second frame gets extra CB atoms
                struct.mask[:, ATOM37_CB] = True
                struct.atom37[:, :, ATOM37_CB] = struct.atom37[:, :, ATOM37_CA] + 1.0
            calls["n"] += 1
            write_pdb(struct, pdb_out)

        monkeypatch.setattr(hp, "run_hpacker", fake_run)
        assert len(hp.reconstruct_sidechains(_backbone_structure(3, 8))) == 2

    def test_missing_python_raises(self, monkeypatch):
        monkeypatch.setenv("HPACKER_PYTHONBIN", "/nonexistent/python")
        with pytest.raises(FileNotFoundError, match="hpacker python"):
            hp.run_hpacker("in.pdb", "out.pdb")


def _fake_openmm(platforms):
    """An OpenMM stand-in whose only platforms are ``platforms``."""

    def get(name):
        if name not in platforms:
            raise Exception(f"There is no registered Platform called \"{name}\"")
        return SimpleNamespace(name=name)

    mm = SimpleNamespace(Platform=SimpleNamespace(getPlatformByName=get))
    return mm, SimpleNamespace(), SimpleNamespace()


class TestMDGating:
    def test_openmm_gate(self):
        try:
            import openmm  # noqa: F401

            have = True
        except ImportError:
            have = False
        if have:
            md.require_openmm()
        else:
            with pytest.raises(ImportError, match="OpenMM"):
                md.require_openmm()

    def test_protocol_enum(self):
        assert md.MDProtocol("local_minimization") == md.MDProtocol.LOCAL_MINIMIZATION
        assert md.MDProtocol("md_equil") == md.MDProtocol.MD_EQUIL

    def test_run_one_md_on_cuda_refuses_openmm_without_cuda(self, monkeypatch):
        monkeypatch.setattr(md, "require_openmm", lambda: _fake_openmm({"CPU", "Reference"}))
        prepared = []
        monkeypatch.setattr(md, "_prepare_system", lambda *a, **k: prepared.append(a))
        with pytest.raises(RuntimeError, match="no CUDA platform"):
            md.run_one_md("frame.pdb", device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA platform"):
            md.run_all_md(["frame.pdb"], md.MDProtocol.LOCAL_MINIMIZATION, outpath=".")
        assert not prepared  # refused before any system was built

    def test_platform_by_device(self, monkeypatch):
        monkeypatch.setattr(md, "require_openmm", lambda: _fake_openmm({"CPU", "CUDA"}))
        assert md.get_platform("cuda").name == "CUDA"
        assert md.get_platform("cpu").name == "CPU"
        with pytest.raises(ValueError, match="device"):
            md.get_platform("tpu")


class TestCLIPipeline:
    def test_sidechain_only_flow(self, monkeypatch, tmp_path):
        """Full CLI flow with mocked hpacker, no MD."""
        from se3diff_torch import sidechain_relax as cli
        from se3diff_torch.struct import xtc as xtcio

        monkeypatch.setattr(hp, "run_hpacker", _fake_hpacker(read_pdb, write_pdb))
        struct = _backbone_structure(2, 8)
        top_path = tmp_path / "topology.pdb"
        write_pdb(Structure(atom37=struct.atom37[:1], mask=struct.mask, aatype=struct.aatype),
                  str(top_path))
        xtcio.write_xtc(str(tmp_path / "samples.xtc"), struct.atom37[:, struct.mask] / 10.0)

        cli.main(["--xtc_path", str(tmp_path / "samples.xtc"), "--pdb_path", str(top_path),
                  "--no-md_equil", "--outpath", str(tmp_path)])
        assert (tmp_path / "samples_sidechain_rec.pdb").exists()
        rec = xtcio.read_xtc(str(tmp_path / "samples_sidechain_rec.xtc"))[0]
        assert rec.shape == (2, 8 * 5, 3)  # N, CA, C, O + CB added by the fake

    def test_md_flow_passes_the_device(self, monkeypatch, tmp_path):
        """With MD on, the CLI's ``--device`` reaches ``run_one_md``."""
        from se3diff_torch import sidechain_relax as cli
        from se3diff_torch.struct import xtc as xtcio

        monkeypatch.setattr(hp, "run_hpacker", _fake_hpacker(read_pdb, write_pdb))
        seen = []

        def fake_md(pdb_path, **kw):
            seen.append(kw["device"])
            frame = read_pdb(pdb_path)
            return frame.atom37[0][frame.mask.astype(bool)] / 10.0, []

        monkeypatch.setattr(md, "run_one_md", fake_md)
        struct = _backbone_structure(2, 8)
        top_path = tmp_path / "topology.pdb"
        write_pdb(Structure(atom37=struct.atom37[:1], mask=struct.mask, aatype=struct.aatype),
                  str(top_path))
        xtcio.write_xtc(str(tmp_path / "samples.xtc"), struct.atom37[:, struct.mask] / 10.0)
        cli.main(["--xtc_path", str(tmp_path / "samples.xtc"), "--pdb_path", str(top_path),
                  "--outpath", str(tmp_path), "--device", "cpu"])
        assert seen == ["cpu", "cpu"]
        assert xtcio.read_xtc(str(tmp_path / "samples_md_equil.xtc"))[0].shape == (2, 40, 3)
