"""Structure layer: frames <-> atom37, PDB and mmCIF I/O, native XTC codec, physics filter."""

from se3diff_torch.struct.atoms import (
    adjust_oxygen_pos,
    atom37_from_frames,
    atom37_mask,
    frames_from_atom37,
    frames_from_backbone,
    get_atom37_from_frames,
)
from se3diff_torch.struct.cif import from_cif_string, read_cif, to_modelcif, write_modelcif
from se3diff_torch.struct.pdb import Structure, from_pdb_string, read_pdb, to_pdb, write_pdb
from se3diff_torch.struct.physics import (
    filter_unphysical_masks,
    filter_unphysical_masks_device,
    get_physical_frame_indices,
)
from se3diff_torch.struct.residues import sequence_to_aatype

__all__ = [
    "Structure",
    "adjust_oxygen_pos",
    "atom37_from_frames",
    "atom37_mask",
    "frames_from_atom37",
    "frames_from_backbone",
    "get_atom37_from_frames",
    "from_cif_string",
    "from_pdb_string",
    "read_cif",
    "read_pdb",
    "to_modelcif",
    "to_pdb",
    "write_modelcif",
    "write_pdb",
    "filter_unphysical_masks",
    "filter_unphysical_masks_device",
    "get_physical_frame_indices",
    "sequence_to_aatype",
]
