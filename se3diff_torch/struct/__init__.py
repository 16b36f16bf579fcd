"""Structure layer: frames <-> atom37, PDB I/O, native XTC codec, physics filter."""

from se3diff_torch.struct.atoms import (
    adjust_oxygen_pos,
    atom37_from_frames,
    atom37_mask,
    frames_from_atom37,
    frames_from_backbone,
)
from se3diff_torch.struct.pdb import Structure, from_pdb_string, read_pdb, to_pdb, write_pdb
from se3diff_torch.struct.physics import (
    filter_unphysical_masks,
    filter_unphysical_masks_device,
)
from se3diff_torch.struct.residues import sequence_to_aatype

__all__ = [
    "Structure",
    "adjust_oxygen_pos",
    "atom37_from_frames",
    "atom37_mask",
    "frames_from_atom37",
    "frames_from_backbone",
    "from_pdb_string",
    "read_pdb",
    "to_pdb",
    "write_pdb",
    "filter_unphysical_masks",
    "filter_unphysical_masks_device",
    "sequence_to_aatype",
]
