"""Minimal ModelCIF write / mmCIF read for atom37 structures.

A copy of ``se3diff_tpu/struct/cif.py`` (host code, numpy only) on the
port's :class:`~se3diff_torch.struct.pdb.Structure`; both write the same
text. Counterpart of the reference's modelcif export
(`openfold/np/protein.py:396-533`, via the `modelcif` package) and its
biotite-based ``.cif`` reference-structure loading (`observables.py:417-432`).
Neither package is a dependency, so both directions are
implemented directly against the format:

* :func:`to_modelcif` emits a single-entity ModelCIF document — entity /
  entity_poly / entity_poly_seq / struct_asym groups, per-residue +
  global pLDDT QA metrics from the structure's b-factors (mirroring the
  reference's _LocalPLDDT/_GlobalPLDDT classes), and the ``_atom_site``
  loop (one ``pdbx_PDB_model_num`` per model for multi-model ensembles).
* :func:`from_cif_string` parses the ``_atom_site`` loop of arbitrary
  mmCIF/ModelCIF/PDBx files by header name (column order independent).
"""

from __future__ import annotations

import io

import numpy as np

from se3diff_torch.struct.pdb import Structure
from se3diff_torch.struct.residues import (
    ATOM37_ELEMENTS,
    ATOM37_NAMES,
    RESTYPE_1TO3,
    RESTYPE_3TO1,
    RESTYPES,
)

_ATOM_SITE_COLUMNS = [
    "group_PDB", "id", "type_symbol", "label_atom_id", "label_alt_id",
    "label_comp_id", "label_asym_id", "label_entity_id", "label_seq_id",
    "auth_seq_id", "pdbx_PDB_ins_code", "Cartn_x", "Cartn_y", "Cartn_z",
    "occupancy", "B_iso_or_equiv", "auth_asym_id", "pdbx_PDB_model_num",
]


def to_modelcif(struct: Structure, title: str = "se3diff-tpu prediction") -> str:
    """Serialize a :class:`Structure` to ModelCIF text."""
    out = io.StringIO()
    seq3 = [RESTYPE_1TO3[RESTYPES[i]] for i in struct.aatype]
    chain = struct.chain_id or "A"
    bfac = (
        struct.bfactor
        if struct.bfactor is not None
        else np.zeros(struct.num_residues, np.float32)
    )

    out.write("data_model\n")
    out.write("_entry.id model\n")
    out.write(f"_struct.title '{title}'\n")
    out.write("#\n")

    out.write("_entity.id 1\n_entity.type polymer\n"
              "_entity.pdbx_description 'Model subunit'\n#\n")
    one_letter = "".join(RESTYPES[i] for i in struct.aatype)
    out.write("_entity_poly.entity_id 1\n"
              "_entity_poly.type 'polypeptide(L)'\n"
              f"_entity_poly.pdbx_seq_one_letter_code {one_letter}\n#\n")
    out.write("loop_\n_entity_poly_seq.entity_id\n_entity_poly_seq.num\n"
              "_entity_poly_seq.mon_id\n")
    for i, res3 in enumerate(seq3):
        out.write(f"1 {int(struct.resseq[i])} {res3}\n")
    out.write("#\n")
    out.write(f"_struct_asym.id {chain}\n_struct_asym.entity_id 1\n"
              f"_struct_asym.details 'Model subunit {chain}'\n#\n")

    # QA metrics: per-residue + global pLDDT from b-factors
    # (protein.py:465-533).
    out.write("loop_\n_ma_qa_metric.id\n_ma_qa_metric.name\n"
              "_ma_qa_metric.mode\n_ma_qa_metric.type\n")
    out.write("1 pLDDT local pLDDT\n2 pLDDT global pLDDT\n#\n")
    out.write("loop_\n_ma_qa_metric_local.label_asym_id\n"
              "_ma_qa_metric_local.label_seq_id\n"
              "_ma_qa_metric_local.label_comp_id\n"
              "_ma_qa_metric_local.metric_id\n"
              "_ma_qa_metric_local.metric_value\n")
    for i, res3 in enumerate(seq3):
        out.write(f"{chain} {int(struct.resseq[i])} {res3} 1 {float(bfac[i]):.2f}\n")
    out.write("#\n")
    out.write("_ma_qa_metric_global.metric_id 2\n"
              f"_ma_qa_metric_global.metric_value {float(np.mean(bfac)):.2f}\n#\n")

    out.write("loop_\n_ma_model_list.ordinal_id\n_ma_model_list.model_id\n"
              "_ma_model_list.model_group_id\n_ma_model_list.model_name\n"
              "_ma_model_list.model_group_name\n_ma_model_list.model_type\n")
    for m in range(struct.num_models):
        out.write(f"{m + 1} {m + 1} 1 'Model {m + 1}' 'All models' "
                  "'Ab initio model'\n")
    out.write("#\n")

    out.write("loop_\n")
    for col in _ATOM_SITE_COLUMNS:
        out.write(f"_atom_site.{col}\n")
    serial = 1
    for m in range(struct.num_models):
        for i in range(struct.num_residues):
            for a in range(37):
                if not struct.mask[i, a]:
                    continue
                x, y, z = struct.atom37[m, i, a]
                out.write(
                    f"ATOM {serial} {ATOM37_ELEMENTS[a].strip()} "
                    f"{ATOM37_NAMES[a]} . {seq3[i]} {chain} 1 "
                    f"{int(struct.resseq[i])} {int(struct.resseq[i])} ? "
                    f"{x:.3f} {y:.3f} {z:.3f} 1.00 {float(bfac[i]):.2f} "
                    f"{chain} {m + 1}\n"
                )
                serial += 1
    out.write("#\n")
    return out.getvalue()


def write_modelcif(struct: Structure, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_modelcif(struct))


def _tokenize_cif_line(line: str) -> list[str]:
    """Split a CIF data line into tokens, honoring ' and \" quoting."""
    tokens, i, n = [], 0, len(line)
    while i < n:
        while i < n and line[i] in " \t":
            i += 1
        if i >= n:
            break
        if line[i] in "'\"":
            quote = line[i]
            j = line.find(quote, i + 1)
            j = n if j == -1 else j
            tokens.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


_ATOM37_INDEX = {n: i for i, n in enumerate(ATOM37_NAMES)}


def from_cif_string(text: str, chain_id: str | None = None) -> Structure:
    """Parse the ``_atom_site`` loop of an mmCIF document into a Structure.

    Columns are resolved by header name, so any writer's column order works.
    ``chain_id=None`` keeps the first chain encountered (matching
    :func:`se3diff_torch.struct.pdb.from_pdb_string` semantics). Waters/hetero
    rows (non-ATOM group_PDB) and non-atom37 atoms are skipped.
    """
    lines = text.splitlines()
    header: list[str] = []
    rows: list[list[str]] = []
    in_loop = in_atom_site = False
    for line in lines:
        s = line.strip()
        if s.startswith("loop_"):
            in_loop, in_atom_site, header = True, False, []
            continue
        if in_loop and s.startswith("_atom_site."):
            header.append(s.split(".", 1)[1].split()[0])
            in_atom_site = True
            continue
        if in_atom_site:
            if not s or s.startswith(("#", "_", "loop_", "data_")):
                in_loop = in_atom_site = False
                continue
            tok = _tokenize_cif_line(s)
            if len(tok) == len(header):
                rows.append(tok)
        elif in_loop and s.startswith("_"):
            in_loop = False  # some other loop's header

    if not rows:
        raise ValueError("no _atom_site loop found in CIF input")
    col = {name: k for k, name in enumerate(header)}

    def get(row, name, default=None):
        k = col.get(name)
        return row[k] if k is not None else default

    # models keyed by pdbx_PDB_model_num; residues keyed by auth_seq_id
    chosen_chain = chain_id
    models: dict[str, dict] = {}
    res_order: list[int] = []
    res_info: dict[int, str] = {}
    for row in rows:
        if get(row, "group_PDB", "ATOM") != "ATOM":
            continue
        ch = get(row, "auth_asym_id") or get(row, "label_asym_id") or "A"
        if chosen_chain is None:
            chosen_chain = ch
        if ch != chosen_chain:
            continue
        comp = get(row, "label_comp_id", "UNK")
        if comp not in RESTYPE_3TO1:
            continue
        atom = get(row, "label_atom_id", "")
        slot = _ATOM37_INDEX.get(atom)
        if slot is None:
            continue
        # mmCIF placeholders '.'/'?' are truthy strings: normalize them
        # away before picking a residue number.
        def _val(*names):
            for n in names:
                v = get(row, n)
                if v not in (None, "", ".", "?"):
                    return v
            return None

        seqid_raw = _val("auth_seq_id", "label_seq_id")
        if seqid_raw is None:
            continue
        seqid = int(seqid_raw)
        model_num = _val("pdbx_PDB_model_num") or "1"
        xyz = (float(get(row, "Cartn_x")), float(get(row, "Cartn_y")),
               float(get(row, "Cartn_z")))
        if seqid not in res_info:
            res_info[seqid] = comp
            res_order.append(seqid)
        models.setdefault(model_num, {})[(seqid, slot)] = xyz

    n_res = len(res_order)
    model_keys = sorted(models, key=lambda k: int(k) if k.isdigit() else 0)
    atom37 = np.zeros((len(model_keys), n_res, 37, 3), np.float32)
    mask = np.zeros((n_res, 37), bool)
    index_of = {seqid: i for i, seqid in enumerate(res_order)}
    for mi, mk in enumerate(model_keys):
        for (seqid, slot), xyz in models[mk].items():
            atom37[mi, index_of[seqid], slot] = xyz
            mask[index_of[seqid], slot] = True
    aatype = np.array(
        [RESTYPES.index(RESTYPE_3TO1[res_info[s]]) for s in res_order], np.int32
    )
    return Structure(
        atom37=atom37, mask=mask, aatype=aatype,
        chain_id=chosen_chain or "A",
        resseq=np.asarray(res_order, np.int32),
    )


def read_cif(path: str, chain_id: str | None = None) -> Structure:
    with open(path) as f:
        return from_cif_string(f.read(), chain_id=chain_id)
