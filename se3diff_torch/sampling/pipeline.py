"""End-to-end sampling pipeline: sequence -> conformational ensemble files.

Counterpart of ``se3diff_tpu/sampling/pipeline.py`` (reference
`bioemu/src/bioemu/sample.py`):

1. parse/validate the sequence and fetch its (cached) Evoformer embeddings,
2. pick a batch size with the quadratic heuristic
   ``batch_size_100 * (100/L)^2`` (sample.py:279),
3. run resumable batches: existing ``batch_{start:07d}_{end:07d}.npz``
   files are counted and sampling continues with seed = start index
   (sample.py:285-308),
4. denoise each batch on the bundle's device, then frames -> backbone
   atom37 -> physicality filter on the device,
5. write ``topology.pdb`` + ``samples.xtc`` (or a multi-model
   ``samples.pdb`` when the native XTC codec is unavailable).

The conditioning is copied to the device once per run. The batch loop is
double-buffered: batch N's device chain is enqueued, its results are copied
to pinned host memory behind an event, and the host finalises batch N-1
while the device works on N.

With a sequence-parallel bundle (``bundle.sp``) every rank runs the same
batches with the same seeds and ends each with the same samples. Rank 0
stages the embeddings and writes every output file; the others write
nothing and read the embeddings only after a barrier, so never from a
half-written cache.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from se3diff_torch.sampling.bundle import Bundle
from se3diff_torch.sampling.embeds import get_embeds, load_embeds
from se3diff_torch.sampling.seq_io import check_protein_valid, parse_sequence
from se3diff_torch.struct.atoms import atom37_from_frames, atom37_mask
from se3diff_torch.struct.pdb import Structure, write_pdb
from se3diff_torch.struct.physics import filter_unphysical_masks_device
from se3diff_torch.struct.residues import sequence_to_aatype

logger = logging.getLogger(__name__)


def format_npz_samples_filename(start_id: int, num_samples: int) -> str:
    """``batch_{start:07d}_{end:07d}.npz`` (utils.py:13-16)."""
    return f"batch_{start_id:07d}_{start_id + num_samples:07d}.npz"


def count_samples_in_output_dir(output_dir: Path) -> int:
    """Total samples across existing batch files (utils.py:19-28)."""
    return sum(
        int(pair[1]) - int(pair[0])
        for p in Path(output_dir).glob("batch_*.npz")
        for pair in [p.stem.split("_")[1:]]
    )


def batch_size_heuristic(batch_size_100: int, seq_len: int) -> int:
    """Quadratic memory heuristic with a floor of 1 (sample.py:279-282)."""
    batch = int(batch_size_100 * (100 / seq_len) ** 2)
    if batch == 0:
        logger.warning("Sequence length %d is very large; using batch_size=1.", seq_len)
        batch = 1
    return batch


def round_to_bucket(length: int, bucket: int) -> int:
    """Smallest multiple of ``bucket`` >= length."""
    return -(-length // bucket) * bucket


def stage_conditioning(
    single: np.ndarray,
    pair: np.ndarray,
    device: torch.device,
    length_bucket: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, int]:
    """Copy the batch-invariant conditioning to ``device`` once, padding it to
    a bucket multiple (with a residue mask) when ``length_bucket`` is set.

    Returns ``(single_d, pair_d, mask_d_or_None, true_len)``.
    """
    L = single.shape[0]
    single_d = torch.from_numpy(np.array(single, np.float32)).to(device)
    pair_d = torch.from_numpy(np.array(pair, np.float32)).to(device)
    if length_bucket:
        pad = round_to_bucket(L, length_bucket) - L
        single_d = torch.nn.functional.pad(single_d, (0, 0, 0, pad))
        pair_d = torch.nn.functional.pad(pair_d, (0, 0, 0, pad, 0, pad))
        mask = torch.zeros(L + pad, dtype=torch.bool, device=device)
        mask[:L] = True
        return single_d, pair_d, mask, L
    return single_d, pair_d, None, L


def _dispatch_batch(
    bundle: Bundle, single_d, pair_d, mask_d, true_len: int, seed: int, batch_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue one denoise batch on the staged conditioning (no host sync)."""
    run = bundle.sampler(batch_size, single_d.shape[0])
    generator = torch.Generator(device=bundle.device).manual_seed(seed)
    pos, rot = run(generator, single_d, pair_d, mask_d)
    return pos[:, :true_len], rot[:, :true_len]


def generate_batch(
    bundle: Bundle,
    single: np.ndarray,
    pair: np.ndarray,
    seed: int,
    batch_size: int,
    length_bucket: int | None = None,
) -> dict[str, np.ndarray]:
    """Denoise one batch on the bundle's device; returns ``{"pos" [B, L, 3],
    "node_orientations" [B, L, 3, 3]}`` as numpy (sample.py:186-238).
    ``length_bucket`` pads L up to a bucket multiple with masked residues,
    as :func:`sample` does."""
    pos, rot = generate_batch_async(bundle, single, pair, seed, batch_size, length_bucket)
    return {"pos": pos.cpu().numpy(), "node_orientations": rot.cpu().numpy()}


def generate_batch_async(
    bundle: Bundle,
    single: np.ndarray,
    pair: np.ndarray,
    seed: int,
    batch_size: int,
    length_bucket: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`stage_conditioning` and one enqueued denoise batch: the device
    tensors ``(pos, rot)``, not synchronised. A loop stages once and
    dispatches each batch instead; this stages the conditioning every call."""
    single_d, pair_d, mask_d, L = stage_conditioning(single, pair, bundle.device, length_bucket)
    with torch.inference_mode():
        return _dispatch_batch(bundle, single_d, pair_d, mask_d, L, seed, batch_size)


def _to_host_async(*tensors: torch.Tensor):
    """Start device->host copies (pinned, non-blocking on CUDA); returns the
    host tensors and an event to wait on (None on the CPU)."""
    host = tuple(t.to("cpu", non_blocking=True) for t in tensors)
    if tensors[0].device.type != "cuda":
        return host, None
    event = torch.cuda.Event()
    event.record()
    return host, event


def sample(
    sequence: str,
    num_samples: int,
    output_dir: str,
    bundle: Bundle,
    batch_size_100: int = 10,
    cache_embeds_dir: str | None = None,
    embeds_backend: str = "colabfold",
    msa_file: str | None = None,
    msa_host_url: str | None = None,
    filter_samples: bool = True,
    length_bucket: int | None = None,
    batch_size: int | None = None,
) -> Path:
    """Sample a conformational ensemble for ``sequence`` (sample.py:241-327).

    Resumable: re-running with the same ``output_dir`` continues from the
    existing batch files (seed = start index). ``batch_size`` overrides the
    ``batch_size_100`` heuristic with an exact per-batch count. Logs a
    stage/loop/write wall breakdown at debug level. Under SP only rank 0
    writes; every rank returns ``output_dir``.
    """
    sp = bundle.sp
    writer = sp is None or sp.rank == 0
    out = Path(output_dir)
    seq = parse_sequence(sequence)
    check_protein_valid(seq)
    L = len(seq)
    # Counted by every rank before any rank can write.
    existing = count_samples_in_output_dir(out)

    def embeds():
        return get_embeds(
            seq, cache_embeds_dir, backend=embeds_backend,
            msa_file=msa_file, msa_host_url=msa_host_url,
        )

    if writer:
        out.mkdir(parents=True, exist_ok=True)
        single_file, pair_file = embeds()
    if sp is not None:
        dist.barrier(group=sp.group)
    if not writer:
        single_file, pair_file = embeds()
    single, pair = load_embeds(single_file, pair_file)

    if batch_size is None:
        batch_size = batch_size_heuristic(batch_size_100, L)
    elif batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")

    if existing >= num_samples:
        logger.info("Found %d samples >= requested %d; skipping.", existing, num_samples)

    aatype = sequence_to_aatype(seq)
    mask = atom37_mask(aatype)
    device = bundle.device

    # Resume: convert pre-existing batch files first so the trajectory
    # keeps batch order.
    kept_chunks: list[np.ndarray] = []
    total = 0
    for f in sorted(out.glob("batch_*.npz")) if writer else ():
        total += _append_npz_chunk(kept_chunks, f, seq, aatype, mask, filter_samples, device)

    t0 = time.perf_counter()
    single_d, pair_d, mask_d, true_len = stage_conditioning(single, pair, device, length_bucket)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_stage = time.perf_counter()

    pending = None
    for start in range(existing, num_samples, batch_size):
        n = min(batch_size, num_samples - start)
        logger.info("Sampling batch %d..%d", start, start + n)
        with torch.inference_mode():
            pos_d, rot_d = _dispatch_batch(
                bundle, single_d, pair_d, mask_d, true_len, seed=start, batch_size=n
            )
            if not writer:
                continue
            atom37_d, _ = atom37_from_frames(pos_d, rot_d, aatype)
            outputs = (pos_d, rot_d, atom37_d)
            if filter_samples:
                outputs += (filter_unphysical_masks_device(atom37_d, mask),)
            host, event = _to_host_async(*outputs)
        if pending is not None:
            total += _finalize_batch(out, seq, mask, kept_chunks, *pending)
        pending = (start, n, host, event)
    if pending is not None:
        total += _finalize_batch(out, seq, mask, kept_chunks, *pending)

    t_loop = time.perf_counter()
    if not writer:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out
    result = _write_ensemble(out, seq, aatype, mask, kept_chunks, total, filter_samples)
    logger.debug(
        "wall breakdown: stage=%.2fs loop=%.2fs write=%.2fs",
        t_stage - t0, t_loop - t_stage, time.perf_counter() - t_loop,
    )
    return result


def _finalize_batch(
    out: Path, seq: str, mask: np.ndarray, kept_chunks: list,
    start: int, n: int, host: tuple, event,
) -> int:
    """Host tail for one sampled batch: npz write + kept-frame centering."""
    if event is not None:
        event.synchronize()
    pos, rot, atom37 = (t.numpy() for t in host[:3])
    np.savez(
        out / format_npz_samples_filename(start, n),
        sequence=seq, pos=pos, node_orientations=rot,
    )
    chunk = atom37[host[3].numpy()] if len(host) > 3 else atom37
    _append_centered(kept_chunks, chunk, mask)
    return n


def _append_centered(kept_chunks: list, chunk: np.ndarray, mask: np.ndarray) -> None:
    if not len(chunk):
        return
    # Center each frame (convert_chemgraph.py:430-436).
    flat_mask = mask.reshape(-1).astype(bool)
    coords = chunk.reshape(len(chunk), -1, 3)
    center = coords[:, flat_mask].mean(axis=1, keepdims=True)
    kept_chunks.append((coords - center).reshape(chunk.shape))


def _append_npz_chunk(
    kept_chunks: list, path: Path, sequence: str, aatype: np.ndarray,
    mask: np.ndarray, filter_samples: bool, device: torch.device,
) -> int:
    """Convert one saved batch file -> centred kept frames; returns its frame count."""
    with np.load(path) as data:
        if str(data["sequence"]) != sequence:
            raise ValueError(f"{path} holds samples of another sequence")
        pos = torch.from_numpy(data["pos"]).to(device)
        rot = torch.from_numpy(data["node_orientations"]).to(device)
    atom37_d, _ = atom37_from_frames(pos, rot, aatype)
    chunk = atom37_d
    if filter_samples:
        chunk = atom37_d[filter_unphysical_masks_device(atom37_d, mask)]
    _append_centered(kept_chunks, chunk.cpu().numpy(), mask)
    return pos.shape[0]


def _write_ensemble(
    output_dir: Path, sequence: str, aatype: np.ndarray, mask: np.ndarray,
    kept_chunks: list, total: int, filter_samples: bool,
) -> Path:
    """Centred kept frames -> topology.pdb + samples.xtc (or samples.pdb)."""
    kept = sum(len(c) for c in kept_chunks)
    if filter_samples:
        logger.info("Physicality filter kept %d / %d frames", kept, total)
    if kept == 0:
        raise RuntimeError("all sampled frames were filtered out as unphysical")

    write_pdb(
        Structure(atom37=kept_chunks[0][:1], mask=mask, aatype=aatype),
        str(output_dir / "topology.pdb"),
    )

    from se3diff_torch.struct import xtc

    mask_b = mask.astype(bool)
    traj_coords = np.concatenate([c[:, mask_b] for c in kept_chunks])  # [M, A, 3] Angstrom
    xtc_path = output_dir / "samples.xtc"
    try:
        xtc.write_xtc(str(xtc_path), traj_coords / 10.0)  # nm
        logger.info("Wrote %s", xtc_path)
    except xtc.XTCUnavailableError:
        pdb_path = output_dir / "samples.pdb"
        write_pdb(
            Structure(atom37=np.concatenate(kept_chunks), mask=mask, aatype=aatype),
            str(pdb_path),
        )
        logger.warning("native XTC codec unavailable; wrote %s instead", pdb_path)
    return output_dir


def write_structure_outputs(
    output_dir: str | Path, sequence: str, filter_samples: bool = True,
    device: str | torch.device = "cuda",
) -> Path:
    """Every batch file in ``output_dir`` -> ``topology.pdb`` + trajectory
    (sample.py:310-327, convert_chemgraph.py:398-458), one file at a time:
    frames -> atom37 and the physicality filter on ``device``, the kept
    frames centred on the host. :func:`sample` does this inline; this
    re-derives the outputs from saved batches (the same files)."""
    from se3diff_torch.sampling.bundle import resolve_device

    output_dir, device = Path(output_dir), resolve_device(device)
    aatype = sequence_to_aatype(sequence)
    mask = atom37_mask(aatype)
    kept_chunks: list[np.ndarray] = []
    total = 0
    for f in sorted(output_dir.glob("batch_*.npz")):
        total += _append_npz_chunk(kept_chunks, f, sequence, aatype, mask, filter_samples, device)
    return _write_ensemble(output_dir, sequence, aatype, mask, kept_chunks, total, filter_samples)
