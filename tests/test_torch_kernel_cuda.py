"""The IPA attention kernels on the card, against their plain version, at 32
heads (the score model, Cp=256), 4 heads (the PPFT control net, Cp=32) and 8
and 16 heads, with the pair bias streamed (``pa``) or computed in the kernel
(``w_pb``); and the tensor-core designs (streamed ``pa``: at 32 heads route
"tc" in bf16 and "tc_f32" in f32, at 16 heads, a tensor-parallel rank's at
``--mesh model=2``, "tc16" and "tc16_f32", at 8 heads, a rank's at
``--mesh model=4``, "tc8" and "tc8_f32"), the 32-head in-kernel designs
(``w_pb``: "tc_pb" in bf16, "tc_pb_f32" in f32) and the 4-head in-kernel design (route "h4": f32,
``w_pb``, the PPFT control net) against the plain version and against the
CUDA-core design on the same inputs; and the backward kernel (streamed
``pa`` at 32 heads: route "bwd_tc" in bf16, "bwd_tc_f32" in f32; at 16
heads "bwd_tc16" and "bwd_tc16_f32"; at 8 heads "bwd_tc8" and
"bwd_tc8_f32") against
the PyTorch backward ``ipa_attention_backward`` and against itself, bit for
bit, on a second call (the 8-head column kernel's row split too); and the backward kernel at the PPFT control net's
widths (route "bwd_h4": f32, 4 heads, ``w_pb``) against autograd of the
plain version and against itself.

These tests need an NVIDIA GPU (sm_90a) and nvcc; elsewhere they skip. They
import neither JAX nor the JAX package, so a machine with only PyTorch runs
them with ``python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py``.

Tolerances, relative to max|plain| (at least 1): f32 2e-4 (same products,
summed in another order across online-softmax tiles; "tc_f32" carries each
x2d and w_pv product to about 2^-22 of it by 3xTF32, "h4" sums in f32 on
CUDA cores); bf16 3e-2 (outputs
round to bf16 at 2^-8, and the kernel rounds the tile's unnormalised
probabilities where the plain version rounds normalised ones).
"""

import numpy as np
import pytest
import torch

from se3diff_torch.ops import ipa_attention as k1

DK = 16
KW = dict(scalar_w=1 / np.sqrt(3 * DK), pair_w=1 / np.sqrt(3))
NAMES = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa", "w_pb")
# (heads, Cp, pair-bias variant)
SHAPES = [(32, 256, "pa"), (32, 256, "w_pb"), (4, 32, "pa"), (4, 32, "w_pb"),
          (8, 64, "pa"), (8, 64, "w_pb"), (16, 128, "pa"), (16, 128, "w_pb"), (16, 256, "pa")]
# Shapes of the tensor-core routes: the ragged cases above, an SP slab of 150
# rows of 300 columns, and the PPFT score model's batch.
TC_CASES = [(3, 37, 37, 5), (2, 5, 70, 0), (1, 1, 1, 0), (2, 33, 33, 33), (4, 150, 300, 0),
            (256, 56, 56, 0)]
# Shapes of the "h4" route: the control net's batch on all rows, a smaller
# batch, L=57 with masked columns (ragged row and column tiles), a 28-row
# slab of 56 columns, and the ragged cases of the other routes.
H4_CASES = [(256, 56, 56, 0), (64, 56, 56, 0), (256, 57, 57, 5), (256, 28, 56, 0), (3, 37, 37, 5),
            (2, 5, 70, 0), (1, 1, 1, 0), (2, 33, 100, 0)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _args(device, B, Lq, Lk, dtype, masked_cols, seed=0, H=32, CP=256, variant="pa"):
    """The eleven operands of ``ipa_attention``: ``pa`` or ``w_pb`` is None."""
    rng = np.random.default_rng(seed)

    def g(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(device)

    bias = torch.zeros(B, Lk, device=device)
    if masked_cols:
        bias[:, -masked_cols:] = k1.NEG_INF
    return (
        g(B, H, Lq, DK).to(dtype), g(B, H, Lk, DK).to(dtype), g(B, H, Lk, DK).to(dtype),
        g(B, 3, H * 4, Lq, scale=0.3), g(B, 3, H * 4, Lk, scale=0.3), g(B, H, Lk, 24),
        g(B, Lq, Lk, CP, scale=0.5).to(dtype), g(H, CP, DK, scale=0.06).to(dtype), bias,
        g(B, H, Lq, Lk).to(dtype) if variant == "pa" else None,
        g(CP, H, scale=0.1) if variant == "w_pb" else None,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("H,CP,variant", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,Lq,Lk,masked", [
    (3, 37, 37, 5),     # ragged square, masked columns
    (2, 5, 70, 0),      # rows != columns, a partial last column tile
    (1, 1, 1, 0),       # one row, one column
    (2, 33, 33, 33),    # every column masked: the softmax is uniform
])
def test_kernel_matches_plain_on_the_card(cuda_device, dtype, tol, B, Lq, Lk, masked, H, CP,
                                          variant):
    args = _args(cuda_device, B, Lq, Lk, dtype, masked, H=H, CP=CP, variant=variant)
    before, by_variant = k1.launches, k1.launches_by_variant[variant]
    got = k1.ipa_attention(*args, **KW)
    torch.cuda.synchronize()
    assert k1.launches == before + 1 and k1.launches_by_variant[variant] == by_variant + 1
    want = k1.ipa_attention_plain(*args, **KW)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("H,CP,variant", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0**-8 + 1e-4)])
def test_gradients_on_the_card_match_autograd_of_plain(cuda_device, dtype, tol, H, CP, variant):
    """The autograd Function on CUDA tensors (kernel forward, row-chunked
    backward) against autograd through the plain version on the same values
    in f32, each gradient within ``tol`` of its own largest entry (bf16: plus
    one rounding of the f32 gradient to bf16's 8 significant bits, 2^-8)."""
    args = _args(cuda_device, 2, 37, 37, dtype, 5, H=H, CP=CP, variant=variant)
    args = [None if t is None else t.requires_grad_(n != "bias") for n, t in zip(NAMES, args)]
    grad_names = [n for n, t in zip(NAMES, args) if t is not None and n != "bias"]
    diff = [args[NAMES.index(n)] for n in grad_names]
    outs = k1.ipa_attention(*args, **KW)
    assert all(o.grad_fn is not None for o in outs)
    cts = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, diff, cts)
    ref = [None if t is None else t.detach().float().requires_grad_(n != "bias")
           for n, t in zip(NAMES, args)]
    want = torch.autograd.grad(k1.ipa_attention_plain(*ref, **KW),
                               [ref[NAMES.index(n)] for n in grad_names], [c.float() for c in cts])
    for g, p, w in zip(got, diff, want):
        assert g.dtype == p.dtype and torch.isfinite(g).all()
        assert (g.float() - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("H,dtype,route,tol", [(32, torch.bfloat16, "tc", 3e-2),
                                               (32, torch.float32, "tc_f32", 2e-4),
                                               (16, torch.bfloat16, "tc16", 3e-2),
                                               (16, torch.float32, "tc16_f32", 2e-4),
                                               (8, torch.bfloat16, "tc8", 3e-2),
                                               (8, torch.float32, "tc8_f32", 2e-4)])
@pytest.mark.parametrize("CP", [256, 96, 32])
@pytest.mark.parametrize("B,Lq,Lk,masked", TC_CASES)
def test_tensor_core_route_matches_plain_and_the_cuda_core_design(cuda_device, B, Lq, Lk, masked, CP,
                                                                  H, dtype, route, tol):
    """32, 16 or 8 heads, streamed pa: ipa_attention launches the
    tensor-core design of the heads and dtype ("tc"/"tc16"/"tc8" for bf16,
    "tc_f32"/"tc16_f32"/"tc8_f32" for f32); within ``tol`` x max|plain| of
    the plain version and of the CUDA-core design (``_launch_design("simt")``)
    on the same inputs."""
    args = _args(cuda_device, B, Lq, Lk, dtype, masked, H=H, CP=CP)
    before = dict(k1.launches_by_route)
    got = k1.ipa_attention(*args, **KW)
    prev = k1._launch_design("simt", *args, **KW)
    torch.cuda.synchronize()
    assert k1.launches_by_route == {**before, route: before[route] + 1}
    want = k1.ipa_attention_plain(*args, **KW)
    for g, p, w in zip(got, prev, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all()
        scale = max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol * scale
        assert (g.float() - p.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route,tol", [(torch.bfloat16, "tc_pb", 3e-2),
                                             (torch.float32, "tc_pb_f32", 2e-4)])
@pytest.mark.parametrize("CP", [256, 96, 32])
@pytest.mark.parametrize("B,Lq,Lk,masked", TC_CASES)
def test_in_kernel_32_head_route_matches_plain_and_the_cuda_core_design(cuda_device, B, Lq, Lk,
                                                                        masked, CP, dtype, route,
                                                                        tol):
    """32 heads, in-kernel pair bias (``w_pb``): ipa_attention launches the
    in-kernel tensor-core design of the dtype once ("tc_pb" bf16,
    "tc_pb_f32" f32); within ``tol`` x max|plain| of the plain version and
    of the CUDA-core design (``_launch_design("simt")``) on the same inputs,
    masked, ragged and with rows != columns."""
    args = _args(cuda_device, B, Lq, Lk, dtype, masked, CP=CP, variant="w_pb")
    before = dict(k1.launches_by_route)
    got = k1.ipa_attention(*args, **KW)
    prev = k1._launch_design("simt", *args, **KW)
    torch.cuda.synchronize()
    assert k1.launches_by_route == {**before, route: before[route] + 1}
    want = k1.ipa_attention_plain(*args, **KW)
    for g, p, w in zip(got, prev, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all()
        scale = max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol * scale
        assert (g.float() - p.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route,tol", [(torch.bfloat16, "tc_pb", 3e-2),
                                             (torch.float32, "tc_pb_f32", 2e-4)])
def test_in_kernel_32_head_slab_matches_plain_and_the_cuda_core_design(cuda_device, dtype, route,
                                                                       tol):
    """A 5-row slab of 70 columns at 32 heads, Cp=256, with the in-kernel
    pair bias (``sp_ipa_attention`` with ``pa=None``): one launch of the
    route's design, within ``tol`` x max|plain| of the plain version on the
    slab and of the CUDA-core design on the same operands."""
    from se3diff_torch.ops.ipa_attention import sp_ipa_attention

    full = _args(cuda_device, 2, 70, 70, dtype, 3, variant="w_pb")
    r0, r1 = 30, 35
    slab = list(full)
    for i, dim in ((0, 2), (3, 3), (6, 1)):
        slab[i] = full[i].narrow(dim, r0, r1 - r0).contiguous()
    before = dict(k1.launches_by_route)
    got = sp_ipa_attention((r0, r1), *slab, **KW)
    prev = k1._launch_design("simt", *slab, **KW)
    torch.cuda.synchronize()
    assert k1.launches_by_route == {**before, route: before[route] + 1}
    want = [o.narrow(2, r0, r1 - r0) for o in k1.ipa_attention_plain(*full, **KW)]
    for g, p, w in zip(got, prev, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol * scale
        assert (g.float() - p.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("route,source", [("tc_pb", "ipa_attention_tc.cu"),
                                          ("tc_pb_f32", "ipa_attention_tc_f32.cu")])
def test_in_kernel_32_head_designs_use_the_shared_memory_their_sources_state(cuda_device, route,
                                                                             source):
    """The library's in-kernel 32-head layouts at Cp=256 are the totals the
    sources state for the variant (held within Hopper's 232,448 bytes by
    the route tests)."""
    import re
    from pathlib import Path

    src = (Path(k1.__file__).resolve().parents[1] / "csrc" / source).read_text()
    stated = re.search(r"Shared memory of the variant at Cp = 256: ([\d,]+) bytes", src).group(1)
    assert getattr(k1._library(), f"ipa_attention_{route}_smem_bytes")(256) == int(
        stated.replace(",", ""))


@pytest.mark.cuda
@pytest.mark.parametrize("CP", [32, 4, 64])
@pytest.mark.parametrize("B,Lq,Lk,masked", H4_CASES)
def test_h4_route_matches_plain_and_the_cuda_core_design(cuda_device, B, Lq, Lk, masked, CP):
    """f32, 4 heads, in-kernel pair bias: ipa_attention launches the "h4"
    design; within 2e-4 x max|plain| of the plain version and of the
    CUDA-core design (``_launch_design("simt")``) on the same inputs."""
    tol = 2e-4
    args = _args(cuda_device, B, Lq, Lk, torch.float32, masked, H=4, CP=CP, variant="w_pb")
    before = dict(k1.launches_by_route)
    got = k1.ipa_attention(*args, **KW)
    prev = k1._launch_design("simt", *args, **KW)
    torch.cuda.synchronize()
    assert k1.launches_by_route == {**before, "h4": before["h4"] + 1}
    want = k1.ipa_attention_plain(*args, **KW)
    for g, p, w in zip(got, prev, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all()
        scale = max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol * scale
        assert (g.float() - p.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_h4_design_uses_the_shared_memory_its_source_states(cuda_device):
    """The library's h4 layout at Cp = 32 and at its largest Cp is what the
    source's header states."""
    import re
    from pathlib import Path

    src = (Path(k1.__file__).resolve().parents[1] / "csrc" / "ipa_attention_h4.cu").read_text()
    for cp in (32, k1.H4_MAX_CP):
        stated = re.search(rf"Shared memory at Cp = {cp}: ([\d,]+) bytes", src).group(1)
        assert k1._library().ipa_attention_h4_smem_bytes(cp) == int(stated.replace(",", ""))


@pytest.mark.cuda
def test_f32_design_uses_the_shared_memory_its_source_states(cuda_device):
    """The library's layout at Cp=256 is the total the source's header
    states (held within Hopper's 232,448 bytes by the route tests)."""
    import re
    from pathlib import Path

    src = (Path(k1.__file__).resolve().parents[1] / "csrc" / "ipa_attention_tc_f32.cu").read_text()
    stated = int(re.search(r"Shared memory at Cp = 256: ([\d,]+) bytes", src).group(1).replace(",", ""))
    assert k1._library().ipa_attention_tc_f32_smem_bytes(256) == stated


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tc16", "tc16_f32"])
def test_16_head_designs_use_the_shared_memory_their_sources_state(cuda_device, route):
    """The library's 16-head layouts at Cp=256 are the totals the sources'
    headers state, and two blocks of each are resident on an SM."""
    import re
    from pathlib import Path

    src = (Path(k1.__file__).resolve().parents[1] / "csrc" / f"ipa_attention_{route}.cu").read_text()
    stated = int(re.search(r"Shared memory at Cp = 256: ([\d,]+) bytes", src).group(1).replace(",", ""))
    lib = k1._library()
    assert getattr(lib, f"ipa_attention_{route}_smem_bytes")(256) == stated
    assert getattr(lib, f"ipa_attention_{route}_blocks_per_sm")(256) == 2



@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tc8", "tc8_f32"])
def test_8_head_designs_use_the_shared_memory_their_sources_state(cuda_device, route):
    """The library's 8-head layouts at Cp=256 are the totals the sources'
    headers state, and two blocks of each are resident on an SM."""
    import re
    from pathlib import Path

    src = (Path(k1.__file__).resolve().parents[1] / "csrc" / f"ipa_attention_{route}.cu").read_text()
    stated = int(re.search(r"Shared memory at Cp = 256: ([\d,]+) bytes", src).group(1).replace(",", ""))
    lib = k1._library()
    assert getattr(lib, f"ipa_attention_{route}_smem_bytes")(256) == stated
    assert getattr(lib, f"ipa_attention_{route}_blocks_per_sm")(256) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route,tol", [(torch.bfloat16, "tc8", 3e-2),
                                             (torch.float32, "tc8_f32", 2e-4)])
def test_8_head_slab_matches_plain_and_the_cuda_core_design(cuda_device, dtype, route, tol):
    """A 5-row slab of 70 columns at 8 heads, Cp=256 (``sp_ipa_attention``,
    a sequence-parallel rank's rows of a model=4 rank's heads): one launch
    of the route's design, within ``tol`` x max|plain| of the plain version
    on the slab and of the CUDA-core design on the same operands."""
    from se3diff_torch.ops.ipa_attention import sp_ipa_attention

    full = _args(cuda_device, 2, 70, 70, dtype, 0, H=8, CP=256)
    r0, r1 = 30, 35
    slab = list(full)
    for i, dim in ((0, 2), (3, 3), (6, 1), (9, 2)):
        slab[i] = full[i].narrow(dim, r0, r1 - r0).contiguous()
    before = dict(k1.launches_by_route)
    got = sp_ipa_attention((r0, r1), *slab, **KW)
    prev = k1._launch_design("simt", *slab, **KW)
    torch.cuda.synchronize()
    assert k1.launches_by_route == {**before, route: before[route] + 1}
    want = [o.narrow(2, r0, r1 - r0) for o in k1.ipa_attention_plain(*full, **KW)]
    for g, p, w in zip(got, prev, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol * scale
        assert (g.float() - p.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc8"), (torch.float32, "tc8_f32")])
def test_8_head_designs_refuse_misaligned_operands_on_the_card(cuda_device, dtype, route):
    """A pa or w_pv that starts 4 bytes into its storage is refused with a
    ValueError, counted nowhere and never handed to another design."""
    args = list(_args(cuda_device, 2, 9, 9, dtype, 0, H=8, CP=64))
    assert k1.kernel_route(dtype, 8, 16, 64, True) == route
    for i, name in ((9, "pa"), (7, "w_pv")):
        t = args[i]
        off = 4 // t.element_size()
        bad = list(args)
        bad[i] = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:].view(t.shape)
        bad[i].copy_(t)
        assert bad[i].data_ptr() % 16
        before = dict(k1.launches_by_route)
        with pytest.raises(ValueError, match=f"16-byte aligned {name}"):
            k1.ipa_attention(*bad, **KW)
        assert k1.launches_by_route == before

@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    args = list(_args(cuda_device, 1, 8, 8, torch.float32, 0))
    with pytest.raises(ValueError, match="contiguous"):
        bad = list(args)
        bad[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
        k1.ipa_attention(*bad, **KW)
    with pytest.raises(TypeError, match="dtype"):
        bad = list(args)
        bad[5] = args[5].double()
        k1.ipa_attention(*bad, **KW)
    with pytest.raises(ValueError, match="take 4, 8, 16, 32 heads"):
        k1.ipa_attention(*_args(cuda_device, 1, 8, 8, torch.float32, 0, H=12, CP=32), **KW)


# Shapes of the backward kernel: ragged row and column tiles with masked
# columns, rows != columns with a partial last tile, one row and column,
# every column masked, an SP slab (150 rows of 300), and L=77 and L=56.
BWD_CASES = [(2, 37, 37, 5), (2, 5, 70, 0), (1, 1, 1, 0), (2, 33, 33, 33), (2, 150, 300, 0),
             (3, 77, 77, 9), (4, 56, 56, 0)]
# Each side rounds its bf16 gradients once from f32 sums taken in another
# order, so the two may lie a bf16 ulp apart: 2^-7 of a value in bf16. The
# streamed routes at 32 heads and at a tensor-parallel rank's 16 and 8.
BWD_ROUTES = [(torch.bfloat16, "bwd_tc", 32, 2.0**-7 + 1e-4),
              (torch.float32, "bwd_tc_f32", 32, 1e-4),
              (torch.bfloat16, "bwd_tc16", 16, 2.0**-7 + 1e-4),
              (torch.float32, "bwd_tc16_f32", 16, 1e-4),
              (torch.bfloat16, "bwd_tc8", 8, 2.0**-7 + 1e-4),
              (torch.float32, "bwd_tc8_f32", 8, 1e-4)]


def _cotangents(args, seed=1):
    q_s = args[0]
    gen = torch.Generator(device=q_s.device).manual_seed(seed)
    B, H, Lq, _ = q_s.shape
    return (torch.randn(B, H, Lq, DK, generator=gen, device=q_s.device).to(q_s.dtype),
            torch.randn(B, H, Lq, 24, generator=gen, device=q_s.device),
            torch.randn(B, H, Lq, DK, generator=gen, device=q_s.device).to(q_s.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route,H,tol", BWD_ROUTES)
@pytest.mark.parametrize("CP", [256, 96, 32])
@pytest.mark.parametrize("B,Lq,Lk,masked", BWD_CASES)
def test_backward_kernel_matches_the_pytorch_backward(cuda_device, B, Lq, Lk, masked, CP, dtype,
                                                      route, H, tol):
    """Each gradient of the backward kernel within ``tol`` of the largest
    entry of ``ipa_attention_backward``'s on the same inputs (f32: sums in
    another order; bf16: plus a bf16 ulp between the two roundings, 2^-7),
    that largest entry taken as at least 1e-2; and autograd on CUDA tensors
    of these widths runs the kernel route. With one key column the softmax
    is 1 and ds is zero but for rounding (the kernel's D sums dphat's terms
    in another order): the gradients made from ds, exactly zero, are held
    at 1e-5 absolute (residues of f32 sums of terms of some 10)."""
    args = _args(cuda_device, B, Lq, Lk, dtype, masked, H=H, CP=CP)[:10]
    cts = _cotangents(args)
    assert k1.backward_route(dtype, H, DK, CP, True) == route
    got = k1._launch_backward(args, cts, KW["scalar_w"], KW["pair_w"], counted=False)
    want = k1.ipa_attention_backward(args, cts, **KW)
    torch.cuda.synchronize()
    from_ds = ("q_s", "k_s", "q_p", "k_p", "pa")
    for name, g, w, p in zip(NAMES, got, want, args):
        if name == "bias":
            assert g is None and w is None
            continue
        assert g.dtype == p.dtype and g.shape == p.shape and torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        if Lk == 1 and name in from_ds:
            assert err <= 1e-5, name
        else:
            assert err <= tol * max(w.float().abs().max().item(), 1e-2), name
    leaves = [t.clone().requires_grad_(n != "bias") for n, t in zip(NAMES, args)]
    before = dict(k1.backward_calls_by_route)
    outs = k1.ipa_attention(*leaves, **KW)
    torch.autograd.grad(outs, [t for n, t in zip(NAMES, leaves) if n != "bias"], cts)
    assert k1.backward_calls_by_route == {**before, route: before[route] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route,H,CP,variant", [
    (torch.bfloat16, "bwd_tc", 32, 256, "pa"), (torch.float32, "bwd_tc_f32", 32, 256, "pa"),
    (torch.bfloat16, "bwd_tc16", 16, 256, "pa"), (torch.float32, "bwd_tc16_f32", 16, 256, "pa"),
    (torch.bfloat16, "bwd_tc8", 8, 256, "pa"), (torch.float32, "bwd_tc8_f32", 8, 256, "pa"),
    (torch.float32, "bwd_h4", 4, 32, "w_pb")])
@pytest.mark.parametrize("B,Lq,Lk,masked", [(16, 100, 100, 0), (3, 77, 77, 9), (4, 150, 300, 0)])
def test_backward_kernel_is_deterministic(cuda_device, B, Lq, Lk, masked, dtype, route, H, CP,
                                          variant):
    """Two calls on the same inputs give the same gradients bit for bit: no
    atomics, every sum (bwd_h4's weight gradients over the rows included) in
    a fixed order."""
    args = list(_args(cuda_device, B, Lq, Lk, dtype, masked, H=H, CP=CP, variant=variant))
    args = args[:10] if variant == "pa" else args
    assert k1.backward_route(dtype, H, DK, CP, variant == "pa") == route
    cts = _cotangents(args)
    first = k1._launch_backward(args, cts, KW["scalar_w"], KW["pair_w"], counted=False)
    second = k1._launch_backward(args, cts, KW["scalar_w"], KW["pair_w"], counted=False)
    assert len(first) == len(args)
    for name, x, y in zip(NAMES, first, second):
        assert (x is None and y is None) or torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("route,rows", [("bwd_tc", "bwd_rows<T, 32>"),
                                        ("bwd_tc16", "bwd_rows<T, 16>"), ("bwd_tc8", "bwd8_rows")])
def test_backward_kernel_uses_the_shared_memory_its_source_states(cuda_device, route, rows):
    """The library's row kernel's and the shared column kernel's shared
    memory at Cp=256 are what the source's header states; every design's
    row kernel keeps two blocks resident an SM in both dtypes, and so does
    the 8-head column kernel, whose rows are split over warps."""
    import re
    from pathlib import Path

    csrc = Path(k1.__file__).resolve().parents[1] / "csrc"
    src = (csrc / f"ipa_attention_{route}.cu").read_text()
    m = re.search(rf"Shared memory of {rows} at Cp = 256: ([\d,]+) bytes \(bf16\), ([\d,]+) "
                  r"\(f32\)[^;]*;\s*(?://\s*)?bwd_cols: ([\d,]+) bytes", src)
    bf16, f32, col = (int(x.replace(",", "")) for x in m.groups())
    lib = k1._library()
    assert getattr(lib, f"ipa_attention_{route}_smem_bytes")(256) == bf16
    assert getattr(lib, f"ipa_attention_{route}_f32_smem_bytes")(256) == f32
    assert lib.ipa_attention_bwd_cols_smem_bytes() == col
    assert getattr(lib, f"ipa_attention_{route}_blocks_per_sm")(256) == 2
    assert getattr(lib, f"ipa_attention_{route}_f32_blocks_per_sm")(256) == 2
    if route == "bwd_tc8":
        assert lib.ipa_attention_bwd_tc8_cols_blocks_per_sm() == 2
        assert lib.ipa_attention_bwd_tc8_f32_cols_blocks_per_sm() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route,H", [(torch.bfloat16, "bwd_tc16", 16),
                                           (torch.float32, "bwd_tc16_f32", 16),
                                           (torch.bfloat16, "bwd_tc8", 8),
                                           (torch.float32, "bwd_tc8_f32", 8)])
def test_16_and_8_head_backward_form_g_in_their_row_kernels(cuda_device, dtype, route, H):
    """The 16- and 8-head backward form g = ct_pr @ w_pv^T in their row
    kernels: a call at the model=2 and model=4 steps' B=16 L=100 runs one
    ``bmm`` (d_w_pv's) and allocates no f32 [H, B Lq, Cp] tensor for g, its
    peak beyond the operands within the gradients, the kernel's scratch
    (wx2d; logits, dv and ds; the row statistics), d_w_pv's partials and
    half of g's 26.2 MB at 16 heads, 13.1 MB at 8 (the cotangents' f32 and
    head-first copies take a few MB)."""
    B, L, CP = 16, 100, 256
    args = _args(cuda_device, B, L, L, dtype, 0, H=H, CP=CP)[:10]
    cts = _cotangents(args)
    assert k1.backward_route(dtype, H, DK, CP, True) == route

    def call():
        return k1._launch_backward(args, cts, KW["scalar_w"], KW["pair_w"], counted=False)

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
        torch.cuda.synchronize()
    assert sum(e.count for e in prof.key_averages() if e.key == "aten::bmm") == 1
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    g_bytes = H * B * L * CP * 4
    scratch = g_bytes + 3 * B * H * L * L * 4 + B * H * L * 2 * 4 + H * B * CP * DK * 4
    out = sum(g.numel() * g.element_size() for g in grads if g is not None)
    assert peak < out + scratch + g_bytes // 2, (peak, out, scratch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bwd_tc8"),
                                         (torch.float32, "bwd_tc8_f32")])
def test_8_head_column_kernel_is_deterministic(cuda_device, dtype, route):
    """The 8-head column kernel splits each head's query rows over four
    warps and adds their parts in a fixed order: at B=40 L=77 with 9 masked
    columns (every part ragged at its end) two calls give the column sums
    (d_k_s, d_v_s, d_k_p, d_v_p) bit for bit, and they agree with the
    PyTorch backward's within the route's tolerance."""
    args = _args(cuda_device, 40, 77, 77, dtype, 9, H=8, CP=256)[:10]
    cts = _cotangents(args)
    assert k1.backward_route(dtype, 8, DK, 256, True) == route
    first = k1._launch_backward(args, cts, KW["scalar_w"], KW["pair_w"], counted=False)
    second = k1._launch_backward(args, cts, KW["scalar_w"], KW["pair_w"], counted=False)
    want = k1.ipa_attention_backward(args, cts, **KW)
    torch.cuda.synchronize()
    tol = {r: t for _, r, _, t in BWD_ROUTES}[route]
    for name in ("k_s", "v_s", "k_p", "v_p"):
        i = NAMES.index(name)
        assert torch.equal(first[i], second[i]), name
        err = (first[i].float() - want[i].float()).abs().max().item()
        assert err <= tol * max(want[i].float().abs().max().item(), 1e-2), name


@pytest.mark.cuda
def test_backward_kernel_refuses_what_it_does_not_take(cuda_device):
    args = list(_args(cuda_device, 1, 8, 8, torch.float32, 0))
    cts = _cotangents(args)
    with pytest.raises(ValueError, match="streamed pair bias"):
        k1._launch_backward(args[:9] + [None], cts, 1.0, 1.0)
    with pytest.raises(ValueError, match="no backward kernel takes 8 heads"):
        small = list(_args(cuda_device, 1, 8, 8, torch.float32, 0, H=8, CP=36))[:10]
        k1._launch_backward(small, _cotangents(small), 1.0, 1.0)
    with pytest.raises(ValueError, match="d_out_p"):
        k1._launch_backward(args[:10], (cts[0], cts[1][..., :12], cts[2]), 1.0, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bwd_tc8"),
                                         (torch.float32, "bwd_tc8_f32")])
def test_8_head_backward_kernels_refuse_misaligned_operands(cuda_device, dtype, route):
    """A pa, v_p or d_out_s that starts 4 bytes into its storage is refused
    with a ValueError before the kernel launches, and the call is counted
    on no route."""
    args = list(_args(cuda_device, 2, 9, 9, dtype, 0, H=8, CP=64))[:10]
    cts = list(_cotangents(args))
    assert k1.backward_route(dtype, 8, DK, 64, True) == route

    def shifted(t):
        off = 4 // t.element_size()
        out = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16
        return out

    for where, i in (("args", 9), ("args", 5), ("cts", 0)):
        bad_args, bad_cts = list(args), list(cts)
        target = bad_args if where == "args" else bad_cts
        target[i] = shifted(target[i])
        before = dict(k1.backward_calls_by_route)
        with pytest.raises(ValueError, match="16-byte aligned"):
            k1._launch_backward(bad_args, tuple(bad_cts), KW["scalar_w"], KW["pair_w"])
        assert k1.backward_calls_by_route == before


# Shapes of the bwd_h4 kernel: a small batch, the PPFT CLI's masked L=57 at
# B=8 (ragged row and column tiles, two row blocks), ragged cases, one row
# and column, every column masked, a 28-row slab of 56 columns, and L=100
# (two key chunks of 64).
H4_BWD_CASES = [(2, 9, 9, 0), (8, 57, 57, 5), (3, 37, 37, 5), (2, 5, 70, 0), (1, 1, 1, 0),
                (2, 33, 33, 33), (4, 28, 56, 0), (2, 100, 100, 0)]
# GRAD_TOL["float32"] of chip_smoke.py: 1e-4 x max|reference|, the reference
# autograd through the plain version in f32 (same function, sums in another
# order).
H4_GRAD_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("CP", [32, 4, 64])
@pytest.mark.parametrize("B,Lq,Lk,masked", H4_BWD_CASES)
def test_h4_backward_kernel_matches_autograd_of_plain(cuda_device, B, Lq, Lk, masked, CP):
    """f32, 4 heads, ``w_pb``: autograd through ``ipa_attention`` runs the
    "bwd_h4" kernel, and each gradient is within ``H4_GRAD_TOL`` of the
    largest entry of autograd's through the plain version on the same
    values. With one key column the softmax is 1 and ds is zero but for
    rounding (the kernel forms D and d_w_pb's row term in another order):
    the gradients made from ds alone are held at 1e-5 absolute."""
    args = _args(cuda_device, B, Lq, Lk, torch.float32, masked, H=4, CP=CP, variant="w_pb")
    cts = _cotangents(args)
    assert k1.backward_route(torch.float32, 4, DK, CP, False) == "bwd_h4"
    names = [n for n, t in zip(NAMES, args) if t is not None and n != "bias"]
    leaves = [None if t is None else t.clone().requires_grad_(n != "bias") for n, t in zip(NAMES, args)]
    diff = [leaves[NAMES.index(n)] for n in names]
    before = dict(k1.backward_calls_by_route)
    got = torch.autograd.grad(k1.ipa_attention(*leaves, **KW), diff, cts)
    assert k1.backward_calls_by_route == {**before, "bwd_h4": before["bwd_h4"] + 1}
    ref = [None if t is None else t.detach().clone().requires_grad_(n != "bias")
           for n, t in zip(NAMES, args)]
    want = torch.autograd.grad(k1.ipa_attention_plain(*ref, **KW),
                               [ref[NAMES.index(n)] for n in names], cts)
    torch.cuda.synchronize()
    from_ds = ("q_s", "k_s", "q_p", "k_p", "w_pb")
    for name, g, w, p in zip(names, got, want, diff):
        assert g.dtype == p.dtype and g.shape == p.shape and torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        if Lk == 1 and name in from_ds:
            assert err <= 1e-5, name
        else:
            assert err <= H4_GRAD_TOL * w.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_h4_backward_kernel_uses_the_shared_memory_its_source_states(cuda_device):
    import re
    from pathlib import Path

    src = (Path(k1.__file__).resolve().parents[1] / "csrc" / "ipa_attention_bwd_h4.cu").read_text()
    m = re.search(r"Shared memory of bwd_h4_rows: ([\d,]+) bytes at Cp = 32 \(8 rows\), "
                  r"([\d,]+) at Cp = 64", src)
    at32, at64 = (int(x.replace(",", "")) for x in m.groups())
    lib = k1._library()
    assert lib.ipa_attention_bwd_h4_smem_bytes(32) == at32
    assert lib.ipa_attention_bwd_h4_smem_bytes(64) == at64
    # Two 8-warp row blocks an SM at either instantiation, as the source says.
    assert lib.ipa_attention_bwd_h4_blocks_per_sm(32) >= 2
    assert lib.ipa_attention_bwd_h4_blocks_per_sm(64) >= 2
