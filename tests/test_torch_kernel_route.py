"""The card's IPA attention widths and the rule that picks a kernel design.

``kernel_route`` and ``check_card_widths`` are pure functions of widths and
a device name, so they run without a GPU: the widths the card refuses fail
at bundle load, train start and finetune start with a ``ValueError`` naming
the supported widths, before the device is resolved (which raises a
``RuntimeError`` where CUDA is absent). ``CARD_WIDTHS`` is held against
the head counts the CUDA sources instantiate.
"""

import re
from pathlib import Path

import pytest
import torch
import yaml

from se3diff_torch import finetune, train
from se3diff_torch.ops import ipa_attention as k1
from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, load_bundle, random_bundle

CSRC = Path(k1.__file__).resolve().parents[1] / "csrc"
BF16, F32 = torch.bfloat16, torch.float32
WIDTHS_MSG = "take 4, 8, 16, 32 heads of width 16"
# Widths the card refuses: head width 8, and 12 heads of width 16.
REFUSED = [dict(dim_model=32, dim_pair=32, num_heads=4), dict(dim_model=192, dim_pair=64, num_heads=12)]


@pytest.mark.parametrize("dtype,H,dk,cp,has_pa,route", [
    (BF16, 32, 16, 256, True, "tc"),     # the score model in bf16: every main path
    (BF16, 32, 16, 128, True, "tc"),
    (BF16, 32, 16, 96, True, "tc"),
    (BF16, 32, 16, 32, True, "tc"),
    (BF16, 32, 16, 36, True, "simt"),    # Cp not a multiple of 32
    (F32, 32, 16, 256, True, "tc_f32"),  # the score model in f32, every CLI's default
    (F32, 32, 16, 128, True, "tc_f32"),
    (F32, 32, 16, 96, True, "tc_f32"),
    (F32, 32, 16, 32, True, "tc_f32"),
    (F32, 32, 16, 36, True, "simt"),     # Cp not a multiple of 32
    (F32, 32, 16, 256, False, "tc_pb_f32"),  # the in-kernel pair bias at 32 heads, f32
    (BF16, 32, 16, 256, False, "tc_pb"),     # the same in bf16
    (F32, 32, 16, 96, False, "tc_pb_f32"),
    (BF16, 32, 16, 32, False, "tc_pb"),
    (F32, 32, 16, 100, False, "simt"),   # in-kernel, Cp not a multiple of 32
    (BF16, 32, 16, 36, False, "simt"),
    (F32, 4, 16, 32, False, "h4"),       # the PPFT control net
    (F32, 4, 16, 4, False, "h4"),
    (F32, 4, 16, 36, False, "h4"),
    (F32, 4, 16, 64, False, "h4"),       # the h4 design's largest Cp
    (F32, 4, 16, 68, False, "simt"),     # Cp above the h4 design's shared memory
    (F32, 4, 16, 256, False, "simt"),
    (BF16, 4, 16, 32, False, "simt"),    # bf16 at 4 heads
    (F32, 4, 16, 32, True, "simt"),      # the streamed variant at 4 heads
    (F32, 8, 16, 32, False, "simt"),     # 8 heads, the in-kernel pair bias
    (BF16, 4, 16, 32, True, "simt"),
    (BF16, 8, 16, 64, True, "tc8"),
    (BF16, 8, 16, 256, True, "tc8"),     # 8 heads (a rank at --mesh model=4), bf16
    (F32, 8, 16, 256, True, "tc8_f32"),  # the same at the train CLI's default f32
    (BF16, 8, 16, 32, True, "tc8"),
    (F32, 8, 16, 96, True, "tc8_f32"),
    (F32, 8, 16, 32, True, "tc8_f32"),
    (BF16, 8, 16, 36, True, "simt"),     # 8 heads, Cp not a multiple of 32
    (F32, 8, 16, 100, True, "simt"),
    (BF16, 8, 16, 256, False, "simt"),   # 8 heads, the in-kernel pair bias
    (F32, 8, 16, 256, False, "simt"),
    (F32, 16, 16, 128, False, "simt"),
    (BF16, 16, 16, 256, True, "tc16"),   # a tensor-parallel rank at --mesh model=2, bf16
    (BF16, 16, 16, 128, True, "tc16"),
    (BF16, 16, 16, 32, True, "tc16"),
    (F32, 16, 16, 256, True, "tc16_f32"),  # the same at the train CLI's default f32
    (F32, 16, 16, 96, True, "tc16_f32"),
    (F32, 16, 16, 32, True, "tc16_f32"),
    (F32, 16, 16, 36, True, "simt"),     # Cp not a multiple of 32
    (BF16, 16, 16, 36, True, "simt"),
    (BF16, 16, 16, 128, False, "simt"),  # the in-kernel pair bias at 16 heads
])
def test_route_rule(dtype, H, dk, cp, has_pa, route):
    assert k1.kernel_route(dtype, H, dk, cp, has_pa) == route


@pytest.mark.parametrize("dtype,H,dk,cp,has_pa", [
    (BF16, 12, 16, 256, True),   # heads
    (F32, 2, 16, 32, True),
    (F32, 32, 8, 256, True),     # head width
    (BF16, 32, 16, 260, True),   # Cp > 256
    (F32, 4, 16, 30, False),     # Cp % 4
])
def test_route_rule_raises_for_widths_the_card_refuses(dtype, H, dk, cp, has_pa):
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        k1.kernel_route(dtype, H, dk, cp, has_pa)


@pytest.mark.parametrize("dtype,H,dk,cp,has_pa,route", [
    (BF16, 32, 16, 256, True, "bwd_tc"),       # the score model's backward in bf16
    (BF16, 32, 16, 96, True, "bwd_tc"),
    (BF16, 32, 16, 32, True, "bwd_tc"),
    (F32, 32, 16, 256, True, "bwd_tc_f32"),    # the same at the train CLI's default f32
    (F32, 32, 16, 128, True, "bwd_tc_f32"),
    (F32, 32, 16, 32, True, "bwd_tc_f32"),
    (BF16, 32, 16, 36, True, "torch"),         # Cp not a multiple of 32
    (F32, 32, 16, 36, True, "torch"),
    (F32, 32, 16, 256, False, "torch"),        # the in-kernel pair bias (forward tc_pb*)
    (BF16, 32, 16, 256, False, "torch"),
    (BF16, 32, 16, 96, False, "torch"),
    (F32, 32, 16, 32, False, "torch"),
    (F32, 4, 16, 32, False, "bwd_h4"),         # the PPFT control net
    (F32, 4, 16, 4, False, "bwd_h4"),
    (F32, 4, 16, 36, False, "bwd_h4"),
    (F32, 4, 16, 64, False, "bwd_h4"),         # the h4 designs' largest Cp
    (F32, 4, 16, 68, False, "torch"),          # Cp above it
    (F32, 4, 16, 96, False, "torch"),
    (BF16, 4, 16, 32, False, "torch"),         # bf16 at 4 heads
    (F32, 4, 16, 32, True, "torch"),           # the streamed variant at 4 heads
    (F32, 8, 16, 64, False, "torch"),          # 8 heads in-kernel
    (BF16, 16, 16, 256, True, "bwd_tc16"),     # a tensor-parallel rank at --mesh model=2
    (F32, 16, 16, 256, True, "bwd_tc16_f32"),
    (F32, 8, 16, 256, True, "bwd_tc8_f32"),   # a rank at --mesh model=4
    (BF16, 16, 16, 96, True, "bwd_tc16"),
    (BF16, 16, 16, 32, True, "bwd_tc16"),
    (F32, 16, 16, 128, True, "bwd_tc16_f32"),
    (F32, 16, 16, 32, True, "bwd_tc16_f32"),
    (BF16, 16, 16, 36, True, "torch"),         # 16 heads, Cp not a multiple of 32
    (F32, 16, 16, 100, True, "torch"),
    (BF16, 16, 16, 256, False, "torch"),       # 16 heads, the in-kernel pair bias
    (F32, 16, 16, 64, False, "torch"),
    (BF16, 8, 16, 256, True, "bwd_tc8"),       # 8 heads streamed (a rank at --mesh model=4)
    (BF16, 8, 16, 32, True, "bwd_tc8"),
    (F32, 8, 16, 32, True, "bwd_tc8_f32"),
    (BF16, 8, 16, 96, True, "bwd_tc8"),
    (F32, 8, 16, 96, True, "bwd_tc8_f32"),
    (BF16, 8, 16, 36, True, "torch"),          # 8 heads, Cp not a multiple of 32
    (F32, 8, 16, 36, True, "torch"),
    (BF16, 8, 16, 64, False, "torch"),         # 8 heads, the in-kernel pair bias
])
def test_backward_route_rule(dtype, H, dk, cp, has_pa, route):
    assert k1.backward_route(dtype, H, dk, cp, has_pa) == route


@pytest.mark.parametrize("dtype,H,dk,cp,has_pa", [
    (BF16, 12, 16, 256, True), (F32, 32, 8, 256, True), (BF16, 32, 16, 260, True),
])
def test_backward_route_rule_raises_for_widths_the_card_refuses(dtype, H, dk, cp, has_pa):
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        k1.backward_route(dtype, H, dk, cp, has_pa)


def test_each_backward_symbol_has_exactly_one_extern_c_definition():
    """Every backward route's C symbol is defined once across ``csrc/*.cu``,
    inside an ``extern "C"`` block of its design's source, with the
    arguments the binding declares (35 for the streamed designs at 32, 16
    and 8 heads, which take ct_pr and w_pv; 34 for bwd_h4); the counts hold
    one entry a backward route and "torch"."""
    sources = {"bwd_tc": "ipa_attention_bwd_tc.cu", "bwd_tc_f32": "ipa_attention_bwd_tc.cu",
               "bwd_tc16": "ipa_attention_bwd_tc16.cu",
               "bwd_tc16_f32": "ipa_attention_bwd_tc16.cu",
               "bwd_tc8": "ipa_attention_bwd_tc8.cu", "bwd_tc8_f32": "ipa_attention_bwd_tc8.cu",
               "bwd_h4": "ipa_attention_bwd_h4.cu"}
    for route, symbol in k1._BWD_ROUTE_SYMBOLS.items():
        found = []
        for path in CSRC.glob("*.cu"):
            text = path.read_text()
            for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S):
                for m in re.finditer(rf"\bint {symbol}\(", block):
                    signature = block[m.start():]
                    commas = 34 if route in k1._BWD_FORMS_G else 33
                    assert signature[:signature.index(")")].count(",") == commas, symbol
                    found.append(path.name)
        assert found == [sources[route]], (symbol, found)
    assert set(k1.backward_calls_by_route) == {"bwd_tc", "bwd_tc_f32", "bwd_tc16", "bwd_tc16_f32",
                                               "bwd_tc8", "bwd_tc8_f32", "bwd_h4", "torch"}


def test_backward_kernel_source_states_widths_and_shared_memory():
    """Each streamed backward source takes the widths its routes name (32
    heads in ``ipa_attention_bwd_tc.cu``, 16 in ``ipa_attention_bwd_tc16.cu``,
    8 in ``ipa_attention_bwd_tc8.cu``; the head width and largest Cp in the
    header all include; the 32- and 16-head sources instantiate the row
    design of ``ipa_attention_bwd_rows.cuh`` at their head count), and the
    shared memory its row kernel states fits two blocks an SM on Hopper; the
    shared column kernel's grid follows the heads (at 8 heads, the heads by
    the row parts each head's sums are split over)."""
    common = (CSRC / "ipa_attention_bwd_common.cuh").read_text()
    assert f"constexpr int kDK = {k1.CARD_WIDTHS['head_dim']};" in common
    assert f"constexpr int kMaxCp = {k1.CARD_WIDTHS['max_cp']};" in common
    rows_design = (CSRC / "ipa_attention_bwd_rows.cuh").read_text()
    assert '#include "ipa_attention_bwd_common.cuh"' in rows_design
    for name, heads, rows in (("ipa_attention_bwd_tc.cu", 32, "bwd_rows<T, 32>"),
                              ("ipa_attention_bwd_tc16.cu", 16, "bwd_rows<T, 16>"),
                              ("ipa_attention_bwd_tc8.cu", 8, "bwd8_rows")):
        text = (CSRC / name).read_text()
        assert f"constexpr int kH = {heads};" in text, name
        if heads == 8:
            assert '#include "ipa_attention_bwd_common.cuh"' in text, name
            assert "constexpr int kColParts = H == 8 ? 4 : 1;" in common
            assert ("const dim3 cgrid((Lk + 31) / 32, kH * kColParts<kH> / kColHeads, B);"
                    in text), name
            assert "bwd_cols<T, kH><<<cgrid" in text, name
        else:
            assert '#include "ipa_attention_bwd_rows.cuh"' in text, name
            assert "launch_backward<bf16, kH>(" in text and "launch_backward<float, kH>(" in text
            assert "const dim3 cgrid((Lk + 31) / 32, H / kColHeads, B);" in rows_design
            assert "bwd_cols<T, H><<<cgrid" in rows_design
        stated = re.search(rf"Shared memory of {rows} at Cp = 256: ([\d,]+) bytes \(bf16\), "
                           r"([\d,]+) \(f32\)", text)
        assert stated is not None, name
        # Two blocks an SM: 228 KB less 1 KB a block.
        assert all(int(x.replace(",", "")) <= 233_472 // 2 - 1024 for x in stated.groups()), name


def test_cpu_backward_counts_the_torch_route():
    """CPU tensors run ipa_attention_backward whatever the widths: the pass
    counts under "torch", never under a kernel route."""
    B, H, L, dk, cp = 1, 32, 3, 16, 32
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    args = [r(B, H, L, dk), r(B, H, L, dk), r(B, H, L, dk), r(B, 3, H * 4, L), r(B, 3, H * 4, L),
            r(B, H, L, 24), r(B, L, L, cp), r(H, cp, dk), torch.zeros(B, L), r(B, H, L, L)]
    assert k1.backward_route(torch.float32, H, dk, cp, True) == "bwd_tc_f32"
    leaves = [t.requires_grad_(i != 8) for i, t in enumerate(args)]
    before, calls = dict(k1.backward_calls_by_route), k1.backward_calls
    out = k1.ipa_attention(*leaves, scalar_w=0.25, pair_w=0.5)
    sum(o.sum() for o in out).backward()
    assert k1.backward_calls == calls + 1
    assert k1.backward_calls_by_route == {**before, "torch": before["torch"] + 1}


def test_h4_backward_source_states_widths_and_shared_memory():
    """The bwd_h4 source takes the widths its route names (4 heads of 16, Cp
    up to ``H4_MAX_CP``), states its row kernel's shared memory within what
    a block may opt into on Hopper, exports it, and the route takes every
    Cp % 4 == 0 up to ``H4_MAX_CP`` in f32 with ``w_pb`` and nothing else
    at 4 heads."""
    text = (CSRC / "ipa_attention_bwd_h4.cu").read_text()
    assert "constexpr int kH = 4;" in text
    assert f"constexpr int kDK = {k1.CARD_WIDTHS['head_dim']};" in text
    assert f"constexpr int kMaxCp = {k1.H4_MAX_CP};" in text
    stated = re.search(r"Shared memory of bwd_h4_rows: ([\d,]+) bytes at Cp = 32 \(8 rows\), "
                       r"([\d,]+) at Cp = 64 \(8 rows\)", text)
    assert stated is not None
    assert all(int(x.replace(",", "")) <= 232_448 for x in stated.groups())
    assert re.search(r"\bint ipa_attention_bwd_h4_smem_bytes\(int Cp\)", text)
    for cp in range(4, k1.CARD_WIDTHS["max_cp"] + 1, 4):
        assert k1.backward_route(F32, 4, 16, cp, False) == ("bwd_h4" if cp <= k1.H4_MAX_CP
                                                           else "torch"), cp
        assert k1.backward_route(BF16, 4, 16, cp, False) == "torch", cp
        assert k1.backward_route(F32, 4, 16, cp, True) == "torch", cp


def test_cpu_in_kernel_backward_counts_the_torch_route():
    """CPU tensors with ``w_pb`` at the control net's widths run
    ipa_attention_backward, though CUDA tensors of these widths take
    "bwd_h4": the pass counts under "torch", and ``w_pb`` gets its
    gradient shaped as itself."""
    B, H, L, dk, cp = 2, 4, 5, 16, 32
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    args = [r(B, H, L, dk), r(B, H, L, dk), r(B, H, L, dk), r(B, 3, H * 4, L), r(B, 3, H * 4, L),
            r(B, H, L, 24), r(B, L, L, cp), r(H, cp, dk), torch.zeros(B, L), None, r(cp, H)]
    assert k1.backward_route(torch.float32, H, dk, cp, False) == "bwd_h4"
    leaves = [t if t is None else t.requires_grad_(i != 8) for i, t in enumerate(args)]
    before, calls = dict(k1.backward_calls_by_route), k1.backward_calls
    out = k1.ipa_attention(*leaves, scalar_w=0.25, pair_w=0.5)
    sum(o.sum() for o in out).backward()
    assert k1.backward_calls == calls + 1
    assert k1.backward_calls_by_route == {**before, "torch": before["torch"] + 1}
    assert leaves[10].grad.shape == (cp, H) and torch.isfinite(leaves[10].grad).all()


def test_card_widths_name_what_the_cuda_sources_instantiate():
    src = (CSRC / "ipa_attention.cu").read_text()
    switch = src[src.index("switch (H) {"):]
    switch = switch[:switch.index("}")]
    cases = {int(a) for a, b in re.findall(r"case (\d+): return \(int\)launch_heads<(\d+)>", switch)
             if a == b}
    takes = src[src.index("int ipa_attention_takes_heads(int H)"):]
    takes = {int(h) for h in re.findall(r"H == (\d+)", takes[:takes.index("}")])}
    assert cases == takes == set(k1.CARD_WIDTHS["heads"])
    tc = (CSRC / "ipa_attention_tc.cu").read_text()
    tc_f32 = (CSRC / "ipa_attention_tc_f32.cu").read_text()
    tc16 = [(CSRC / f"ipa_attention_{r}.cu").read_text() for r in ("tc16", "tc16_f32")]
    tc8 = [(CSRC / f"ipa_attention_{r}.cu").read_text() for r in ("tc8", "tc8_f32")]
    for text in (src, tc, tc_f32, *tc16, *tc8):
        assert f"constexpr int kDK = {k1.CARD_WIDTHS['head_dim']};" in text
        assert f"constexpr int kMaxCp = {k1.CARD_WIDTHS['max_cp']};" in text
    for text in (tc, tc_f32):
        assert "constexpr int kH = 32;" in text
    for text in tc16:
        assert "constexpr int kH = 16;" in text
    for text in tc8:
        assert "constexpr int kH = 8;" in text
    # The f32 design states its shared memory at Cp=256, within what a block
    # may opt into on Hopper (232,448 bytes).
    stated = re.search(r"Shared memory at Cp = 256: ([\d,]+) bytes", tc_f32)
    assert stated is not None
    assert int(stated.group(1).replace(",", "")) <= 232_448


def test_every_route_names_an_entry_the_cuda_sources_define():
    """Each route's C symbol is a 25-argument entry of one ``csrc/*.cu``,
    and the launch counts hold one entry a route."""
    sources = {p.name: p.read_text() for p in CSRC.glob("*.cu")}
    for route, symbol in k1._ROUTE_SYMBOLS.items():
        defined = [name for name, text in sources.items() if re.search(rf"\bint {symbol}\(", text)]
        assert len(defined) == 1, (route, symbol, defined)
        text = sources[defined[0]]
        signature = text[text.index(f"int {symbol}("):]
        assert signature[:signature.index(")")].count(",") == 24
    assert set(k1.launches_by_route) == set(k1._ROUTE_SYMBOLS) == {
        "tc", "tc_f32", "tc_pb", "tc_pb_f32", "tc16", "tc16_f32", "tc8", "tc8_f32", "h4", "simt"}
    assert k1._ROUTE_SYMBOLS["tc_f32"] == "ipa_attention_tc_f32_fwd"
    assert k1._ROUTE_SYMBOLS["tc_pb"] == "ipa_attention_tc_pb_fwd"
    assert k1._ROUTE_SYMBOLS["tc_pb_f32"] == "ipa_attention_tc_pb_f32_fwd"
    assert k1._ROUTE_SYMBOLS["tc16"] == "ipa_attention_tc16_fwd"
    assert k1._ROUTE_SYMBOLS["tc16_f32"] == "ipa_attention_tc16_f32_fwd"
    assert k1._ROUTE_SYMBOLS["tc8"] == "ipa_attention_tc8_fwd"
    assert k1._ROUTE_SYMBOLS["tc8_f32"] == "ipa_attention_tc8_f32_fwd"
    assert k1._ROUTE_SYMBOLS["h4"] == "ipa_attention_h4_fwd"


def test_each_route_symbol_has_exactly_one_extern_c_definition():
    """Every ``_ROUTE_SYMBOLS`` name is defined once across ``csrc/*.cu``,
    inside an ``extern "C"`` block, so ctypes finds it unmangled."""
    for symbol in k1._ROUTE_SYMBOLS.values():
        found = []
        for path in CSRC.glob("*.cu"):
            text = path.read_text()
            for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S):
                found += [path.name for _ in re.finditer(rf"\bint {symbol}\(", block)]
        assert len(found) == 1, (symbol, found)


def test_h4_cp_limit_is_the_sources_constant():
    """``H4_MAX_CP`` is the h4 source's ``kMaxCp``; the source's stated
    shared memory at that width fits what a block may opt into on Hopper,
    and the route takes every Cp % 4 == 0 up to it and none above."""
    src = (CSRC / "ipa_attention_h4.cu").read_text()
    assert f"constexpr int kMaxCp = {k1.H4_MAX_CP};" in src
    assert "constexpr int kH = 4;" in src
    assert f"constexpr int kDK = {k1.CARD_WIDTHS['head_dim']};" in src
    stated = re.search(rf"Shared memory at Cp = {k1.H4_MAX_CP}: ([\d,]+) bytes", src)
    assert stated is not None
    assert int(stated.group(1).replace(",", "")) <= 232_448
    assert k1.H4_MAX_CP >= 64
    for cp in range(4, k1.CARD_WIDTHS["max_cp"] + 1, 4):
        want = "h4" if cp <= k1.H4_MAX_CP else "simt"
        assert k1.kernel_route(F32, 4, 16, cp, False) == want, cp


@pytest.mark.parametrize("route,dtype,source", [("tc_pb", BF16, "ipa_attention_tc.cu"),
                                                ("tc_pb_f32", F32, "ipa_attention_tc_f32.cu")])
def test_in_kernel_32_head_designs_state_a_layout_one_block_can_hold(route, dtype, source):
    """The in-kernel pair bias at 32 heads: each design is a variant of the
    streamed design's source, whose one ``extern "C"`` entry it is; the
    source states the variant's shared memory at Cp=256 within what one
    block may opt into on Hopper (232,448 bytes) and exports that layout
    (the card tests hold ``*_smem_bytes(256)`` to the stated number). The
    route takes every Cp % 32 == 0 up to 256 at 32 heads with the
    in-kernel pair bias and nothing else: the 16- and 8-head in-kernel
    widths keep "simt", the streamed ones their own designs, and the
    backward stays "torch"."""
    src = (CSRC / source).read_text()
    blocks = "".join(re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', src, re.S))
    assert len(re.findall(rf"\bint {k1._ROUTE_SYMBOLS[route]}\(", blocks)) == 1
    assert re.search(rf"\bint ipa_attention_{route}_smem_bytes\(int Cp\)", blocks)
    stated = re.search(r"Shared memory of the variant at Cp = 256: ([\d,]+) bytes", src)
    assert stated is not None
    assert int(stated.group(1).replace(",", "")) <= 232_448
    assert "template <bool kPb>" in src and "__launch_bounds__(kThreads, 1)" in src
    streamed = "tc" if dtype == BF16 else "tc_f32"
    for cp in range(4, k1.CARD_WIDTHS["max_cp"] + 1, 4):
        assert k1.kernel_route(dtype, 32, 16, cp, False) == (route if cp % 32 == 0 else "simt"), cp
        assert k1.kernel_route(dtype, 32, 16, cp, True) == (streamed if cp % 32 == 0 else "simt"), cp
        assert k1.backward_route(dtype, 32, 16, cp, False) == "torch", cp
        for heads in (16, 8):
            assert k1.kernel_route(dtype, heads, 16, cp, False) == "simt", (heads, cp)
    assert k1.kernel_route(dtype, 4, 16, 32, False) == ("simt" if dtype == BF16 else "h4")


@pytest.mark.parametrize("design,dtype", [("tc_pb", BF16), ("tc_pb_f32", F32)])
def test_in_kernel_32_head_designs_refuse_what_they_do_not_take(design, dtype):
    """Before any build: the in-kernel designs refuse the streamed variant
    and the streamed designs refuse ``w_pb`` at 32 heads; ``"tc_pb_f32"``
    needs a 16-byte aligned w_pv as ``"tc_f32"`` does (a view 4 bytes into
    its storage is refused with a ValueError, never taken by another
    design)."""
    B, H, L, dk, cp = 1, 32, 3, 16, 32
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    args = [z(B, H, L, dk, dt=dtype), z(B, H, L, dk, dt=dtype), z(B, H, L, dk, dt=dtype),
            z(B, 3, H * 4, L), z(B, 3, H * 4, L), z(B, H, L, 24), z(B, L, L, cp, dt=dtype),
            z(H, cp, dk, dt=dtype), z(B, L), None, z(cp, H)]
    streamed = args[:9] + [z(B, H, L, L, dt=dtype)]
    kw = dict(scalar_w=1.0, pair_w=1.0)
    assert k1.kernel_route(dtype, H, dk, cp, False) == design
    with pytest.raises(ValueError, match=f"{design!r} design does not take these widths"):
        k1._launch_design(design, *streamed, **kw)
    other = "tc" if dtype == BF16 else "tc_f32"
    with pytest.raises(ValueError, match=f"{other!r} design does not take these widths"):
        k1._launch_design(other, *args, **kw)
    if design == "tc_pb_f32":
        bad = list(args)
        bad[7] = torch.zeros(args[7].numel() + 1)[1:].view(args[7].shape)
        assert bad[7].is_contiguous() and bad[7].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned w_pv"):
            k1._launch_design(design, *bad, **kw)


@pytest.mark.parametrize("route,dtype", [("tc16", BF16), ("tc16_f32", F32),
                                         ("bwd_tc16", BF16), ("bwd_tc16_f32", F32)])
def test_16_head_designs_state_a_layout_two_blocks_an_sm_can_hold(route, dtype):
    """Each 16-head tensor-core source (the forwards, and the backward of
    both dtypes in ``ipa_attention_bwd_tc16.cu``) states its shared memory
    at Cp=256, within what two blocks of one Hopper SM may hold (233,472
    bytes less 1,024 a block), exports that layout and its resident blocks
    an SM, and its design takes every Cp % 32 == 0 up to 256 at 16 heads
    with the streamed pair bias and nothing else; the card tests hold the
    library's ``*_smem_bytes(256)`` to the stated number. The backward's
    row design (``ipa_attention_bwd_rows.cuh``, which the source includes)
    holds its block size and launch bounds."""
    backward = route.startswith("bwd_")
    src = (CSRC / f"ipa_attention_{'bwd_tc16' if backward else route}.cu").read_text()
    if backward:
        assert '#include "ipa_attention_bwd_rows.cuh"' in src
        src += (CSRC / "ipa_attention_bwd_rows.cuh").read_text()
        stated = re.search(r"Shared memory of bwd_rows<T, 16> at Cp = 256: ([\d,]+) bytes "
                           r"\(bf16\), ([\d,]+) \(f32\)\s*// \(two 256-thread blocks an SM\)",
                           src)
        stated = stated and stated.group(1 if dtype == BF16 else 2)
    else:
        stated = re.search(r"Shared memory at Cp = 256: ([\d,]+) bytes \(two 256-thread blocks an "
                           r"SM\)", src)
        stated = stated and stated.group(1)
    assert stated is not None
    assert int(stated.replace(",", "")) <= (233_472 - 2 * 1_024) // 2
    assert "constexpr int kThreads = 256;" in src and "__launch_bounds__(kThreads, 2)" in src
    for name in (f"ipa_attention_{route}_smem_bytes", f"ipa_attention_{route}_blocks_per_sm"):
        assert re.search(rf"\bint {name}\(int Cp\)", src), name
    route_of, other = (k1.backward_route, "torch") if backward else (k1.kernel_route, "simt")
    for cp in range(4, k1.CARD_WIDTHS["max_cp"] + 1, 4):
        want = route if cp % 32 == 0 else other
        assert route_of(dtype, 16, 16, cp, True) == want, cp
        assert route_of(dtype, 16, 16, cp, False) == other, cp


@pytest.mark.parametrize("dtype,route,bwd_route", [(BF16, "tc16", "bwd_tc16"),
                                                   (F32, "tc16_f32", "bwd_tc16_f32")])
def test_a_tensor_parallel_rank_at_model_2_takes_the_16_head_designs(dtype, route, bwd_route):
    """The attention layer of bioemu-v1.0's score model split over two model
    ranks (``--mesh model=2``) holds 16 heads of 16 with the streamed pair
    bias: its forward and backward take the 16-head tensor-core designs."""
    from types import SimpleNamespace

    from se3diff_torch.models.dig import SAAttention

    cfg = BIOEMU_V1_MODEL
    layer = SAAttention(cfg["dim_model"], cfg["dim_pair"], cfg["num_heads"],
                        tp=SimpleNamespace(model=2))
    H, dk, cp = layer.n_head, layer.head_dim, layer.d_pair
    assert (H, dk, cp) == (16, 16, 256)
    assert k1.kernel_route(dtype, H, dk, cp, True) == route
    assert k1.backward_route(dtype, H, dk, cp, True) == bwd_route



@pytest.mark.parametrize("route,dtype", [("tc8", BF16), ("tc8_f32", F32)])
def test_8_head_designs_state_a_layout_two_blocks_an_sm_can_hold(route, dtype):
    """Each 8-head tensor-core source states its shared memory at Cp=256,
    within what two blocks of one Hopper SM may hold (233,472 bytes less
    1,024 a block), exports that layout and its resident blocks an SM, and
    its design takes every Cp % 32 == 0 up to 256 at 8 heads with the
    streamed pair bias and nothing else; the card tests hold the library's
    ``*_smem_bytes(256)`` to the stated number."""
    src = (CSRC / f"ipa_attention_{route}.cu").read_text()
    stated = re.search(r"Shared memory at Cp = 256: ([\d,]+) bytes \(two 256-thread blocks an "
                       r"SM\)", src)
    assert stated is not None
    assert int(stated.group(1).replace(",", "")) <= (233_472 - 2 * 1_024) // 2
    assert "constexpr int kThreads = 256;" in src and "__launch_bounds__(kThreads, 2)" in src
    for name in (f"ipa_attention_{route}_smem_bytes", f"ipa_attention_{route}_blocks_per_sm"):
        assert re.search(rf"\bint {name}\(int Cp\)", src), name
    for cp in range(4, k1.CARD_WIDTHS["max_cp"] + 1, 4):
        assert k1.kernel_route(dtype, 8, 16, cp, True) == (route if cp % 32 == 0 else "simt"), cp
        assert k1.kernel_route(dtype, 8, 16, cp, False) == "simt", cp


@pytest.mark.parametrize("dtype,route", [(BF16, "tc8"), (F32, "tc8_f32")])
def test_a_tensor_parallel_rank_at_model_4_takes_the_8_head_designs(dtype, route):
    """The attention layer of bioemu-v1.0's score model split over four
    model ranks (``--mesh model=4``) holds 8 heads of 16 with the streamed
    pair bias: its forward takes the 8-head tensor-core designs, its
    backward the 8-head backward kernel of the same dtype ("bwd_tc8",
    "bwd_tc8_f32")."""
    from types import SimpleNamespace

    from se3diff_torch.models.dig import SAAttention

    cfg = BIOEMU_V1_MODEL
    layer = SAAttention(cfg["dim_model"], cfg["dim_pair"], cfg["num_heads"],
                        tp=SimpleNamespace(model=4))
    H, dk, cp = layer.n_head, layer.head_dim, layer.d_pair
    assert (H, dk, cp) == (8, 16, 256)
    assert k1.kernel_route(dtype, H, dk, cp, True) == route
    assert k1.backward_route(dtype, H, dk, cp, True) == f"bwd_{route}"


@pytest.mark.parametrize("design,dtype", [("tc8", BF16), ("tc8_f32", F32)])
def test_8_head_designs_refuse_misaligned_operands(design, dtype):
    """At their widths the 8-head designs need 16-byte aligned pa and w_pv
    (x2d and k_s are checked for every design): a view 4 bytes into its
    storage is refused with a ValueError before any build, never taken by
    another design."""
    B, H, L, dk, cp = 1, 8, 3, 16, 32
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    args = [z(B, H, L, dk, dt=dtype), z(B, H, L, dk, dt=dtype), z(B, H, L, dk, dt=dtype),
            z(B, 3, H * 4, L), z(B, 3, H * 4, L), z(B, H, L, 24), z(B, L, L, cp, dt=dtype),
            z(H, cp, dk, dt=dtype), z(B, L), z(B, H, L, L, dt=dtype)]
    assert k1.kernel_route(dtype, H, dk, cp, True) == design
    shifted = lambda t: torch.zeros(t.numel() + 4 // t.element_size(), dtype=t.dtype)[
        4 // t.element_size():].view(t.shape)
    kw = dict(scalar_w=1.0, pair_w=1.0)
    for i, name in ((9, "pa"), (7, "w_pv")):
        bad = list(args)
        bad[i] = shifted(args[i])
        assert bad[i].is_contiguous() and bad[i].data_ptr() % 16
        with pytest.raises(ValueError, match=f"16-byte aligned {name}"):
            k1._launch_design(design, *bad, **kw)

def test_check_card_widths():
    for cfg in (BIOEMU_V1_MODEL, dict(dim_model=64, dim_pair=32, num_heads=4),
                dict(dim_model=128, dim_pair=64, num_heads=8), dict(dim_model=256, num_heads=16)):
        k1.check_card_widths(cfg, "cuda")
    for cfg in REFUSED + [dict(dim_pair=300), dict(dim_pair=30, dim_model=64, num_heads=4)]:
        with pytest.raises(ValueError, match=WIDTHS_MSG):
            k1.check_card_widths(cfg, "cuda")
        with pytest.raises(ValueError, match=WIDTHS_MSG):
            k1.check_card_widths(cfg, torch.device("cuda", 0))
        k1.check_card_widths(cfg, "cpu")  # the plain version takes any width


def _config(tmp_path, cfg):
    block = {"_target_": "bioemu.shortcuts.DiGConditionalScoreModel", **cfg, "num_layers": 1}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump({"score_model": block, "finetune_model": block}))
    return path


@pytest.mark.parametrize("cfg", REFUSED)
def test_load_bundle_refuses_card_widths_before_the_device(tmp_path, cfg):
    path = _config(tmp_path, cfg)
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        load_bundle(tmp_path / "missing.npz", config_path=path, device="cuda")
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        random_bundle(model_cfg=cfg, device="cuda")


@pytest.mark.parametrize("cfg", REFUSED)
def test_train_cli_refuses_card_widths_before_the_device(tmp_path, cfg):
    argv = ["--trajectory", str(tmp_path / "missing.xtc"), "--model_config_path",
            str(_config(tmp_path, cfg)), "--device", "cuda"]
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        train.main(argv)


@pytest.mark.parametrize("cfg", REFUSED)
def test_finetune_cli_refuses_card_widths_before_the_device(tmp_path, cfg):
    argv = ["--csv_path", str(tmp_path / "train.csv"), "--csv_path_val", str(tmp_path / "val.csv"),
            "--h_stars_cols", "f_dg_pred", "--ckpt_path", str(tmp_path / "missing.npz"),
            "--model_config_path", str(_config(tmp_path, cfg)), "--device", "cuda"]
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        finetune.main(argv)


def test_control_net_widths_are_checked_apart(tmp_path):
    """A score model the card takes with a control net it refuses."""
    path = tmp_path / "config.yaml"
    target = "bioemu.shortcuts.DiGConditionalScoreModel"
    path.write_text(yaml.safe_dump({
        "score_model": {"_target_": target, **BIOEMU_V1_MODEL},
        "finetune_model": {"_target_": target, **REFUSED[1]},
    }))
    from se3diff_torch.ppft.trainer import load_finetune_bundle

    with pytest.raises(ValueError, match="num_heads=12"):
        load_finetune_bundle(tmp_path / "missing.npz", model_config_path=path, device="cuda")


def test_launch_design_refuses_what_it_does_not_take():
    """The private timing entry: unknown designs, and the tensor-core design
    at widths its route does not take, fail before any build."""
    B, H, L, dk, cp = 1, 4, 3, 16, 32
    z = lambda *s: torch.zeros(s)
    args = (z(B, H, L, dk), z(B, H, L, dk), z(B, H, L, dk), z(B, 3, H * 4, L), z(B, 3, H * 4, L),
            z(B, H, L, 24), z(B, L, L, cp), z(H, cp, dk), z(B, L), z(B, H, L, L))
    kw = dict(scalar_w=1.0, pair_w=1.0)
    with pytest.raises(ValueError, match="design must be one of"):
        k1._launch_design("wgmma", *args, **kw)
    with pytest.raises(ValueError, match="does not take these widths"):
        k1._launch_design("tc", *args, **kw)
    with pytest.raises(ValueError, match="'h4' design does not take these widths"):
        k1._launch_design("h4", *args, **kw)   # the streamed variant
    # The f32 tensor-core design refuses bf16 operands at its own widths.
    H, cp = 32, 32
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)
    args = (bf(B, H, L, dk), bf(B, H, L, dk), bf(B, H, L, dk), z(B, 3, H * 4, L), z(B, 3, H * 4, L),
            z(B, H, L, 24), bf(B, L, L, cp), bf(H, cp, dk), z(B, L), bf(B, H, L, L))
    assert k1.kernel_route(torch.bfloat16, H, dk, cp, True) == "tc"
    with pytest.raises(ValueError, match="'tc_f32' design does not take these widths"):
        k1._launch_design("tc_f32", *args, **kw)
    # At its widths it needs 16-byte aligned pa and w_pv (views 4 bytes in).
    f32 = [a.float() for a in args]
    shifted = lambda t: torch.zeros(t.numel() + 1)[1:].view(t.shape)
    for i, name in ((9, "pa"), (7, "w_pv")):
        bad = list(f32)
        bad[i] = shifted(f32[i])
        assert bad[i].is_contiguous() and bad[i].data_ptr() % 16
        with pytest.raises(ValueError, match=f"16-byte aligned {name}"):
            k1._launch_design("tc_f32", *bad, **kw)
    # The h4 design needs 16-byte aligned q_s, v_s, v_p, w_pv and w_pb
    # (16-byte loads and copies; x2d and k_s are checked for every design).
    H, cp = 4, 32
    args = [z(B, H, L, dk), z(B, H, L, dk), z(B, H, L, dk), z(B, 3, H * 4, L), z(B, 3, H * 4, L),
            z(B, H, L, 24), z(B, L, L, cp), z(H, cp, dk), z(B, L), None, z(cp, H)]
    assert k1.kernel_route(torch.float32, H, dk, cp, False) == "h4"
    for i in (0, 2, 5, 7, 10):
        bad = list(args)
        bad[i] = shifted(args[i])
        with pytest.raises(ValueError, match="h4 design needs 16-byte aligned q_s, v_s, v_p"):
            k1._launch_design("h4", *bad, **kw)


def test_library_name_follows_every_source_and_header(tmp_path, monkeypatch):
    """The library's name is a digest of the flags, the ``.cu`` sources and
    the headers beside them, computed before any build: an edit to a header
    a source includes names a new library, so a stale one is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("constexpr int kH = 32;\n")
    (csrc / "notes.txt").write_text("not a source")
    monkeypatch.setattr(k1, "CSRC", csrc)
    monkeypatch.setattr(k1, "BUILD_DIR", tmp_path / "_build")
    first = k1.library_path()
    assert first.parent == tmp_path / "_build" and first.name.startswith("libipa_attention_")
    (csrc / "notes.txt").write_text("other text")
    assert k1.library_path() == first
    (csrc / "common.cuh").write_text("constexpr int kH = 16;\n")
    second = k1.library_path()
    assert second != first
    (csrc / "common.h").write_text("// a plain header\n")
    assert k1.library_path() not in (first, second)
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert k1.library_path() != second
