"""``ops/sass.py``: instruction counts from a ``cuobjdump -sass`` listing.

The listing below is written by hand in cuobjdump's format (``Function :``
headers, ``/*addr*/`` instructions, branch targets as addresses or as
``.L_x_`` labels); on the card ``chip_smoke.py`` phase 3i reads the built
library's own listing.
"""

import pytest

from dmf_tpu_torch.ops import sass


def _listing(name, body, start=0):
    lines = [f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"']
    for i, op in enumerate(body):
        if op.endswith(":"):
            lines.append(f"{op}")
            continue
        addr = start + 16 * sum(1 for o in body[:i] if not o.endswith(":"))
        lines.append(f"        /*{addr:04x}*/                   {op} ;"
                     f"                /* 0x000fe20000000f00 */")
    return "\n".join(lines) + "\n"


# a draw loop: 4 shuffles and 16 wide multiplies in 40 instructions (8
# calls: 5 instructions a call), then a shuffle's out-of-line retry loop
DRAW = (["S2R R0, SR_TID.X", ".L_x_1:"]
        + ["IMAD.WIDE.U32 R4, R2, -0x2daee0ad, RZ", "LOP3.LUT R6, R5, UR4, R7, 0x96, !PT"] * 16
        + ["SHFL.IDX PT, R8, R9, RZ, 0x1f"] * 4
        + ["IADD3 R2, R2, 0x1, RZ", "ISETP.GE.AND P0, PT, R2, R3, PT", "@!P0 BRA `(.L_x_1)"]
        + ["EXIT", ".L_x_2:", "SHFL.IDX PT, R8, R9, RZ, 0x1f", "@P0 BRA `(.L_x_2)"])


def _tile_loop(extra):
    """A consumer key-tile loop of 10 instructions (an HGMMA among them)
    plus ``extra``, with a back branch by address."""
    body = ["MOV R1, c[0x0][0x28]"] + ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ"] \
        + ["FFMA R2, R3, R4, R5"] * 7 + ["IMAD R6, R7, R8, R9"] * extra
    return body + [f"@P0 BRA 0x{16:x}", "EXIT"]


def test_draw_loop_is_the_smallest_loop_with_the_calls():
    funcs = sass.functions(_listing("_Z4drawILi128ELi2EEv", DRAW))
    ins, labels = funcs["_Z4drawILi128ELi2EEv"]
    assert labels == {".L_x_1": 16, ".L_x_2": 16 * (1 + 32 + 4 + 3 + 1)}
    # the retry loop holds a shuffle but no multiply: not the draw loop
    assert sass.draw_loop_per_call(ins, labels) == (32 + 4 + 3) / 8


def test_per_call_counts_both_instances():
    text = (_listing("_ZN2wg15flash_fwd_wgmmaILi128ELi0EEEv", _tile_loop(0))
            + _listing("_ZN2wg15flash_fwd_wgmmaILi128ELi1EEEv", _tile_loop(6400))
            + _listing("_ZN2wg15flash_fwd_wgmmaILi128ELi2EEEv", _tile_loop(3))
            + _listing("_ZN2hs9draw_bitsILi128EEEv", DRAW))
    got = sass.per_call(text, "flash_fwd_wgmma", 128, 128)
    assert got == {"head_shared": (32 + 4 + 3) / 8, "per_element": 6400 / 64}
    with pytest.raises(ValueError, match="functions match"):
        sass.per_call(text, "flash_fwd_wgmma", 64, 128)
    with pytest.raises(ValueError, match="functions match"):
        sass.per_call(text, "flash_fwd_wgmma", 128, 32)


@pytest.mark.parametrize("weights,passes,base,calls", [
    (8 * 4 * 4096 * 4096, 1, 2 ** 33, 8 * 4096 * 4096),  # the served call: a quarter
    (16, 3, 4, 12),                                      # aligned: 4 counters a call
    (16, 1, 2, 5),                                       # base = 2 mod 4: one group more
    (1, 2, 7, 2)])
def test_philox_calls_count_counter_groups(weights, passes, base, calls):
    assert sass.philox_calls(weights, passes, base) == calls


def test_issue_floor_and_select():
    # 41 instructions x 134M calls over 132 SMs x 128 lanes a clock at 1980 MHz
    assert sass.PHILOX_CALL_INSTRUCTIONS == 41
    assert sass.issue_floor_ms(8 * 4 * 4096 * 4096 // 4, 1980.0) == pytest.approx(
        41 * 2 ** 27 / (132 * 128 * 1980e6) * 1e3)
    assert sass.issue_floor_ms(8 * 4 * 4096 * 4096 // 4, 1980.0) == pytest.approx(0.1645,
                                                                                  abs=1e-4)
    text = _listing("_Z1aILi64ELi2EEv", ["EXIT"]) + _listing("_Z1bv", ["EXIT"])
    assert "_Z1bv" not in sass.select(text, ("_Z1a",))
    assert "_Z1aILi64ELi2EEv" in sass.select(text, ("_Z1a",))
