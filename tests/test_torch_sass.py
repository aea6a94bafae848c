"""The SASS reader of ``utils.sass`` on hand-written listings in the form
``cuobjdump --dump-sass`` prints: which registers an instruction writes,
and where a ``wgmma.sp`` product's metadata register may be written while
its group is still in flight (on a loop's back edge, inside an uncommitted
group, on a branch that skips the wait). The built libraries are read on
the card (``tests/test_torch_cuda.py``)."""

import pytest

from sparsifyme_tpu_torch.utils import sass


def _listing(*lines):
    """``lines`` as one function's SASS, 16 bytes an instruction."""
    return "\n".join(f"        /*{16 * i:04x}*/                   {ln} ;"
                     for i, ln in enumerate(lines))


def _hazards(*lines):
    return [(reg, writer) for writer, reg, _ in
            sass.metadata_hazards(sass.parse(_listing(*lines)))]


# a k-step loop in the form the ring step's first design compiled to: the
# loop top reads the clock into R56:R57 for the barrier wait's timeout,
# then loads the next stage's metadata into R56 and R57 and issues two
# products, one group, and waits for all but one group
LOOP = ("CS2R R56, SR_CLOCKLO",                                      # 0x00
        "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R81+URZ], R76",         # 0x10
        "LDS R56, [R90+0x2000]",                                     # 0x20
        "LDS R57, [R90+0x2100]",                                     # 0x30
        "WARPGROUP.ARRIVE",                                          # 0x40
        "HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R56, 0x0",
        "R2UR UR6, R76",                                             # 0x60
        "HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R57, 0x0, "
        "gsb0",                                                      # 0x70
        "WARPGROUP.DEPBAR.LE gsb0, 0x{left}",                        # 0x80
        "ISETP.GE.AND P1, PT, R86, R77, PT",                         # 0x90
        "@!P1 BRA 0x0",                                              # 0xa0
        "WARPGROUP.DEPBAR.LE gsb0, 0x0",                             # 0xb0
        "IMAD.MOV.U32 R56, RZ, RZ, R4",                              # 0xc0
        "EXIT")


def _loop(left):
    return [ln.format(left=left) for ln in LOOP]


def test_parse_reads_address_predicate_opcode_and_operands():
    got = sass.parse(_listing(
        "@!P0 SYNCS.ARRIVE.TRANS64.A1T0 RZ, [R74+URZ], RZ",
        "HGMMA.SP.64x128x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R57, 0x0, "
        "gsb0",
        "STG.E desc[UR4][R2.64], R5"))
    assert got == [
        (0x00, True, "SYNCS.ARRIVE.TRANS64.A1T0", ["RZ", "[R74+URZ]", "RZ"]),
        (0x10, False, "HGMMA.SP.64x128x32.F32.BF16",
         ["R24", "gdesc[UR4].tnspB", "R24", "R57", "0x0", "gsb0"]),
        (0x20, False, "STG.E", ["desc[UR4][R2.64]", "R5"])]


def test_functions_splits_a_library_listing():
    text = ("\t\tFunction : _Z1av\n" + _listing("NOP", "EXIT") +
            "\n\t\tFunction : _Z1bv\n" + _listing("EXIT"))
    assert {name: len(ins) for name, ins in
            sass.functions(text).items()} == {"_Z1av": 2, "_Z1bv": 1}


@pytest.mark.parametrize("line,regs", [
    ("IMAD.MOV.U32 R56, RZ, RZ, R4", [56]),
    ("CS2R R56, SR_CLOCKLO", [56, 57]),
    ("CS2R.32 R56, SR_CLOCKLO", [56]),
    ("IMAD.WIDE.U32 R10, R3, 0x4, R8", [10, 11]),
    ("LDS.128 R8, [R90]", [8, 9, 10, 11]),
    ("LDS.64 R8, [R90]", [8, 9]),
    ("@P0 IADD3 R88, P0, -R56, R76, RZ", [88]),
    ("STS [R90+0x2000], R56", []),
    ("SYNCS.ARRIVE.TRANS64.A1T0 RZ, [R74+URZ], RZ", []),
    ("SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R81+URZ], R76", []),
    ("HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R56, 0x0", []),
    ("R2UR UR6, R76", []),
])
def test_written_registers(line, regs):
    (_, _, op, ops), = sass.parse(_listing(line))
    assert sass.written(op, ops) == regs


def test_a_group_left_in_flight_over_the_back_edge_is_found():
    """One group in flight at the back edge: the clock read at the loop's
    top and the next stage's metadata loads write R56 and R57."""
    assert _hazards(*_loop(1)) == [(56, 0x00), (57, 0x00), (56, 0x20),
                                   (57, 0x30)]


def test_each_stage_retired_before_the_next_is_clean():
    """kRing's loop: the stage's group retired (DEPBAR.LE 0) before the
    back edge."""
    assert _hazards(*_loop(0)) == []


def test_a_write_inside_an_uncommitted_group_is_found():
    """The first product runs as soon as it is issued, before its group is
    committed."""
    assert _hazards(
        "HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R56, 0x0",
        "MOV R56, 0x1",
        "HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R57, 0x0, "
        "gsb0",
        "WARPGROUP.DEPBAR.LE gsb0, 0x0",
        "EXIT") == [(56, 0x10)]


def test_a_branch_that_skips_the_wait_is_followed():
    """The wait on one path does not cover the other: the write after the
    join may follow the path that skipped it."""
    lines = ["HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R56, "
             "0x0, gsb0",
             "@P0 BRA 0x30",
             "WARPGROUP.DEPBAR.LE gsb0, 0x0",
             "MOV R56, 0x1",
             "EXIT"]
    assert _hazards(*lines) == [(56, 0x30)]
    lines[1] = "NOP"
    assert _hazards(*lines) == []


def test_older_groups_retire_in_commit_order():
    """DEPBAR.LE 1 after two groups retires the first (R56) and leaves the
    second (R57) in flight."""
    assert _hazards(
        "HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R56, 0x0, "
        "gsb0",
        "HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R57, 0x0, "
        "gsb0",
        "WARPGROUP.DEPBAR.LE gsb0, 0x1",
        "MOV R56, 0x1",
        "MOV R57, 0x1",
        "EXIT") == [(57, 0x40)]


def test_an_exit_ends_a_path():
    assert _hazards(
        "HGMMA.SP.64x64x32.F32.BF16 R24, gdesc[UR4].tnspB, R24, R56, 0x0, "
        "gsb0",
        "EXIT",
        "MOV R56, 0x1",
        "EXIT") == []
