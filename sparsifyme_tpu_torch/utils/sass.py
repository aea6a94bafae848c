"""Reading a built library's SASS for one hazard of Hopper's ``wgmma.sp``.

``wgmma.mma_async.sp`` takes its sparsity metadata in a general register,
and the warpgroup may read that register while the product runs: until a
``wgmma.wait_group`` retires the group. ``ptxas`` does not treat the
register as busy, so it may give it to another value while the group is
still in flight: with one group left in flight, K7's ``kRing`` loop once
had a clock read of the next barrier wait land on it (some warps' products
came out wrong now and then), and K3's ``kFull`` loop loaded the next
stage's metadata words into it. In SASS the product is ``HGMMA.SP ... Rmeta, sel[, gsb0]``, the
group is committed by the ``gsb0`` operand and retired by
``WARPGROUP.DEPBAR.LE gsb0, N`` (at most ``N`` committed groups left in
flight).

:func:`metadata_hazards` walks a function's control flow (branches
followed, loops to a fixed point) and reports every instruction that may
write a metadata register of a group that may still be in flight.
:func:`library_hazards` does so for every function of a built library
(``cuobjdump --dump-sass``; needs the CUDA toolkit).
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path
from typing import Dict, FrozenSet, List, Tuple

_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Za-z0-9_.]*)\s*"
    r"([^;]*);")
_REG = re.compile(r"^R(\d+)$")
_CAP = 16  # groups deeper than this are as good as retired by any DEPBAR

Instr = Tuple[int, bool, str, List[str]]  # address, predicated, op, operands
State = FrozenSet[Tuple[int, int]]  # (register, groups committed since)


def _operands(text: str) -> List[str]:
    """``text`` split at its top-level commas (none inside brackets)."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += ch == "["
        depth -= ch == "]"
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def parse(body: str) -> List[Instr]:
    """The instructions of one function's SASS, in address order."""
    out = []
    for m in _LINE.finditer(body):
        out.append((int(m.group(1), 16), bool(m.group(2)), m.group(3),
                    _operands(m.group(4))))
    return out


def functions(sass: str) -> Dict[str, List[Instr]]:
    """``{mangled name: instructions}`` of ``cuobjdump --dump-sass`` output."""
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = parse(body)
    return funcs


def _reg(operand: str):
    m = _REG.match(operand.split(".")[0].lstrip("-|~"))
    return int(m.group(1)) if m else None


def written(op: str, operands: List[str]) -> List[int]:
    """The general registers an instruction writes: its first operand where
    that is a register (stores, branches and barriers have none), as wide
    as the operation."""
    if op.startswith(("HGMMA", "ST", "RED", "BRA", "WARPGROUP")) or \
            not operands:
        return []
    first = _reg(operands[0])
    if first is None:
        return []
    width = 1
    if ".128" in op:
        width = 4
    elif ".64" in op or ".WIDE" in op or \
            (op.startswith("CS2R") and ".32" not in op) or \
            op.startswith(("DADD", "DMUL", "DFMA")):
        width = 2
    return list(range(first, first + width))


def metadata_hazards(instrs: List[Instr]) -> List[Tuple[int, int, int]]:
    """Every ``(writer address, register, HGMMA.SP address)`` where an
    instruction may write the metadata register of an ``HGMMA.SP`` whose
    group may still be in flight, on any path through the function."""
    index = {addr: i for i, (addr, _, _, _) in enumerate(instrs)}
    issued: Dict[int, int] = {}  # metadata register -> its HGMMA.SP
    states: Dict[int, State] = {0: frozenset()} if instrs else {}
    work = [0] if instrs else []
    hazards = set()
    while work:
        i = work.pop()
        state = set(states[i])
        addr, pred, op, ops = instrs[i]
        live = {reg for reg, _ in state}
        for reg in written(op, ops):
            if reg in live:
                hazards.add((addr, reg, issued[reg]))
        succ = [i + 1] if i + 1 < len(instrs) else []
        if op.startswith("HGMMA.SP"):
            regs = [r for r in map(_reg, ops) if r is not None]
            if regs:
                issued[regs[-1]] = addr
                state.add((regs[-1], -1))  # -1: not yet committed
            if "gsb0" in ops:
                state = {(r, min(d + 1, _CAP)) for r, d in state}
        elif op.startswith("WARPGROUP.DEPBAR"):
            left = int(ops[-1], 16)
            state = {(r, d) for r, d in state if d < left}
        elif op.startswith("BRA"):
            targets = [int(o, 16) for o in ops if o.startswith("0x")]
            succ = [index[t] for t in targets if t in index] + \
                (succ if pred else [])
        elif op in ("EXIT", "RET", "RET.REL", "RET.ABS") and not pred:
            succ = []
        new = frozenset(state)
        for j in succ:
            merged = states.get(j, frozenset()) | new
            if j not in states or merged != states[j]:
                states[j] = merged
                work.append(j)
    return sorted(hazards)


def dump(lib: Path) -> str:
    """``cuobjdump --dump-sass`` of a built library."""
    from .. import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "--dump-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def library_hazards(lib: Path) -> Dict[str, List[Tuple[int, int, int]]]:
    """:func:`metadata_hazards` of every function of ``lib`` that issues an
    ``HGMMA.SP`` (an empty list where it has none)."""
    return {name: metadata_hazards(instrs)
            for name, instrs in functions(dump(lib)).items()
            if any(op.startswith("HGMMA.SP") for _, _, op, _ in instrs)}
