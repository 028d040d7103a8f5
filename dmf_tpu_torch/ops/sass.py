"""Instruction counts from the SASS of a built CUDA library.

The flash forward's attention-weight dropout is bound by integer issue as
well as by the tensor cores.  Its integer-issue floor is the function's:
the Philox4x32-10 calls the keep bits need (one for the four heads of a
weight, :func:`philox_calls`) times the instructions a call needs at least
(``PHILOX_CALL_INSTRUCTIONS``), over what the SMs issue (4 warp
instructions a clock each, 128 threads' instructions).  That floor is the
same for both instances.  What each instance spends a call, read out of
``cuobjdump -sass`` of the built library (on the card's machine, where the
toolkit is), is a diagnostic beside it; the parsing is plain text and runs
anywhere:

* the head-shared instance (``DROP_SHARED``): its pre-pass (``draw_bits``)
  loop is the smallest loop that holds the lane transposition's
  ``SHFL.IDX`` (4 a chunk of 8 calls); its instructions over its calls are
  the instructions a call, the transposition, stores and loop included;
* the per-element instance (``DROP_EACH``): its consumers' key-tile loop
  (the largest loop with an ``HGMMA``) less the same loop of the instance
  without dropout, over the calls a consumer thread makes a tile.
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

Listing = List[Tuple[int, str]]  # (address, instruction) in address order

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"\bBRA(?:\.[A-Z0-9_]+)*\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")
# issue rate of an SM: 4 warp instructions a clock (one a sub-partition)
ISSUE_PER_SM_CLOCK = 4 * 32
# SASS instructions a Philox4x32-10 call and its keep tests need at least,
# on counters (e/4 lo, e/4 hi, pass, 0) of one pass and high word: rounds
# 3-10 are two 32 x 32 -> 64-bit multiplies (IMAD.WIDE.U32) and two
# three-input xors (LOP3) each; round 1 one multiply (the low word's; the
# pass word's product is the same for every call) and one xor; round 2 one
# multiply and two xors (its first word is round 1's constant one); then
# one compare a word for the four keep bits
PHILOX_CALL_INSTRUCTIONS = 8 * 4 + 2 + 3 + 4


def dump(library: str, cuobjdump: Optional[str] = None) -> str:
    """``cuobjdump -sass`` of ``library`` (the toolkit's, beside nvcc)."""
    if cuobjdump is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cuobjdump = os.path.join(cuda_home, "bin", "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=600).stdout


def functions(text: str) -> Dict[str, Tuple[Listing, Dict[str, int]]]:
    """Each function's instructions and its labels' addresses."""
    out: Dict[str, Tuple[Listing, Dict[str, int]]] = {}
    ins: Optional[Listing] = None
    labels: Dict[str, int] = {}
    pending: List[str] = []
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            ins, labels, pending = [], {}, []
            out[m.group(1)] = (ins, labels)
            continue
        if ins is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTRUCTION.match(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            ins.append((addr, m.group(2)))
    return out


def loops(ins: Listing, labels: Dict[str, int]) -> List[Tuple[int, int]]:
    """(first, last) instruction indices of every backward branch's loop."""
    index = {addr: i for i, (addr, _) in enumerate(ins)}
    found = []
    for i, (addr, op) in enumerate(ins):
        m = _BRANCH.search(op)
        if not m:
            continue
        target = m.group(1)
        to = labels.get(target) if target.startswith(".L") else int(target, 16)
        if to is not None and to <= addr and to in index:
            found.append((index[to], i))
    return found


def _count(ins: Listing, span: Tuple[int, int], pattern: str) -> int:
    return sum(1 for _, op in ins[span[0]:span[1] + 1] if re.search(pattern, op))


def find(funcs: Dict[str, Tuple[Listing, Dict[str, int]]], *parts: str) -> str:
    """The one function whose (mangled) name holds every one of ``parts``."""
    names = [n for n in funcs if all(p in n for p in parts)]
    if len(names) != 1:
        raise ValueError(f"sass: {len(names)} functions match {parts}")
    return names[0]


def draw_loop_per_call(ins: Listing, labels: Dict[str, int]) -> float:
    """Instructions a Philox call in the head-shared instance's draw loop:
    the smallest loop holding a ``SHFL.IDX`` and the calls' multiplies (not
    a shuffle's out-of-line retry), over its 2 calls a shuffle (8 calls and
    4 shuffles a chunk)."""
    spans = [sp for sp in loops(ins, labels) if _count(ins, sp, r"\bSHFL\.IDX\b")
             and _count(ins, sp, r"\bIMAD\.(WIDE|HI)") >= 8]
    if not spans:
        raise ValueError("sass: no loop with SHFL.IDX")
    span = min(spans, key=lambda sp: sp[1] - sp[0])
    calls = 2 * _count(ins, span, r"\bSHFL\.IDX\b")
    return (span[1] - span[0] + 1) / calls


def tile_loop_size(ins: Listing, labels: Dict[str, int]) -> int:
    """Instructions of the consumers' key-tile loop: the largest loop that
    holds an ``HGMMA``."""
    spans = [sp for sp in loops(ins, labels) if _count(ins, sp, r"\bHGMMA\b")]
    if not spans:
        raise ValueError("sass: no loop with HGMMA")
    span = max(spans, key=lambda sp: sp[1] - sp[0])
    return span[1] - span[0] + 1


def per_call(text: str, kernel: str, d: int, bn: int) -> Dict[str, float]:
    """SASS instructions a Philox call of the dropout instances of ``kernel``
    (``flash_fwd_wgmma`` or ``flash_fwd_tf32x3``) at head width ``d`` and key
    tile ``bn``: ``{"head_shared": .., "per_element": ..}``, the first in
    the pre-pass ``draw_bits<bn>``, the second in the forward, whose
    consumer threads make bn / 2 calls a key tile."""
    funcs = functions(text)

    def listing(drop: int):
        return funcs[find(funcs, kernel, f"ILi{d}ELi{drop}E")]

    each = (tile_loop_size(*listing(1)) - tile_loop_size(*listing(0))) / (bn // 2)
    shared = draw_loop_per_call(*funcs[find(funcs, "draw_bits", f"ILi{bn}E")])
    return {"head_shared": shared, "per_element": each}


def philox_calls(weights_per_pass: int, passes: int, base: int) -> int:
    """The Philox calls the keep bits of ``passes`` passes of weights need,
    ``weights_per_pass`` a pass from counter ``base`` in seed order: one for
    each group of 4 counters that holds one of them (the distinct e/4)."""
    return passes * ((base + weights_per_pass + 3) // 4 - base // 4)


def issue_floor_ms(calls: int, sm_clock_mhz: float, sms: int = 132) -> float:
    """The least time ``sms`` SMs at ``sm_clock_mhz`` take to issue the
    ``PHILOX_CALL_INSTRUCTIONS`` of each of ``calls`` calls, in ms."""
    return PHILOX_CALL_INSTRUCTIONS * calls / (sms * ISSUE_PER_SM_CLOCK * sm_clock_mhz * 1e6) * 1e3


def select(text: str, parts: Sequence[str]) -> str:
    """The part of a listing that holds the functions whose names hold any
    of ``parts`` (for keeping beside a run's log)."""
    keep, on = [], False
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            on = any(p in m.group(1) for p in parts)
        if on:
            keep.append(line)
    return "\n".join(keep) + "\n"
