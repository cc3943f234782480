"""Instruction counts of the loops that load features, from a SASS dump.

    cuobjdump -sass build/torch_kernels/<hash>/libroi_align.so \\
        | python -m monorun_tpu_torch.tools.sass_loops

For every kernel of the dump whose name contains ``forward_kernel``: its
instruction count, and for every loop (a backward branch and its target)
whose body holds 128-bit global loads, the body's instructions, 128-bit
loads and ``FFMA``s, innermost (shortest) first. A loop body's count over
its loads is what one tap costs in issued instructions. One JSON line per
kernel.
"""

from __future__ import annotations

import json
import re
import sys
from typing import Dict, Iterable, List, Tuple

_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRANCH = re.compile(r"\bBRA (?:\S+, )?0x([0-9a-f]+)")


def parse(lines: Iterable[str]) -> Dict[str, List[Tuple[int, str]]]:
    """{kernel name: [(address, instruction), ...]}."""
    kernels: Dict[str, List[Tuple[int, str]]] = {}
    current = None
    for line in lines:
        m = _FUNC.search(line)
        if m:
            current = m.group(1)
            kernels[current] = []
            continue
        m = _INSTR.match(line)
        if m and current is not None:
            kernels[current].append((int(m.group(1), 16), m.group(2).strip()))
    return kernels


def load_loops(instrs: List[Tuple[int, str]]) -> List[dict]:
    """The loops whose bodies hold 128-bit global loads, shortest first."""
    index = {addr: i for i, (addr, _) in enumerate(instrs)}
    loops = []
    for i, (addr, text) in enumerate(instrs):
        m = _BRANCH.search(text)
        if not m or int(m.group(1), 16) >= addr or int(m.group(1), 16) not in index:
            continue
        body = [t for _, t in instrs[index[int(m.group(1), 16)]:i + 1]]
        loads = sum("LDG.E.128" in t for t in body)
        if loads:
            loops.append(dict(instructions=len(body), loads=loads,
                              ffma=sum(re.search(r"(^|\s)FFMA\b", t) is not None for t in body),
                              start=m.group(1)))
    return sorted(loops, key=lambda d: d["instructions"])


def main() -> int:
    for name, instrs in parse(sys.stdin).items():
        if "forward_kernel" in name:
            print(json.dumps(dict(kernel=name, instructions=len(instrs),
                                  loops=load_loops(instrs))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
