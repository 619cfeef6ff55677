"""Operation counts of the built kernels, read from their SASS.

A kernel's bound (the least time the card could take for its work) counts
the operations it does on its inputs: in f64 and in f32 a fused
multiply-add is 2 operations and an add or a multiply 1 (DFMA, DADD, DMUL;
FFMA, FADD, FMUL), over the card's peak rate for the type. The radial
return's work depends on the data: an elastic update skips the Newton
corrector. So this module reads the kernels' machine code
(``cuobjdump -sass`` of the built library) and splits each kernel's
arithmetic into what every update runs and what only a plastic update
adds:

- the slow paths of the IEEE divide and square root (subroutines reached
  by ``CALL``, run only on operands outside the fast path's range) are
  left out;
- the plastic-only code is every region that a predicated forward branch
  skips, holds a divide or an exp (``MUFU.RCP64H``, ``MUFU.RCP``,
  ``MUFU.EX2``) but no square root (every update takes one) and touches
  no memory: the Newton corrector and the radial scale behind
  ``if (plastic)``;
- a kernel's code may carry several updates (one square root each,
  ``MUFU.RSQ64H`` or ``MUFU.RSQ``), and counts are per update.

Nothing here needs a GPU; :func:`library_counts` needs ``cuobjdump``.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")
_LABEL = re.compile(r"^\s*\.L_x_(\d+):")
# the kernels' names (each translation unit's anonymous namespace adds a
# prefix of its own to the mangled name)
_KERNEL = re.compile(
    r"(j2_[a-z]+_[a-z]+|segment_sum(?:_block)?|coarse_pair_sum|csr_matvec)"
    r"_kernelI([fd])((?:L[ib]\d+E)*)")

FP64 = ("DFMA", "DADD", "DMUL")
FP32 = ("FFMA", "FADD", "FMUL")
_PLASTIC_MUFU = ("MUFU.RCP64H", "MUFU.RCP", "MUFU.EX2")
_RSQ = ("MUFU.RSQ64H", "MUFU.RSQ")
_MEMORY = ("LDG", "STG", "LDGSTS", "LDS", "STS", "ATOMG", "ATOMS", "RED",
           "BAR")

Insn = tuple[int, str, str]  # address, predicate, instruction


def kernel_key(mangled: str) -> str:
    """``j2_soa_step<double>``, or with the integer template arguments
    that follow the type ``j2_soa_history<float, 8>``, from a mangled
    kernel name."""
    m = _KERNEL.search(mangled)
    if not m:
        return mangled
    args = ["double" if m.group(2) == "d" else "float",
            *re.findall(r"L[ib](\d+)E", m.group(3))]
    return f"{m.group(1)}<{', '.join(args)}>"


def parse(text: str) -> dict[str, list[Insn]]:
    """{kernel: [(address, predicate, instruction)]} from a cuobjdump
    listing, with branch labels rewritten as addresses."""
    funcs: dict[str, list[Insn]] = {}
    labels: dict[str, dict[str, int]] = {}
    cur = None
    pending: list[str] = []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = kernel_key(m.group(1))
            funcs[cur], labels[cur] = [], {}
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr, body = int(m.group(1), 16), m.group(2).strip()
        pred = ""
        if body.startswith("@"):
            pred, body = body.split(None, 1)
        for lab in pending:
            labels[cur][lab] = addr
        pending = []
        funcs[cur].append((addr, pred, body))
    for name, insns in funcs.items():
        lab = labels[name]
        funcs[name] = [
            (a, p, re.sub(r"`\(\.L_x_(\d+)\)",
                          lambda mm: hex(lab.get(mm.group(1), -1)), b))
            for a, p, b in insns]
    return funcs


def _op(body: str) -> str:
    return body.split()[0]


def _target(body: str) -> int | None:
    m = re.search(r"0x([0-9a-f]+)", body)
    return int(m.group(1), 16) if m else None


def _subroutines(insns: list[Insn]) -> set[int]:
    """Addresses of called subroutines, from each CALL target to its
    RET."""
    inside: set[int] = set()
    for _a, _p, body in insns:
        start = _target(body) if body.startswith("CALL") else None
        if start is None:
            continue
        for a, _p2, b in insns:
            if a >= start:
                inside.add(a)
                if b.startswith("RET"):
                    break
    return inside


def _plastic_only(insns: list[Insn]) -> set[int]:
    inside: set[int] = set()
    for addr, pred, body in insns:
        end = _target(body)
        if not pred or not body.startswith("BRA") or end is None \
                or end <= addr:
            continue
        region = [(a, b) for a, _p, b in insns if addr < a < end]
        ops = {_op(b) for _a, b in region}
        if ops & set(_PLASTIC_MUFU) and not ops & set(_RSQ) and \
                not any(o.split(".")[0] in _MEMORY for o in ops):
            inside.update(a for a, _b in region)
    return inside


def _ops(counter: Counter) -> dict[str, int]:
    return {"fp64": 2 * counter["DFMA"] + counter["DADD"] + counter["DMUL"],
            "fp32": 2 * counter["FFMA"] + counter["FADD"] + counter["FMUL"]}


def kernel_counts(insns: list[Insn]) -> dict:
    """Per update: ``elastic`` (the operations every update runs) and
    ``plastic`` (what a plastic update adds), each ``{"fp64", "fp32"}``;
    ``mnemonics``, the static count of each floating-point and MUFU
    instruction of the kernel's code; ``updates`` per pass of the code;
    ``instructions``, the static count."""
    sub = _subroutines(insns)
    main = [(a, p, b) for a, p, b in insns if a not in sub]
    plastic = _plastic_only(main)
    every = Counter(_op(b) for a, _p, b in main if a not in plastic)
    extra = Counter(_op(b) for a, _p, b in main if a in plastic)
    updates = max(1, sum(every[r] + extra[r] for r in _RSQ))
    mnemonics = {k: v for k, v in sorted((every + extra).items())
                 if k.split(".")[0] in FP64 + FP32 + ("DSETP", "MUFU")}
    return {"elastic": {k: v / updates for k, v in _ops(every).items()},
            "plastic": {k: v / updates for k, v in _ops(extra).items()},
            "mnemonics": mnemonics, "updates": updates,
            "instructions": len(main)}


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "cuobjdump").exists():
        return str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    raise RuntimeError("cuobjdump not found (neither on PATH nor under "
                       "CUDA_HOME)")


def library_sass(path: Path) -> str:
    return subprocess.run([cuobjdump(), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout


def library_counts(path: Path) -> dict[str, dict]:
    """:func:`kernel_counts` of every kernel of a built library."""
    return {k: kernel_counts(v) for k, v in parse(library_sass(path)).items()}
