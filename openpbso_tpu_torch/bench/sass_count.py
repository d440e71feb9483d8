"""Instruction counts of a kernel's main loop, read from the SASS of the
port's built kernel library (``cuobjdump -sass``).

    python -m openpbso_tpu_torch.bench.sass_count [--kernel SUBSTRING]
        [--per OPCODE] [--library PATH]

The main loop is the backward branch whose range holds the most
instructions of the opcode --per (default STG, the global store: one per
sample for ar_noise; HMMA for the Toeplitz conv); its instructions are
counted by class and divided by that count, statically: a forward branch
inside the loop counts both of its sides. Classes: "int" (the ALU's
integer operations), "imad" and "fp32" (the FMA pipe), "mufu", "mem",
"uniform", "convert" and "other". Prints one JSON object (and
with --listing the loop's SASS). Needs the CUDA toolkit (nvcc builds the
library first).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

INT_OPS = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
           "LEA", "ISETP", "IABS", "IMNMX", "PRMT", "SEL", "SGXT", "BMSK",
           "POPC", "FLO", "BREV", "ISCADD", "VIADD", "VIMNMX", "IDP",
           "IMUL", "ICMP", "XMAD"}
FP32_OPS = {"FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK",
            "FSWZADD", "FSET", "FMUL32I", "FADD32I", "FFMA32I"}
MEM_OPS = {"LDG", "STG", "LDS", "STS", "LDC", "LD", "ST", "LDL", "STL",
           "ATOM", "ATOMS", "RED", "LDGSTS"}

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\s*$")


def cuobjdump() -> str:
    from ..ops import _build
    return os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")


def sass(library: str) -> str:
    return subprocess.run([cuobjdump(), "-sass", library], check=True,
                          capture_output=True, text=True).stdout


def functions(text: str) -> dict[str, list[tuple[int, str]]]:
    """Mangled name -> [(address, instruction or label)] in order."""
    out: dict[str, list[tuple[int, str]]] = {}
    cur = None
    pending = []
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                cur.append((addr, label + ":"))
            pending = []
            cur.append((addr, m.group(2)))
    return out


def opcode(insn: str) -> str:
    tokens = insn.split()
    if tokens and tokens[0].startswith("@"):
        tokens = tokens[1:]
    return tokens[0].split(".")[0] if tokens else ""


def classify(op: str) -> str:
    if op in INT_OPS:
        return "int"
    if op == "IMAD":      # runs on the FMA pipe
        return "imad"
    if op in FP32_OPS:
        return "fp32"
    if op == "MUFU":
        return "mufu"
    if op in MEM_OPS:
        return "mem"
    if op.startswith("U"):
        return "uniform"
    if op in {"I2F", "F2I", "F2F", "I2FP", "F2FP", "I2I"}:
        return "convert"
    return "other"


def main_loop(body: list[tuple[int, str]], per: str) -> list[str]:
    """The instructions of the backward branch's range with the most
    `per` instructions."""
    labels = {text[:-1]: addr for addr, text in body if text.endswith(":")}
    insns = [(a, t) for a, t in body if not t.endswith(":")]
    best, best_stores = [], -1
    for addr, text in insns:
        m = _TARGET.search(text)
        if opcode(text) != "BRA" or not m:
            continue
        target = (labels.get(m.group(1), addr) if m.group(1)
                  else int(m.group(2), 16))
        if target >= addr:
            continue
        loop = [t for a, t in insns if target <= a <= addr]
        stores = sum(opcode(t) == per for t in loop)
        if stores > best_stores:
            best, best_stores = loop, stores
    return best


def count(library: str, kernel: str, per: str = "STG") -> dict:
    funcs = {name: body for name, body in functions(sass(library)).items()
             if kernel in name}
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} functions match {kernel!r}: "
                         f"{sorted(funcs)}")
    (name, body), = funcs.items()
    loop = main_loop(body, per)
    stores = sum(opcode(t) == per for t in loop)
    if not stores:
        raise ValueError(f"{name}: no loop with an {per} instruction:\n"
                         + "\n".join(t for _, t in body))
    by_class: dict[str, int] = {}
    for t in loop:
        c = classify(opcode(t))
        by_class[c] = by_class.get(c, 0) + 1
    return {"function": name, "per": per, "loop_instructions": len(loop),
            "per_iteration": stores, "by_class": by_class,
            "by_class_per_item": {c: n / stores for c, n in by_class.items()},
            "instructions_per_item": len(loop) / stores, "listing": loop}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", default="ar_noise_kernelILb0E")
    parser.add_argument("--per", default="STG")
    parser.add_argument("--library", help="default: the port's library")
    parser.add_argument("--listing", action="store_true")
    args = parser.parse_args()
    from ..ops import _build
    out = count(args.library or _build.build(), args.kernel, args.per)
    listing = out.pop("listing")
    print(json.dumps(out))
    if args.listing:
        print("\n".join(listing))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
