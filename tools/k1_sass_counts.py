#!/usr/bin/env python3
"""Count the instructions K1's kernels execute per element, from their
SASS.

    python3 tools/k1_sass_counts.py [SASS_FILE]

Without an argument, builds ``ops/csrc/contacts.cu`` as the port does
(``ops/_build.py``, so it needs nvcc and a CUDA card's toolkit) and
disassembles the library with ``cuobjdump -sass``; with one, reads that
disassembly.  For each of K1's three kernels it walks the code as one
thread runs it, twice: for an element that is not eclipsed and for one
that is.  The walk follows the fall-through side of a conditional forward
branch, except where that side calls a slow path (``CALL.REL.NOINC``
before its next branch: the IEEE divide's and sqrt's rare cases), and
except at the eclipsed branch (the last one before the edge loops that
skips them all), which
it takes for a visible element and not for an eclipsed one; a predicated
EXIT is not taken (the element is in range); a loop's back edge is taken
its trip count less one times (``TRIPS``: the edge loop's 8 iterations, 5
float32 ones and 4 of the double tails in the mixed kernel).  Counts are
by class: DFMA, DMUL, DADD, DSETP (the FP64 pipe), MUFU (the special
function unit, its double estimates included), FP32 (FADD, FMUL, FFMA,
FSETP, FMNMX, FCHK), CONV (conversions) and OTHER (integer, select, move,
memory, control).  Prints one JSON line: per kernel, the counts of an
element ("element") and what an eclipsed one adds ("eclipsed"), and the
conditional branches the walk decided by each rule.
"""

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# back edges of each kernel, in address order, and their trip counts
TRIPS = {"contacts_kernel<f32>": (8,), "contacts_kernel<f64>": (8,),
         "contacts_mixed_kernel": (5, 4)}
CLASSES = ("DFMA", "DMUL", "DADD", "DSETP", "MUFU", "FP32", "CONV",
           "OTHER")
FP32 = {"FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FCHK", "FSET"}
CONV = {"F2F", "F2I", "I2F", "F2FP", "FRND", "I2FP", "F2IP"}
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)"
                  r"([^;]*);")


def kernel_name(mangled):
    if "contacts_mixed_kernel" in mangled:
        return "contacts_mixed_kernel"
    m = re.search(r"contacts_kernelI([fd])", mangled)
    return f"contacts_kernel<{'f32' if m.group(1) == 'f' else 'f64'}>"


def parse(sass):
    """{kernel: [(addr, predicated, opcode, operands)]} of the
    ``contacts`` kernels in a cuobjdump -sass listing."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = None
            if "contacts" in m.group(1) and "backward" not in m.group(1):
                cur = out.setdefault(kernel_name(m.group(1)), [])
            continue
        m = _INS.search(ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2) is not None,
                        m.group(3), m.group(4).strip()))
    return out


def klass(op):
    base = op.split(".")[0]
    if base in ("DFMA", "DMUL", "DADD", "DSETP", "MUFU"):
        return base
    if base in FP32:
        return "FP32"
    if base in CONV:
        return "CONV"
    return "OTHER"


def target(operands):
    return int(re.findall(r"0x([0-9a-f]+)", operands)[-1], 16)


def walk(code, trips, eclipsed):
    """(Counter of classes, Counter of branch decisions) of one thread's
    run through ``code``."""
    at = {a: i for i, (a, *_) in enumerate(code)}
    back = sorted(a for a, _, op, o in code
                  if op.startswith("BRA") and target(o) <= a)
    if len(back) != len(trips):
        raise SystemExit(f"{len(back)} loops, expected {len(trips)}")
    trip = dict(zip(back, trips))
    # the last conditional branch before the loops that jumps past them
    ecl_branch = max(a for a, p, op, o in code
                     if p and op.startswith("BRA") and a < back[0]
                     and target(o) > back[-1])
    taken = Counter()
    counts, rules = Counter(), Counter()
    i = 0
    while True:
        addr, pred, op, operands = code[i]
        counts[klass(op)] += 1
        if op.startswith("CALL"):
            raise SystemExit(f"the walk reached a call at {addr:#x}")
        if op == "EXIT" and not pred:
            return counts, rules
        if op.startswith("BRA"):
            dest = target(operands)
            if not pred:
                i = at[dest]
                continue
            if dest <= addr:                            # a back edge
                if taken[addr] < trip[addr] - 1:
                    taken[addr] += 1
                    i = at[dest]
                    continue
                taken[addr] = 0
            elif addr == ecl_branch:
                rules["eclipsed branch"] += 1
                if not eclipsed:
                    i = at[dest]
                    continue
            elif _calls_first(code, i + 1):
                rules["skips a slow-path call"] += 1
                i = at[dest]
                continue
            else:
                rules["falls through"] += 1
        i += 1


def _calls_first(code, i):
    """Whether the straight-line code from ``i`` reaches a CALL before
    any branch or exit."""
    for _, _, op, _ in code[i:]:
        if op.startswith("CALL"):
            return True
        if op.startswith(("BRA", "EXIT", "RET")):
            return False
    return False


def counts(sass):
    """{kernel: {"element": {class: n}, "eclipsed": {class: n},
    "rules": {rule: n}}} of the K1 kernels in a cuobjdump -sass
    listing."""
    out = {}
    for name, code in sorted(parse(sass).items()):
        # the kernel's body ends at its unpredicated EXIT: the slow-path
        # subroutines follow it
        end = next(i for i, (_, p, op, _) in enumerate(code)
                   if op == "EXIT" and not p)
        code = code[:end + 1]
        vis, rules = walk(code, TRIPS[name], False)
        ecl, rules_e = walk(code, TRIPS[name], True)
        out[name] = {"element": {c: vis[c] for c in CLASSES},
                     "eclipsed": {c: ecl[c] - vis[c] for c in CLASSES},
                     "rules": dict(rules_e)}
    if set(out) != set(TRIPS):
        raise SystemExit(f"kernels found: {sorted(out)}")
    return out


def built_sass():
    """cuobjdump -sass of the port's contacts library, built on first
    use."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.ops import _build

    _build.load_library("contacts")
    so = _build.PTXAS_LOGS["contacts"].with_name("libcontacts.so")
    return subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout


def main():
    sass = (Path(sys.argv[1]).read_text() if len(sys.argv) > 1
            else built_sass())
    print(json.dumps(counts(sass)))


if __name__ == "__main__":
    main()
