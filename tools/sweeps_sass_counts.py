#!/usr/bin/env python3
"""Count the instructions K7's and K8's sweep kernels (``sweeps.cu``)
issue per term, from their SASS.

    python3 tools/sweeps_sass_counts.py [--loops] [SASS_FILE]

Without an argument, builds ``ops/csrc/sweeps.cu`` as the port does
(``ops/_build.py``: nvcc, so a CUDA card's toolkit) and disassembles the
library with ``cuobjdump -sass``; with one, reads that disassembly.

A term is one (phase, element) pair of a row.  Each kernel's terms run in
its term loops: the innermost loops that hold the kernel's marker, an
instruction each term issues a known number of times (``markers``: K7's
instant product and sum, fused (FFMA or DFMA: one a term, on its
comparison path and on its floor's); the floor-form remainder's floor
(FRND) of K7 with widths and of K7's backward; K8's seven products a
term; K8's backward's 11 fused products and sums a term).  A loop's terms
per trip are its markers over that number, whatever the compiler
unrolled; its count per term is every instruction of its body (each
once: both sides of a branch, a nested loop's body once) over its terms
per trip.  A kernel's count is its main term loop's: the most terms a
trip (an unrolled loop's remainder loop runs the terms left over, not
every term), and of those the one with the fewest MUFU and CONV, then
the fewest instructions: K7's fast path, which the north star's rows
take, not its fallback (the floor's FRND, the divide's MUFU).
Counts are by
class: FP32 (FADD, FMUL, FFMA), FP64 (DADD, DMUL, DFMA, DSETP), ALU
(compares, selects, min / max, integer and logic: FSETP, FSEL, FMNMX,
ISETP, IADD3, LOP3, SEL, ...), MUFU, CONV (conversions and FRND), LDST
(loads, stores, shuffles) and OTHER (control, moves, IMAD, uniform
datapath).  Each count is also given in cycles of its pipe per
term on one SM sub-partition (``LANES``: Hopper's lanes a sub-partition,
so a warp instruction takes 32 / lanes cycles of its pipe; every
instruction also takes one issue cycle of its scheduler).  Prints one JSON
line: per kernel instantiation, its term loops' sizes and markers, and
where its marker is known its per-term counts and pipe cycles; with
``--loops``, every loop of each kernel instead, with its MUFU and FRND.
"""

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CLASSES = ("FP32", "FP64", "ALU", "MUFU", "CONV", "LDST", "OTHER")
FP32 = {"FADD", "FMUL", "FFMA"}
FP64 = {"DADD", "DMUL", "DFMA", "DSETP"}
ALU = {"FSETP", "FSEL", "FMNMX", "ISETP", "IADD3", "LOP3", "SEL", "SHF",
       "LEA", "PLOP3", "VIADD", "VIMNMX", "VIADDMNMX", "IABS", "FSET",
       "FCHK", "P2R", "R2P", "LOP", "IMNMX"}
CONV = {"F2F", "F2I", "I2F", "FRND", "F2FP", "I2FP", "F2IP"}
LDST = {"LDS", "LDG", "LD", "STS", "STG", "ST", "SHFL", "LDC", "ATOMS"}
# lanes a sub-partition (SM quarter) of the H100: a warp instruction of the
# class takes 32 / lanes cycles of its pipe
LANES = {"FP32": 32, "FP64": 16, "ALU": 16, "MUFU": 4, "CONV": 4,
         "LDST": 8, "OTHER": 32}
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)"
                  r"([^;]*);")
_NAME = re.compile(r"\d+(element_curve_kernel|element_curve_backward_kernel|"
                   r"donor_sum_kernel|donor_sum_backward_kernel)I([fd])"
                   r"(Lb([01])|Li(\d+)E)?")


def klass(op):
    base = op.split(".")[0]
    for name, ops in (("FP32", FP32), ("FP64", FP64), ("ALU", ALU),
                      ("CONV", CONV), ("LDST", LDST)):
        if base in ops:
            return name
    return "MUFU" if base == "MUFU" else "OTHER"


def markers(kernel, typ, widths, code):
    """The terms the instructions ``code`` run, counted by the kernel's
    marker (None where none of it is there)."""
    ops = Counter(op.split(".")[0] for _, _, op, _ in code)
    fma = "FFMA" if typ == "f" else "DFMA"
    if kernel == "element_curve_kernel" and not widths:
        return ops[fma] or None                   # acc + vis w, fused
    if kernel.startswith("element_curve"):
        return ops["FRND"] or None                # one floor a term
    if kernel == "donor_sum_kernel":
        n = ops["FMUL" if typ == "f" else "DMUL"]
        return n // 7 if n >= 7 else None         # dot 3, weight 3, area 1
    # K8's backward: the dot 2, the weight 2, u 1, d n 3, d e 3
    return ops[fma] // 11 or None


def parse(sass):
    """{kernel label: [(addr, predicated, opcode, operands)]} of the sweep
    kernels in a cuobjdump -sass listing; labels like
    ``element_curve_backward_kernel<f32, widths>`` (K8's: ``threads`` or
    ``lanes``)."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = None
            n = _NAME.search(m.group(1))
            if n:
                flags = (("instant", "widths")
                         if n.group(1).startswith("element")
                         else ("threads", "lanes"))
                kind = (f", {flags[int(n.group(4))]}" if n.group(4) else
                        f", {n.group(5)}" if n.group(5) else "")
                typ = "f32" if n.group(2) == "f" else "f64"
                label = f"{n.group(1)}<{typ}{kind}>"
                cur = out.setdefault(label, [])
            continue
        m = _INS.search(ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2) is not None,
                        m.group(3), m.group(4).strip()))
    return out


def loops(code):
    """[(first index, last index)] of each loop of ``code``: a branch back
    to an address at or before its own."""
    at = {a: i for i, (a, *_) in enumerate(code)}
    out = []
    for i, (a, _, op, o) in enumerate(code):
        if op.startswith("BRA"):
            t = int(re.findall(r"0x([0-9a-f]+)", o)[-1], 16)
            if t < a and t in at:
                out.append((at[t], i))
    return out


def term_loops(label, code):
    """[(first, last, terms a trip)]: the innermost loops of ``code`` that
    hold the kernel's marker."""
    kernel, typ = label.split("<")[0], label.split("<")[1][1]
    typ = "f" if typ == "3" else "d"
    widths = "widths" in label
    found = []
    for lo, hi in loops(code):
        n = markers(kernel, typ, widths, code[lo:hi + 1])
        if n:
            found.append((lo, hi, n))
    return [(lo, hi, n) for lo, hi, n in found
            if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                       for a, b, _ in found)]


def counts(sass):
    """{kernel label: {"loops": [{"instructions", "terms_per_trip",
    "by_class", "main" where counted}], "per_term": {class: n},
    "cycles_per_term": {pipe: c}, "issue_cycles_per_term": c}} of the
    sweep kernels in a listing."""
    out = {}
    for label, code in sorted(parse(sass).items()):
        per_term = Counter()
        rows = []
        for lo, hi, n in term_loops(label, code):
            by = Counter(klass(op) for _, _, op, _ in code[lo:hi + 1])
            rows.append({"instructions": hi - lo + 1, "terms_per_trip": n,
                         "by_class": {c: by[c] for c in CLASSES if by[c]}})
        main = sorted(rows, key=lambda r: (
            r["terms_per_trip"], -r["by_class"].get("MUFU", 0)
            - r["by_class"].get("CONV", 0), -r["instructions"]),
            reverse=True)
        for r in main[:1]:
            r["main"] = True
            for c, v in r["by_class"].items():
                per_term[c] += v / r["terms_per_trip"]
        res = {"loops": rows}
        if rows:
            res["per_term"] = {c: round(per_term[c], 3) for c in CLASSES
                               if per_term[c]}
            res["cycles_per_term"] = {
                c: round(per_term[c] * 32 / LANES[c], 3) for c in CLASSES
                if per_term[c] and c != "OTHER"}
            res["issue_cycles_per_term"] = round(sum(per_term.values()), 3)
        out[label] = res
    return out


def built_sass():
    """cuobjdump -sass of the port's sweeps library, built on first
    use."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.ops import _build

    _build.load_library("sweeps")
    so = _build.PTXAS_LOGS["sweeps"].with_name("libsweeps.so")
    return subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout


def all_loops(sass):
    """{kernel label: [{"first", "last" (addresses), "instructions",
    "by_class", "MUFU", "FRND"}]} of every loop of every sweep kernel: for
    reading a design whose terms this file's markers do not count."""
    out = {}
    for label, code in sorted(parse(sass).items()):
        rows = []
        for lo, hi in loops(code):
            body = code[lo:hi + 1]
            by = Counter(klass(op) for _, _, op, _ in body)
            ops = Counter(op.split(".")[0] for _, _, op, _ in body)
            rows.append({"first": hex(code[lo][0]), "last": hex(code[hi][0]),
                         "instructions": hi - lo + 1,
                         "by_class": {c: by[c] for c in CLASSES if by[c]},
                         "MUFU": ops["MUFU"], "FRND": ops["FRND"]})
        out[label] = rows
    return out


def main():
    args = [a for a in sys.argv[1:] if a != "--loops"]
    sass = Path(args[0]).read_text() if args else built_sass()
    print(json.dumps(all_loops(sass) if "--loops" in sys.argv[1:]
                     else counts(sass)))


if __name__ == "__main__":
    main()
