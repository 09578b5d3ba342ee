#!/usr/bin/env python3
"""Count the instructions K9 (``donor_grid_kernel``) issues a solve and
K10 (``wd_curve_kernel``, both modes) a point, from their SASS.

    python3 tools/wd_donor_sass_counts.py [--phases P] [SASS_FILE]

Without an argument, builds ``ops/csrc/wd_donor.cu`` as the port does
(``ops/_build.py``: nvcc, so a CUDA card's toolkit) and disassembles the
library with ``cuobjdump -sass``; with one, reads that disassembly (any
build of the source since its first design, whose kernels are one thread
a solve or a point).

What is counted is the path a solve or a point takes at the north star's
shapes, each instruction of it once (both sides of a branch between its
slow paths' guards).  Left out are the slow paths: the blocks that a
division's check sends to its subroutine (a ``CALL``), the subroutines
themselves, what a guard's branch skips over sin / cos's Payne-Hanek
reduction (a loop in local memory) and every block reached only through
those.  A loop runs as often as its role says: K10's point loop (the
first loop that holds the divisions) a lane's phases at the north star
(P = ``--phases`` = 128 at 32 lanes a row: P / 32 / its points a trip),
a later loop (a remainder loop) not at all; K9's solve loop (the innermost loop
holding the divisions and a store) once a solve and the loops around it
once (one chunk of 384 directions), float64's bisection loop 54 steps
over its divisions a trip, a warp's copy of its staged grid (the loop
that holds a 128-bit store: 96 values in vectors of 16 bytes over 32
lanes) once in float32 and twice in float64, its scalar head and tail
loops not at all.  A kernel with no such loop (the first design: a
thread a solve or a point) is one solve or point.  A point's or solve's
count is all-in: the point loop's instructions a trip over its points a
trip (``loop``), plus what a lane runs outside that loop (``outside``,
per lane: K10's row prologue, K9's index set-up and the walker's terms,
which only a walker's first lane makes but which are counted here as if
each lane did) over the points or solves a lane makes at the north star
(K10: P / 32; K9: 384 directions over a block of 384 lanes, one), so
that a first design's count and a redesign's are on one basis.
Divisions are known by their checks (float32 ``FCHK``, float64
``MUFU.RCP64H``): K10 18 a point (16 in the distance mode).

Counts are by class (``tools/sweeps_sass_counts.py``'s: FP32, FP64, ALU,
MUFU, CONV, LDST, OTHER), and in cycles of each class's pipe per solve or
point on one SM sub-partition (32 / its lanes a warp instruction); every
instruction also takes an issue cycle of its scheduler.  Prints one JSON
line: per kernel instantiation (``donor_grid_kernel<f32>``,
``wd_curve_kernel<f64, 1>``: the distance mode), its all-in counts and
pipe cycles a solve or a point, its loop's alone, and those outside the
loop a lane.
"""

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from sweeps_sass_counts import CLASSES, LANES, klass  # noqa: E402

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)"
                  r"([^;]*);")
_NAME = re.compile(r"\d+(donor_grid_kernel|wd_curve_kernel)I([fd])"
                   r"(Lb([01])E)?")
# a division's check: float32, float64
DIVISIONS = ("FCHK", "MUFU.RCP64H")
# divisions a K10 point, by mode (0 the curve, 1 the distance)
K10_DIVISIONS = {"0": 18, "1": 16}
# float64 bisection steps of K9's solve (wd_donor.cu's WD_BISECT_F64)
K9_BISECT_F64 = 54
# K9's solves a lane at the north star: 384 directions, 384 lanes a walker
K9_SOLVES_A_LANE = 1


def parse(sass):
    """{label: [(addr, predicated, opcode, operands)]} of K9's and K10's
    kernels in a cuobjdump -sass listing."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = None
            n = _NAME.search(m.group(1))
            if n:
                typ = "f32" if n.group(2) == "f" else "f64"
                mode = f", {n.group(4)}" if n.group(4) else ""
                cur = out.setdefault(f"{n.group(1)}<{typ}{mode}>", [])
            continue
        m = _INS.search(ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2) is not None,
                        m.group(3), m.group(4).strip()))
    return out


def _target(ops):
    return int(re.findall(r"0x([0-9a-f]+)", ops)[-1], 16)


def hot(code):
    """The indices of ``code``'s instructions on its fast path: outside
    its subroutines (from the first CALL target on), outside the blocks
    that hold a CALL or that a guard's branch skips over a loop in local
    memory, and outside those reached only through them."""
    at = {a: i for i, (a, *_) in enumerate(code)}
    calls = [at[_target(o)] for _, _, op, o in code
             if op.startswith("CALL") and _target(o) in at]
    end = min(calls) if calls else len(code)
    leaders = {0}
    for i, (a, pred, op, o) in enumerate(code[:end]):
        if op.startswith(("BRA", "EXIT", "RET", "CALL")):
            leaders.add(i + 1)
            if op.startswith("BRA") and _target(o) in at:
                leaders.add(at[_target(o)])
    starts = sorted(x for x in leaders if x < end)
    blocks = [(s, (starts + [end])[k + 1]) for k, s in enumerate(starts)]
    block_of = {}
    for k, (s, e) in enumerate(blocks):
        for i in range(s, e):
            block_of[i] = k
    preds = {k: set() for k in range(len(blocks))}
    for k, (s, e) in enumerate(blocks):
        a, pred, op, o = code[e - 1]
        falls = not ((op.startswith(("BRA", "EXIT", "RET")) and not pred))
        if falls and e < end:
            preds[block_of[e]].add(k)
        if op.startswith("BRA") and _target(o) in at \
                and at[_target(o)] < end:
            preds[block_of[at[_target(o)]]].add(k)
    # the slow paths: a block with a CALL, and the range a guard's branch
    # skips over a loop in local memory and no division (sin / cos's
    # reduction; a spill outside such a loop is on the fast path)
    skipped = set()
    for i, (a, pred, op, o) in enumerate(code[:end]):
        t = at.get(_target(o)) if op.startswith("BRA") else None
        if pred and t is not None and t > i + 1 and not any(
                code[x][2].startswith(DIVISIONS) for x in range(i + 1, t)) \
                and any(i < lo and hi < t and any(
                    code[x][2].startswith(("LDL", "STL"))
                    for x in range(lo, hi + 1)) for lo, hi in loops(code)):
            skipped.update(range(i + 1, t))
    cold = {k for k, (s, e) in enumerate(blocks)
            if any(code[i][2].startswith("CALL") or i in skipped
                   for i in range(s, e))}
    grew = True
    while grew:
        grew = False
        for k in range(1, len(blocks)):
            if k not in cold and preds[k] and preds[k] <= cold:
                cold.add(k)
                grew = True
    return [i for i in range(end) if block_of[i] not in cold]


def loops(code):
    """[(first index, last index)] of each loop of ``code``: a branch back
    to an address at or before its own."""
    at = {a: i for i, (a, *_) in enumerate(code)}
    return [(at[_target(o)], i) for i, (a, _, op, o) in enumerate(code)
            if op.startswith("BRA") and _target(o) <= a
            and _target(o) in at]


def _count(code, idx, weight):
    c = Counter()
    for i in idx:
        c[klass(code[i][2])] += weight(i)
    return c


def counts_of(label, code, phases=128):
    """{"per": "solve" or "point", "counts": {class: n}, "cycles":
    {class: c}, "issue_cycles": c (all-in, a solve or a point), "loop":
    {class: n}, "loop_issue_cycles": c (the loop's alone), "outside":
    {class: n} (per lane: the row's or the walker's), "per_lane": the
    points or solves a lane, ...} of one kernel instantiation."""
    f64 = "f64" in label
    marker = "MUFU.RCP64H" if f64 else "FCHK"
    hot_idx = hot(code)
    hot_set = set(hot_idx)

    def markers(lo, hi):
        return sum(1 for i in range(lo, hi + 1)
                   if i in hot_set and code[i][2].startswith(marker))

    def has(lo, hi, op):
        return any(code[i][2].startswith(op) for i in range(lo, hi + 1))
    ls = [(lo, hi) for lo, hi in loops(code)
          if any(lo <= i <= hi for i in hot_idx)]
    trips = {}
    if label.startswith("wd_curve"):
        per = "point"
        point = [lp for lp in ls if markers(*lp)]
        divisions = K10_DIVISIONS[label[-2]]
        if point:
            main, rest = point[0], point[1:]
            k = markers(*main) // divisions
            trips[main] = phases / 32 / k
            for lp in rest:
                trips[lp] = 0
            region, points = main, k
        else:
            region, points = None, 1
    else:
        per = "solve"
        stores = [lp for lp in ls if markers(*lp)
                  and (has(*lp, "STG") or has(*lp, "STS"))]
        region = min(stores, key=lambda lp: lp[1] - lp[0]) if stores \
            else None
        points = 1
        for lp in ls:
            if lp == region:
                continue
            if region and lp[0] <= region[0] and region[1] <= lp[1]:
                trips[lp] = 1                # the chunk loop: one chunk
            elif markers(*lp):               # float64's bisection steps
                trips[lp] = K9_BISECT_F64 / markers(*lp)
            elif has(*lp, "STG.E.128"):      # a warp's staged grid
                trips[lp] = 1 if "f32" in label else 2
            else:                            # its head and tail
                trips[lp] = 0
    def weight(i):
        w = 1.0
        for lp, n in trips.items():
            if lp[0] <= i <= lp[1] and lp != region:
                w *= n
        return w
    inside = [i for i in hot_idx if region and region[0] <= i <= region[1]]
    outside = [i for i in hot_idx if not (region and region[0] <= i
                                          <= region[1])]
    if region:
        c = _count(code, inside, weight)
        loop = {k: v / points for k, v in c.items()}
        out_c = _count(code, outside, weight)
    else:
        loop = dict(_count(code, hot_idx, weight))
        out_c = Counter()
    per_lane = phases / 32 if per == "point" else K9_SOLVES_A_LANE
    per_point = {k: loop.get(k, 0) + out_c.get(k, 0) / per_lane
                 for k in CLASSES}

    def rounded(c):
        return {k: round(c[k], 3) for k in CLASSES if c.get(k)}
    res = {"per": per, "per_lane": per_lane,
           "counts": rounded(per_point),
           "issue_cycles": round(sum(per_point.values()), 3),
           "loop": rounded(loop),
           "loop_issue_cycles": round(sum(loop.values()), 3),
           "outside": rounded(out_c),
           "hot_instructions": len(hot_idx), "instructions": len(code)}
    res["cycles"] = {k: round(v * 32 / LANES[k], 3)
                     for k, v in per_point.items() if v and k != "OTHER"}
    return res


def counts(sass, phases=128):
    """{kernel label: counts_of(...)} of K9's and K10's instantiations in
    a listing."""
    return {label: counts_of(label, code, phases)
            for label, code in sorted(parse(sass).items())}


def built_sass():
    """cuobjdump -sass of the port's wd_donor library, built on first
    use."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.ops import _build

    _build.load_library("wd_donor")
    so = _build.PTXAS_LOGS["wd_donor"].with_name("libwd_donor.so")
    return subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout


def main():
    args = sys.argv[1:]
    phases = 128
    if "--phases" in args:
        k = args.index("--phases")
        phases = int(args[k + 1])
        del args[k:k + 2]
    sass = Path(args[0]).read_text() if args else built_sass()
    print(json.dumps(counts(sass, phases)))


if __name__ == "__main__":
    main()
