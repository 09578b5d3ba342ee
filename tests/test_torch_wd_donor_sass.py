"""tools/wd_donor_sass_counts.py: the path a K10 point and a K9 solve take
through their kernels' SASS, on small listings written in cuobjdump
-sass's form.

The K10 listing (the distance mode, float32: 16 divisions a point) has a
row prologue (its share of a point counted in), a point loop of one point with a division's slow-path call
and a guard that skips a loop in local memory (sin / cos's reduction),
a spill store on the fast path, a remainder loop, and a subroutine after
the EXIT; the K9 listing (float64, the first design: no solve loop) a
bisection loop of two steps a trip between a prologue and its stores.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import wd_donor_sass_counts as wc  # noqa: E402


def listing(name, body):
    """A cuobjdump -sass function ``name`` of ``body``: (label or None,
    instruction text with ``{label}`` targets), 16 bytes apart."""
    at = {}
    for i, (label, _) in enumerate(body):
        if label:
            at[label] = f"0x{16 * i:x}"
    lines = [f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_SM90"']
    for i, (_, text) in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/       {text.format(**at)} ;")
    return "\n".join(lines) + "\n"


K10 = listing("_Z15wd_curve_kernelIfLb1EEv6WdArgsIT_E", [
    (None, "LDC R1, c[0x0][0x28]"),                        # prologue: 3
    (None, "FADD R2, R3, 1"),
    (None, "STL [R1+0x20], R7"),                          # a spill
    ("main", "FCHK P0, R2, R3"),                          # point loop
    *[(None, "FCHK P0, R2, R3")] * 15,                    # 16 divisions
    (None, "BSSY B0, {join}"),
    (None, "@!P0 BRA {join}"),
    (None, "MOV R4, {ret}"),                              # slow path
    (None, "CALL.REL.NOINC {sub}"),
    ("ret", "MOV R5, R4"),
    ("join", "BSYNC B0"),
    (None, "@!P2 BRA {trig_join}"),                       # the guard
    ("trig", "STL [R1], R6"),                             # reduction
    (None, "IADD3 R7, R7, 0x1, RZ"),
    (None, "@P3 BRA {trig}"),
    (None, "FMUL R6, R6, R6"),
    ("trig_join", "FMUL R8, R8, R8"),
    (None, "@P1 BRA {main}"),                             # back edge
    ("tail", "FCHK P0, R2, R3"),                          # remainder
    *[(None, "FCHK P0, R2, R3")] * 15,
    (None, "@P4 BRA {tail}"),
    (None, "EXIT"),
    ("sub", "FFMA R2, R3, R4, R5"),                       # subroutine
    (None, "RET.REL.NODEC R4 0x0"),
])

K9 = listing("_Z17donor_grid_kernelIdEv9DonorArgsIT_E", [
    (None, "LDC R1, c[0x0][0x28]"),                        # 3
    (None, "DADD R2, R3, 1"),
    (None, "MUFU.RCP64H R5, R3"),                         # mu = q / (1 + q)
    ("step", "MUFU.RCP64H R5, R3"),                       # 2 steps a trip
    (None, "DFMA R6, R5, R3, R6"),
    (None, "MUFU.RCP64H R5, R3"),
    (None, "DFMA R6, R5, R3, R6"),
    (None, "@P0 BRA {step}"),
    (None, "STG.E.64 desc[UR4][R8.64], R6"),               # 2
    (None, "EXIT"),
])


def test_k10_point_path():
    """A point: the point loop less the division's call block and what
    the guard skips over the reduction (16 FCHK, BSSY, the branch, the
    join, the guard, the FMUL after it and the back edge: 22), plus the
    prologue, the spill on it and the EXIT (4 a lane) over the 4 points a
    lane at P = 128; the remainder loop and the subroutine not counted."""
    res = wc.counts(K10)["wd_curve_kernel<f32, 1>"]
    assert res["per"] == "point"
    assert res["per_lane"] == 4
    assert res["loop_issue_cycles"] == 22
    assert res["loop"] == {"FP32": 1, "ALU": 16, "OTHER": 5}
    assert res["outside"] == {"FP32": 1, "LDST": 1, "OTHER": 2}
    assert res["issue_cycles"] == 23
    assert res["counts"] == {"FP32": 1.25, "ALU": 16, "LDST": 0.25,
                             "OTHER": 5.5}
    assert res["cycles"] == {"FP32": 1.25, "ALU": 32.0, "LDST": 1.0}


def test_k10_phases_per_lane():
    """The point loop's trips follow --phases and its count a point does
    not; the prologue's share a point is its 4 instructions over P / 32."""
    for phases in (32, 128, 384):
        res = wc.counts(K10, phases)["wd_curve_kernel<f32, 1>"]
        assert res["loop_issue_cycles"] == 22
        assert res["issue_cycles"] == pytest.approx(22 + 4 / (phases / 32),
                                                    abs=1e-3)


def test_k9_bisection_weighted():
    """The first design's float64 solve: the bisection loop's 5
    instructions 27 times (54 steps, two divisions a trip) between its 3
    and 2."""
    res = wc.counts(K9)["donor_grid_kernel<f64>"]
    assert res["per"] == "solve"
    assert res["issue_cycles"] == pytest.approx(3 + 27 * 5 + 2)
    assert res["loop_issue_cycles"] == res["issue_cycles"]
    assert res["outside"] == {}
    assert res["counts"]["FP64"] == pytest.approx(1 + 27 * 2)
    assert res["counts"]["MUFU"] == pytest.approx(1 + 27 * 2)


def test_parse_labels():
    assert set(wc.parse(K10 + K9)) == {"wd_curve_kernel<f32, 1>",
                                        "donor_grid_kernel<f64>"}
