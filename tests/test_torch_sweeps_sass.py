"""tools/sweeps_sass_counts.py: the term loops of K7's and K8's sweep
kernels and their instructions per term, on small listings written in
cuobjdump -sass's form.

LISTING holds K7's backward with widths (a phase loop of two terms, with
a loop nested before it that holds no marker, inside an outer loop that
holds the same markers: the inner one is the term loop), and K8 (a loop
of two terms, 14 products, and its remainder loop of one: only the main
loop counts).  FAST_PATHS holds K7 without widths (its comparison loop
and its floor's, two terms each by their fused products and sums: the
shorter one is the main loop), K7 with widths (its reciprocal's loop and
its divide's, one floor a term) and K8's fused backward (a pair loop of
22 fused products and sums: two terms).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import sweeps_sass_counts as sc  # noqa: E402

LISTING = """
	code for sm_90a
		Function : _Z29element_curve_backward_kernelIfLb1EEvPKT_S2_S2_S2_PKhS2_S2_PS0_S5_S5_S5_ii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/       LDC R1, c[0x0][0x28] ;
        /*0010*/       LDS.128 R4, [R2] ;
        /*0020*/       IADD3 R3, R3, 0x1, RZ ;
        /*0030*/       ISETP.GE.AND P1, PT, R3, R9, PT ;
        /*0040*/   @!P1 BRA 0x20 ;
        /*0050*/       FADD R6, R4, -R5 ;
        /*0060*/       FRND.FLOOR R7, R6 ;
        /*0070*/       FSETP.GE.AND P0, PT, R6, RZ, PT ;
        /*0080*/       FSEL R8, R6, RZ, P0 ;
        /*0090*/       FMUL R8, R8, R7 ;
        /*00a0*/       FADD R6, R4, -R5 ;
        /*00b0*/       FRND.FLOOR R7, R6 ;
        /*00c0*/       FMNMX.NAN R8, R6, RZ, !PT ;
        /*00d0*/       MUFU.RCP R9, R8 ;
        /*00e0*/       SHFL.DOWN PT, R9, R8, 0x10, 0x1f ;
        /*00f0*/   @P0 BRA 0x50 ;
        /*0100*/   @P1 BRA 0x10 ;
        /*0110*/       EXIT ;
        /*0120*/       BRA 0x120;
		Function : _Z16donor_sum_kernelIfEvPKT_S2_S2_ddPS0_iiii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/       LDS R4, [R2] ;
        /*0010*/       FMUL R5, R4, R4 ;
        /*0020*/       FMUL R5, R4, R4 ;
        /*0030*/       FMUL R5, R4, R4 ;
        /*0040*/       FMUL R5, R4, R4 ;
        /*0050*/       FMUL R5, R4, R4 ;
        /*0060*/       FMUL R5, R4, R4 ;
        /*0070*/       FMUL R5, R4, R4 ;
        /*0080*/       FMUL R5, R4, R4 ;
        /*0090*/       FMUL R5, R4, R4 ;
        /*00a0*/       FMUL R5, R4, R4 ;
        /*00b0*/       FMUL R5, R4, R4 ;
        /*00c0*/       FMUL R5, R4, R4 ;
        /*00d0*/       FMUL R5, R4, R4 ;
        /*00e0*/       FMUL R5, R4, R4 ;
        /*00f0*/       FADD R6, R6, R5 ;
        /*0100*/   @P0 BRA 0x0 ;
        /*0110*/       FMUL R5, R4, R4 ;
        /*0120*/       FMUL R5, R4, R4 ;
        /*0130*/       FMUL R5, R4, R4 ;
        /*0140*/       FMUL R5, R4, R4 ;
        /*0150*/       FMUL R5, R4, R4 ;
        /*0160*/       FMUL R5, R4, R4 ;
        /*0170*/       FMUL R5, R4, R4 ;
        /*0180*/   @P1 BRA 0x110 ;
        /*0190*/       EXIT ;
		Function : _Z16donor_sum_kernelIdLi8EEvPKT_S2_S2_ddPS0_iiii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/       EXIT ;
"""


def test_parse_labels_each_instantiation():
    code = sc.parse(LISTING)
    assert sorted(code) == ["donor_sum_kernel<f32>",
                            "donor_sum_kernel<f64, 8>",
                            "element_curve_backward_kernel<f32, widths>"]
    assert len(code["element_curve_backward_kernel<f32, widths>"]) == 19
    assert code["donor_sum_kernel<f32>"][16] == (0x100, True, "BRA", "0x0")
    assert sc.parse(LISTING.replace("kernelIfEv", "kernelIfLb1EEv"))[
        "donor_sum_kernel<f32, lanes>"]


def test_the_term_loop_is_the_innermost_that_holds_the_marker():
    label = "element_curve_backward_kernel<f32, widths>"
    code = sc.parse(LISTING)[label]
    assert [(code[lo][0], code[hi][0]) for lo, hi in sc.loops(code)] == [
        (0x20, 0x40), (0x50, 0xf0), (0x10, 0x100)]
    assert [(code[lo][0], code[hi][0], n)
            for lo, hi, n in sc.term_loops(label, code)] == [(0x50, 0xf0, 2)]


def test_counts_per_term_and_pipe_cycles():
    """The phase loop's 11 instructions over its 2 terms (2 FRND): FP32
    FADD x2, FMUL; ALU FSETP, FSEL, FMNMX; CONV FRND x2; MUFU; LDST SHFL;
    OTHER the back edge.  K8's 16 over 2 pairs (14 FMUL)."""
    res = sc.counts(LISTING)
    k7 = res["element_curve_backward_kernel<f32, widths>"]
    assert k7["loops"] == [{"instructions": 11, "terms_per_trip": 2,
                            "by_class": {"FP32": 3, "ALU": 3, "MUFU": 1,
                                         "CONV": 2, "LDST": 1, "OTHER": 1},
                            "main": True}]
    assert k7["per_term"] == {"FP32": 1.5, "ALU": 1.5, "MUFU": 0.5,
                              "CONV": 1.0, "LDST": 0.5, "OTHER": 0.5}
    assert k7["cycles_per_term"] == {"FP32": 1.5, "ALU": 3.0, "MUFU": 4.0,
                                     "CONV": 8.0, "LDST": 2.0}
    assert k7["issue_cycles_per_term"] == 5.5
    k8 = res["donor_sum_kernel<f32>"]
    assert [(r["terms_per_trip"], r.get("main", False))
            for r in k8["loops"]] == [(2, True), (1, False)]
    assert k8["per_term"] == {"FP32": 7.5, "LDST": 0.5, "OTHER": 0.5}
    assert res["donor_sum_kernel<f64, 8>"] == {"loops": []}


def test_every_loop_for_a_design_the_markers_do_not_count():
    rows = sc.all_loops(LISTING)["element_curve_backward_kernel<f32, widths>"]
    assert [(r["first"], r["instructions"], r["MUFU"], r["FRND"])
            for r in rows] == [("0x20", 3, 0, 0), ("0x50", 11, 1, 2),
                               ("0x10", 16, 1, 2)]


FAST_PATHS = """
		Function : _Z20element_curve_kernelIfLb0EEvPKT_S2_S2_S2_PKhS2_PS0_ii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/       LDS.128 R4, [R2] ;
        /*0010*/       FADD R6, R20, -R4 ;
        /*0020*/       FSET.BF.LT.AND R7, R6, RZ, PT ;
        /*0030*/       FADD R6, R6, R7 ;
        /*0040*/       FSET.BF.GEU.AND R7, R6, R8, PT ;
        /*0050*/       FFMA R10, R7, R9, R10 ;
        /*0060*/       FADD R6, R20, -R5 ;
        /*0070*/       FSET.BF.LT.AND R7, R6, RZ, PT ;
        /*0080*/       FADD R6, R6, R7 ;
        /*0090*/       FSET.BF.GEU.AND R7, R6, R8, PT ;
        /*00a0*/       FFMA R11, R7, R9, R11 ;
        /*00b0*/   @P0 BRA 0x0 ;
        /*00c0*/       LDS.128 R4, [R2] ;
        /*00d0*/       FADD R6, R20, -R4 ;
        /*00e0*/       FRND.FLOOR R7, R6 ;
        /*00f0*/       FADD R6, R6, -R7 ;
        /*0100*/       FSET.BF.GEU.AND R7, R6, R8, PT ;
        /*0110*/       FFMA R10, R7, R9, R10 ;
        /*0120*/       FADD R6, R20, -R5 ;
        /*0130*/       FRND.FLOOR R7, R6 ;
        /*0140*/       FADD R6, R6, -R7 ;
        /*0150*/       FSET.BF.GEU.AND R7, R6, R8, PT ;
        /*0160*/       FFMA R11, R7, R9, R11 ;
        /*0170*/   @P1 BRA 0xc0 ;
        /*0180*/       EXIT ;
		Function : _Z20element_curve_kernelIfLb1EEvPKT_S2_S2_S2_PKhS2_PS0_ii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/       FADD R6, R20, -R4 ;
        /*0010*/       FRND.FLOOR R7, R6 ;
        /*0020*/       MUFU.RCP R9, R22 ;
        /*0030*/       FFMA R10, -R22, R9, 1 ;
        /*0040*/       FFMA R9, R9, R10, R9 ;
        /*0050*/       FCHK P2, R8, R22 ;
        /*0060*/   @P1 BRA 0x0 ;
        /*0070*/       FADD R6, R20, -R4 ;
        /*0080*/       FRND.FLOOR R7, R6 ;
        /*0090*/       FMNMX.NAN R8, R6, RZ, !PT ;
        /*00a0*/       FMUL R9, R8, R21 ;
        /*00b0*/       FFMA R10, -R9, R22, R8 ;
        /*00c0*/       FFMA R9, R10, R21, R9 ;
        /*00d0*/   @P0 BRA 0x70 ;
        /*00e0*/       EXIT ;
		Function : _Z25donor_sum_backward_kernelIfEvPKT_S2_S2_ddS2_PS0_S3_S3_iii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/       LDS.128 R4, [R2] ;
        /*0010*/       FMUL R8, R4, R30 ;
        /*0020*/       FFMA R8, R5, R31, R8 ;
        /*0030*/       FFMA R8, R6, R32, R8 ;
        /*0040*/       FMNMX.NAN R9, R8, RZ, !PT ;
        /*0050*/       FFMA R10, R9, R40, R41 ;
        /*0060*/       FMUL R10, R9, R10 ;
        /*0070*/       FFMA R33, R7, R10, R33 ;
        /*0080*/       FSETP.GE.AND P0, PT, R8, RZ, PT ;
        /*0090*/       FFMA R11, R12, R9, R13 ;
        /*00a0*/       FSEL R11, R11, RZ, P0 ;
        /*00b0*/       FFMA R34, R11, R4, R34 ;
        /*00c0*/       FFMA R35, R11, R5, R35 ;
        /*00d0*/       FFMA R36, R11, R6, R36 ;
        /*00e0*/       FFMA R14, R11, R37, R14 ;
        /*00f0*/       FFMA R15, R11, R38, R15 ;
        /*0100*/       FFMA R16, R11, R39, R16 ;
        /*0110*/       FMUL R8, R4, R50 ;
        /*0120*/       FFMA R8, R5, R51, R8 ;
        /*0130*/       FFMA R8, R6, R52, R8 ;
        /*0140*/       FMNMX.NAN R9, R8, RZ, !PT ;
        /*0150*/       FFMA R10, R9, R40, R41 ;
        /*0160*/       FMUL R10, R9, R10 ;
        /*0170*/       FFMA R53, R7, R10, R53 ;
        /*0180*/       FSETP.GE.AND P0, PT, R8, RZ, PT ;
        /*0190*/       FFMA R11, R12, R9, R13 ;
        /*01a0*/       FSEL R11, R11, RZ, P0 ;
        /*01b0*/       FFMA R54, R11, R4, R54 ;
        /*01c0*/       FFMA R55, R11, R5, R55 ;
        /*01d0*/       FFMA R56, R11, R6, R56 ;
        /*01e0*/       FFMA R14, R11, R57, R14 ;
        /*01f0*/       FFMA R15, R11, R58, R15 ;
        /*0200*/       FFMA R16, R11, R59, R16 ;
        /*0210*/       SHFL.BFLY PT, R17, R14, 0x10, 0x1f ;
        /*0220*/       FADD R14, R14, R17 ;
        /*0230*/   @P1 BRA 0x0 ;
        /*0240*/       EXIT ;
"""


def test_each_new_loop_is_counted_by_its_marker():
    """K7 without widths: both loops hold two terms (two FFMA) in 12
    instructions, the comparison's is the main one, not the floor's (its
    FRND); with widths one term a loop by its FRND, the reciprocal's main
    over the divide's (its MUFU), which comes first; K8's backward: 22 FFMA, two terms,
    36 instructions."""
    res = sc.counts(FAST_PATHS)
    k7 = res["element_curve_kernel<f32, instant>"]
    assert [(r["instructions"], r["terms_per_trip"], r.get("main", False))
            for r in k7["loops"]] == [(12, 2, True), (12, 2, False)]
    assert k7["per_term"] == {"FP32": 3.0, "ALU": 2.0, "LDST": 0.5,
                              "OTHER": 0.5}
    assert "CONV" not in k7["cycles_per_term"]
    k7w = res["element_curve_kernel<f32, widths>"]
    assert [(r["instructions"], r["terms_per_trip"], r.get("main", False))
            for r in k7w["loops"]] == [(7, 1, False), (7, 1, True)]
    k8b = res["donor_sum_backward_kernel<f32>"]
    assert [(r["instructions"], r["terms_per_trip"])
            for r in k8b["loops"]] == [(36, 2)]
    assert k8b["per_term"] == {"FP32": 13.5, "ALU": 3.0, "LDST": 1.0,
                               "OTHER": 0.5}
    assert k8b["issue_cycles_per_term"] == 18.0
