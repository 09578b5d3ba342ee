"""tools/sweeps_sass_counts.py: the term loops of K7's and K8's sweep
kernels and their instructions per term, on a small listing written in
cuobjdump -sass's form.

The listing holds K7's backward with widths (a phase loop of two terms,
with a loop nested before it that holds no marker, inside an outer loop
that holds the same markers: the inner one is the term loop), and K8 (a
loop of two terms, 14 products, and its remainder loop of one: only the
main loop counts).
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
