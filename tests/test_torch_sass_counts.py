"""tools/k1_sass_counts.py: the walk that counts what K1's kernels execute
per element, on a small listing written in cuobjdump -sass's form.

The listing has each construct the walk decides on: a predicated EXIT,
an IEEE slow path behind a conditional branch (CALL.REL.NOINC on the
fall-through side), a special case on the taken side of a two-predicate
branch, the eclipsed branch that skips the loop, a conditional branch
inside the loop, the loop's back edge and a subroutine after the EXIT.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import k1_sass_counts as kc  # noqa: E402

LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_115contacts_kernelIdEEvPKT_
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/       LDC R1, c[0x0][0x28] ;  /* 0x000fe20000000800 */
                        /* 0x000fe20000000800 */
        /*0010*/   @P0 EXIT ;
        /*0020*/       DFMA R2, R4, R6, R8 ;
        /*0030*/   @P1 BRA 0x70 ;
        /*0040*/       MOV R4, 0x60 ;
        /*0050*/       CALL.REL.NOINC 0x200 ;
        /*0060*/       BRA 0x80 ;
        /*0070*/       MUFU.RCP64H R5, R3 ;
        /*0080*/              @!P1 BRA P2, 0x120 ;
        /*0090*/   @P2 BRA 0x100 ;
        /*00a0*/       DMUL R2, R2, R2 ;
        /*00b0*/       DADD R2, R2, R2 ;
        /*00c0*/              @!P3 BRA 0xe0 ;
        /*00d0*/       FADD R1, R1, R1 ;
        /*00e0*/       DSETP.GT.AND P4, PT, R2, R4, PT ;
        /*00f0*/   @P4 BRA 0xa0 ;
        /*0100*/       F2F.F32.F64 R2, R4 ;
        /*0110*/       BRA 0x130 ;
        /*0120*/       SEL R2, R2, R4, P2 ;
        /*0130*/       STG.E.64 [R2.64], R4 ;
        /*0140*/       EXIT ;
        /*0150*/       BRA 0x150 ;
        /*0200*/       DFMA R4, R4, R4, R4 ;
        /*0210*/       RET.REL.NODEC R4 0x0 ;
"""


@pytest.fixture
def code():
    code = kc.parse(LISTING)["contacts_kernel<f64>"]
    end = next(i for i, (_, p, op, _) in enumerate(code)
               if op == "EXIT" and not p)
    return code[:end + 1]


def test_parse_names_and_reads_every_instruction():
    code = kc.parse(LISTING)
    assert list(code) == ["contacts_kernel<f64>"]
    assert len(code["contacts_kernel<f64>"]) == 24
    assert code["contacts_kernel<f64>"][1] == (0x10, True, "EXIT", "")


@pytest.mark.parametrize("eclipsed", [False, True])
def test_walk_counts_one_threads_path(code, eclipsed):
    """A visible element: LDC, EXIT, DFMA, BRA (skips the call), MUFU,
    BRA (falls through the special case), BRA (the eclipsed branch,
    taken), F2F, BRA, STG, EXIT.  An eclipsed one instead runs the loop
    body (DMUL, DADD, BRA, FADD, DSETP, BRA) 8 times before the F2F."""
    counts, rules = kc.walk(code, (8,), eclipsed)
    loop = 8 if eclipsed else 0
    assert dict(counts) == {
        "OTHER": 8 + 2 * loop, "DFMA": 1, "MUFU": 1, "CONV": 1,
        **({"DMUL": loop, "DADD": loop, "FP32": loop, "DSETP": loop}
           if eclipsed else {})}
    assert rules == {"skips a slow-path call": 1, "falls through":
                     1 + loop, "eclipsed branch": 1}


def test_walk_refuses_a_wrong_loop_count(code):
    with pytest.raises(SystemExit):
        kc.walk(code, (8, 4), True)
