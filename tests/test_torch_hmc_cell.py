"""The benchmark's HMC cell (``hier5_calib.hmc256``) on the CPU: its
entries and files, its sampler module's draws and check, its readers,
and a whole run at a small size that is correct, while the bfloat16
control and each planted fault (``lfit_bench/hmc_faults.py``) are not.

The runs go through the port's plain paths (the kernel wrappers take them
on CPU tensors) in a process of their own (this one has JAX loaded, which
a run refuses): one eclipse, 8 chains of 2 leapfrogs, a window of a step.
The step size is large for that model (most trajectories rejected), so
that a fault in the accept test shows on a step of 8 chains.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lfit_bench import grad, layers, work
from lfit_bench import run as bench
from lfit_bench.reference import spec
from lfit_bench.trace import POSTERIOR, STEP, Trace
from lfit_python_tpu_torch.sampling import hmc

REPO = Path(__file__).resolve().parents[1]
CELL = "hier5_calib.hmc256"
READERS = ("host_ms_per_grad.grad", "launches_per_grad.grad",
           "device_ms_per_grad.grad", "device_idle_pct.grad",
           "replays_per_grad.grad", "leapfrog.host_ms.grad",
           "k2_stream.device_ms.grad", "k1_contacts_bwd_roofline.grad",
           "k7_curve_bwd_roofline.grad")
# what a traced run on the CPU reads: the host's clock and spans, a
# device with no events, and nothing of the kernels or the replays
HOST = ("host_ms_per_grad.grad", "leapfrog.host_ms.grad")
EMPTY_DEVICE = ("launches_per_grad.grad", "device_ms_per_grad.grad",
                "device_idle_pct.grad")
FAULTS = ("accept_all", "sign_flip", "wrong_step", "stale_momentum")


def _reader(name):
    return bench._load(REPO / "lfit_bench" / "metrics" / f"{name}.py")


# ---- the entries and files ------------------------------------------------

def test_the_benchmark_has_the_cell_and_its_readers():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    (w,) = [w for w in b["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("hier5_calib_hmc",
                                                       "hmc256", 1)
    conf = {c["name"]: c for c in b["configs"]}
    assert conf["hier5_calib_hmc"]["reduced"] == []
    assert conf["hier5_calib_hmc"]["source"] != conf["hier5_calib"]["source"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert CELL in e2e["evals_per_s"]["workloads"]
    # the p95 of a step swings with the card's speed at a run's start
    # (PERF.md, section 6), so the cell reports the rate alone
    assert CELL not in e2e["step_ms_p95"]["workloads"]
    grads = {m["name"]: m for m in b["per_layer"] if CELL in m["workloads"]}
    assert set(grads) == set(READERS)
    for m in grads.values():
        assert m["workloads"] == [CELL] and m["moves"] == "evals_per_s"
    cell = bench.load_cell(CELL)
    assert {m["name"] for m in cell["per_layer"]} == set(READERS)
    assert {m["name"] for m in cell["end_to_end"]} == {"evals_per_s",
                                                        "setup_s"}


def test_the_traffic_fits_the_configuration():
    cell = bench.load_cell(CELL)
    traffic, cfg = cell["traffic"], cell["config"]
    model, _ = bench.program(cfg, spec.light_curves(cfg, 1), "cpu")
    assert len(traffic["inv_mass"]) == len(model.var_start()) == 47
    assert all(v > 0 for v in traffic["inv_mass"])
    assert traffic["sampler"] == "hmc" and traffic["chains"] == 256
    assert traffic["leapfrog"] == 16 and 0 < traffic["step_size"] < 1
    assert 0 < traffic["acceptance"] < 1
    # the deployment is the north star's model and light curves, fit by HMC
    # as the configuration's fit block states and the traffic runs it
    north = json.loads((REPO / "lfit_bench" / "configs"
                        / "hier5_calib.json").read_text())
    assert {k: v for k, v in cfg.items()
            if k not in ("name", "source", "about", "fit")} == {
        k: v for k, v in north.items() if k not in ("name", "source", "about")}
    assert cfg["fit"] == {"sampler": traffic["sampler"],
                          "chains": traffic["chains"],
                          "leapfrog": traffic["leapfrog"]}
    limits = cell["settings"]["limits"]
    assert set(limits) == {"lnp_gap", "unmoved_pct", "leapfrog_ulps",
                           "grad_gap", "accepted_gap", "rejected_gap"}


@pytest.mark.parametrize("name", READERS)
def test_a_grad_reader_reads_none_without_a_trace(name):
    assert _reader(name).read(layers.Context({}, {})) is None


# ---- the sampler module ---------------------------------------------------

def test_the_checks_draws_are_the_samplers():
    mod = bench._load(REPO / "lfit_bench" / "samplers" / "hmc.py")
    gen = torch.Generator().manual_seed(2 ** 33 + 5)
    state = gen.get_state()
    want = hmc.trajectory_draws(gen, 6, 5, torch.float32, "cpu")
    got = mod.draws(state, 6, 5, torch.float32, "cpu")
    for a, b in zip(want, got):
        assert np.array_equal(a.double().numpy(), b)


# ---- the readers on a trace made by hand ----------------------------------

def _ctx(host, device, rows, share=0.9):
    cfg = json.loads((REPO / "lfit_bench" / "configs"
                      / "hier5_calib.json").read_text())
    return layers.Context(cfg, {}, trace=Trace((0, 10 ** 9), device, host),
                          trace_rows=rows, eclipsed_share=share)


def test_the_replays_and_the_leapfrog_span_are_counted():
    host = [(STEP, 0, 500), (POSTERIOR, 0, 100), (grad.REPLAY, 10, 90),
            (grad.LEAPFROG, 100, 130), (POSTERIOR, 200, 300),
            (grad.LEAPFROG, 300, 320), (STEP, 500, 900),
            (POSTERIOR, 600, 700), (grad.REPLAY, 610, 690),
            (grad.REPLAY, 950, 990)]
    ctx = _ctx(host, [], [4, 4, 4])
    assert _reader("replays_per_grad.grad").read(ctx) == pytest.approx(
        2 / 3)
    # 50 ns of the span over 2 steps
    assert _reader("leapfrog.host_ms.grad").read(ctx) == pytest.approx(
        25e-6)
    ctx = _ctx(host[:3], [], [4])
    assert _reader("leapfrog.host_ms.grad").read(ctx) is None


@pytest.mark.parametrize("name,kernel,match", [
    ("k1_contacts_bwd_roofline.grad", "k1_backward",
     "contacts_backward_kernel"),
    ("k7_curve_bwd_roofline.grad", "k7_backward",
     "element_curve_backward_kernel")])
def test_a_backward_roofline_is_its_work_over_its_time(name, kernel, match):
    device = [(f"void {match}<float, true>(float*)", 0, 200_000),
              (f"void {match}<float, true>(float*)", 300_000, 100_000),
              ("void contacts_kernel<float>(float*)", 500_000, 50_000),
              ("void element_curve_kernel<float, true>(float*)", 600_000,
               70_000)]
    ctx = _ctx([], device, [256, 256])
    shape = layers.call_shapes(ctx, 256)
    rows = 256 * 5
    if kernel == "k1_backward":
        ops, nbytes = work.k1_backward(rows, shape.solved_elements, 0.9)
    else:
        parts = [work.k7_backward(rows, 128, n, True)
                 for n in (shape.disc_elements, shape.spot_elements)]
        ops, nbytes = (sum(p[i] for p in parts) for i in (0, 1))
    least = work.least_seconds(ops, nbytes)[0]
    assert _reader(name).read(ctx) == pytest.approx(
        100 * 2 * least / 300e-6)
    ctx.eclipsed_share = None
    assert (_reader(name).read(ctx) is None) == (kernel == "k1_backward")


def test_the_backward_work_is_perf_mds_count():
    """PERF.md section 6: K1's backward on the north star's 1280 x 512
    gradient rows at the eclipsed share 0.9316, 1.088 GFLOP (883 an
    eclipsed edge, 15 an element), 16.2 us at peak; K7's backward with
    widths on 1280 x 128 x 960 terms, 5.662 G (36 a term), 84.5 us."""
    ops, _ = work.k1_backward(1280, 512, 0.9316)
    assert ops == pytest.approx(1.088e9, rel=2e-3)
    assert 1e6 * work.least_seconds(ops, 0)[0] == pytest.approx(16.2,
                                                                rel=5e-3)
    ops, _ = work.k7_backward(1280, 128, 960, True)
    assert ops == pytest.approx(5.662e9, rel=1e-3)
    assert 1e6 * work.least_seconds(ops, 0)[0] == pytest.approx(84.5,
                                                                rel=5e-3)


# ---- whole runs at a small size -------------------------------------------

RUNS = r'''
import json, sys, torch
torch.set_num_threads(2)
import numpy as np
from lfit_bench import hmc_faults, run as r
from lfit_bench.reference import spec
cell = r.load_cell(CELL)
cfg = dict(cell["config"], n_eclipses=1)
model = spec.build_spec(cfg, spec.light_curves(cfg, 5),
                        spec.REFERENCE_CLASSES).compile()
start = np.asarray(model.var_start())
over = {"config": {"n_eclipses": 1},
        "traffic": {"chains": 8, "leapfrog": 2, "segment_steps": 1,
                    "trace_seconds": 0.1, "step_size": 3.5,
                    "inv_mass": ((1e-3 * np.maximum(np.abs(start), 1e-2))
                                 ** 2).tolist()},
        "settings": {"check": {"sample": 2},
                     "limits": {"unmoved_pct": 100.0}}}
out = {}
res, _ = r.run(CELL, 2 ** 31 + 17, 1.0, True, device="cpu", overrides=over,
               controls=(torch.bfloat16,))
out["sound"] = res
for fault in FAULTS:
    undo = hmc_faults.plant(fault)
    out[fault], _ = r.run(CELL, 2 ** 31 + 17, 1.0, False, device="cpu",
                          overrides=over)
    undo()
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def runs():
    """The sound run (traced, with the bfloat16 control) and one run with
    each planted fault, in a process of their own."""
    code = f"CELL = {CELL!r}\nFAULTS = {FAULTS!r}\n" + RUNS
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_small_run_is_correct(runs):
    res = runs["sound"]
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"lnp_gap", "unmoved_pct", "leapfrog_ulps",
                                  "grad_gap", "accepted_gap",
                                  "rejected_gap"}
    # the line a benchmark run prints (it makes no control)
    json.dumps({k: v for k, v in res.items() if k != "controls"},
               allow_nan=False)


def test_the_control_is_not_correct(runs):
    limits = bench.load_cell(CELL)["settings"]["limits"]
    (read,) = runs["sound"]["controls"].values()
    over = [k for k, v in read.items()
            if not (isinstance(v, float) and v <= limits[k])]
    assert over, read


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(runs, fault):
    res = runs[fault]
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", READERS)
def test_a_small_traced_run_reads_the_host(runs, name):
    metrics = runs["sound"]["metrics"]
    if name in HOST:
        assert math.isfinite(metrics[name]["value"])
        assert metrics[name]["value"] > 0.0
    elif name in EMPTY_DEVICE:
        assert name in metrics
    else:
        # no replay on the CPU, and no kernel to read
        assert name not in metrics
