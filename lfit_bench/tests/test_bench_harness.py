"""The harness on the CPU at a tiny size: a cell added as data alone, the
result's line, the modules a run loads, and the faults and the control
that have to come out as not correct.

Runs here go through the port's plain paths (the kernel wrappers take
them on CPU tensors) with one eclipse, a few walkers and a window of a
second; every number is compared against the cell's own limits.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lfit_bench import check, control
from lfit_bench import run as bench
from lfit_bench.reference import spec
from lfit_bench.reference.posterior import Posterior as RefPosterior

REPO = Path(__file__).resolve().parents[2]
ENS = "hier5_calib.ensemble1024"
PROD = "prod10_gp.ensemble4096"
# a window of a step or two leaves some walkers where they were: a sound
# tiny run is held to every limit but the share unmoved
SOUND = {"settings": {"limits": {"unmoved_pct": 100.0}}}
TINY = {"config": {"n_eclipses": 1},
        "traffic": {"walkers": 8, "segment_steps": 1, "trace_seconds": 0.1},
        "settings": {"check": {"sample": 8}}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _tiny(workload, seed=2 ** 31 + 17, trace=False, root=bench.ROOT,
          overrides=None):
    return bench.run(workload, seed, 1.0, trace, device="cpu", root=root,
                     overrides=overrides or TINY)


def test_benchmark_json_is_well_formed():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    cells = {w["name"]: w for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in list(b["end_to_end"]) + list(b["per_layer"]):
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m.get("workloads", [])) <= set(cells)
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file() and len(c["source"]) <= 200
    for w in cells.values():
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        traffic = json.loads((REPO / "lfit_bench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (REPO / "lfit_bench" / "samplers"
                / f"{traffic['sampler']}.py").is_file()
        assert (REPO / "lfit_bench" / "cells" / f"{w['name']}.json").is_file()
        reported = [m for m in b["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
    for m in b["per_layer"]:
        assert (REPO / "lfit_bench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def _copy_with_cell(tmp_path, sampler, traffic, config, limits):
    """A copy of the harness under ``tmp_path`` with a configuration
    ``one_eclipse`` (the north star's file cut to one eclipse, then
    ``config``), a traffic mix ``mix8`` of the sampler ``sampler`` and the
    cell ``one_eclipse.mix8``, added as files and entries alone."""
    shutil.copytree(REPO / "lfit_bench", tmp_path / "lfit_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    here = tmp_path / "lfit_bench"
    cfg = json.loads((here / "configs" / "hier5_calib.json").read_text())
    cfg.update(name="one_eclipse", n_eclipses=1, bands=["g"], **config)
    (here / "configs" / "one_eclipse.json").write_text(json.dumps(cfg))
    (here / "traffic" / "mix8.json").write_text(json.dumps(
        {"sampler": sampler, "walkers": 8, "segment_steps": 1,
         "ball": {"rel": 1e-3, "floor": 1e-2}, "trace_seconds": 0.1,
         **traffic}))
    (here / "cells" / "one_eclipse.mix8.json").write_text(json.dumps(
        {"check": {"sample": 8}, "limits": limits}))
    b["configs"].append({"name": "one_eclipse", "source": "a test",
                         "file": "lfit_bench/configs/one_eclipse.json",
                         "reduced": ["n_eclipses"], "why": "a test"})
    b["workloads"].append({"name": "one_eclipse.mix8",
                           "config": "one_eclipse", "traffic": "mix8",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if ENS in m.get("workloads", []):
            m["workloads"].append("one_eclipse.mix8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return here


def test_a_cell_added_as_data_alone_runs(tmp_path):
    """A configuration, a traffic mix and a cell added by files and
    entries alone, with no edit to any file of the harness."""
    limits = json.loads((REPO / "lfit_bench" / "cells"
                         / f"{ENS}.json").read_text())["limits"]
    _copy_with_cell(tmp_path, "ensemble", {"a": 2.0}, {}, limits)
    res, rows = bench.run("one_eclipse.mix8", 5, 1.0, False, device="cpu",
                          root=tmp_path, overrides=SOUND)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"evals_per_s", "setup_s"}
    assert {r[0] for r in rows} == set(limits)


# a sampler the harness has never seen, added as a file of its own
RANDOM_WALK = '''"""Random-walk Metropolis, one proposal a walker a step."""
import torch

from lfit_python_tpu_torch.sampling.ensemble import EnsembleState


def start(traffic, post, start, scatter, gen):
    noise = torch.randn((traffic["walkers"], start.numel()), generator=gen,
                        dtype=start.dtype, device=start.device)
    pos = start + scatter * noise
    return EnsembleState(pos, post(pos), 0)


def step_fn(traffic, post, gen):
    def step(state):
        pos, lp = state.positions, state.log_prob
        like = dict(generator=gen, dtype=pos.dtype, device=pos.device)
        prop = pos + traffic["scale"] * pos.abs().clamp(min=1e-2) * \\
            torch.randn(pos.shape, **like)
        lp_prop = post(prop)
        take = torch.log(torch.rand(lp.shape, **like)) < lp_prop - lp
        return (EnsembleState(torch.where(take[:, None], prop, pos),
                              torch.where(take, lp_prop, lp),
                              state.step + 1), take.to(pos.dtype).mean())
    return step


def evals_per_step(traffic):
    return traffic["walkers"]


def check_points(traffic, record, idx):
    return record["before"][0][:0], None


def check(traffic, record, idx, memo, lp):
    return {"taken_pct": 100.0 * float(
        (record["after"][0] != record["before"][0]).any(1).mean())}


def control(traffic, record, idx, memo, lp, dtype, evaluate):
    return {}
'''


def test_a_sampler_added_as_a_file_alone_runs(tmp_path):
    """A new kind of sampler (``samplers/<name>.py``) and a configuration
    that states another dtype and resolution as data, added with a cell
    by files and entries alone."""
    here = _copy_with_cell(
        tmp_path, "random_walk", {"scale": 1e-4},
        {"dtype": "float64", "cv_config": {"n_spot": 16}},
        {"lnp_gap": 1e-6, "unmoved_pct": 100.0, "taken_pct": 100.0})
    (here / "samplers" / "random_walk.py").write_text(RANDOM_WALK)
    res, rows = bench.run("one_eclipse.mix8", 6, 1.0, False, device="cpu",
                          root=tmp_path)
    assert res["correct"], res["checks"]
    assert {r[0] for r in rows} == {"lnp_gap", "unmoved_pct", "taken_pct"}
    # float64 and 16 spot elements on both sides: ln p agrees to rounding
    assert res["checks"]["lnp_gap"]["value"] < 1e-6


def test_the_result_line():
    res, rows = _tiny(ENS, trace=True,
                      overrides=bench._merge(TINY, SOUND))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["correct"], res["checks"]
    assert {r[0] for r in rows} == {"lnp_gap", "unmoved_pct",
                                    "proposal_ulps", "accepted_gap",
                                    "rejected_gap"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the host-clock readers have something to read on the CPU too
    assert {"sampler_self_ms.ens", "host_ms_per_eval.ens"} <= set(
        res["metrics"])
    json.dumps(res, allow_nan=False)


def test_a_run_loads_no_module_of_jax():
    code = ("import json, sys; from lfit_bench import run as r; "
            f"r.run({ENS!r}, 3, 1.0, False, device='cpu', overrides="
            f"json.loads({json.dumps(json.dumps(TINY))})); "
            "print(json.dumps(r.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("lfit_python_tpu_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "lfit_python_tpu.models", object())
    assert bench.forbidden_modules() == ["jax", "lfit_python_tpu"]


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "lfit_bench.run",
                          "--workload", ENS, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _unchanged(state, *a, **k):
    return state._replace(step=state.step + 1), torch.zeros(())


def _half(fn):
    """The posterior on the first half of the batch, the rest given the
    mean of those."""
    def call(self, var):
        h = max(var.shape[0] // 2, 1)
        out = fn(self, var[:h])
        return torch.cat([out, out.mean().expand(var.shape[0] - h)])
    return call


def _altered(fn):
    """The posterior with the first answer of each call altered: its
    ln p by 1%."""
    def call(self, var):
        out = fn(self, var).clone()
        out[0] *= 1.01
        return out
    return call


@pytest.mark.parametrize("workload", [ENS, PROD])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "accept_all", "wrong_stretch"])
def test_a_fault_is_not_correct(workload, fault, monkeypatch):
    from lfit_python_tpu_torch.models.likelihood import Posterior
    from lfit_python_tpu_torch.sampling import ensemble

    if fault == "unchanged":
        monkeypatch.setattr(ensemble, "ensemble_step", _unchanged)
    elif fault in ("half", "altered"):
        wrap = _half if fault == "half" else _altered
        monkeypatch.setattr(Posterior, "__call__", wrap(Posterior.__call__))
    else:
        monkeypatch.setattr(ensemble, "_half_update",
                            control.FAULTS[fault](ensemble._half_update))
    # prod10_gp at its ten eclipses: its ln p limit is of their size
    res, rows = _tiny(workload, overrides=bench._merge(
        TINY, {"config": {"n_eclipses": 10}}) if workload == PROD else None)
    assert not res["correct"], rows


@pytest.mark.parametrize("workload", [ENS, PROD])
def test_the_control_is_not_correct(workload):
    """The reference in bfloat16, put in the program's place, fails the
    cell's ln p limit (at the start ball of a one-eclipse cut)."""
    cell = bench.load_cell(workload)
    cfg = dict(cell["config"], n_eclipses=1)
    curves = spec.light_curves(cfg, 9)
    model = spec.build_spec(cfg, curves, spec.REFERENCE_CLASSES).compile()
    start = model.var_start()
    x = start + 1e-3 * np.maximum(np.abs(start), 1e-2) * \
        np.random.default_rng(9).standard_normal((4, start.size))
    lp_ref = check.reference_eval(RefPosterior(model), x)[0]
    lp_c = check.reference_eval(RefPosterior(model, dtype=torch.bfloat16),
                                x)[0]
    gap = check.lnp_gap(lp_c, lp_ref)
    assert not gap <= cell["settings"]["limits"]["lnp_gap"], gap
    assert math.isinf(gap) or gap > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [ENS])
def test_a_cell_runs_on_the_card(workload):
    """A short window of the cell on the card, from the command line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "lfit_bench.run",
                          "--workload", workload, "--seed", "2147483999",
                          "--seconds", "3", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
