"""The port's posterior tools on the CPU: the ablation tool's stage
replacements, and the accuracy and parity tools at small sizes.

``patched()`` (tools/torch_ablate_posterior.py) must replace every
binding of a stage's function in the package's loaded modules, put every
one back on exit (also when the block raises), and each flux ablation
must change only its own stage: with it, ``cv_fluxes``' components are
the full model's bit for bit except the ones the stage feeds, which
become the constant's; ``host_ms`` times every ablation in turn, each
inside its own context.  The accuracy tool holds K1's plain twin in
float32 to the p99 gate on a small stress set, the parity tool float32 to
PERF.md section 2's limits on 2 vectors; both exit 0.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import torch_ablate_posterior as ablate  # noqa: E402
import torch_accuracy_contacts as accuracy  # noqa: E402
import torch_parity as parity  # noqa: E402

from lfit_python_tpu_torch.models import components as comp  # noqa: E402
from lfit_python_tpu_torch.models import cv as cvmod  # noqa: E402
from lfit_python_tpu_torch.models import likelihood as lk  # noqa: E402
from lfit_python_tpu_torch.ops import stream as ops_stream  # noqa: E402
from lfit_python_tpu_torch.roche import geometry as geo  # noqa: E402

STAGES = ("stream", "findi", "spotel", "prior", "wd", "contacts", "curve",
          "donor", "dgrid")
# (module, name) of each stage's function and where it is bound
BINDINGS = {
    "stream": [(ops_stream, "stream_impacts"), (lk, "stream_impacts"),
               (cvmod, "stream_impacts"), (comp, "stream_impacts")],
    "findi": [(geo, "findi"), (lk, "findi"), (cvmod, "findi")],
    "spotel": [(comp, "spot_elements")],
    "prior": [(lk, "ln_prior_table")],
    "wd": [(comp, "wd_flux")],
    "contacts": [(comp, "element_intervals")],
    "curve": [(comp, "element_flux_curve")],
    "donor": [(comp, "donor_flux")],
    "dgrid": [(comp, "donor_grid"), (lk, "donor_grid")],
}


def _snapshot():
    return {(m.__name__, n): getattr(m, n) for pairs in BINDINGS.values()
            for m, n in pairs}


@pytest.mark.parametrize("stage", STAGES)
def test_patched_replaces_every_binding_and_restores_it(stage):
    before = _snapshot()
    with ablate.patched(**{stage: True}):
        fakes = {getattr(m, n) for m, n in BINDINGS[stage]}
        assert len(fakes) == 1
        assert all(getattr(m, n) is not before[m.__name__, n]
                   for m, n in BINDINGS[stage])
        others = {k: v for k, v in _snapshot().items()
                  if k not in {(m.__name__, n) for m, n in BINDINGS[stage]}}
        assert all(before[k] is v for k, v in others.items())
    assert _snapshot() == before


def test_patched_restores_when_the_block_raises():
    before = _snapshot()
    with pytest.raises(KeyError):
        with ablate.patched(**dict.fromkeys(STAGES, True)):
            assert _snapshot() != before
            raise KeyError("inside")
    assert _snapshot() == before


# the components each flux ablation feeds
FEEDS = {"wd": {"ywd"}, "contacts": {"ydisc", "yspot"},
         "curve": {"ydisc", "yspot"}, "donor": {"ysec"},
         "dgrid": {"ysec"}}


@pytest.fixture(scope="module")
def full_fluxes():
    from lfit_python_tpu_torch.models.cv import CVConfig

    pars = torch.tensor(
        [[0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.01, 0.02, 160.0,
          0.2, 1.5, 0.0, 1.0, 1.0, 90.0, 0.0]] * 2, dtype=torch.float64)
    pars[1, 4] = 0.17
    phases = torch.linspace(-0.1, 0.1, 33, dtype=torch.float64)
    cfg = CVConfig(complex_spot=True, n_disc_rad=5, n_disc_az=8, n_spot=8,
                   n_donor_lat=6, n_donor_lon=8)

    def run():
        with torch.inference_mode():
            return cvmod.cv_fluxes(pars, phases, config=cfg)._asdict()
    return run, run()


@pytest.mark.parametrize("stage", sorted(FEEDS))
def test_each_flux_ablation_changes_only_its_stage(stage, full_fluxes):
    run, full = full_fluxes
    with ablate.patched(**{stage: True}):
        got = run()
    for name in ("ywd", "ydisc", "yspot", "ysec"):
        if name in FEEDS[stage]:
            assert not torch.equal(got[name], full[name]), name
        else:
            assert torch.equal(got[name], full[name]), name
    if stage == "wd":         # ones, times wdFlux
        assert torch.equal(got["ywd"], torch.full_like(got["ywd"], 0.1))


def test_accuracy_tool_passes_its_gate_on_the_cpu(capsys):
    assert accuracy.main(["--device", "cpu", "--rows", "32",
                          "--elements", "32"]) == 0
    assert "gate (p99 <= 1e-5 cycles" in capsys.readouterr().out


def test_parity_tool_passes_its_limits_on_the_cpu(capsys):
    assert parity.main(["--device", "cpu", "--draws", "2"]) == 0
    out = capsys.readouterr().out
    assert "[fast] total flux rel err" in out and "[precise]" in out


def test_parity_flux_errors_are_relative_to_the_largest_total():
    from lfit_python_tpu_torch.models.cv import CVFluxes

    ones = np.ones((1, 4))
    oracle = CVFluxes(2 * ones, ones, 0 * ones, 0 * ones, ones)
    test = CVFluxes(2 * ones + 1e-3, ones + 1e-3, 0 * ones, 0 * ones, ones)
    r = parity.flux_errors(test, oracle)
    assert r["total"]["max"] == pytest.approx(5e-4)
    assert r["ywd"]["max"] == pytest.approx(5e-4)
    assert r["ysec"]["max"] == 0.0 and r["ok"] is False


def test_host_ms_times_every_function_in_turn_inside_its_context():
    import contextlib

    log = []

    @contextlib.contextmanager
    def context(name):
        log.append(f"enter {name}")
        yield
        log.append(f"exit {name}")

    fns = {name: (lambda name=name: log.append(name)) for name in "ab"}
    ms = ablate.host_ms(fns, reps=2, context=context, per_turn=3)
    assert set(ms) == {"a", "b"}
    assert all(0 <= v < float("inf") for v in ms.values())
    # a warm-up call each, then two rounds of three calls each, in turn
    turn = [["enter a", *"aaa", "exit a"], ["enter b", *"bbb", "exit b"]]
    assert log == ["enter a", "a", "exit a", "enter b", "b", "exit b",
                   *turn[0], *turn[1], *turn[0], *turn[1]]
