"""The port's stage spans and the benchmark's readers of them, on the CPU.

A posterior call under ``torch.profiler`` records its stages as
``record_function`` ranges (``utils.tracing``), the sampler loop its
kept rows' copies; with no profiler running a span is one shared null
context.  ``lfit_bench.stages`` puts a synthetic trace's device events
down to the innermost stage open at their launch, and every stage reader
reads None with no trace and, in a tiny traced run of the harness on the
CPU (no device events), only the host's numbers.
"""

import contextlib
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lfit_bench import layers, stages
from lfit_bench import run as bench
from lfit_bench.trace import POSTERIOR, STEP, Trace
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.sampling.ensemble import (EnsembleState,
                                                     run_chunked)
from lfit_python_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parents[1]
TINY = dict(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
            n_donor_lon=8)
POSTERIOR_STAGES = (tracing.PARAMS, tracing.GEOMETRY, tracing.FLUX,
                    tracing.CONTACTS)
HOST_READERS = ("params.host_ms.ens", "geometry.host_ms.ens",
                "contacts.host_ms.ens", "flux.host_ms.ens",
                "gp.host_ms.ens", "chain_copy_ms.ens")
DEVICE_READERS = ("h2d_copies_per_eval.ens", "geometry.device_ms.ens",
                  "contacts.device_ms.ens", "flux.device_ms.ens",
                  "gp.device_ms.ens")


def _stage_ranges(fn):
    """The ``lfit.*`` ranges (name, start ns, end ns) ``fn()`` records
    under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() in tracing.SPANS]


def _posterior(use_gp):
    model = build_model(n_eclipses=1, use_gp=use_gp, n_points=8).compile()
    post = make_ln_prob(model, CVConfig(**TINY), device="cpu")
    # a short stream scan: the spans, not the physics, are under test
    post.stream_steps = 64
    var = torch.tensor(model.var_start(), dtype=torch.float64)[None]
    return post, var.expand(2, -1).clone()


@pytest.fixture(scope="module")
def chi2():
    return _posterior(False)


@pytest.fixture(scope="module")
def gp():
    return _posterior(True)


def test_the_names_are_the_benchmarks():
    assert tracing.SPANS == stages.SPANS


@pytest.mark.parametrize("model", ["chi2", "gp"])
def test_a_posterior_call_records_each_stage_once(model, request):
    post, var = request.getfixturevalue(model)
    ranges = _stage_ranges(lambda: post(var))
    names = [r[0] for r in ranges]
    for stage in POSTERIOR_STAGES:
        assert names.count(stage) == 1, names
    assert names.count(tracing.GP) == (1 if model == "gp" else 0)
    assert tracing.CHAIN_COPY not in names
    by = {r[0]: r for r in ranges}
    flux, contacts = by[tracing.FLUX], by[tracing.CONTACTS]
    assert flux[1] <= contacts[1] and contacts[2] <= flux[2]
    # the stages follow one another: none holds another but the flux
    for a, b in zip(ranges, ranges[1:]):
        if a[0] != tracing.FLUX:
            assert a[2] <= b[1], (a, b)


@pytest.mark.parametrize("path, expect", [
    ("ln_prior", {tracing.PARAMS, tracing.GEOMETRY}),
    ("parts", set(POSTERIOR_STAGES) | {tracing.GP}),
    ("value_and_grad", set(POSTERIOR_STAGES) | {tracing.GP}),
])
def test_every_path_records_its_stages(gp, path, expect):
    post, var = gp
    names = [r[0] for r in _stage_ranges(lambda: getattr(post, path)(var))]
    assert set(names) == expect
    assert all(names.count(s) == 1 for s in expect), names


def test_run_chunked_records_a_copy_per_kept_row():
    def step(state):
        return (EnsembleState(state.positions + 1.0, state.log_prob,
                              state.step + 1), torch.tensor(0.5))

    state = EnsembleState(torch.zeros(4, 3), torch.zeros(4), 0)
    out = {}

    def go():
        out["run"] = run_chunked(state, step, 5, thin=1, chunk_size=2)

    names = [r[0] for r in _stage_ranges(go)]
    assert names == [tracing.CHAIN_COPY] * 5
    _, chain, _, aux = out["run"]
    assert chain.shape == (5, 4, 3) and aux[0].tolist() == [0.5] * 5


def test_a_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    spans = [tracing.annotate(name) for name in tracing.SPANS]
    assert all(s is spans[0] for s in spans)
    assert isinstance(spans[0], contextlib.nullcontext)
    with tracing.annotate(tracing.PARAMS):
        with tracing.annotate(tracing.PARAMS):
            pass


def test_a_span_under_a_profiler_is_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.annotate("lfit.test_range"):
            torch.ones(4) + 1.0
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("lfit.test_range") == 1


# ---- lfit_bench.stages on a synthetic trace -----------------------------

def _launch(name, t):
    return (name, t, t + 5)


def _trace():
    """One step of one posterior call: the prior's copy in lfit.params, a
    kernel in the contact solve inside the flux, one in the flux outside
    it, one outside every stage, and the kept row's copy."""
    host = [
        (STEP, 0, 1000), (POSTERIOR, 5, 750),
        (tracing.PARAMS, 10, 100), _launch("cudaMemcpyAsync", 20),
        (tracing.GEOMETRY, 100, 200), _launch("cudaLaunchKernel", 150),
        (tracing.FLUX, 200, 600),
        (tracing.CONTACTS, 300, 400), _launch("cudaLaunchKernel", 310),
        ("aten::cat", 320, 330), _launch("cuLaunchKernel", 500),
        _launch("cudaLaunchKernelExC", 700),
        (tracing.CHAIN_COPY, 800, 900), _launch("cudaMemcpyAsync", 810),
    ]
    device = [  # not in start order: the reader sorts them
        ("contacts_kernel", 320, 50),
        ("Memcpy HtoD (Pageable -> Device)", 30, 4),
        ("stream_kernel", 160, 30),
        ("element_curve_kernel", 510, 40),
        ("elementwise_kernel", 710, 20),
        ("Memcpy DtoH (Device -> Pageable)", 820, 6),
    ]
    return Trace((0, 1000), device, host)


def _ctx(trace, calls=1):
    return layers.Context({}, {}, trace=trace, trace_rows=[8] * calls)


def test_stages_put_device_events_down_to_the_innermost_span():
    ctx = _ctx(_trace())
    s = stages.Summary(ctx.trace)
    assert s.launches == s.events == 6
    owners = {e[0]: o for e, o in s.owners}
    assert owners == {
        "Memcpy HtoD (Pageable -> Device)": tracing.PARAMS,
        "stream_kernel": tracing.GEOMETRY,
        "contacts_kernel": tracing.CONTACTS,
        "element_curve_kernel": tracing.FLUX,
        "elementwise_kernel": None,
        "Memcpy DtoH (Device -> Pageable)": tracing.CHAIN_COPY}
    assert stages.device_ms(ctx, tracing.CONTACTS) == pytest.approx(50e-6)
    assert stages.device_ms(ctx, tracing.FLUX) == pytest.approx(40e-6)
    assert stages.device_ms(ctx, tracing.GEOMETRY) == pytest.approx(30e-6)
    # copies are counted, not timed: params launched a copy, no kernel
    assert stages.device_ms(ctx, tracing.PARAMS) == 0.0
    assert stages.h2d_per_call(ctx) == 1.0
    assert stages.h2d_per_call(_ctx(_trace(), calls=4)) == 0.25


def test_stages_take_self_time_and_per_step_time():
    ctx = _ctx(_trace(), calls=2)
    assert stages.host_ms(ctx, tracing.PARAMS) == pytest.approx(45e-6)
    assert stages.host_ms(ctx, tracing.CONTACTS) == pytest.approx(50e-6)
    # the flux less the contact solve inside it
    assert stages.host_ms(ctx, tracing.FLUX) == pytest.approx(150e-6)
    assert stages.host_ms(ctx, tracing.CHAIN_COPY,
                          per_step=True) == pytest.approx(100e-6)
    assert stages.host_ms(ctx, tracing.GP) is None


def test_stages_attribute_nothing_where_the_counts_differ():
    tr = _trace()
    tr.device = tr.device[:-1]
    ctx = _ctx(tr)
    assert stages.Summary(tr).owners is None
    for stage in (tracing.CONTACTS, tracing.FLUX, tracing.GEOMETRY):
        assert stages.device_ms(ctx, stage) is None
    assert stages.h2d_per_call(ctx) is None
    # the host's numbers do not need the device
    assert stages.host_ms(ctx, tracing.CONTACTS) == pytest.approx(100e-6)


def test_stages_read_none_without_the_spans():
    tr = _trace()
    tr.host = [h for h in tr.host if h[0] not in tracing.SPANS]
    ctx = _ctx(tr)
    for stage in tracing.SPANS:
        assert stages.host_ms(ctx, stage) is None
        assert stages.device_ms(ctx, stage) is None
    assert stages.h2d_per_call(ctx) is None


# ---- the readers --------------------------------------------------------

def _reader(name):
    return bench._load(REPO / "lfit_bench" / "metrics" / f"{name}.py")


def test_the_readers_are_the_benchmarks_entries():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in b["per_layer"]}
    for name in HOST_READERS + DEVICE_READERS:
        m = entries[name]
        assert m["moves"] == "evals_per_s" and m["source"] == "device_trace"
        assert (REPO / "lfit_bench" / "metrics" / f"{name}.py").is_file()
    assert entries["gp.host_ms.ens"]["workloads"] == [
        "prod10_gp.ensemble4096"]


@pytest.mark.parametrize("name", HOST_READERS + DEVICE_READERS)
def test_a_reader_reads_none_without_a_trace(name):
    assert _reader(name).read(layers.Context({}, {})) is None


@pytest.fixture(scope="module")
def tiny_traced_line():
    """The result line of a tiny traced run of the GP cell on the CPU, in
    a process of its own (this one has JAX loaded, which a run refuses)."""
    over = {"config": {"n_eclipses": 1},
            "traffic": {"walkers": 8, "segment_steps": 1,
                        "trace_seconds": 0.1},
            "settings": {"check": {"sample": 8},
                         "limits": {"unmoved_pct": 100.0}}}
    code = ("import json, torch; torch.set_num_threads(2); "
            "from lfit_bench import run as r; "
            "res, _ = r.run('prod10_gp.ensemble4096', 2 ** 31 + 29, 1.0, "
            f"True, device='cpu', overrides={over!r}); "
            "print(json.dumps(res))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", HOST_READERS + DEVICE_READERS)
def test_a_tiny_traced_run_reads_the_host_and_not_the_device(
        tiny_traced_line, name):
    metrics = tiny_traced_line["metrics"]
    if name in HOST_READERS:
        assert math.isfinite(metrics[name]["value"])
        assert metrics[name]["value"] > 0.0
    else:
        # the CPU has no device events to put down to a stage
        assert name not in metrics
    assert tiny_traced_line["correct"], tiny_traced_line["checks"]
