"""The posterior's graph route and its resident tables, on the CPU.

``models/graphs.py`` decides per call whether a forward evaluation runs
eagerly, is captured, or is replayed; here the capture is injected (a
host stand-in of a CUDA graph: its replay runs the captured function into
the static outputs), so that the decision, the replay's copies and the
launch counters are checked without a card.  The tables the posterior
keeps on its device give the values the per-call copies gave, and a
forward call copies nothing from numpy.  ``value_and_grad`` is an entry
of its own, captured forward and backward together in any grad mode, and
holds the benchmark's float64 reference's gradient; ``init_hmc``'s
redraws take no slot of the cache.  The card's own tests
(``test_torch_cuda.py``) replay real graphs.
"""

import numpy as np
import pytest
import torch

from lfit_bench import layers
from lfit_bench import run as bench
from lfit_bench.trace import POSTERIOR, Trace
from lfit_python_tpu_torch import ops
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models import graphs
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.models.priors import (PriorTensors, ln_prior_table,
                                                  prior_tensors)
from lfit_python_tpu_torch.utils import tracing

TINY = dict(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
            n_donor_lon=8)
READER = bench.HERE / "metrics" / "replays_per_eval.ens.py"


class HostGraph:
    """A CUDA graph's stand-in on the CPU: made by running ``fn`` on the
    static input (the capture), each replay runs it again into the same
    output tensors."""

    def __init__(self, fn, static_in):
        self.fn, self.static_in = fn, static_in
        self.static_out = fn(static_in)
        self.replays = 0

    def replay(self):
        self.replays += 1
        fresh = self.fn(self.static_in)
        if isinstance(fresh, tuple):
            for t, f in zip(self.static_out, fresh):
                t.copy_(f)
        else:
            self.static_out.copy_(fresh)


class Captures:
    """An injected ``capture``: each call's (fn, input shape), and the
    :class:`graphs.Replay` of a :class:`HostGraph` with ``launches``."""

    def __init__(self, launches=None):
        self.made = []
        self.launches = launches or (0,) * len(ops.launch_counts())

    def __call__(self, fn, var):
        self.made.append((fn, tuple(var.shape)))
        static_in = var.clone()
        out = fn(static_in)
        g = HostGraph(fn, static_in)
        return graphs.Replay(g, static_in, g.static_out, self.launches), out


@pytest.fixture
def on_card(monkeypatch):
    """Every tensor taken as one on a card (the grad check stays)."""
    monkeypatch.setattr(graphs, "_on_card", lambda var: True)


@pytest.fixture
def counters(monkeypatch):
    """The launch counters, restored after the test."""
    for mod, name in ops._all_counters():
        monkeypatch.setattr(mod, name, getattr(mod, name))


def _counting(fn):
    calls = []

    def wrapped(var):
        calls.append(tuple(var.shape))
        return fn(var)

    return wrapped, calls


def _double(var):
    return 2.0 * var.sum(dim=-1)


# ---- the route ------------------------------------------------------------

def test_a_call_on_the_cpu_runs_eagerly():
    cache, cap = graphs.GraphCache(), Captures()
    cache.capture = cap
    fn, calls = _counting(_double)
    x = torch.ones(3, 2)
    with torch.inference_mode():
        outs = [cache("ln_prob", fn, x) for _ in range(4)]
    assert calls == [(3, 2)] * 4 and cap.made == []
    assert cache.seen == set() and cache.graphs == {}
    assert all(torch.equal(o, _double(x)) for o in outs)


def test_a_call_that_autograd_records_runs_eagerly(on_card):
    cache, cap = graphs.GraphCache(), Captures()
    cache.capture = cap
    fn, calls = _counting(_double)
    x = torch.ones(3, 2, requires_grad=True)
    for _ in range(3):
        cache("ln_prob", fn, x).sum().backward()
    assert calls == [(3, 2)] * 3 and cap.made == [] and cache.seen == set()


def test_first_sight_is_eager_the_second_call_captures_then_replays(
        on_card):
    cache, cap = graphs.GraphCache(), Captures()
    cache.capture = cap
    fn, calls = _counting(_double)
    xs = [torch.full((3, 2), float(k)) for k in range(4)]
    with torch.inference_mode():
        outs = [cache("ln_prob", fn, x) for x in xs]
    # eager; the capture's warm-up and the stand-in's recording; two
    # replays
    assert len(cap.made) == 1 and cap.made[0][1] == (3, 2)
    assert calls == [(3, 2)] * 5
    replay = cache.graphs["ln_prob", (3, 2), torch.float32,
                          torch.device("cpu")]
    assert replay.graph.replays == 2
    assert all(torch.equal(o, _double(x)) for o, x in zip(outs, xs))


def test_each_entry_shape_and_dtype_is_a_key(on_card):
    cache, cap = graphs.GraphCache(), Captures()
    cache.capture = cap
    with torch.inference_mode():
        for _ in range(2):
            for entry in ("ln_prob", "parts"):
                cache(entry, _double, torch.ones(3, 2))
            cache("ln_prob", _double, torch.ones(5, 2))
            cache("ln_prob", _double, torch.ones(3, 2, dtype=torch.float64))
    assert sorted(shape for _, shape in cap.made) == [(3, 2)] * 3 + [(5, 2)]


def test_the_cap_on_keys_holds(on_card):
    cache, cap = graphs.GraphCache(), Captures()
    cache.capture = cap
    fn, calls = _counting(_double)
    with torch.inference_mode():
        for _ in range(3):
            for n in range(1, graphs.MAX_GRAPHS + 3):
                cache("ln_prob", fn, torch.ones(n, 2))
    assert len(cap.made) == len(cache.graphs) == graphs.MAX_GRAPHS
    # the keys past the cap stay eager: three calls each, none captured
    extra = [(n, 2) for n in range(graphs.MAX_GRAPHS + 1,
                                   graphs.MAX_GRAPHS + 3)]
    assert [c for c in calls if c in extra] == extra * 3


# ---- the replay -----------------------------------------------------------

def test_two_replays_return_outputs_that_are_not_aliased():
    static_in = torch.zeros(4, 3)

    def both(var):
        return var.sum(dim=-1), var.amax(dim=-1)

    g = HostGraph(both, static_in)
    replay = graphs.Replay(g, static_in, g.static_out,
                           (0,) * len(ops.launch_counts()))
    a, b = torch.rand(4, 3), torch.rand(4, 3)
    ra, rb = replay(a), replay(b)
    assert all(torch.equal(x, y) for x, y in zip(ra, both(a)))
    assert all(torch.equal(x, y) for x, y in zip(rb, both(b)))
    for t in ra + rb:
        assert all(t.data_ptr() != s.data_ptr() for s in g.static_out)
    assert ra[0].data_ptr() != rb[0].data_ptr()


def test_a_replay_adds_what_its_capture_counted(counters):
    n = len(ops.launch_counts())
    launches = tuple(k % 3 for k in range(n))
    static_in = torch.zeros(2, 2)
    g = HostGraph(_double, static_in)
    replay = graphs.Replay(g, static_in, g.static_out, launches)
    before = ops.launch_counts()
    replay(torch.ones(2, 2))
    replay(torch.ones(2, 2))
    assert ops.launch_counts() == tuple(b + 2 * d
                                        for b, d in zip(before, launches))


def test_the_launch_counters_are_the_wrappers_integers():
    import importlib

    found = [(m.__name__.rsplit(".", 1)[1], n)
             for m, n in ops._all_counters()]
    assert sorted(found) == sorted(
        [("contacts", n) for n in ("LAUNCHES", "F64_LAUNCHES",
                                   "MIXED_LAUNCHES", "BACKWARD_CALLS",
                                   "BACKWARD_LAUNCHES")]
        + [("gp", "LAUNCHES"), ("gp", "BACKWARD_LAUNCHES")]
        + [("roche", n) for n in ("FINDI_LAUNCHES", "XL1_LAUNCHES",
                                  "LOBE_LAUNCHES")]
        + [("stream", "LAUNCHES"), ("stream", "SENS_LAUNCHES")]
        + [("sweeps", n) for n in ("CURVE_LAUNCHES",
                                   "CURVE_BACKWARD_LAUNCHES",
                                   "DONOR_LAUNCHES",
                                   "DONOR_BACKWARD_LAUNCHES")]
        + [("wd_donor", "DONOR_GRID_LAUNCHES"), ("wd_donor", "WD_LAUNCHES")])
    assert ops.launch_counts() == tuple(
        getattr(importlib.import_module(f"lfit_python_tpu_torch.ops.{m}"), n)
        for m, n in found)


# ---- the posterior --------------------------------------------------------

def _posterior(use_gp=False):
    model = build_model(n_eclipses=2, complex_spot=[False, True],
                        use_gp=[use_gp, False], n_points=8,
                        bands=("g",)).compile()
    post = make_ln_prob(model, CVConfig(**TINY), device="cpu")
    # a short stream scan: the route, not the physics, is under test
    post.stream_steps = 64
    start = model.var_start()
    rng = np.random.default_rng(7)
    var = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((3, start.size)))
    return model, post, var


@pytest.fixture(scope="module")
def gp_posterior():
    return _posterior(use_gp=True)


@pytest.mark.parametrize("entry", ["__call__", "parts", "ln_prior",
                                   "ln_like"])
def test_a_replayed_entry_gives_the_eager_bits(gp_posterior, on_card, entry):
    _, post, var = gp_posterior
    post._graphs = graphs.GraphCache(capture=Captures())
    fn = getattr(post, entry)
    eager, captured, replayed = fn(var), fn(var), fn(var)
    assert len(post._graphs.capture.made) == 1
    for out in (captured, replayed):
        for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (eager, out))):
            assert torch.equal(a, b)


def test_value_and_grad_takes_its_own_entry_alone(gp_posterior, on_card):
    """``value_and_grad`` never takes a forward entry's route: its calls
    see and capture its own entry alone, and a forward call after them is
    a first sight."""
    _, post, var = gp_posterior
    post._graphs = graphs.GraphCache(capture=Captures())
    for _ in range(3):
        post.value_and_grad(var)
    key = (tuple(var.shape), var.dtype, var.device)
    assert post._graphs.seen == {("value_and_grad", *key)}
    assert list(post._graphs.graphs) == [("value_and_grad", *key)]
    post(var)
    assert len(post._graphs.capture.made) == 1
    post(var)
    assert set(post._graphs.graphs) == {("value_and_grad", *key),
                                        ("ln_prob", *key)}


# ---- the gradient entry ---------------------------------------------------

class _OnCard:
    """A tensor's stand-in on a card, for the route's rules."""
    is_cuda = True


@pytest.mark.parametrize("capturing", [False, True])
def test_the_rules_of_the_route(monkeypatch, capturing):
    """On a card a call takes the route with grad mode off; under another
    capture it does not, nor with grad mode on, nor on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    var = _OnCard()
    with torch.no_grad():
        assert graphs.routable(var) is not capturing
        assert not graphs.routable(torch.ones(1))
    with torch.enable_grad():
        assert graphs.routable(var) is False


def test_a_forward_entry_stays_eager_under_autograd_the_gradient_does_not(
        gp_posterior, on_card):
    """Under autograd a forward entry's calls stay eager, while
    ``value_and_grad`` on the same cache, which turns grad mode off around
    its entry, is captured."""
    _, post, var = gp_posterior
    post._graphs = graphs.GraphCache(capture=Captures())
    fn, calls = _counting(_double)
    x = torch.ones(3, 2, requires_grad=True)
    with torch.enable_grad():
        for _ in range(3):
            post._graphs("ln_prob", fn, x)
        for _ in range(2):
            post.value_and_grad(var)
    assert calls == [(3, 2)] * 3
    assert list(post._graphs.graphs) == [("value_and_grad",
                                          tuple(var.shape), var.dtype,
                                          var.device)]


def test_a_gradient_call_on_the_cpu_runs_eagerly(gp_posterior):
    _, post, var = gp_posterior
    post._graphs = graphs.GraphCache(capture=Captures())
    outs = [post.value_and_grad(var) for _ in range(3)]
    assert post._graphs.capture.made == [] and post._graphs.seen == set()
    assert all(torch.equal(a, b) for o in outs[1:]
               for a, b in zip(o, outs[0]))


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
def test_value_and_grad_replays_in_any_grad_mode(gp_posterior, on_card,
                                                 mode):
    """The first call of a batch eager, the second captured, the replays
    after it: each the eager evaluation's bits, on two inputs of the one
    shape in turns, in the caller's grad mode ``mode`` (the route; the
    short stream scan leaves these walkers outside the support, and
    ``test_value_and_grad_holds_the_reference_gradient`` replays finite
    gradients)."""
    _, post, var = gp_posterior
    post._graphs = graphs.GraphCache(capture=Captures())
    other = var.flip(0).contiguous()
    want = {0: post._value_and_grad(var), 1: post._value_and_grad(other)}
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[mode]
    with ctx():
        got = [(k % 2, post.value_and_grad(x))
               for k, x in enumerate((var, other, var, other))]
    (replay,) = post._graphs.graphs.values()
    assert len(post._graphs.capture.made) == 1 and replay.graph.replays == 2
    for k, (lp, g) in got:
        assert torch.equal(lp, want[k][0]) and torch.equal(g, want[k][1])
        assert not lp.requires_grad and not g.requires_grad


def test_init_hmc_redraws_take_no_slot_of_the_graph_cache(on_card):
    """A start ball that redraws (q scattered across its prior's lower
    bound; with this seed the rounds redraw 4, then 1, then 1 chains):
    every gradient call has the chains' shape, so the cache captures the
    chains' key alone, and each chain carries its own evaluation."""
    from lfit_python_tpu_torch.sampling import hmc

    model, post, _ = _posterior()
    post.stream_steps = 4352    # finite ln p at the start vector
    post._graphs = graphs.GraphCache(capture=Captures())
    start = torch.tensor(model.var_start())
    scatter = 1e-3 * start.abs().clamp(min=1e-2)
    scatter[model.param_names.index("q_core")] = 0.25
    calls = []

    def vg(x):
        calls.append(tuple(x.shape))
        return post.value_and_grad(x)

    state = hmc.init_hmc(torch.Generator().manual_seed(2), start, scatter,
                         post, 8, vg_fn=vg)
    assert len(calls) > 2 and set(calls) == {(8, start.numel())}
    assert list(post._graphs.graphs) == [
        ("value_and_grad", (8, start.numel()), start.dtype, start.device)]
    lp, g = post._value_and_grad(state.positions)
    assert bool(torch.isfinite(state.log_prob).all())
    assert torch.equal(state.log_prob, lp) and torch.equal(state.grad, g)


# the one-eclipse north star at a low resolution, for the gradient against
# the benchmark's float64 reference
HIER1 = dict(n_eclipses=1, cv_config=TINY)


@pytest.fixture(scope="module")
def hier1_reference():
    import json

    from lfit_bench import check
    from lfit_bench.reference import spec
    from lfit_bench.reference.cv import CVConfig as RefCVConfig
    from lfit_bench.reference.posterior import Posterior as RefPosterior

    cfg = json.loads((bench.HERE / "configs" / "hier5_calib.json")
                     .read_text())
    cfg.update(HIER1)
    curves = spec.light_curves(cfg, 11)
    ref_model = spec.build_spec(cfg, curves,
                                spec.REFERENCE_CLASSES).compile()
    ref = RefPosterior(ref_model, RefCVConfig(**TINY), dtype=torch.float64,
                       device="cpu")
    start = np.asarray(ref_model.var_start())
    scale = 1e-3 * np.maximum(np.abs(start), 1e-2)
    x = start + scale * np.random.default_rng(11).standard_normal(
        (3, start.size))
    # central differences at 1e-4 of the ball's scale: the float64
    # rounding of ln p over the step is ~1e-9 of a scaled gradient, the
    # truncation ~1e-8
    D = start.size
    h = 1e-4 * scale
    pts = np.concatenate([x[:, None] + np.diag(h)[None],
                          x[:, None] - np.diag(h)[None]], axis=1)
    lp = check.reference_eval(ref, pts.reshape(-1, D))[0].reshape(3, 2, D)
    return cfg, curves, x, scale, (lp[:, 0] - lp[:, 1]) / (2 * h)


# the gradient's distance from the reference's: the norm of the difference
# scaled by the ball's scale over the larger of the scaled reference's
# norm and sqrt(D) (lfit_bench/samplers/hmc.py's grad_gap).  float64:
# the port and the reference are one model's arithmetic, 6e-7 measured;
# float32: the model's rounding, 6.3e-4 measured
GRAD_TOL = {torch.float64: 1e-5, torch.float32: 5e-3}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_value_and_grad_holds_the_reference_gradient(hier1_reference,
                                                     on_card, dtype):
    """The port's gradient at three seeded points of the one-eclipse
    north star, eager, from the injected capture and replayed (the same
    bits), against central differences of the float64 reference."""
    cfg, curves, x, scale, g_ref = hier1_reference
    _, post = bench.program(dict(cfg, dtype=str(dtype).split(".")[1]),
                            curves, "cpu")
    post._graphs = graphs.GraphCache(capture=Captures())
    var = torch.tensor(x, dtype=dtype)
    eager, captured, replayed = (post.value_and_grad(var) for _ in range(3))
    assert len(post._graphs.capture.made) == 1
    for out in (captured, replayed):
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
    g = eager[1].double().numpy()
    num = np.linalg.norm((g - g_ref) * scale, axis=1)
    den = np.maximum(np.linalg.norm(g_ref * scale, axis=1),
                     np.sqrt(x.shape[1]))
    assert np.all(num / den <= GRAD_TOL[dtype]), num / den


def test_a_forward_call_copies_nothing_from_numpy(gp_posterior, monkeypatch):
    _, post, var = gp_posterior
    made = []
    real = torch.as_tensor

    def as_tensor(data, *a, **k):
        if isinstance(data, np.ndarray):
            made.append(data.shape)
        return real(data, *a, **k)

    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    post(var), post.parts(var), post.ln_prior(var), post.ln_like(var)
    assert made == []


# ---- the resident tables --------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_resident_tables_are_the_copies(dtype):
    model, _, var = _posterior()
    t = model.tensors(dtype, "cpu")
    assert t is model.tensors(dtype, torch.device("cpu"))
    for got, want, dt in ((t.full_start, model.full_start, dtype),
                          (t.var_idx, model.var_idx, torch.int64),
                          (t.cv_idx, model.cv_idx, torch.int64),
                          (t.cv_const, model.cv_const, dtype),
                          (t.prior.codes, model.prior_table.codes,
                           torch.int64),
                          (t.prior.p1, model.prior_table.p1, dtype),
                          (t.prior.p2, model.prior_table.p2, dtype)):
        assert got.dtype == dt and torch.equal(
            got, torch.as_tensor(want, dtype=dt))
    v = var.to(dtype)
    full = model.full_from_var(v)
    assert np.array_equal(full.numpy(), model.full_from_var(
        v.numpy()).astype(full.numpy().dtype))
    assert torch.equal(ln_prior_table(full, t.prior),
                       ln_prior_table(full, model.prior_table))
    # the per-call copies the resident maps replace
    idx = torch.as_tensor(model.cv_idx, dtype=torch.int64)
    const = torch.as_tensor(model.cv_const, dtype=dtype)
    want = torch.where(idx >= 0, full[..., idx.clamp(min=0)], const)
    assert torch.equal(model.cv_params(full), want)


def test_the_resident_tables_can_take_a_gradient():
    model, _, var = _posterior()
    with torch.inference_mode():
        model.tensors(torch.float64, "cpu")
    v = var.clone().requires_grad_()
    full = model.full_from_var(v)
    lp = ln_prior_table(full, model.tensors(torch.float64, "cpu").prior)
    (g,) = torch.autograd.grad((lp.sum() + model.cv_params(full).sum()), v)
    assert bool(torch.isfinite(g).all())
    assert isinstance(prior_tensors(model.prior_table, torch.float64, "cpu"),
                      PriorTensors)


# ---- the benchmark's reader of the replays --------------------------------

def _replays(trace):
    return bench._load(READER).read(layers.Context(
        {}, {}, trace=trace, trace_rows=[8, 8]))


def test_the_reader_counts_replays_inside_posterior_calls():
    host = [(POSTERIOR, 0, 100), (tracing.REPLAY, 10, 90),
            (POSTERIOR, 200, 300), (tracing.REPLAY, 210, 290),
            (tracing.REPLAY, 400, 450)]
    assert _replays(Trace((0, 500), [], host)) == 1.0
    assert _replays(Trace((0, 500), [], host[:3])) == 0.5


def test_the_reader_reads_nothing_without_a_replay():
    host = [(POSTERIOR, 0, 100), (tracing.PARAMS, 10, 20)]
    assert _replays(Trace((0, 500), [], host)) is None
    assert bench._load(READER).read(layers.Context({}, {})) is None
