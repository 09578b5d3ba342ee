"""The port's host surface against the JAX package, on the CPU: profiling
hooks, notifications, chain rebinning and ArviZ output, the native chain
writer, corner plots, the reference-API chain and tree helpers, and the
white-dwarf atmosphere fit.

Tolerances: the numpy parts (``rebin``, ``to_arviz``, the synthetic DA
grid, the extinction law, the mass-radius relation, the grid reader)
equal the JAX package's arrays bit for bit; ``GridInterpolator`` and the
wdparams ln p on 64 vectors agree with the JAX package's within 1e-12
relative in float64; the native chain writer writes the numpy writer's
bytes.  A wdparams run at 32 walkers recovers its synthetic truth within
3 sigma and writes the JAX package's keys.
"""

import json
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.post import wdparams as jwd
from lfit_python_tpu.utils import chains as jchains
from lfit_python_tpu.utils import notify as jnotify
from lfit_python_tpu_torch import native
from lfit_python_tpu_torch.post import wdparams as twd
from lfit_python_tpu_torch.utils import chains, tracing
from lfit_python_tpu_torch.utils.notify import notify


# ---- profiling hooks ---------------------------------------------------

def _trace_names(path):
    return {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}


def test_trace_to_writes_a_chrome_trace_on_the_cpu(tmp_path, capsys):
    with tracing.trace_to(tmp_path / "trace") as trace:
        with tracing.annotate("matmul_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = trace.path
    assert trace.closed and path.parent == tmp_path / "trace" and path.is_file()
    assert f"trace written to {path}" in capsys.readouterr().out
    names = _trace_names(path)
    assert "matmul_span" in names and "aten::mm" in names


def test_trace_to_records_only_its_first_steps(tmp_path, capsys):
    with tracing.trace_to(tmp_path / "trace", steps=2) as trace:
        for i in range(4):
            with tracing.annotate(f"step_{i}"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            assert trace.closed == (i >= 2)
            trace.step()
    assert trace.done == 4
    assert capsys.readouterr().out.count("trace written to") == 1
    names = _trace_names(trace.path)
    assert {"step_0", "step_1"} <= names
    assert not {"step_2", "step_3"} & names


# ---- notifications -----------------------------------------------------

def test_notify_channels_match_the_jax_module(tmp_path):
    for fn, tag in ((jnotify.notify, "jax"), (notify, "port")):
        got = tmp_path / f"{tag}_cmd.txt"
        log = tmp_path / f"{tag}.jsonl"
        ok = fn("subject", "body", cmd=f"cat > {got}", file=log)
        assert ok == ["cmd", "file"]
        assert got.read_text() == "subject\nbody"
        rec = json.loads(log.read_text())
        assert (rec["subject"], rec["body"]) == ("subject", "body")


def test_notify_swallows_failures(tmp_path):
    # a failing command, an unwritable file, no mail transfer agent
    bad = tmp_path / "no_such_dir" / "n.jsonl"
    args = dict(cmd="exit 3", file=bad, email="nobody@localhost")
    assert notify("s", "b", **args) == jnotify.notify("s", "b", **args) == []


# ---- chains: rebin, ArviZ form, the native writer ----------------------

def test_rebin_equals_the_jax_rebin():
    rng = np.random.default_rng(3)
    ph, fl = np.sort(rng.uniform(-0.1, 0.1, 101)), rng.normal(1, 0.1, 101)
    er = rng.uniform(0.01, 0.05, 101)
    for factor in (1, 2, 3, 7):
        for a, b in zip(chains.rebin(ph, fl, er, factor),
                        jchains.rebin(ph, fl, er, factor)):
            np.testing.assert_array_equal(a, b)


def test_rebin_inverse_variance():
    p2, f2, e2 = chains.rebin(np.arange(10.0), np.ones(10), np.full(10, 0.2),
                              2)
    assert p2.shape == (5,)
    np.testing.assert_allclose(f2, 1.0)
    np.testing.assert_allclose(e2, 0.2 / np.sqrt(2))


def test_to_arviz_equals_the_jax_to_arviz():
    rng = np.random.default_rng(4)
    chain, lp = rng.standard_normal((20, 8, 3)), rng.standard_normal((20, 8))
    for log_prob in (None, lp):
        got = chains.to_arviz(chain, ["a", "b", "c"], log_prob)
        want = jchains.to_arviz(chain, ["a", "b", "c"], log_prob)
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        assert got["a"].shape == (8, 20)


def test_save_arviz_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    chain, lp = rng.standard_normal((20, 8, 2)), rng.standard_normal((20, 8))
    path = chains.save_arviz(chain, ["a", "b"], tmp_path / "chains",
                             log_prob=lp)
    assert path == tmp_path / "chains.npz"     # arviz is not installed
    jpath = jchains.save_arviz(chain, ["a", "b"], tmp_path / "jax",
                               log_prob=lp)
    with np.load(path) as z, np.load(jpath) as zj:
        assert set(z.files) == set(zj.files) == {"a", "b", "ln_prob"}
        for k in z.files:
            np.testing.assert_array_equal(z[k], zj[k])
        np.testing.assert_array_equal(z["a"], chain[:, :, 0].T)
        np.testing.assert_array_equal(z["ln_prob"], lp.T)


def test_native_writer_writes_the_numpy_bytes(tmp_path):
    rng = np.random.default_rng(5)
    chain, lp = rng.standard_normal((5, 8, 4)), rng.standard_normal((5, 8))
    lp[0, 3] = -np.inf
    paths = {}
    for use_native in (False, True):
        paths[use_native] = tmp_path / f"{use_native}.txt"
        with chains.ChainWriter(paths[use_native], list("abcd"),
                                use_native=use_native) as w:
            w.append(chain[:2], lp[:2])
            w.append(chain[2:], lp[2:])
    assert paths[True].read_bytes() == paths[False].read_bytes()
    # and the JAX package's numpy writer's
    with jchains.ChainWriter(tmp_path / "jax.txt", list("abcd"),
                             use_native=False) as w:
        w.append(chain[:2], lp[:2])
        w.append(chain[2:], lp[2:])
    assert (tmp_path / "jax.txt").read_bytes() == paths[True].read_bytes()
    rows = native.chain_read_rows(paths[True], 6)
    c, l, _ = chains.read_chain(paths[False])
    np.testing.assert_array_equal(rows[:, 1:-1].reshape(5, 8, 4), c)
    np.testing.assert_array_equal(rows[:, -1].reshape(5, 8), l)


def test_native_resumed_file_appends(tmp_path):
    rng = np.random.default_rng(6)
    chain, lp = rng.standard_normal((4, 3, 2)), rng.standard_normal((4, 3))
    p = tmp_path / "c.txt"
    with chains.ChainWriter(p, ["a", "b"], use_native=True) as w:
        w.append(chain[:2], lp[:2])
    with chains.ChainWriter(p, ["a", "b"], append=True,
                            use_native=True) as w:
        w.append(chain[2:], lp[2:])
    c, l, names = chains.read_chain(p)
    assert names == ["a", "b"]
    np.testing.assert_allclose(c, chain, rtol=1e-10)
    np.testing.assert_allclose(l, lp, rtol=1e-10)


def test_native_write_speed(tmp_path):
    """The native writer beats numpy's: each timed as the least of 5
    repeats, the two interleaved, so that a stall of the machine in one
    run (other tests share its cores) decides nothing."""
    rows = np.random.default_rng(0).standard_normal((20000, 32))
    rows[:, 0] = np.arange(20000) % 64
    native.load()

    def write_native():
        native.chain_write(tmp_path / "big.txt", rows)

    def write_numpy():
        with (tmp_path / "big_np.txt").open("w") as fh:
            np.savetxt(fh, rows, fmt=["%d"] + ["%.10e"] * 31)

    times = {write_native: [], write_numpy: []}
    for _ in range(5):
        for fn, ts in times.items():
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    t_nat, t_np = min(times[write_native]), min(times[write_numpy])
    assert t_nat < t_np


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent degradation: the writer that was asked for native rows
    raises with the compiler's message."""
    bad = tmp_path / "chainio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with chains.ChainWriter(tmp_path / "c.txt", ["a"],
                            use_native=True) as w:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed for "
                                               "chainio.cpp"):
            w.append(np.zeros((1, 2, 1)), np.zeros((1, 2)))


# ---- corner plots (tests/test_plotting.py) -----------------------------

class TestCornerPlot:
    def test_no_truncation_no_warning(self, tmp_path):
        from lfit_python_tpu_torch.utils.plotting import corner_plot

        flat = np.random.default_rng(0).standard_normal((50, 3))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            corner_plot(flat, ["a", "b", "c"], tmp_path / "c.png")
        assert (tmp_path / "c.png").exists()

    def test_truncation_warns_and_annotates(self, tmp_path):
        from lfit_python_tpu_torch.utils.plotting import corner_plot

        flat = np.random.default_rng(0).standard_normal((50, 15))
        with pytest.warns(UserWarning, match=r"12/15"):
            corner_plot(flat, [f"p{i}" for i in range(15)],
                        tmp_path / "c.png")
        assert (tmp_path / "c.png").exists()

    def test_max_params_raised_covers_node(self, tmp_path):
        from lfit_python_tpu_torch.utils.plotting import corner_plot

        flat = np.random.default_rng(0).standard_normal((30, 15))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            corner_plot(flat, [f"p{i}" for i in range(15)],
                        tmp_path / "c.png", max_params=19)

    def test_var_groups_cover_every_param(self):
        from lfit_python_tpu_torch.examples import build_model

        model = build_model(n_eclipses=10, complex_spot=True, use_gp=True,
                            n_points=8, bands=("g", "r")).compile()
        groups = model.var_groups()
        covered = sorted(i for _, idx in groups for i in idx)
        assert covered == list(range(model.n_var))
        assert model.n_var > 12
        assert max(len(idx) for _, idx in groups) <= 19


# ---- compat: chains and tree (tests/test_compat.py) --------------------

def test_compat_readchain_and_flat(tmp_path):
    from lfit_python_tpu_torch.compat import (flatchain, readchain,
                                              readflatchain, rebin)

    rng = np.random.default_rng(0)
    ch, lp = rng.standard_normal((6, 4, 2)), rng.standard_normal((6, 4))
    with chains.ChainWriter(tmp_path / "c.txt", ["a", "b"]) as w:
        w.append(ch, lp)
    chain, _, names = readchain(tmp_path / "c.txt")
    assert names == ["a", "b"]
    flat, names2 = readflatchain(tmp_path / "c.txt", discard=2)
    assert flat.shape == (16, 2) and names2 == names
    np.testing.assert_allclose(flat, flatchain(chain, 2), rtol=1e-9)
    assert rebin is chains.rebin


def test_compat_thumbplot_and_dynasty(tmp_path):
    from lfit_python_tpu_torch.compat import (dynasty_par_names,
                                              dynasty_par_vals, thumbPlot)
    from lfit_python_tpu_torch.examples import build_model

    m = build_model(n_eclipses=1, n_points=8).compile()
    vals, names = dynasty_par_vals(m), dynasty_par_names(m)
    assert len(vals) == len(names) == m.n_var
    assert names[0] == "q_core"
    flat = np.random.default_rng(2).standard_normal((40, 3))
    assert thumbPlot(flat, ["a", "b", "c"], tmp_path / "t.png") == \
        tmp_path / "t.png"


# ---- wdparams ------------------------------------------------------------

LAMS = [3561.0, 4770.0, 6231.0, 7625.0, 9134.0]


def test_wd_numpy_parts_equal_the_jax_bits():
    np.testing.assert_array_equal(twd.nauenberg_radius(np.linspace(
        0.2, 1.3, 12)), jwd.nauenberg_radius(np.linspace(0.2, 1.3, 12)))
    loggs = np.linspace(6.5, 9.5, 31)
    for a, b in zip(twd.mass_radius_from_logg(loggs),
                    jwd.mass_radius_from_logg(loggs)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(twd.synthetic_da_grid(LAMS), jwd.synthetic_da_grid(LAMS)):
        np.testing.assert_array_equal(a, b)
    lams = LAMS + [12500.0, 22000.0]
    np.testing.assert_array_equal(twd.extinction_coefficients(lams),
                                  jwd.extinction_coefficients(lams))


def _vectors(n=64, seed=11, ebv=False):
    rng = np.random.default_rng(seed)
    v = np.column_stack([rng.uniform(5000, 95000, n),
                         rng.uniform(6.0, 10.0, n),
                         rng.uniform(1.0, 9.0, n)])
    if ebv:
        v = np.column_stack([v, rng.uniform(-0.1, 0.6, n)])
    return v


def test_grid_interpolator_matches_the_jax_one():
    """64 vectors inside and beyond the grid's edges (the clamps)."""
    grid = twd.synthetic_da_grid(LAMS)
    ours = twd.GridInterpolator(*grid)
    theirs = jwd.GridInterpolator(*grid)
    v = _vectors()
    got = ours(torch.tensor(v[:, 0]), torch.tensor(v[:, 1])).numpy()
    want = np.asarray(jax.vmap(theirs)(jnp.asarray(v[:, 0]),
                                       jnp.asarray(v[:, 1])))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _grid_file(path, hash_header=True):
    """tests/test_io.py's Bergeron-format fixture: mags bilinear in
    (Teff, logg), with an extra Mass column."""
    lines = [("# " if hash_header else "") + "Teff logg Mass g r"]
    for t in (10000.0, 15000.0, 20000.0, 30000.0):
        for g in (7.5, 8.0, 8.5):
            lines.append(f"{t:.1f} {g:.2f} 0.6 {10.0 + t / 1e4 + 2.0 * g:.6f}"
                         f" {11.0 - t / 2e4 + 1.5 * g:.6f}")
    path.write_text("\n".join(lines) + "\n")


def test_grid_from_file_matches_the_jax_reader(tmp_path):
    for hash_header in (True, False):
        p = tmp_path / f"grid_{hash_header}.txt"
        _grid_file(p, hash_header)
        ours = twd.GridInterpolator.from_file(p, ["g", "r"])
        theirs = jwd.GridInterpolator.from_file(p, ["g", "r"])
        for name in ("teffs", "loggs", "mags"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name))
        assert ours.source == theirs.source == str(p)
        mid = ours(torch.tensor([12500.0], dtype=torch.float64),
                   torch.tensor([7.75], dtype=torch.float64))[0].numpy()
        np.testing.assert_allclose(mid, [10.0 + 1.25 + 15.5,
                                         11.0 - 0.625 + 11.625], rtol=1e-12)
    _grid_file(tmp_path / "ragged.txt")
    lines = (tmp_path / "ragged.txt").read_text().splitlines()
    (tmp_path / "ragged.txt").write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError, match="rectangular"):
        twd.GridInterpolator.from_file(tmp_path / "ragged.txt", ["g", "r"])
    with pytest.raises(ValueError, match="missing column 'z'"):
        twd.GridInterpolator.from_file(tmp_path / "grid_True.txt",
                                       ["g", "z"])


def _wd_input(path, ebv=False):
    lines = ["teff = 15000 uniform 6000 90000 1",
             "logg = 8.0 uniform 6.5 9.5 1",
             "plax = 5.0 gauss 5.0 0.5 1"]
    if ebv:
        lines.append("ebv = 0.05 uniform 0.0 0.5 1")
    lines += [f"flux_b{i} = {0.4 - 0.05 * i:.4f} {0.004:.4f} {lam}"
              for i, lam in enumerate(LAMS)]
    path.write_text("\n".join(lines) + "\n")
    return path


def _jax_ln_prob(inp, monkeypatch):
    """The JAX package's wdparams ln_prob closure for the input ``inp``,
    caught where run_wdparams hands it to the sampler."""
    from types import SimpleNamespace

    from lfit_python_tpu.sampling import ensemble as jens

    caught = {}

    class Caught(Exception):
        pass

    def catch(key, start, scatter, ln_prob, n_walkers):
        caught["fn"] = ln_prob
        raise Caught

    monkeypatch.setattr(jens, "init_walkers", catch)
    args = SimpleNamespace(input=str(inp), outdir=str(inp.parent / "jout"),
                           grid=None, seed=0, nburn=1, nprod=1, nwalkers=4)
    with pytest.raises(Caught):
        jwd.run_wdparams(args)
    return caught["fn"]


@pytest.mark.parametrize("ebv", [False, True])
def test_wd_ln_prob_matches_the_jax_one(ebv, tmp_path, monkeypatch):
    inp = _wd_input(tmp_path / "wd.dat", ebv)
    want = np.asarray(jax.vmap(_jax_ln_prob(inp, monkeypatch))(
        jnp.asarray(_vectors(ebv=ebv))))
    parsed = twd.read_wd_input(inp)
    interp = twd.GridInterpolator(*twd.synthetic_da_grid(parsed.lams))
    fn = twd.make_wd_ln_prob(parsed, interp, torch.float64, "cpu")
    got = fn(torch.tensor(_vectors(ebv=ebv))).numpy()
    assert np.isfinite(want).sum() > 16
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0)


def test_wdparams_recovers_a_synthetic_truth(tmp_path, capsys):
    from lfit_python_tpu_torch import cli

    truth = {"teff": 15000.0, "logg": 8.0, "plax": 5.0}
    interp = twd.GridInterpolator(*twd.synthetic_da_grid(LAMS))
    mags = interp(torch.tensor([truth["teff"]], dtype=torch.float64),
                  torch.tensor([truth["logg"]], dtype=torch.float64))[0]
    flux = 3631e3 * 10 ** (-0.4 * (mags.numpy() + 5 * np.log10(200.0 / 10)))
    inp = tmp_path / "wd.dat"
    inp.write_text("teff = 15000 uniform 6000 90000 1\n"
                   "logg = 8.0 uniform 6.5 9.5 1\n"
                   "plax = 5.0 gauss 5.0 0.5 1\n"
                   + "".join(f"flux_b{i} = {f:.8e} {0.01 * f:.8e} {lam}\n"
                             for i, (f, lam) in enumerate(zip(flux, LAMS))))
    rc = cli.main(["wdparams", str(inp), "--outdir", str(tmp_path / "out"),
                   "--device", "cpu", "--nwalkers", "32", "--nburn", "200",
                   "--nprod", "400"])
    assert rc == 0
    assert "synthetic (blackbody+Nauenberg) DA grid" in capsys.readouterr().out
    report = json.loads((tmp_path / "out" / "wdparams.json").read_text())
    assert set(report) == {"grid", "params", "best", "derived",
                           "mean_acceptance"}
    assert report["grid"] == "synthetic-blackbody"
    assert set(report["derived"]) == {"mass_msun", "radius_rsun",
                                      "distance_pc"}
    for row in report["params"]:
        t = truth[row["name"]]
        sigma = row["upper"] if t > row["median"] else row["lower"]
        assert abs(row["median"] - t) <= 3 * sigma, row
    assert 0.1 < report["mean_acceptance"] < 0.9
    assert (tmp_path / "out" / "wd_corner.png").exists()

