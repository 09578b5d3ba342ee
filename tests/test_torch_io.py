"""The port's host IO against the JAX package (CPU): the input-file
reader and the model it builds, the light-curve loaders, chain files read
both ways, the convergence diagnostics, and the port's checkpoints.

The compiled model from an input file must equal the JAX package's
exactly (every layout array, index map, prior table entry and padded data
point, with its dtype), chain files agree to 1e-10 relative (the format
keeps 11 significant digits), the diagnostics exactly (the same numpy
arithmetic), and a run split at a checkpoint equals the uninterrupted run
bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import tree as jtree
from lfit_python_tpu.sampling.ensemble import EnsembleState as JState
from lfit_python_tpu.utils import chains as jchains
from lfit_python_tpu.utils import checkpoints as jck
from lfit_python_tpu.utils import config as jcfg
from lfit_python_tpu_torch.models import tree as ttree
from lfit_python_tpu_torch.sampling import ensemble as ens
from lfit_python_tpu_torch.sampling import hmc, pt
from lfit_python_tpu_torch.utils import chains, checkpoints, config

DEMO = Path(__file__).resolve().parent.parent / "examples/demo_input.dat"

LAYOUT = ("full_start", "var_idx", "var_pos", "scatter", "cv_idx",
          "cv_const", "gp_idx", "gp_mask", "data_phase", "data_flux",
          "data_err", "data_width", "data_mask", "plot_mask")


def assert_same_model(tm, jm):
    for name in LAYOUT:
        a, b = getattr(tm, name), getattr(jm, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("codes", "p1", "p2"):
        a, b = getattr(tm.prior_table, name), getattr(jm.prior_table, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tm.param_names == jm.param_names
    assert tm.param_labels == jm.param_labels
    assert tm.var_names() == jm.var_names()
    assert tm.var_groups() == jm.var_groups()
    assert (tm.any_complex, tm.any_gp) == (jm.any_complex, jm.any_gp)
    assert tm.n_var == jm.n_var and tm.n_eclipses == jm.n_eclipses
    np.testing.assert_array_equal(tm.var_start(), jm.var_start())
    np.testing.assert_array_equal(tm.var_scatter(), jm.var_scatter())


# ---- input files ----------------------------------------------------------

# every prior family, complex and GP eclipses, two bands, plot / trim /
# calib flags, a .calib file and a global ephemeris
PRIORS = {
    "q": "0.16 gauss 0.16 0.02 1", "dphi": "0.041 uniform 0.01 0.2 1",
    "rwd": "0.011 log_uniform 0.0005 0.1 1",
    "wdFlux": "0.11 gaussPos 0.1 0.05 1", "rsFlux": "0.028 uniform 0 1 1",
    "ulimb": "0.3 gauss 0.3 0.05 0", "dFlux": "0.045 mod_jeff 0.001 1 1",
    "sFlux": "0.085 uniform 0 1 1", "rdisc": "0.42 uniform 0.2 0.9 1",
    "scale": "0.022 log_uniform 1e-4 0.5 1", "az": "157 uniform 50 175 1",
    "fis": "0.22 uniform 0 1 1", "dexp": "1.4 uniform 0 3 1",
    "phi0": "0.001 uniform -0.05 0.05 1", "exp1": "2.0 uniform 0 5 1",
    "exp2": "1.0 uniform 0 5 0", "tilt": "90 uniform 0 180 1",
    "yaw": "1.0 uniform -90 90 1", "ln_ampin_gp": "-6 uniform -20 0 1",
    "ln_ampout_gp": "-7 uniform -20 0 1", "ln_tau_gp": "-4 uniform -10 0 1",
}
T0, PERIOD = 55000.25, 0.0625


def write_curves(d, rng):
    ph = np.linspace(-0.15, 0.15, 41)
    flux = 0.2 + 0.01 * rng.standard_normal(ph.size)
    err = np.full(ph.size, 0.003)
    np.savetxt(d / "ecl0.txt", np.c_[ph, flux, err])
    np.savetxt(d / "ecl1.txt", np.c_[ph, flux, err, np.full(ph.size, 0.002)])
    # time-domain calibrated photometry, two cycles on, out of order
    times = T0 + PERIOD * (ph + 2.0)
    order = rng.permutation(ph.size)
    np.savetxt(d / "ecl2.dat", np.c_[times, flux, err][order])
    np.savetxt(d / "ecl3.calib", np.c_[times + PERIOD, flux, err][order])


def rich_input(d, drop=()):
    lines = ["nwalkers = 16", "nburn = 5", "nprod = 7", "neclipses = 4",
             "complex = 0", "useGP = 0", "comp_scat = 1", "thin = 2",
             "scatter_1 = 0.003", "double_burnin = 1", f"t0 = {T0}",
             f"period = {PERIOD}", "file_0 = ecl0.txt", "band_0 = g",
             "trim_0 = -0.1 0.12", "plot_0 = 1", "file_1 = ecl1.txt",
             "band_1 = r", "complex_1 = 1", "plot_1 = 0",
             "file_2 = ecl2.dat", "calib_2 = 1", "useGP_2 = 1",
             "file_3 = ecl3.calib", "trim_3 = -0.12 0.1",
             "# a comment line", "custom_key = some value  # trailing"]
    for n in ("q", "dphi", "rwd"):
        lines.append(f"{n}_core = {PRIORS[n]}")
    for band in ("g", "r"):
        for n in ("wdFlux", "rsFlux", "ulimb"):
            lines.append(f"{n}_{band} = {PRIORS[n]}")
    for k, names in enumerate((
            ttree.ECLIPSE_NAMES,
            ttree.ECLIPSE_NAMES + ttree.ECLIPSE_COMPLEX_NAMES,
            ttree.ECLIPSE_NAMES + ttree.GP_NAMES, ttree.ECLIPSE_NAMES)):
        for n in names:
            lines.append(f"{n}_{k} = {PRIORS[n]}")
    lines = [ln for ln in lines if ln.split(" = ")[0] not in drop]
    path = d / "input.dat"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def rich_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("rich")
    write_curves(d, np.random.default_rng(4))
    return d


class TestConfig:
    @pytest.mark.parametrize("which", ["demo", "rich"])
    def test_model_equals_the_jax_package(self, which, rich_dir):
        path = DEMO if which == "demo" else rich_input(rich_dir)
        tc, jc = config.parse_input_dat(path), jcfg.parse_input_dat(path)
        for name in ("meta", "files", "bands", "complex_flags", "gp_flags",
                     "plot_flags", "calib_flags", "trims"):
            assert getattr(tc, name) == getattr(jc, name), name
        assert tc.n_eclipses == jc.n_eclipses
        for key, p in tc.params.items():
            q = jc.params[key]
            assert (p.name, p.start, p.is_var, p.scatter) == (
                q.name, q.start, q.is_var, q.scatter)
            assert (p.prior.type, p.prior.p1, p.prior.p2) == (
                q.prior.type, q.prior.p1, q.prior.p2)
        assert tc.params.keys() == jc.params.keys()
        tm = config.build_model_from_config(tc).compile()
        jm = jcfg.build_model_from_config(jc).compile()
        assert_same_model(tm, jm)
        if which == "rich":
            assert tm.any_complex and tm.any_gp
            assert tm.plot_mask.tolist() == [True, False, True, True]
            assert tm.param_labels.count("r") == 3
            assert [g[0] for g in tm.var_groups()] == [
                "core", "g", "r", "ecl0", "ecl1", "ecl2", "ecl3"]

    @pytest.mark.parametrize("drop", ["dexp_2", "ulimb_r", "q_core",
                                      "file_3", "yaw_1", "ln_tau_gp_2"])
    def test_missing_keys_give_the_same_error(self, drop, tmp_path):
        write_curves(tmp_path, np.random.default_rng(4))
        path = rich_input(tmp_path, drop=(drop,))
        with pytest.raises(KeyError) as jerr:
            jcfg.build_model_from_config(jcfg.parse_input_dat(path))
        with pytest.raises(KeyError) as terr:
            config.build_model_from_config(config.parse_input_dat(path))
        assert str(terr.value) == str(jerr.value)
        assert drop in str(terr.value)

    def test_unparsable_line(self, tmp_path):
        path = tmp_path / "bad.dat"
        path.write_text("nwalkers = 8\nthis line has no equals sign\n")
        with pytest.raises(ValueError, match="cannot parse line"):
            config.parse_input_dat(path)
        with pytest.raises(ValueError, match="cannot parse line"):
            jcfg.parse_input_dat(path)

    def test_data_dir(self, rich_dir, tmp_path):
        path = tmp_path / "elsewhere.dat"
        path.write_text(rich_input(rich_dir).read_text())
        with pytest.raises(OSError):
            config.build_model_from_config(config.parse_input_dat(path))
        tm = config.build_model_from_config(
            config.parse_input_dat(path), data_dir=rich_dir).compile()
        jm = jcfg.build_model_from_config(
            jcfg.parse_input_dat(path), data_dir=rich_dir).compile()
        assert_same_model(tm, jm)


# ---- light-curve loaders ---------------------------------------------------

def assert_same_curve(t, j):
    for name in ("phase", "flux", "err"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.width is None) == (j.width is None)
    if t.width is not None:
        np.testing.assert_array_equal(t.width, j.width)
    assert t.name == j.name


class TestLoaders:
    @pytest.mark.parametrize("fname,trim", [
        ("ecl0.txt", None), ("ecl0.txt", (-0.1, 0.12)),
        ("ecl1.txt", None), ("ecl1.txt", (-0.05, 0.05))])
    def test_from_file(self, rich_dir, fname, trim):
        t = ttree.Lightcurve.from_file(rich_dir / fname, "x", trim)
        j = jtree.Lightcurve.from_file(rich_dir / fname, "x", trim)
        assert_same_curve(t, j)
        assert (t.width is None) == (fname == "ecl0.txt")

    @pytest.mark.parametrize("fname,trim,ephem", [
        ("ecl0.txt", None, False), ("ecl2.dat", None, True),
        ("ecl3.calib", (-0.12, 0.1), True), ("ecl2.dat", None, False)])
    def test_from_calib(self, rich_dir, fname, trim, ephem):
        kw = dict(t0=T0, period=PERIOD) if ephem else {}
        t = ttree.Lightcurve.from_calib(rich_dir / fname, None, trim, **kw)
        j = jtree.Lightcurve.from_calib(rich_dir / fname, None, trim, **kw)
        assert_same_curve(t, j)
        if ephem:
            assert np.all(np.diff(t.phase) >= 0)
            assert np.all((t.phase >= -0.5) & (t.phase < 0.5))

    def test_loader_errors(self, tmp_path):
        one = tmp_path / "one.calib"
        np.savetxt(one, [[0.01, 0.2, 0.003]])
        assert_same_curve(ttree.Lightcurve.from_calib(one),
                          jtree.Lightcurve.from_calib(one))
        assert ttree.Lightcurve.from_calib(one).width is None
        two = tmp_path / "two.txt"
        np.savetxt(two, np.ones((4, 2)))
        for cls in (ttree.Lightcurve, jtree.Lightcurve):
            with pytest.raises(ValueError, match=">=3 columns"):
                cls.from_file(two)
            with pytest.raises(ValueError, match=">=3 columns"):
                cls.from_calib(two)
            with pytest.raises(ValueError, match="both t0 and period"):
                cls.from_calib(one, t0=1.0)

    def test_trimmed(self, rich_dir):
        t = ttree.Lightcurve.from_file(rich_dir / "ecl1.txt")
        j = jtree.Lightcurve.from_file(rich_dir / "ecl1.txt")
        assert t.trimmed(None) is t
        assert_same_curve(t.trimmed((-0.07, 0.02)), j.trimmed((-0.07, 0.02)))
        assert len(t.trimmed((-0.07, 0.02))) < len(t)


# ---- chain files and diagnostics ------------------------------------------

NAMES = ["q_core", "dphi_core", "az_ecl0"]


def random_chain(seed=0, n=24, w=6):
    rng = np.random.default_rng(seed)
    chain = np.cumsum(rng.standard_normal((n, w, 3)), axis=0) * [
        0.01, 1e-4, 3.0] + [0.16, 0.041, 157.0]
    return chain, -0.5 * (chain ** 2).sum(-1) - 800.0


class TestChains:
    def test_port_file_read_by_jax(self, tmp_path):
        chain, lp = random_chain()
        path = tmp_path / "chain_prod.txt"
        with chains.ChainWriter(path, NAMES) as w:
            w.append(chain[:5], lp[:5])
            w.append(chain[5:], lp[5:])
        with chains.ChainWriter(path, NAMES, append=True) as w:
            w.append(chain[-1], lp[-1])        # one (W, D) step
        jc, jlp, names = jchains.read_chain(path)
        assert names == NAMES
        np.testing.assert_allclose(jc, np.concatenate([chain, chain[-1:]]),
                                   rtol=1e-10, atol=0)
        np.testing.assert_allclose(jlp, np.concatenate([lp, lp[-1:]]),
                                   rtol=1e-10, atol=0)

    def test_jax_file_read_by_port(self, tmp_path):
        chain, lp = random_chain(1)
        path = tmp_path / "chain_prod.txt"
        w = jchains.ChainWriter(path, NAMES)
        w.append(chain, lp)
        w.close()
        tc, tlp, names = chains.read_chain(path)
        jc, jlp, _ = jchains.read_chain(path)
        assert names == NAMES
        np.testing.assert_allclose(tc, chain, rtol=1e-10, atol=0)
        np.testing.assert_allclose(tlp, lp, rtol=1e-10, atol=0)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tlp, jlp)

    def test_writer_refuses_another_header(self, tmp_path):
        path = tmp_path / "chain_prod.txt"
        chains.ChainWriter(path, NAMES).close()
        with pytest.raises(ValueError, match="different parameter header"):
            chains.ChainWriter(path, NAMES[:2], append=True)
        chains.ChainWriter(path, NAMES[:2]).close()    # a new run rewrites
        assert path.read_text().split()[1:-1] == ["walker"] + NAMES[:2]
        (tmp_path / "x.txt").write_text("1 2 3\n")
        with pytest.raises(ValueError, match="not a chain file"):
            chains.read_chain(tmp_path / "x.txt")

    def test_diagnostics_equal_the_jax_package(self):
        chain, _ = random_chain(2, n=64, w=12)
        for d in (0, 16):
            np.testing.assert_array_equal(
                chains.gelman_rubin(chain, discard=d),
                jchains.gelman_rubin(chain, discard=d))
            assert chains.summarize(chain, NAMES, discard=d) == \
                jchains.summarize(chain, NAMES, discard=d)
        for block in (256, 5):
            np.testing.assert_array_equal(
                chains.autocorr_time(chain, walker_block=block),
                jchains.autocorr_time(chain, walker_block=block))
        np.testing.assert_array_equal(chains.flatchain(chain, 3, 2),
                                      jchains.flatchain(chain, 3, 2))


# ---- checkpoints -----------------------------------------------------------

def gauss_ln_prob(x):
    return -0.5 * (x * x).sum(dim=-1)


def gauss_state(dtype=torch.float64, seed=5):
    gen = torch.Generator().manual_seed(seed)
    start = torch.linspace(-1.0, 1.0, 4, dtype=dtype)
    state = ens.init_walkers(gen, start, torch.full_like(start, 0.5),
                             gauss_ln_prob, 10)
    return state, gen


def sampler_state(kind, dtype=torch.float64):
    """A state of ``kind`` one step past its start, and its generator."""
    if kind == "ensemble":
        state, gen = gauss_state(dtype)
        return ens.ensemble_step(state, gauss_ln_prob, gen)[0], gen
    gen = torch.Generator().manual_seed(6)
    start = torch.linspace(-1.0, 1.0, 4, dtype=dtype)
    scatter = torch.full_like(start, 0.5)
    if kind == "pt":
        state = pt.init_pt(gen, start, scatter, lambda x: torch.zeros(
            x.shape[0], dtype=dtype), gauss_ln_prob, 6, 3)
        return pt.pt_step(state, lambda x: torch.zeros(
            x.shape[0], dtype=dtype), gauss_ln_prob, gen)[0], gen
    state = hmc.init_hmc(gen, start, scatter, gauss_ln_prob, 5)
    return hmc.hmc_step(state, gauss_ln_prob, gen, n_leapfrog=3)[0], gen


class TestCheckpoints:
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_round_trip_is_bit_for_bit(self, tmp_path, dtype):
        state, gen = gauss_state(dtype)
        state, _ = ens.ensemble_step(state, gauss_ln_prob, gen)
        path = checkpoints.save_checkpoint(
            tmp_path / "checkpoint_0000001.npz", state, gen,
            {"input": "x.dat", "stage": "prod"})
        back, gen2, meta = checkpoints.load_checkpoint(path, "cpu")
        assert torch.equal(back.positions, state.positions)
        assert torch.equal(back.log_prob, state.log_prob)
        assert back.positions.dtype == dtype and back.step == 1
        assert torch.equal(gen2.get_state(), gen.get_state())
        assert meta == {"input": "x.dat", "stage": "prod"}
        with np.load(path) as z:
            assert str(z["kind"]) == "ensemble" and "key" not in z

    def test_split_run_equals_uninterrupted(self, tmp_path):
        state, gen = gauss_state()
        whole = ens.run_chunked(state, lambda s: ens.ensemble_step(
            s, gauss_ln_prob, gen), 7, thin=2, chunk_size=2)
        state, gen = gauss_state()
        first = ens.run_chunked(state, lambda s: ens.ensemble_step(
            s, gauss_ln_prob, gen), 3, thin=2, chunk_size=2)
        path = checkpoints.save_checkpoint(tmp_path / "c.npz", first[0], gen)
        del gen
        state, gen2, _ = checkpoints.load_checkpoint(path, "cpu")
        second = ens.run_chunked(state, lambda s: ens.ensemble_step(
            s, gauss_ln_prob, gen2), 4, thin=2, chunk_size=2)
        assert second[0].step == whole[0].step == 7
        assert torch.equal(second[0].positions, whole[0].positions)
        assert torch.equal(second[0].log_prob, whole[0].log_prob)
        for i in (1, 2):
            np.testing.assert_array_equal(
                np.concatenate([first[i], second[i]]), whole[i])
        np.testing.assert_array_equal(
            np.concatenate([first[3][0], second[3][0]]), whole[3][0])

    def test_a_jax_checkpoint_is_refused(self, tmp_path):
        jstate = JState(jax.random.PRNGKey(3), jnp.zeros((4, 3)),
                        jnp.zeros(4), jnp.asarray(0, jnp.int32))
        path = jck.save_checkpoint(tmp_path / "checkpoint_0000010.npz",
                                   jstate, {"stage": "prod"})
        with pytest.raises(ValueError, match="no torch.Generator state"):
            checkpoints.load_checkpoint(path, "cpu")

    @pytest.mark.parametrize("kind", ["pt", "hmc"])
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_pt_and_hmc_round_trip_is_bit_for_bit(self, tmp_path, kind,
                                                  dtype):
        state, gen = sampler_state(kind, dtype)
        path = checkpoints.save_checkpoint(
            tmp_path / "checkpoint_0000001.npz", state, gen,
            {"stage": "prod", "kind": kind})
        back, gen2, meta = checkpoints.load_checkpoint(path, "cpu", kind)
        assert type(back) is type(state)
        for a, b in zip(back[:-1], state[:-1]):
            assert a.dtype == dtype and torch.equal(a, b)
        assert back.step == state.step == 1
        assert torch.equal(gen2.get_state(), gen.get_state())
        assert meta == {"stage": "prod", "kind": kind}
        # the JAX package's field names
        with np.load(path) as z:
            assert str(z["kind"]) == kind and "key" not in z
            own = {"pt": ("ln_prior", "betas"),
                   "hmc": ("grad", "step_size", "inv_mass")}[kind]
            assert set(own) <= set(z.files)
            first = state.ln_like if kind == "pt" else state.log_prob
            np.testing.assert_array_equal(z["log_prob"], first.numpy())

    @pytest.mark.parametrize("saved,asked", [
        ("ensemble", "pt"), ("ensemble", "hmc"), ("pt", "ensemble"),
        ("pt", "hmc"), ("hmc", "ensemble"), ("hmc", "pt")])
    def test_another_kind_is_refused(self, tmp_path, saved, asked):
        state, gen = sampler_state(saved)
        path = checkpoints.save_checkpoint(tmp_path / "c.npz", state, gen)
        with pytest.raises(ValueError, match="across sampler kinds"):
            checkpoints.load_checkpoint(path, "cpu", asked)

    def test_latest_checkpoint(self, tmp_path):
        assert checkpoints.latest_checkpoint(tmp_path) is None
        state, gen = gauss_state()
        for step in (20, 100, 40):
            checkpoints.save_checkpoint(
                tmp_path / f"checkpoint_{step:07d}.npz", state, gen)
        (tmp_path / ".checkpoint_0000200.npz.tmp").write_bytes(b"partial")
        assert checkpoints.latest_checkpoint(tmp_path).name == \
            "checkpoint_0000100.npz"
