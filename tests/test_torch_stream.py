"""The port's gas-stream integration against the JAX package (float64).

Each stream integration is a 4352-step loop of tensor ops on the CPU
(about 3 s), so the draws are small.
"""

import jax
import numpy as np
import pytest
import torch

from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu.roche import stream as js
from lfit_python_tpu_torch.roche import stream as ts


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def impacts():
    rng = np.random.default_rng(2)
    q = np.array([0.08, 0.15, 0.6])
    x1 = np.asarray(jax.vmap(jg.xl1)(q))
    # disc radii from well inside to beyond the stream's reach
    rd = rng.uniform(0.3, 0.6, (3, 3)) * x1[:, None]
    rd[0, 2] = 0.02                      # never reached: closest approach
    ref = np.asarray(jax.vmap(js.stream_impacts)(q, rd, x1))
    with torch.inference_mode():
        got = ts.stream_impacts(t64(q), t64(rd), t64(x1)).numpy()
    return q, x1, rd, ref, got


class TestStream:
    def test_impacts_match_jax(self, impacts):
        *_, ref, got = impacts
        assert got.shape == (3, 3, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)

    def test_impacts_lie_on_the_rim(self, impacts):
        _, _, rd, _, got = impacts
        r = np.linalg.norm(got, axis=-1)
        hit = np.ones_like(rd, bool)
        hit[0, 2] = False
        # linear interpolation along a chord of the curved stream: the
        # radius misses the rim by ~ step^2 / (8 r), a few 1e-6
        np.testing.assert_allclose(r[hit], rd[hit], rtol=2e-5)
        assert r[0, 2] > rd[0, 2]        # closest-approach fallback

    def test_spot_position_oracle(self, impacts):
        q, x1, rd, _, got = impacts
        with torch.inference_mode():
            traj = ts.stream_trajectory(t64(q[:1]), t64(x1[:1]))
            for e in range(2):
                p = ts.spot_position(t64(q[:1]), t64(rd[:1, e]), traj)
                np.testing.assert_allclose(p.numpy()[0], got[0, e],
                                           atol=1e-14)
        assert traj.shape == (1, ts._N_STEPS + 1, 3)

    @pytest.mark.parametrize("q_lo,steps", [
        (0.03, 4352), (0.02, 4352), (0.01, 5120), (0.002, 5120),
        (0.001, 6144), (0.0, 6144)])
    def test_steps_tiers_match_jax(self, q_lo, steps):
        assert ts.stream_steps_for(q_lo) == steps == js.stream_steps_for(q_lo)


# ---- K2's first-crossing bookkeeping (ops/csrc/stream.cu) ---------------

MAX_E = 16          # STREAM_MAX_E in stream.cu
NAN = float("nan")


def k2_first_crossings(x1, xs, ys, rd):
    """K2's bookkeeping in Python, statement for statement: the radii
    sorted once (descending, NaN last, the same compare-exchanges), one
    compare per step against the head, the head dropped at its crossing,
    the closest-approach fallback for what is left at the end.  ``xs``,
    ``ys``: the positions after steps 1..S; returns (E, 2) impacts."""
    E = len(rd)
    srd = [float(rd[e]) if e < E else NAN for e in range(MAX_E)]
    sid = [e if e < E else -1 for e in range(MAX_E)]

    def before(u, v):
        return u > v or (v != v and u == u)

    for i in range(MAX_E - 1):
        for j in range(MAX_E - 1, i, -1):
            if before(srd[j], srd[j - 1]):
                srd[j - 1], srd[j] = srd[j], srd[j - 1]
                sid[j - 1], sid[j] = sid[j], sid[j - 1]
    out = np.full((E, 2), np.inf)
    x, y = float(x1) - 1e-5, 0.0
    r = -x if x < 0.0 else x
    minr, mx, my = np.inf, x, y
    for xn, yn in zip(xs, ys):
        xn, yn = float(xn), float(yn)
        rn = float(np.sqrt(xn * xn + yn * yn))
        d = r - rn
        den = 1e-30 if d < 1e-30 else d
        while rn <= srd[0]:
            fr = (r - srd[0]) / den
            frac = 0.0 if fr < 0.0 else (1.0 if fr > 1.0 else fr)
            out[sid[0]] = x + frac * (xn - x), y + frac * (yn - y)
            srd, sid = srd[1:] + [NAN], sid[1:] + [-1]
        closer = rn < minr
        minr = rn if closer else minr
        mx = x if closer else mx
        my = y if closer else my
        x, y, r = xn, yn, rn
    for i in range(MAX_E):
        if sid[i] >= 0:
            out[sid[i]] = mx, my
    return out


def scripted_path(n, seed, with_nan=False):
    """A path from (x0, 0) whose radius goes in, out and in again."""
    s = np.arange(1, n + 1) / n
    rad = 0.5 - 0.3 * s + 0.08 * np.sin(5 * np.pi * s)
    th = 0.07 * np.arange(1, n + 1) + 0.01 * np.random.default_rng(
        seed).standard_normal(n)
    xs, ys = rad * np.cos(th), rad * np.sin(th)
    if with_nan:
        xs[n // 3] = np.nan
    return 0.5 + 1e-5, xs, ys


def crossing_radii(case, xs, ys):
    rng = np.random.default_rng(len(case))
    r = np.sqrt(xs * xs + ys * ys)
    r_ok = r[np.isfinite(r)]
    if case == "E=1":
        return np.array([0.3])
    if case == "E=5 ties, NaN, unreached":
        # two tied radii, one exactly equal to a step's radius, a NaN, one
        # below the path's closest approach
        return np.array([0.33, np.nan, 0.33, r_ok[57], 0.01])
    if case == "E=16":
        rd = rng.uniform(r_ok.min() - 0.02, r_ok.max(), 16)
        rd[[3, 9]] = rd[5]                         # a three-way tie
        rd[11] = np.nan
        rd[14] = 0.005                             # never reached
        return rd
    return rng.uniform(0.15, 0.45, 7)              # NaN in the path


@pytest.mark.parametrize("case", ["E=1", "E=5 ties, NaN, unreached", "E=16",
                                  "E=7, NaN position"])
def test_k2_sorted_bookkeeping_matches_the_plain_loop(case, monkeypatch):
    """K2's sorted-radius bookkeeping (mirrored in Python) finds the same
    first crossings as the plain per-radius loop of roche/stream.py, fed
    the same scripted non-monotone path through its RK4 step."""
    x1, xs, ys = scripted_path(300, 1, with_nan="NaN" in case)
    rd = crossing_radii(case, xs, ys)
    steps = iter(zip(xs, ys))

    def scripted_rk4(x, y, vx, vy, mu, dt):
        xn, yn = next(steps)
        return t64([xn]), t64([yn]), vx, vy

    monkeypatch.setattr(ts, "_rk4", scripted_rk4)
    with torch.inference_mode():
        plain = ts.stream_impacts(t64([0.2]), t64(rd[None]), t64([x1]),
                                  n_steps=len(xs))[0, :, :2].numpy()
    mirror = k2_first_crossings(x1, xs, ys, rd)
    np.testing.assert_array_equal(mirror, plain)
    r = np.sqrt(xs * xs + ys * ys)
    crossed = np.array([bool(np.any(r <= v)) for v in rd])
    assert crossed.any()
    if case.startswith(("E=5", "E=16")):
        assert not crossed.all()             # the fallback is exercised
