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
