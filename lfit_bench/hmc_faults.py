"""Faults planted in the port's HMC, for the readings of the HMC cell's
numbers that a control in a lower precision cannot read, and for the
tests that hold each to ``correct`` false.

    python3 -m lfit_bench.hmc_faults --fault NAME --workload W \\
        --seeds 1,2,3 [--seconds 5] [--controls 0]

plants the fault :data:`FAULTS` names in the port, then runs the seeds as
``lfit_bench.control`` does (one JSON line a seed).  ``plant(name)``
plants one in this process and returns what undoes it.
"""

from __future__ import annotations

import sys

__all__ = ["FAULTS", "plant", "main"]


def _accept_all(hmc, likelihood):
    """Every trajectory taken that is not divergent: the acceptance
    uniforms all 0."""
    draws = hmc.trajectory_draws

    def fn(*a, **k):
        noise, jitter, u_acc = draws(*a, **k)
        return noise, jitter, u_acc * 0
    return hmc, "trajectory_draws", fn


def _sign_flip(hmc, likelihood):
    """The gradient of the posterior with its sign flipped."""
    vg = likelihood.Posterior.value_and_grad

    def fn(self, var):
        lp, g = vg(self, var)
        return lp, -g
    return likelihood.Posterior, "value_and_grad", fn


def _wrong_step(hmc, likelihood):
    """Each trajectory at 1.1 times the step size the state holds."""
    traj = hmc._trajectory

    def fn(x0, lp0, g0, eps, *rest):
        return traj(x0, lp0, g0, 1.1 * eps, *rest)
    return hmc, "_trajectory", fn


def _stale_momentum(hmc, likelihood):
    """The momentum noise of the first step used again at every step (the
    draws made, the noise not taken)."""
    draws = hmc.trajectory_draws
    first = []

    def fn(*a, **k):
        noise, jitter, u_acc = draws(*a, **k)
        if not first:
            first.append(noise)
        return first[0], jitter, u_acc
    return hmc, "trajectory_draws", fn


FAULTS = {"accept_all": _accept_all, "sign_flip": _sign_flip,
          "wrong_step": _wrong_step, "stale_momentum": _stale_momentum}


def plant(name):
    """Plant the fault ``name`` in the port; returns a function that takes
    it out again."""
    from lfit_python_tpu_torch.models import likelihood
    from lfit_python_tpu_torch.sampling import hmc

    owner, attr, fn = FAULTS[name](hmc, likelihood)
    old = owner.__dict__[attr]
    setattr(owner, attr, fn)
    return lambda: setattr(owner, attr, old)


def main(argv=None):
    from . import control

    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--fault")
    name = argv[i + 1]
    del argv[i:i + 2]
    plant(name)
    print(f"fault planted: {name}", file=sys.stderr, flush=True)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
