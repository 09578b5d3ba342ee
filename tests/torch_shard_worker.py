"""One rank of the sharding tests (tests/test_torch_sharding.py), on the CPU
with gloo:

    torchrun --standalone --nproc-per-node N tests/torch_shard_worker.py \\
        OUT.json CASE [CASE ...]

A case is ``sampler:posterior:dtype``: sampler ``ensemble``, ``pt``,
``hmc`` or ``nuts``; posterior ``gauss`` (a Gaussian with a hard support
bound, so that inits redraw batches of odd sizes) or ``cv`` (the port's
posterior of a TINY 2-eclipse model); dtype ``f64`` or ``f32``.  Every
rank runs the case's init and steps with the sharded evaluators of
``parallel.mesh``; rank 0 then runs them again unsharded from the same
seed and writes, per case, each state field's largest difference, whether
the fields, the step outputs and the generator states are the same bits,
and the sizes of the batches the sharded evaluator was handed.
"""

import json
import math
import sys

import torch

from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob_parts
from lfit_python_tpu_torch.parallel import mesh as pm
from lfit_python_tpu_torch.sampling import ensemble, hmc, nuts, pt

TINY = dict(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
            n_donor_lon=8)
DTYPES = {"f64": torch.float64, "f32": torch.float32}
N_WALKERS = 8          # ensemble and per PT rung
N_TEMPS = 2
N_CHAINS = 6           # HMC / NUTS


def gauss_posterior(dtype):
    """(ln_prob, ln_prior, ln_like, start, scatter) of a 3-d Gaussian
    whose prior cuts x0 > 1.0 (-inf): a ball of scatter 1 around 0 draws
    ~16% outside it."""
    def ln_prior(x):
        return torch.where(x[:, 0] > 1.0, -math.inf, 0.0).to(x.dtype)

    def ln_like(x):
        return -0.5 * (x * x).sum(dim=-1)

    def ln_prob(x):
        return ln_prior(x) + ln_like(x)

    start = torch.zeros(3, dtype=dtype)
    return ln_prob, ln_prior, ln_like, start, torch.ones(3, dtype=dtype)


def cv_posterior(dtype):
    model = build_model(n_eclipses=2, complex_spot=[False, True],
                        n_points=16, bands=("g",)).compile()
    ln_prior, ln_like, post = make_ln_prob_parts(model, CVConfig(**TINY),
                                                 dtype=dtype, device="cpu")
    start = torch.tensor(model.var_start(), dtype=dtype)
    return post, ln_prior, ln_like, start, 1e-3 * start.abs().clamp(min=1e-2)


def counted(fn, sizes):
    def wrapped(x):
        sizes.append(int(x.shape[0]) if x.dim() < 3
                     else int(x.shape[0] * x.shape[1]))
        return fn(x)
    return wrapped


def run_case(sampler, post, mesh, seed, depth):
    """The case's init and steps; ``mesh`` None runs them unsharded.
    ``depth``: HMC's leapfrog steps, NUTS's maximum depth.  Returns (state
    fields, step outputs, generator state, batch sizes handed to the
    sharded evaluator)."""
    ln_prob, ln_prior, ln_like, start, scatter = post
    gen = torch.Generator().manual_seed(seed)
    sizes = []
    outs = []
    if sampler == "ensemble":
        if mesh is not None:
            ln_prob = counted(pm.sharded_batch_ln_prob(ln_prob, mesh), sizes)
        state = ensemble.init_walkers(gen, start, scatter, ln_prob,
                                      N_WALKERS)
        if mesh is not None:
            state = pm.shard_state(state, mesh, gen)
        for _ in range(2):
            state, acc = ensemble.ensemble_step(state, ln_prob, gen)
            outs.append(acc)
        fields = [state.positions, state.log_prob]
    elif sampler == "pt":
        batch = None if mesh is None else counted(
            pm.sharded_pt_batch_parts(ln_prior, ln_like, mesh), sizes)
        state = pt.init_pt(gen, start, scatter, ln_prior, ln_like,
                           N_WALKERS, N_TEMPS, batch_parts_fn=batch)
        if mesh is not None:
            state = pm.shard_pt_state(state, mesh, gen)
        state, (acc, rung) = pt.pt_step(state, ln_prior, ln_like, gen,
                                        batch_parts_fn=batch)
        outs += [acc, rung]
        fields = [state.positions, state.ln_like, state.ln_prior]
    else:
        vg = traj = None
        if mesh is not None:
            vg = counted(pm.sharded_value_and_grad(ln_prob, mesh), sizes)
            traj = hmc.batch_trajectories(ln_prob, depth, vg_fn=vg)
        state = hmc.init_hmc(gen, start, scatter, ln_prob, N_CHAINS,
                             step_size=0.3, vg_fn=vg)
        if mesh is not None:
            state = pm.shard_hmc_state(state, mesh, gen)
        if sampler == "nuts":
            state, *aux = nuts.nuts_step(state, ln_prob, gen, depth,
                                         vg_fn=vg)
        else:
            state, *aux = hmc.hmc_step(state, ln_prob, gen, depth, traj)
        outs += aux
        fields = [state.positions, state.log_prob, state.grad]
    return fields, outs, gen.get_state(), sizes


def compare(sharded, plain):
    (f1, o1, g1, sizes), (f2, o2, g2, _) = sharded, plain
    return {
        "max_abs": [float((a.double() - b.double()).abs().nan_to_num()
                          .max()) for a, b in zip(f1, f2)],
        "fields_equal": all(torch.equal(a, b) for a, b in zip(f1, f2)),
        "outputs_equal": all(torch.equal(a, b) for a, b in zip(o1, o2)),
        "generator_equal": torch.equal(g1, g2),
        "finite": all(bool(torch.isfinite(a).any()) for a in f1),
        "batch_sizes": sizes,
    }


def main(out_path, cases):
    mesh = pm.walker_mesh("cpu")
    posts = {}
    results = {"world_size": mesh.world_size}
    for seed, case in enumerate(cases):
        sampler, kind, dt = case.split(":")
        key = (kind, dt)
        if key not in posts:
            make = gauss_posterior if kind == "gauss" else cv_posterior
            posts[key] = make(DTYPES[dt])
        # each CPU gradient evaluation of the CV posterior takes seconds
        depth = 3 if kind == "gauss" else 1
        sharded = run_case(sampler, posts[key], mesh, seed, depth)
        if mesh.rank == 0:
            plain = run_case(sampler, posts[key], None, seed, depth)
            results[case] = compare(sharded, plain)
    if mesh.rank == 0:
        with open(out_path, "w") as fh:
            json.dump(results, fh, indent=1)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
