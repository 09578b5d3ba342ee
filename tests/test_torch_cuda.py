"""The CUDA kernels K1 (contacts: float32, float64 and mixed precision) and
its backward, K2 (gas stream), K3 (GP recursion) and its reverse kernel,
K4-K6 (the core geometry's bisections), K7 and K8 (the flux curves'
sweeps) and their backward kernels, and K9 and K10 (the donor grid's
radius solve, the white dwarf's sweep) on the card, against their
plain PyTorch versions, the posterior and its gradient through them, the
posterior's forward calls replayed from CUDA graphs, and the fit command,
its chunked sampling loop and its checkpoints on the card.

Every test here needs a CUDA card (the kernels have no CPU form) and skips
without one.  The file imports nothing of JAX, so on a machine with the
card it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from lfit_python_tpu_torch.examples import build_model, with_calib_widths
from lfit_python_tpu_torch.models import components as comp
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.ops import (contacts, gp, roche, stream, sweeps,
                                       wd_donor)
from lfit_python_tpu_torch.roche import geometry as tg

pytestmark = pytest.mark.cuda

TINY = dict(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
            n_donor_lon=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    return torch.device("cuda", 0)


def contact_rows(dev, rows=40, n=300, seed=7):
    """f32 per-row scalars and element coordinates around the north-star
    geometry, as element_intervals hands them to the kernel."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(0.15 + 0.01 * rng.standard_normal(rows),
                     dtype=torch.float32, device=dev)
    x1 = tg.xl1(q)
    pl1 = tg.l1_potential(q, x1)
    incl = tg.findi(q, torch.full_like(q, 0.04), x1, pl1)
    r_ins = tg.inscribed_radius(q, x1, pl1)
    r = rng.uniform(0.02, 0.45, (rows, n))
    th = rng.uniform(0, 2 * np.pi, (rows, n))
    px = torch.tensor(r * np.cos(th), dtype=torch.float32, device=dev)
    py = torch.tensor(r * np.sin(th), dtype=torch.float32, device=dev)
    return [q, incl, px, py, x1, pl1, r_ins]


def test_kernel_matches_plain(cuda):
    args = contact_rows(cuda)
    before = contacts.LAUNCHES
    k = contacts.element_intervals_kernel(*args)
    p = contacts.element_intervals_plain(*args)
    torch.cuda.synchronize()
    assert contacts.LAUNCHES == before + 1
    assert torch.equal(k[2], p[2])
    m = k[2]
    assert 0 < int(m.sum()) < m.numel()
    assert float((k[0] - p[0]).abs()[m].max()) <= 1e-5
    assert float((k[1] - p[1]).abs()[m].max()) <= 1e-5
    assert torch.equal(k[0][~m], k[1][~m])


def test_kernel_on_an_infeasible_row(cuda):
    args = contact_rows(cuda, rows=4)
    args[1] = args[1].clone()
    args[1][0] = float("nan")
    k = contacts.element_intervals_kernel(*args)
    p = contacts.element_intervals_plain(*args)
    assert not bool(k[2][0].any())
    assert torch.equal(k[2], p[2])
    assert float((k[0][0] - p[0][0]).abs().max()) <= 1e-6


def special_rows(dev, case):
    """Rows at the edges of K1's two passes: every element eclipsed (all
    near the white dwarf), none (a low inclination), a row shorter than
    a warp and one not a multiple of the block (ragged edges), and an
    infeasible row (NaN inclination) among feasible ones."""
    if case == "all eclipsed":
        args = contact_rows(dev, rows=6, n=256, seed=1)
        rng = np.random.default_rng(1)
        r = rng.uniform(0.005, 0.05, (6, 256))
        th = rng.uniform(0, 2 * np.pi, (6, 256))
        args[2] = torch.tensor(r * np.cos(th), dtype=torch.float32,
                               device=dev)
        args[3] = torch.tensor(r * np.sin(th), dtype=torch.float32,
                               device=dev)
    elif case == "all visible":
        args = contact_rows(dev, rows=6, n=256, seed=2)
        args[1] = torch.full_like(args[1], 40.0)
    elif case == "n = 37":
        args = contact_rows(dev, rows=9, n=37, seed=3)
    elif case == "n = 300":
        args = contact_rows(dev, rows=7, n=300, seed=4)
    else:
        args = contact_rows(dev, rows=5, n=160, seed=5)
        args[1] = args[1].clone()
        args[1][2] = float("nan")
    return args


def in_mode(args, mode):
    """float32 contact rows as the K1 instantiation of ``mode`` takes them:
    float32 as they are, float64 cast, and the mixed-precision mode's
    float64 (q, incl, x1, pl1) and positions beside the float32 rows (the
    inclination cast, so that a NaN row stays NaN)."""
    if mode == "float32":
        return args, {}
    if mode == "float64":
        return [a.double() for a in args], {}
    q64 = args[0].double()
    x164 = tg.xl1(q64)
    pl164 = tg.l1_potential(q64, x164)
    return args, dict(precise=(q64, args[1].double(), x164, pl164),
                      p64=(args[2].double(), args[3].double()))


@pytest.mark.parametrize("mode", ["float32", "float64", "mixed"])
@pytest.mark.parametrize("case", ["all eclipsed", "all visible", "n = 37",
                                  "n = 300", "infeasible row"])
def test_kernel_on_edge_rows(cuda, case, mode):
    """Each K1 instantiation on the edge rows against the plain version
    of its mode: flags equal, phases to 1e-5 cycles (1e-12 in float64),
    one launch on the mode's counter."""
    args, kw = in_mode(special_rows(cuda, case), mode)
    counters = ("LAUNCHES", "F64_LAUNCHES", "MIXED_LAUNCHES")
    before = [getattr(contacts, c) for c in counters]
    k = contacts.element_intervals(*args, **kw)
    torch.cuda.synchronize()
    p = contacts.element_intervals_plain(*args, **kw)
    launched = [getattr(contacts, c) - b for c, b in zip(counters, before)]
    assert launched == [int(mode == m)
                        for m in ("float32", "float64", "mixed")]
    assert torch.equal(k[2], p[2])
    m = k[2]
    if case == "all eclipsed":
        assert bool(m.all())
    elif case == "all visible":
        assert not bool(m.any())
    elif case == "infeasible row":
        assert not bool(m[2].any()) and bool(m.any())
    else:
        assert 0 < int(m.sum()) < m.numel()
    tol = 1e-12 if mode == "float64" else 1e-5
    if bool(m.any()):
        assert float((k[0] - p[0]).abs()[m].max()) <= tol
        assert float((k[1] - p[1]).abs()[m].max()) <= tol
    # a visible element's interval is empty, at phi_c, as in plain
    assert torch.equal(k[0][~m], k[1][~m])
    if not bool(m.all()):
        assert float((k[0] - p[0]).abs()[~m].max()) <= 1e-6


def test_kernel_checks_inputs(cuda):
    args = contact_rows(cuda, rows=4)
    with pytest.raises(TypeError):
        contacts.element_intervals_kernel(*[a.half() for a in args])
    with pytest.raises(TypeError):
        contacts.element_intervals_kernel(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        contacts.element_intervals_kernel(args[0][:-1], *args[1:])
    with pytest.raises(ValueError):
        contacts.element_intervals_kernel(args[0].cpu(), *args[1:])
    strided = torch.stack([args[2], args[2]], dim=-1)[..., 0]
    with pytest.raises(ValueError):
        contacts.element_intervals_kernel(*args[:2], strided, *args[3:])


def precise_rows(dev, rows=40, n=300, seed=7):
    """contact_rows with the mixed-precision mode's float64 solve of the
    rows' (q, incl, x1, pl1) and the elements' float64 positions."""
    args = contact_rows(dev, rows, n, seed)
    q64 = args[0].double()
    x164 = tg.xl1(q64)
    pl164 = tg.l1_potential(q64, x164)
    incl64 = tg.findi(q64, torch.full_like(q64, 0.04), x164, pl164)
    rng = np.random.default_rng(seed + 100)
    r = rng.uniform(0.02, 0.45, (rows, n))
    th = rng.uniform(0, 2 * np.pi, (rows, n))
    p64 = (torch.tensor(r * np.cos(th), device=dev),
           torch.tensor(r * np.sin(th), device=dev))
    args[2], args[3] = p64[0].float(), p64[1].float()
    return args, (q64, incl64, x164, pl164), p64


@pytest.mark.parametrize("mode", ["float64", "mixed"])
def test_float64_and_mixed_kernels_match_plain(cuda, mode):
    """K1's float64 and mixed-precision instantiations against the plain
    version of their mode: flags equal, phases to 1e-12 cycles (float64)
    and 1e-5 (mixed: phase 2's limit); each call one launch, counted on
    its own counter."""
    if mode == "float64":
        args = [a.double() for a in contact_rows(cuda)]
        kw = {}
    else:
        args, precise, p64 = precise_rows(cuda)
        kw = dict(precise=precise, p64=p64)
    before = (contacts.LAUNCHES, contacts.F64_LAUNCHES,
              contacts.MIXED_LAUNCHES)
    k = contacts.element_intervals(*args, **kw)
    torch.cuda.synchronize()
    after = (contacts.LAUNCHES, contacts.F64_LAUNCHES,
             contacts.MIXED_LAUNCHES)
    assert after == (before[0], before[1] + (mode == "float64"),
                     before[2] + (mode == "mixed"))
    p = contacts.element_intervals_plain(*args, **kw)
    assert k[0].dtype == p[0].dtype == args[2].dtype
    assert torch.equal(k[2], p[2])
    m = k[2]
    assert 0 < int(m.sum()) < m.numel()
    tol = 1e-12 if mode == "float64" else 1e-5
    assert float((k[0] - p[0]).abs()[m].max()) <= tol
    assert float((k[1] - p[1]).abs()[m].max()) <= tol
    assert torch.equal(k[0][~m], k[1][~m])


def test_mixed_kernel_checks_inputs(cuda):
    args, precise, p64 = precise_rows(cuda, rows=4, n=64)
    with pytest.raises(TypeError):
        contacts.element_intervals_mixed_kernel(*args, precise,
                                                (p64[0].float(), p64[1]))
    with pytest.raises(TypeError):
        contacts.element_intervals_mixed_kernel(
            *[a.double() for a in args], precise, p64)
    with pytest.raises(ValueError):
        contacts.element_intervals_mixed_kernel(
            *args, (precise[0][:-1],) + precise[1:], p64)


@pytest.mark.parametrize("mode", ["float64", "mixed"])
def test_posterior_float64_and_precise_kernel_paths(cuda, mode):
    """The float64 posterior and the precise float32 one on the card: K1
    in that mode once per evaluation, against the same posterior with the
    plain contact solver (flux max 2e-4: phase 3's limit)."""
    model = build_model(n_eclipses=2, complex_spot=[False, True],
                        n_points=16, bands=("g",)).compile()
    dtype = torch.float64 if mode == "float64" else torch.float32
    lp = make_ln_prob(model, CVConfig(mixed_precision=mode == "mixed",
                                      **TINY), dtype=dtype, device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(3)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((8, start.size)),
                       dtype=dtype, device=cuda)
    counter = "F64_LAUNCHES" if mode == "float64" else "MIXED_LAUNCHES"
    before = (getattr(contacts, counter), contacts.LAUNCHES)
    a, fa = lp(pos), lp.model_flux(pos)
    assert (getattr(contacts, counter), contacts.LAUNCHES) == (
        before[0] + 2, before[1])
    wrapper = ("element_intervals_kernel" if mode == "float64"
               else "element_intervals_mixed_kernel")
    with mock.patch.object(contacts, wrapper,
                           contacts.element_intervals_plain):
        b, fb = lp(pos), lp.model_flux(pos)
    assert getattr(contacts, counter) == before[0] + 2
    assert bool(torch.isfinite(a).all())
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    assert float((fa - fb).abs().max()) <= 2e-4


def backward_rows(dev, dtype, case):
    """The arguments of K1's backward: rows solved by the port's own
    forward with random cotangents on both edges, at the edges of the
    kernel's block (one row, one element, 37, 300 and 992 elements), an
    infeasible row, and rows over the whole parameter range with phases
    off the roots, which take every branch of the residual."""
    if case == "every branch":
        rng = np.random.default_rng(11)
        rows, n = 6, 203

        def f(a):
            return torch.tensor(a, dtype=dtype, device=dev)

        q = f(rng.uniform(0.08, 0.8, rows))
        x1 = tg.xl1(q)
        pl1 = tg.l1_potential(q, x1)
        incl = f(rng.uniform(60, 89.9, rows))
        r = rng.uniform(0.02, 0.95, (rows, n))
        th = rng.uniform(0, 2 * np.pi, (rows, n))
        px, py = f(r * np.cos(th)), f(r * np.sin(th))
        phi_c = torch.atan2(py, 1 - px) / (2 * np.pi)
        pin = phi_c - f(rng.uniform(0, 0.2, (rows, n)))
        pout = phi_c + f(rng.uniform(0, 0.2, (rows, n)))
        ecl = torch.tensor(rng.uniform(size=(rows, n)) < 0.8, device=dev)
        g = f(rng.standard_normal((2, rows, n)))
        return [q, incl, px, py, x1, pl1, pin, pout, ecl, g[0], g[1]]
    shape = {"R = 1": (1, 160), "N = 1": (5, 1), "N = 37": (9, 37),
             "N = 300": (7, 300), "N = 992": (3, 992),
             "infeasible row": (5, 160)}[case]
    args = contact_rows(dev, *shape, seed=len(case))
    if case == "infeasible row":
        args[1] = args[1].clone()
        args[1][2] = float("nan")
    pin, pout, ecl = contacts.element_intervals_kernel(*args)
    rng = np.random.default_rng(2)
    g = torch.tensor(rng.standard_normal((2, *shape)), dtype=torch.float32,
                     device=dev)
    out = [*args[:6], pin, pout, ecl, g[0].contiguous(), g[1].contiguous()]
    return [a if a.dtype == torch.bool else a.to(dtype) for a in out]


BACKWARD_CASES = ["R = 1", "N = 1", "N = 37", "N = 300", "N = 992",
                  "infeasible row", "every branch"]


def feasible(case, grads):
    """The gradients' rows with finite inputs; checks the infeasible row
    (NaN inclination) of that case on the way.  There the plain backward
    gives NaN in q, incl, px and py, and 0 in x1 and pl1, whose paths
    through clamps and selects autograd masks to exact zeros; the kernel's
    reverse sweep applies the same masks and gives the same.  (The
    posterior zeroes non-finite gradients.)"""
    if case != "infeasible row":
        return grads
    for name, g in zip(("q", "incl", "px", "py", "x1", "pl1"), grads):
        if name in ("x1", "pl1"):
            assert float(g[2]) == 0.0, name
        else:
            assert bool(torch.isnan(g[2]).all()), name
    return [g[[0, 1, 3, 4]] for g in grads]


@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_backward_kernel_f64_matches_autograd(cuda, case):
    """The float64 instantiation of K1's backward kernel against autograd
    on the edge residual: each of the six gradients within 1e-9 of its
    largest entry, one launch."""
    args = backward_rows(cuda, torch.float64, case)
    before = contacts.BACKWARD_LAUNCHES
    k = contacts.contact_backward_kernel(*args)
    p = contacts._contact_backward_plain(*args)
    torch.cuda.synchronize()
    assert contacts.BACKWARD_LAUNCHES == before + 1
    for a, b in zip(feasible(case, k), feasible(case, p)):
        assert a.shape == b.shape
        assert bool(torch.isfinite(a).all() & torch.isfinite(b).all())
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_backward_kernel_f32_matches_plain(cuda, case):
    """float32, what the main paths run: each entry within 1e-5 + 2e-3 |g|
    of the plain float32 backward, or no farther from the float64 plain
    backward than 3x the plain float32 backward's largest distance from it
    in that output (the two round their angles differently, and differ by
    about as much as each errs where 1 / dcdphi is large); the same bits
    on a second launch (the row sums use no atomics)."""
    a32 = backward_rows(cuda, torch.float32, case)
    a64 = [a if a.dtype == torch.bool else a.double() for a in a32]
    k = contacts.contact_backward_kernel(*a32)
    again = contacts.contact_backward_kernel(*a32)
    p = contacts._contact_backward_plain(*a32)
    ref = contacts._contact_backward_plain(*a64)
    torch.cuda.synchronize()
    for a, a2 in zip(k, again):
        assert torch.equal(torch.isnan(a), torch.isnan(a2))
        assert torch.equal(a.nan_to_num(), a2.nan_to_num())
    for a, b, r in zip(feasible(case, k), feasible(case, p),
                       feasible(case, ref)):
        assert bool(torch.isfinite(a).all() & torch.isfinite(b).all())
        d = (a.double() - b.double()).abs()
        e_k, e_p = (a.double() - r).abs(), (b.double() - r).abs()
        ok = (d <= 1e-5 + 2e-3 * b.double().abs()) | (e_k <= 3 * e_p.max())
        assert bool(ok.all())


def test_backward_kernel_routing_and_input_checks(cuda):
    """On the card the backward of element_intervals_diff is one launch of
    the kernel in either dtype; the wrapper raises on what the kernel does
    not take."""
    args = backward_rows(cuda, torch.float32, "N = 300")
    for dtype in (torch.float32, torch.float64):
        rows = [a.to(dtype) for a in contact_rows(cuda, 7, 300, seed=7)]
        leaves = [a.clone().requires_grad_() for a in rows[:6]]
        before = (contacts.BACKWARD_CALLS, contacts.BACKWARD_LAUNCHES)
        pin, pout, _ = contacts.element_intervals_diff(*leaves, rows[6])
        grads = torch.autograd.grad((pout - pin).sum(), leaves)
        assert (contacts.BACKWARD_CALLS, contacts.BACKWARD_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(TypeError):
        contacts.contact_backward_kernel(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        contacts.contact_backward_kernel(*[
            a if a.dtype == torch.bool else a.half() for a in args])
    with pytest.raises(TypeError):
        contacts.contact_backward_kernel(*args[:8], args[8].float(),
                                         *args[9:])
    with pytest.raises(ValueError):
        contacts.contact_backward_kernel(args[0][:-1], *args[1:])
    with pytest.raises(ValueError):
        contacts.contact_backward_kernel(args[0].cpu(), *args[1:])
    # a strided cotangent is made contiguous, not refused
    wide = torch.stack([args[9], args[9]], dim=-1)[..., 0]
    a = contacts.contact_backward_kernel(*args[:9], wide, args[10])
    b = contacts.contact_backward_kernel(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_backward_kernel_takes_float64_on_the_card(cuda):
    """One float64 forward and backward of element_intervals_diff on the
    card (the plain solver's roots, as the JAX package solves float64) is
    one launch of the backward kernel, and its gradients are autograd's on
    the edge residual within 1e-9 of each one's largest entry."""
    rows = [a.double() for a in contact_rows(cuda, 9, 256, seed=3)]
    leaves = [a.clone().requires_grad_() for a in rows[:6]]
    before = (contacts.BACKWARD_CALLS, contacts.BACKWARD_LAUNCHES)
    pin, pout, ecl = contacts.element_intervals_diff(*leaves, rows[6])
    cot = torch.randn(pin.shape, dtype=torch.float64, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(0))
    grads = torch.autograd.grad((cot * pin + pout).sum(), leaves)
    assert (contacts.BACKWARD_CALLS, contacts.BACKWARD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    ref = contacts._contact_backward_plain(
        *rows[:6], pin.detach(), pout.detach(), ecl, cot,
        torch.ones_like(cot))
    assert contacts.BACKWARD_LAUNCHES == before[1] + 1
    for g, r in zip(grads, ref):
        assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
        assert float((g - r).abs().max()) <= 1e-9 * float(r.abs().max())


def test_posterior_kernel_path_matches_plain_path(cuda):
    """float32 on the card: the posterior through K1 against the same
    posterior with the plain contact solver."""
    model = build_model(n_eclipses=2, complex_spot=[False, True],
                        n_points=16, bands=("g",)).compile()
    lp = make_ln_prob(model, CVConfig(**TINY), dtype=torch.float32,
                      device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(3)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((8, start.size)),
                       dtype=torch.float32, device=cuda)
    before = contacts.LAUNCHES
    a, fa = lp(pos), lp.model_flux(pos)
    assert contacts.LAUNCHES == before + 2
    with mock.patch.object(contacts, "element_intervals_kernel",
                           contacts.element_intervals_plain):
        b, fb = lp(pos), lp.model_flux(pos)
    assert bool(torch.isfinite(a).all())
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    assert float((fa - fb).abs().max()) <= 2e-4


def test_float32_posterior_does_not_depend_on_its_batch(cuda):
    """A walker's float32 ln p and flux are the same bits alone and inside
    a larger batch, across the flux sweep's chunk boundaries (chunks cut
    small here so that the batches end in partial chunks of other sizes):
    the chain file's ln_prob column and a fresh evaluation agree."""
    from lfit_python_tpu_torch.models import components as comp

    model = build_model(n_eclipses=2, complex_spot=[False, True],
                        n_points=16, bands=("g",)).compile()
    lp = make_ln_prob(model, CVConfig(**TINY), dtype=torch.float32,
                      device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(5)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((37, start.size)),
                       dtype=torch.float32, device=cuda)
    with mock.patch.object(comp, "_CHUNK_ELEMS", 1 << 12):
        alone = lp(pos[:25]), lp.model_flux(pos[:25])
        inside = lp(pos), lp.model_flux(pos)
    assert torch.equal(alone[0], inside[0][:25])
    assert torch.equal(alone[1], inside[1][:25])


@pytest.mark.parametrize("n_points", [5, 11])
def test_float32_posterior_of_short_light_curves_does_not_depend_on_its_batch(
        cuda, n_points):
    """The same for light curves of fewer than 16 points, at the default
    element grids: a chunk of the flux or donor sweep may then hold fewer
    than 16 outputs (rows x P), and the donor's quadrature normaliser
    (P = 1) does for a walker alone.  A walker's ln p and flux are the
    same bits alone, in batches of 2 and 25 and in the batch of 37, with
    the chunks at their default size and cut so that batches end in
    partial chunks."""
    from lfit_python_tpu_torch.models import components as comp

    model = build_model(n_eclipses=2, complex_spot=[False, True],
                        n_points=n_points, bands=("g",)).compile()
    lp = make_ln_prob(model, CVConfig(), dtype=torch.float32, device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(6)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((37, start.size)),
                       dtype=torch.float32, device=cuda)
    for chunk in (comp._CHUNK_ELEMS, 1 << 14):
        with mock.patch.object(comp, "_CHUNK_ELEMS", chunk):
            inside = lp(pos), lp.model_flux(pos)
            assert bool(torch.isfinite(inside[0]).all())
            for n in (1, 2, 25):
                alone = lp(pos[:n]), lp.model_flux(pos[:n])
                assert torch.equal(alone[0], inside[0][:n]), (chunk, n)
                assert torch.equal(alone[1], inside[1][:n]), (chunk, n)


def stream_inputs(dev, dtype):
    """Four walkers over the q range and four disc radii each; the
    smallest the stream never reaches in 3072 steps (closest-approach
    fallback)."""
    q = torch.tensor([0.08, 0.15, 0.6, 1.2], dtype=dtype, device=dev)
    x1 = tg.xl1(q)
    frac = torch.tensor([0.95, 0.8, 0.6, 0.02], dtype=dtype, device=dev)
    return q, (frac[None] * x1[:, None]).contiguous(), x1


@pytest.mark.parametrize("with_sens", [False, True])
@pytest.mark.parametrize("dtype,imp_tol,jac_tol", [
    (torch.float64, 1e-10, 1e-8), (torch.float32, 1e-4, 1e-4)])
def test_stream_kernel_matches_plain(cuda, dtype, imp_tol, jac_tol,
                                     with_sens):
    """K2 repeats the plain loop's arithmetic op for op (built without
    contracted multiply-adds); the bounds leave room for the device's
    rsqrt and sqrt against PyTorch's."""
    q, rd, x1 = stream_inputs(cuda, dtype)
    before = (stream.LAUNCHES, stream.SENS_LAUNCHES)
    k = stream.stream_impacts_kernel(q, rd, x1, 3072, with_sens=with_sens)
    p = stream._plain(q, rd, x1, 3072, stream.plain._DT, with_sens)
    torch.cuda.synchronize()
    assert (stream.LAUNCHES, stream.SENS_LAUNCHES) == (
        before[0] + 1, before[1] + int(with_sens))
    assert len(k) == len(p) == (4 if with_sens else 1)
    assert bool((k[0][..., 2] == 0).all())
    assert float((k[0] - p[0]).abs().max()) <= imp_tol
    for a, b in zip(k[1:], p[1:]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max() / b.abs().max()) <= jac_tol
    if with_sens:
        # the unreached radius carries no rdisc derivative
        assert bool((k[3][:, 3] == 0).all())


N_STEPS_EXACT = 1024


@pytest.fixture(scope="module")
def stream_radii():
    """Per walker, 16 disc radii for N_STEPS_EXACT steps, from the plain
    trajectory's own radii (float64 on the CPU): crossed in an order
    other than the given one, a three-way tie, a radius equal to a step's
    radius, a NaN, and one below the closest approach (never reached)."""
    q = torch.tensor([0.08, 0.15, 0.6, 1.2], dtype=torch.float64)
    traj = stream.plain.stream_trajectory(q, tg.xl1(q), N_STEPS_EXACT)
    r = torch.linalg.vector_norm(traj, dim=-1)[:, 1:]       # (4, S)
    lo, hi = r.amin(dim=1), r.amax(dim=1)
    rng = np.random.default_rng(11)
    u = torch.tensor(rng.uniform(0.0, 1.0, (4, 16)), dtype=torch.float64)
    rd = lo[:, None] + u * (hi - lo)[:, None]
    rd[:, [3, 9]] = rd[:, [5]]
    rd[:, 7] = r[:, N_STEPS_EXACT // 2]
    rd[:, 11] = float("nan")
    rd[:, 14] = 0.5 * lo
    return q, rd


@pytest.mark.parametrize("with_sens", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_radii", [1, 5, 16])
def test_stream_kernel_bit_identical(cuda, stream_radii, n_radii, dtype,
                                     with_sens):
    """K2's sorted-radius bookkeeping, closest-approach selects and
    two-thread sensitivities change no operation: its outputs equal the
    plain loop's bit for bit, on the card, in both dtypes and modes."""
    q, rd = stream_radii
    cols = {1: [7], 5: [14, 3, 0, 9, 7], 16: list(range(16))}[n_radii]
    q = q.to(cuda, dtype)
    rd = rd[:, cols].to(cuda, dtype).contiguous()
    x1 = tg.xl1(q)
    k = stream.stream_impacts_kernel(q, rd, x1, N_STEPS_EXACT,
                                     with_sens=with_sens)
    p = stream._plain(q, rd, x1, N_STEPS_EXACT, stream.plain._DT, with_sens)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


def test_stream_kernel_checks_inputs(cuda):
    q, rd, x1 = stream_inputs(cuda, torch.float32)
    with pytest.raises(TypeError):
        stream.stream_impacts_kernel(q.double(), rd, x1)
    with pytest.raises(TypeError):
        stream.stream_impacts_kernel(q.half(), rd.half(), x1.half())
    with pytest.raises(ValueError):
        stream.stream_impacts_kernel(q[:-1], rd, x1)
    with pytest.raises(ValueError):
        stream.stream_impacts_kernel(q, rd[:, 0], x1)
    with pytest.raises(ValueError):
        stream.stream_impacts_kernel(q.cpu(), rd, x1)
    with pytest.raises(ValueError):
        stream.stream_impacts_kernel(q, rd.t().contiguous().t(), x1)
    wide = rd[:, :1].expand(4, 17).contiguous()
    with pytest.raises(ValueError):
        stream.stream_impacts_kernel(q, wide, x1)


def test_posterior_gradient_kernel_path_matches_plain_path(cuda):
    """float32 on the card, on the tiny model with exposure widths: the
    gradient through K1 (with its IFT backward) and K2 (with its
    sensitivities) against the same gradient with the plain contact
    solver and the plain stream loop, at tests/test_pallas.py's bound
    for the Pallas and XLA paths' posterior gradients."""
    model = with_calib_widths(build_model(
        n_eclipses=2, complex_spot=[False, True], n_points=16,
        bands=("g",))).compile()
    lp = make_ln_prob(model, CVConfig(**TINY), dtype=torch.float32,
                      device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(3)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((8, start.size)),
                       dtype=torch.float32, device=cuda)
    before = (contacts.BACKWARD_CALLS, stream.SENS_LAUNCHES)
    a, ga = lp.value_and_grad(pos)
    assert (contacts.BACKWARD_CALLS, stream.SENS_LAUNCHES) == (
        before[0] + 1, before[1] + 1)

    def plain_stream(q, rd, x1, n_steps, dt, with_sens=False):
        return stream._plain(q, rd, x1, n_steps, dt, with_sens)

    with mock.patch.object(contacts, "element_intervals_kernel",
                           contacts.element_intervals_plain), \
            mock.patch.object(stream, "stream_impacts_kernel", plain_stream):
        b, gb = lp.value_and_grad(pos)
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(ga).all())
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(ga, gb, rtol=2e-3, atol=1e-5)


def gp_series(dev, dtype, case, W=5, E=3, P=50, seed=3):
    """(W, E) residual series around an eclipse, as gp_flicker_ln_like
    hands them to K3, with the edge cases of the recursion's masks."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(-0.15, 0.15, (E, P)), axis=-1)
    yerr = rng.uniform(1e-3, 3e-3, (E, P))
    y = 0.01 * np.sin(40 * t)[None] + 0.002 * rng.standard_normal((W, E, P))
    half = rng.uniform(0.02, 0.06, (W, E, 1))
    in_ecl = np.abs(t[None]) <= half
    if case == "no in-eclipse point":
        in_ecl[1] = False
    sigma2 = np.where(in_ecl, rng.uniform(5e-4, 2e-3, (W, E, 1)) ** 2,
                      rng.uniform(2e-3, 8e-3, (W, E, 1)) ** 2)
    reset = np.zeros((W, E, P), bool)
    reset[..., 1:] = in_ecl[..., 1:] != in_ecl[..., :-1]
    mask = np.ones((E, P), bool)
    if case == "padded points":
        mask[1, -9:] = False
        mask[2, -1:] = False
    elif case == "reset at first and last point":
        reset[..., 0] = True
        reset[:, 0, -1] = True
    c = np.sqrt(3.0) / rng.uniform(0.01, 0.1, (W, E))

    def f(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    return (f(t), f(y), f(yerr), f(sigma2), f(c),
            torch.tensor(reset, device=dev), torch.tensor(mask, device=dev))


@pytest.mark.parametrize("case", ["segments", "padded points",
                                  "reset at first and last point",
                                  "no in-eclipse point"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 1e-5)])
def test_gp_kernel_matches_plain(cuda, dtype, tol, case):
    """K3 repeats the plain loop's arithmetic (built without contracted
    multiply-adds) but makes its angles with sincospi, which rounds them
    once more than PyTorch's cos and sin: 1e-11 relative in float64, 1e-5
    per point absolute in float32."""
    t, y, yerr, sigma2, c, reset, mask = gp_series(cuda, dtype, case)
    before = gp.LAUNCHES
    k = gp.segmented_matern32_ln_like(t, y, yerr, sigma2, c, reset=reset,
                                      mask=mask)
    assert gp.LAUNCHES == before + 1
    p = gp.segmented_matern32_plain(t, y, yerr, sigma2, c, reset=reset,
                                    mask=mask)
    torch.cuda.synchronize()
    assert gp.LAUNCHES == before + 1
    assert k.shape == (5, 3) and bool(torch.isfinite(k).all())
    d = (k - p).abs()
    # against the float64 plain loop on the CPU
    ref = gp.segmented_matern32_plain(*[
        a.cpu().double() if a.is_floating_point() else a.cpu()
        for a in (t, y, yerr, sigma2, c)], reset=reset.cpu(),
        mask=mask.cpu())
    if dtype == torch.float64:
        assert float((d / p.abs()).max()) <= tol
    else:
        assert float(d.max()) <= tol * y.shape[-1]
    rel = 1e-9 if dtype == torch.float64 else 2e-3
    assert float(((k.cpu().double() - ref) / ref).abs().max()) <= rel


@pytest.mark.parametrize("case", ["segments", "padded points",
                                  "reset at first and last point",
                                  "no in-eclipse point"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_gp_reverse_kernel_matches_autograd_of_plain(cuda, dtype, tol, case):
    """K3's reverse kernel against autograd on the plain loop, through
    the amplitudes and the timescale as the GP likelihood reaches them:
    each gradient within ``tol`` of its largest entry (the two sum in
    different orders), one forward and one backward launch."""
    t, y, yerr, sigma2, c, reset, mask = gp_series(cuda, dtype, case)
    cot = torch.tensor(np.random.default_rng(5).standard_normal((5, 3)),
                       dtype=dtype, device=cuda)
    grads = {}
    for name, fn in (("kernel", gp.segmented_matern32_ln_like),
                     ("plain", gp.segmented_matern32_plain)):
        leaves = [a.clone().requires_grad_()
                  for a in (y, sigma2.log(), c.log())]
        before = (gp.LAUNCHES, gp.BACKWARD_LAUNCHES)
        ll = fn(t, leaves[0], yerr, leaves[1].exp(), leaves[2].exp(),
                reset=reset, mask=mask)
        grads[name] = torch.autograd.grad(ll, leaves, cot)
        n = int(name == "kernel")
        assert (gp.LAUNCHES, gp.BACKWARD_LAUNCHES) == (before[0] + n,
                                                       before[1] + n)
    for k, p in zip(grads["kernel"], grads["plain"]):
        assert k.shape == p.shape and bool(torch.isfinite(k).all())
        assert float(p.abs().max()) > 0
        assert float((k - p).abs().max()) <= tol * float(p.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_gp_reverse_kernel_gradient_of_broadcast_c(cuda, dtype, tol):
    """The reverse kernel writes d c itself; where one amplitude and one
    timescale per walker came in broadcast over eclipses and points, as
    matern32_gp_ln_like calls K3, autograd sums the kernel's gradients
    back to their shapes."""
    t, y, yerr, sigma2, c, _, mask = gp_series(cuda, dtype, "padded points")
    cot = torch.tensor(np.random.default_rng(5).standard_normal((5, 3)),
                       dtype=dtype, device=cuda)
    grads = {}
    for name, fn in (("kernel", gp.segmented_matern32_ln_like),
                     ("plain", gp.segmented_matern32_plain)):
        leaves = [sigma2[:, :1, :1].clone().requires_grad_(),
                  c[:, :1].clone().requires_grad_()]
        ll = fn(t, y, yerr, leaves[0], leaves[1], mask=mask)
        grads[name] = torch.autograd.grad(ll, leaves, cot)
    for k, p, shape in zip(grads["kernel"], grads["plain"],
                           ((5, 1, 1), (5, 1))):
        assert tuple(k.shape) == tuple(p.shape) == shape
        assert bool(torch.isfinite(k).all()) and float(p.abs().max()) > 0
        assert float((k - p).abs().max()) <= tol * float(p.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gp_kernel_series_without_points(cuda, dtype):
    """P = 0: one launch of the forward kernel, which reads no point and
    gives each series the plain loop's ln-likelihood 0; the context stays
    usable."""
    t, y, yerr, sigma2, c, reset, mask = gp_series(cuda, dtype, "segments")
    before = gp.LAUNCHES
    k = gp.segmented_matern32_ln_like(t[..., :0], y[..., :0], yerr[..., :0],
                                      sigma2[..., :0], c,
                                      reset=reset[..., :0],
                                      mask=mask[..., :0])
    torch.cuda.synchronize()
    assert gp.LAUNCHES == before + 1
    p = gp.segmented_matern32_plain(t[..., :0], y[..., :0], yerr[..., :0],
                                    sigma2[..., :0], c, reset=reset[..., :0],
                                    mask=mask[..., :0])
    assert k.shape == p.shape == (5, 3)
    assert torch.equal(k, p) and not bool(k.any())
    k = gp.segmented_matern32_ln_like(t, y, yerr, sigma2, c, reset=reset,
                                      mask=mask)
    assert bool(torch.isfinite(k).all())


def test_gp_kernel_routing_and_input_checks(cuda):
    t, y, yerr, sigma2, c, reset, mask = gp_series(cuda, torch.float32,
                                                   "segments")
    # a gradient is required: still the kernel, and its reverse kernel
    before = gp.LAUNCHES
    before_bwd = gp.BACKWARD_LAUNCHES
    yg = y.clone().requires_grad_()
    ll = gp.segmented_matern32_ln_like(t, yg, yerr, sigma2, c, reset=reset,
                                       mask=mask)
    g, = torch.autograd.grad(ll.sum(), yg)
    assert gp.LAUNCHES == before + 1 and bool(torch.isfinite(g).all())
    assert gp.BACKWARD_LAUNCHES == before_bwd + 1
    with pytest.raises(ValueError):
        gp.segmented_matern32_ln_like(t, y, yerr.clone().requires_grad_(),
                                      sigma2, c)
    with pytest.raises(ValueError):
        gp.segmented_matern32_ln_like(t.clone().requires_grad_(), y, yerr,
                                      sigma2, c)
    before = gp.LAUNCHES
    # broadcast arguments: a scalar amplitude, no reset, no mask
    k = gp.segmented_matern32_kernel(t, y, yerr, 1e-5, c)
    p = gp.segmented_matern32_plain(t, y, yerr, 1e-5, c)
    assert gp.LAUNCHES == before + 1
    assert float((k - p).abs().max()) <= 1e-5 * y.shape[-1]
    with pytest.raises(TypeError):
        gp.segmented_matern32_kernel(t.double(), y, yerr, sigma2, c)
    with pytest.raises(TypeError):
        gp.segmented_matern32_kernel(t, y.half(), yerr.half(),
                                     sigma2.half(), c.half())
    with pytest.raises(TypeError):
        gp.segmented_matern32_kernel(t, y, yerr, sigma2, c,
                                     reset=reset.float())
    with pytest.raises(ValueError):
        gp.segmented_matern32_kernel(t, y[0], yerr, sigma2, c)
    with pytest.raises((ValueError, RuntimeError)):
        gp.segmented_matern32_kernel(t, y, yerr, sigma2.cpu(), c)


def test_gp_posterior_kernel_path_matches_plain_path(cuda):
    """float32 on the card: a mixed GP / chi^2 posterior through K3
    against the same posterior with the plain recursion."""
    model = build_model(n_eclipses=3, complex_spot=[False, True, False],
                        use_gp=[True, True, False], n_points=24,
                        bands=("g",)).compile()
    lp = make_ln_prob(model, CVConfig(**TINY), dtype=torch.float32,
                      device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(3)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((8, start.size)),
                       dtype=torch.float32, device=cuda)
    before = gp.LAUNCHES
    a = lp(pos)
    assert gp.LAUNCHES == before + 1
    with mock.patch.object(gp, "segmented_matern32_kernel",
                           gp.segmented_matern32_plain):
        b = lp(pos)
    assert gp.LAUNCHES == before + 1
    assert bool(torch.isfinite(a).all())
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    assert float((a - b).abs().max()) <= 3 * 1e-5 * 24
    # the gradient path: K3 forward and its reverse kernel, once each,
    # against the plain recursion under autograd
    before_bwd = gp.BACKWARD_LAUNCHES
    lp_g, g = lp.value_and_grad(pos)
    assert gp.LAUNCHES == before + 2
    assert gp.BACKWARD_LAUNCHES == before_bwd + 1
    assert bool(torch.isfinite(g).all())
    torch.testing.assert_close(lp_g, a, rtol=1e-5, atol=3 * 1e-5 * 24)
    with mock.patch.object(gp, "segmented_matern32_kernel",
                           gp.segmented_matern32_plain):
        _, g_plain = lp.value_and_grad(pos)
    assert (gp.LAUNCHES, gp.BACKWARD_LAUNCHES) == (before + 2,
                                                   before_bwd + 1)
    cos = torch.nn.functional.cosine_similarity(g.double(),
                                                g_plain.double(), dim=-1)
    assert float(cos.min()) >= 0.9999


# ---- the fit command and its host IO on the card ----------------------------

def test_fit_on_the_demo(cuda, tmp_path):
    from pathlib import Path

    from lfit_python_tpu_torch import cli
    from lfit_python_tpu_torch.utils.chains import read_chain

    demo = Path(__file__).resolve().parent.parent / "examples/demo_input.dat"
    before = contacts.LAUNCHES, stream.LAUNCHES
    rc = cli.main(["fit", str(demo), "--outdir", str(tmp_path), "--nburn",
                   "2", "--nprod", "4", "--checkpoint-every", "2",
                   "--quiet"])
    assert rc == 0
    chain, lp, names = read_chain(tmp_path / "chain_prod.txt")
    assert chain.shape == (4, 1024, 13) and np.isfinite(lp).all()
    assert sorted(p.name for p in tmp_path.glob("checkpoint_*")) == [
        "checkpoint_0000002.npz", "checkpoint_0000004.npz"]
    assert (tmp_path / "params.json").exists()
    # init and 6 steps of 2 evaluations: K1 and K2 on every one
    assert contacts.LAUNCHES - before[0] >= 13
    assert stream.LAUNCHES - before[1] >= 13


def _gauss(x):
    return -0.5 * (x * x).sum(dim=-1)


def _gauss_start(dev, seed=9):
    from lfit_python_tpu_torch.sampling import ensemble as ens

    gen = torch.Generator(device=dev).manual_seed(seed)
    start = torch.linspace(-1.0, 1.0, 5, dtype=torch.float32, device=dev)
    state = ens.init_walkers(gen, start, torch.full_like(start, 0.5),
                             _gauss, 64)
    return state, gen


def test_checkpoint_resume_of_a_cuda_generator(cuda, tmp_path):
    from lfit_python_tpu_torch.sampling import ensemble as ens
    from lfit_python_tpu_torch.utils import checkpoints

    def step(gen):
        return lambda s: ens.ensemble_step(s, _gauss, gen)

    state, gen = _gauss_start(cuda)
    whole = ens.run_chunked(state, step(gen), 9, thin=2, chunk_size=4)
    state, gen = _gauss_start(cuda)
    first = ens.run_chunked(state, step(gen), 5, thin=2, chunk_size=4)
    path = checkpoints.save_checkpoint(tmp_path / "c.npz", first[0], gen)
    back, gen2, _ = checkpoints.load_checkpoint(path, cuda)
    assert gen2.device.type == "cuda" and back.positions.is_cuda
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert torch.equal(back.positions, first[0].positions)
    second = ens.run_chunked(back, step(gen2), 4, thin=2, chunk_size=4)
    assert torch.equal(second[0].positions, whole[0].positions)
    assert torch.equal(second[0].log_prob, whole[0].log_prob)
    for i in (1, 2):
        np.testing.assert_array_equal(
            np.concatenate([first[i], second[i]]), whole[i])
    np.testing.assert_array_equal(
        np.concatenate([first[3][0], second[3][0]]), whole[3][0])
    with pytest.raises(ValueError, match="cuda generator"):
        checkpoints.load_checkpoint(path, "cpu")


def test_run_chunked_on_the_card_keeps_run_samplers_rows(cuda):
    from lfit_python_tpu_torch.sampling import ensemble as ens

    state, gen = _gauss_start(cuda)
    twin = torch.Generator(device=cuda)
    twin.set_state(gen.get_state())
    out = ens.run_chunked(state, lambda s: ens.ensemble_step(s, _gauss, gen),
                          13, thin=3, chunk_size=4)
    ref = ens.run_sampler(state, _gauss, 13, twin, thin=3)
    assert torch.equal(out[0].positions, ref[0].positions)
    for got, want in zip((*out[1:3], out[3][0]), ref[1:]):
        np.testing.assert_array_equal(got, want.cpu().numpy())


# ---- K4-K6: the core geometry's bisections ------------------------------

ROCHE_LOOPS = {"findi": tg._findi_loop, "xl1": tg._xl1_loop,
               "lobe_radius": tg._lobe_loop}


def roche_inputs(dev, dtype, n=2048, seed=13):
    """Each solve's inputs: q 0.03-3 and dphi 0.005-0.15 with infeasible
    pairs (0.05, 0.2), (0.05, 0.25) and a NaN q last; radii along the pole
    and along random unit directions."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(np.r_[rng.uniform(0.03, 3.0, n - 3), 0.05, 0.05,
                           np.nan], dtype=dtype, device=dev)
    dphi = torch.tensor(np.r_[rng.uniform(0.005, 0.15, n - 3), 0.2, 0.25,
                              0.04], dtype=dtype, device=dev)
    d = rng.standard_normal((n, 3))
    d[: n // 2] = (0.0, 0.0, 1.0)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                     dtype=dtype, device=dev)
    x1 = tg._xl1_loop(q)
    pl1 = tg.l1_potential(q, x1)
    return {"findi": (q, 0.5 * dphi, x1, pl1), "xl1": (q,),
            "lobe_radius": (q, x1, pl1,
                            *(d[:, k].contiguous() for k in range(3)))}


def same_bits(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(a[~na], b[~nb]))


@pytest.mark.parametrize("name", sorted(ROCHE_LOOPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_roche_kernel_bit_identical(cuda, name, dtype):
    """K4-K6 repeat their plain loops' operations in order: the same bits
    and the same NaN pattern, on the card, in both dtypes."""
    args = roche_inputs(cuda, dtype)[name]
    counter = {"findi": "FINDI_LAUNCHES", "xl1": "XL1_LAUNCHES",
               "lobe_radius": "LOBE_LAUNCHES"}[name]
    before = getattr(roche, counter)
    k = getattr(roche, f"{name}_kernel")(*args)
    p = ROCHE_LOOPS[name](*args)
    torch.cuda.synchronize()
    assert getattr(roche, counter) == before + 1
    assert same_bits(k, p)
    if name == "findi":
        assert bool(torch.isnan(k[-3:]).all())
        assert 0.5 * k.numel() < int(torch.isfinite(k).sum()) < k.numel()


ROCHE_ITERS = {"findi": "_FINDI_ITERS", "xl1": "_XL1_ITERS",
               "lobe_radius": "_LOBE_ITERS"}


@pytest.mark.parametrize("iters", [1, 5, 6, 54])
@pytest.mark.parametrize("name", sorted(ROCHE_ITERS))
def test_roche_group_kernels_bit_identical(cuda, name, iters):
    """K4-K6 (groups of 2^d lanes a solve, d levels a round) give the
    loops' bits at solve counts around a warp, a block and the north
    star's, with the bisection cut to 1, 5 or 6 steps (a short round, a
    whole one, one step more) and at 54, in both dtypes."""
    fn = getattr(roche, f"{name}_kernel")
    with mock.patch.object(tg, ROCHE_ITERS[name], iters):
        for dtype in (torch.float32, torch.float64):
            args = roche_inputs(cuda, dtype, n=5121)[name]
            for n in (1, 31, 33, 1023, 1024, 5121):
                a = [t[:n] for t in args] if n < 5121 else args
                assert same_bits(fn(*a), ROCHE_LOOPS[name](*a)), (dtype, n)


def test_roche_every_depth_bit_identical(cuda):
    """roche.cu built at each group depth that tools/torch_roche_depths.py
    times (the kept one and those measured beside it) gives the loops'
    bits, K4-K6 in both dtypes; its launches count nothing."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import torch_roche_depths as depths

    libs = depths.build()
    iters = {"findi": tg._FINDI_ITERS, "xl1": tg._XL1_ITERS,
             "lobe_radius": tg._LOBE_ITERS}
    before = (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES, roche.LOBE_LAUNCHES)
    for dtype in (torch.float32, torch.float64):
        inputs = roche_inputs(cuda, dtype)
        for name in sorted(ROCHE_ITERS):
            ref = ROCHE_LOOPS[name](*inputs[name])
            for label, (lib, _) in libs.items():
                out = torch.empty_like(ref)
                depths.launcher(lib, name, inputs[name], out, iters[name])()
                assert same_bits(out, ref), (label, name, dtype)
    assert (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES,
            roche.LOBE_LAUNCHES) == before


def north_star_walkers(dev, n=1024, dtype=torch.float32):
    """The north-star model (5 eclipses x 128 points, 2 bands) and n
    walkers around its start, as chip_smoke.py draws them (seed 0)."""
    model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                        n_points=128, bands=("g", "r")).compile()
    start = model.var_start()
    rng = np.random.default_rng(0)
    pos = torch.tensor(start[None] + 0.001 * np.abs(start)[None]
                       * rng.standard_normal((n, start.size)),
                       dtype=dtype, device=dev)
    return model, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_xl1_kernel_on_the_north_star_and_stress_sets(cuda, dtype):
    """K5 at its kept depth gives ``_xl1_loop``'s bits on the north
    star's 1024 q (one float32 evaluation's, cast) and on chip_smoke.py
    phase 22's stress set (8192: q 0.03-3, a NaN) with q <= 0, 1e3 and
    inf beside it; one call is one ``xl1_kernel`` event and one count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, pos = north_star_walkers(cuda)
    with torch.inference_mode():
        q_ns = model.cv_params(model.full_from_var(pos))[:, 0, 4]
    rng = np.random.default_rng(22)
    q_st = np.r_[rng.uniform(0.03, 3.0, 8189), 0.05, 0.05, np.nan,
                 0.0, -0.3, -1.0, 1e3, np.inf]
    sets = (q_ns.to(dtype).contiguous(),
            torch.tensor(q_st, dtype=dtype, device=cuda))
    for q in sets:
        roche.xl1_kernel(q)
    torch.cuda.synchronize()
    before = roche.XL1_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = [roche.xl1_kernel(q) for q in sets]
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert roche.XL1_LAUNCHES == before + 2
    assert len(names) == 2 and all("xl1_kernel" in n for n in names), names
    for q, k in zip(sets, got):
        assert same_bits(k, tg._xl1_loop(q))
    assert q_ns.numel() == 1024


def test_forward_evaluation_solves_the_inscribed_radius_once(cuda):
    """One forward evaluation (the north star, 256 walkers, float32)
    launches K6 once, on one radius a walker, and its profiler trace
    shows one ``lobe_radius_kernel`` and, inside ``inscribed_radius``, no
    host-to-device copy and no synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from lfit_python_tpu_torch.models import likelihood

    model, pos = north_star_walkers(cuda, n=256)
    lp = make_ln_prob(model, dtype=torch.float32, device=cuda)
    solve = likelihood.inscribed_radius

    def marked(*args, **kw):
        with record_function("inscribed_radius"):
            return solve(*args, **kw)

    with mock.patch.object(likelihood, "inscribed_radius", marked), \
            mock.patch.object(roche, "lobe_radius_kernel",
                              wraps=roche.lobe_radius_kernel) as rec:
        lp(pos)
        torch.cuda.synchronize()
        assert rec.call_count == 1
        assert tuple(rec.call_args.args[0].shape) == (256, 1)
        # a batch not seen before: an eager call (a second call of a
        # batch is captured, which runs the Python twice)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lp(pos[:128])
            torch.cuda.synchronize()
    events = prof.events()
    span = [e for e in events if e.name == "inscribed_radius"
            and e.device_type == DeviceType.CPU]
    assert len(span) == 1
    t0, t1 = span[0].time_range.start, span[0].time_range.end
    inside = [e.name for e in events if e.device_type == DeviceType.CPU
              and t0 <= e.time_range.start <= t1]
    # the span holds the runtime's records (the pole's fills, K6's
    # launch), and no copy (a host tensor's is a cudaMemcpyAsync, with
    # a cudaStreamSynchronize after it) and no sync
    assert "cudaLaunchKernel" in inside, inside
    assert not [n for n in inside if "Memcpy" in n or "Synchronize" in n],\
        inside
    kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
    assert sum("lobe_radius_kernel" in n for n in kernels) == 1


@pytest.mark.parametrize("name", sorted(ROCHE_LOOPS))
def test_roche_kernel_is_one_device_event(cuda, name):
    """One wrapper call is one launch of its kernel and no other device
    event (no copy, no set, no PyTorch kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = roche_inputs(cuda, torch.float32, n=1024)[name]
    fn = getattr(roche, f"{name}_kernel")
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and f"{name}_kernel" in names[0], names


def test_roche_routing_on_the_card(cuda):
    """geometry's xl1, findi and inscribed_radius on CUDA tensors are one
    launch each, with the loops' bits; the wrappers refuse what the
    kernels cannot take."""
    q = torch.linspace(0.05, 1.5, 64, dtype=torch.float32, device=cuda)
    dphi = torch.full_like(q, 0.05)
    before = (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES, roche.LOBE_LAUNCHES)
    x1 = tg.xl1(q)
    pl1 = tg.l1_potential(q, x1)
    i = tg.findi(q, dphi, x1, pl1)
    r = tg.inscribed_radius(q[:, None], x1[:, None], pl1[:, None])
    assert (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES,
            roche.LOBE_LAUNCHES) == (before[0] + 1, before[1] + 1,
                                     before[2] + 1)
    assert torch.equal(x1, tg._xl1_loop(q))
    assert same_bits(i, tg._findi_loop(q, 0.5 * dphi, x1, pl1))
    pole = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    assert r.shape == (64, 1)
    assert torch.equal(r, 0.995 * tg._lobe_loop(
        q[:, None], x1[:, None], pl1[:, None], *pole))
    with pytest.raises(TypeError):
        roche.findi_kernel(q, dphi.double(), x1, pl1)
    with pytest.raises(TypeError):
        roche.xl1_kernel(q.half())
    with pytest.raises(ValueError):
        roche.findi_kernel(q, dphi[:-1], x1, pl1)
    with pytest.raises(ValueError):
        roche.xl1_kernel(torch.stack([q, q], dim=1)[:, 0])
    with pytest.raises(ValueError):
        roche.lobe_radius_kernel(q, x1, pl1, q, q, q.cpu())


@pytest.mark.parametrize("mode", ["float32", "float64", "precise"])
def test_posterior_through_roche_kernels_matches_plain_loops(cuda, mode):
    """ln p and flux at 256 walkers on the north-star tree: the same bits
    through K4-K6 and through the plain loops; findi and xl1 once an
    evaluation (twice in the precise mode), the inscribed radius once."""
    model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                        n_points=128, bands=("g", "r")).compile()
    dtype = torch.float64 if mode == "float64" else torch.float32
    lp = make_ln_prob(model, CVConfig(mixed_precision=mode == "precise"),
                      dtype=dtype, device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(4)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((256, start.size)),
                       dtype=dtype, device=cuda)
    before = (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES, roche.LOBE_LAUNCHES)
    a = lp(pos)
    n_core = 2 if mode == "precise" else 1
    assert (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES, roche.LOBE_LAUNCHES) \
        == (before[0] + n_core, before[1] + n_core, before[2] + 1)
    fa = lp.model_flux(pos)
    with mock.patch.object(roche, "findi_kernel", tg._findi_loop), \
            mock.patch.object(roche, "xl1_kernel", tg._xl1_loop), \
            mock.patch.object(roche, "lobe_radius_kernel", tg._lobe_loop):
        b, fb = lp(pos), lp.model_flux(pos)
    assert int(torch.isfinite(a).sum()) > 128
    assert same_bits(a, b) and same_bits(fa, fb)


# ---- K7, K8: the flux curves' sweeps and their backward kernels --------

def curve_rows(dev, dtype, R, P, N, widths, seed=0):
    """K7's inputs: contact intervals with non-eclipsed elements (dur 0),
    NaN intervals (not eclipsed in row 0, eclipsed in row 1), an interval
    across the wrap at 1; phases on the contacts, a float either side and
    a cycle on; widths at and below the 1e-12 clamp, and 0."""
    rng = np.random.default_rng(seed)
    pin = rng.uniform(-0.06, 0.04, (R, N))
    pout = pin + rng.uniform(0.0, 0.05, (R, N))
    ecl = rng.uniform(size=(R, N)) < 0.75
    mid = 0.5 * (pin + pout)
    pin, pout = np.where(ecl, pin, mid), np.where(ecl, pout, mid)
    if N > 4:
        pin[:, 1], pout[:, 1], ecl[:, 1] = 0.96, 1.02, True
        pin[0, 2] = pout[0, 2] = np.nan
        ecl[0, 2] = False
        pin[1, 3], ecl[1, 3] = np.nan, True
    w = rng.uniform(0.0, 1.0, (R, N))
    w /= w.sum(-1, keepdims=True)
    ph = rng.uniform(-0.15, 0.15, (R, P))
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    pin, pout = pin.astype(np_dt), pout.astype(np_dt)
    for r in range(R):
        vals = [x for n in range(min(N, 6)) for v in (pin[r, n], pout[r, n])
                for x in (v, np.nextafter(v, np_dt(-1)),
                          np.nextafter(v, np_dt(2)), v + np_dt(1))
                if np.isfinite(x)][:P]
        ph[r, :len(vals)] = vals
    wd = None
    if widths:
        wd = np.full((R, P), 0.3 / 127)
        wd[:, :min(P, 3)] = [1e-12, 1e-13, 0.0][:min(P, 3)]

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)
    return (t(ph), None if wd is None else t(wd), t(pin), t(pout),
            torch.tensor(ecl, device=dev), t(w))


def donor_rows(dev, dtype, G, E, P, N, seed=1):
    """K8's inputs: directions at P phases for E rows of each of G grids;
    unit normals, one perpendicular to the first direction (mu exactly 0),
    one facing away (mu < 0), a zero one; areas ~1e-3."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(rng.uniform(70.0, 88.0, (G * E, 1)))
    ph = 2 * np.pi * rng.uniform(-0.5, 0.5, (G * E, P))
    e = np.stack([np.sin(th) * np.cos(ph), -np.sin(th) * np.sin(ph),
                  np.cos(th) * np.ones_like(ph)], axis=-1)
    e[:, 0] = (0.0, 0.0, 1.0)
    n = rng.standard_normal((G, N, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    if N > 3:
        n[:, 0], n[:, 1], n[:, 2] = (1.0, 0.0, 0.0), (0.0, 0.0, -1.0), 0.0
    a = rng.uniform(1e-4, 3e-3, (G, N))
    return tuple(torch.tensor(x, dtype=dtype, device=dev) for x in (e, n, a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("widths", [False, True])
@pytest.mark.parametrize("N,P,R", [(1, 1, 3), (33, 257, 17), (992, 128, 64),
                                   (32, 128, 5120)])
def test_element_curve_kernel_gives_the_plain_bits(cuda, dtype, widths, N, P,
                                                   R):
    """K7 repeats its plain version's operations in its order: the same
    bits (and NaN pattern), the same bits from two launches, one launch a
    call."""
    args = curve_rows(cuda, dtype, R, P, N, widths)
    before = sweeps.CURVE_LAUNCHES
    k = sweeps.element_curve_kernel(*args)
    k2 = sweeps.element_curve_kernel(*args)
    p = sweeps.plain._element_curve_plain(*args)
    assert sweeps.CURVE_LAUNCHES == before + 2
    assert same_bits(k, p) and same_bits(k, k2)
    if widths and N > 4:
        assert bool(torch.isnan(k[1]).all())


def curve_stress_rows(dev, dtype, P, N, widths, seed=14):
    """K7's per-tile paths' stress rows (N past one tile of 256: a short
    last tile): row 0 phases several cycles wide, some at integers as are
    some contacts, intervals across the wrap and longer than a cycle (the
    floor's path); row 1 phases within a cycle of every contact in its
    first tile, d exactly -1, -0 and 0 (the comparison's path), and d >= 1
    in its second; row 2 NaN and infinite phases, contacts and widths;
    row 3 contacts and phases down to the subnormals and a contact 5
    cycles off in its second tile, widths above the quotient's range up to
    where 1 / wc is subnormal, with intervals as long, and a negative
    weight; row 4 row 1 with an infinite weight on an element its phase 0
    occults."""
    rng = np.random.default_rng(seed)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    R = 5
    pin = rng.uniform(-0.5, 0.5, (R, N))
    pout = pin + rng.uniform(0.0, 0.3, (R, N))
    ecl = rng.uniform(size=(R, N)) < 0.8
    ph = np.sort(rng.uniform(-0.2, 0.2, (R, P)), axis=-1)
    ph[0] = np.sort(rng.uniform(-3.5, 3.5, P))
    pout[0, ::7] = pin[0, ::7] + 1.5
    pin[0, 1::9], pout[0, 1::9] = 0.9, 1.1
    ints = np.array([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0])
    ph[0, :6] = ints
    pin[0, 2::5] = np.resize(ints, pin[0, 2::5].size)
    ph[1, :P // 2] = np.resize([-0.5, -0.0, 0.0, 0.25, 0.49], P // 2)
    pin[1, ::3] = np.resize([0.5, 0.0, -0.0, 0.25, -0.25], pin[1, ::3].size)
    pout[1, ::3] = pin[1, ::3] + np.resize([0.0, 0.25, 0.75],
                                           pin[1, ::3].size)
    pin[1, 260], pout[1, 260] = -0.9, -0.6
    ph[4], pin[4], pout[4], ecl[4] = ph[1], pin[1], pout[1], True
    w = rng.uniform(0.0, 1.0, (R, N))
    w[4, 3], w[3, 290] = np.inf, -0.5
    ph[2, :6] = [np.nan, np.inf, -np.inf, np.nan, 0.5, -0.5]
    pin[2, 3:6], pout[2, 3:7] = [np.nan, np.inf, -np.inf], [0.1, np.inf,
                                                          0.2, np.nan]
    ecl[2, 3:7] = True
    tiny = [1e-30, -1e-30, 1e-44, -1e-44, 3e-39]
    pin[3, 256:261] = tiny
    pout[3, 256:261] = np.array(tiny) + np.array([0.0, 1e-30, 0.1, 1e-44,
                                                  0.0])
    ecl[3, 256:261] = True
    pin[3, 266], pout[3, 266] = 5.0, 5.02
    big = 3e38 if dtype == torch.float32 else 1e308
    pin[3, 7:9], pout[3, 7:9], ecl[3, 7:9] = 0.0, big, True
    ph[3, :4] = [1e-30, -1e-44, 2.0 ** -60, 0.0]
    wd = None
    if widths:
        wd = rng.uniform(0.0, 0.05, (R, P))
        wd[2, :3] = [np.nan, np.inf, 0.0]
        wd[3, 4:10] = [2.0 ** 60, 3e38, 1e-30, 0.0, np.inf, big]

    def t(a):
        return torch.tensor(np.asarray(a).astype(np_dt), dtype=dtype,
                            device=dev)
    return (t(ph), None if wd is None else t(wd), t(pin), t(pout),
            torch.tensor(ecl, device=dev), t(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("widths", [False, True])
@pytest.mark.parametrize("N,P", [(300, 64), (600, 128), (300, 300)])
def test_element_curve_kernel_on_the_stress_rows(cuda, dtype, widths, N, P):
    """K7's fast paths (the comparison for the floor where a tile's phases
    are within a cycle of its contacts, the reciprocal for the width's
    divide) and their fallbacks on curve_stress_rows: the plain version's
    bits and NaN pattern, two launches alike (P = 300: three blocks of
    phases, each with its own range)."""
    args = curve_stress_rows(cuda, dtype, P, N, widths)
    k = sweeps.element_curve_kernel(*args)
    k2 = sweeps.element_curve_kernel(*args)
    p = sweeps.plain._element_curve_plain(*args)
    assert same_bits(k, p) and same_bits(k, k2)
    ok = ~torch.isnan(p)
    ints = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(k[ok].view(ints), p[ok].view(ints))   # signed zeros
    assert bool(torch.isnan(p[4]).any()) and bool(torch.isinf(p[4]).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,P,E,G", [(1, 1, 1, 2), (33, 257, 1, 3),
                                     (384, 128, 5, 1024), (384, 1, 5, 64),
                                     (384, 257, 1, 64), (384, 1, 5, 1024),
                                     (1000, 7, 2, 5)])
def test_donor_sum_kernel_gives_the_plain_bits(cuda, dtype, N, P, E, G):
    e, n, a = donor_rows(cuda, dtype, G, E, P, N)
    before = sweeps.DONOR_LAUNCHES
    for u in (0.9, 0.37):
        k = sweeps.donor_sum_kernel(e, n, a, u)
        assert same_bits(k, sweeps.donor_sum_kernel(e, n, a, u))
        assert same_bits(k, sweeps.plain._donor_sum_plain(e, n, a, u))
    assert sweeps.DONOR_LAUNCHES == before + 4


def _f32_gate(k32, p32, p64):
    """Each entry within 1e-5 + 2e-3 |g| of plain float32, or no farther
    from plain float64 than plain float32's largest distance from it."""
    assert torch.equal(torch.isnan(k32), torch.isnan(p32))
    k32, p32 = torch.nan_to_num(k32), torch.nan_to_num(p32)
    p64 = torch.nan_to_num(p64)
    near = (k32 - p32).abs() <= 1e-5 + 2e-3 * p32.abs()
    lim = float((p32.double() - p64).abs().max())
    return bool((near | ((k32.double() - p64).abs() <= lim)).all())


def _f64_close(k, p):
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    scale = max(float(torch.nan_to_num(p).abs().max()), 1e-300)
    return float(torch.nan_to_num(k - p).abs().max()) <= 1e-9 * scale


@pytest.mark.parametrize("widths", [False, True])
@pytest.mark.parametrize("N,P,R", [(1, 1, 3), (33, 257, 17),
                                   (992, 128, 64), (1100, 300, 4)])
def test_element_curve_backward_kernel_matches_autograd(cuda, widths, N, P,
                                                        R):
    """K7's backward kernel against autograd on the plain forward: float64
    within 1e-9 of the largest |gradient|, float32 at PERF.md's gate; two
    launches the same bits (N = 1100: two passes of a block's warps; P =
    300: three tiles of staged phases)."""
    grads = {}
    for dtype in (torch.float64, torch.float32):
        args = curve_rows(cuda, dtype, R, P, N, widths)
        g = torch.tensor(np.random.default_rng(2).standard_normal((R, P)),
                         dtype=dtype, device=cuda)
        k = sweeps.element_curve_backward_kernel(*args, g)
        k2 = sweeps.element_curve_backward_kernel(*args, g)
        p = sweeps._curve_backward_plain(*args, g)
        grads[dtype] = k, p
        for a, b in zip(k, k2):
            assert (a is None) == (b is None)
            assert a is None or same_bits(a, b)
    for i in range(4):
        k64, p64 = (x[i] for x in grads[torch.float64])
        k32, p32 = (x[i] for x in grads[torch.float32])
        assert (k64 is None) == (p64 is None) == (not widths and i < 3)
        if k64 is not None:
            assert _f64_close(k64, p64), i
            assert _f32_gate(k32, p32, p64), i


@pytest.mark.parametrize("N,P,E,G", [(1, 1, 1, 2), (33, 257, 1, 3),
                                     (384, 128, 5, 256), (384, 1, 5, 64),
                                     (384, 1, 5, 256), (992, 128, 5, 16),
                                     (2000, 257, 1, 3), (100, 1, 1, 7)])
def test_donor_sum_backward_kernel_matches_autograd(cuda, N, P, E, G):
    """K8's fused backward against autograd on the plain forward: float64
    within 1e-9 of the largest |gradient|, float32 at PERF.md's gate, two
    launches the same bits; the main call's shape and the normaliser's (P
    = 1), N = 2000 in two passes of the slab groups."""
    grads = {}
    for dtype in (torch.float64, torch.float32):
        e, n, a = donor_rows(cuda, dtype, G, E, P, N)
        g = torch.tensor(np.random.default_rng(3).standard_normal(
            (G * E, P)), dtype=dtype, device=cuda)
        k = sweeps.donor_sum_backward_kernel(e, n, a, 0.9, g)
        k2 = sweeps.donor_sum_backward_kernel(e, n, a, 0.9, g)
        assert all(same_bits(x, y) for x, y in zip(k, k2))
        grads[dtype] = k, sweeps._donor_backward_plain(e, n, a, 0.9, g)
    for i in range(3):
        k64, p64 = (x[i] for x in grads[torch.float64])
        k32, p32 = (x[i] for x in grads[torch.float32])
        assert _f64_close(k64, p64), i
        assert _f32_gate(k32, p32, p64), i


def test_sweep_kernels_are_one_device_event_each(cuda):
    """One call of each of the four wrappers is one launch of its kernel
    and no other device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    c = curve_rows(cuda, torch.float32, 64, 128, 992, True)
    ci = curve_rows(cuda, torch.float32, 64, 128, 992, False)
    gc = torch.ones_like(c[0])
    e, n, a = donor_rows(cuda, torch.float32, 64, 5, 128, 384)
    ge = torch.ones(e.shape[:2], dtype=e.dtype, device=cuda)
    e1, n1, a1 = donor_rows(cuda, torch.float32, 64, 5, 1, 384)
    ge1 = torch.ones(e1.shape[:2], dtype=e1.dtype, device=cuda)
    calls = [
        ("element_curve_kernel", lambda: sweeps.element_curve_kernel(*c)),
        ("element_curve_kernel", lambda: sweeps.element_curve_kernel(*ci)),
        ("element_curve_backward_kernel",
         lambda: sweeps.element_curve_backward_kernel(*c, gc)),
        ("donor_sum_kernel", lambda: sweeps.donor_sum_kernel(e, n, a, 0.9)),
        ("donor_sum_backward_kernel",
         lambda: sweeps.donor_sum_backward_kernel(e, n, a, 0.9, ge)),
        ("donor_sum_backward_kernel",
         lambda: sweeps.donor_sum_backward_kernel(e1, n1, a1, 0.9, ge1))]
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        # a window opened after many untraced launches may lose its first
        # kernel records: a spin kernel goes first
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and "spin_kernel" not in ev.name]
        assert len(names) == 1 and name in names[0], (name, names)


def test_sweep_kernels_keep_nothing_in_local_memory(cuda):
    """ptxas's report of the sweeps library: each of the 14
    instantiations (K7 and its backward in two dtypes with and without
    widths, K8 in two dtypes and layouts, K8's backward in two dtypes)
    has no stack frame and spills nothing."""
    import re

    from lfit_python_tpu_torch.ops import _build

    sweeps._kernel()
    entries, cur = {}, None
    for line in _build.PTXAS_LOGS["sweeps"].read_text().splitlines():
        m = re.search(r"Compiling entry function '(_Z\d+(element_curve|"
                      r"donor_sum)\w*)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if cur and m:
            entries[cur] = tuple(int(x) for x in m.groups())
    assert len(entries) == 14, sorted(entries)
    assert all(v == (0, 0, 0) for v in entries.values()), entries


def test_sweeps_routing_on_the_card(cuda):
    """element_flux_curve and donor_flux on CUDA tensors launch K7 and K8
    (the plain sweeps never run); under inference_mode nothing is saved;
    the widths take no gradient; the wrappers refuse what the kernels
    cannot take."""
    c = curve_rows(cuda, torch.float32, 8, 16, 40, True)
    with mock.patch.object(sweeps.plain, "_element_curve_plain",
                           side_effect=AssertionError("plain K7 ran")), \
            mock.patch.object(sweeps.plain, "_donor_sum_plain",
                              side_effect=AssertionError("plain K8 ran")):
        leaves = [c[0].clone().requires_grad_(), c[1], c[2], c[3], c[4],
                  c[5].clone().requires_grad_()]
        with torch.inference_mode():
            out = sweeps.element_curve(*leaves)
        assert out.grad_fn is None
        out = sweeps.element_curve(*leaves)
        before = sweeps.CURVE_BACKWARD_LAUNCHES
        out.sum().backward()
        assert sweeps.CURVE_BACKWARD_LAUNCHES == before + 1
        assert leaves[0].grad is not None and leaves[5].grad is not None
        e, n, a = donor_rows(cuda, torch.float32, 2, 3, 8, 40)
        with torch.inference_mode():
            assert sweeps.donor_sum(e.requires_grad_(), n, a, 0.9).grad_fn \
                is None
    with pytest.raises(ValueError, match="widths"):
        sweeps.element_curve(c[0], c[1].clone().requires_grad_(), *c[2:])
    with pytest.raises(TypeError):
        sweeps.element_curve_kernel(c[0].double(), *c[1:])
    with pytest.raises(ValueError):
        sweeps.element_curve_kernel(c[0], c[1], c[2].cpu(), *c[3:])
    with pytest.raises(ValueError):
        sweeps.donor_sum_kernel(e[:5], n, a, 0.9)
    with pytest.raises(TypeError):
        sweeps.donor_sum_kernel(e, n, a, torch.tensor(0.9))


@pytest.mark.parametrize("mode", ["float32", "float64", "precise"])
def test_posterior_through_the_sweep_kernels_matches_plain(cuda, mode):
    """ln p and flux at 256 walkers on the north-star tree: the same bits
    through K7 and K8 and through their plain versions; K7 and K8 twice an
    evaluation."""
    model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                        n_points=128, bands=("g", "r")).compile()
    dtype = torch.float64 if mode == "float64" else torch.float32
    lp = make_ln_prob(model, CVConfig(mixed_precision=mode == "precise"),
                      dtype=dtype, device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(4)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((256, start.size)),
                       dtype=dtype, device=cuda)
    before = (sweeps.CURVE_LAUNCHES, sweeps.DONOR_LAUNCHES)
    a = lp(pos)
    assert (sweeps.CURVE_LAUNCHES, sweeps.DONOR_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    fa = lp.model_flux(pos)
    with mock.patch.object(sweeps, "element_curve",
                           sweeps.plain._element_curve_plain), \
            mock.patch.object(sweeps, "donor_sum",
                              sweeps.plain._donor_sum_plain):
        b, fb = lp(pos), lp.model_flux(pos)
    assert int(torch.isfinite(a).sum()) > 128
    assert same_bits(a, b) and same_bits(fa, fb)


def test_gradient_through_the_sweep_kernels_matches_plain(cuda):
    """value_and_grad at 256 chains on the widths model: ln p the plain
    sweeps' bits, the gradient within PERF.md's gate of autograd on the
    plain sweeps (float64 as referee); K7, K8 and their backward kernels
    twice an evaluation."""
    model = with_calib_widths(build_model(
        n_eclipses=5, complex_spot=[False] * 5, n_points=128,
        bands=("g", "r"))).compile()
    start = model.var_start()
    rng = np.random.default_rng(5)
    pos = start[None] + 1e-3 * np.abs(start)[None] * rng.standard_normal(
        (256, start.size))
    out = {}
    for dtype in (torch.float32, torch.float64):
        lp = make_ln_prob(model, dtype=dtype, device=cuda)
        p = torch.tensor(pos, dtype=dtype, device=cuda)
        before = (sweeps.CURVE_LAUNCHES, sweeps.CURVE_BACKWARD_LAUNCHES,
                  sweeps.DONOR_LAUNCHES, sweeps.DONOR_BACKWARD_LAUNCHES)
        k = lp.value_and_grad(p)
        after = (sweeps.CURVE_LAUNCHES, sweeps.CURVE_BACKWARD_LAUNCHES,
                 sweeps.DONOR_LAUNCHES, sweeps.DONOR_BACKWARD_LAUNCHES)
        assert [y - x for x, y in zip(before, after)] == [2, 2, 2, 2]
        with mock.patch.object(sweeps, "element_curve",
                               sweeps.plain._element_curve_plain), \
                mock.patch.object(sweeps, "donor_sum",
                                  sweeps.plain._donor_sum_plain):
            out[dtype] = k, lp.value_and_grad(p)
    (v32, g32), (pv32, pg32) = out[torch.float32]
    (v64, g64), (pv64, pg64) = out[torch.float64]
    assert same_bits(v32, pv32) and same_bits(v64, pv64)
    assert bool(torch.isfinite(g32).all())
    assert _f64_close(g64, pg64)
    assert _f32_gate(g32, pg32, pg64)


# ---- K9, K10: the donor grid's radius solve, the white dwarf's sweep ----

def wd_rows(dev, dtype, W=64, E=3, P=96, seed=9):
    """K10's inputs as the posterior hands them: (W, E, P) phases across
    ingress, egress, mid-eclipse and out of eclipse, (W, E, 1) columns of
    a parameter table (q, rwd, ulimb) and (W, 1, 1) walkers (incl, x1,
    pl1, r_ins); q 0.03-3.5, inclinations 75-90 deg (rays that miss the
    donor among them), rwd 0.005-0.03 with rows at 0.2 and 1e-4."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(np.r_[rng.uniform(0.03, 3.5, W - 2), 0.03, 3.5],
                     dtype=dtype, device=dev)
    x1 = tg.xl1(q)
    pl1 = tg.l1_potential(q, x1)
    r_ins = tg.inscribed_radius(q, x1, pl1)
    incl = torch.tensor(rng.uniform(75.0, 90.0, W), dtype=dtype, device=dev)
    table = torch.tensor(rng.uniform(0.1, 0.6, (W, E, 14)), dtype=dtype,
                         device=dev)
    table[..., 4] = q[:, None]
    table[..., 8] = torch.tensor(rng.uniform(0.005, 0.03, (W, E)),
                                 dtype=dtype, device=dev)
    table[::7, :, 8] = 0.2
    table[1::7, :, 8] = 1e-4
    ph = torch.tensor(np.linspace(-0.15, 0.15, P)[None, None, :]
                      + rng.uniform(-0.003, 0.003, (W, E, 1)),
                      dtype=dtype, device=dev)
    col = [a[:, None, None] for a in (incl, x1, pl1, r_ins)]
    return (table[..., 4:5], col[0], ph, table[..., 8:9], table[..., 7:8],
            col[1], col[2], col[3])


def donor_walkers(dev, dtype, W=64, seed=9):
    q = torch.tensor(np.random.default_rng(seed).uniform(0.03, 3.5, W),
                     dtype=dtype, device=dev)
    x1 = tg.xl1(q)
    return q, x1, tg.l1_potential(q, x1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_donor_grid_kernel_bit_identical(cuda, dtype):
    """K9 at 64 walkers x 16 x 24 directions: the grid (a forward
    evaluation's launch), and the radius and its slope (a recorded
    graph's), the plain grid's and the plain loop's bits; one launch
    each."""
    q, x1, pl1 = donor_walkers(cuda, dtype)
    dirs = comp._directions(16, 24, dtype, cuda)
    before = wd_donor.DONOR_GRID_LAUNCHES
    none, none2, grid = wd_donor.donor_grid_kernel(q, x1, pl1, *dirs)
    r, slope, none3 = wd_donor.donor_grid_kernel(q, x1, pl1, *dirs,
                                                 grid=False)
    assert none is none2 is none3 is None
    assert wd_donor.DONOR_GRID_LAUNCHES == before + 2
    r0, slope0 = comp._donor_radius_loop(q, x1, pl1, *dirs[:3])
    grid0 = comp._donor_grid_plain(r0, (q / (1.0 + q))[:, None], *dirs)
    torch.cuda.synchronize()
    for a, b in zip((r, slope, *grid), (r0, slope0, *grid0)):
        assert a.shape == b.shape and same_bits(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wd_curve_kernel_bit_identical(cuda, dtype):
    """K10 on (64, 3, 96) points with per-row and per-walker parameters
    read in place: the fraction the plain chain's bits, and the distance
    mode the plain distance's (d and the clearance); both the bits of
    the same inputs broadcast and copied; one launch each."""
    args = wd_rows(cuda, dtype)
    before = wd_donor.WD_LAUNCHES
    y = wd_donor.wd_curve_kernel(*args)
    dist = (args[0], args[1], args[2], args[5], args[6])
    d, clear = wd_donor.wd_distance_kernel(*dist)
    assert wd_donor.WD_LAUNCHES == before + 2
    torch.cuda.synchronize()
    assert same_bits(y, comp._wd_curve_plain(*args))
    d0, clear0 = tg._shadow_distance_plain(*dist)
    assert same_bits(d, d0) and same_bits(clear, clear0)
    assert int((clear == 10.0).sum()) > 0 and bool(torch.isfinite(y).all())
    assert int((y == 0).sum()) and int((y == 1).sum()) \
        and int(((y > 0) & (y < 1)).sum())
    shape = y.shape
    copied = [a.expand(shape).contiguous() for a in args]
    assert same_bits(y, wd_donor.wd_curve_kernel(*copied))


# K10's row lengths: fewer phases than a warp, a warp's, between, the
# north star's 128 and around it, and the widths' P * n_sub (128 x 3); K9's
# grids (n_lat, n_lon): fewer directions than a block, a few, more than a
# block's chunk
WD_PHASES = (1, 2, 5, 31, 32, 33, 127, 128, 129, 384)
DONOR_GRIDS = ((6, 8), (5, 7), (3, 3), (32, 48))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", WD_PHASES)
def test_wd_curve_kernel_row_lengths(cuda, P, dtype):
    """K10 in both modes at each row length, on 37 x 3 rows (not a
    multiple of a block's rows), the first P of wd_rows' phases (and, at
    P = 1, points whose parameters vary along the last axis, the
    changepoints' layout): the plain chains' bits."""
    args = list(wd_rows(cuda, dtype, W=37, P=max(P, 8)))
    args[2] = args[2][..., :P].contiguous()
    if P == 1:
        args[2] = args[2][..., 0]
        args = [a[..., 0] for a in args[:2]] + [args[2]] + [
            a[..., 0] for a in args[3:]]
    y = wd_donor.wd_curve_kernel(*args)
    dist = (args[0], args[1], args[2], args[5], args[6])
    d, clear = wd_donor.wd_distance_kernel(*dist)
    torch.cuda.synchronize()
    assert same_bits(y, comp._wd_curve_plain(*args))
    d0, clear0 = tg._shadow_distance_plain(*dist)
    assert same_bits(d, d0) and same_bits(clear, clear0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", DONOR_GRIDS)
def test_donor_grid_kernel_grids(cuda, grid, dtype):
    """K9 at odd grids on 13 walkers (not a multiple of a block's): the
    grid, and the radius and its slope, the plain versions' bits."""
    q, x1, pl1 = donor_walkers(cuda, dtype, W=13)
    dirs = comp._directions(*grid, dtype, cuda)
    grid_k = wd_donor.donor_grid_kernel(q, x1, pl1, *dirs)[2]
    r, slope, _ = wd_donor.donor_grid_kernel(q, x1, pl1, *dirs, grid=False)
    r0, slope0 = comp._donor_radius_loop(q, x1, pl1, *dirs[:3])
    grid0 = comp._donor_grid_plain(r0, (q / (1.0 + q))[:, None], *dirs)
    torch.cuda.synchronize()
    for a, b in zip((r, slope, *grid_k), (r0, slope0, *grid0)):
        assert a.shape == b.shape and same_bits(a, b)


def test_wd_donor_kernels_are_one_device_event(cuda):
    """One wrapper call of K9 and of K10 is one launch of its kernel and
    no other device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, x1, pl1 = donor_walkers(cuda, torch.float32)
    dirs = comp._directions(16, 24, torch.float32, cuda)
    args = wd_rows(cuda, torch.float32)
    calls = {"donor_grid_kernel": lambda: wd_donor.donor_grid_kernel(
                 q, x1, pl1, *dirs),
             "wd_curve_kernel": lambda: wd_donor.wd_curve_kernel(*args)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        assert len(names) == 1 and name in names[0], names


def test_wd_donor_routing_on_the_card(cuda):
    """wd_flux and donor_grid on CUDA tensors are one launch each with
    the plain chains' bits; with a gradient recorded wd_flux launches
    nothing and donor_grid launches K9 for the radius alone, with the
    plain loop's gradient; wd_flux with a Python number raises and the
    wrappers refuse what the kernels cannot take."""
    args = wd_rows(cuda, torch.float32)
    before = (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES)
    y = comp.wd_flux(*args[:7], r_ins=args[7])
    q, x1, pl1 = (a[:, None] for a in donor_walkers(cuda, torch.float32))
    grid = comp.donor_grid(q, x1, pl1, 6, 8)
    assert (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    plain = mock.patch.object(tg, "_on_card", lambda t: False)
    with plain:
        assert same_bits(y, comp.wd_flux(*args[:7], r_ins=args[7]))
        grid0 = comp.donor_grid(q, x1, pl1, 6, 8)
    assert all(same_bits(a, b) for a, b in zip(grid, grid0))
    leaf = q.clone().requires_grad_()
    comp.wd_flux(leaf[..., None], *args[1:7], r_ins=args[7]).sum()
    g = torch.autograd.grad(comp.donor_grid(leaf, x1, pl1, 6, 8).areas.sum(),
                            leaf)[0]
    assert (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES) == (
        before[0] + 2, before[1] + 1)
    with plain:
        g0 = torch.autograd.grad(comp.donor_grid(
            leaf, x1, pl1, 6, 8).areas.sum(), leaf)[0]
    assert same_bits(g, g0)
    with pytest.raises(TypeError, match="ulimb is not a tensor"):
        comp.wd_flux(*args[:4], 0.3, *args[5:7], r_ins=args[7])
    assert wd_donor.WD_LAUNCHES == before[1] + 1
    with pytest.raises(TypeError):
        wd_donor.wd_curve_kernel(*args[:3], args[3].double(), *args[4:])
    with pytest.raises(ValueError):
        wd_donor.wd_curve_kernel(*args[:3], args[3].cpu(), *args[4:])
    with pytest.raises(ValueError):
        wd_donor.donor_grid_kernel(q[:, 0], x1[:, 0], pl1[:-1, 0],
                                   *comp._directions(6, 8, torch.float32,
                                                     cuda))


@pytest.mark.parametrize("mode", ["float32", "float64", "precise", "gp"])
def test_posterior_through_the_wd_donor_kernels_matches_plain(cuda, mode):
    """ln p and flux at 256 walkers on the north-star tree (with use_gp
    on every eclipse for "gp"): the same bits through K9 / K10 and
    through the plain chains; K9 once an evaluation, K10 once (0 in the
    precise mode, 2 more for the GP changepoints)."""
    model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                        use_gp=mode == "gp", n_points=128,
                        bands=("g", "r")).compile()
    dtype = torch.float64 if mode == "float64" else torch.float32
    lp = make_ln_prob(model, CVConfig(mixed_precision=mode == "precise"),
                      dtype=dtype, device=cuda)
    start = model.var_start()
    rng = np.random.default_rng(4)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((256, start.size)),
                       dtype=dtype, device=cuda)
    before = (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES)
    a = lp(pos)
    k10 = {"precise": 0, "gp": 3}.get(mode, 1)
    assert (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES) == (
        before[0] + 1, before[1] + k10)
    fa = lp.model_flux(pos)
    with mock.patch.object(tg, "_on_card", lambda t: False):
        b, fb = lp(pos), lp.model_flux(pos)
    assert int(torch.isfinite(a).sum()) > 128
    assert same_bits(a, b) and same_bits(fa, fb)


def test_gradient_through_the_wd_donor_kernels_matches_plain(cuda):
    """value_and_grad at 256 chains on the widths model: K9 once (its
    radius and slope), K10 never; ln p and the gradient the plain
    chains' bits."""
    model = with_calib_widths(build_model(
        n_eclipses=5, complex_spot=[False] * 5, n_points=128,
        bands=("g", "r"))).compile()
    start = model.var_start()
    rng = np.random.default_rng(5)
    lp = make_ln_prob(model, dtype=torch.float32, device=cuda)
    p = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                     * rng.standard_normal((256, start.size)),
                     dtype=torch.float32, device=cuda)
    before = (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES)
    v, g = lp.value_and_grad(p)
    assert (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES) == (
        before[0] + 1, before[1])
    with mock.patch.object(tg, "_on_card", lambda t: False):
        v0, g0 = lp.value_and_grad(p)
    assert same_bits(v, v0) and same_bits(g, g0)


# ---- the posterior's forward calls replayed from CUDA graphs -------------

def bench_walkers(dev, config, n=64, seed=2 ** 31 + 5):
    """The benchmark's configuration ``config`` (its light curves from
    ``seed``) as the port's posterior, and ``n`` walkers of its start
    ball."""
    import json

    from lfit_bench import run as bench
    from lfit_bench.reference import spec

    cfg = json.loads((bench.HERE / "configs" / f"{config}.json")
                     .read_text())
    model, post = bench.program(cfg, spec.light_curves(cfg, seed), dev)
    start = torch.tensor(model.var_start(), dtype=post.dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    noise = torch.randn((n, start.numel()), generator=gen,
                        dtype=post.dtype, device=dev)
    return post, start + 1e-3 * torch.clamp(start.abs(), min=1e-2) * noise


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("config", ["hier5_calib", "prod10_gp"])
@pytest.mark.parametrize("entry", ["__call__", "parts", "ln_prior"])
def test_a_replay_gives_the_eager_bits(cuda, config, entry):
    """Both benchmark configurations at 64 walkers: the first call of a
    batch (eager), the second (its warm-up, then the capture) and the
    replays after it give the eager evaluation's bits, on two inputs of
    the one shape in turns."""
    post, pos = bench_walkers(cuda, config)
    other = pos.flip(0).contiguous()
    fn = getattr(post, entry)
    inner = {"__call__": post._ln_prob, "parts": post._parts,
             "ln_prior": post._ln_prior}[entry]
    with torch.inference_mode():
        want = {0: inner(pos), 1: inner(other)}
    got = [(k, fn(x)) for k, x in enumerate((pos, other, pos, other, pos))]
    assert len(post._graphs.graphs) == 1
    for k, out in got:
        assert all(same_bits(a, b) for a, b in zip(_outs(out),
                                                   _outs(want[k % 2])))
    assert bool(torch.isfinite(_outs(want[0])[0]).any())


def test_two_replays_return_outputs_that_are_not_aliased(cuda):
    """A replay returns clones: the first half's ln p survives the second
    half's replay (the stretch move's two calls a step)."""
    post, pos = bench_walkers(cuda, "hier5_calib")
    other = pos.flip(0).contiguous()
    post.parts(pos), post.parts(pos)
    a, b = post.parts(pos), post.parts(other)
    with torch.inference_mode():
        want = post._parts(pos)
    assert all(x.data_ptr() != y.data_ptr() for x in a for y in b)
    assert all(same_bits(x, y) for x, y in zip(a, want))


@pytest.mark.parametrize("config", ["hier5_calib", "prod10_gp"])
def test_launch_counters_count_each_replay(cuda, config):
    """The kernel wrappers' counters advance by the eager call's launches
    at the capture's call (its warm-up; the capture runs nothing) and at
    each replay: K1 and K2 once a call, K7 twice, K3 once with the GP."""
    from lfit_python_tpu_torch import ops

    post, pos = bench_walkers(cuda, config)

    def counted():
        before = ops.launch_counts()
        post(pos)
        return tuple(a - b for a, b in zip(ops.launch_counts(), before))

    eager = counted()
    assert [counted() for _ in range(3)] == [eager] * 3
    (replay,) = post._graphs.graphs.values()
    assert replay.launches == eager
    names = [(m.__name__.rsplit(".", 1)[1], n)
             for m, n in ops._all_counters()]
    per_call = dict(zip(names, eager))
    assert per_call["contacts", "LAUNCHES"] == 1
    assert per_call["stream", "LAUNCHES"] == 1
    assert per_call["sweeps", "CURVE_LAUNCHES"] == 2
    assert per_call["gp", "LAUNCHES"] == (config == "prod10_gp")


def test_value_and_grad_stays_eager_on_the_card(cuda):
    """Past the cache's cap on keys (four forward batches captured first)
    a gradient evaluation stays eager on the card, with the eager
    evaluation's bits."""
    from lfit_python_tpu_torch.models import graphs

    post, pos = bench_walkers(cuda, "hier5_calib", n=16)
    for n in range(1, graphs.MAX_GRAPHS + 1):
        post(pos[:n]), post(pos[:n])
    assert len(post._graphs.graphs) == graphs.MAX_GRAPHS
    want = post._value_and_grad(pos)
    for _ in range(3):
        out = post.value_and_grad(pos)
        assert all(same_bits(a, b) for a, b in zip(out, want))
    assert all(k[0] != "value_and_grad" for k in post._graphs.graphs)


def test_a_replayed_value_and_grad_gives_the_eager_bits(cuda):
    """The north star's gradient at the HMC cell's 256 chains: the first
    call eager, the second its warm-up then the capture (forward and
    backward in one graph), the replays after it, each the eager
    evaluation's bits on two inputs of the one shape in turns; outputs
    not aliased from one replay to the next."""
    post, pos = bench_walkers(cuda, "hier5_calib", n=256)
    other = pos.flip(0).contiguous()
    want = {0: post._value_and_grad(pos), 1: post._value_and_grad(other)}
    got = [(k % 2, post.value_and_grad(x))
           for k, x in enumerate((pos, other, pos, other, pos))]
    assert list(post._graphs.graphs) == [
        ("value_and_grad", (256, pos.shape[1]), pos.dtype, pos.device)]
    for k, out in got:
        assert all(same_bits(a, b) for a, b in zip(out, want[k]))
    assert all(a.data_ptr() != b.data_ptr()
               for a in got[-2][1] for b in got[-1][1])
    assert bool(torch.isfinite(want[0][0]).all())
    assert bool((want[0][1] != 0).any())


def test_launch_counters_count_each_gradient_replay(cuda):
    """A gradient replay adds the eager gradient evaluation's launches,
    forward and backward: K1 and its backward, K2 with its sensitivities,
    K7 and K7's backward twice each, K8 and K8's backward twice each."""
    from lfit_python_tpu_torch import ops

    post, pos = bench_walkers(cuda, "hier5_calib", n=64)

    def counted():
        before = ops.launch_counts()
        post.value_and_grad(pos)
        return tuple(a - b for a, b in zip(ops.launch_counts(), before))

    eager = counted()
    assert [counted() for _ in range(3)] == [eager] * 3
    (replay,) = post._graphs.graphs.values()
    assert replay.launches == eager
    names = [(m.__name__.rsplit(".", 1)[1], n)
             for m, n in ops._all_counters()]
    per_call = dict(zip(names, eager))
    assert per_call["contacts", "LAUNCHES"] == 1
    assert per_call["contacts", "BACKWARD_LAUNCHES"] == 1
    assert per_call["stream", "SENS_LAUNCHES"] == 1
    assert per_call["sweeps", "CURVE_LAUNCHES"] == 2
    assert per_call["sweeps", "CURVE_BACKWARD_LAUNCHES"] == 2
    assert per_call["sweeps", "DONOR_LAUNCHES"] == 2
    assert per_call["sweeps", "DONOR_BACKWARD_LAUNCHES"] == 2
