"""The CUDA kernels K1 (contacts) and K2 (gas stream) on the card, against
their plain PyTorch versions, and the posterior and its gradient through
them.

Every test here needs a CUDA card (the kernels have no CPU form) and skips
without one.  The file imports nothing of JAX, so on a machine with the
card it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

from unittest import mock

import numpy as np
import pytest
import torch

from lfit_python_tpu_torch.examples import build_model, with_calib_widths
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.ops import contacts, stream
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


@pytest.mark.parametrize("case", ["all eclipsed", "all visible", "n = 37",
                                  "n = 300", "infeasible row"])
def test_kernel_on_edge_rows(cuda, case):
    args = special_rows(cuda, case)
    k = contacts.element_intervals_kernel(*args)
    p = contacts.element_intervals_plain(*args)
    torch.cuda.synchronize()
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
    if bool(m.any()):
        assert float((k[0] - p[0]).abs()[m].max()) <= 1e-5
        assert float((k[1] - p[1]).abs()[m].max()) <= 1e-5
    # a visible element's interval is empty, at phi_c, as in plain
    assert torch.equal(k[0][~m], k[1][~m])
    if not bool(m.all()):
        assert float((k[0] - p[0]).abs()[~m].max()) <= 1e-6


def test_kernel_checks_inputs(cuda):
    args = contact_rows(cuda, rows=4)
    with pytest.raises(TypeError):
        contacts.element_intervals_kernel(*[a.double() for a in args])
    with pytest.raises(ValueError):
        contacts.element_intervals_kernel(args[0][:-1], *args[1:])
    with pytest.raises(ValueError):
        contacts.element_intervals_kernel(args[0].cpu(), *args[1:])
    strided = torch.stack([args[2], args[2]], dim=-1)[..., 0]
    with pytest.raises(ValueError):
        contacts.element_intervals_kernel(*args[:2], strided, *args[3:])


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
