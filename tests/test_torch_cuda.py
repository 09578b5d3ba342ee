"""The CUDA kernel K1 on the card, against its plain PyTorch version.

Every test here needs a CUDA card (the kernel has no CPU form) and skips
without one.  The file imports nothing of JAX, so on a machine with the
card it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

from unittest import mock

import numpy as np
import pytest
import torch

from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.ops import contacts
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
