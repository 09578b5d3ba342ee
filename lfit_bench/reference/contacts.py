"""The contact-interval solve in plain PyTorch, with its IFT gradient: the
benchmark's frozen copy of the PyTorch port's plain contact path (which
follows ``lfit_python_tpu/ops/pallas_contacts.py`` and the JAX package's
``roche/geometry.py::_contact_interval_impl``).  Rows are flattened
(walker, eclipse) pairs:

    q, incl, x1, pl1, r_ins : (R,)   per-row scalars
    px, py                  : (R, N) orbital-plane element coordinates

and each function returns ``(phi_in, phi_out, eclipsed)``, each (R, N).
"""

from __future__ import annotations

import math

import torch

from .geometry import _edge_residual, contact_interval

__all__ = ["element_intervals_plain", "element_intervals_diff"]


def element_intervals_plain(q, incl, px, py, x1, pl1, r_ins):
    """Contact intervals (:func:`~.geometry.contact_interval` broadcast
    over rows and elements), in the inputs' dtype."""
    col = (lambda a: a[:, None])
    return contact_interval(col(q), col(incl), px, py, col(x1), col(pl1),
                            col(r_ins))


def _contact_backward_plain(q, incl, px, py, x1, pl1, phi_in, phi_out, ecl,
                            g_in, g_out):
    """The gradients of the contact phases in (q, incl, px, py, x1, pl1)
    for the cotangents ``g_in``, ``g_out``: the residual at the roots of
    both edges at once, dc/dphi's value (non-finite coefficients zeroed)
    and the VJP of c by autograd."""
    zero = torch.zeros_like(g_in)
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_()
                  for a in (q, incl, px, py, x1, pl1)]
        lq, li, lpx, lpy, lx1, lpl1 = leaves
        row = (lambda a: a[:, None, None])
        phi = torch.stack([phi_in, phi_out], dim=-1)     # (R, N, 2)
        c, dcdphi = _edge_residual(phi, row(lq), row(li), lpx[..., None],
                                   lpy[..., None], row(lx1), row(lpl1))
        coeff = -1.0 / dcdphi.detach()
        coeff = torch.where(torch.isfinite(coeff), coeff,
                            torch.zeros_like(coeff))
        g = torch.stack([torch.where(ecl, g_in, zero),
                         torch.where(ecl, g_out, zero)], dim=-1)
        grads = torch.autograd.grad(c, leaves, g * coeff,
                                    allow_unused=True)
    grads = [torch.zeros_like(a) if d is None else d
             for a, d in zip(leaves, grads)]
    # never-eclipsed: phi_in = phi_out = atan2(py, 1 - px) / 2 pi
    g_c = torch.where(ecl, zero, g_in + g_out) / (2.0 * math.pi)
    wx = 1.0 - px
    r2 = wx * wx + py * py
    grads[2] = grads[2] + g_c * py / r2
    grads[3] = grads[3] + g_c * wx / r2
    return tuple(grads)


class _ContactIntervals(torch.autograd.Function):
    """:func:`element_intervals_plain` with IFT gradients: at a contact
    root phi* of c(phi; theta) = 0, dphi*/dtheta = -(dc/dtheta) /
    (dc/dphi).  Non-eclipsed elements carry phi_c = atan2(py, 1 - px) /
    2 pi and its gradient; ``r_ins`` shapes only the bracket and gets
    none."""

    @staticmethod
    def forward(ctx, q, incl, px, py, x1, pl1, r_ins):
        phi_in, phi_out, ecl = element_intervals_plain(q, incl, px, py, x1,
                                                       pl1, r_ins)
        ctx.mark_non_differentiable(ecl)
        ctx.save_for_backward(q, incl, px, py, x1, pl1, phi_in, phi_out,
                              ecl)
        return phi_in, phi_out, ecl

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_in, g_out, _):
        return (*_contact_backward_plain(*ctx.saved_tensors, g_in, g_out),
                None)


def element_intervals_diff(q, incl, px, py, x1, pl1, r_ins):
    """:func:`element_intervals_plain` carrying IFT gradients to (q, incl,
    px, py, x1, pl1)."""
    return _ContactIntervals.apply(q, incl, px, py, x1, pl1, r_ins)
