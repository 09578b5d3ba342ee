"""The contact solver K1: its plain version, routing and wrapper checks.

The plain version is held to the JAX package's two contact solvers:
  * float64, against ``components.element_intervals`` (the XLA solver):
    flags equal, phases to 1e-10 cycles;
  * float32, against the Pallas kernel in interpret mode, as
    tests/test_pallas.py runs it: flags equal, phases to 1e-5 cycles (the
    same bound test_pallas.py holds Pallas to XLA by; separately compiled
    float32 programs round differently and a graze element amplifies the
    ulps through the bracket decisions).
And its float64 phases are held to the JAX package's float64 oracle
``roche.geometry.ray_clearance`` (the minimum of the potential along the
sight-line) at a stated p99 (``TestAccuracyAgainstTheOracle``).
The CUDA kernel itself is tested against the plain version on the card
(tests/test_torch_cuda.py).  Here its source's arithmetic is: the part of
``ops/csrc/contacts.cu`` above its kernels, compiled as C++ by ``g++``
behind a shim header (``__device__`` and friends as empty macros) with a
host loop over elements in the kernels' place, in each of its three
instantiations (float32, float64 and the mixed-precision one) against the
plain version of the same mode (``TestKernelSource``; skipped where there
is no ``g++``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import components as jcomp
from lfit_python_tpu.ops.pallas_contacts import element_intervals_pallas
from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu_torch.ops import contacts
from lfit_python_tpu_torch.roche import geometry as tg
from jax_fresh_compiles import fresh_jax_compiles  # noqa: F401


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    W, N = 5, 200
    q = 0.15 + 0.01 * rng.standard_normal(W)
    dphi = np.full(W, 0.04)
    x1 = np.asarray(jax.vmap(jg.xl1)(q))
    pl1 = np.asarray(jax.vmap(jg.l1_potential)(q))
    incl = np.asarray(jax.vmap(jg.findi)(q, dphi))
    r = rng.uniform(0.05, 0.4, (W, N))
    th = rng.uniform(0, 2 * np.pi, (W, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th), np.zeros((W, N))], -1)
    return q, incl, x1, pl1, pos


def _args(batch, dtype):
    q, incl, x1, pl1, pos = batch

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    r_ins = tg.inscribed_radius(t(q), t(x1), t(pl1))
    return (t(q), t(incl), t(pos[..., 0]), t(pos[..., 1]), t(x1), t(pl1),
            r_ins)


class TestPlainVersion:
    def test_f64_matches_xla_solver(self, batch):
        q, incl, x1, pl1, pos = batch
        pin, pout, ecl = contacts.element_intervals_plain(
            *_args(batch, torch.float64))
        for k in range(len(q)):
            ri, ro, re = jcomp.element_intervals(q[k], incl[k],
                                                 jnp.asarray(pos[k]), x1[k],
                                                 pl1[k])
            np.testing.assert_array_equal(ecl[k].numpy(), np.asarray(re))
            np.testing.assert_allclose(pin[k].numpy(), np.asarray(ri),
                                       atol=1e-10)
            np.testing.assert_allclose(pout[k].numpy(), np.asarray(ro),
                                       atol=1e-10)
        assert 50 < int(ecl.sum()) < ecl.numel()

    def test_f32_matches_pallas_interpret(self, batch):
        q, incl, x1, pl1, pos = batch
        ri, ro, re = element_intervals_pallas(
            q, incl, pos[..., 0], pos[..., 1], x1, pl1, interpret=True)
        pin, pout, ecl = contacts.element_intervals_plain(
            *_args(batch, torch.float32))
        assert pin.dtype == torch.float32
        np.testing.assert_array_equal(ecl.numpy(), np.asarray(re))
        m = np.asarray(re)
        np.testing.assert_allclose(pin.numpy()[m], np.asarray(ri)[m],
                                   atol=1e-5)
        np.testing.assert_allclose(pout.numpy()[m], np.asarray(ro)[m],
                                   atol=1e-5)

    def test_empty_interval_where_not_eclipsed(self, batch):
        pin, pout, ecl = contacts.element_intervals_plain(
            *_args(batch, torch.float64))
        assert torch.equal(pin[~ecl], pout[~ecl])
        assert bool((pout[ecl] > pin[ecl]).all())

    def test_mirror_identity(self, batch):
        """(px, -py) has interval (-phi_out, -phi_in): what cv_fluxes's
        halved disc solve relies on."""
        args = list(_args(batch, torch.float64))
        pin, pout, ecl = contacts.element_intervals_plain(*args)
        args[3] = -args[3]
        min_, mout, mecl = contacts.element_intervals_plain(*args)
        assert torch.equal(ecl, mecl)
        np.testing.assert_allclose(min_[ecl].numpy(), -pout[ecl].numpy(),
                                   atol=1e-15)
        np.testing.assert_allclose(mout[ecl].numpy(), -pin[ecl].numpy(),
                                   atol=1e-15)

    def test_nan_row_gives_empty_interval(self, batch):
        args = list(_args(batch, torch.float64))
        args[1] = args[1].clone()
        args[1][0] = float("nan")
        pin, pout, ecl = contacts.element_intervals_plain(*args)
        assert not bool(ecl[0].any())
        assert torch.equal(pin[0], pout[0])


def _oracle_roots(q, incl, p, x1, pl1, phase, half_width):
    """The phase where the f64 oracle's clearance changes sign within
    ``half_width`` of ``phase``, by 60 bisections (NaN where it does not
    change sign there)."""
    def clear(ph):
        return jg.ray_clearance(q, p, jg.earth_vector(ph, incl), x1, pl1)

    lo, hi = phase - half_width, phase + half_width
    c_lo = clear(lo)
    bracketed = (c_lo > 0) != (clear(hi) > 0)

    def bisect(_, s):
        lo, hi, c_lo = s
        mid = 0.5 * (lo + hi)
        c_mid = clear(mid)
        keep = (c_mid > 0) == (c_lo > 0)
        return (jnp.where(keep, mid, lo), jnp.where(keep, hi, mid),
                jnp.where(keep, c_mid, c_lo))

    lo, hi, _ = jax.lax.fori_loop(0, 60, bisect, (lo, hi, c_lo))
    return jnp.where(bracketed, 0.5 * (lo + hi), jnp.nan)


def oracle_stress_rows():
    """The stress set of the oracle tests (q 0.05-0.5, incl 75-90 deg: deep
    eclipses to grazes; tools/accuracy_contacts.py's ranges), 32 rows x 64
    elements in float64, as element_intervals takes them."""
    rng = np.random.default_rng(42)
    W, N = 32, 64
    q = torch.tensor(rng.uniform(0.05, 0.5, W))
    incl = torch.tensor(rng.uniform(75.0, 90.0, W))
    r = rng.uniform(0.02, 0.45, (W, N))
    th = rng.uniform(0, 2 * np.pi, (W, N))
    x1 = tg.xl1(q)
    pl1 = tg.l1_potential(q, x1)
    return [q, incl, torch.tensor(r * np.cos(th)),
            torch.tensor(r * np.sin(th)), x1, pl1,
            tg.inscribed_radius(q, x1, pl1)]


def oracle_errors(args, pin, pout, ecl):
    """|phase - the oracle's root| of every eclipsed edge, in cycles: each
    root bracketed within half the element's eclipse width (at most 1e-3
    cycles) so that only its own edge is in the bracket; an unbracketed
    edge counts as that half-width."""
    q, incl, px, py, x1, pl1, _ = (a.numpy() for a in args)
    pin, pout, ecl = pin.numpy(), pout.numpy(), ecl.numpy()
    w, n = np.nonzero(ecl)
    assert 1000 < w.size < ecl.size
    p = np.stack([px[w, n], py[w, n], np.zeros(w.size)], -1)
    half = np.minimum(1e-3, 0.45 * (pout - pin)[w, n])
    roots = jax.jit(jax.vmap(_oracle_roots))
    err = []
    for phase in (pin, pout):
        got = np.asarray(roots(q[w], incl[w], p, x1[w], pl1[w], phase[w, n],
                               half))
        err.append(np.where(np.isnan(got), half, np.abs(got - phase[w, n])))
    return np.concatenate(err)


def assert_oracle_gates(err, tag):
    """median <= 1e-12, p99 <= 1e-5 cycles, at most 2% of edges above
    1e-5 (see TestAccuracyAgainstTheOracle)."""
    p99 = np.percentile(err, 99)
    print(f"{tag}: phase error against ray_clearance, {err.size} edges: "
          f"median {np.median(err):.3e}, p99 {p99:.3e}, max "
          f"{err.max():.3e} cycles; {(err > 1e-5).mean():.2%} above 1e-5")
    assert np.median(err) <= 1e-12
    assert p99 <= 1e-5
    assert (err > 1e-5).mean() <= 0.02


class TestAccuracyAgainstTheOracle:
    def test_f64_phases_p99_against_ray_clearance(self):
        """Contact phases of the plain solver in float64 against the roots
        of the oracle's clearance, on the stress set of 32 rows x 64
        elements (``oracle_stress_rows``, ``oracle_errors``).  The error is
        bimodal: ~1e-15 cycles, or 1e-5 to 1e-3 where the edge solve's one
        warm Newton step in t (``_EDGE_T_WARM`` = 1 in the JAX package,
        which the port repeats) ends on the wrong side of a near-grazing
        minimum; 0.65% of edges on 128 such rows.  Limits: p99 <= 1e-5
        cycles (the bound tests/test_pallas.py holds two float32 solvers
        to), which fails once that tail passes 1% of edges; at most 2% of
        edges above 1e-5.  Measured on this set: median ~1e-16, p99
        ~1e-13, max ~1e-3."""
        args = oracle_stress_rows()
        pin, pout, ecl = contacts.element_intervals_plain(*args)
        assert_oracle_gates(oracle_errors(args, pin, pout, ecl),
                            "plain float64")


class TestRouting:
    def test_dtype_rule_on_cpu(self, batch):
        before = contacts.LAUNCHES
        for dt in (torch.float32, torch.float64):
            args = _args(batch, dt)
            got = contacts.element_intervals(*args)
            ref = contacts.element_intervals_plain(*args)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
            assert got[0].dtype == dt
        # the kernel wrapper takes the plain version only for CPU tensors,
        # and counts no launch for it
        got = contacts.element_intervals_kernel(*_args(batch, torch.float32))
        assert contacts.LAUNCHES == before
        assert got[2].dtype == torch.bool

    def test_kernel_wrapper_refuses_other_devices(self, batch):
        args = [a.to("meta") for a in _args(batch, torch.float32)]
        with pytest.raises(ValueError):
            contacts.element_intervals_kernel(*args)


# ---- the kernel source's arithmetic, compiled as C++ --------------------

SOURCE = Path(contacts.__file__).resolve().parent / "csrc" / "contacts.cu"

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __launch_bounds__(...)
static inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
static inline double rsqrt(double v) { return 1.0 / std::sqrt(v); }
// sin(pi x), cos(pi x): the card's are exact in their argument; these
// round pi x first, which moves a phase by an ulp
static inline void sincospi(double x, double* s, double* c) {
  *s = std::sin(M_PI * x);
  *c = std::cos(M_PI * x);
}
static inline void sincospif(float x, float* s, float* c) {
  *s = (float)std::sin(M_PI * (double)x);
  *c = (float)std::cos(M_PI * (double)x);
}
"""

_HOST = r"""
}  // namespace

template <typename T>
static void host_rows(const T* scal, const T* px, const T* py, T* pin,
                      T* pout, unsigned char* ecl, int rows, int n) {
  for (int r = 0; r < rows; ++r)
    for (int j = 0; j < n; ++j) {
      const size_t k = (size_t)r * n + j;
      bool e;
      solve_element(scal + 6 * (size_t)r, px[k], py[k], pin[k], pout[k], e);
      ecl[k] = e ? 1 : 0;
    }
}

extern "C" void contacts_host(int is_double, const void* scal,
                              const void* px, const void* py, void* pin,
                              void* pout, unsigned char* ecl, int rows,
                              int n) {
  if (is_double)
    host_rows<double>((const double*)scal, (const double*)px,
                      (const double*)py, (double*)pin, (double*)pout, ecl,
                      rows, n);
  else
    host_rows<float>((const float*)scal, (const float*)px, (const float*)py,
                     (float*)pin, (float*)pout, ecl, rows, n);
}

extern "C" void contacts_mixed_host(const float* scal, const double* scal64,
                                    const float* px, const float* py,
                                    const double* px64, const double* py64,
                                    float* pin, float* pout,
                                    unsigned char* ecl, int rows, int n) {
  for (int r = 0; r < rows; ++r)
    for (int j = 0; j < n; ++j) {
      const size_t k = (size_t)r * n + j;
      bool e;
      solve_element_mixed(scal + 6 * (size_t)r, scal64 + 3 * (size_t)r,
                          px[k], py[k], px64[k], py64[k], pin[k], pout[k], e);
      ecl[k] = e ? 1 : 0;
    }
}
"""


@pytest.fixture(scope="module")
def source_lib(tmp_path_factory):
    """contacts.cu above its ``// ---- kernel and launcher`` line, built by
    g++ (no contraction of products and sums, as --fmad=false) with host
    loops in the kernels' place."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source's arithmetic")
    build = tmp_path_factory.mktemp("contacts_source")
    (build / "cuda_runtime.h").write_text(_SHIM)
    head, marker, _ = SOURCE.read_text().partition(
        "// ---- kernel and launcher")
    assert marker, "the kernel source lost its marker line"
    (build / "host.cpp").write_text(head + _HOST)
    so = build / "libhost.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{build}", "-o", str(so),
                    str(build / "host.cpp")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.contacts_host.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                  + [ctypes.c_int] * 2)
    lib.contacts_mixed_host.argtypes = ([ctypes.c_void_p] * 9
                                        + [ctypes.c_int] * 2)
    return lib


def source_rows(dtype, stress, seed=11, rows=24, n=160):
    """Rows as element_intervals hands them to K1: north-star geometry, or
    a stress set (q 0.05-1, incl 70-90 deg, elements out to 0.6 a)."""
    rng = np.random.default_rng(seed)
    if stress:
        q = torch.tensor(rng.uniform(0.05, 1.0, rows), dtype=dtype)
        incl = torch.tensor(rng.uniform(70.0, 90.0, rows), dtype=dtype)
        r = rng.uniform(0.0, 0.6, (rows, n))
    else:
        q = torch.tensor(0.15 + 0.01 * rng.standard_normal(rows),
                         dtype=dtype)
        incl = None
        r = rng.uniform(0.02, 0.45, (rows, n))
    th = rng.uniform(0, 2 * np.pi, (rows, n))
    x1 = tg.xl1(q)
    pl1 = tg.l1_potential(q, x1)
    if incl is None:
        incl = tg.findi(q, torch.full_like(q, 0.04), x1, pl1)
    p64 = (torch.tensor(r * np.cos(th)), torch.tensor(r * np.sin(th)))
    return ([q, incl, p64[0].to(dtype), p64[1].to(dtype), x1, pl1,
             tg.inscribed_radius(q, x1, pl1)], p64)


def _run_source(lib, args, precise=None, p64=None):
    q, incl, px, py, x1, pl1, r_ins = args
    scal = contacts._row_scalars(q, incl, x1, pl1, r_ins)
    pin, pout = torch.empty_like(px), torch.empty_like(px)
    ecl = torch.empty(px.shape, dtype=torch.bool)
    rows, n = px.shape
    if precise is None:
        lib.contacts_host(int(px.dtype == torch.float64), scal.data_ptr(),
                          px.data_ptr(), py.data_ptr(), pin.data_ptr(),
                          pout.data_ptr(), ecl.data_ptr(), rows, n)
    else:
        q64, incl64, _, pl164 = precise
        scal64 = torch.stack([q64 / (1.0 + q64),
                              torch.sin(torch.deg2rad(incl64)), pl164],
                             dim=-1).contiguous()
        lib.contacts_mixed_host(
            scal.data_ptr(), scal64.data_ptr(), px.data_ptr(), py.data_ptr(),
            p64[0].data_ptr(), p64[1].data_ptr(), pin.data_ptr(),
            pout.data_ptr(), ecl.data_ptr(), rows, n)
    return pin, pout, ecl


class TestKernelSource:
    """Each instantiation of K1's source against the plain version of its
    mode on the same inputs: flags on all but 1e-4 of the elements and
    phases to 1e-5 cycles in float32 and mixed precision (phase 2's
    limits on the card; here the compiled source and PyTorch round
    alike almost everywhere), flags equal and phases to 1e-12 cycles in
    float64."""

    @pytest.mark.parametrize("stress", [False, True])
    @pytest.mark.parametrize("mode", ["float32", "float64", "mixed"])
    def test_matches_plain(self, source_lib, mode, stress):
        dtype = torch.float64 if mode == "float64" else torch.float32
        args, p64 = source_rows(dtype, stress)
        precise = None
        if mode == "mixed":
            q64 = args[0].double()
            x164 = tg.xl1(q64)
            pl164 = tg.l1_potential(q64, x164)
            incl64 = (args[1].double() if stress else
                      tg.findi(q64, torch.full_like(q64, 0.04), x164,
                               pl164))
            precise = (q64, incl64, x164, pl164)
        got = _run_source(source_lib, args, precise, p64)
        ref = contacts.element_intervals_plain(
            *args, precise=precise, p64=None if precise is None else p64)
        flags = (got[2] != ref[2]).double().mean().item()
        both = got[2] & ref[2]
        assert 0 < int(both.sum()) < both.numel()
        err = max((got[k] - ref[k]).abs()[both].max().item() for k in (0, 1))
        if mode == "float64":
            assert flags == 0.0 and err <= 1e-12
        else:
            assert flags <= 1e-4 and err <= 1e-5
        # a visible element's interval is empty, at phi_c
        assert torch.equal(got[0][~got[2]], got[1][~got[2]])
        vis = ~(got[2] | ref[2])
        assert (got[0] - ref[0]).abs()[vis].max().item() <= (
            1e-15 if mode == "float64" else 1e-7)

    # two near-tangent ingress edges found by a wider study of the float64
    # source against the plain solver (~1.4M edges): (q, incl, px, py, x1,
    # pl1) and the oracle's ingress phase (the root of ray_clearance)
    NEAR_TANGENT = (
        ((0.7732050218425135, 89.69461143926931, 0.5259144430160004,
          -0.024604336992572338, 0.5264464972309368, -1.9961287415945224),
         -0.24597748718652784),
        ((0.543272328148226, 89.53005102410908, 0.5621676146857828,
          -0.00968977677780298, 0.5623972883496267, -1.9787342654536761),
         -0.24533414568031303))

    def test_f64_near_tangent_edges(self, source_lib):
        """The two edges on record: the float64 source and the plain
        solver differ there by 1.04e-12 and 4.06e-12 cycles, beyond
        test_matches_plain's 1e-12 (the card's phase 14 allows a 1e-4 share
        of elements above it), and both sit 1.456e-4 and 1.176e-4 cycles
        off the oracle, the reference's single warm Newton step.  Held to
        1e-11 between the two and 2e-4 from the oracle; the egress edges
        to 1e-12."""
        cols = [torch.tensor([[edge[k]] for edge, _ in self.NEAR_TANGENT],
                             dtype=torch.float64) for k in range(6)]
        q, incl, px, py, x1, pl1 = cols
        args = [q[:, 0], incl[:, 0], px, py, x1[:, 0], pl1[:, 0],
                tg.inscribed_radius(q[:, 0], x1[:, 0], pl1[:, 0])]
        got = _run_source(source_lib, args)
        ref = contacts.element_intervals_plain(*args)
        assert bool(got[2].all()) and bool(ref[2].all())
        oracle = torch.tensor([[o] for _, o in self.NEAR_TANGENT],
                              dtype=torch.float64)
        d_in = (got[0] - ref[0]).abs()
        print("near-tangent ingress edges, source - plain:",
              (got[0] - ref[0]).flatten().tolist(), "cycles; off the "
              "oracle:", (got[0] - oracle).flatten().tolist())
        assert d_in.max().item() <= 1e-11
        assert (got[0] - oracle).abs().max().item() <= 2e-4
        assert (ref[0] - oracle).abs().max().item() <= 2e-4
        assert (got[1] - ref[1]).abs().max().item() <= 1e-12

    def test_f64_phases_p99_against_ray_clearance(self, source_lib):
        """The float64 instantiation (fused arithmetic, steering
        reciprocals) against the oracle on the plain solver's stress set,
        under the plain solver's gates: the float64 mode is for accuracy,
        and its redesign must cost none."""
        args = oracle_stress_rows()
        pin, pout, ecl = _run_source(source_lib, args)
        assert_oracle_gates(oracle_errors(args, pin, pout, ecl),
                            "compiled float64 source")
