#!/usr/bin/env python3
"""Time builds of ``wd_donor.cu`` side by side in turns on one CUDA card:
K9 (the donor grid's radius solve) and K10 (the white dwarf's sweep, both
modes) on the north star's inputs.

    python3 tools/torch_wd_donor_variants.py [--parent TREE] [--only A,B]
                                             [--sass DIR]

Each entry of ``VARIANTS`` is this checkout's ``wd_donor.cu`` with its
text substitutions ("kept": the source as it stands); ``--parent`` adds TREE's ``wd_donor.cu`` as it stands, launched
with the index maps of the first design (a map a point over the whole
broadcast shape, then the point count; K9's arguments are the same);
``--only`` keeps the labels named; ``--sass`` writes each build's
``cuobjdump -sass`` listing and ptxas log there.  Every source is built at
once with nvcc and the port's flags into ``build/wd_donor_variants/``
and launched through its C entry points.  The inputs are the arguments
one float32 evaluation of the north-star model at 1024 walkers hands K9
(1024 walkers x 384 directions: the grid, ``k9_grid``, and the radius and
slope a recorded graph's launch asks for, ``k9_radius``) and K10 (5120 x
128 points, ``k10_curve``), the same model with .calib exposure widths
hands K10 (5120 x 384 sub-phases, ``k10_widths``) and the GP model's
changepoints hand K10's distance mode (2 x 5120 points,
``k10_distance``), float32 and cast to float64.  It prints one JSON line
with, for each build and case: the outputs' bits against the plain
versions (``same_bits``: max difference 0.0 and the same NaN pattern), a
SHA-256 of the outputs; the device time as the profiler traces it (the
least of 5 launches, every build in one profiler window: only a
process's first keeps every record); us a launch over back-to-back
launches between two CUDA events, in turns (each turn runs the builds in
the opposite order to the last); ptxas's registers, stack frame and
spills of each build's kernels; and each build's SASS instructions a
solve and a point (``tools/wd_donor_sass_counts.py``).
"""

import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "lfit_python_tpu_torch" / "ops" / "csrc" / "wd_donor.cu"
OUT = ROOT / "build" / "wd_donor_variants"
F32, F64 = torch.float32, torch.float64

# K9 as a k-section of d = 3 (roche.cu's K6 schedule): a group of 8 lanes
# a solve, the loop's bisection steps in rounds of 3 levels (7 midpoints
# voted at once by __ballot_sync and walked as the loop would), then the
# Newton steps in every lane; lane 0 stores, the grid written in place
_KSECTION = r'''
template <typename T>
__device__ T ks_mid(T lo, T hi, unsigned node) {
  int level = (node >= 2u) + (node >= 4u);
  for (int b = 1; b >= 0; --b) {
    if (b < level) {
      const T mid = T(0.5) * (lo + hi);
      const bool up = (node >> b) & 1u;
      lo = up ? mid : lo;
      hi = up ? hi : mid;
    }
  }
  return T(0.5) * (lo + hi);
}

template <typename T>
__global__ void __launch_bounds__(128) donor_ksection_kernel(
    const DonorArgs<T> a) {
  const unsigned t = blockIdx.x * 128 + threadIdx.x;
  const unsigned n = a.n_walkers * a.n_dir, solve = t >> 3, lane = t & 7u;
  const unsigned shift = threadIdx.x & 31u & ~7u;
  const unsigned i = solve < n ? solve : n - 1;
  const unsigned w = i / a.n_dir, j = i - w * a.n_dir;
  const T q = a.q[w * a.sq];
  Lobe<T> l;
  l.mu = q / (T(1) + q);
  l.omu = T(1) - l.mu;
  l.pl1 = a.pl1[w * a.spl1];
  l.dx = a.dx[j];
  l.dy = a.dy[j];
  l.dz = a.dz[j];
  T hi = T(1) - a.x1[w * a.sx1];
  T lo = T(1e-6) * hi;
  for (int done = 0; done < DonorSteps<T>::bisections;) {
    const int left = DonorSteps<T>::bisections - done, r = left < 3 ? left : 3;
    const bool vote = lane >= 1u && lane < (1u << r)
                      && lobe_f(l, ks_mid(lo, hi, lane)) < T(0);
    const unsigned mask = __ballot_sync(0xffffffffu, vote) >> shift;
    unsigned node = 1;
    for (int k = 0; k < r; ++k) {
      const T mid = T(0.5) * (lo + hi);
      const bool up = (mask >> node) & 1u;
      lo = up ? mid : lo;
      hi = up ? hi : mid;
      node = 2 * node + up;
    }
    done += r;
  }
  T r = T(0.5) * (lo + hi);
  for (int k = 0; k < DonorSteps<T>::newtons; ++k) {
    const T fr = lobe_f(l, r);
    const bool inside = fr < T(0);
    lo = inside ? r : lo;
    hi = inside ? hi : r;
    const T rn = r - fr / clamp_min(lobe_fp(l, r), T(1e-12));
    const bool bad = (rn < lo) | (rn > hi);
    r = bad ? T(0.5) * (lo + hi) : rn;
  }
  if (solve >= n || lane != 0u) return;
  if (a.r != nullptr) {
    a.r[i] = r;
    a.slope[i] = lobe_fp(l, r);
  }
  if (a.pos == nullptr) return;
  const T px = T(1) + r * l.dx;
  const T py = r * l.dy;
  const T pz = r * l.dz;
  const T i1 = rsqrt_(px * px + py * py + pz * pz);
  const T i2 = T(1) / r;
  const T i13 = i1 * i1 * i1;
  const T i23 = i2 * i2 * i2;
  const T gx = l.omu * px * i13 + l.mu * (px - T(1)) * i23 - (px - l.mu);
  const T gy = py * (l.omu * i13 + l.mu * i23 - T(1));
  const T gz = pz * (l.omu * i13 + l.mu * i23);
  const T gn = clamp_min(sqrt_(gx * gx + gy * gy + gz * gz), T(1e-12));
  const T nx = gx / gn, ny = gy / gn, nz = gz / gn;
  const T mu_dn = clamp_min(l.dx * nx + l.dy * ny + l.dz * nz, T(1e-3));
  a.pos[3 * i] = px;
  a.pos[3 * i + 1] = py;
  a.pos[3 * i + 2] = pz;
  a.nrm[3 * i] = nx;
  a.nrm[3 * i + 1] = ny;
  a.nrm[3 * i + 2] = nz;
  a.area[i] = r * r * a.d_omega[j] / mu_dn;
}

template <typename T>
static int donor_launch('''

# K9 with its grid staged a warp at a time in shared memory and written
# by 16-byte stores, PTX's (nvcc splits this copy's struct-typed float4
# store into four); a lane past the last direction solves a copy of it
# and stores nothing, so that the warp reaches each __syncwarp whole
_STAGED = r'''
__device__ __forceinline__ void st16_ptx(float* p, const float* v) {
  asm volatile("{ .reg .u64 g; cvta.to.global.u64 g, %0; "
               "st.global.v4.f32 [g], {%1, %2, %3, %4}; }" ::"l"(p),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]) : "memory");
}
__device__ __forceinline__ void st16_ptx(double* p, const double* v) {
  asm volatile("{ .reg .u64 g; cvta.to.global.u64 g, %0; "
               "st.global.v2.f64 [g], {%1, %2}; }" ::"l"(p),
               "d"(v[0]), "d"(v[1]) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(DonorSteps<T>::threads,
                                  DonorSteps<T>::blocks)
donor_staged_kernel(const DonorArgs<T> a) {
  __shared__ Walker<T> wk[DonorSteps<T>::threads / 32];
  __shared__ __align__(16) T st[DonorSteps<T>::threads * 6];
  const unsigned b = blockIdx.x, tx = threadIdx.x, ty = threadIdx.y;
  const unsigned lane = tx & 31u;
  donor_walkers(a, b, tx, ty, wk);
  __syncthreads();
  bool w_real;
  const unsigned w0 = donor_walker_of(a, b, ty, w_real);
  const unsigned w = w_real ? w0 : a.n_walkers - 1;
  const Walker<T> k = wk[w_real ? ty : 0];
  T* slot = st + 6 * (ty * a.sh.x + (tx & ~31u));
  for (unsigned base = 0; base < a.n_dir; base += a.sh.x) {
    const unsigned j0 = base + tx;
    const bool real = w_real && j0 < a.n_dir;
    const unsigned j = j0 < a.n_dir ? j0 : a.n_dir - 1;
    Lobe<T> l;
    l.mu = k.mu;
    l.omu = k.omu;
    l.pl1 = k.pl1;
    l.dx = a.dx[j];
    l.dy = a.dy[j];
    l.dz = a.dz[j];
    const T r = lobe_root(l, k.lo, k.hi);
    const long long i = (long long)w * a.n_dir + j;
    if (a.r != nullptr && real) {
      a.r[i] = r;
      a.slope[i] = lobe_fp(l, r);
    }
    if (a.pos == nullptr) continue;
    const T px = T(1) + r * l.dx;
    const T py = r * l.dy;
    const T pz = r * l.dz;
    const T i1 = rsqrt_(px * px + py * py + pz * pz);
    const T i2 = T(1) / r;
    const T i13 = i1 * i1 * i1;
    const T i23 = i2 * i2 * i2;
    const T gx = k.omu * px * i13 + k.mu * (px - T(1)) * i23 - (px - k.mu);
    const T gy = py * (k.omu * i13 + k.mu * i23 - T(1));
    const T gz = pz * (k.omu * i13 + k.mu * i23);
    const T gn = clamp_min(sqrt_(gx * gx + gy * gy + gz * gz), T(1e-12));
    const T nx = gx / gn, ny = gy / gn, nz = gz / gn;
    const T mu_dn = clamp_min(l.dx * nx + l.dy * ny + l.dz * nz, T(1e-3));
    slot[3 * lane] = px;
    slot[3 * lane + 1] = py;
    slot[3 * lane + 2] = pz;
    slot[96 + 3 * lane] = nx;
    slot[96 + 3 * lane + 1] = ny;
    slot[96 + 3 * lane + 2] = nz;
    if (real) a.area[i] = r * r * a.d_omega[j] / mu_dn;
    __syncwarp();
    const unsigned first = base + (tx & ~31u);
    if (w_real && first < a.n_dir) {
      const unsigned left = a.n_dir - first;
      const unsigned n = 3 * (left < 32u ? left : 32u);
      const long long at = 3 * ((long long)w * a.n_dir + first);
      for (int half = 0; half < 2; ++half) {
        T* dst = (half ? a.nrm : a.pos) + at;
        const T* src = slot + 96 * half;
        constexpr unsigned per = 16 / sizeof(T);
        unsigned head = (unsigned)((16u - ((size_t)dst & 15u)) & 15u)
                        / (unsigned)sizeof(T);
        if (head > n) head = n;
        const unsigned nv = (n - head) / per;
        for (unsigned e = lane; e < head; e += 32u) dst[e] = src[e];
        for (unsigned v = lane; v < nv; v += 32u) {
          T x[per];
          for (unsigned q = 0; q < per; ++q) x[q] = src[head + v * per + q];
          st16_ptx(dst + head + v * per, x);
        }
        for (unsigned e = head + nv * per + lane; e < n; e += 32u)
          dst[e] = src[e];
      }
    }
    __syncwarp();
  }
}

template <typename T>
static int donor_launch('''

# K10 with K phases a lane at once (float32 4, float64 2): each whole
# chunk of L K phases read and written as 16-byte vectors where aligned, K
# independent chains; the rest of the row one phase a lane
_SLOTS = r'''
template <typename T> struct WdSlots;
template <> struct WdSlots<float> {
  static constexpr int k = 4;
};
template <> struct WdSlots<double> {
  static constexpr int k = 2;
};

WD_FN bool aligned16(const void* p) { return ((size_t)p & 15u) == 0; }
WD_FN void ld16(const float* p, float* v) {
  const float4 x = *(const float4*)p;
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
WD_FN void ld16(const double* p, double* v) {
  const double2 x = *(const double2*)p;
  v[0] = x.x;
  v[1] = x.y;
}
WD_FN void st16(float* p, const float* v) {
  *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
}
WD_FN void st16(double* p, const double* v) {
  *(double2*)p = make_double2(v[0], v[1]);
}

// K consecutive values at p: 16-byte vectors where p is aligned, else one
// at a time
template <int K, typename T> WD_FN void load_k(const T* p, T* v) {
  constexpr int per = 16 / (int)sizeof(T);
  if (K % per == 0 && aligned16(p)) {
#pragma unroll
    for (int b = 0; b < K; b += per) ld16(p + b, v + b);
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) v[s] = p[s];
  }
}
template <int K, typename T> WD_FN void store_k(T* p, const T* v) {
  constexpr int per = 16 / (int)sizeof(T);
  if (K % per == 0 && aligned16(p)) {
#pragma unroll
    for (int b = 0; b < K; b += per) st16(p + b, v + b);
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) p[s] = v[s];
  }
}

// K points of the row w from phases ph
template <bool DISTANCE, int K, typename T>
WD_FN void wd_points(const WdRow<T>& w, const T* ph, T* out, T* out2) {
  T x[K], y[K], y2[K];
  load_k<K>(ph, x);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (DISTANCE) {
      T ex;
      origin_shadow(w, x[s], y[s], y2[s], ex);
    } else {
      y[s] = wd_fraction(w, x[s]);
    }
  }
  store_k<K>(out, y);
  if (DISTANCE) store_k<K>(out2, y2);
}

template <bool DISTANCE, typename T>
WD_FN void wd_row_slots(const WdArgs<T>& a, unsigned r, unsigned lane) {
  constexpr unsigned K = WdSlots<T>::k;
  const WdRow<T> w = wd_row<DISTANCE>(a, r);
  const T* ph = a.p[WD_PH] + row_at(a.map[WD_PH], r);
  const long long at = (long long)r * a.P;
  T* out = a.out + at;
  T* out2 = DISTANCE ? a.out2 + at : nullptr;
  const unsigned step = a.lanes * K, whole = a.P - a.P % step;
  for (unsigned c = 0; c < whole; c += step) {
    const unsigned p = c + lane * K;
    wd_points<DISTANCE, K>(w, ph + p, out + p, DISTANCE ? out2 + p : nullptr);
  }
  for (unsigned p = whole + lane; p < a.P; p += a.lanes)
    wd_point<DISTANCE>(w, ph, out, out2, p);
}

// ---- kernel and launcher'''

_K9_LAUNCH = ("  donor_grid_kernel<T><<<donor_blocks(a.n_walkers, a.sh),\n"
              "                         dim3(a.sh.x, a.sh.g), 0, s>>>(a);")

# label: [(text, its replacement)] on this checkout's source
VARIANTS = {
    "kept": [],
    # K9: block threads and blocks an SM in each type (one wave of 1024
    # walkers at 8 and 9 blocks an SM)
    "k9_f32_192": [("threads = 384, blocks = 5", "threads = 192, blocks = 8")],
    "k9_f64_128": [("threads = 384, blocks = 3", "threads = 128, blocks = 9")],
    # K9 with its grid staged a warp at a time, 16-byte stores
    "k9_staged": [
        ("template <typename T>\nstatic int donor_launch(", _STAGED),
        (_K9_LAUNCH, _K9_LAUNCH.replace("donor_grid_kernel",
                                        "donor_staged_kernel"))],
    # K9 as a d = 3 k-section (ROADMAP queue 2), a group of 8 lanes a solve
    "k9_ksection": [
        ("template <typename T>\nstatic int donor_launch(", _KSECTION),
        (_K9_LAUNCH, "  donor_ksection_kernel<T><<<(a.n_walkers * a.n_dir * "
         "8 + 127) / 128, 128, 0, s>>>(a);")],
    # K10: phases a lane at once (16-byte vectors, unrolled chains); lanes
    # a row
    "k10_slots4": [
        ("// ---- kernel and launcher", _SLOTS),
        ("wd_row_sweep<DISTANCE>(a, l.row, l.lane)",
         "wd_row_slots<DISTANCE>(a, l.row, l.lane)")],
    "k10_lanes16": [("WD_ROW_LANES = 32", "WD_ROW_LANES = 16")],
    # K10: sincosf in float32; sin and cos apart in float64
    "k10_sincosf": [("  s = sinf(v);\n  c = cosf(v);",
                     "  sincosf(v, &s, &c);")],
    "k10_f64_sin_cos": [("{ sincos(v, &s, &c); }",
                         "{\n  s = sin(v);\n  c = cos(v);\n}")],
}


def _build_one(label, src, text=None):
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.ops import _build

    flags = _build.NVCC_FLAGS
    body = src.read_bytes() if text is None else text.encode()
    key = hashlib.sha256(body + " ".join(flags).encode()).hexdigest()[:16]
    out = OUT / f"{label}-{key}"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "wd_donor.cu"
    cu.write_bytes(body)
    proc = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-o",
                           str(out / "libwd_donor.so"), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    sass = subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
         str(out / "libwd_donor.so")], capture_output=True, text=True,
        check=True).stdout
    return label, out / "libwd_donor.so", proc.stderr, sass


def build(labels, parent=None):
    """{label: (ctypes library, ptxas log, SASS listing)}; every nvcc
    started at once.  Raises with nvcc's output if a build fails."""
    jobs = []
    text = SOURCE.read_text()
    for label in labels:
        t = text
        for old, new in VARIANTS[label]:
            if t.count(old) != 1:
                raise RuntimeError(f"{label}: {old!r} is not in the source "
                                   f"once")
            t = t.replace(old, new)
        jobs.append((label, SOURCE, t))
    if parent is not None:
        jobs.append(("parent", Path(parent) / SOURCE.relative_to(ROOT),
                     None))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: _build_one(*j), jobs))
    libs = {}
    i, p = ctypes.c_int, ctypes.c_void_p
    for label, so, log, sass in built:
        lib = ctypes.CDLL(str(so))
        for fn, types in ((lib.donor_grid_launch, [i, p, p, p]),
                          (lib.wd_curve_launch, [i, i, p, p, p])):
            fn.argtypes = types
            fn.restype = ctypes.c_int
        libs[label] = (lib, log, sass)
    return libs


def ptxas(log):
    """{kernel entry: [registers, stack frame bytes, spilled bytes]} of
    K9 and K10 in a ``-Xptxas -v`` log."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w*(donor_grid|"
                      r"donor_ksection|donor_staged|wd_curve)_kernel\w*)'",
                      line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if entry and m:
            out[entry] = [None, int(m.group(1)),
                          int(m.group(2)) + int(m.group(3))]
        m = re.search(r"Used (\d+) registers", line)
        if entry and m and entry in out:
            out[entry][0] = int(m.group(1))
            entry = None
    return out


def north_star_inputs(dev):
    """{case: (wrapper name, args)}: the float32 arguments one evaluation
    of the north-star model at 1024 walkers hands K9 and K10, one of the
    same model with .calib exposure widths hands K10 (its sub-phases) and
    one of the GP model hands K10's distance mode (its changepoints' first
    Newton step)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from torch_eval_turns import walkers

    from lfit_python_tpu_torch.examples import build_model, with_calib_widths
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops import wd_donor

    spec = dict(n_eclipses=5, complex_spot=[False] * 5, n_points=128,
                bands=("g", "r"))

    def recorded(model):
        lp = make_ln_prob(model, dtype=F32, device=dev)
        names = ("donor_grid", "wd_curve", "wd_distance")
        with contextlib.ExitStack() as stack:
            rec = {n: stack.enter_context(mock.patch.object(
                wd_donor, f"{n}_kernel", wraps=getattr(wd_donor,
                                                       f"{n}_kernel")))
                for n in names}
            with torch.inference_mode():
                lp(walkers(model.var_start(), 1024, 0))
        return {n: [list(c.args) for c in r.call_args_list]
                for n, r in rec.items()}
    fwd = recorded(build_model(**spec).compile())
    widths = recorded(with_calib_widths(build_model(**spec)).compile())
    gp = recorded(build_model(use_gp=True, **spec).compile())
    return {"k9_grid": ("donor_grid", fwd["donor_grid"][0]),
            "k9_radius": ("donor_radius", fwd["donor_grid"][0]),
            "k10_curve": ("wd_curve", fwd["wd_curve"][0]),
            "k10_widths": ("wd_curve", widths["wd_curve"][0]),
            "k10_distance": ("wd_distance", gp["wd_distance"][0])}


def _cast(args, dtype):
    return [a.to(dtype) if isinstance(a, torch.Tensor)
            and a.is_floating_point() else a for a in args]


def plain_outputs(kernel, args):
    """The plain version's outputs of one case."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.roche import geometry as tg

    if kernel.startswith("donor"):
        q, x1, pl1, dx, dy, dz, d_omega = args
        r, slope = comp._donor_radius_loop(q, x1, pl1, dx, dy, dz)
        if kernel == "donor_radius":
            return [r, slope]
        return list(comp._donor_grid_plain(r, (q / (1.0 + q))[:, None], dx,
                                           dy, dz, d_omega))
    if kernel == "wd_curve":
        return [comp._wd_curve_plain(*args)]
    return list(tg._shadow_distance_plain(*args))


def launcher(lib, label, kernel, args):
    """(a function of no arguments that launches ``kernel`` of ``lib`` on
    ``args`` on the current stream, its outputs): the first design's
    per-point index maps for the parent, the row maps otherwise.  Raises
    if the launch fails.  Its arguments are read once, here."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.ops import wd_donor

    stream = torch.cuda.current_stream().cuda_stream
    ref = args[0]
    dbl = int(ref.dtype == F64)
    keep = []
    if kernel.startswith("donor"):
        q, x1, pl1 = args[:3]
        W, N = q.shape[0], args[3].shape[0]
        if kernel == "donor_radius":
            outs = [q.new_empty((W, N)), q.new_empty((W, N))]
            tail = [*outs, None, None, None]
        else:
            outs = [q.new_empty((W, N, 3)), q.new_empty((W, N, 3)),
                    q.new_empty((W, N))]
            tail = [None, None, *outs]
        ptrs = wd_donor._pointers([*args, *tail])
        ints = wd_donor._ints((q.stride(0), x1.stride(0), pl1.stride(0), W,
                               N))

        def call():
            return lib.donor_grid_launch(dbl, ptrs, ints, stream)
    else:
        distance = kernel == "wd_distance"
        names = wd_donor._WD_INPUTS[:5 if distance else 8]
        order = (2, 0, 1, 3, 4) if distance else (2, 0, 1, 5, 6, 3, 4, 7)
        ins = {n: args[k] for n, k in zip(names, order)}
        shape = torch.broadcast_shapes(*(t.shape for t in ins.values()))
        outs = [ref.new_empty(shape)] + ([ref.new_empty(shape)]
                                         if distance else [])
        n = outs[0].numel()
        if label == "parent":
            maps = [wd_donor._index_map(t, shape) for t in ins.values()]
            count = [n]
        else:
            P, _, m = wd_donor._row_layout(ins, shape)
            maps, count = list(m.values()), [n // P, P]
        maps += [(None, 1, 0, 0)] * (8 - len(maps))
        keep = [m[0] for m in maps]
        ptrs = wd_donor._pointers(keep + outs + [None] * (2 - len(outs)))
        ints = wd_donor._ints([m[k] for k in (1, 2, 3) for m in maps]
                              + count)

        def call():
            return lib.wd_curve_launch(dbl, int(distance), ptrs, ints,
                                       stream)

    def go():
        err = call()
        if err != 0:
            raise RuntimeError(f"{label} {kernel}: cudaError {err}")
    go.keep = (keep, args)
    return go, outs


def measure(libs, inputs, reps=20, n_turns=4):
    """{label: {case: {...}}} for each build of ``libs`` (``build``'s)
    and each case of ``inputs`` (``north_star_inputs``'s), float32 and
    float64."""
    cases = [(f"{name}_{str(dt)[6:]}", kernel, _cast(args, dt))
             for name, (kernel, args) in inputs.items() for dt in (F32, F64)]
    run, res_of, out = {}, {}, {label: {} for label in libs}
    for i, (tag, kernel, args) in enumerate(cases):
        plain = plain_outputs(kernel, args)
        for label in libs:
            go, res = launcher(libs[label][0], label, kernel, args)
            run[label, i], res_of[label, i] = go, res
            go()
            torch.cuda.synchronize()
            same = all(torch.equal(torch.isnan(k), torch.isnan(p))
                       and torch.equal(k[~torch.isnan(k)],
                                       p[~torch.isnan(p)])
                       for k, p in zip(res, plain))
            out[label][tag] = {"same_bits": same, "sha256": hashlib.sha256(
                b"".join(x.cpu().numpy().tobytes() for x in res)
            ).hexdigest()[:16]}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the window opens with 5 launches more, whose records may be lost
    order = [(label, i) for i in range(len(cases)) for label in libs]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, i in order[:1] + order:
            for _ in range(5):
                run[label, i]()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and re.search(
                       r"(donor_grid|donor_ksection|donor_staged|wd_curve)"
                       r"_kernel",
                       e.name)), key=lambda e: e.time_range.start)
    if len(kern) < 5 * len(order):
        raise RuntimeError(f"the trace holds {len(kern)} K9 / K10 kernels "
                           f"of {5 * len(order) + 5} launched")
    kern = kern[len(kern) - 5 * len(order):]
    for k, (label, i) in enumerate(order):
        out[label][cases[i][0]]["traced_us"] = min(
            e.time_range.elapsed_us() for e in kern[5 * k:5 * k + 5])
    for i, (tag, _, _) in enumerate(cases):
        turns = {label: [] for label in libs}
        for t in range(n_turns):
            for label in (list(libs) if t % 2 == 0 else list(libs)[::-1]):
                for _ in range(3):
                    run[label, i]()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    run[label, i]()
                end.record()
                torch.cuda.synchronize()
                turns[label].append(start.elapsed_time(end) / reps * 1e3)
        for label, us in turns.items():
            out[label][tag].update(us=statistics.median(us), us_turns=us)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a tree whose wd_donor.cu is timed too")
    ap.add_argument("--only", help="the VARIANTS labels to build, by commas")
    ap.add_argument("--sass", help="a directory for each build's SASS "
                                   "listing and ptxas log")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    labels = args.only.split(",") if args.only else list(VARIANTS)
    libs = build(labels, parent=args.parent)
    if args.sass:
        d = Path(args.sass)
        d.mkdir(parents=True, exist_ok=True)
        for label, (_, log, listing) in libs.items():
            (d / f"{label}.sass").write_text(listing)
            (d / f"{label}.ptxas.txt").write_text(log)
    res = measure(libs, north_star_inputs(torch.device("cuda", 0)))
    sys.path.insert(0, str(ROOT / "tools"))
    sass = {}
    with contextlib.suppress(ImportError):
        from wd_donor_sass_counts import counts

        sass = {label: counts(listing)
                for label, (_, _, listing) in libs.items()}
    print(json.dumps({"card": smi, "variants": {
        lb: {"substitutions": len(VARIANTS[lb])}
        for lb in labels},
        "ptxas": {lb: ptxas(log) for lb, (_, log, _) in libs.items()},
        "sass": sass, "kernels": res}))
    if not all(c["same_bits"] for r in res.values() for c in r.values()):
        raise SystemExit("a build's K9 or K10 differs from its plain "
                         "version")


if __name__ == "__main__":
    main()
