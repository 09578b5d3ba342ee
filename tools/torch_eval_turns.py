#!/usr/bin/env python3
"""Time one checkout's north-star posterior evaluation, gradient
evaluation, GP evaluation and CUDA kernels on one CUDA card, for
comparing two checkouts in turns.

    python3 tools/torch_eval_turns.py CHECKOUT_ROOT

Imports ``lfit_python_tpu_torch`` from CHECKOUT_ROOT and prints one JSON
line:

- ms per ln_prob evaluation at 1024 walkers (the north-star model,
  float32) and ms per value_and_grad at 256 chains (the same model with
  .calib exposure widths), three host-clock turns each after a warm-up;
  where the checkout has the GP likelihood, ms per ln_prob evaluation of
  the same tree with use_gp on every eclipse, at 1024 walkers;
- s per hmc_step (16 leapfrog steps) and per nuts_step (max depth 6) at
  the 256 chains of the value_and_grad above, from one chain ball at a
  fixed step size, two turns each after a warm-up, with the NUTS
  steps' mean depths;
- ms per call of the checkout's kernels, through its own wrappers and
  timed with CUDA events: K1 on the contact rows one evaluation hands it
  (5120 x 512); K1 in float64 and in mixed precision on the rows one
  float64 and one precise evaluation hand it, at 1024 walkers (5120 x
  512) and at a half-step of the demo fit (512 walkers of
  examples/demo_input.dat: 512 x 512), each also as the profiler traces
  the kernel alone; K1's backward on the contact rows one gradient evaluation
  hands it (1280 x 512; the backward pass of element_intervals_diff, as a
  forward and backward less a forward, and the backward kernel's wrapper
  alone in float32 and float64), K2 on the evaluation's stream
  inputs (primal at 1024 walkers, with sensitivities at 256; float32 and
  float64), K3 on the GP evaluation's series (5120 x 128 points; float32
  and float64) and, where the checkout has it, K3's recorded forward and
  its backward pass on the same series' first 256 walkers; and the device
  time of the backward kernel and of K3's forward kernel alone, as the
  profiler traces them (the least of 5 calls); where the checkout has
  them, K4 (``findi_kernel``), K5 (``xl1_kernel``) and K6
  (``lobe_radius_kernel``, its first call: 5120 radii in a checkout that
  solves the inscribed radius per eclipse, 1024 in one that solves it
  once a walker) on the inputs one evaluation hands them, float32 and
  float64, event-timed and traced; and where the checkout has them, K7
  (``element_curve_kernel``: the disc's rows) and K8 (``donor_sum_kernel``:
  the donor curve's rows, and its normaliser's at P = 1: ``k8_p1``) on
  the inputs one evaluation hands them, and
  their backward kernels on those of the value_and_grad above, float32
  and float64, event-timed and traced;
- a SHA-256 of each kernel's outputs (for K1's backward, of its six
  gradients), and of the ln p and model flux of one float32, float64 and
  precise evaluation at 1024 walkers and of the value_and_grad above, so
  that two checkouts whose kernels and posteriors give the same bits
  print the same digests.

The evaluations are host-bound, so compare two checkouts only within one
call, each in its own process, in the order a, b, b, a:

    for r in OLD NEW NEW OLD; do python3 tools/torch_eval_turns.py $r; done
"""

import contextlib
import hashlib
import json
import re
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

DEV = torch.device("cuda", 0)
F32, F64 = torch.float32, torch.float64


def walkers(start, n, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(start[None] + 0.001 * np.abs(start)[None]
                        * rng.standard_normal((n, start.size)), dtype=F32,
                        device=DEV)


def turns(fn, n_turns=3, reps=2):
    out = []
    for _ in range(n_turns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / reps * 1e3)
    return out


def event_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced_us(fn, kernel):
    """The least device time of ``kernel`` over 5 profiled calls of
    ``fn``, in us (None where the trace has no such kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and re.search(rf"\b{kernel}\b", e.name)]
    return min(times) if times else None


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    root = str(Path(sys.argv[1]).resolve())
    sys.path.insert(0, root)
    import lfit_python_tpu_torch
    from lfit_python_tpu_torch.examples import build_model, with_calib_widths
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops import contacts, stream
    from lfit_python_tpu_torch.roche.geometry import xl1
    from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                    parse_input_dat)

    if not lfit_python_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {lfit_python_tpu_torch.__file__}")
    spec = dict(n_eclipses=5, complex_spot=[False] * 5, n_points=128,
                bands=("g", "r"))
    model = build_model(**spec).compile()
    lp = make_ln_prob(model, dtype=F32, device=DEV)
    pos = walkers(model.var_start(), 1024, 0)
    with mock.patch.object(contacts, "element_intervals_kernel",
                           wraps=contacts.element_intervals_kernel) as rec:
        lp(pos)
    ev = turns(lambda: lp(pos))
    lpw = make_ln_prob(with_calib_widths(build_model(**spec)).compile(),
                       dtype=F32, device=DEV)
    posw = walkers(model.var_start(), 256, 1)
    with mock.patch.object(contacts, "element_intervals_diff",
                           wraps=contacts.element_intervals_diff) as rec_d:
        lpw.value_and_grad(posw)
    vg = turns(lambda: lpw.value_and_grad(posw), reps=1)

    k1_args = rec.call_args.args
    kernels = {"k1": {"ms": event_ms(
        lambda: contacts.element_intervals_kernel(*k1_args), 20),
        "sha256": digest(contacts.element_intervals_kernel(*k1_args))}}
    demo = build_model_from_config(parse_input_dat(
        Path(root) / "examples" / "demo_input.dat")).compile()
    for tag, m, p in (("", model, pos),
                      ("_512", demo, walkers(demo.var_start(), 512, 2))):
        for mode, (fn, args) in k1_mode_rows(contacts, m, p).items():
            kernels[f"k1_{mode}{tag}"] = {
                "rows": list(args[2].shape),
                "ms": event_ms(lambda: fn(*args), 20),
                "traced_us": traced_us(lambda: fn(*args), {
                    "f64": "contacts_kernel",
                    "mixed": "contacts_mixed_kernel"}[mode]),
                "sha256": digest(fn(*args))}
    kernels["k1_backward"] = k1_backward(
        contacts, [a.detach() for a in rec_d.call_args.args])
    with torch.inference_mode():
        cvp = model.cv_params(model.full_from_var(pos))
        q = cvp[:, 0, 4].contiguous()
        x1 = xl1(q)
        rd = (cvp[..., 6] * x1[:, None]).contiguous()
    for dt in (F32, F64):
        for w, sens in ((1024, False), (256, True)):
            a = [t[:w].to(dt).contiguous() for t in (q, rd, x1)]

            def k2():
                return stream.stream_impacts_kernel(*a, lp.stream_steps,
                                                    with_sens=sens)
            kernels[f"k2_{str(dt)[6:]}{'_sens' if sens else ''}"] = {
                "ms": event_ms(k2, 5), "sha256": digest(k2())}
    roche_kernels(lp, pos, kernels)
    sweep_kernels(lp, pos, lpw, posw, kernels)
    print(json.dumps({"root": root, "card": torch.cuda.get_device_name(0),
                      "eval_ms": ev, "value_and_grad_ms": vg,
                      "eval_sha256": eval_digests(model, pos, lpw, posw),
                      "gp_eval_ms": gp_turns(spec, pos, kernels),
                      **sampler_turns(lpw, model.var_start()),
                      "kernels": kernels}))


def sampler_turns(lpw, start):
    """{hmc_step_s, nuts_step_s: two turns each, nuts_depth: the mean
    depth of each NUTS step}: one hmc_step of 16 leapfrog steps and one
    nuts_step of max depth 6 at 256 chains of ``lpw``, each from the same
    chain ball around ``start`` at init_hmc's step size, after one
    warm-up step."""
    from lfit_python_tpu_torch.sampling.hmc import hmc_step, init_hmc
    from lfit_python_tpu_torch.sampling.nuts import nuts_step

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    x0 = torch.tensor(start, dtype=F32, device=DEV)
    hs = init_hmc(gen, x0, 1e-3 * x0.abs() + 1e-6, lpw, 256)
    depths = []

    def nuts():
        depths.append(nuts_step(hs, lpw, gen, max_depth=6)[4].item())

    out = {}
    for name, step in (("hmc_step_s", lambda: hmc_step(hs, lpw, gen, 16)),
                       ("nuts_step_s", nuts)):
        step()
        out[name] = [ms / 1e3 for ms in turns(step, n_turns=2, reps=1)]
    return {**out, "nuts_depth": depths}


def eval_digests(model, pos, lpw, posw):
    """{mode: digest}: of ln p and the model flux of one float32, float64
    and precise evaluation of ``model`` at ``pos``, and of ``lpw``'s
    value_and_grad at ``posw``."""
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    out = {}
    for mode, config, dt in (("float32", CVConfig(), F32),
                             ("float64", CVConfig(), F64),
                             ("precise", CVConfig(mixed_precision=True),
                              F32)):
        post = make_ln_prob(model, config, dtype=dt, device=DEV)
        p = pos.to(dt)
        with torch.inference_mode():
            out[mode] = digest([post(p), post.model_flux(p)])
    out["value_and_grad"] = digest(lpw.value_and_grad(posw))
    return out


def roche_kernels(lp, pos, kernels):
    """Add K4's, K5's and K6's times and digests, on the inputs the first
    call of each wrapper gets in one evaluation of ``lp`` at ``pos``, in
    float32 and float64, to ``kernels``; nothing for a checkout without
    them."""
    try:
        from lfit_python_tpu_torch.ops import roche
    except ImportError:
        return
    names = {"findi": 4, "xl1": 5, "lobe_radius": 6}
    with contextlib.ExitStack() as stack, torch.inference_mode():
        recs = {n: stack.enter_context(mock.patch.object(
            roche, f"{n}_kernel", wraps=getattr(roche, f"{n}_kernel")))
            for n in names}
        lp(pos)
    for name, rec in recs.items():
        fn = getattr(roche, f"{name}_kernel")
        for dt in (F32, F64):
            args = [a.to(dt) for a in rec.call_args_list[0].args]
            kernels[f"k{names[name]}_{str(dt)[6:]}"] = {
                "solves": args[0].numel(),
                "ms": event_ms(lambda: fn(*args), 20),
                "traced_us": traced_us(lambda: fn(*args), f"{name}_kernel"),
                "sha256": digest([fn(*args)])}


def sweep_kernels(lp, pos, lpw, posw, kernels):
    """Add K7's and K8's times and digests, on the inputs of the first
    call of each wrapper in one evaluation of ``lp`` at ``pos`` (the
    disc, the donor curve; and K8's second, the normaliser), and their
    backward kernels', on those of the
    largest call in one value_and_grad of ``lpw`` at ``posw``, float32
    and float64, to ``kernels``; nothing for a checkout without them."""
    try:
        from lfit_python_tpu_torch.ops import sweeps
    except ImportError:
        return
    names = {"element_curve": "k7", "donor_sum": "k8",
             "element_curve_backward": "k7_backward",
             "donor_sum_backward": "k8_backward"}

    def recorded(run):
        with contextlib.ExitStack() as stack:
            recs = {n: stack.enter_context(mock.patch.object(
                sweeps, f"{n}_kernel", wraps=getattr(sweeps, f"{n}_kernel")))
                for n in names}
            run()
        return {n: [[a.detach() if isinstance(a, torch.Tensor) else a
                     for a in c.args] for c in r.call_args_list]
                for n, r in recs.items()}

    def forward():
        with torch.inference_mode():
            lp(pos)
    fwd = recorded(forward)
    bwd = recorded(lambda: lpw.value_and_grad(posw))
    rows = [(key, name, max(bwd[name] if name.endswith("backward")
                            else fwd[name][:1],
                            key=lambda a: a[0].shape[1] * a[2].shape[-1]))
            for name, key in names.items()]
    # and K8 on the donor's normaliser (its second call: P = 1)
    rows.append(("k8_p1", "donor_sum", fwd["donor_sum"][1]))
    for key, name, args in rows:
        fn = getattr(sweeps, f"{name}_kernel")
        for dt in (F32, F64):
            a = [x.to(dt) if isinstance(x, torch.Tensor)
                 and x.is_floating_point() else x for x in args]
            kernels[f"{key}_{str(dt)[6:]}"] = {
                "shape": [a[0].shape[0], a[0].shape[1], a[2].shape[-1]],
                "ms": event_ms(lambda: fn(*a), 20),
                "traced_us": traced_us(lambda: fn(*a), f"{name}_kernel"),
                "sha256": digest([x for x in fn(*a) if x is not None]
                                 if name.endswith("backward") else [fn(*a)])}


def k1_mode_rows(contacts, model, pos):
    """{mode: (K1 wrapper, its arguments)}: the call one float64 (f64) and
    one precise (mixed) evaluation of ``model`` at the walkers ``pos``
    make of K1's float64 and mixed-precision wrappers."""
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    out = {}
    for mode, wrapper, config, dt in (
            ("f64", "element_intervals_kernel", CVConfig(), F64),
            ("mixed", "element_intervals_mixed_kernel",
             CVConfig(mixed_precision=True), F32)):
        post = make_ln_prob(model, config, dtype=dt, device=DEV)
        fn = getattr(contacts, wrapper)
        with mock.patch.object(contacts, wrapper, wraps=fn) as rec, \
                torch.inference_mode():
            post(pos.to(dt))
        out[mode] = (fn, rec.call_args.args)
    return out


def k1_backward(contacts, rows):
    """ms of the backward pass of ``element_intervals_diff`` on ``rows``
    (a forward and backward less a forward) and a digest of its six
    gradients, for a seeded cotangent on both edges."""
    cot = torch.randn(rows[2].shape, generator=torch.Generator(
        device=DEV).manual_seed(1), dtype=F32, device=DEV)

    def run(backward):
        leaves = [a.clone().requires_grad_() for a in rows[:6]]
        with torch.enable_grad():
            pin, pout, _ = contacts.element_intervals_diff(*leaves, rows[6])
        if backward:
            return torch.autograd.grad([pin, pout], leaves, [cot, cot],
                                       allow_unused=True)

    grads = [torch.zeros(()) if g is None else g for g in run(True)]
    pin, pout, ecl = contacts.element_intervals(*rows[:7])
    b32 = [*rows[:6], pin, pout, ecl, cot, cot]
    b64 = [a if a.dtype == torch.bool else a.double() for a in b32]

    def kernel32():
        return contacts.contact_backward_kernel(*b32)

    return {"ms": event_ms(lambda: run(True), 5)
            - event_ms(lambda: run(False), 5),
            "rows": list(rows[2].shape), "sha256": digest(grads),
            "kernel_ms": event_ms(kernel32, 20),
            "kernel64_ms": event_ms(
                lambda: contacts.contact_backward_kernel(*b64), 20),
            "kernel_traced_us": traced_us(kernel32,
                                          "contacts_backward_kernel"),
            "kernel_sha256": digest(kernel32())}


def gp_turns(spec, pos, kernels):
    """ms per GP evaluation (three turns), adding K3's time and digest
    to ``kernels``; None for a checkout without the GP likelihood."""
    try:
        from lfit_python_tpu_torch.ops import gp
    except ImportError:
        return None
    from lfit_python_tpu_torch.examples import build_model
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    lp = make_ln_prob(build_model(use_gp=True, **spec).compile(), dtype=F32,
                      device=DEV)
    pos = walkers(lp.model.var_start(), pos.shape[0], 0)
    with mock.patch.object(gp, "segmented_matern32_kernel",
                           wraps=gp.segmented_matern32_kernel) as rec:
        lp(pos)
    out = turns(lambda: lp(pos))
    # copies: the evaluation made its tensors in inference mode, and
    # autograd records none of those
    args = [t.clone() for t in rec.call_args.args]
    kw = {k: v.clone() for k, v in rec.call_args.kwargs.items()}
    for dt in (F32, F64):
        a = [t.to(dt) for t in args]

        def k3():
            return gp.segmented_matern32_kernel(*a, **kw)
        kernels[f"k3_{str(dt)[6:]}"] = {"ms": event_ms(k3, 20),
                                        "traced_us": traced_us(k3,
                                                               "gp_kernel"),
                                        "sha256": digest([k3()])}
        if not hasattr(gp, "BACKWARD_LAUNCHES"):
            continue
        # the gradient path's width: y, sigma2 and c of 256 walkers
        t, y, yerr, sigma2, c = a
        leaves = [v[:256].detach().requires_grad_() for v in (y, sigma2, c)]
        kw256 = {k: v[:256] if v.dim() == 3 else v for k, v in kw.items()}

        def k3_forward():
            with torch.enable_grad():
                return gp.segmented_matern32_kernel(
                    t, leaves[0], yerr, leaves[1], leaves[2], **kw256)

        ll = k3_forward()
        cot = torch.ones_like(ll)

        def k3_backward():
            return torch.autograd.grad(ll, leaves, cot, retain_graph=True)
        kernels[f"k3_backward_{str(dt)[6:]}"] = {
            "forward_ms": event_ms(k3_forward, 20),
            "ms": event_ms(k3_backward, 20),
            "sha256": digest(k3_backward())}
    return out


if __name__ == "__main__":
    main()
