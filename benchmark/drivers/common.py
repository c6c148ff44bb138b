"""What both kinds of cell share: the state built from the seed, the
likelihood that records what the program asks of it, the episode's own
seeds, and the profiled slice with its reduction to device time."""
from __future__ import annotations

import importlib
import time
from contextlib import contextmanager

import numpy as np
import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed drawn from (seed, tags): every stream of a run has its
    own, and the same seed gives the same streams."""
    ss = np.random.SeedSequence([int(seed), *[int(t) for t in tags]])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def program_seed(seed: int, *tags: int) -> int:
    """A 32-bit seed for the program: its seeding writes the seed into
    PYTHONHASHSEED, which a child interpreter refuses above 2**32 - 1."""
    return sub_seed(seed, *tags) % 2**32


class RecordingLikelihood:
    """The configuration's toy as the program's likelihood: every point the
    program asks for is kept (physical coordinates) while ``recording``."""

    def __init__(self, loglike):
        self.loglike = loglike
        self.points = []
        self.recording = True

    def __call__(self, x):
        if self.recording:
            self.points.append(np.array(x, dtype=np.float64))
        return self.loglike(x)


def make_toy(spec):
    """The configuration's likelihood, found by its name: ``make(spec)`` of
    ``benchmark/toys/<spec["toy"]>.py``."""
    return importlib.import_module(
        f"{__package__.rsplit('.', 1)[0]}.toys.{spec['toy']}").make(spec)


def build_state(cfg, cell, seed, device, bobe_cls):
    """Set-up's state: the configuration's initial design (the program's
    Sobol draw), seeded rows about the posterior up to the cell's
    ``n_state`` evaluations, and one BOBE built on them, which fits the GP
    (and trains the gate). The rows are one set for every seed, drawn from
    the cell's ``state_seed``, and the run's seed gives them in its own
    order: every seed gets the same work, and the seed moves only its order
    and the window's random streams. Returns (bobe, info), info holding
    what the reference needs: the toy, bounds, the set-up rows in physical
    coordinates."""
    loglike, bounds, names, logz_true, draws = make_toy(cfg["likelihood"])
    bobe_kw = dict(cfg["bobe"])
    minus_inf = float(bobe_kw.get("minus_inf", -1e10))
    n_sobol = int(bobe_kw["n_sobol_init"])
    n_draws = int(cell["n_state"]) - n_sobol
    state_seed = int(cell["state_seed"])
    rng = np.random.default_rng(sub_seed(state_seed, 1))
    init_x, init_y = draws(loglike, bounds, n_draws, rng, minus_inf=minus_inf)
    order = np.random.default_rng(sub_seed(seed, 1)).permutation(n_draws)
    init_x, init_y = init_x[order], init_y[order]
    lik = RecordingLikelihood(loglike)
    bobe = bobe_cls(loglikelihood=lik, param_list=names, param_bounds=bounds,
                    init_train_x=init_x, init_train_y=init_y,
                    seed=program_seed(state_seed, 2), verbosity="WARNING",
                    device=device, **bobe_kw)
    lik.recording = False
    rows = np.vstack([np.asarray(lik.points).reshape(-1, bounds.shape[1]),
                      init_x])
    info = {"loglike": loglike, "bounds": bounds, "logz_true": logz_true,
            "rows_phys": rows, "minus_inf": minus_inf, "lik": lik}
    return bobe, info


def log_params_of(gp):
    """[log lengthscales, log amplitude] of the GP's state, on the host."""
    st = gp.state
    return np.concatenate([st.log_ls.detach().cpu().numpy(),
                           [float(st.log_amp)]])


def log_params_ref(gp):
    """Device copies of the GP's log lengthscales and log amplitude, taken
    with no read to the host (a record inside the window)."""
    st = gp.state
    return st.log_ls.detach().clone(), st.log_amp.detach().clone()


@contextmanager
def record_fit_gradients(holder):
    """While open, ``holder["last"]`` is what the latest GP hyperparameter
    fit of the program began from: the log hyperparameters of its restarts
    (``x``) and the gradient its objective gave its optimizer there
    (``grad``), device copies both. The fit is the program's one call of its
    bounded multi-restart minimizer that asks for every endpoint."""
    from bobe_tpu_torch.ops import optimize as opt

    base = opt.minimize_restarts

    def recording(fun, x0, *a, **k):
        if not k.get("return_all"):
            return base(fun, x0, *a, **k)
        first = {}

        def hooked(x):
            if not first and x.requires_grad:
                first["x"] = x.detach().clone()
                x.register_hook(
                    lambda g: first.setdefault("grad", g.detach().clone()))
            return fun(x)

        holder["last"] = first
        return base(hooked, x0, *a, **k)

    opt.minimize_restarts = recording
    try:
        yield
    finally:
        opt.minimize_restarts = base


# --------------------------------------------------------------- profiling

def gram_kind(name):
    """The Gram kernel a device operation's name is, or None: the forward,
    the backward in the lengthscales and amplitude, or its coordinate
    variant (the template's NEED_X true)."""
    if "gram_masked_fwd" in name:
        return "forward"
    if "gram_masked_bwd" in name:
        return "backward_x" if "true>" in name else "backward"
    return None


@contextmanager
def launch_shapes(out):
    """Record (kind, cap, d, lanes, per_lane) of every Gram kernel launch,
    in order, while the context is open."""
    from bobe_tpu_torch.ops import kernels as kr

    fwd, bwd = kr.launch_forward, kr.launch_backward

    def rec_fwd(name, x, mask, ls, amp, noise, o, *a, **k):
        out.append(("forward", o.shape[-1], x.shape[-1], o.shape[0],
                    x.dim() == 3))
        return fwd(name, x, mask, ls, amp, noise, o, *a, **k)

    def rec_bwd(name, x, mask, ls, amp, grad, *a, **k):
        kind = "backward_x" if k.get("grad_x") is not None else "backward"
        out.append((kind, grad.shape[-1], x.shape[-1], grad.shape[0],
                    x.dim() == 3))
        return bwd(name, x, mask, ls, amp, grad, *a, **k)

    kr.launch_forward, kr.launch_backward = rec_fwd, rec_bwd
    try:
        yield
    finally:
        kr.launch_forward, kr.launch_backward = fwd, bwd


def profile_slice(fn, device, spans):
    """Run ``fn`` once under torch.profiler (device activity only; on the
    CPU, without it, and with nothing read from a trace) and
    reduce its trace: wall seconds, busy seconds (the union of the device
    operations' intervals), the device operations by name, the idle gaps
    named by the host span they fall in, and the Gram launches' device
    times with their shapes. ``spans`` is a list the caller's code fills
    with (name, t_start, t_end) host times during ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    shapes = []
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        result = fn()
        return {"wall_s": time.perf_counter() - t0, "launches": 0,
                "result": result, "shapes": shapes}
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with launch_shapes(shapes):
            result = fn()
        sync(device)
        wall = time.perf_counter() - t0
    evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda t: t[0])
    out = {"wall_s": wall, "launches": len(evs), "result": result,
           "shapes": shapes}
    if not evs:
        return out
    busy, gaps = 0.0, []
    cur_s, cur_e = evs[0][0], evs[0][1]
    for s, e, name in evs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for s, e, name in evs:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    # host spans are placed on the trace's clock by its first operation
    base = evs[0][0]

    def span_at(t_us):
        t = t0 + (t_us - base) * 1e-6
        inside = [n for n, a, b in spans if a <= t <= b]
        return inside[-1] if inside else "harness"

    gaps.sort(key=lambda g: -g[0])
    out.update(
        busy_s=busy * 1e-6,
        device_ops=sorted(([n, v] for n, v in by_name.items()),
                          key=lambda t: -t[1])[:10],
        idle_gaps=[[f"{span_at(at)} before {name[:60]}", g * 1e-6]
                   for g, at, name in gaps[:10]],
        gram=[(gram_kind(name), (e - s) * 1e-6)
              for s, e, name in evs if gram_kind(name)])
    return out
