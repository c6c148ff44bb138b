"""The port's CUDA kernels on the card. Every test here is marked ``cuda`` and
skips without a card; this file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from bobe_tpu_torch.models import gp as tgp
from bobe_tpu_torch.ops import kernels as tkr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(cap, n, d, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(cap, d))
    mask = (np.arange(cap) < n).astype(np.float64)
    ls = rng.uniform(0.05, 2.0, size=d)
    amp = float(rng.uniform(0.5, 3.0))
    return [torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)
            for a in (x, mask, ls, amp)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rbf", "matern"])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-10, 1e-12),
                                             (torch.float32, 2e-5, 2e-5)])
def test_gram_kernel_matches_plain_on_card(cuda, name, dtype, rtol, atol):
    """The kernel against its plain version computed in float64 on the card
    (atol relative to the amplitude); the pad block exactly the identity and
    the result exactly symmetric."""
    n = 700
    args = _inputs(1000, n, 8, seed=2, device=cuda)
    amp = float(args[3])
    before = tkr.gram_masked.launches
    got = tkr.gram_masked(name, *(a.to(dtype) for a in args), 1e-6)
    torch.cuda.synchronize()
    assert tkr.gram_masked.launches == before + 1
    want = tkr.gram_masked_plain(name, *args, 1e-6)
    err = (got.double() - want).abs()
    assert bool((err <= atol * amp + rtol * want.abs()).all())
    assert torch.equal(got, got.T)
    assert torch.equal(got[n:, n:], torch.eye(1000 - n, dtype=dtype,
                                              device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n", [(1000, 700), (1001, 650)])
def test_gram_kernel_lanes_match_plain_on_card(cuda, cap, n):
    """Four restart lanes from one launch, lane r against the plain build at
    lane r's hyperparameters; exact symmetry and an exact identity pad
    block in every lane. cap 1001 takes the scalar edge stores, cap 1000
    the 16-byte ones."""
    x, mask, _, _ = _inputs(cap, n, 8, seed=4, device=cuda)
    rng = np.random.default_rng(5)
    ls = torch.as_tensor(rng.uniform(0.05, 2.0, size=(4, 8)), device=cuda)
    amp = torch.as_tensor(rng.uniform(0.5, 3.0, size=4), device=cuda)
    before = tkr.gram_masked.launches
    got = tkr.gram_masked("matern", x, mask, ls, amp, 1e-6)
    torch.cuda.synchronize()
    assert tkr.gram_masked.launches == before + 1
    eye = torch.eye(cap - n, dtype=torch.float64, device=cuda)
    for r in range(4):
        want = tkr.gram_masked_plain("matern", x, mask, ls[r], amp[r], 1e-6)
        err = (got[r] - want).abs()
        assert bool((err <= 1e-12 * float(amp[r]) + 1e-10 * want.abs()).all())
        assert torch.equal(got[r], got[r].T)
        assert torch.equal(got[r, n:, n:], eye)
        assert float(got[r, n:, :n].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rbf", "matern"])
@pytest.mark.parametrize("d,lanes", [(40, 4), (64, 1)])
def test_gram_kernels_stage_many_dimensions_on_card(cuda, name, d, lanes):
    """Above 32 dimensions both kernels stage the scaled panels in chunks of
    32 (d=40: a full and a partial chunk; d=64: two full ones). Lengthscales
    grow with d so that the correlations stay of order one. The forward
    against the plain build, exactly symmetric with an exact identity pad
    block; the backward against the plain backward as in
    test_gram_backward_kernel_matches_plain_on_card."""
    cap, n = 300, 210
    x, mask, _, _ = _inputs(cap, n, d, seed=8, device=cuda)
    rng = np.random.default_rng(9)
    ls = torch.as_tensor(rng.uniform(0.5, 4.0, size=(lanes, d)), device=cuda)
    amp = torch.as_tensor(rng.uniform(0.5, 3.0, size=lanes), device=cuda)
    got = tkr.gram_masked(name, x, mask, ls, amp, 1e-6)
    want = tkr.gram_masked_plain(name, x, mask, ls, amp, 1e-6)
    err = (got - want).abs()
    assert bool((err <= 1e-12 * amp[:, None, None] + 1e-10 * want.abs()).all())
    assert float(want[:, :n, :n].min()) > 1e-6  # correlations of order one
    assert torch.equal(got, got.transpose(-1, -2))
    assert torch.equal(got[:, n:, n:], torch.eye(
        cap - n, dtype=torch.float64, device=cuda).expand(lanes, -1, -1))
    g = torch.as_tensor(rng.normal(size=(lanes, cap, cap)), device=cuda)
    grads = tkr.gram_masked_backward(name, x, mask, ls, amp, g)
    want = tkr.gram_masked_backward_plain(name, x, mask, ls, amp, g)
    scale = tkr.gram_masked_backward_plain(name, x, mask, ls, amp, g.abs())
    for k, w, s in zip(grads, want, scale):
        assert bool(((k - w).abs() <= 1e-10 * s).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rbf", "matern"])
@pytest.mark.parametrize("cap,d,lanes", [(200, 3, 1), (1280, 30, 4)])
def test_gram_backward_kernel_matches_plain_on_card(cuda, name, cap, d,
                                                    lanes):
    """The backward kernel against the plain backward on the card, within
    1e-10 * sum_ij |G_ij dK_ij/dtheta| per component (the two sum in
    different orders), with pad rows and a non-symmetric G; two launches
    give bit-identical gradients."""
    x, mask, _, _ = _inputs(cap, int(0.7 * cap), d, seed=6, device=cuda)
    rng = np.random.default_rng(7)
    ls = torch.as_tensor(rng.uniform(0.05, 2.0, size=(lanes, d)),
                         device=cuda)
    amp = torch.as_tensor(rng.uniform(0.5, 3.0, size=lanes), device=cuda)
    g = torch.as_tensor(rng.normal(size=(lanes, cap, cap)), device=cuda)
    before = tkr.gram_masked_backward.launches
    got = tkr.gram_masked_backward(name, x, mask, ls, amp, g)
    again = tkr.gram_masked_backward(name, x, mask, ls, amp, g)
    torch.cuda.synchronize()
    assert tkr.gram_masked_backward.launches == before + 2
    want = tkr.gram_masked_backward_plain(name, x, mask, ls, amp, g)
    scale = tkr.gram_masked_backward_plain(name, x, mask, ls, amp, g.abs())
    for k, w, s, a in zip(got, want, scale, again):
        assert bool(((k - w).abs() <= 1e-10 * s).all())
        assert torch.equal(k, a)


@pytest.mark.cuda
def test_gram_kernel_refuses_what_it_cannot_do(cuda):
    """The gradient in the lengthscales and amplitude runs both kernels (the
    launch counts move, never a plain path); a gradient in x runs the
    coordinate variant of the backward kernel, a gradient in the mask
    raises, as do a float32 backward, mixed dtypes and non-contiguous
    inputs."""
    x, mask, ls, amp = _inputs(256, 100, 4, seed=3, device=cuda)
    fwd, bwd = tkr.gram_masked.launches, tkr.gram_masked_backward.launches
    tls = ls.clone().requires_grad_(True)
    K = tkr.gram_masked("rbf", x, mask, tls, amp, 1e-6)
    (g,) = torch.autograd.grad(K.sum(), tls)
    assert bool(torch.isfinite(g).all())
    assert (tkr.gram_masked.launches, tkr.gram_masked_backward.launches) \
        == (fwd + 1, bwd + 1)
    bx = tkr.gram_masked_backward_x.launches
    tx = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(
        tkr.gram_masked("rbf", tx, mask, ls, amp, 1e-6).sum(), tx)
    assert tkr.gram_masked_backward_x.launches == bx + 1
    assert bool(torch.isfinite(gx).all())
    with pytest.raises(ValueError, match="mask"):
        tkr.gram_masked("rbf", x, mask.clone().requires_grad_(True), ls, amp,
                        1e-6)
    x32, m32, l32, a32 = (t.float() for t in (x, mask, ls, amp))
    K32 = tkr.gram_masked("rbf", x32, m32, l32.requires_grad_(True), a32,
                          1e-6)
    with pytest.raises(TypeError):
        K32.sum().backward()
    with pytest.raises(ValueError):
        tkr.gram_masked("rbf", x, mask.float(), ls, amp, 1e-6)
    with pytest.raises(ValueError):
        tkr.gram_masked("rbf", x.T.contiguous().T, mask, ls, amp, 1e-6)


@pytest.mark.cuda
def test_neg_mll_gram_route_matches_perdim_route_on_card(cuda):
    """The fit's objective over 3 lanes at cap 256, d=8 on the card: through
    the two kernels (dsq_perdim=None) against the per-dimension slab sum
    under torch autograd, value and gradient, at the tolerances the CPU
    holds the Gram route to against the JAX package."""
    rng = np.random.default_rng(14)
    x = rng.uniform(size=(230, 8))
    y = -0.5 * np.sum(((x - 0.5) / 0.25) ** 2, axis=1)
    y = y + 0.01 * rng.normal(size=230)
    gp = tgp.GP(train_x=x, train_y=y, noise=1e-6, device=cuda)
    assert gp.state.cap == 256
    lps = torch.as_tensor(np.random.default_rng(15).uniform(
        np.log(0.2), np.log(2.0), size=(3, 9)), device=cuda)
    out = {}
    for route, dsq in (("gram", None),
                       ("perdim", tkr.sq_dist_perdim(gp.state.x))):
        lp = lps.clone().requires_grad_(True)
        before = tkr.gram_masked_backward.launches
        v = tgp.neg_mll(gp.state, gp.cfg, lp, dsq_perdim=dsq)
        (g,) = torch.autograd.grad(v.sum(), lp)
        out[route] = (v.detach().cpu().numpy(), g.cpu().numpy())
        assert tkr.gram_masked_backward.launches == before + (dsq is None)
    np.testing.assert_allclose(out["gram"][0], out["perdim"][0], rtol=1e-9)
    np.testing.assert_allclose(out["gram"][1], out["perdim"][1], rtol=1e-7,
                               atol=1e-9)


@pytest.mark.cuda
def test_fit_above_the_perdim_budget_on_card(cuda, monkeypatch):
    """With the per-dimension budget at 0 the fit runs every objective
    through the forward and backward kernels, and reaches the neg_mll of the
    same fit on the CPU (plain versions) from the same x0 to 1e-7 relative.
    The targets carry 1 % noise and the fit runs to its optimum, which is
    then interior and well determined; short fits on noiseless targets end
    at points that roundoff decides (ROADMAP queue 3)."""
    monkeypatch.setattr(tgp, "PERDIM_MAX_BYTES", 0)
    rng = np.random.default_rng(16)
    x = rng.uniform(size=(60, 3))
    y = -0.5 * np.sum(((x - 0.5) / 0.25) ** 2, axis=1)
    y = y + 0.01 * rng.normal(size=60)
    x0 = np.vstack([np.zeros(4),
                    rng.uniform(np.log(0.05), np.log(3.0), size=(3, 4))])
    fwd, bwd = tkr.gram_masked.launches, tkr.gram_masked_backward.launches
    f_card = -tgp.GP(train_x=x, train_y=y, noise=1e-8, device=cuda).fit(
        x0=x0, maxiter=100)["mll"]
    assert tkr.gram_masked.launches > fwd
    assert tkr.gram_masked_backward.launches > bwd
    f_cpu = -tgp.GP(train_x=x, train_y=y, noise=1e-8, device="cpu").fit(
        x0=x0, maxiter=100)["mll"]
    assert abs(f_card - f_cpu) <= 1e-7 * abs(f_cpu), (f_card, f_cpu)


def _lane_inputs(lanes, cap, n, d, seed, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=device)
    return (t(rng.uniform(size=(lanes, cap, d))),
            t((np.arange(cap) < n).astype(np.float64)),
            t(rng.uniform(0.1, 1.0, size=(lanes, d))),
            t(rng.uniform(0.5, 3.0, size=lanes)),
            t(rng.normal(size=(lanes, cap, cap))))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rbf", "matern"])
@pytest.mark.parametrize("lanes,cap,n,d", [(1, 384, 300, 6), (8, 384, 300, 6),
                                           (4, 1280, 1200, 30)])
def test_per_lane_forward_matches_plain_on_card(cuda, name, lanes, cap, n,
                                                d):
    """One set of coordinates per lane (the input warp's fit): every lane
    against the plain build, exactly symmetric, identity pad block."""
    x, mask, ls, amp, _ = _lane_inputs(lanes, cap, n, d, 31, cuda)
    before = (tkr.gram_masked.launches, tkr.gram_masked.launches_lane_x)
    got = tkr.gram_masked(name, x, mask, ls, amp, 1e-6)
    assert (tkr.gram_masked.launches, tkr.gram_masked.launches_lane_x) == \
        (before[0] + 1, before[1] + 1)
    want = tkr.gram_masked_plain(name, x, mask, ls, amp, 1e-6)
    err = (got - want).abs()
    assert bool((err <= 1e-12 * amp[:, None, None]
                 + 1e-10 * want.abs()).all())
    assert torch.equal(got, got.transpose(-1, -2))
    eye = torch.eye(cap - n, dtype=torch.float64, device=cuda)
    assert torch.equal(got[:, n:, n:], eye.expand(lanes, -1, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rbf", "matern"])
@pytest.mark.parametrize("lanes,cap,n,d", [(8, 384, 300, 6),
                                           (4, 1280, 1200, 30),
                                           (8, 200, 150, 6),
                                           (8, 256, 209, 6),
                                           (8, 300, 250, 6),
                                           (8, 330, 300, 6),
                                           (4, 300, 210, 40),
                                           (1, 384, 300, 6)])
def test_backward_x_matches_plain_on_card(cuda, name, lanes, cap, n, d):
    """dL/dx (and the lengthscale and amplitude parts) of the coordinate
    variant against the plain backward for a cotangent that is not
    symmetric, within 1e-10 of the largest term; pad rows exactly 0; two
    launches bit-identical; the hyperparameter-only kernel unchanged. The
    shapes take 32-row tiles (caps 200, 256, 300 at 8 lanes, ragged ones
    among them), 64-row tiles (caps 330 and 384 at 8 lanes, 1280 at 4, the
    last folding each row tile's 20 contributions in 4 runs), d=40 (two
    chunks of dimensions) and one lane."""
    x, mask, ls, amp, g = _lane_inputs(lanes, cap, n, d, 32, cuda)
    got = tkr.gram_masked_backward_x(name, x, mask, ls, amp, g)
    again = tkr.gram_masked_backward_x(name, x, mask, ls, amp, g)
    want = tkr.gram_masked_backward_plain(name, x, mask, ls, amp, g,
                                          need_x=True)
    for k, a, w in zip(got, again, want):
        assert torch.equal(k, a)
        assert float((k - w).abs().max()) <= 1e-10 * float(w.abs().max()) \
            * cap
    assert bool((got[2][:, n:] == 0).all())
    ls_only = tkr.gram_masked_backward(name, x, mask, ls, amp, g)
    for k, w in zip(ls_only, want[:2]):
        assert float((k - w).abs().max()) <= 1e-10 * float(w.abs().max()) \
            * cap


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,cap,n,d", [(8, 256, 209, 6),
                                           (4, 1280, 1200, 30)])
def test_backward_x_tickets_reset_on_card(cuda, lanes, cap, n, d):
    """The coordinate backward folds through integer tickets in a buffer
    that persists between calls: after each of two calls in a row on the
    current stream every ticket is back at 0, each call is one counted
    launch, and the two agree bit for bit."""
    x, mask, ls, amp, g = _lane_inputs(lanes, cap, n, d, 35, cuda)
    before = tkr.gram_masked_backward_x.launches
    runs = []
    for _ in range(2):
        runs.append(tkr.gram_masked_backward_x("rbf", x, mask, ls, amp, g))
        torch.cuda.synchronize()
        tickets = tkr.ticket_buffer(torch.cuda.current_stream(cuda), 0)
        assert int(tickets.abs().sum()) == 0
    assert tkr.gram_masked_backward_x.launches == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_x_on_two_streams_on_card(cuda):
    """Coordinate backwards enqueued on two side streams at once (two
    shapes, several calls each, interleaved) each draw on their own
    stream's tickets: every result equals the same call's on the current
    stream bit for bit, and both streams' tickets end at 0."""
    cases = [_lane_inputs(8, 256, 209, 6, 36, cuda),
             _lane_inputs(4, 1280, 1200, 30, 37, cuda)]
    want = [tkr.gram_masked_backward_x("rbf", *c) for c in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    got = [[] for _ in cases]
    for _ in range(4):
        for c, s, out in zip(cases, streams, got):
            with torch.cuda.stream(s):
                out.append(tkr.gram_masked_backward_x("rbf", *c))
    torch.cuda.synchronize()
    for w, outs in zip(want, got):
        for res in outs:
            for a, b in zip(res, w):
                assert torch.equal(a, b)
    for s in streams:
        assert int(tkr.ticket_buffer(s, 0).abs().sum()) == 0


def _device_ops(fn):
    """Device operations (kernels, copies, sets) that ``fn`` launches, from
    torch.profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,cap,n,d", [(1, 128, 90, 8), (4, 1280, 1200, 30)])
def test_backward_one_launch_and_tickets_reset_on_card(cuda, lanes, cap, n,
                                                        d):
    """The hyperparameter backward is one device launch a call (tile edge
    32 at cap 128, 64 at cap 1280) and leaves every ticket of its stream at
    0 after each of two calls in a row, which agree bit for bit; each call
    counts one launch."""
    x, mask, ls, amp, g = _lane_inputs(lanes, cap, n, d, 38, cuda)
    x = x[0].contiguous()
    tkr.gram_masked_backward("rbf", x, mask, ls, amp, g)  # the ticket buffer
    before = tkr.gram_masked_backward.launches
    runs = []
    for _ in range(2):
        runs.append(tkr.gram_masked_backward("rbf", x, mask, ls, amp, g))
        torch.cuda.synchronize()
        tickets = tkr.ticket_buffer(torch.cuda.current_stream(cuda), 0)
        assert int(tickets.abs().sum()) == 0
    assert tkr.gram_masked_backward.launches == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert _device_ops(
        lambda: tkr.gram_masked_backward("rbf", x, mask, ls, amp, g)) == 1


@pytest.mark.cuda
def test_backwards_interleaved_on_streams_on_card(cuda):
    """Hyperparameter and coordinate backwards, which share a stream's
    ticket buffer, interleaved on the current stream and on two side
    streams (each stream running both kinds in turn): every result equals
    the same call alone bit for bit, and every ticket ends at 0."""
    cases = []
    for lanes, cap, n, d, seed in ((8, 256, 209, 6, 39),
                                   (4, 1280, 1200, 30, 40)):
        x, mask, ls, amp, g = _lane_inputs(lanes, cap, n, d, seed, cuda)
        cases.append(("ls", (x[0].contiguous(), mask, ls, amp, g)))
        cases.append(("x", (x, mask, ls, amp, g)))
    call = {"ls": lambda a: tkr.gram_masked_backward("rbf", *a),
            "x": lambda a: tkr.gram_masked_backward_x("rbf", *a)}
    want = [call[kind](a) for kind, a in cases]
    got = [[] for _ in cases]
    for _ in range(3):
        for i, (kind, a) in enumerate(cases):
            got[i].append(call[kind](a))
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    for rnd in range(4):
        # even rounds: one kind a stream; odd rounds: one shape a stream,
        # both kinds on it
        for i, (kind, a) in enumerate(cases):
            with torch.cuda.stream(streams[i // 2 % 2 if rnd % 2 else i % 2]):
                got[i].append(call[kind](a))
    torch.cuda.synchronize()
    for w, outs in zip(want, got):
        for res in outs:
            for a, b in zip(res, w):
                assert torch.equal(a, b)
    for s in [torch.cuda.current_stream(cuda)] + streams:
        assert int(tkr.ticket_buffer(s, 0).abs().sum()) == 0


def _ns_surrogate(form, device):
    """A small surrogate of each form the port builds: a plain GP, the
    input-warped GP (warp away from the identity), and GPs gated by an SVM,
    an MLP and an ellipsoid (a bump with a failure region at x0 > 0.7)."""
    from bobe_tpu_torch.models.clf_gp import GPwithClassifier
    from bobe_tpu_torch.utils.seed import set_global_seed

    set_global_seed(41)   # the MLP's and the ellipsoid's training
    rng = np.random.default_rng(41)
    x = rng.uniform(size=(60, 2))
    y = -30.0 * np.sum((x - np.array([0.45, 0.5])) ** 2, axis=1)
    kw = dict(noise=1e-6, lengthscales=np.array([0.35, 0.4]),
              kernel_variance=2.0, device=device)
    if form == "plain":
        return tgp.GP(train_x=x, train_y=y, **kw)
    if form == "warp":
        gp = tgp.GP(train_x=x, train_y=y, input_warp=True, **kw)
        w = torch.tensor([0.3, -0.2], dtype=torch.float64, device=device)
        gp.state = tgp.refresh(gp.state._replace(log_wa=w, log_wb=-w),
                               gp.cfg)
        return gp
    y = np.where(x[:, 0] > 0.7, -1e5, y)
    return GPwithClassifier(train_x=x, train_y=y, clf_type=form,
                            clf_use_size=10, minus_inf=-1e5,
                            clf_threshold=100.0, gp_threshold=200.0, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["plain", "warp", "svm", "nn", "ellipsoid"])
def test_ns_graph_replays_match_eager_on_card(cuda, form, monkeypatch):
    """run_nested on the card replays its inner iteration from one CUDA
    graph per run; with the graph holder taken away it runs every
    iteration eagerly. Same seeds, same surrogate: the dead points, their
    values and volumes, the calls and the iterations are equal to the bit,
    the run's generator ends in the same state, the run captured once and
    every inner iteration after the eager warm-up was a replay."""
    from bobe_tpu_torch import samplers as tsamp
    from bobe_tpu_torch.infer import nested as tnest
    from bobe_tpu_torch.utils import trace

    gp = _ns_surrogate(form, cuda)
    assert (getattr(gp, "_clf_ctx", None) is not None) == (
        form in ("svm", "nn", "ellipsoid"))
    apply_fn, ctx = tsamp._gp_loglike(gp)
    live_x, live_l, logvol0, _ = tsamp._seed_live_points(
        gp, lambda x: apply_fn(ctx, x), 60, 2, np.random.default_rng(3))

    def run():
        gen = torch.Generator(device=cuda).manual_seed(12)
        trace.enable()
        try:
            with trace.span("ns.run"):
                res = tnest.run_nested(apply_fn, ctx, 2, gen, dlogz=0.05,
                                       live_x=live_x, live_logl=live_l,
                                       logvol0=logvol0)
            counters = trace.snapshot()["counters"]
        finally:
            trace.disable()
        return res, gen.get_state(), counters

    graphed, g_state, counters = run()
    with monkeypatch.context() as mp:
        mp.setattr(tnest, "_SliceGraph", lambda generator: None)
        eager, e_state, e_counters = run()
    for key in ("dead_x", "dead_logl", "logvol"):
        np.testing.assert_array_equal(getattr(graphed, key),
                                      getattr(eager, key), err_msg=key)
    for key in ("n_calls", "n_iter", "n_inner", "logz"):
        assert getattr(graphed, key) == getattr(eager, key), key
    assert torch.equal(g_state, e_state)
    assert graphed.n_iter > 2 and graphed.success
    assert counters.get("ns.run.captures") == 1
    assert counters.get("ns.inner.graph") == \
        graphed.n_inner - tnest._SliceGraph.WARMUP
    assert "ns.inner.graph" not in e_counters
    assert "ns.run.captures" not in e_counters


@pytest.mark.cuda
def test_warp_fit_on_card(cuda):
    """A warp fit on the card runs every objective through the per-lane
    forward and the dL/dx backward, and reaches the neg_mll of the same fit
    on the CPU (plain versions) from the same x0 to 1e-6 relative."""
    rng = np.random.default_rng(33)
    x = rng.uniform(size=(60, 2))
    y = -0.5 * np.sum(((x ** 2 - 0.3) / 0.25) ** 2, axis=1)
    y = y + 0.01 * np.abs(y).std() * rng.normal(size=60)
    x0 = np.zeros((4, 7))
    x0[1:, :3] = rng.uniform(np.log(0.05), np.log(3.0), size=(3, 3))
    x0[1:, 3:] = rng.normal(0.0, 0.1, size=(3, 4))
    fx, bx = tkr.gram_masked.launches_lane_x, \
        tkr.gram_masked_backward_x.launches
    f_card = -tgp.GP(train_x=x, train_y=y, noise=1e-8, input_warp=True,
                     device=cuda).fit(x0=x0, maxiter=100)["mll"]
    assert tkr.gram_masked.launches_lane_x > fx
    assert tkr.gram_masked_backward_x.launches > bx
    f_cpu = -tgp.GP(train_x=x, train_y=y, noise=1e-8, input_warp=True,
                    device="cpu").fit(x0=x0, maxiter=100)["mll"]
    assert abs(f_card - f_cpu) <= 1e-6 * abs(f_cpu), (f_card, f_cpu)


@pytest.mark.cuda
def test_mesh_on_one_card_named_twice(cuda):
    """chip_smoke.py phase 19 at a small size: sharded predict and WIPStd
    sweep over an uneven batch equal the unsharded calls on the card, and
    NUTS chains split over the mesh equal the same chains run in its
    groups; the split launches no Gram kernel."""
    from bobe_tpu_torch import acquisition as tacq
    from bobe_tpu_torch import samplers as tsamp
    from bobe_tpu_torch.infer.nuts import run_chain
    from bobe_tpu_torch.parallel import mesh as tmesh
    from bobe_tpu_torch.utils.seed import split_generator

    rng = np.random.default_rng(19)
    x = rng.uniform(size=(300, 4))
    gp = tgp.GP(train_x=x, train_y=-np.sum((x - 0.5) ** 2, axis=1) / 0.1,
                noise=1e-6, lengthscales=np.full(4, 0.4), kernel_variance=4.0,
                device=cuda)
    mesh = tmesh.get_mesh([cuda, cuda])
    xq = torch.as_tensor(rng.uniform(size=(101, 4)), device=cuda)
    before = tkr.gram_masked.launches
    mean_s, var_s = tmesh.sharded_predict(gp, xq, mesh)
    acq_s = tmesh.sharded_wip_sweep(gp, xq, True, mesh)
    assert tkr.gram_masked.launches == before
    mean_u, var_u = tgp.predict(gp.state, gp.cfg, xq)
    acq_u = tacq._wip_sweep_core(gp, xq, True)[0]
    # the variance amp + noise - sum V^2 carries an absolute roundoff of
    # its prior scale whatever the batch; the WIPStd values divide by it
    scale = float(torch.exp(gp.state.log_amp) * gp.state.y_std ** 2)
    torch.testing.assert_close(mean_s, mean_u, rtol=1e-12, atol=0)
    torch.testing.assert_close(var_s, var_u, rtol=0, atol=1e-12 * scale)
    torch.testing.assert_close(acq_s, acq_u, rtol=1e-9, atol=0)
    assert mean_s.shape == var_s.shape == acq_s.shape == (101,)
    make_vg, ctx = tsamp._logprob_target(gp, 1.0)
    init = torch.as_tensor(rng.normal(size=(4, 4)), device=cuda)
    kw = dict(num_warmup=16, num_samples=8, thinning=2, max_depth=5)
    gens = lambda: split_generator(
        torch.Generator(device=cuda).manual_seed(3), 4)
    zs_s = tmesh.sharded_nuts(make_vg, ctx, init, gens(), mesh, **kw)[0]
    for r in (slice(0, 2), slice(2, 4)):
        zs_g = run_chain(make_vg(ctx), init[r], gens()[r], **kw)[0]
        assert torch.equal(zs_s[r], zs_g)


@pytest.mark.cuda
def test_server_on_card_matches_the_run_in_process(cuda, tmp_path):
    """chip_smoke.py phase 18 at a small size: a server on the card
    (``--device cuda``) runs a LogEI run for this process, and its result
    equals the same run in this process on the card at rtol 1e-9."""
    import os
    import subprocess
    import sys
    import time

    from bobe_tpu_torch import client as tclient
    from bobe_tpu_torch.bo import BOBE
    from bobe_tpu_torch.models import toys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sock = str(tmp_path / "card.sock")
    env = dict(os.environ, BOBE_TPU_SERVER_ROLE="server")
    env.pop("BOBE_TPU_SERVER", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bobe_tpu_torch.server", "--device", "cuda",
         "--socket", sock, "--idle-timeout", "300"], cwd=repo, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        t0 = time.time()
        while tclient.ping(sock) is None:
            assert proc.poll() is None and time.time() - t0 < 180
            time.sleep(0.2)
        assert tclient.ping(sock)["device"].startswith("cuda")

        def run(**kw):
            return BOBE(loglikelihood=toys.rosenbrock,
                        param_list=toys.rosenbrock_names,
                        param_bounds=toys.rosenbrock_bounds, n_sobol_init=8,
                        seed=3, save=False, verbosity="WARNING", **kw).run(
                acq="logei", max_evals=14, ei_goal=1e-8, fit_n_points=4)

        served = run(server=sock)
        local = run(device=cuda)
        np.testing.assert_allclose(served["best_val"], local["best_val"],
                                   rtol=1e-9)
        np.testing.assert_allclose(served["best_pt"], local["best_pt"],
                                   rtol=1e-9)
        # the client's GP, rebuilt on the CPU with the server's factor,
        # predicts what the GP on the card predicts
        xs = np.linspace(0.1, 0.9, 5)[:, None] * np.ones((5, 2))
        np.testing.assert_allclose(
            served["gp"].predict_mean_batched(xs).numpy(),
            local["gp"].predict_mean_batched(xs).cpu().numpy(), rtol=1e-9)
        assert tclient.ping(sock)["launches"]["gram_masked"] > 0
        assert tclient.shutdown(sock)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
