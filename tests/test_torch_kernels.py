"""Parity of the PyTorch port's covariance kernels (bobe_tpu_torch.ops.kernels)
with the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages. On a CPU tensor
``gram_masked`` computes its plain PyTorch version; the JAX side runs
``bobe_tpu.ops.kernels.gram_masked`` (float64) and, in float32, the Pallas
kernel in interpret mode as tests/test_pallas.py runs it. Float64 stages are
held to rtol 1e-9; the float32 comparison with the Pallas kernel to 2e-5,
the tolerance of tests/test_pallas.py.

The Gram build's backward (``GramMasked``) runs its plain version on a CPU
tensor; it is held to ``torch.autograd`` through ``gram_masked_plain`` at
rtol 1e-10 and to ``jax.vjp`` of the JAX package's ``gram_masked`` at rtol
1e-9, each with an absolute floor of the same factor times
sum_ij |G_ij dK_ij/dtheta| per component: the three sum the same terms in
different orders (JAX and autograd through the |a|^2 + |b|^2 - 2ab
distance), so a component that cancels to near 0 is only known to that
scale.

The CUDA kernels themselves run only on a card: see tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bobe_tpu  # noqa: F401  (float64 in JAX)
from bobe_tpu.ops import kernels as jkr
from bobe_tpu.ops.pallas_gram import gram_masked_pallas
from bobe_tpu_torch.ops import kernels as tkr

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(cap, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(cap, d))
    x[n:] = 0.5
    mask = (np.arange(cap) < n).astype(np.float64)
    ls = rng.uniform(0.1, 1.5, size=d)
    amp = float(rng.uniform(0.5, 3.0))
    return x, mask, ls, amp


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("name", ["rbf", "matern"])
@pytest.mark.parametrize("cap,n,d", [(128, 100, 2), (256, 200, 8),
                                     (100, 37, 30)])
def test_gram_masked_matches_jax(name, cap, n, d):
    x, mask, ls, amp = _inputs(cap, n, d, seed=cap + d)
    noise = 1e-6
    want = np.asarray(jkr.gram_masked(name, jnp.asarray(x), jnp.asarray(mask),
                                      jnp.asarray(ls), amp, noise))
    got = tkr.gram_masked(name, _t(x), _t(mask), _t(ls), _t(amp), noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-14)
    # pad block is exactly the identity, cross blocks exactly zero
    np.testing.assert_array_equal(got[n:, n:].numpy(), np.eye(cap - n))
    assert float(got[n:, :n].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["rbf", "matern"])
def test_gram_masked_float32_matches_pallas_interpret(name):
    """The TPU kernel's own type: float32 against gram_masked_pallas run in
    interpret mode (tests/test_pallas.py's tolerance, 2e-5)."""
    x, mask, ls, amp = _inputs(256, 100, 4, seed=0)
    noise = 1e-4
    want = np.asarray(gram_masked_pallas(
        name, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(ls), amp, noise,
        interpret=True))
    got = tkr.gram_masked(name, _t(x, torch.float32), _t(mask, torch.float32),
                          _t(ls, torch.float32), _t(amp, torch.float32), noise)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["rbf", "matern"])
def test_cross_kernels_and_perdim_match_jax(name):
    x, mask, ls, amp = _inputs(128, 60, 3, seed=5)
    xq = np.random.default_rng(6).uniform(size=(17, 3))
    jx, jm, jls, jq = (jnp.asarray(a) for a in (x, mask, ls, xq))
    tx, tm, tls, tq = (_t(a) for a in (x, mask, ls, xq))

    np.testing.assert_allclose(
        tkr.cross_kernel(name, tx, tq, tls, amp).numpy(),
        np.asarray(jkr.cross_kernel(name, jx, jq, jls, amp)), rtol=RTOL)
    np.testing.assert_allclose(
        tkr.cross_kernel_masked(name, tx, tm, tq, tls, amp).numpy(),
        np.asarray(jkr.cross_kernel_masked(name, jx, jm, jq, jls, amp)),
        rtol=RTOL)
    np.testing.assert_allclose(tkr.sq_dist_perdim(tx).numpy(),
                               np.asarray(jkr.sq_dist_perdim(jx)), rtol=RTOL)
    want = np.asarray(jkr.gram_masked_perdim(name, jkr.sq_dist_perdim(jx), jm,
                                             jls, amp, 1e-8))
    got = tkr.gram_masked_perdim(name, tkr.sq_dist_perdim(tx), tm, tls,
                                 _t(amp), 1e-8)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(
        tkr.kernel_diag(5, amp, 1e-3).numpy(),
        np.asarray(jkr.kernel_diag(5, amp, 1e-3)), rtol=RTOL)


def test_gram_masked_perdim_batches_over_lanes():
    """The optimizer's restart lanes: a (R, d) batch of lengthscales gives
    (R, cap, cap), lane r equal to the single build at its parameters."""
    x, mask, ls, amp = _inputs(128, 50, 3, seed=8)
    rng = np.random.default_rng(9)
    lss = rng.uniform(0.1, 1.0, size=(4, 3))
    amps = rng.uniform(0.5, 2.0, size=4)
    dsq = tkr.sq_dist_perdim(_t(x))
    batch = tkr.gram_masked_perdim("rbf", dsq, _t(mask), _t(lss), _t(amps),
                                   1e-8)
    assert batch.shape == (4, 128, 128)
    for r in range(4):
        single = tkr.gram_masked("rbf", _t(x), _t(mask), _t(lss[r]),
                                 _t(amps[r]), 1e-8)
        np.testing.assert_allclose(batch[r].numpy(), single.numpy(),
                                   rtol=RTOL, atol=1e-14)


def test_gram_masked_on_cpu_uses_the_plain_version():
    """A CPU tensor takes the plain version (differentiable, no launch);
    an unknown kernel name raises."""
    x, mask, ls, amp = _inputs(128, 20, 2, seed=1)
    before = tkr.gram_masked.launches
    tls = _t(ls).requires_grad_(True)
    K = tkr.gram_masked("rbf", _t(x), _t(mask), tls, _t(amp), 1e-8)
    (g,) = torch.autograd.grad(K.sum(), tls)
    assert torch.isfinite(g).all()
    assert tkr.gram_masked.launches == before
    with pytest.raises(ValueError):
        tkr.gram_masked("cubic", _t(x), _t(mask), _t(ls), _t(amp), 1e-8)


def _lanes(cap, n, d, lanes, seed):
    """Inputs with pad rows, restart lanes of hyperparameters and a random,
    non-symmetric cotangent G."""
    x, mask, _, _ = _inputs(cap, n, d, seed)
    rng = np.random.default_rng(seed + 1)
    ls = rng.uniform(0.1, 1.5, size=(lanes, d))
    amp = rng.uniform(0.5, 3.0, size=lanes)
    g = rng.normal(size=(lanes, cap, cap))
    return x, mask, ls, amp, g


@pytest.mark.parametrize("name", ["rbf", "matern"])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("cap,d", [(128, 2), (128, 8), (128, 30),
                                   (256, 2), (256, 8), (256, 30)])
def test_gram_backward_plain_matches_autograd_and_jax(name, lanes, cap, d):
    x, mask, ls, amp, g = _lanes(cap, int(0.7 * cap), d, lanes, cap + d)
    noise = 1e-6
    got_ls, got_amp = tkr.gram_masked_backward_plain(
        name, _t(x), _t(mask), _t(ls), _t(amp), _t(g))
    # per-component scale: sum_ij |G_ij dK_ij/dtheta| (dK/dtheta >= 0)
    scale_ls, scale_amp = tkr.gram_masked_backward_plain(
        name, _t(x), _t(mask), _t(ls), _t(amp), _t(np.abs(g)))

    tls = _t(ls).requires_grad_(True)
    tamp = _t(amp).requires_grad_(True)
    K = tkr.gram_masked_plain(name, _t(x), _t(mask), tls, tamp, noise)
    want_ls, want_amp = torch.autograd.grad(torch.sum(K * _t(g)), (tls, tamp))
    for got, want, scale in ((got_ls, want_ls, scale_ls),
                             (got_amp, want_amp, scale_amp)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(scale.max()))

    def build(l, a):
        return jkr.gram_masked(name, jnp.asarray(x), jnp.asarray(mask), l, a,
                               noise)

    def lane_vjp(l, a, gr):
        return jax.vjp(build, l, a)[1](gr)

    jls, jamp = jax.vmap(lane_vjp)(jnp.asarray(ls), jnp.asarray(amp),
                                   jnp.asarray(g))
    for got, want, scale in ((got_ls, jls, scale_ls),
                             (got_amp, jamp, scale_amp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-9 * float(scale.max()))


def test_gram_masked_plain_batches_over_lanes():
    """The batched-lane plain forward: lane r equals the single build at
    lane r's hyperparameters; every lane keeps the exact identity pad
    block."""
    n = 90
    x, mask, ls, amp, _ = _lanes(128, n, 5, 4, seed=21)
    batch = tkr.gram_masked_plain("matern", _t(x), _t(mask), _t(ls), _t(amp),
                                  1e-6)
    assert batch.shape == (4, 128, 128)
    for r in range(4):
        single = tkr.gram_masked_plain("matern", _t(x), _t(mask), _t(ls[r]),
                                       _t(amp[r]), 1e-6)
        np.testing.assert_allclose(batch[r].numpy(), single.numpy(),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(batch[r, n:, n:].numpy(),
                                      np.eye(128 - n))


def test_gram_masked_function_takes_the_plain_versions_on_cpu():
    """On CPU tensors GramMasked runs the plain forward and the plain
    backward: lanes in one call, gradients in ls and amp equal to the plain
    backward's, no kernel launch counted; a gradient in x is the plain
    backward's grad_x (summed over the lanes for a shared x); a gradient in
    the mask raises."""
    x, mask, ls, amp, g = _lanes(128, 70, 3, 2, seed=22)
    fwd, bwd = tkr.gram_masked.launches, tkr.gram_masked_backward.launches
    tls = _t(ls).requires_grad_(True)
    tamp = _t(amp).requires_grad_(True)
    K = tkr.gram_masked("rbf", _t(x), _t(mask), tls, tamp, 1e-8)
    assert K.shape == (2, 128, 128)
    np.testing.assert_array_equal(
        K.detach().numpy(),
        tkr.gram_masked_plain("rbf", _t(x), _t(mask), _t(ls), _t(amp),
                              1e-8).numpy())
    gls, gamp = torch.autograd.grad(torch.sum(K * _t(g)), (tls, tamp))
    want_ls, want_amp = tkr.gram_masked_backward_plain(
        "rbf", _t(x), _t(mask), _t(ls), _t(amp), _t(g))
    np.testing.assert_array_equal(gls.numpy(), want_ls.numpy())
    np.testing.assert_array_equal(gamp.numpy(), want_amp.numpy())
    assert (tkr.gram_masked.launches, tkr.gram_masked_backward.launches) \
        == (fwd, bwd)
    tx = _t(x).requires_grad_(True)
    K = tkr.gram_masked("rbf", tx, _t(mask), _t(ls), _t(amp), 1e-8)
    (gx,) = torch.autograd.grad(torch.sum(K * _t(g)), tx)
    *_, want_x = tkr.gram_masked_backward_plain(
        "rbf", _t(x), _t(mask), _t(ls), _t(amp), _t(g), need_x=True)
    np.testing.assert_array_equal(gx.numpy(), want_x.sum(0).numpy())
    with pytest.raises(ValueError, match="mask"):
        tkr.gram_masked("rbf", _t(x), _t(mask).requires_grad_(True),
                        _t(ls[0]), _t(amp[0]), 1e-8)


def test_kernel_library_is_not_built_at_import():
    assert tkr._LIBS == {}
    assert tkr.build_info == {}


# Both backwards' tile edge: 64 where lanes x pairs of 64-row tiles reach
# the card's 132 SMs, else 32; the boundary at 8, 4 and 1 lanes, and the
# hyperparameter backward's shapes of chip_smoke.py phase 3.
@pytest.mark.parametrize("cap,lanes,tile", [
    (200, 8, 32), (256, 8, 32), (300, 8, 32), (320, 8, 32), (321, 8, 64),
    (384, 8, 64), (448, 4, 32), (449, 4, 64), (1280, 4, 64), (960, 1, 32),
    (961, 1, 64), (1, 1, 32), (2048, 4, 64), (128, 1, 32), (128, 4, 32),
    (200, 4, 32), (1024, 1, 64), (1024, 4, 64), (1280, 1, 64),
    (2048, 1, 64)])
def test_backward_x_tile_is_chosen_by_shape(cap, lanes, tile):
    """The choice depends on (cap, d, lanes) alone: the same for every d,
    on every call, and it builds no library (it runs here without nvcc)."""
    got = {tkr.backward_tile(cap, d, lanes) for d in (1, 6, 30, 40, 128)}
    assert got == {tile}
    assert tkr.backward_tile(cap, 6, lanes) == tile
    t = -(-cap // 64)
    assert (lanes * t * (t + 1) // 2 >= 132) == (tile == 64)


@pytest.mark.parametrize("t,runs", [(1, 1), (4, 1), (8, 1), (9, 3), (16, 4),
                                    (20, 4), (32, 6), (64, 8)])
def test_backward_x_fold_runs(t, runs):
    """A row tile's t contributions fold in one run up to t = 8, else in
    runs of ceil(sqrt(t)) contributions."""
    assert tkr.fold_runs(t) == runs


@pytest.mark.parametrize("cap,d,lanes,tile,sizes", [
    (256, 6, 8, 32, (8 * 36 * 7, 8 * (72 + 8) * 32 * 6, 8 * 17)),
    (256, 6, 8, 64, (8 * 10 * 7, 8 * (20 + 4) * 64 * 6, 8 * 9)),
    (1280, 30, 4, 64, (4 * 210 * 31, 4 * (420 + 80) * 64 * 30, 4 * 101)),
    (200, 40, 1, 32, (28 * 41, (56 + 7) * 32 * 40, 15))])
def test_backward_x_scratch_sizes(cap, d, lanes, tile, sizes):
    """Per lane: pairs x (d + 1) hyperparameter partials; 2 pairs + T R
    slabs of tile rows x d (the pairs' contributions and the run sums); T R
    + T + 1 tickets; T = ceil(cap / tile), pairs = T (T + 1) / 2, R =
    fold_runs(T)."""
    assert tkr.backward_scratch_sizes(cap, d, lanes, tile,
                                      need_x=True) == sizes


def _corr_dcorr(name, dsq):
    if name == "rbf":
        c = torch.exp(-0.5 * dsq)
        return c, c
    r = torch.sqrt(torch.clamp(dsq, min=1e-30))
    e = torch.exp(-tkr.SQRT5 * r)
    return ((1.0 + tkr.SQRT5 * r + (5.0 / 3.0) * dsq) * e,
            (5.0 / 3.0) * (1.0 + tkr.SQRT5 * r) * e)


def _product_form_backward(name, x, mask, ls, amp, g, tile):
    """The hyperparameter backward as the CUDA kernel sums it, in float64:
    for each tile pair (bi >= bj) the weight W = (G_ij + G_ji) amp m_i m_j
    c'_ij from exact-difference distances (W_ii = 0 on a diagonal pair,
    where D_ii = 0), the lengthscale sums by the product form
    sum_i r_i u_i^2 + sum_j c_j v_j^2 - 2 sum_i u_i (W v)_i with u, v the
    pair's scaled rows less its origin (the column tile's first row), r and
    c W's row and column sums; diagonal pairs halved."""
    cap = x.shape[-2]
    t_n = -(-cap // tile)
    grad_ls, grad_amp = torch.zeros_like(ls), torch.zeros_like(amp)
    for r in range(ls.shape[0]):
        xs = x / ls[r]
        for bi in range(t_n):
            for bj in range(bi + 1):
                rows_i = slice(bi * tile, min(cap, (bi + 1) * tile))
                rows_j = slice(bj * tile, min(cap, (bj + 1) * tile))
                u, v = xs[rows_i], xs[rows_j]
                dsq = ((u[:, None, :] - v[None, :, :]) ** 2).sum(-1)
                corr, dcorr = _corr_dcorr(name, dsq)
                gm = (g[r, rows_i, rows_j] + g[r, rows_j, rows_i].T) \
                    * mask[rows_i, None] * mask[None, rows_j]
                w = gm * amp[r] * dcorr
                if bi == bj:
                    w = w * (1.0 - torch.eye(w.shape[0], dtype=w.dtype))
                o = v[0]
                uo, vo = u - o, v - o
                ls_sum = (w.sum(1)[:, None] * uo ** 2).sum(0) \
                    + (w.sum(0)[:, None] * vo ** 2).sum(0) \
                    - 2.0 * (uo * (w @ vo)).sum(0)
                half = 0.5 if bi == bj else 1.0
                grad_ls[r] += half * ls_sum
                grad_amp[r] += half * (gm * corr).sum()
    return grad_ls / ls, grad_amp


@pytest.mark.parametrize("name", ["rbf", "matern"])
@pytest.mark.parametrize("cap,n,d,tile", [(100, 70, 8, 32), (150, 120, 30, 64)])
def test_gram_backward_product_form_matches_plain_and_jax(name, cap, n, d,
                                                          tile):
    """The ℓ/amp kernel's arithmetic (the product form of the lengthscale
    sums, with the pair's origin, tile by tile) against the plain backward
    and jax.vjp of the JAX package's Gram, within 1e-10 of
    sum_ij |G_ij dK_ij/dtheta| per component: caps that are not a multiple
    of the tile, pad rows, a non-symmetric G, and lengthscales from 0.05
    (times sqrt(d / 8) above d=8, as chip_smoke.py phase 2b draws them, so
    that correlations stay above roundoff) with one at exactly 0.05: x on
    the unit cube, so that scaled coordinates reach 20 while the weighted
    pairs are close, the expansion's worst case."""
    lanes = 2
    x, mask, _, _ = _inputs(cap, n, d, seed=cap + d)
    rng = np.random.default_rng(cap * d)
    ls = rng.uniform(0.05, 2.0, size=(lanes, d)) * max(1.0, np.sqrt(d / 8))
    ls[0, 0] = 0.05
    amp = rng.uniform(0.5, 3.0, size=lanes)
    g = rng.normal(size=(lanes, cap, cap))
    args = (_t(x), _t(mask), _t(ls), _t(amp))
    got = _product_form_backward(name, *args, _t(g), tile)
    want = tkr.gram_masked_backward_plain(name, *args, _t(g))
    scale = tkr.gram_masked_backward_plain(name, *args, _t(np.abs(g)))

    def build(l, a):
        return jkr.gram_masked(name, jnp.asarray(x), jnp.asarray(mask), l, a,
                               1e-6)

    jls, jamp = jax.vmap(lambda l, a, gr: jax.vjp(build, l, a)[1](gr))(
        jnp.asarray(ls), jnp.asarray(amp), jnp.asarray(g))
    for k, w, jw, s in zip(got, want, (jls, jamp), scale):
        assert bool(((k - w).abs() <= 1e-10 * s).all())
        assert bool(((k - _t(np.asarray(jw))).abs() <= 1e-10 * s).all())


@pytest.mark.parametrize("cap,d,lanes,tile,sizes", [
    (1280, 30, 4, 64, (4 * 210 * 31, 0, 4)),
    (1280, 8, 1, 64, (210 * 9, 0, 1)),
    (128, 8, 4, 32, (4 * 10 * 9, 0, 4)),
    (200, 2, 3, 32, (3 * 28 * 3, 0, 3))])
def test_backward_scratch_sizes(cap, d, lanes, tile, sizes):
    """Per lane: T (T + 1) / 2 tile pairs of d + 1 partials, T = ceil(cap /
    tile), no row contributions and one ticket."""
    assert tkr.backward_scratch_sizes(cap, d, lanes, tile) == sizes
