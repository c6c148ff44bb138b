"""The port's CUDA kernels on the card. Every test here is marked ``cuda`` and
skips without a card; this file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

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
def test_gram_kernel_refuses_what_it_cannot_do(cuda):
    """Forward only: a gradient through the kernel raises (never a silent
    plain path); mixed dtypes and non-contiguous inputs raise."""
    x, mask, ls, amp = _inputs(256, 100, 4, seed=3, device=cuda)
    with pytest.raises(NotImplementedError, match="Gram kernel backward"):
        tkr.gram_masked("rbf", x, mask, ls.clone().requires_grad_(True), amp,
                        1e-6)
    with pytest.raises(ValueError):
        tkr.gram_masked("rbf", x, mask.float(), ls, amp, 1e-6)
    with pytest.raises(ValueError):
        tkr.gram_masked("rbf", x.T.contiguous().T, mask, ls, amp, 1e-6)
