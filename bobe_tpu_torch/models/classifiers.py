"""Feasibility classifiers of the classifier-gated GP.

Counterpart of ``bobe_tpu/models/classifiers.py``: three classifiers behind
a registry, each a dict of parameter tensors on the caller's device and a
batched probability function ((m, d) -> (m,)) that gates whole GP-mean
batches.

* ``svm``: an RBF C-SVC (C = 1e7, ``gamma="scale"``) trained on the host in
  float64 numpy by this module's own SMO solver, libsvm's algorithm with its
  second-order working-set selection and stopping tolerance; its decision
  function ``exp(-gamma d^2) @ dual_coef + intercept`` is replayed in torch.
  The support vectors are padded to a multiple of ``SV_PAD`` rows with zero
  dual coefficients, the JAX package's layout.
* ``nn`` (an MLP) and ``ellipsoid`` (a learned Mahalanobis ellipsoid): the
  binary cross-entropy minimised by ``torch.optim.AdamW``, the update of the
  JAX package's ``optax.adamw``, over the same per-epoch permutations
  (``np.random.default_rng(seed)``), with the best of ``n_restarts``
  restarts kept and the previous parameters kept when every restart
  diverges.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import numpy as np
import torch

from .. import config
from ..utils.log import get_logger
from ..utils.seed import get_numpy_rng

log = get_logger("clf")

SV_PAD = 128  # support-vector capacity granularity


# =====================================================================
# batched apply functions
# =====================================================================

def _svm_apply(params, x):
    """RBF-SVM decision replay: (m, d) -> hard {0, 1} probabilities. Padded
    support vectors have dual_coef 0."""
    sv, coef = params["support_vectors"], params["dual_coef"]
    d2 = (torch.sum(x * x, -1)[:, None] + torch.sum(sv * sv, -1)[None, :]
          - 2.0 * x @ sv.T)
    k = torch.exp(-params["gamma"] * torch.clamp(d2, min=0.0))
    decision = k @ coef + params["intercept"]
    return (decision >= 0.0).to(x.dtype)


def _mlp_forward(layers, x):
    h = x
    for w, b in layers[:-1]:
        h = torch.relu(h @ w + b)
    w, b = layers[-1]
    return (h @ w + b)[..., 0]


def _nn_apply(params, x):
    return torch.sigmoid(_mlp_forward(params["layers"], x))


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), with no linear cut-off
    return torch.logaddexp(x, torch.zeros_like(x))


def _ellipsoid_logit(params, x):
    d = x.shape[-1]
    rows, cols = torch.tril_indices(d, d, device=x.device)
    flat_L = params["flat_L"]
    L = torch.zeros((d, d), dtype=flat_L.dtype, device=x.device).index_put(
        (rows, cols), flat_L)
    diag = torch.diagonal(L)
    L = L * (1.0 - torch.eye(d, dtype=L.dtype, device=x.device)) \
        + torch.diag_embed(_softplus(diag) + 1e-4)
    diff = x - params["mu"]
    md2 = torch.einsum("...i,ij,...j->...", diff, L @ L.T, diff)
    return -params["alpha"] * md2 + params["beta"]


def _ellipsoid_apply(params, x):
    return torch.sigmoid(_ellipsoid_logit(params, x))


_APPLY = {"svm": _svm_apply, "nn": _nn_apply, "ellipsoid": _ellipsoid_apply}


def predict_proba_apply(kind: str) -> Callable:
    """Batched probability function ``f(params, x)`` of a classifier kind."""
    return _APPLY[kind]


def params_to_device(params, device) -> Dict:
    """Classifier parameters (numpy, tensors or nested (W, b) layers, from
    either package) as float64 tensors on ``device``."""
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64),
                                  dtype=config.DTYPE, device=device)
    out = {}
    for k, v in dict(params).items():
        if k == "layers":
            out[k] = [(t(w), t(b)) for w, b in v]
        else:
            out[k] = t(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else v)
    return out


def params_to_numpy(params) -> Dict:
    """The inverse of :func:`params_to_device`: the state-dict layout."""
    np_ = lambda v: v.detach().cpu().numpy()
    out = {k: np_(v) for k, v in params.items() if k != "layers"}
    if "layers" in params:
        out["layers"] = [(np_(w), np_(b)) for w, b in params["layers"]]
    return out


# =====================================================================
# SVM: SMO for the C-SVC dual (libsvm's Solver), on the host
# =====================================================================

def rbf_gamma_scale(X) -> float:
    """``gamma="scale"``: 1 / (d * X.var()), the variance over every entry."""
    X = np.asarray(X, dtype=np.float64)
    var = float(X.var())
    return 1.0 / (X.shape[1] * var) if var > 0 else 1.0


def rbf_kernel_matrix(X, Z, gamma: float) -> np.ndarray:
    d2 = (np.sum(X * X, axis=1)[:, None] + np.sum(Z * Z, axis=1)[None, :]
          - 2.0 * X @ Z.T)
    return np.exp(-gamma * np.maximum(d2, 0.0))


def smo_solve(K, y, C: float, tol: float = 1e-3,
              max_iter: int = 10_000_000):
    """Solve the C-SVC dual min 1/2 a'Qa - e'a, 0 <= a <= C, y'a = 0, with
    Q = (y y') * K, by libsvm's SMO: second-order working-set selection
    (Fan, Chen and Lin 2005), the analytic two-variable update with
    clipping, no shrinking. Stops when the maximal KKT violation
    m(a) - M(a) falls below ``tol``.

    K: (n, n) kernel matrix; y: (n,) labels in {-1, +1}. Returns (alpha,
    rho, iterations, violation); the decision function is
    sum_i y_i a_i K(x_i, x) - rho."""
    tau = 1e-12
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    QD = np.diag(K).copy()
    alpha = np.zeros(n)
    G = -np.ones(n)
    pos = y > 0
    at_upper = np.zeros(n, dtype=bool)
    at_lower = np.ones(n, dtype=bool)
    it = 0
    violation = np.inf
    while it < max_iter:
        yG = y * G
        # I_up: y=+1 below C or y=-1 above 0; I_low the reverse
        up = np.where(pos, ~at_upper, ~at_lower)
        low = np.where(pos, ~at_lower, ~at_upper)
        v = np.where(up, -yG, -np.inf)
        i = int(np.argmax(v))
        gmax = v[i]
        gmax2 = float(np.max(np.where(low, yG, -np.inf)))
        violation = gmax + gmax2
        grad_diff = gmax + yG
        cand = low & (grad_diff > 0)
        if violation < tol or not cand.any():
            break
        Ki = K[i]
        quad = QD[i] + QD - 2.0 * Ki
        quad = np.where(quad > 0, quad, tau)
        obj = np.where(cand, -(grad_diff * grad_diff) / quad, np.inf)
        j = int(np.argmin(obj))
        Kj = K[j]

        a_i, a_j = alpha[i], alpha[j]
        if y[i] != y[j]:
            quad_ij = QD[i] + QD[j] + 2.0 * (y[i] * y[j] * Ki[j])
            quad_ij = quad_ij if quad_ij > 0 else tau
            delta = (-G[i] - G[j]) / quad_ij
            diff = a_i - a_j
            n_i, n_j = a_i + delta, a_j + delta
            if diff > 0:
                if n_j < 0:
                    n_j, n_i = 0.0, diff
            elif n_i < 0:
                n_i, n_j = 0.0, -diff
            if diff > 0:
                if n_i > C:
                    n_i, n_j = C, C - diff
            elif n_j > C:
                n_j, n_i = C, C + diff
        else:
            quad_ij = QD[i] + QD[j] - 2.0 * (y[i] * y[j] * Ki[j])
            quad_ij = quad_ij if quad_ij > 0 else tau
            delta = (G[i] - G[j]) / quad_ij
            total = a_i + a_j
            n_i, n_j = a_i - delta, a_j + delta
            if total > C:
                if n_i > C:
                    n_i, n_j = C, total - C
            elif n_j < 0:
                n_j, n_i = 0.0, total
            if total > C:
                if n_j > C:
                    n_j, n_i = C, total - C
            elif n_i < 0:
                n_i, n_j = 0.0, total
        alpha[i], alpha[j] = n_i, n_j
        # G_k += Q_ki da_i + Q_kj da_j with Q_kl = y_k y_l K_kl
        G += y * (Ki * (y[i] * (n_i - a_i)) + Kj * (y[j] * (n_j - a_j)))
        for k in (i, j):
            at_upper[k] = alpha[k] >= C
            at_lower[k] = alpha[k] <= 0.0
        it += 1
    if it >= max_iter:
        log.warning(f"SMO reached max_iter={max_iter} with KKT violation "
                    f"{violation:.3e} > tol {tol}")

    # rho: mean of y_i G_i over free alphas, else the middle of the bounds
    yG = y * G
    free = ~at_upper & ~at_lower
    if free.any():
        rho = float(np.mean(yG[free]))
    else:
        ub_m = np.where(pos, at_lower, at_upper)
        lb_m = np.where(pos, at_upper, at_lower)
        ub = float(np.min(yG[ub_m], initial=np.inf))
        lb = float(np.max(yG[lb_m], initial=-np.inf))
        rho = 0.5 * (ub + lb)
    return alpha, rho, it, float(violation)


def train_svm_classifier(X, Y, settings=None, init_params=None, device=None,
                         **kwargs):
    """RBF C-SVC on labels Y in {0, 1}; class 1 where the decision is >= 0
    (scikit-learn's order of the classes). Returns (params, metrics,
    predict_fn)."""
    settings = dict(settings or {})
    C = float(settings.get("C", 1e7))
    if settings.get("kernel", "rbf") != "rbf":
        raise ValueError("the SVM classifier implements the rbf kernel only")
    X = np.asarray(X, dtype=np.float64)
    y = np.where(np.asarray(Y) > 0, 1.0, -1.0)
    gamma = settings.get("gamma", "scale")
    gamma = rbf_gamma_scale(X) if gamma == "scale" else float(gamma)
    K = rbf_kernel_matrix(X, X, gamma)
    alpha, rho, n_iter, violation = smo_solve(
        K, y, C, tol=float(settings.get("tol", 1e-3)))
    sv_idx = np.flatnonzero(alpha > 0)
    n_sv = sv_idx.size
    cap = max(SV_PAD, ((n_sv + SV_PAD - 1) // SV_PAD) * SV_PAD)
    sv_pad = np.zeros((cap, X.shape[1]))
    sv_pad[:n_sv] = X[sv_idx]
    coef_pad = np.zeros(cap)
    coef_pad[:n_sv] = y[sv_idx] * alpha[sv_idx]
    dev = device if device is not None else config.get_device()
    params = params_to_device({"support_vectors": sv_pad,
                               "dual_coef": coef_pad, "intercept": -rho,
                               "gamma": gamma}, dev)
    metrics = {"n_support_vectors": int(n_sv), "C": f"{C:.2e}",
               "gamma": f"{gamma:.2e}", "smo_iterations": int(n_iter),
               "kkt_violation": float(violation)}
    return params, metrics, partial(_svm_apply, params)


# =====================================================================
# shared AdamW trainer
# =====================================================================

def _leaves(params) -> list:
    if "layers" in params:
        return [t for wb in params["layers"] for t in wb]
    return [params[k] for k in sorted(params)]


def _with_leaves(params, leaves) -> Dict:
    if "layers" in params:
        return {"layers": [(leaves[2 * i], leaves[2 * i + 1])
                           for i in range(len(params["layers"]))]}
    return dict(zip(sorted(params), leaves))


def _bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    logsig = torch.nn.functional.logsigmoid
    return -labels * logsig(logits) - (1.0 - labels) * logsig(-logits)


def _train_bce(apply_logit, params, X, Y, lr, weight_decay, n_epochs,
               batch_size, seed):
    """Mini-batch AdamW on the mean binary cross-entropy: ``n_epochs``
    permutations from ``np.random.default_rng(seed)``, each cut into
    ``max(1, n // batch_size)`` batches (the remainder dropped)."""
    dev = _leaves(params)[0].device
    X = torch.as_tensor(X, dtype=config.DTYPE, device=dev)
    Y = torch.as_tensor(Y, dtype=config.DTYPE, device=dev)
    n = X.shape[0]
    leaves = [t.detach().clone().requires_grad_(True)
              for t in _leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(n) for _ in range(n_epochs)])
    steps = max(1, n // batch_size)
    idxs = torch.as_tensor(
        perms[:, :steps * batch_size].reshape(n_epochs, steps, batch_size),
        device=dev)
    loss_fn = lambda p, bx, by: _bce(apply_logit(p, bx), by).mean()
    for e in range(n_epochs):
        for s in range(steps):
            idx = idxs[e, s]
            opt.zero_grad(set_to_none=True)
            loss_fn(_with_leaves(params, leaves), X[idx], Y[idx]).backward()
            opt.step()
    out = _with_leaves(params, [t.detach() for t in leaves])
    with torch.no_grad():
        final_loss = float(loss_fn(out, X, Y))
    return out, {"train_loss": f"{final_loss:.2e}", "loss": final_loss,
                 "epochs": n_epochs}


def _train_with_restarts(init_fn, apply_logit, X, Y, settings, init_params,
                         n_restarts=2):
    rng = get_numpy_rng()
    best_loss, best_params, best_metrics = np.inf, None, {}
    for i in range(n_restarts):
        seed = int(rng.integers(0, 2**31 - 1))
        p0 = init_params if (i == 0 and init_params is not None) \
            else init_fn(seed)
        params, metrics = _train_bce(
            apply_logit, p0, X, Y,
            lr=settings.get("lr", 1e-3),
            weight_decay=settings.get("weight_decay", 1e-4),
            n_epochs=settings.get("n_epochs", 300),
            batch_size=min(settings.get("batch_size", 64), len(X)),
            seed=seed)
        loss = float(metrics["loss"])
        if np.isfinite(loss) and loss < best_loss:
            best_loss, best_params, best_metrics = loss, params, metrics
    if best_params is None:
        # every restart diverged: keep the caller's previous parameters
        log.warning("classifier training diverged in all restarts; keeping "
                    "previous parameters")
        return init_params, {"train_loss": "nan", "loss": float("nan")}
    return best_params, best_metrics


def _init_normal(seed, shape, scale, device):
    """Seeded N(0, scale^2) draws, made on the CPU so that every device
    gets the same values."""
    g = torch.Generator().manual_seed(int(seed))
    return (torch.randn(shape, generator=g, dtype=config.DTYPE)
            * scale).to(device)


# =====================================================================
# NN classifier
# =====================================================================

def train_nn_classifier(X, Y, settings=None, init_params=None, device=None,
                        **kwargs):
    settings = dict(settings or {})
    hidden = tuple(settings.get("hidden_dims", (32, 32)))
    d = np.asarray(X).shape[1]
    dims = (d,) + hidden + (1,)
    dev = device if device is not None else config.get_device()

    def init_fn(seed):
        seeds = np.random.default_rng(seed).integers(0, 2**31 - 1,
                                                     size=len(dims) - 1)
        return {"layers": [
            (_init_normal(s, (dims[i], dims[i + 1]), np.sqrt(2.0 / dims[i]),
                          dev),
             torch.zeros(dims[i + 1], dtype=config.DTYPE, device=dev))
            for i, s in enumerate(seeds)]}

    if init_params is not None:
        init_params = params_to_device(init_params, dev)
    settings.setdefault("lr", 1e-3)
    params, metrics = _train_with_restarts(
        init_fn, lambda p, x: _mlp_forward(p["layers"], x), X, Y, settings,
        init_params, n_restarts=settings.get("n_restarts", 2))
    if params is None:
        return None, metrics, None
    return params, metrics, partial(_nn_apply, params)


# =====================================================================
# Ellipsoid classifier
# =====================================================================

def train_ellipsoid_classifier(X, Y, settings=None, init_params=None,
                               device=None, **kwargs):
    settings = dict(settings or {})
    X = np.asarray(X)
    d = X.shape[1]
    dev = device if device is not None else config.get_device()
    mu = np.asarray(kwargs.get("best_pt", 0.5 * np.ones(d)), dtype=np.float64)

    def init_fn(seed):
        tril = d * (d + 1) // 2
        t = lambda a: torch.as_tensor(a, dtype=config.DTYPE, device=dev)
        return {"flat_L": _init_normal(seed, (tril,),
                                       settings.get("init_scale", 0.1), dev),
                "alpha": t(1.0), "beta": t(0.0), "mu": t(mu)}

    if init_params is not None:
        init_params = params_to_device(init_params, dev)
    settings.setdefault("lr", 1e-2)
    params, metrics = _train_with_restarts(
        init_fn, _ellipsoid_logit, X, Y, settings, init_params,
        n_restarts=settings.get("n_restarts", 2))
    if params is None:
        return None, metrics, None
    return params, metrics, partial(_ellipsoid_apply, params)


# train_fn(X, labels, settings, init_params=None, device=None, **kwargs) ->
# (params, metrics, probability function); the samplers and the GP gate with
# predict_proba_apply(kind) on the params
CLASSIFIER_REGISTRY: Dict[str, Dict[str, Callable]] = {
    "svm": {"train_fn": train_svm_classifier},
    "nn": {"train_fn": train_nn_classifier},
    "ellipsoid": {"train_fn": train_ellipsoid_classifier},
}
