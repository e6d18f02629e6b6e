"""DNN-based wafer cost model (paper §VII-A.1 / §VIII-G).

Copy of ``repro.wafer.dnn_cost``.  The numpy parts (``FEATURES``,
``featurize``, ``TARGETS``, ``make_dataset`` on this package's
``simulate_step``, ``fit_linear``, ``evaluate``) are the reference's line
for line, so they give its bits.  The MLP surrogate is torch float32 on
the GPU by default (``device="cpu"`` when asked): the reference's
parameter names (``w{i}`` / ``b{i}``, weights ``[in, out]``), its tanh-form
GELU (``jax.nn.gelu``'s default; torch's default is the erf form), its
He-normal initial weights (drawn from a ``torch.Generator``: jax's RNG
cannot be replayed in torch, so ``train_dnn(init=...)`` takes the
reference's converted with :func:`repro_torch.weights.dnn_params_from_jax`)
and its own Adam update (warmup, cosine learning rate, bias correction
with ``t`` in float32), the gradient from autograd.

A small MLP learns step latency (and its computation / communication /
overlap components) from workload + configuration features, trained on
samples from the analytic simulator (the paper trains on ASTRA-sim traces).
The surrogate answers in microseconds instead of the simulator's
milliseconds-to-seconds, giving the DLWS search its 100–1000× speedup.

A multivariate linear-regression baseline reproduces the paper's Fig. 21
comparison (DNN: r>0.99, err <5%; regression: r<0.98, err ~10%).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import resolve_device
from repro_torch.wafer.simulator import ParallelDegrees, simulate_step
from repro_torch.wafer.topology import Wafer


FEATURES = [
    "log_batch", "log_seq", "log_d_model", "log_layers", "log_vocab",
    "log_dff", "dp", "tp", "sp", "tatp", "seq_par", "bidir", "engine_tcme",
    "log_tokens", "log_params", "log_flops_per_die", "log_stream_bytes",
]


def featurize(cfg: ModelConfig, batch: int, seq: int, deg: ParallelDegrees,
              engine: str, bidirectional: bool = True) -> np.ndarray:
    tokens = batch * seq
    p_layer = 12 * cfg.d_model * cfg.d_model if not cfg.d_ff else \
        (4 * cfg.d_model * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    params = p_layer * cfg.n_layers
    shard = max(deg.total, 1)
    return np.array([
        np.log2(batch), np.log2(seq), np.log2(cfg.d_model),
        np.log2(cfg.n_layers), np.log2(cfg.vocab_size),
        np.log2(max(cfg.d_ff, 1)),
        np.log2(deg.dp), np.log2(max(deg.tp, 1)), np.log2(max(deg.sp, 1)),
        np.log2(max(deg.tatp, 1)),
        float(deg.seq_par), float(bidirectional),
        float(engine == "tcme"),
        np.log2(tokens), np.log2(params),
        np.log2(max(6.0 * params * tokens / shard, 1.0)),
        np.log2(max(2.0 * p_layer / max(deg.tp, 1), 1.0)),
    ], np.float32)


TARGETS = ["log_step", "log_comp", "log_comm", "log_overlap"]


_FLOOR = 1e-6  # seconds: components below this are noise, clamp them


def _targets(res) -> np.ndarray:
    bd = res.breakdown
    comp = max(bd["comp_layer"], _FLOOR)
    comm = max(bd["coll_layer"] + bd["dp_exposed"], _FLOOR)
    ovl = max(bd["p2p_layer"], _FLOOR)
    return np.log(np.array([max(res.step_time, _FLOOR), comp, comm, ovl],
                           np.float32))


# ---------------------------------------------------------------------------
# dataset generation
# ---------------------------------------------------------------------------


def make_dataset(wafer: Wafer, base_cfgs: list[ModelConfig], n: int = 500,
                 seed: int = 0, protocol: str = "paper"):
    """Paper §VIII-G protocol: fixed hardware + parallel configuration,
    'varying parameters such as batch size, sequence length, and hidden
    size' → 500 unique cases.  ``protocol="wide"`` additionally randomises
    layer counts, degrees and engines (a much harder regression domain,
    reported alongside)."""
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    tried = 0
    n_dies = len(wafer.alive_dies())
    while len(xs) < n and tried < 20 * n:
        tried += 1
        cfg = base_cfgs[rng.randint(len(base_cfgs))]
        cfg = replace(
            cfg,
            d_model=int(256 * rng.randint(2, 48)),
            n_layers=(int(rng.choice([8, 16, 24, 32, 48, 96]))
                      if protocol == "wide" else cfg.n_layers),
        )
        batch = int(2 ** rng.randint(2, 8))
        seq = int(256 * rng.randint(1, 65))
        if protocol == "wide":
            degs = []
            for _ in range(20):
                dp = 2 ** rng.randint(0, 6)
                tp = 2 ** rng.randint(0, 4)
                ta = 2 ** rng.randint(0, 6)
                if dp * tp * ta <= n_dies and n_dies % (dp * tp * ta) == 0:
                    degs.append(ParallelDegrees(
                        dp, tp, 1, ta, seq_par=bool(rng.randint(2))))
            if not degs:
                continue
            deg = degs[0]
            engine = ["smap", "gmap", "tcme"][rng.randint(3)]
        else:
            deg = ParallelDegrees(dp=2, tatp=16)
            engine = "tcme"
        res = simulate_step(wafer, cfg, batch, seq, deg, engine,
                            run_tcme_optimizer=False)
        if not np.isfinite(res.step_time):
            continue
        xs.append(featurize(cfg, batch, seq, deg, engine))
        ys.append(_targets(res))
    return np.stack(xs), np.stack(ys)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@dataclass
class DNNCostModel:
    params: dict  # name -> float32 tensor on the model's device
    x_mu: np.ndarray
    x_sd: np.ndarray
    y_mu: np.ndarray
    y_sd: np.ndarray

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Targets for the feature rows ``x``, computed on the model's
        device; numpy in, numpy out."""
        xn = (x - self.x_mu) / self.x_sd
        dev = self.params["w0"].device
        with torch.no_grad():
            yn = _mlp_apply(self.params, torch.as_tensor(
                np.asarray(xn, np.float32), device=dev))
        return yn.cpu().numpy() * self.y_sd + self.y_mu

    def predict_step_time(self, cfg, batch, seq, deg, engine) -> float:
        x = featurize(cfg, batch, seq, deg, engine)[None]
        return float(np.exp(self.predict(x)[0, 0]))


def _mlp_init(gen: torch.Generator, sizes) -> dict:
    """He-normal weights and zero biases, the reference's ``_mlp_init``
    scheme, drawn on the CPU from ``gen`` (so one seed gives the same
    weights on every device)."""
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = torch.randn((a, b), generator=gen) \
            * (2.0 / a) ** 0.5
        params[f"b{i}"] = torch.zeros((b,))
    return params


def _mlp_apply(params, x):
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    return x


def train_dnn(xs: np.ndarray, ys: np.ndarray, *, hidden=(256, 256, 128),
              epochs: int = 3000, lr: float = 2e-3, seed: int = 0,
              device="cuda", init: dict | None = None) -> DNNCostModel:
    """Fit the MLP to ``(xs, ys)`` full-batch for ``epochs`` steps of the
    reference's Adam update on ``device``.  The initial weights are
    ``init`` (a params dict, e.g. the reference's converted) when given,
    else drawn from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    x_mu, x_sd = xs.mean(0), xs.std(0) + 1e-6
    y_mu, y_sd = ys.mean(0), ys.std(0) + 1e-6
    xn = torch.as_tensor(np.asarray((xs - x_mu) / x_sd, np.float32),
                         device=dev)
    yn = torch.as_tensor(np.asarray((ys - y_mu) / y_sd, np.float32),
                         device=dev)
    sizes = (xs.shape[1], *hidden, ys.shape[1])
    if init is None:
        init = _mlp_init(torch.Generator().manual_seed(seed), sizes)
    want = {f"{p}{i}": (a, b) if p == "w" else (b,)
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))
            for p in "wb"}
    got = {k: tuple(v.shape) for k, v in init.items()}
    if got != want:
        raise ValueError(f"init has shapes {got}; sizes {sizes} need "
                         f"{want}")
    params = {k: v.detach().to(device=dev, dtype=torch.float32).clone()
              for k, v in init.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    steps = torch.arange(1, epochs + 1, dtype=torch.float32, device=dev)
    for i in range(epochs):
        t = steps[i]
        for p in params.values():
            p.requires_grad_(True)
        loss = torch.mean(torch.square(_mlp_apply(params, xn) - yn))
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            cur_lr = lr * torch.clamp(t / 100.0, max=1.0) \
                * 0.5 * (1 + torch.cos(math.pi * t / epochs))
            # the bias corrections, once a step (the same values every
            # parameter's update divides by)
            c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
            for (k, p), g in zip(list(params.items()), grads):
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * torch.square(g)
                mh = m[k] / c1
                vh = v[k] / c2
                params[k] = p - cur_lr * mh / (torch.sqrt(vh) + 1e-8)
    return DNNCostModel(params, x_mu, x_sd, y_mu, y_sd)


def fit_linear(xs: np.ndarray, ys: np.ndarray):
    """Multivariate linear-regression baseline (paper Fig. 21)."""
    x1 = np.concatenate([xs, np.ones((len(xs), 1), np.float32)], 1)
    w, *_ = np.linalg.lstsq(x1, ys, rcond=None)

    def predict(x):
        x1 = np.concatenate([x, np.ones((len(x), 1), np.float32)], 1)
        return x1 @ w

    return predict


def evaluate(pred: np.ndarray, truth: np.ndarray) -> dict:
    """Correlation + median relative error per target on the latency scale
    (components at the clamp floor are excluded from the relative metric —
    they are sub-microsecond noise)."""
    out = {}
    for j, name in enumerate(TARGETS):
        p, t = pred[:, j], truth[:, j]
        corr = float(np.corrcoef(p, t)[0, 1])
        keep = np.exp(t) > 2 * _FLOOR
        if keep.sum() < 3:
            keep = np.ones_like(t, bool)
        rel = float(np.median(np.abs(np.exp(p[keep]) - np.exp(t[keep]))
                              / np.maximum(np.exp(t[keep]), 1e-12)))
        out[name] = {"corr": corr, "rel_err": rel, "n": int(keep.sum())}
    return out
