"""Wafer-scale training-step simulator (paper §VII-A, Eq. 2–4).

Copy of ``repro.wafer.simulator``.  Its numpy tiers keep the
reference's names, constants and float64 arithmetic in its order, so
results are bitwise equal to the reference's.  The reference's jitted
stage-1, Tier-B and decode twins (``_stage1_jax_fn``, ``_tierb_jax_fn``,
``_decode_jax_fn``) are torch float64 tiers here (``_stage1_torch``,
``_tierb_torch``, ``_decode_torch``), which give the numpy tiers' bits
too: a context asks for them with ``stage1`` / ``tierb`` = ``"torch"``
(on the GPU) or ``"torch:cpu"``, as an argument or through
``REPRO_STAGE1`` / ``REPRO_TIERB``; ``"jax"`` raises ``ValueError``.

Models one training step of a transformer LM on the WSC for a hybrid
parallel configuration ``(dp, tp, sp, tatp)`` under a mapping engine
(``smap`` / ``gmap`` / ``tcme``), following the paper's cost structure::

    T_intra(op)  = Collective(op) + max(Comp(op), P2P(op))      (Eq. 2)
    T_inter      = P2P between ops                                (Eq. 3)
    T_total      = Σ T_intra + Σ T_inter                          (Eq. 4)

TATP turns weight/activation movement into one-hop P2P streams that overlap
with compute (the ``max`` term); stationary-tensor strategies (TP/SP/FSDP)
pay exposed collectives (the additive term).  Contention and tail-latency
penalties come from the topology/traffic/TCME modules; memory and power
follow Table I.

The cost model is a two-tier engine so the DLWS search can score thousands
of candidates cheaply:

* **Tier A** — :class:`StepCostContext`: built once per
  ``(wafer, cfg, batch, seq, engine, dies)``, it precomputes every
  degree-independent invariant (layer/active/total params, flop counts,
  HBM/compute energies) and memoizes the degree-dependent ones
  (``hierarchical_map`` groups, ring-hop factors, link-load templates via
  the wafer's routing caches).
* **Tier B** — :func:`simulate_batch`: vectorizes the memory/compute/stream
  arithmetic over all candidates with numpy, applies memory-feasibility
  pre-pruning before any traffic modeling (``prune_oom``), and only walks
  the link-level traffic model for surviving candidates.

:func:`simulate_step` is a batch-of-one wrapper kept for all existing
callers; :func:`simulate_step_reference` preserves the original pure-scalar
path and pins the fast path bitwise in ``tests/test_solver_fast.py``.

The same simulator also powers the paper-figure benchmarks and generates
training data for the DNN cost surrogate.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import resolve_device
from repro_torch.wafer import mapping as wmap
from repro_torch.wafer import tcme as wtcme
from repro_torch.wafer.topology import Wafer
from repro_torch.wafer.traffic import (CommOp, link_loads, link_template,
                                 max_link_load, max_load_entries,
                                 max_ring_hops, pair_hop_bytes, phase_time,
                                 template_bank_row)

BYTES_ACT = 2  # fp16/bf16 activations
BYTES_W = 2
BYTES_OPT = 8  # fp32 Adam m+v (paper: fp16 weights, fp32 Adam states)
ACT_COEFF = 1.0  # activation bytes/token/d_model per layer (full remat)
T_DISPATCH = 2e-6  # per-round stream orchestration overhead (s)
_EMPTY_IDS = np.empty(0, np.int64)  # unroutable-axis link template
# degree-column arrays per candidate-list identity.  DP-grid batches recur
# verbatim across solves; GA/ILP batches are more varied, so the cache is
# bounded — a resident solver must not grow it without limit.
_DEGREE_ARRAYS: dict = {}
_DEGREE_ARRAYS_CAP = 4096
# resident StepCostContext instances per wafer (Wafer._ctx_cache): each
# holds a per-candidate result memo, so the cap bounds total memo memory
_CTX_CACHE_CAP = 32
# the cost engine's stage-1 / Tier-B backends: the numpy anchor, and the
# torch float64 tier on the GPU or on the CPU
TIER_BACKENDS = ("numpy", "torch", "torch:cpu")
# batches below this size stay on the numpy tier, as the reference's
# jitted tier does: a device round trip and the host epilogue cost more
# than numpy's lean loops there (results are bitwise-identical either way
# — the gate is purely a perf knob)
_TIER_MIN_BATCH = 8


@dataclass(frozen=True)
class ParallelDegrees:
    dp: int = 1
    tp: int = 1
    sp: int = 1  # sequence/context partition dim (TEMP space)
    tatp: int = 1
    seq_par: bool = False  # Megatron-3 SP flag: tied to the TP groups
    # expert parallelism (decode objective, MoE only): the dp replicas
    # split into ep expert groups, each hosting n_experts/ep experts plus
    # a full copy of the dense (attention) weights.  ep subdivides dp —
    # it consumes no extra dies, so it stays out of ``total``/``as_tuple``
    ep: int = 1

    def __post_init__(self):
        # precomputed identity key: the solver's memoized evaluation layer
        # looks candidates up millions of times per sweep, so the tuple is
        # built once (frozen dataclass -> via object.__setattr__)
        object.__setattr__(self, "key", (self.dp, self.tp, self.sp,
                                         self.tatp, self.seq_par, self.ep))

    @property
    def total(self) -> int:
        return self.dp * self.tp * self.sp * self.tatp

    def as_tuple(self):
        return (self.dp, self.tp, self.sp, self.tatp)


def ring_stream_time(tensor_bytes: float, r: int, spec, *,
                     bidirectional: bool = True, hops: int = 1,
                     stages: int = 3, contention: float = 1.0) -> float:
    """Serial time of a TATP tensor stream around an r-ring.

    Per round one block (tensor/r) moves one hop per direction; the
    bidirectional orchestration needs ⌈r/2⌉ rounds, the naive ring r−1.
    Granularity: small blocks pay the D2D efficiency ramp (paper §III-B).
    """
    if r <= 1 or tensor_bytes <= 0:
        return 0.0
    block = tensor_bytes / r
    eff = spec.bw_eff(block)
    rounds = (r + 1) // 2 if bidirectional else (r - 1)
    per_round = (block * hops * contention) / (spec.link_bw * eff) \
        + hops * spec.hop_latency
    return stages * rounds * per_round


@dataclass(slots=True)
class SimResult:
    step_time: float
    throughput: float  # tokens/s
    mem_per_die: float
    oom: bool
    power: float  # W (wafer total)
    power_eff: float  # tokens/s/W
    bw_util: float  # D2D utilization during the step
    breakdown: dict = field(default_factory=dict)
    degrees: Optional[ParallelDegrees] = None
    engine: str = ""
    # solver-side score memo (repro_torch.wafer.solver._score); excluded from
    # equality so cached results stay comparable to fresh ones
    score_cache: Optional[float] = field(default=None, compare=False,
                                         repr=False)

    @property
    def ok(self) -> bool:
        return not self.oom and math.isfinite(self.step_time)


def _layer_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.is_moe:
        mlp = cfg.n_experts * 3 * d * cfg.d_ff
    elif cfg.act in ("swiglu", "geglu"):
        mlp = 3 * d * cfg.d_ff
    else:
        mlp = 2 * d * cfg.d_ff
    return attn + mlp


def _layer_active_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.is_moe:
        mlp = cfg.top_k * 3 * d * cfg.d_ff
    elif cfg.act in ("swiglu", "geglu"):
        mlp = 3 * d * cfg.d_ff
    else:
        mlp = 2 * d * cfg.d_ff
    return attn + mlp


# ---------------------------------------------------------------------------
# Tier A: per-(wafer, cfg, batch, seq, engine, dies) invariant context
# ---------------------------------------------------------------------------


class StepCostContext:
    """Degree-independent invariants + memoization for repeated scoring.

    The context *is* the cache identity: anything that changes the cost
    surface — the wafer (faults), the model/workload shape, the mapping
    engine, the alive-die subset — lives here, so two contexts never share
    results (the seed's solver cache keyed only on degrees and could leak
    results across different ``dies`` subsets).
    """

    def __init__(self, wafer: Wafer, cfg: ModelConfig, batch: int, seq: int,
                 engine: str = "tcme", *, fsdp: bool = False,
                 tatp_bidirectional: bool = True, stream: str = "auto",
                 dies: Optional[Sequence[int]] = None,
                 evaluator: str = "batch",
                 stage1: Optional[str] = None,
                 tierb: Optional[str] = None,
                 objective: str = "train"):
        self.wafer = wafer
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.engine = engine
        # "train" scores one training step; "decode" scores one
        # continuous-batching decode iteration (batch = in-flight
        # sequences, seq = per-sequence KV budget in tokens)
        self.objective = objective
        self.fsdp = fsdp
        self.tatp_bidirectional = tatp_bidirectional
        self.stream = stream
        self.dies = list(dies) if dies is not None else wafer.alive_dies()
        self.evaluator = evaluator  # "batch" | "reference" (seed scalar path)
        # stage-1 arithmetic and Tier-B backends, read as the reference
        # reads them (argument, else REPRO_STAGE1 / REPRO_TIERB): "numpy"
        # (default; the bitwise-pinned anchor) or the torch float64 tier,
        # "torch" on the GPU or "torch:cpu" (bitwise equal to numpy;
        # Tier B takes it for search-time evaluations only, so plan
        # numbers are backend-invariant — see _tierb_torch_eval)
        self.stage1 = _tier_backend("stage1", stage1)
        self.tierb = _tier_backend("tierb", tierb)
        spec = wafer.spec
        self.spec = spec
        self.n_dies = len(self.dies)
        # workload invariants (plain Python ints — exact, shared by both the
        # vectorized and the reference arithmetic)
        self.tokens = batch * seq
        self.n_l = cfg.n_layers
        self.p_layer = _layer_params(cfg)
        self.p_active = _layer_active_params(cfg)
        self.p_total = self.p_layer * self.n_l + cfg.vocab_size * cfg.d_model
        # MoE dense/expert split (exact ints, zero for dense models): the
        # EP axis shards only the expert tensors, so the decode path prices
        # the two groups under different sharding denominators
        p_expert_layer = (cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
                          if cfg.is_moe else 0)
        self.p_expert_total = p_expert_layer * self.n_l
        self.p_dense_total = self.p_total - self.p_expert_total
        self.p_active_expert = (cfg.top_k * 3 * cfg.d_model * cfg.d_ff
                                if cfg.is_moe else 0)
        self.p_active_dense = self.p_active - self.p_active_expert
        self.attn_flops = 12 * self.tokens * seq * cfg.d_model
        self.layer_flops = 6 * self.p_active * self.tokens + self.attn_flops
        self.head_flops = 6 * self.tokens * cfg.d_model * cfg.vocab_size
        # degree-independent energies (Table I)
        self.e_comp = (self.n_l * self.layer_flops + self.head_flops) \
            * spec.e_flop
        self.hbm_bytes = self.n_l * (4 * BYTES_W * self.p_active + 6
                                     * self.tokens * cfg.d_model * BYTES_ACT)
        self.e_hbm = self.hbm_bytes * spec.e_hbm
        # decode-objective invariants (cheap; computed unconditionally so a
        # context can answer decode memory queries even when solving train)
        self.kv_seq_bytes = cfg.cache_bytes_per_seq(seq)  # full KV budget
        self.state_seq_bytes = cfg.cache_bytes_per_seq(0)  # ctx-free part
        # fwd-only per-token flops (one layer / the lm head); the training
        # numbers above are fwd+bwd (3x)
        self.dec_layer_flops = 2 * self.p_active \
            + 4 * self.seq * cfg.d_model
        self.dec_head_flops = 2 * cfg.d_model * cfg.vocab_size
        # memoization
        self._groups: dict = {}
        self.results: dict = {}
        self.evaluated = 0  # cost-model evaluations actually performed

    @classmethod
    def for_space(cls, wafer: Wafer, cfg: ModelConfig, batch: int, seq: int,
                  space: str, engine: str = "tcme",
                  **kw) -> "StepCostContext":
        spec = STRATEGY_SPACES[space]
        return cls(wafer, cfg, batch, seq, engine, fsdp=spec["fsdp"], **kw)

    @classmethod
    def resident(cls, wafer: Wafer, cfg: ModelConfig, batch: int, seq: int,
                 engine: str = "tcme", *, fsdp: bool = False,
                 tatp_bidirectional: bool = True, stream: str = "auto",
                 dies: Optional[Sequence[int]] = None,
                 evaluator: str = "batch",
                 stage1: Optional[str] = None,
                 tierb: Optional[str] = None,
                 objective: str = "train") -> "StepCostContext":
        """A context shared across solves on a long-lived wafer.

        The context *is* the cache identity (see the class docstring), so a
        resident solver that re-solves the same workload — repeated
        ``dlws_solve`` calls, serve replans, design sweeps revisiting a
        point — can reuse the instance and serve repeat evaluations
        straight from the per-candidate result memo.  The key is the full
        cost-surface identity: the whole ``ModelConfig``, the workload
        shape, every scoring knob (including the resolved stage-1/Tier-B
        backends), and the alive-die subset.  Uncached wafers (the seed's
        cold-cache reference behaviour) always get a fresh context.
        """
        stage1 = _tier_backend("stage1", stage1)
        tierb = _tier_backend("tierb", tierb)
        if not wafer.cache_enabled:
            return cls(wafer, cfg, batch, seq, engine, fsdp=fsdp,
                       tatp_bidirectional=tatp_bidirectional, stream=stream,
                       dies=dies, evaluator=evaluator, stage1=stage1,
                       tierb=tierb, objective=objective)
        key = (dataclasses.astuple(cfg), batch, seq, engine, fsdp,
               tatp_bidirectional, stream,
               None if dies is None else tuple(dies),
               evaluator, stage1, tierb, objective)
        ctx = wafer._ctx_cache.get(key)
        if ctx is None:
            ctx = cls(wafer, cfg, batch, seq, engine, fsdp=fsdp,
                      tatp_bidirectional=tatp_bidirectional, stream=stream,
                      dies=dies, evaluator=evaluator, stage1=stage1,
                      tierb=tierb, objective=objective)
            if len(wafer._ctx_cache) >= _CTX_CACHE_CAP:
                wafer._ctx_cache.clear()
            wafer._ctx_cache[key] = ctx
        return ctx

    # -- spatial mapping (memoized per degree tuple) -----------------------
    def groups_for(self, deg: ParallelDegrees) -> dict:
        key = deg.as_tuple()
        got = self._groups.get(key)
        if got is None:
            degrees_map = {}
            if deg.dp > 1 or self.fsdp:
                degrees_map["dp"] = deg.dp
            if deg.tp > 1:
                degrees_map["tp"] = deg.tp
            if deg.sp > 1:
                degrees_map["sp"] = deg.sp
            if deg.tatp > 1:
                degrees_map["tatp"] = deg.tatp
            if not degrees_map:
                degrees_map = {"dp": 1}
            # second-level cache on the wafer: the same spatial embedding is
            # shared across contexts (models, batch shapes) on one wafer
            wkey = (tuple(degrees_map.items()), self.engine)
            got = self.wafer._groups_cache.get(wkey) \
                if self.wafer.cache_enabled else None
            if got is None:
                got = wmap.hierarchical_map(self.wafer, degrees_map,
                                            self.engine)
                if self.wafer.cache_enabled:
                    self.wafer._groups_cache[wkey] = got
            self._groups[key] = got
        return got

    # -- memoized scoring (the solver's evaluation layer) ------------------
    def evaluate_many(self, degs: list[ParallelDegrees],
                      final: bool = False) -> list[SimResult]:
        """Score candidates through the batch engine with memoization.

        Search-time evaluations (``final=False``) skip the TCME optimizer and
        prune OOM candidates before traffic modeling; the final plan pays for
        the full pass (the seed solver's fast/final split, batched).
        """
        results = self.results
        # fast path: fully-memoized batches (every re-sweep after the
        # first) skip the miss-tracking machinery entirely
        out = [results.get((d.key, final)) for d in degs]
        if None not in out:
            return out
        missing: list[ParallelDegrees] = []
        slots: list[tuple[int, tuple]] = []
        pending: set = set()
        for i, d in enumerate(degs):
            if out[i] is not None:
                continue
            key = (d.key, final)
            if key in pending:
                slots.append((i, key))
            else:
                pending.add(key)
                slots.append((i, key))
                missing.append(d)
        if missing:
            if self.objective == "decode":
                # decode iterations have no TCME-final / remat split: the
                # same vectorized evaluator serves search and final
                # scoring (``final`` only pins the recorded evaluation to
                # the anchored numpy backend)
                if self.evaluator == "reference":
                    res = [_decode_reference_ctx(self, d)
                           for d in missing]
                else:
                    res = simulate_decode_batch(self, missing,
                                                final=final)
            elif self.evaluator == "reference":
                res = [simulate_step_reference(
                    self.wafer, self.cfg, self.batch, self.seq, d,
                    self.engine, fsdp=self.fsdp,
                    tatp_bidirectional=self.tatp_bidirectional,
                    stream=self.stream, dies=self.dies,
                    run_tcme_optimizer=final) for d in missing]
            else:
                res = simulate_batch(self, missing,
                                     run_tcme_optimizer=final,
                                     prune_oom=not final)
            for d, r in zip(missing, res):
                results[(d.key, final)] = r
            self.evaluated += len(missing)
        for i, key in slots:
            out[i] = results[key]
        return out  # type: ignore[return-value]

    def evaluate(self, deg: ParallelDegrees,
                 final: bool = False) -> SimResult:
        return self.evaluate_many([deg], final=final)[0]


# ---------------------------------------------------------------------------
# Tier B: batched candidate evaluation
# ---------------------------------------------------------------------------


def _stage1_numpy(ctx: StepCostContext, dp, tp, sp, ta, seq_par) -> dict:
    """Stage 1: memory/compute/stream-byte arithmetic over all candidates
    (numpy; op-for-op identical to the scalar reference, so results are
    bitwise equal)."""
    cfg, spec = ctx.cfg, ctx.spec
    n_dies, tokens, n_l, fsdp = ctx.n_dies, ctx.tokens, ctx.n_l, ctx.fsdp
    nC = len(dp)

    # ---------------- memory (vectorized; mirrors the reference) ----------
    zero = (ta > 1) | fsdp
    w_shard = tp * ta * (n_dies if fsdp else 1)
    w_div = np.minimum(w_shard, n_dies)
    w_bytes = BYTES_W * ctx.p_total / w_div
    g_bytes = w_bytes  # same expression as the reference's g_bytes
    opt_shard = np.minimum(w_shard * np.where(zero, dp, 1), n_dies)
    opt_bytes = BYTES_OPT * ctx.p_total / opt_shard
    act_tokens = tokens / (dp * sp * ta)
    act_unit = ACT_COEFF * act_tokens * cfg.d_model * BYTES_ACT * n_l
    act_full = np.where((tp > 1) & ~seq_par,
                        act_unit * (0.3 + 0.7 / tp), act_unit / tp)
    transient = BYTES_W * ctx.p_layer if fsdp else 0.0
    fixed = w_bytes + g_bytes + opt_bytes + transient
    seqs_per_die = np.maximum(1, ctx.batch // dp)
    # gradient-accumulation doubling, vectorized over the exponent: the
    # reference loop doubles n_micro while (fixed + act_full/n_micro >
    # cap) and (n_micro < seqs_per_die).  Dividing by 2^k is exact, so
    # evaluating the same predicate at every power at once and taking the
    # first non-growing one reproduces the loop bitwise.
    kb = max(int(seqs_per_die.max()).bit_length() + 1, 1)
    pows = np.left_shift(np.int64(1), np.arange(kb, dtype=np.int64))
    grow = (fixed[:, None] + act_full[:, None] / pows > spec.hbm_cap) \
        & (pows < seqs_per_die[:, None])
    n_micro = pows[np.argmin(grow, axis=1)]
    act_bytes = act_full / n_micro
    mem = fixed + act_bytes
    oom = mem > spec.hbm_cap

    # ---------------- compute (vectorized) --------------------------------
    model_shard = tp * sp * ta * dp
    comp_denom = model_shard * spec.flops * spec.gemm_eff
    comp_layer = ctx.layer_flops / comp_denom
    t_head = ctx.head_flops / comp_denom

    # ---------------- communication byte sizes (vectorized) ---------------
    act_group_bytes = (tokens / (dp * sp)) * cfg.d_model * BYTES_ACT
    w_stream = BYTES_W * ctx.p_active / tp
    a_stream = act_group_bytes / tp
    if cfg.n_kv_heads:
        kv_bytes = (tokens / (dp * sp * ta)) * 2 * cfg.kv_dim * BYTES_ACT
    else:
        kv_bytes = np.zeros(nC)
    return dict(n_micro=n_micro, mem=mem, oom=oom, comp_layer=comp_layer,
                t_head=t_head, act_group_bytes=act_group_bytes,
                w_stream=w_stream, a_stream=a_stream, kv_bytes=kv_bytes)


def _degree_columns(degrees: list) -> tuple:
    """Columnized ``(dp, tp, sp, ta, seq_par, ep)`` for a candidate list,
    memoized in ``_DEGREE_ARRAYS`` (identity: the tuple of degree keys)."""
    dkey = tuple(d.key for d in degrees)
    arrs = _DEGREE_ARRAYS.get(dkey)
    if arrs is None:
        arrs = (np.array([d.dp for d in degrees], np.int64),
                np.array([d.tp for d in degrees], np.int64),
                np.array([d.sp for d in degrees], np.int64),
                np.array([d.tatp for d in degrees], np.int64),
                np.array([d.seq_par for d in degrees], bool),
                np.array([d.ep for d in degrees], np.int64))
        if len(_DEGREE_ARRAYS) >= _DEGREE_ARRAYS_CAP:
            _DEGREE_ARRAYS.clear()  # cheap full reset; entries are tiny
        _DEGREE_ARRAYS[dkey] = arrs
    return arrs


# ---------------------------------------------------------------------------
# the torch float64 tiers (stage1 / tierb = "torch" on the GPU, "torch:cpu")
# ---------------------------------------------------------------------------
#
# Counterparts of the reference's jitted ``_stage1_jax_fn``,
# ``_tierb_jax_fn`` and ``_decode_jax_fn``: the same arithmetic as eager
# torch float64 ops, op for op in the numpy tier's order, so they give its
# bits.  Eager torch rounds every op on its own (no FMA contraction, no
# rewritten division chains), so the reference's strict-IEEE jit options
# and optimization barriers have no counterpart here.  Three rules keep
# the bits:
#
# * promotion — an int64 tensor against a Python float, and int64 / int64,
#   give float32 in torch where numpy gives float64, so the degree columns
#   enter float arithmetic as float64 tensors (exact: they are small ints);
# * division — CUDA's true division by a CPU scalar (a Python number or a
#   0-d CPU tensor) multiplies by the reciprocal, and ``number / tensor``
#   is ``tensor.reciprocal() * number``: one rounding off either way.  So
#   every division is tensor / tensor, its scalars committed once per
#   workload as 0-d float64 tensors on the tier's device
#   (:func:`_commit_scalars`);
# * order — no fused op (``addcmul``, ``lerp``, ...), no ``torch.compile``,
#   and the per-hop link-load chains add one hop at a time in the numpy
#   tier's order (the chain is the invariant: repeated addition is not
#   ``k * w``).
#
# Search-time evaluations only: final (recorded) evaluations stay on the
# numpy tier, so plans are tier-invariant by construction, as in the
# reference.

# tier calls by stage since the counts were last zeroed (each call is one
# candidate batch evaluated on the tier's device)
TIER_CALLS = {"stage1": 0, "tierb": 0, "decode": 0}
# committed scalar dicts keyed on (device, values): fresh contexts over
# the same workload (the solver builds thousands) reuse the device
# scalars instead of committing ~20 each
_SCALARS_TORCH: dict = {}
# device-resident decode degree columns (same identity / cap policy as
# _DEGREE_ARRAYS, per device)
_DEGREE_ARRAYS_TORCH: dict = {}


def _tier_device(backend: str) -> torch.device:
    """The device a torch tier runs on: the GPU for ``"torch"`` (raises
    without one), the CPU for ``"torch:cpu"``."""
    return resolve_device("cpu" if backend == "torch:cpu" else "cuda")


def _tier_backend(name: str, backend: Optional[str]) -> str:
    """The ``stage1`` / ``tierb`` backend asked for (the argument, else
    ``REPRO_STAGE1`` / ``REPRO_TIERB``, else ``"numpy"``), checked:
    ``"numpy"``, ``"torch"`` (the GPU, which must exist) or
    ``"torch:cpu"``."""
    backend = backend or os.environ.get("REPRO_" + name.upper(), "numpy")
    if backend == "jax":
        raise ValueError(
            f"{name}='jax': the jitted cost-engine tier is 'torch' in "
            f"repro_torch ('torch:cpu' to run it on the CPU)")
    if backend not in TIER_BACKENDS:
        raise ValueError(f"{name}={backend!r}: the cost engine's backends "
                         f"are {', '.join(map(repr, TIER_BACKENDS))}")
    if backend != "numpy":
        _tier_device(backend)
    return backend


def _commit_scalars(dev: torch.device, flts: dict) -> dict:
    """One dict of 0-d float64 tensors on ``dev``, memoized on the values
    themselves.  ``float`` of a Python int rounds as numpy's int64 to
    float64 conversion does."""
    key = (str(dev), tuple(sorted(flts.items())))
    sc = _SCALARS_TORCH.get(key)
    if sc is None:
        sc = {k: torch.tensor(float(v), dtype=torch.float64, device=dev)
              for k, v in flts.items()}
        if len(_SCALARS_TORCH) >= _DEGREE_ARRAYS_CAP:
            _SCALARS_TORCH.clear()
        _SCALARS_TORCH[key] = sc
    return sc


def _tierb_scalars(ctx: StepCostContext, dev: torch.device) -> dict:
    """Context-invariant scalars of stage 1 and Tier B, each the value the
    numpy tier divides by or into (its Python-int products folded first,
    as numpy folds them)."""
    spec = ctx.spec
    full_layer = BYTES_W * ctx.p_layer
    return _commit_scalars(dev, dict(
        tokens=ctx.tokens, w_total=BYTES_W * ctx.p_total,
        opt_total=BYTES_OPT * ctx.p_total, w_active=BYTES_W * ctx.p_active,
        layer_flops=ctx.layer_flops, head_flops=ctx.head_flops, c0_7=0.7,
        full_layer=full_layer, full_layer2=2 * full_layer,
        link_bw=spec.link_bw))


def _f64(*cols) -> tuple:
    return tuple(c.to(torch.float64) for c in cols)


def _stage1_torch_cols(ctx: StepCostContext, dp, tp, sp, ta, seq_par,
                       sc: dict) -> dict:
    """Stage 1 over device degree columns (int64 ``dp``..``ta``, bool
    ``seq_par``): :func:`_stage1_numpy` op for op.  The micro-batch ladder
    runs to the batch's bit length (``seqs_per_die`` never exceeds the
    batch), so its last power never grows and the first non-growing power
    is the numpy tier's."""
    cfg, spec = ctx.cfg, ctx.spec
    n_dies, n_l, fsdp = ctx.n_dies, ctx.n_l, ctx.fsdp
    dpf, tpf, spf, taf = _f64(dp, tp, sp, ta)

    zero = (ta > 1) | fsdp
    w_shard = tpf * taf * (n_dies if fsdp else 1)
    w_div = torch.clamp(w_shard, max=n_dies)
    w_bytes = sc["w_total"] / w_div
    g_bytes = w_bytes
    opt_shard = torch.clamp(w_shard * torch.where(zero, dpf, 1.0),
                            max=n_dies)
    opt_bytes = sc["opt_total"] / opt_shard
    act_tokens = sc["tokens"] / (dpf * spf * taf)
    act_unit = ACT_COEFF * act_tokens * cfg.d_model * BYTES_ACT * n_l
    act_full = torch.where((tp > 1) & ~seq_par,
                           act_unit * (0.3 + sc["c0_7"] / tpf),
                           act_unit / tpf)
    transient = BYTES_W * ctx.p_layer if fsdp else 0.0
    fixed = w_bytes + g_bytes + opt_bytes + transient
    seqs_per_die = torch.clamp(ctx.batch // dp, min=1)
    kb = max(int(ctx.batch).bit_length() + 1, 1)
    pows = torch.tensor([1 << k for k in range(kb)], dtype=torch.int64,
                        device=dp.device)
    grow = (fixed[:, None] + act_full[:, None] / pows.to(torch.float64)
            > spec.hbm_cap) & (pows < seqs_per_die[:, None])
    n_micro = pows[grow.to(torch.uint8).argmin(dim=1)]
    act_bytes = act_full / n_micro.to(torch.float64)
    mem = fixed + act_bytes
    oom = mem > spec.hbm_cap

    comp_denom = tpf * spf * taf * dpf * spec.flops * spec.gemm_eff
    comp_layer = sc["layer_flops"] / comp_denom
    t_head = sc["head_flops"] / comp_denom

    act_group_bytes = (sc["tokens"] / (dpf * spf)) * cfg.d_model * BYTES_ACT
    w_stream = sc["w_active"] / tpf
    a_stream = act_group_bytes / tpf
    if cfg.n_kv_heads:
        kv_bytes = (sc["tokens"] / (dpf * spf * taf)) * 2 * cfg.kv_dim \
            * BYTES_ACT
    else:
        kv_bytes = torch.zeros_like(w_stream)
    return dict(n_micro=n_micro, mem=mem, oom=oom, comp_layer=comp_layer,
                t_head=t_head, act_group_bytes=act_group_bytes,
                w_stream=w_stream, a_stream=a_stream, kv_bytes=kv_bytes)


def _stage1_torch(ctx: StepCostContext, dp, tp, sp, ta, seq_par) -> dict:
    """Stage 1 on the context's torch tier (``stage1="torch"`` /
    ``"torch:cpu"``): numpy degree columns in, numpy fields out."""
    dev = _tier_device(ctx.stage1)
    TIER_CALLS["stage1"] += 1
    cols = [torch.from_numpy(a).to(dev) for a in (dp, tp, sp, ta, seq_par)]
    out = _stage1_torch_cols(ctx, *cols, _tierb_scalars(ctx, dev))
    return {k: v.cpu().numpy() for k, v in out.items()}


def _tierb_torch_struct(degrees: list, st: dict,
                        dev: torch.device) -> dict:
    """Device-resident form of one batch struct and its degree columns
    (what the device half of Tier B reads; no padding: eager torch has no
    shapes to bucket).  Cached inside the ``_batch_cache`` entry, per
    device."""
    dp, tp, sp, ta, seq_par, _ep = _degree_columns(degrees)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    names = ("present", "glen", "touched_e", "maxhops_e", "dp_present",
             "dp_maxlen", "dp_glen", "dp_touched", "dp_mask")
    out = {k: put(st[k]) for k in names}
    out["deg"] = tuple(put(a) for a in (dp, tp, sp, ta, seq_par))
    out["masks"] = [put(m) for _s, m, _dm in st["masks"]]
    return out


def _tierb_torch_eval(ctx: StepCostContext, st: dict, tst: dict,
                      sc: dict) -> torch.Tensor:
    """The device half of the fused Tier B for one feasible candidate
    list: stage 1 (:func:`_stage1_torch_cols`) and stage 2's heavy part,
    the per-hop link-load chains and their maxima (the reference's
    ``_tierb_jax_fn`` body).  Returns the (12, nC) rows the host epilogue
    of :func:`_tierb_torch` reads."""
    spec = ctx.spec
    dp, tp, sp, ta, seq_par = tst["deg"]
    s1 = _stage1_torch_cols(ctx, dp, tp, sp, ta, seq_par, sc)
    act_group_bytes, kv_bytes = s1["act_group_bytes"], s1["kv_bytes"]
    w_stream, a_stream = s1["w_stream"], s1["a_stream"]
    tpf, spf, taf = _f64(tp, sp, ta)
    active = st["active"]

    # ---- stage 2 (mirrors _slot_weights and _traffic_and_power_batch) --
    present, glen = tst["present"], tst["glen"]
    bidir_f = 0.5 if ctx.tatp_bidirectional else 1.0
    if ctx.stream == "auto":
        sel = torch.minimum(w_stream, a_stream)
    elif ctx.stream == "weights":
        sel = w_stream
    else:
        sel = a_stream
    zcol = torch.zeros_like(sel)
    wcols = [zcol] * _N_SLOTS
    chcols = [zcol] * _N_SLOTS
    if 0 in active:
        wcols[0] = sel * 3 * (taf - 1) / taf * bidir_f
    if 1 in active:
        wcols[1] = kv_bytes * torch.clamp(spf - 1, min=1)
    if 2 in active:
        g2 = glen[:, 2]
        nb2 = torch.where(seq_par, 2 * act_group_bytes,
                          4.0 * act_group_bytes)
        wcols[2] = torch.where(seq_par, nb2 * (g2 - 1) / g2,
                               2.0 * nb2 * (g2 - 1) / g2)
        chcols[2] = nb2 / torch.clamp(g2, min=1)
    if 3 in active:
        g3 = glen[:, 3]
        nb3 = 2 * act_group_bytes
        wcols[3] = nb3 * (g3 - 1) / g3
        chcols[3] = nb3 / torch.clamp(g3, min=1)
    if 4 in active:
        g4 = glen[:, 4]
        wcols[4] = torch.where(g4 >= 2, sc["full_layer2"] * (g4 - 1) / g4,
                               0.0)
        chcols[4] = sc["full_layer2"] / torch.clamp(g4, min=1)
    if 5 in active:
        g5 = glen[:, 5]
        wcols[5] = torch.where(g5 >= 2, sc["full_layer"] * (g5 - 1) / g5,
                               0.0)
        chcols[5] = sc["full_layer"] / torch.clamp(g5, min=1)
    W = torch.where(present, torch.stack(wcols, dim=1), 0.0)

    nc, n_links = dp.shape[0], tst["dp_mask"].shape[2]
    exposed = bool(st["exposed"])
    if exposed:
        che = torch.stack(chcols[2:], dim=1)
        effe = torch.where(che <= 0, 1.0, che / (che + spec.bw_half_size))
        we = W[:, 2:] / torch.clamp(effe, min=1e-3)
    l0 = torch.zeros((nc, n_links), dtype=torch.float64, device=dp.device)
    l1 = torch.zeros_like(l0)
    for m, s in zip(tst["masks"], active):
        wm0 = W[:, s][:, None, None] * m
        if s >= 2:
            wm1 = we[:, s - 2][:, None, None] * m
        # the numpy tier adds both lanes of one (candidate, link) chain in
        # lock-step; split lanes keep each chain's order
        for k in range(m.shape[1]):
            l0 = l0 + wm0[:, k]
            if s >= 2:
                l1 = l1 + wm1[:, k]
    mx_all = l0.amax(dim=1)
    if exposed:
        t_coll = torch.where(
            tst["touched_e"],
            l1.amax(dim=1) / sc["link_bw"]
            + tst["maxhops_e"] * spec.hop_latency, 0.0)
    else:
        t_coll = torch.zeros_like(mx_all)

    if st["dp_any"]:
        dp_glen = tst["dp_glen"]
        dmask = (dp > 1) & (not ctx.fsdp)
        dpb = torch.where(dmask, sc["w_total"] / (tpf * taf), 0.0)
        ph = 2.0 * dpb * (dp_glen - 1) / dp_glen
        chunk_dp = dpb / torch.clamp(dp_glen, min=1)
        eff_dp = torch.where(chunk_dp <= 0, 1.0,
                             chunk_dp / (chunk_dp + spec.bw_half_size))
        wdp = torch.where(tst["dp_present"],
                          ph / torch.clamp(eff_dp, min=1e-3), 0.0)
        mdp = tst["dp_mask"]
        wmd = wdp[:, None, None] * mdp
        ldp = torch.zeros_like(l0)
        for k in range(mdp.shape[1]):
            ldp = ldp + wmd[:, k]
        t_dp = torch.where(
            tst["dp_touched"],
            0.5 * (ldp.amax(dim=1) / sc["link_bw"]
                   + tst["dp_maxlen"] * spec.hop_latency), 0.0)
    else:
        t_dp = torch.zeros_like(mx_all)

    # the candidate-sized chains past the per-link maxima (slot weights
    # -> contention / ring stream time / D2D volume, the step fold, the
    # power and ratio tail) are finished on the host through the numpy
    # tier's own helpers, as the reference's jitted tier finishes them
    return torch.stack([
        s1["mem"], s1["comp_layer"], t_coll, t_dp, s1["t_head"], mx_all,
        s1["n_micro"].to(torch.float64), s1["oom"].to(torch.float64),
        act_group_bytes, w_stream, a_stream, kv_bytes])


def _tierb_torch(ctx: StepCostContext,
                 degrees: list[ParallelDegrees]) -> dict:
    """Run the fused Tier B on the context's torch tier over one (feasible)
    candidate list: the stage-1 fields plus the assembled stage-2 column
    rows (the reference's ``_tierb_jax``)."""
    dev = _tier_device(ctx.tierb)
    st = _batch_struct(ctx, degrees)
    skey = f"_torch:{dev}"
    tst = st.get(skey)
    if tst is None:
        tst = st[skey] = _tierb_torch_struct(degrees, st, dev)
    sc = getattr(ctx, "_tierb_sc", None)
    if sc is None:
        sc = ctx._tierb_sc = _tierb_scalars(ctx, dev)
    TIER_CALLS["tierb"] += 1
    out = _tierb_torch_eval(ctx, st, tst, sc).cpu().numpy()
    (mem, comp_layer, t_coll, t_dp, t_head, mx_all,
     n_micro, oomf, act_group_bytes, w_stream, a_stream, kv_bytes) = out
    # the candidate-sized stage-2 chains + step fold + power / ratio
    # tail, through the same numpy helpers as the numpy tier
    dp, tp, sp, ta, seq_par, _ep = _degree_columns(degrees)
    bidir = ctx.tatp_bidirectional
    spec = ctx.spec
    hopf, sp_hops = st["hopf"], st["sp_hops"]
    sel = _stream_select(ctx.stream, w_stream, a_stream)
    W, _ch = _slot_weights(st, sel, kv_bytes, act_group_bytes,
                           ctx.p_layer, sp, ta, seq_par, bidir)
    contention = _contention_factor(st, W, mx_all)
    t_p2p = _overlap_stream_time(spec, sel, kv_bytes, hopf, sp_hops,
                                 contention, sp, ta, seq_par, bidir)
    rounds0 = (ta + 1) // 2 if bidir else ta - 1
    t_sched = np.where(ta > 1, 3 * rounds0 * T_DISPATCH, 0.0)
    t_layer = t_coll + np.maximum(comp_layer, t_p2p) + t_sched
    step = ctx.n_l * t_layer + t_dp + t_head
    thr = ctx.tokens / step
    dmask = (dp > 1) & (not ctx.fsdp)
    d2d = _d2d_volume(st, W, ctx.n_l)
    d2d = np.where(dmask,
                   d2d + 2 * BYTES_W * ctx.p_total / (tp * ta) * dp, d2d)
    e_d2d = d2d * spec.e_d2d
    e_static = 450.0 * ctx.n_dies * step
    energy = ctx.e_comp + ctx.e_hbm + e_d2d + e_static
    power = energy / step
    power_eff = np.where(power > 0, thr / power, 0.0)
    bw_cap = ctx.n_dies * 4 * spec.link_bw
    bw_util = np.minimum(1.0, d2d / step / bw_cap)
    coll_frac = (ctx.n_l * t_coll + t_dp) / step
    cols = np.stack([step, thr, mem, power, power_eff, bw_util,
                     comp_layer, t_p2p, t_coll, t_dp, t_head, coll_frac,
                     e_d2d, hopf]).T.tolist()
    return dict(
        cols=cols, n_micro=n_micro.astype(np.int64), oom=oomf != 0.0,
        mem=mem, comp_layer=comp_layer, t_head=t_head,
        act_group_bytes=act_group_bytes, w_stream=w_stream,
        a_stream=a_stream, kv_bytes=kv_bytes, fb_idx=st["fb_idx"])


def simulate_batch(ctx: StepCostContext, degrees: list[ParallelDegrees], *,
                   run_tcme_optimizer: bool = False,
                   prune_oom: bool = False,
                   prune_dominated: bool = False) -> list[SimResult]:
    """Score a batch of candidate degree tuples against one context.

    Stage 1 (:func:`_stage1_numpy`, or the torch twin behind
    ``ctx.stage1 != "numpy"``) vectorizes the memory/compute/stream-byte
    arithmetic over all candidates; stage 2
    (:func:`_traffic_and_power_batch`) vectorizes the link-level traffic
    model over all surviving candidates on per-wafer link-template banks.
    ``prune_oom`` short-circuits memory-infeasible candidates before any
    traffic modeling (their ``mem_per_die`` stays exact; ``step_time``
    becomes ``inf``).

    ``prune_dominated`` additionally drops candidates that have an
    *identical* memory footprint (and compute time) as another candidate
    but strictly worse stream/collective byte volumes on every comm axis —
    they cannot win, so the traffic model skips them.  Dominance cannot
    displace the batch argmax (the dominator stays and is at least as
    fast), so argmax-only consumers (:func:`best_config`) enable it; the
    solver's memoized evaluation path does not, keeping DLWS trajectories
    bitwise identical to the scalar reference.
    """
    if not degrees:
        return []
    cfg, spec = ctx.cfg, ctx.spec
    n_dies = ctx.n_dies
    fsdp = ctx.fsdp
    nC = len(degrees)

    dp, tp, sp, ta, seq_par, _ep = _degree_columns(degrees)
    feasible = dp * tp * sp * ta <= n_dies

    # fused torch Tier B: search-time evaluations only — final
    # (recorded) evaluations always take the anchored numpy/scalar path,
    # so plan-predicted numbers are backend-invariant by construction
    jx = None
    fidx = None
    if ctx.tierb != "numpy" and nC >= _TIER_MIN_BATCH \
            and ctx.wafer.cache_enabled and not run_tcme_optimizer:
        if feasible.all():
            jx = _tierb_torch(ctx, degrees)
        else:
            # struct building (hierarchical_map) needs feasible degrees;
            # infeasible rows only ever produce the inf sentinel below
            fidx = np.nonzero(feasible)[0]
            if len(fidx):
                jx = _tierb_torch(ctx, [degrees[i] for i in fidx])
            if jx is None:
                fidx = None

    if jx is not None:
        if fidx is None:
            n_micro, mem, oom = jx["n_micro"], jx["mem"], jx["oom"]
            comp_layer, t_head = jx["comp_layer"], jx["t_head"]
            act_group_bytes = jx["act_group_bytes"]
            w_stream, a_stream = jx["w_stream"], jx["a_stream"]
            kv_bytes = jx["kv_bytes"]
        else:  # scatter back; infeasible rows never read these fields
            n_micro = np.ones(nC, np.int64)
            mem = np.full(nC, np.inf)
            oom = np.ones(nC, bool)
            comp_layer = np.zeros(nC)
            t_head = np.zeros(nC)
            act_group_bytes = np.zeros(nC)
            w_stream = np.zeros(nC)
            a_stream = np.zeros(nC)
            kv_bytes = np.zeros(nC)
            n_micro[fidx] = jx["n_micro"]
            mem[fidx] = jx["mem"]
            oom[fidx] = jx["oom"]
            comp_layer[fidx] = jx["comp_layer"]
            t_head[fidx] = jx["t_head"]
            act_group_bytes[fidx] = jx["act_group_bytes"]
            w_stream[fidx] = jx["w_stream"]
            a_stream[fidx] = jx["a_stream"]
            kv_bytes[fidx] = jx["kv_bytes"]
    else:
        if ctx.stage1 != "numpy":
            s1 = _stage1_torch(ctx, dp, tp, sp, ta, seq_par)
        else:
            s1 = _stage1_numpy(ctx, dp, tp, sp, ta, seq_par)
        n_micro, mem, oom = s1["n_micro"], s1["mem"], s1["oom"]
        comp_layer, t_head = s1["comp_layer"], s1["t_head"]
        act_group_bytes = s1["act_group_bytes"]
        w_stream, a_stream = s1["w_stream"], s1["a_stream"]
        kv_bytes = s1["kv_bytes"]

    # ---------------- dominance pre-filter (search-only heuristic) --------
    # Byte dominance implies time dominance only while ring geometry is
    # uniform: on a pristine full wafer the snake embedding gives every
    # candidate contiguous rings (hop factor 1), so more bytes on every
    # axis can't be rescued by better routing.  Degraded wafers (holes,
    # dead links, die subsets) break that symmetry — the filter disables
    # itself there rather than risk pruning the true argmax.
    pristine = not ctx.wafer.failed_dies and not ctx.wafer.failed_links \
        and ctx.n_dies == ctx.spec.n_dies
    dominated = np.zeros(nC, bool)
    if prune_dominated and pristine and nC > 1:
        bidir_f = 0.5 if ctx.tatp_bidirectional else 1.0
        if ctx.stream == "auto":
            sel = np.minimum(w_stream, a_stream)
        elif ctx.stream == "weights":
            sel = w_stream + np.zeros(nC)
        else:
            sel = a_stream + np.zeros(nC)
        # per-axis comm byte volumes: TATP streams, SP KV rings, TP
        # collectives, DP gradient all-reduce (fsdp spaces collapse to a
        # single legal candidate, so their ag/rs volume is not needed).
        # NB: these mirror _traffic_and_power's byte formulas and must stay
        # monotone-consistent with them; the argmax-equivalence test in
        # tests/test_solver_fast.py guards the pairing.
        comm = np.stack([
            np.where(ta > 1, sel * 3 * (ta - 1) / ta * bidir_f, 0.0),
            np.where((sp > 1) & ~seq_par,
                     kv_bytes * np.maximum(sp - 1, 1), 0.0),
            np.where(tp > 1, 4.0 * act_group_bytes, 0.0),
            np.zeros(nC) if fsdp
            else np.where(dp > 1, BYTES_W * ctx.p_total / (tp * ta), 0.0),
        ], axis=1)
        by_footprint: dict = {}
        for i in range(nC):
            if not feasible[i] or oom[i]:
                continue  # infeasible/OOM candidates are handled upstream
            by_footprint.setdefault(
                (float(mem[i]), float(comp_layer[i]), int(n_micro[i])),
                []).append(i)
        for idxs in by_footprint.values():
            if len(idxs) < 2:
                continue
            # vectorized pairwise dominance within the footprint group:
            # j is dominated iff some i has comm[i] <= comm[j] on every
            # axis and < on one.  Dominance is transitive (<=/< compose),
            # so witnesses that are themselves dominated never change the
            # final set — the full pairwise matrix equals the old
            # skip-dominated-witness loop.
            g = comm[idxs]  # (m, axes)
            ge = (g[:, None, :] >= g[None, :, :]).all(-1)
            gt = (g[:, None, :] > g[None, :, :]).any(-1)
            dom = (ge & gt).any(axis=1)
            dominated[idxs] = dom

    results: list[Optional[SimResult]] = [None] * nC
    survivors: list[int] = []
    feas_l = feasible.tolist()
    oom_l = oom.tolist()
    dom_l = dominated.tolist()
    for i, deg in enumerate(degrees):
        if not feas_l[i]:
            results[i] = SimResult(math.inf, 0.0, math.inf, True, 0.0,
                                   0.0, 0.0,
                                   {"reason": "degree exceeds dies"},
                                   deg, ctx.engine)
            continue
        if prune_oom and oom_l[i]:
            results[i] = SimResult(math.inf, 0.0, float(mem[i]), True, 0.0,
                                   0.0, 0.0, {"reason": "oom-pruned",
                                              "n_micro": int(n_micro[i])},
                                   deg, ctx.engine)
            continue
        if dom_l[i]:
            # same memory footprint as a surviving candidate, strictly
            # worse comm bytes: cannot be the argmax, skip traffic modeling
            results[i] = SimResult(math.inf, 0.0, float(mem[i]),
                                   oom_l[i], 0.0, 0.0, 0.0,
                                   {"reason": "dominated-pruned",
                                    "n_micro": int(n_micro[i])},
                                   deg, ctx.engine)
            continue
        survivors.append(i)

    if survivors:
        # full-fidelity evaluations (TCME optimizer runs, or caches off)
        # keep the per-candidate CommOp path; tiny batches take the scalar
        # lean path too (bitwise-equal either way, and the matrix setup
        # only pays for itself from a handful of candidates up); everything
        # else — the bulk of the search — goes through the vectorized
        # traffic stage.
        scalar_route = (ctx.engine == "tcme" and run_tcme_optimizer) \
            or not ctx.wafer.cache_enabled or len(survivors) <= 4
        if jx is not None:
            # stage 2 already computed by the fused torch tier —
            # assemble results straight from its column rows (structural
            # fallback candidates keep the scalar path, as in the numpy
            # tier)
            pos = None if fidx is None \
                else {int(i): j for j, i in enumerate(fidx)}
            fbset = set(jx["fb_idx"])
            cols = jx["cols"]
            e_comp, e_hbm = ctx.e_comp, ctx.e_hbm
            for i in survivors:
                j = i if pos is None else pos[i]
                if j in fbset:
                    results[i] = _traffic_and_power(
                        ctx, degrees[i],
                        comp_layer=float(comp_layer[i]),
                        t_head=float(t_head[i]),
                        mem=float(mem[i]), oom=bool(oom[i]),
                        n_micro=int(n_micro[i]),
                        act_group_bytes=float(act_group_bytes[i]),
                        w_stream=float(w_stream[i]),
                        a_stream=float(a_stream[i]),
                        kv_bytes=float(kv_bytes[i]),
                        run_tcme_optimizer=run_tcme_optimizer)
                else:
                    results[i] = _result_from_cols(
                        degrees[i], ctx.engine, cols[j], bool(oom[i]),
                        int(n_micro[i]), e_comp, e_hbm)
        elif scalar_route:
            for i in survivors:
                results[i] = _traffic_and_power(
                    ctx, degrees[i],
                    comp_layer=float(comp_layer[i]),
                    t_head=float(t_head[i]),
                    mem=float(mem[i]), oom=bool(oom[i]),
                    n_micro=int(n_micro[i]),
                    act_group_bytes=float(act_group_bytes[i]),
                    w_stream=float(w_stream[i]),
                    a_stream=float(a_stream[i]),
                    kv_bytes=float(kv_bytes[i]),
                    run_tcme_optimizer=run_tcme_optimizer)
        else:
            idx = np.asarray(survivors, np.int64)
            for i, res in zip(survivors, _traffic_and_power_batch(
                    ctx, [degrees[i] for i in survivors],
                    dp=dp[idx], tp=tp[idx], sp=sp[idx], ta=ta[idx],
                    seq_par=seq_par[idx],
                    comp_layer=comp_layer[idx], t_head=t_head[idx],
                    mem=mem[idx], oom=oom[idx], n_micro=n_micro[idx],
                    act_group_bytes=act_group_bytes[idx],
                    w_stream=w_stream[idx], a_stream=a_stream[idx],
                    kv_bytes=kv_bytes[idx],
                    run_tcme_optimizer=run_tcme_optimizer)):
                results[i] = res
    return results  # type: ignore[return-value]


def _axis_template(groups: dict, axis: str, kind: str, groups_list: list,
                   wafer: Wafer) -> tuple:
    """(concatenated link ids, max single-pair path length, dense per-link
    hop-count row) for all groups of one parallel axis, cached inside the
    (wafer-cached) groups dict.

    The hop-count row is the template's link-bank form: ``row[link_id]``
    counts how many times the axis's pair-by-pair traversal crosses that
    link, over the fixed link universe of the wafer — the batched traffic
    stage turns a whole candidate batch's link loads into row gathers."""
    tkey = ("_tmpl", axis, kind if kind == "p2p_chain" else "ring")
    tmpl = groups.get(tkey)
    if tmpl is None:
        parts = [link_template(kind, g, wafer) for g in groups_list]
        ids = [p.ids for p in parts if len(p.ids)]
        cat = (np.concatenate(ids) if len(ids) > 1
               else (ids[0] if ids else _EMPTY_IDS))
        tmpl = (cat, max((p.max_len for p in parts), default=0),
                template_bank_row(cat, wafer))
        groups[tkey] = tmpl
    return tmpl


# slot order of the batched traffic stage — it mirrors the rec order of
# the scalar lean path exactly (overlapped streams first, then exposed
# collectives), so the per-link load accumulation chains are identical:
# 0 tatp ring · 1 sp ring · 2 tp allreduce|allgather · 3 tp reducescatter
# · 4 fsdp allgather · 5 fsdp reducescatter
_N_SLOTS = 6


def _tatp_hop_factor(tatp_groups: list, wafer: Wafer,
                     bidirectional: bool) -> int:
    """Worst ring-hop distance of the TATP groups (tail latency, Fig. 5a).
    One shared implementation for the batched slot structs and the scalar
    CommOp path, so the bitwise pin between them cannot desynchronize
    (``simulate_step_reference`` keeps its own deliberately frozen copy)."""
    if not tatp_groups:
        return 1
    if bidirectional:
        hop_factor = max(max_ring_hops(g, wafer, wrap=False)
                         for g in tatp_groups)
    else:  # naive TSPP needs the wrap link: line topology pays O(N)
        hop_factor = max(max_ring_hops(g, wafer, wrap=True)
                         for g in tatp_groups)
    return max(1, hop_factor)


def _sp_hop_factor(sp_groups: list, wafer: Wafer) -> int:
    """Worst ring-hop distance of the SP KV rings (shared as above)."""
    return max((max_ring_hops(g, wafer, wrap=False) for g in sp_groups),
               default=1)


def _bank_row_index(wafer: Wafer, row: np.ndarray) -> int:
    """Global index of a hop-count row in the wafer's link-template bank
    (index 0 is the reserved all-zero row).  Rows are registered once —
    they are cached template objects — and the stacked matrix is rebuilt
    lazily on growth."""
    j = wafer._bank_index.get(id(row))
    if j is None:
        wafer._bank_rows.append(row)
        j = len(wafer._bank_rows)
        wafer._bank_index[id(row)] = j
        wafer._bank_mat = None
    return j


def _bank_matrices(wafer: Wafer, L: int) -> tuple:
    """(bank matrix, per-row any-link flag)."""
    got = wafer._bank_mat
    if got is None:
        B = np.zeros((len(wafer._bank_rows) + 1, L), np.int64)
        for k, r in enumerate(wafer._bank_rows):
            B[k + 1] = r
        got = (B, B.any(axis=1))
        wafer._bank_mat = got
    return got


def _slot_struct(ctx: StepCostContext, deg: ParallelDegrees) -> tuple:
    """Degree-dependent but byte-independent traffic structure of one
    candidate: per-slot (bank row index, max path length, group size,
    #groups), the DP all-reduce entry, ring tail-latency hop factors, and
    whether the candidate needs the scalar fallback (FSDP with multiple dp
    groups interleaves unequal payloads).  Cached in the wafer-cached
    groups dict, so repeat solves pay one dict lookup per candidate."""
    groups = ctx.groups_for(deg)
    key = ("_slots", deg.seq_par, ctx.fsdp, ctx.tatp_bidirectional)
    st = groups.get(key)
    if st is not None:
        return st
    wafer = ctx.wafer
    slots: list = [None] * _N_SLOTS
    fallback = False
    tatp_groups = groups.get("tatp", [])
    hop_factor = _tatp_hop_factor(tatp_groups, wafer,
                                  ctx.tatp_bidirectional)
    if deg.tatp > 1 and tatp_groups:
        t = _axis_template(groups, "tatp", "p2p_ring", tatp_groups, wafer)
        slots[0] = (_bank_row_index(wafer, t[2]), t[1],
                    len(tatp_groups[0]), len(tatp_groups))
    sp_hops = 1
    if deg.sp > 1 and not deg.seq_par:
        spg = groups.get("sp", [])
        sp_hops = _sp_hop_factor(spg, wafer)
        if spg:
            t = _axis_template(groups, "sp", "p2p_ring", spg, wafer)
            slots[1] = (_bank_row_index(wafer, t[2]), t[1],
                        len(spg[0]), len(spg))
    if deg.tp > 1:
        tpg = groups.get("tp", [])
        if tpg:
            t = _axis_template(groups, "tp",
                               "allgather" if deg.seq_par else "allreduce",
                               tpg, wafer)
            slots[2] = (_bank_row_index(wafer, t[2]), t[1],
                        len(tpg[0]), len(tpg))
            if deg.seq_par:  # rs shares the ring template with ag
                slots[3] = slots[2]
    if ctx.fsdp:
        dpg = groups.get("dp", [])
        if len(dpg) > 1:
            fallback = True  # interleaved ag/rs with unequal payloads
        elif dpg:
            t = _axis_template(groups, "dp", "allgather", dpg, wafer)
            slots[4] = (_bank_row_index(wafer, t[2]), t[1],
                        len(dpg[0]), len(dpg))
            slots[5] = slots[4]
    dp_entry = None
    if deg.dp > 1 and not ctx.fsdp:
        dpg = groups.get("dp", [])
        if dpg:
            t = _axis_template(groups, "dp", "allreduce", dpg, wafer)
            dp_entry = (_bank_row_index(wafer, t[2]), t[1], len(dpg[0]))
    st = (tuple(slots), dp_entry, hop_factor, sp_hops, fallback)
    groups[key] = st
    return st


# _slot_vec column layout: one flat row per candidate so the batch prep is
# a single array-row copy instead of ~20 scalar writes
# [0:6] bank row idx · [6:12] present · [12:18] max path len ·
# [18:24] group size · [24:30] #groups · [30] dp bank idx · [31] dp max
# len · [32] dp group size · [33] dp present · [34] tatp hop factor ·
# [35] sp hop factor · [36:42] per-slot max hop count · [42] dp max hops
_VEC_W = 43


def _slot_vec(ctx: StepCostContext,
              deg: ParallelDegrees) -> Optional[np.ndarray]:
    """Flat-row form of :func:`_slot_struct` (None = scalar fallback),
    cached directly on the wafer under the full structural identity (the
    batch path only runs on cache-enabled wafers)."""
    key = ("_vec", deg.key, ctx.engine, ctx.fsdp, ctx.tatp_bidirectional)
    cache = ctx.wafer._groups_cache
    vec = cache.get(key, False)
    if vec is not False:
        return vec
    slots, dp_entry, hf, sph, fallback = _slot_struct(ctx, deg)
    if fallback:
        vec = None
    else:
        rows = ctx.wafer._bank_rows
        vec = np.zeros(_VEC_W)
        vec[18:24] = 1.0
        vec[32] = 1.0
        for s, ent in enumerate(slots):
            if ent is None:
                continue
            vec[s] = ent[0]
            vec[6 + s] = 1.0
            vec[12 + s] = ent[1]
            vec[18 + s] = ent[2]
            vec[24 + s] = ent[3]
            vec[36 + s] = int(rows[ent[0] - 1].max())
        if dp_entry is not None:
            vec[30] = dp_entry[0]
            vec[31] = dp_entry[1]
            vec[32] = dp_entry[2]
            vec[33] = 1.0
            vec[42] = int(rows[dp_entry[0] - 1].max())
        vec[34] = hf
        vec[35] = sph
    cache[key] = vec
    return vec


_KARR = np.arange(64)


def _karr(k: int) -> np.ndarray:
    """First ``k`` hop indices (grown on demand; shared comparison rail
    for the per-hop addend masks)."""
    global _KARR
    if k > len(_KARR):
        _KARR = np.arange(max(k, 2 * len(_KARR)))
    return _KARR[:k]


def _batch_struct(ctx: StepCostContext, degs: list[ParallelDegrees]) -> dict:
    """Byte-independent batch structure for one candidate list: slot
    presence/geometry arrays, precomputed per-hop addend masks against the
    wafer's link-template bank, and the derived touch flags.  Cached on
    the wafer per (candidate identity tuple, engine, fsdp, direction) —
    DP grids and GA generations are stable lists, so repeat solves reuse
    the gathered masks and only recompute byte weights.  The cache is
    bounded (mask stacks are big; GA/ILP miss lists vary), mirroring
    ``_DEGREE_ARRAYS_CAP``."""
    wafer = ctx.wafer
    key = (tuple(d.key for d in degs), ctx.engine, ctx.fsdp,
           ctx.tatp_bidirectional)
    cache = wafer._batch_cache
    st = cache.get(key)
    if st is not None:
        return st
    nc = len(degs)
    L = wafer.link_universe()
    S = np.zeros((nc, _VEC_W))
    S[:, 18:24] = 1.0
    S[:, 32] = 1.0
    S[:, 34:36] = 1.0
    fb_idx: list[int] = []
    for i, deg in enumerate(degs):
        vec = _slot_vec(ctx, deg)
        if vec is None:
            fb_idx.append(i)
            continue
        S[i] = vec
    tidx = S[:, 0:6].astype(np.int64)
    present = S[:, 6:12] != 0.0
    maxlen = S[:, 12:18]
    skmax = S[:, 36:42].max(axis=0)
    B, Bnz = _bank_matrices(wafer, L)
    active = [s for s in range(_N_SLOTS) if present[:, s].any()]
    rownz = Bnz[tidx] & present
    dp_present = S[:, 33] != 0.0
    dp_tidx = S[:, 30].astype(np.int64)
    dkm = int(S[:, 42].max())
    # column compression: restrict every load matrix to links actually
    # touched by some referenced row — the bottleneck max is unchanged
    # (dropped columns are zero in every row) and the hop chains shrink
    used = np.unique(np.concatenate([tidx.ravel(), dp_tidx]))
    colmask = B[used].any(axis=0)
    if not colmask.any():
        colmask[0] = True  # keep a 1-column rail so reductions stay valid
    masks = []
    nops = S[:, 24:30]
    for s in active:
        c = B[tidx[:, s]][:, colmask]
        km = int(skmax[s])
        masks.append((s, c[:, None, :] > _karr(km)[:, None],
                      nops[:, s, None] > _karr(int(nops[:, s].max()))))
    cdp = B[dp_tidx][:, colmask]
    st = dict(
        fb_idx=fb_idx, present=present, glen=S[:, 18:24], nops=nops,
        active=active, masks=masks,
        exposed=[s for s in active if s >= 2],
        touched_all=rownz.any(axis=1),
        touched_e=rownz[:, 2:].any(axis=1),
        has_overlap=present[:, :2].any(axis=1),
        maxhops_e=np.max(np.where(present[:, 2:], maxlen[:, 2:], 0),
                         axis=1),
        dp_present=dp_present, dp_maxlen=S[:, 31], dp_glen=S[:, 32],
        dp_any=bool(dp_present.any()),
        dp_mask=cdp[:, None, :] > _karr(dkm)[:, None],
        dp_touched=dp_present & Bnz[dp_tidx],
        hopf=S[:, 34], sp_hops=S[:, 35],
    )
    if len(cache) >= _DEGREE_ARRAYS_CAP // 8:
        cache.clear()  # bounded: each entry holds multi-KB mask stacks
    cache[key] = st
    return st


def _stream_select(stream: str, w_stream: np.ndarray,
                   a_stream: np.ndarray) -> np.ndarray:
    """Streamed-operand bytes per TATP round under one stream policy."""
    if stream == "auto":
        return np.minimum(w_stream, a_stream)
    if stream == "weights":
        return w_stream
    return a_stream


def _slot_weights(st: dict, sel, kv_bytes, act_group_bytes, p_layer,
                  sp, ta, seq_par, bidir: bool):
    """Per-slot per-hop byte weights ``(W, CH)`` — the scalar formulas,
    arrayed.  One numpy implementation shared by the numpy tier and the
    jitted tier's host epilogue, so every consumer rounds identically."""
    active, glen, present = st["active"], st["glen"], st["present"]
    nc = len(sel)
    bidir_f = 0.5 if bidir else 1.0
    W = np.zeros((nc, _N_SLOTS))
    CH = np.zeros((nc, _N_SLOTS))
    if 0 in active:  # TATP p2p_ring (pair-hop bytes of a ring op = nbytes)
        W[:, 0] = sel * 3 * (ta - 1) / ta * bidir_f
        CH[:, 0] = sel / ta
    if 1 in active:  # SP KV p2p_ring
        nb1 = kv_bytes * np.maximum(sp - 1, 1)
        W[:, 1] = nb1
        CH[:, 1] = nb1 / np.maximum(glen[:, 1], 1)
    if 2 in active:  # TP allreduce (2(g-1)/g) or Megatron-3 ag ((g-1)/g)
        g2 = glen[:, 2]
        nb2 = np.where(seq_par, 2 * act_group_bytes, 4.0 * act_group_bytes)
        W[:, 2] = np.where(seq_par, nb2 * (g2 - 1) / g2,
                           2.0 * nb2 * (g2 - 1) / g2)
        CH[:, 2] = nb2 / np.maximum(g2, 1)
    if 3 in active:  # Megatron-3 reducescatter (same payload as its ag)
        g3 = glen[:, 3]
        nb3 = 2 * act_group_bytes
        W[:, 3] = nb3 * (g3 - 1) / g3
        CH[:, 3] = nb3 / np.maximum(g3, 1)
    full_layer = BYTES_W * p_layer
    if 4 in active:  # FSDP full-layer allgather
        g4 = glen[:, 4]
        W[:, 4] = np.where(g4 >= 2, (2 * full_layer) * (g4 - 1) / g4, 0.0)
        CH[:, 4] = (2 * full_layer) / np.maximum(g4, 1)
    if 5 in active:  # FSDP gradient reducescatter
        g5 = glen[:, 5]
        W[:, 5] = np.where(g5 >= 2, full_layer * (g5 - 1) / g5, 0.0)
        CH[:, 5] = full_layer / np.maximum(g5, 1)
    return np.where(present, W, 0.0), CH


def _d2d_volume(st: dict, W: np.ndarray, n_l: int) -> np.ndarray:
    """Per-step D2D byte volume: one add per group, in the mask records'
    slot order (the scalar engine's chain, arrayed)."""
    glen = st["glen"]
    d2d = np.zeros(W.shape[0])
    for s, _m, dm in st["masks"]:
        xm = (W[:, s] * glen[:, s] * n_l)[:, None] * dm
        for k in range(dm.shape[1]):
            d2d += xm[:, k]
    return d2d


def _contention_factor(st: dict, W: np.ndarray,
                       mx_all: np.ndarray) -> np.ndarray:
    """Streamed-ring slowdown when collectives share its bottleneck
    link (``mx_all`` is the unweighted per-link load maximum)."""
    own = np.max(np.where(st["present"][:, :2], W[:, :2], 0.0), axis=1)
    use_ctn = st["touched_all"] & st["has_overlap"] & (own > 0)
    return np.where(
        use_ctn, np.maximum(1.0, mx_all / np.where(own > 0, own, 1.0)),
        1.0)


def _overlap_stream_time(spec, sel, kv_bytes, hopf, sp_hops, contention,
                         sp, ta, seq_par, bidir: bool) -> np.ndarray:
    """Overlapped stream time (ring_stream_time, arrayed)."""
    block0 = sel / ta
    eff0 = np.where(block0 <= 0, 1.0,
                    block0 / (block0 + spec.bw_half_size))
    rounds0 = (ta + 1) // 2 if bidir else ta - 1
    per0 = (block0 * hopf * contention) / (spec.link_bw * eff0) \
        + hopf * spec.hop_latency
    t_p2p = np.where((ta > 1) & (sel > 0), 3 * rounds0 * per0, 0.0)
    tb1 = kv_bytes * sp
    block1 = tb1 / sp
    eff1 = np.where(block1 <= 0, 1.0,
                    block1 / (block1 + spec.bw_half_size))
    rounds1 = (sp + 1) // 2 if bidir else sp - 1
    hops1 = np.maximum(1, sp_hops)
    per1 = (block1 * hops1 * contention) / (spec.link_bw * eff1) \
        + hops1 * spec.hop_latency
    return t_p2p + np.where((sp > 1) & ~seq_par & (tb1 > 0),
                            3 * rounds1 * per1, 0.0)


def _traffic_and_power_batch(
        ctx: StepCostContext, degs: list[ParallelDegrees], *,
        dp, tp, sp, ta, seq_par, comp_layer, t_head, mem, oom, n_micro,
        act_group_bytes, w_stream, a_stream, kv_bytes,
        run_tcme_optimizer: bool = False) -> list[SimResult]:
    """Stage 2, fully batched: link-level traffic + power for all surviving
    candidates in one matrix computation (arithmetic replays the scalar
    lean path op-for-op, so results stay bitwise identical to
    :func:`simulate_step_reference`).

    Each candidate contributes one bank row per traffic slot (gathered
    from the wafer-cached link-template banks via :func:`_batch_struct`);
    per-link loads for the whole batch accumulate by replaying the scalar
    per-hop add chain against precomputed hop masks, and every downstream
    scalar formula (contention, exposed-phase time, ring stream time,
    power) runs as an elementwise array expression in the scalar
    evaluation order."""
    spec = ctx.spec
    engine, fsdp = ctx.engine, ctx.fsdp
    n_l, n_dies, tokens = ctx.n_l, ctx.n_dies, ctx.tokens
    bidir, stream = ctx.tatp_bidirectional, ctx.stream
    nc = len(degs)

    st = _batch_struct(ctx, degs)
    exposed = st["exposed"]
    hopf, sp_hops = st["hopf"], st["sp_hops"]
    fb: dict[int, SimResult] = {}
    for i in st["fb_idx"]:
        fb[i] = _traffic_and_power(
            ctx, degs[i], comp_layer=float(comp_layer[i]),
            t_head=float(t_head[i]), mem=float(mem[i]),
            oom=bool(oom[i]), n_micro=int(n_micro[i]),
            act_group_bytes=float(act_group_bytes[i]),
            w_stream=float(w_stream[i]), a_stream=float(a_stream[i]),
            kv_bytes=float(kv_bytes[i]),
            run_tcme_optimizer=run_tcme_optimizer)

    # ---- per-slot per-hop byte weights (the scalar formulas, arrayed) ----
    sel = _stream_select(stream, w_stream, a_stream)
    W, CH = _slot_weights(st, sel, kv_bytes, act_group_bytes, ctx.p_layer,
                          sp, ta, seq_par, bidir)

    # ---- bottleneck links: contention (unweighted, all slots) and the
    # exposed collective phase (granularity-weighted, slots 2+), replaying
    # the scalar per-hop add chain against the precomputed masks ------------
    L = st["dp_mask"].shape[2]
    if exposed:
        CHe = CH[:, 2:]
        effe = np.where(CHe <= 0, 1.0, CHe / (CHe + spec.bw_half_size))
        We = W[:, 2:] / np.maximum(effe, 1e-3)
        loads2 = np.zeros((nc, 2, L))  # lane 0: unweighted; lane 1: exposed
    else:
        loads2 = np.zeros((nc, 1, L))
    for s, m, _dm in st["masks"]:
        if s >= 2:
            wpair = np.stack([W[:, s], We[:, s - 2]], axis=1)
            wm = wpair[:, :, None, None] * m[:, None, :, :]
        else:
            wm = W[:, s, None, None, None] * m[:, None, :, :]
        for k in range(m.shape[1]):
            if s >= 2:
                loads2 += wm[:, :, k]
            else:
                loads2[:, :1] += wm[:, :, k]
    d2d = _d2d_volume(st, W, n_l)
    mx2 = loads2.max(axis=2)
    mx_all = mx2[:, 0]
    contention = _contention_factor(st, W, mx_all)

    t_coll = np.zeros(nc)
    if exposed:
        t_coll = np.where(
            st["touched_e"],
            mx2[:, 1] / spec.link_bw + st["maxhops_e"] * spec.hop_latency,
            0.0)

    # ---- DP gradient all-reduce (half overlapped with backward) ----------
    dmask = (dp > 1) & (not fsdp)
    t_dp = np.zeros(nc)
    if st["dp_any"]:
        dp_glen = st["dp_glen"]
        dpb = np.where(dmask, BYTES_W * ctx.p_total / (tp * ta), 0.0)
        ph = 2.0 * dpb * (dp_glen - 1) / dp_glen
        chunk_dp = dpb / np.maximum(dp_glen, 1)
        eff_dp = np.where(chunk_dp <= 0, 1.0,
                          chunk_dp / (chunk_dp + spec.bw_half_size))
        wdp = np.where(st["dp_present"], ph / np.maximum(eff_dp, 1e-3), 0.0)
        ldp = np.zeros((nc, L))
        mdp = st["dp_mask"]
        wmd = wdp[:, None, None] * mdp
        for k in range(mdp.shape[1]):
            ldp += wmd[:, k]
        mxd = ldp.max(axis=1)
        t_dp = np.where(
            st["dp_touched"],
            0.5 * (mxd / spec.link_bw
                   + st["dp_maxlen"] * spec.hop_latency), 0.0)

    # ---- overlapped stream time (ring_stream_time, arrayed) --------------
    t_p2p = _overlap_stream_time(spec, sel, kv_bytes, hopf, sp_hops,
                                 contention, sp, ta, seq_par, bidir)

    # per-round orchestration overhead (sequential dependency, not hidden)
    rounds0 = (ta + 1) // 2 if bidir else ta - 1
    t_sched = np.where(ta > 1, 3 * rounds0 * T_DISPATCH, 0.0)

    # Eq. 2 per layer
    t_layer = t_coll + np.maximum(comp_layer, t_p2p) + t_sched
    step = n_l * t_layer + t_dp + t_head
    thr = tokens / step

    # ---- power (Table I energies) ----------------------------------------
    d2d = np.where(dmask,
                   d2d + 2 * BYTES_W * ctx.p_total / (tp * ta) * dp, d2d)
    e_d2d = d2d * spec.e_d2d
    e_static = 450.0 * n_dies * step
    energy = ctx.e_comp + ctx.e_hbm + e_d2d + e_static
    power = energy / step
    power_eff = np.where(power > 0, thr / power, 0.0)
    bw_cap = n_dies * 4 * spec.link_bw
    bw_util = np.minimum(1.0, d2d / step / bw_cap)
    coll_frac = (n_l * t_coll + t_dp) / step

    cols = np.stack([step, thr, mem, power, power_eff, bw_util, comp_layer,
                     t_p2p, t_coll, t_dp, t_head, coll_frac, e_d2d,
                     hopf]).T.tolist()  # one bulk float conversion
    oom_l = oom.tolist()
    nm_l = n_micro.tolist()
    e_comp, e_hbm = ctx.e_comp, ctx.e_hbm
    out: list[SimResult] = []
    for i, deg in enumerate(degs):
        got = fb.get(i)
        if got is not None:
            out.append(got)
            continue
        out.append(_result_from_cols(deg, engine, cols[i], oom_l[i],
                                     nm_l[i], e_comp, e_hbm))
    return out


def _result_from_cols(deg: ParallelDegrees, engine: str, row: list,
                      oom: bool, n_micro: int, e_comp: float,
                      e_hbm: float) -> SimResult:
    """Assemble one :class:`SimResult` from a stage-2 column row
    ``[step, thr, mem, power, power_eff, bw_util, comp_layer, t_p2p,
    t_coll, t_dp, t_head, coll_frac, e_d2d, hopf]`` — shared by the numpy
    and jitted Tier-B paths so their result contracts cannot diverge."""
    (c_step, c_thr, c_mem, c_pow, c_pe, c_bw, c_comp, c_p2p, c_coll,
     c_dp, c_head, c_cf, c_e, c_hf) = row
    return SimResult(
        c_step, c_thr, c_mem, oom, c_pow, c_pe, c_bw,
        {
            "comp_layer": c_comp,
            "p2p_layer": c_p2p,
            "coll_layer": c_coll,
            "dp_exposed": c_dp,
            "head": c_head,
            "n_micro": n_micro,
            "hop_factor": int(c_hf),
            "collective_frac": c_cf,
            "e_comp": e_comp, "e_hbm": e_hbm,
            "e_d2d": c_e,
            "tcme": 1.0,
        },
        deg, engine,
    )


def _traffic_and_power(ctx: StepCostContext, deg: ParallelDegrees, *,
                       comp_layer: float, t_head: float, mem: float,
                       oom: bool, n_micro: int, act_group_bytes: float,
                       w_stream: float, a_stream: float, kv_bytes: float,
                       run_tcme_optimizer: bool) -> SimResult:
    """Stage 2: link-level traffic + power for one feasible candidate
    (scalar tail of the batch engine; arithmetic mirrors the reference).

    Search evaluations take a lean path: ops are plain tuples scored on the
    wafer's cached link templates (no CommOp objects, bincount-accumulated
    loads).  Final plans (``run_tcme_optimizer`` on the tcme engine) build
    real CommOps so TCME can mutate routing — the reference behaviour.
    """
    wafer, cfg, spec = ctx.wafer, ctx.cfg, ctx.spec
    engine, fsdp = ctx.engine, ctx.fsdp
    tokens, n_l, n_dies = ctx.tokens, ctx.n_l, ctx.n_dies
    tatp_bidirectional, stream = ctx.tatp_bidirectional, ctx.stream
    # TCME's optimizer only runs on the full CommOp path; everything else is
    # routing-invariant and bitwise identical on the lean path
    full_fidelity = engine == "tcme" and run_tcme_optimizer \
        or not wafer.cache_enabled

    groups = ctx.groups_for(deg)

    # tail latency: worst ring-hop distance of the TATP groups (Fig. 5a)
    tatp_groups = groups.get("tatp", [])
    hop_factor = _tatp_hop_factor(tatp_groups, wafer, tatp_bidirectional)

    dp_bytes = BYTES_W * ctx.p_total / (deg.tp * deg.tatp) \
        if deg.dp > 1 and not fsdp else 0.0

    tcme_report = None
    if full_fidelity:
        ops_overlap: list[CommOp] = []  # P2P streams (overlap w/ compute)
        ops_exposed: list[CommOp] = []  # collectives (exposed)

        # TATP streams (3 stages: fwd, dgrad, wgrad) — selective transfer.
        if deg.tatp > 1:
            per_link = min(w_stream, a_stream) if stream == "auto" else (
                w_stream if stream == "weights" else a_stream)
            link_share = per_link * 3 * (deg.tatp - 1) / deg.tatp \
                * (0.5 if tatp_bidirectional else 1.0)
            for g in tatp_groups:
                ops_overlap.append(CommOp("p2p_ring", g, link_share,
                                          tag="tatp",
                                          chunk_bytes=per_link / deg.tatp))
        # sp as a context/sequence partition: ring KV exchange (overlapped)
        if deg.sp > 1 and not deg.seq_par:
            for g in groups.get("sp", []):
                ops_overlap.append(CommOp("p2p_ring", g,
                                          kv_bytes * max(deg.sp - 1, 1),
                                          tag="cp_kv"))
        # TP all-reduces (2 fwd + 2 bwd per layer) — or Megatron-3 SP:
        # all-gather + reduce-scatter pairs of the same payload
        if deg.tp > 1:
            for g in groups.get("tp", []):
                if deg.seq_par:
                    ops_exposed.append(CommOp("allgather", g,
                                              2 * act_group_bytes,
                                              tag="sp_ag"))
                    ops_exposed.append(CommOp("reducescatter", g,
                                              2 * act_group_bytes,
                                              tag="sp_rs"))
                else:
                    ops_exposed.append(CommOp("allreduce", g,
                                              4 * act_group_bytes,
                                              tag="tp_ar"))
        # FSDP: per-layer full-weight all-gather (fwd + re-gather in bwd)
        # and a gradient reduce-scatter — coarse collectives (§VIII-B)
        if fsdp:
            full_layer = BYTES_W * ctx.p_layer
            for g in groups.get("dp", []):
                ops_exposed.append(CommOp("allgather", g, 2 * full_layer,
                                          tag="fsdp_ag"))
                ops_exposed.append(CommOp("reducescatter", g, full_layer,
                                          tag="fsdp_rs"))

        all_ops = ops_overlap + ops_exposed
        # run TCME's optimizer for the tcme engine
        if engine == "tcme" and run_tcme_optimizer and all_ops:
            tcme_report = wtcme.optimize_phase(all_ops, wafer)

        # contention: bottleneck link load vs a single ring's own share
        contention = 1.0
        if all_ops:
            mx, touched = max_link_load(all_ops, wafer)
            if touched and ops_overlap:
                own = max(op.pair_bytes() for op in ops_overlap)
                if own > 0:
                    contention = max(1.0, mx / own)
        t_coll = phase_time(ops_exposed, wafer)
        d2d_bytes = 0.0
        for op in all_ops:
            d2d_bytes += op.pair_bytes() * len(op.group) * n_l
        t_dp = 0.0
        if deg.dp > 1 and not fsdp:
            dp_ops = [CommOp("allreduce", g, dp_bytes, tag="dp_ar")
                      for g in groups.get("dp", [])]
            if engine == "tcme" and run_tcme_optimizer:
                wtcme.optimize_phase(dp_ops, wafer)
            t_dp = 0.5 * phase_time(dp_ops, wafer)
    else:
        # lean path: cached per-axis link templates, no CommOp objects.
        # All groups of one axis share group size and payload, so one
        # (concatenated template, weight) entry per axis reproduces the
        # per-op accumulation bitwise: within an axis every op adds the
        # same value, and adds of equal values commute exactly.  The one
        # exception — FSDP ag/rs with multiple dp groups interleaves two
        # different payloads — falls back to per-group entries.
        recs: list[tuple] = []  # (per_hop, ids, max_len, chunk, glen,
        #                          n_ops, overlap?)

        def add_axis(axis, kind, groups_list, nbytes, chunk, overlap):
            if not groups_list:
                return
            glen = len(groups_list[0])
            tmpl = _axis_template(groups, axis, kind, groups_list, wafer)
            recs.append((pair_hop_bytes(kind, glen, nbytes), tmpl[0],
                         tmpl[1], chunk if chunk is not None
                         else nbytes / max(glen, 1), glen,
                         len(groups_list), overlap))

        if deg.tatp > 1:
            per_link = min(w_stream, a_stream) if stream == "auto" else (
                w_stream if stream == "weights" else a_stream)
            add_axis("tatp", "p2p_ring", tatp_groups,
                     per_link * 3 * (deg.tatp - 1) / deg.tatp
                     * (0.5 if tatp_bidirectional else 1.0),
                     per_link / deg.tatp, True)
        if deg.sp > 1 and not deg.seq_par:
            add_axis("sp", "p2p_ring", groups.get("sp", []),
                     kv_bytes * max(deg.sp - 1, 1), None, True)
        n_overlap = len(recs)
        if deg.tp > 1:
            tpg = groups.get("tp", [])
            if deg.seq_par:
                # ag/rs carry the same payload -> same per-hop value, so
                # axis-major order is bitwise-equal to interleaved order
                add_axis("tp", "allgather", tpg, 2 * act_group_bytes,
                         None, False)
                add_axis("tp", "reducescatter", tpg, 2 * act_group_bytes,
                         None, False)
            else:
                add_axis("tp", "allreduce", tpg, 4 * act_group_bytes,
                         None, False)
        if fsdp:
            full_layer = BYTES_W * ctx.p_layer
            dpg = groups.get("dp", [])
            if len(dpg) <= 1:
                add_axis("dp", "allgather", dpg, 2 * full_layer, None,
                         False)
                add_axis("dp", "reducescatter", dpg, full_layer, None,
                         False)
            else:  # interleaved ag/rs with unequal payloads: keep op order
                for g in dpg:
                    t = link_template("allgather", g, wafer)
                    recs.append((pair_hop_bytes("allgather", len(g),
                                                2 * full_layer),
                                 t.ids, t.max_len,
                                 2 * full_layer / max(len(g), 1),
                                 len(g), 1, False))
                    recs.append((pair_hop_bytes("reducescatter", len(g),
                                                full_layer),
                                 t.ids, t.max_len,
                                 full_layer / max(len(g), 1),
                                 len(g), 1, False))

        contention = 1.0
        if recs:
            mx, touched = max_load_entries([(r[1], r[0]) for r in recs])
            if touched and n_overlap:
                own = max(r[0] for r in recs[:n_overlap])
                if own > 0:
                    contention = max(1.0, mx / own)
        exposed_recs = recs[n_overlap:]
        t_coll = 0.0
        if exposed_recs:
            mx, touched = max_load_entries(
                [(r[1], r[0] / max(spec.bw_eff(r[3]), 1e-3))
                 for r in exposed_recs])
            if touched:
                max_hops = max(r[2] for r in exposed_recs)
                t_coll = mx / spec.link_bw + max_hops * spec.hop_latency
        d2d_bytes = 0.0
        for per_hop, _, _, _, glen, n_ops, _ in recs:
            x = per_hop * glen * n_l
            for _ in range(n_ops):
                d2d_bytes += x
        t_dp = 0.0
        if deg.dp > 1 and not fsdp:
            dpg = groups.get("dp", [])
            if dpg:
                glen = len(dpg[0])
                tmpl = _axis_template(groups, "dp", "allreduce", dpg,
                                      wafer)
                ph = pair_hop_bytes("allreduce", glen, dp_bytes)
                mx, touched = max_load_entries(
                    [(tmpl[0], ph / max(spec.bw_eff(
                        dp_bytes / max(glen, 1)), 1e-3))])
                t_dp = 0.5 * (mx / spec.link_bw
                              + tmpl[1] * spec.hop_latency) \
                    if touched else 0.0

    # overlapped stream time (serial rounds, granularity, tail latency)
    t_p2p = 0.0
    if deg.tatp > 1:
        sel = min(w_stream, a_stream) if stream == "auto" else (
            w_stream if stream == "weights" else a_stream)
        t_p2p = ring_stream_time(
            sel, deg.tatp, spec, bidirectional=tatp_bidirectional,
            hops=hop_factor, stages=3, contention=contention)
    if deg.sp > 1 and not deg.seq_par:
        sp_hops = _sp_hop_factor(groups.get("sp", []), wafer)
        t_p2p += ring_stream_time(kv_bytes * deg.sp, deg.sp, spec,
                                  bidirectional=tatp_bidirectional,
                                  hops=max(1, sp_hops), stages=3,
                                  contention=contention)

    # per-round orchestration overhead (sequential dependency, not hidden)
    t_sched = 0.0
    if deg.tatp > 1:
        rounds = (deg.tatp + 1) // 2 if tatp_bidirectional else deg.tatp - 1
        t_sched = 3 * rounds * T_DISPATCH

    # Eq. 2 per layer
    t_layer = t_coll + max(comp_layer, t_p2p) + t_sched

    step = n_l * t_layer + t_dp + t_head
    thr = tokens / step

    # ---------------- power (Table I energies) -----------------------------
    if deg.dp > 1 and not fsdp:
        d2d_bytes += 2 * BYTES_W * ctx.p_total / (deg.tp * deg.tatp) * deg.dp
    e_d2d = d2d_bytes * spec.e_d2d
    # static (leakage/clock) floor: dies draw ~half their dynamic budget
    # while stalled on exposed communication
    e_static = 450.0 * n_dies * step
    energy = ctx.e_comp + ctx.e_hbm + e_d2d + e_static
    power = energy / step
    bw_cap = n_dies * 4 * spec.link_bw
    bw_util = min(1.0, d2d_bytes / step / bw_cap)

    return SimResult(
        step_time=step,
        throughput=thr,
        mem_per_die=mem,
        oom=oom,
        power=power,
        power_eff=thr / power if power > 0 else 0.0,
        bw_util=bw_util,
        breakdown={
            "comp_layer": comp_layer,
            "p2p_layer": t_p2p,
            "coll_layer": t_coll,
            "dp_exposed": t_dp,
            "head": t_head,
            "n_micro": n_micro,
            "hop_factor": hop_factor,
            "collective_frac": (n_l * t_coll + t_dp) / step,
            "e_comp": ctx.e_comp, "e_hbm": ctx.e_hbm, "e_d2d": e_d2d,
            "tcme": (tcme_report.improvement if tcme_report else 1.0),
        },
        degrees=deg,
        engine=engine,
    )


def simulate_step(wafer: Wafer, cfg: ModelConfig, batch: int, seq: int,
                  deg: ParallelDegrees, engine: str = "tcme", *,
                  fsdp: bool = False, tatp_bidirectional: bool = True,
                  stream: str = "auto", dies: Optional[list[int]] = None,
                  run_tcme_optimizer: bool = True) -> SimResult:
    """Batch-of-one wrapper over :func:`simulate_batch` (full fidelity —
    never prunes, so it matches :func:`simulate_step_reference` bitwise)."""
    ctx = StepCostContext(wafer, cfg, batch, seq, engine, fsdp=fsdp,
                          tatp_bidirectional=tatp_bidirectional,
                          stream=stream, dies=dies)
    return simulate_batch(ctx, [deg],
                          run_tcme_optimizer=run_tcme_optimizer)[0]


def simulate_step_reference(wafer: Wafer, cfg: ModelConfig, batch: int,
                            seq: int, deg: ParallelDegrees,
                            engine: str = "tcme", *, fsdp: bool = False,
                            tatp_bidirectional: bool = True,
                            stream: str = "auto",
                            dies: Optional[list[int]] = None,
                            run_tcme_optimizer: bool = True) -> SimResult:
    """The original single-candidate scalar path, kept verbatim as the
    golden reference for the batched engine (and as the baseline the
    search-time benchmark measures its speedup against)."""
    spec = wafer.spec
    alive = dies if dies is not None else wafer.alive_dies()
    n_dies = len(alive)
    if deg.total > n_dies:
        return SimResult(math.inf, 0.0, math.inf, True, 0.0, 0.0, 0.0,
                         {"reason": "degree exceeds dies"}, deg, engine)

    tokens = batch * seq
    n_l = cfg.n_layers
    p_layer = _layer_params(cfg)
    p_active = _layer_active_params(cfg)
    p_total = p_layer * n_l + cfg.vocab_size * cfg.d_model

    # ---------------- spatial mapping ------------------------------------
    degrees_map = {}
    if deg.dp > 1 or fsdp:
        degrees_map["dp"] = deg.dp
    if deg.tp > 1:
        degrees_map["tp"] = deg.tp
    if deg.sp > 1:
        degrees_map["sp"] = deg.sp
    if deg.tatp > 1:
        degrees_map["tatp"] = deg.tatp
    if not degrees_map:
        degrees_map = {"dp": 1}
    groups = wmap.hierarchical_map(wafer, degrees_map, engine)

    # tail latency: worst ring-hop distance of the TATP groups (Fig. 5a)
    tatp_groups = groups.get("tatp", [])
    if tatp_groups:
        if tatp_bidirectional:
            hop_factor = max(max_ring_hops(g, wafer, wrap=False)
                             for g in tatp_groups)
        else:  # naive TSPP needs the wrap link: line topology pays O(N)
            hop_factor = max(max_ring_hops(g, wafer, wrap=True)
                             for g in tatp_groups)
        hop_factor = max(1, hop_factor)
    else:
        hop_factor = 1

    # ---------------- memory ----------------------------------------------
    # ZeRO-style optimizer sharding over dp: FSDP and TEMP (our runnable
    # system shards Adam over the data axis); Megatron-1/3 baselines keep
    # optimizer states within the model-parallel shard only (paper Fig. 4c).
    zero = fsdp or deg.tatp > 1
    w_shard = deg.tp * deg.tatp * (n_dies if fsdp else 1)
    w_bytes = BYTES_W * p_total / min(w_shard, n_dies)
    g_bytes = BYTES_W * p_total / min(w_shard, n_dies)
    opt_shard = min(w_shard * (deg.dp if zero else 1), n_dies)
    opt_bytes = BYTES_OPT * p_total / opt_shard
    act_tokens = tokens / (deg.dp * deg.sp * deg.tatp)
    act_unit = ACT_COEFF * act_tokens * cfg.d_model * BYTES_ACT * n_l
    if deg.tp > 1 and not deg.seq_par:
        # Megatron-1: boundary activations replicated across TP (Fig. 4a/4c)
        act_full = act_unit * (0.3 + 0.7 / deg.tp)
    else:
        act_full = act_unit / deg.tp
    # FSDP gathers one layer's full weights transiently
    transient = BYTES_W * p_layer if fsdp else 0.0
    fixed = w_bytes + g_bytes + opt_bytes + transient
    # gradient-accumulation micro-batching shrinks live activations
    seqs_per_die = max(1, int(batch // deg.dp))
    n_micro = 1
    while fixed + act_full / n_micro > spec.hbm_cap \
            and n_micro < seqs_per_die:
        n_micro *= 2
    act_bytes = act_full / n_micro
    mem = fixed + act_bytes
    oom = mem > spec.hbm_cap

    # ---------------- compute ---------------------------------------------
    # 6·P·tokens for matmuls (+ attention quadratic term), backward incl.
    attn_flops = 12 * tokens * seq * cfg.d_model  # scores+context, causal/2×3
    layer_flops = 6 * p_active * tokens + attn_flops
    model_shard = deg.tp * deg.sp * deg.tatp * deg.dp
    comp_layer = layer_flops / (model_shard * spec.flops * spec.gemm_eff)

    # ---------------- communication ---------------------------------------
    # activation tensor of one layer within a model-parallel group
    act_group_bytes = (tokens / (deg.dp * deg.sp)) * cfg.d_model * BYTES_ACT
    ops_overlap: list[CommOp] = []  # P2P streams (overlap with compute)
    ops_exposed: list[CommOp] = []  # collectives (exposed)

    # TATP streams (3 stages: fwd, dgrad, wgrad) — selective transfer.
    w_stream = BYTES_W * p_active / deg.tp  # whole layer's weights
    a_stream = act_group_bytes / deg.tp  # whole group input instead
    if deg.tatp > 1:
        per_link = min(w_stream, a_stream) if stream == "auto" else (
            w_stream if stream == "weights" else a_stream)
        link_share = per_link * 3 * (deg.tatp - 1) / deg.tatp \
            * (0.5 if tatp_bidirectional else 1.0)
        for g in tatp_groups:
            ops_overlap.append(CommOp("p2p_ring", g, link_share, tag="tatp",
                                      chunk_bytes=per_link / deg.tatp))
    # sp as a context/sequence partition: ring KV exchange (overlapped)
    if deg.sp > 1 and not deg.seq_par:
        kv_bytes = (tokens / (deg.dp * deg.sp * deg.tatp)) \
            * 2 * cfg.kv_dim * BYTES_ACT if cfg.n_kv_heads else 0.0
        for g in groups.get("sp", []):
            ops_overlap.append(CommOp("p2p_ring", g,
                                      kv_bytes * max(deg.sp - 1, 1),
                                      tag="cp_kv"))

    # TP all-reduces (2 fwd + 2 bwd per layer) — or Megatron-3 SP:
    # all-gather + reduce-scatter pairs of the same payload
    if deg.tp > 1:
        for g in groups.get("tp", []):
            if deg.seq_par:
                ops_exposed.append(CommOp("allgather", g,
                                          2 * act_group_bytes, tag="sp_ag"))
                ops_exposed.append(CommOp("reducescatter", g,
                                          2 * act_group_bytes, tag="sp_rs"))
            else:
                ops_exposed.append(CommOp("allreduce", g,
                                          4 * act_group_bytes, tag="tp_ar"))
    # FSDP: per-layer full-weight all-gather (fwd + re-gather in bwd) and a
    # gradient reduce-scatter — coarse-grained collectives (paper §VIII-B)
    if fsdp:
        full_layer = BYTES_W * p_layer
        for g in groups.get("dp", []):
            ops_exposed.append(CommOp("allgather", g, 2 * full_layer,
                                      tag="fsdp_ag"))
            ops_exposed.append(CommOp("reducescatter", g, full_layer,
                                      tag="fsdp_rs"))

    # run TCME's optimizer for the tcme engine
    tcme_report = None
    all_ops = ops_overlap + ops_exposed
    if engine == "tcme" and run_tcme_optimizer and all_ops:
        tcme_report = wtcme.optimize_phase(all_ops, wafer)

    # contention factor: bottleneck link load vs a single ring's own share
    contention = 1.0
    if all_ops:
        loads = link_loads(all_ops, wafer)
        if loads and ops_overlap:
            own = max(op.pair_bytes() for op in ops_overlap)
            if own > 0:
                contention = max(1.0, max(loads.values()) / own)

    # overlapped stream time (serial rounds, granularity, tail latency)
    t_p2p = 0.0
    if deg.tatp > 1:
        sel = min(w_stream, a_stream) if stream == "auto" else (
            w_stream if stream == "weights" else a_stream)
        t_p2p = ring_stream_time(
            sel, deg.tatp, spec, bidirectional=tatp_bidirectional,
            hops=hop_factor, stages=3, contention=contention)
    if deg.sp > 1 and not deg.seq_par:
        kv_bytes = (tokens / (deg.dp * deg.sp * deg.tatp)) \
            * 2 * cfg.kv_dim * BYTES_ACT if cfg.n_kv_heads else 0.0
        sp_hops = max((max_ring_hops(g, wafer, wrap=False)
                       for g in groups.get("sp", [])), default=1)
        t_p2p += ring_stream_time(kv_bytes * deg.sp, deg.sp, spec,
                                  bidirectional=tatp_bidirectional,
                                  hops=max(1, sp_hops), stages=3,
                                  contention=contention)

    t_coll = phase_time(ops_exposed, wafer)

    # per-round orchestration overhead (sequential dependency, not hidden)
    t_sched = 0.0
    if deg.tatp > 1:
        rounds = (deg.tatp + 1) // 2 if tatp_bidirectional else deg.tatp - 1
        t_sched = 3 * rounds * T_DISPATCH

    # Eq. 2 per layer
    t_layer = t_coll + max(comp_layer, t_p2p) + t_sched

    # DP gradient all-reduce once per step (50% overlapped with backward)
    t_dp = 0.0
    if deg.dp > 1 and not fsdp:
        dp_ops = [CommOp("allreduce", g,
                         BYTES_W * p_total / (deg.tp * deg.tatp), tag="dp_ar")
                  for g in groups.get("dp", [])]
        if engine == "tcme" and run_tcme_optimizer:
            wtcme.optimize_phase(dp_ops, wafer)
        t_dp = 0.5 * phase_time(dp_ops, wafer)

    # embedding/head compute
    head_flops = 6 * tokens * cfg.d_model * cfg.vocab_size
    t_head = head_flops / (model_shard * spec.flops * spec.gemm_eff)

    step = n_l * t_layer + t_dp + t_head
    thr = tokens / step

    # ---------------- power (Table I energies) -----------------------------
    e_comp = (n_l * layer_flops + head_flops) * spec.e_flop
    hbm_bytes = n_l * (4 * BYTES_W * p_active + 6
                       * tokens * cfg.d_model * BYTES_ACT)
    e_hbm = hbm_bytes * spec.e_hbm
    d2d_bytes = 0.0
    for op in all_ops:
        d2d_bytes += op.pair_bytes() * len(op.group) * n_l
    if deg.dp > 1 and not fsdp:
        d2d_bytes += 2 * BYTES_W * p_total / (deg.tp * deg.tatp) * deg.dp
    e_d2d = d2d_bytes * spec.e_d2d
    # static (leakage/clock) floor: dies draw ~half their dynamic budget
    # while stalled on exposed communication
    e_static = 450.0 * n_dies * step
    energy = e_comp + e_hbm + e_d2d + e_static
    power = energy / step
    bw_cap = n_dies * 4 * spec.link_bw
    bw_util = min(1.0, d2d_bytes / step / bw_cap)

    return SimResult(
        step_time=step,
        throughput=thr,
        mem_per_die=mem,
        oom=oom,
        power=power,
        power_eff=thr / power if power > 0 else 0.0,
        bw_util=bw_util,
        breakdown={
            "comp_layer": comp_layer,
            "p2p_layer": t_p2p,
            "coll_layer": t_coll,
            "dp_exposed": t_dp,
            "head": t_head,
            "n_micro": n_micro,
            "hop_factor": hop_factor,
            "collective_frac": (n_l * t_coll + t_dp) / step,
            "e_comp": e_comp, "e_hbm": e_hbm, "e_d2d": e_d2d,
            "tcme": (tcme_report.improvement if tcme_report else 1.0),
        },
        degrees=deg,
        engine=engine,
    )


def memory_components(ctx: StepCostContext,
                      deg: ParallelDegrees) -> tuple[float, float, int]:
    """``(fixed_bytes, act_full_bytes, seqs_per_die)`` for one candidate —
    a scalar mirror of the engine's memory model (``fixed + act_full /
    n_micro == mem_per_die``, pinned by tests/test_solver_fast.py).

    The multi-wafer pipeline level needs the split because pipeline
    microbatching changes only the *activation* term: a stage holding
    ``k`` in-flight microbatches out of ``n_micro`` keeps
    ``fixed + act_full · k / n_micro`` bytes per die (GPipe k = n_micro,
    1F1B k = min(pp − s, n_micro)).
    """
    cfg, spec, n_dies = ctx.cfg, ctx.spec, ctx.n_dies
    zero = ctx.fsdp or deg.tatp > 1
    w_shard = deg.tp * deg.tatp * (n_dies if ctx.fsdp else 1)
    w_bytes = BYTES_W * ctx.p_total / min(w_shard, n_dies)
    g_bytes = BYTES_W * ctx.p_total / min(w_shard, n_dies)
    opt_shard = min(w_shard * (deg.dp if zero else 1), n_dies)
    opt_bytes = BYTES_OPT * ctx.p_total / opt_shard
    act_tokens = ctx.tokens / (deg.dp * deg.sp * deg.tatp)
    act_unit = ACT_COEFF * act_tokens * cfg.d_model * BYTES_ACT * ctx.n_l
    if deg.tp > 1 and not deg.seq_par:
        act_full = act_unit * (0.3 + 0.7 / deg.tp)
    else:
        act_full = act_unit / deg.tp
    transient = BYTES_W * ctx.p_layer if ctx.fsdp else 0.0
    fixed = w_bytes + g_bytes + opt_bytes + transient
    seqs_per_die = max(1, int(ctx.batch // deg.dp))
    return fixed, act_full, seqs_per_die


# ---------------------------------------------------------------------------
# decode objective: one continuous-batching decode iteration
# ---------------------------------------------------------------------------

# GEMV/attention arithmetic efficiency during decode: single-token matmuls
# run far below the training GEMM efficiency (the workload is
# memory-bandwidth-bound; this floor only matters for very large in-flight
# batches where decode tips back to compute)
DECODE_GEMV_EFF = 0.25
# per-token workspace: a handful of d_model-wide activation buffers per
# in-flight sequence (q/k/v/o + mlp transients)
DECODE_WS_COEFF = 8


def _decode_kv_divisors(cfg: ModelConfig, dp, tp, sp, ta):
    """(kv_div, state_div): how many ways the per-sequence decode cache
    shards under a degree tuple.

    Attention KV shards over heads only up to ``n_kv_heads`` (GQA
    replicates past that), over the sequence dim via sp, around the TATP
    ring via tatp, and over the batch via dp.  SSM state has no sequence
    dim — sp replicates it — but its d_inner axis splits fully over tp.
    """
    kv_heads = max(cfg.n_kv_heads, 1)
    kv_div = dp * sp * ta * np.minimum(tp, kv_heads)
    state_div = dp * ta * tp
    return kv_div, state_div


def decode_memory_components(ctx: StepCostContext, deg: ParallelDegrees) \
        -> tuple[float, float, float]:
    """``(weight_bytes, cache_bytes, workspace_bytes)`` per die for one
    candidate at the context's full KV budget (``batch`` in-flight
    sequences × ``seq`` context tokens).

    Inference holds no gradients and no optimizer state: the fixed term is
    the weight shard alone (dp replicas each keep a full copy of their
    model shard), and the variable term is the decode cache priced through
    :meth:`repro_torch.configs.base.ModelConfig.cache_bytes_per_seq` — the same
    function the serve engine's admission uses, so plan-time budgets and
    runtime occupancy agree byte-for-byte.
    """
    cfg, n_dies = ctx.cfg, ctx.n_dies
    if deg.ep > 1:
        # EP shards only the expert tensors (scalar twin of the batched
        # np.where(ep > 1, ...) select — same ops, same order)
        w_bytes = (BYTES_W * ctx.p_dense_total
                   / min(deg.tp * deg.tatp, n_dies)
                   + BYTES_W * ctx.p_expert_total
                   / min(deg.tp * deg.tatp * deg.ep, n_dies))
    else:
        w_bytes = BYTES_W * ctx.p_total / min(deg.tp * deg.tatp, n_dies)
    kv_div, state_div = _decode_kv_divisors(
        cfg, deg.dp, deg.tp, deg.sp, deg.tatp)
    kv_ctx = ctx.kv_seq_bytes - ctx.state_seq_bytes  # ctx-length-dependent
    cache = ctx.batch * (kv_ctx / kv_div
                         + ctx.state_seq_bytes / state_div)
    ws = (ctx.batch / deg.dp) * cfg.d_model * BYTES_ACT * DECODE_WS_COEFF
    return w_bytes, float(cache), float(ws)


def _decode_ring_hops(ctx: StepCostContext, deg: ParallelDegrees) \
        -> tuple[int, int]:
    """(tatp ring hop factor, sp ring hop factor) for one candidate —
    the same wafer-cached group structures the training path uses, so
    degraded wafers (holes, detours) stretch decode rings identically."""
    groups = ctx.groups_for(deg)
    ta_h = _tatp_hop_factor(groups.get("tatp", []), ctx.wafer,
                            ctx.tatp_bidirectional) if deg.tatp > 1 else 1
    sp_h = _sp_hop_factor(groups.get("sp", []), ctx.wafer) \
        if deg.sp > 1 else 1
    return ta_h, sp_h


def _decode_expert_placement(ctx: StepCostContext, deg: ParallelDegrees):
    """Memoized topology-aware expert placement for one EP decode
    candidate.  The choice is pure topology (degrees + engine + wafer),
    so it is shared across contexts on the wafer like the group
    structures; degraded wafers re-key naturally (fault edits clear the
    wafer caches)."""
    from repro_torch.wafer.placement import choose_expert_placement
    wkey = ("_eplace", deg.key, ctx.engine)
    got = ctx.wafer._groups_cache.get(wkey) \
        if ctx.wafer.cache_enabled else None
    if got is None:
        groups = ctx.groups_for(deg)
        got = choose_expert_placement(ctx.wafer, groups["dp"],
                                      deg.dp, deg.ep)
        if ctx.wafer.cache_enabled:
            ctx.wafer._groups_cache[wkey] = got
    return got


def _decode_scalars(ctx: StepCostContext, dev: torch.device) -> dict:
    """Context-invariant decode scalars, each the value the numpy tier
    divides by or into (its Python-int products and the scalar-only
    quotient ``kv_ctx / n_l`` folded on the host first, as numpy folds
    them)."""
    cfg, spec = ctx.cfg, ctx.spec
    kv_ctx = ctx.kv_seq_bytes - ctx.state_seq_bytes
    return _commit_scalars(dev, dict(
        B=ctx.batch, w_total=BYTES_W * ctx.p_total,
        w_dense=BYTES_W * ctx.p_dense_total,
        w_expert=BYTES_W * ctx.p_expert_total,
        w_active=BYTES_W * ctx.p_active,
        w_active_dense=BYTES_W * ctx.p_active_dense,
        p2_active=2 * ctx.p_active, kv_ctx=kv_ctx,
        kv_ctx_layer=kv_ctx / ctx.n_l, state_seq=ctx.state_seq_bytes,
        gemv_flops=spec.flops * DECODE_GEMV_EFF, hbm_bw=spec.hbm_bw,
        head_bytes=BYTES_W * cfg.d_model * cfg.vocab_size,
        dec_head_flops=ctx.dec_head_flops))


def _decode_torch_eval(ctx: StepCostContext, deg: tuple, hops: tuple,
                       sc: dict) -> torch.Tensor:
    """The decode objective's device half over device degree columns
    (int64 ``dp, tp, sp, ta, ep``) and hop / expert-read columns
    (float64): :func:`simulate_decode_batch`'s numpy arithmetic op for op
    (the reference's ``_decode_jax_fn`` body).  Returns the (11, nC) rows
    its host epilogue reads."""
    cfg, spec = ctx.cfg, ctx.spec
    n_dies, n_l = ctx.n_dies, ctx.n_l
    dp, tp, sp, ta, ep = deg
    ta_hops, sp_hops, eff = hops
    dpf, tpf, spf, taf, epf = _f64(dp, tp, sp, ta, ep)
    tok = sc["B"] / dpf

    # memory (EP shards only the expert tensors; ep == 1 keeps the
    # pre-EP expression)
    w_bytes = torch.where(
        ep > 1,
        sc["w_dense"] / torch.clamp(tpf * taf, max=n_dies)
        + sc["w_expert"] / torch.clamp(tpf * taf * epf, max=n_dies),
        sc["w_total"] / torch.clamp(tpf * taf, max=n_dies))
    kv_div = dpf * spf * taf * torch.clamp(tpf, max=max(cfg.n_kv_heads, 1))
    state_div = dpf * taf * tpf
    cache_bytes = ctx.batch * (sc["kv_ctx"] / kv_div
                               + sc["state_seq"] / state_div)
    ws = tok * cfg.d_model * BYTES_ACT * DECODE_WS_COEFF
    mem = w_bytes + cache_bytes + ws
    oom = mem > spec.hbm_cap

    # per-layer compute / HBM
    lin_flops = sc["p2_active"] * tok / (tpf * taf)
    attn_flops = 4 * ctx.seq * cfg.d_model * tok / (tpf * spf * taf)
    t_flops = (lin_flops + attn_flops) / sc["gemv_flops"]
    if cfg.is_moe:
        w_read = sc["w_active_dense"] / (tpf * taf) \
            + sc["w_expert"] * eff / (tpf * taf)
    else:
        w_read = sc["w_active"] / (tpf * taf)
    kv_read = tok * sc["kv_ctx_layer"] / (kv_div / dpf)
    t_hbm = (w_read + kv_read) / sc["hbm_bw"]
    t_comp = torch.maximum(t_flops, t_hbm)

    q_bytes = tok * cfg.d_model * BYTES_ACT
    head_read = sc["head_bytes"] / (tpf * taf)
    t_head = torch.maximum(
        sc["dec_head_flops"] * tok / (tpf * taf) / sc["gemv_flops"],
        head_read / sc["hbm_bw"])
    hbm_step = (w_read + kv_read) * n_l * dpf \
        * torch.clamp(tpf * taf, max=n_dies)
    d2d_step = n_l * (q_bytes * (spf - 1) * sp_hops
                      + q_bytes * (taf - 1) * ta_hops
                      + torch.where(tp > 1, 4 * q_bytes * (tpf - 1),
                                    0.0)) * dpf
    # t_ring / t_coll, the latency fold and the power / ratio tail are
    # finished on the host; q_bytes goes back so the host's ring and
    # all-reduce chains round from the same value
    return torch.stack([mem, oom.to(torch.float64), t_comp, t_hbm, t_head,
                        w_bytes, cache_bytes, kv_read, hbm_step, d2d_step,
                        q_bytes])


def _decode_torch(ctx: StepCostContext, dkey: tuple, arrs: tuple,
                  hkey: tuple, ta_hops: np.ndarray, sp_hops: np.ndarray,
                  eff: np.ndarray) -> np.ndarray:
    """Run the decode objective's device half on the context's torch tier
    over one candidate list; the (11, nC) component matrix."""
    dev = _tier_device(ctx.tierb)
    key = (dkey, str(dev))
    deg = _DEGREE_ARRAYS_TORCH.get(key)
    if deg is None:
        # (dp, tp, sp, ta, ep) — seq_par (arrs[4]) plays no decode role
        deg = tuple(torch.from_numpy(a).to(dev)
                    for a in arrs[:4] + (arrs[5],))
        if len(_DEGREE_ARRAYS_TORCH) >= _DEGREE_ARRAYS_CAP:
            _DEGREE_ARRAYS_TORCH.clear()
        _DEGREE_ARRAYS_TORCH[key] = deg
    tkey = ("_torch", str(dev)) + hkey
    hops = ctx.wafer._groups_cache.get(tkey) \
        if ctx.wafer.cache_enabled else None
    if hops is None:
        # eff is keyed by hkey too (it folds B, dp, ep, top_k, n_experts)
        hops = tuple(torch.from_numpy(a).to(dev)
                     for a in (ta_hops, sp_hops, eff))
        if ctx.wafer.cache_enabled:
            ctx.wafer._groups_cache[tkey] = hops
    sc = getattr(ctx, "_dec_sc", None)
    if sc is None:
        sc = ctx._dec_sc = _decode_scalars(ctx, dev)
    TIER_CALLS["decode"] += 1
    return _decode_torch_eval(ctx, deg, hops, sc).cpu().numpy()


# per-expert micro-batch dispatch overhead (s): every *distinct* expert a
# replica activates in a layer is a separately launched sliced GEMV
# (gather → tile GEMM → scatter bookkeeping on the dataflow fabric) — the
# tiny-tile tax MoEntwine measures on wafer-scale meshes.  EP's whole
# latency case is shrinking the resident pool this serializes over.
T_EXPERT_DISPATCH = 0.5e-6


def _decode_a2a_epilogue(ctx: StepCostContext, dp, ep, q_bytes, eff,
                         a2a_load, a2a_hops):
    """``(t_a2a, d2d_a2a, t_moe)``: per-layer dispatch+combine all-to-all
    time, its per-step D2D byte·hop volume, and the per-layer expert
    micro-batch dispatch overhead.

    Host-side numpy for *both* Tier-B backends (the torch twin exports
    ``q_bytes``; candidate-sized epilogues stay on the pinned numpy
    path), so the two call sites are bitwise-identical by construction.
    Per ordered pair of an a2a set a replica ships ``tok·top_k/ep`` token activations (balanced routing);
    the bottleneck link carries ``a2a_load`` such pair flows.  Decode
    messages are latency-bound like the ring-KV stream, so no
    granularity ramp applies; the ×2 is dispatch + combine.  ``ep == 1``
    rows contribute exact ``0.0`` a2a (adding it preserves the pre-EP
    bits); ``t_moe`` serializes the ``eff·n_experts`` distinct experts a
    replica activates per layer and is exact ``0.0`` for dense configs.
    """
    spec = ctx.spec
    pair_bytes = q_bytes * ctx.cfg.top_k / ep
    t_a2a = np.where(ep > 1,
                     2 * (pair_bytes * a2a_load / spec.link_bw
                          + a2a_hops * spec.hop_latency), 0.0)
    d2d_a2a = np.where(ep > 1,
                       ctx.n_l * (2 * pair_bytes * (ep - 1) * a2a_hops)
                       * dp, 0.0)
    if ctx.cfg.is_moe:
        t_moe = eff * (ctx.cfg.n_experts * T_EXPERT_DISPATCH)
    else:
        t_moe = np.zeros_like(t_a2a)
    return t_a2a, d2d_a2a, t_moe


def simulate_decode_batch(ctx: StepCostContext,
                          degrees: list[ParallelDegrees], *,
                          final: bool = False) -> list[SimResult]:
    """Score one continuous-batching decode iteration for a batch of
    candidate degree tuples (the decode twin of :func:`simulate_batch`).

    The returned :class:`SimResult` reuses the training field contract so
    the DLWS machinery runs unchanged — ``step_time`` is the per-token
    iteration latency (every in-flight sequence gains one token per
    iteration), ``throughput`` is decode tokens/s across the wafer, and
    ``mem_per_die`` includes the full-budget KV cache.

    Cost structure per layer::

        t_layer = t_coll + max(t_comp, t_ring) + t_sched

    * ``t_comp`` — max of GEMV flop time and the HBM time to read the
      weight shard once per iteration (amortized over the whole in-flight
      batch: the term that makes continuous batching pay) plus the KV
      scan of every active sequence.
    * ``t_ring`` — the ring-KV stream: per-token query/partial blocks
      circulating the sp and tatp rings.  Decode messages are tiny and
      latency-bound, so hops are priced at ``bytes/link_bw +
      hop_latency`` — the sustained-stream granularity ramp
      (``spec.bw_eff``) models DMA efficiency of tens-of-MB training
      streams and would overcharge a KB-scale decode hop by ~100×.
    * ``t_coll`` — exposed TP all-reduces of the token activations
      (2/layer, ring algorithm: ``2(tp-1)`` latency-bound hops each).

    Weight streaming (the training TATP trade) is deliberately absent:
    re-streaming weights every generated token can never win, so the
    decode TATP axis is modeled as a cache-ring split — WaferLLM's
    inference regime, where the partition trade-offs genuinely differ
    from the training solve.
    """
    if not degrees:
        return []
    cfg, spec = ctx.cfg, ctx.spec
    n_dies = ctx.n_dies
    nC = len(degrees)

    dkey = tuple(d.key for d in degrees)
    arrs = _degree_columns(degrees)
    dp, tp, sp, ta, _seq_par, ep = arrs
    B, S = ctx.batch, ctx.seq
    # decode feasibility: the die product must fit, tp cannot split more
    # query heads than the model has, and dp cannot exceed (or unevenly
    # split) the in-flight batch — each dp replica serves whole sequences,
    # so dp > B would emit an unexecutable mesh that the fractional
    # tok = B/dp arithmetic also underprices
    feasible = (dp * tp * sp * ta <= n_dies) \
        & (tp <= max(cfg.n_heads, 1)) \
        & (dp <= B) & (B % dp == 0)
    # expert parallelism is decode+MoE only: each of the ep expert groups
    # hosts n_experts/ep experts and dp/ep whole replicas, so both
    # divisibilities must hold (dense models admit only ep == 1)
    if cfg.is_moe:
        ep_ok = (ep == 1) | ((cfg.n_experts % ep == 0) & (dp % ep == 0))
    else:
        ep_ok = ep == 1
    feasible = feasible & ep_ok

    # ---------------- ring hop factors (wafer-cached) ----------------------
    # keyed on everything the feasibility gate depends on (candidate
    # identity, die budget, batch, head count, expert count): hops are
    # only computed for feasible candidates, since groups_for can fail on
    # infeasible ones
    hkey = ("_dechops", dkey, ctx.engine, ctx.tatp_bidirectional,
            B, n_dies, cfg.n_heads,
            (cfg.n_experts, cfg.top_k) if cfg.is_moe else (0, 0))
    hops = ctx.wafer._groups_cache.get(hkey) \
        if ctx.wafer.cache_enabled else None
    if hops is None:
        ta_hops = np.ones(nC)
        sp_hops = np.ones(nC)
        a2a_load = np.zeros(nC)
        a2a_hops = np.zeros(nC)
        need = np.nonzero(feasible & ((ta > 1) | (sp > 1)))[0]
        for i in need:
            ta_hops[i], sp_hops[i] = _decode_ring_hops(ctx, degrees[i])
        # dispatch/combine congestion of EP candidates: bottleneck link
        # multiplicity + path lengths of the chosen expert placement
        for i in np.nonzero(feasible & (ep > 1))[0]:
            pl = _decode_expert_placement(ctx, degrees[i])
            a2a_load[i] = pl.a2a_load
            a2a_hops[i] = pl.a2a_hops
        if ctx.wafer.cache_enabled:
            ctx.wafer._groups_cache[hkey] = (ta_hops, sp_hops,
                                             a2a_load, a2a_hops)
    else:
        ta_hops, sp_hops, a2a_load, a2a_hops = hops

    # expected distinct-expert read fraction per replica: tok·top_k
    # routing draws over the replica's n_experts/ep expert pool —
    # ``eff·p_expert_total`` is the expert weight volume each iteration
    # actually pulls from HBM.  Saturates at 1/ep for large batches (the
    # whole resident shard), and at tok·top_k/n_experts for small ones;
    # shrinking the per-replica pool is exactly why EP pays during
    # decode.  Computed host-side for both Tier-B backends (pow is
    # transcendental — XLA's expansion may differ from libm in ULP).
    if cfg.is_moe:
        eff = (1.0 - np.power(np.maximum(0.0, 1.0 - ep / cfg.n_experts),
                              (B / dp) * cfg.top_k)) / ep
    else:
        eff = np.ones(nC)

    # fused torch decode twin: search evaluations only — the final
    # (recorded) evaluation stays on the anchored numpy path, so ServePlan
    # numbers and plan hashes are backend-invariant by construction
    dec = None
    if ctx.tierb != "numpy" and nC >= _TIER_MIN_BATCH and not final:
        dec = _decode_torch(ctx, dkey, arrs, hkey, ta_hops, sp_hops, eff)
    if dec is not None:
        (mem, oomf, t_comp, t_hbm, t_head,
         w_bytes, cache_bytes, kv_read, hbm_step, d2d_step,
         q_bytes) = dec
        oom = oomf != 0.0
        # ring / all-reduce chains + latency fold + power epilogue in
        # numpy, op-for-op the numpy tier's
        t_ring = (sp - 1) * (q_bytes / spec.link_bw
                             + sp_hops * spec.hop_latency) \
            + (ta - 1) * (q_bytes / spec.link_bw
                          + ta_hops * spec.hop_latency)
        ar_bytes = 2 * q_bytes / np.maximum(tp, 1)
        t_coll = np.where(tp > 1,
                          2 * 2 * (tp - 1) * (ar_bytes / spec.link_bw
                                              + spec.hop_latency), 0.0)
        t_sched = np.where(ta > 1, (ta + 1) // 2 * T_DISPATCH, 0.0) \
            + np.where(sp > 1, T_DISPATCH, 0.0)
        t_a2a, d2d_a2a, t_moe = _decode_a2a_epilogue(ctx, dp, ep, q_bytes,
                                                     eff, a2a_load,
                                                     a2a_hops)
        t_layer = t_coll + np.maximum(t_comp, t_ring) + t_sched \
            + t_moe + t_a2a
        lat = ctx.n_l * t_layer + t_head
        thr = B / lat
        flops_step = (ctx.dec_layer_flops * ctx.n_l
                      + ctx.dec_head_flops) * B
        d2d_step = d2d_step + d2d_a2a
        energy = flops_step * spec.e_flop + hbm_step * spec.e_hbm \
            + d2d_step * spec.e_d2d + 450.0 * n_dies * lat
        power = energy / lat
        bw_cap = n_dies * 4 * spec.link_bw
        bw_util = np.minimum(1.0, d2d_step / lat / bw_cap)
    else:
        tok = B / dp  # tokens computed per dp replica per iteration

        # ------------- memory (vectorized decode_memory_components) -------
        # EP splits the weight shard: dense tensors over tp·ta, expert
        # tensors additionally over ep.  The ep == 1 operand is the
        # pre-EP expression unchanged (bitwise-pinned baselines)
        w_bytes = np.where(
            ep > 1,
            BYTES_W * ctx.p_dense_total / np.minimum(tp * ta, n_dies)
            + BYTES_W * ctx.p_expert_total
            / np.minimum(tp * ta * ep, n_dies),
            BYTES_W * ctx.p_total / np.minimum(tp * ta, n_dies))
        kv_div, state_div = _decode_kv_divisors(cfg, dp, tp, sp, ta)
        kv_ctx = ctx.kv_seq_bytes - ctx.state_seq_bytes
        cache_bytes = B * (kv_ctx / kv_div
                           + ctx.state_seq_bytes / state_div)
        ws = tok * cfg.d_model * BYTES_ACT * DECODE_WS_COEFF
        mem = w_bytes + cache_bytes + ws
        oom = mem > spec.hbm_cap

        # ------------- per-layer compute / HBM -----------------------------
        lin_flops = 2 * ctx.p_active * tok / (tp * ta)
        attn_flops = 4 * S * cfg.d_model * tok / (tp * sp * ta)
        t_flops = (lin_flops + attn_flops) / (spec.flops * DECODE_GEMV_EFF)
        # MoE weight read: dense tensors once per iteration (shared by
        # the whole in-flight batch) + the expected distinct expert
        # slice (``eff``) — mirrors the jitted kernel's select
        if cfg.is_moe:
            w_read = BYTES_W * ctx.p_active_dense / (tp * ta) \
                + BYTES_W * ctx.p_expert_total * eff / (tp * ta)
        else:
            w_read = BYTES_W * ctx.p_active / (tp * ta)
        kv_read = tok * (kv_ctx / ctx.n_l) / (kv_div / dp)  # KV scan
        t_hbm = (w_read + kv_read) / spec.hbm_bw
        t_comp = np.maximum(t_flops, t_hbm)

        # ------------- ring-KV stream + TP collectives ---------------------
        q_bytes = tok * cfg.d_model * BYTES_ACT  # query + partial block
        t_ring = (sp - 1) * (q_bytes / spec.link_bw
                             + sp_hops * spec.hop_latency) \
            + (ta - 1) * (q_bytes / spec.link_bw
                          + ta_hops * spec.hop_latency)
        ar_bytes = 2 * q_bytes / np.maximum(tp, 1)  # ring all-reduce chunk
        t_coll = np.where(tp > 1,
                          2 * 2 * (tp - 1) * (ar_bytes / spec.link_bw
                                              + spec.hop_latency), 0.0)
        t_sched = np.where(ta > 1, (ta + 1) // 2 * T_DISPATCH, 0.0) \
            + np.where(sp > 1, T_DISPATCH, 0.0)

        # ------------- EP dispatch/combine all-to-all ----------------------
        t_a2a, d2d_a2a, t_moe = _decode_a2a_epilogue(ctx, dp, ep, q_bytes,
                                                     eff, a2a_load,
                                                     a2a_hops)

        # ------------- per-token latency / throughput ----------------------
        t_layer = t_coll + np.maximum(t_comp, t_ring) + t_sched \
            + t_moe + t_a2a
        head_read = BYTES_W * cfg.d_model * cfg.vocab_size / (tp * ta)
        t_head = np.maximum(ctx.dec_head_flops * tok / (tp * ta)
                            / (spec.flops * DECODE_GEMV_EFF),
                            head_read / spec.hbm_bw)
        lat = ctx.n_l * t_layer + t_head
        thr = B / lat

        # ------------- power -----------------------------------------------
        flops_step = (ctx.dec_layer_flops * ctx.n_l
                      + ctx.dec_head_flops) * B
        hbm_step = (w_read + kv_read) * ctx.n_l * dp \
            * np.minimum(tp * ta, n_dies)
        d2d_step = ctx.n_l * (q_bytes * (sp - 1) * sp_hops
                              + q_bytes * (ta - 1) * ta_hops
                              + np.where(tp > 1, 4 * q_bytes * (tp - 1),
                                         0.0)) * dp
        d2d_step = d2d_step + d2d_a2a
        energy = flops_step * spec.e_flop + hbm_step * spec.e_hbm \
            + d2d_step * spec.e_d2d + 450.0 * n_dies * lat
        power = energy / lat
        bw_cap = n_dies * 4 * spec.link_bw
        bw_util = np.minimum(1.0, d2d_step / lat / bw_cap)

    out: list[SimResult] = []
    for i, deg in enumerate(degrees):
        if not feasible[i]:
            if tp[i] > max(cfg.n_heads, 1):
                reason = "tp exceeds heads"
            elif dp[i] > B or B % dp[i]:
                reason = "dp does not divide batch"
            elif not ep_ok[i]:
                reason = "ep illegal for config"
            else:
                reason = "degree exceeds dies"
            out.append(SimResult(math.inf, 0.0, math.inf, True, 0.0, 0.0,
                                 0.0, {"objective": "decode",
                                       "reason": reason},
                                 deg, ctx.engine))
            continue
        out.append(SimResult(
            step_time=float(lat[i]),
            throughput=float(thr[i]),
            mem_per_die=float(mem[i]),
            oom=bool(oom[i]),
            power=float(power[i]),
            power_eff=float(thr[i] / power[i]) if power[i] > 0 else 0.0,
            bw_util=float(bw_util[i]),
            breakdown={
                "objective": "decode",
                "t_comp_layer": float(t_comp[i]),
                "t_hbm_layer": float(t_hbm[i]),
                "t_ring_layer": float(t_ring[i]),
                "t_coll_layer": float(t_coll[i]),
                "t_head": float(t_head[i]),
                "w_bytes": float(w_bytes[i]),
                "cache_bytes": float(cache_bytes[i]),
                "kv_read_per_iter": float(kv_read[i]),
                "ta_hops": int(ta_hops[i]),
                "sp_hops": int(sp_hops[i]),
                "ep": int(ep[i]),
                "t_a2a_layer": float(t_a2a[i]),
                "a2a_load": int(a2a_load[i]),
                "a2a_hops": int(a2a_hops[i]),
                "expert_read_frac": float(eff[i]),
                "t_moe_disp_layer": float(t_moe[i]),
            },
            degrees=deg,
            engine=ctx.engine,
        ))
    return out


def _decode_reference_ctx(ctx: StepCostContext,
                          deg: ParallelDegrees) -> SimResult:
    """Scalar replay of one :func:`simulate_decode_batch` candidate —
    plain Python floats, one value at a time, in the exact operation
    order of the vectorized numpy tier.  IEEE-754 scalar arithmetic is
    bitwise-identical to numpy's float64 elementwise kernels, so this is
    the decode objective's permanent anchor the same way
    :func:`simulate_step_reference` anchors the training objective
    (tests assert equality against both Tier-B backends)."""
    cfg, spec = ctx.cfg, ctx.spec
    n_dies = ctx.n_dies
    dp, tp, sp, ta, ep = deg.dp, deg.tp, deg.sp, deg.tatp, deg.ep
    B, S = ctx.batch, ctx.seq
    ep_legal = ep == 1 or (cfg.is_moe and cfg.n_experts % ep == 0
                           and dp % ep == 0)
    feasible = (dp * tp * sp * ta <= n_dies
                and tp <= max(cfg.n_heads, 1)
                and dp <= B and B % dp == 0 and ep_legal)
    if not feasible:
        if tp > max(cfg.n_heads, 1):
            reason = "tp exceeds heads"
        elif dp > B or B % dp:
            reason = "dp does not divide batch"
        elif not ep_legal:
            reason = "ep illegal for config"
        else:
            reason = "degree exceeds dies"
        return SimResult(math.inf, 0.0, math.inf, True, 0.0, 0.0, 0.0,
                         {"objective": "decode", "reason": reason},
                         deg, ctx.engine)
    ta_hops = sp_hops = 1.0
    if ta > 1 or sp > 1:
        th, sh = _decode_ring_hops(ctx, deg)
        ta_hops, sp_hops = float(th), float(sh)
    a2a_load = a2a_hops = 0.0
    if ep > 1:
        pl = _decode_expert_placement(ctx, deg)
        a2a_load, a2a_hops = float(pl.a2a_load), float(pl.a2a_hops)
    if cfg.is_moe:
        eff = (1.0 - max(0.0, 1.0 - ep / cfg.n_experts)
               ** ((B / dp) * cfg.top_k)) / ep
    else:
        eff = 1.0

    tok = B / dp
    if ep > 1:
        w_bytes = (BYTES_W * ctx.p_dense_total / min(tp * ta, n_dies)
                   + BYTES_W * ctx.p_expert_total
                   / min(tp * ta * ep, n_dies))
    else:
        w_bytes = BYTES_W * ctx.p_total / min(tp * ta, n_dies)
    kv_heads = max(cfg.n_kv_heads, 1)
    kv_div = dp * sp * ta * min(tp, kv_heads)
    state_div = dp * ta * tp
    kv_ctx = ctx.kv_seq_bytes - ctx.state_seq_bytes
    cache_bytes = B * (kv_ctx / kv_div + ctx.state_seq_bytes / state_div)
    ws = tok * cfg.d_model * BYTES_ACT * DECODE_WS_COEFF
    mem = w_bytes + cache_bytes + ws
    oom = mem > spec.hbm_cap
    lin_flops = 2 * ctx.p_active * tok / (tp * ta)
    attn_flops = 4 * S * cfg.d_model * tok / (tp * sp * ta)
    t_flops = (lin_flops + attn_flops) / (spec.flops * DECODE_GEMV_EFF)
    if cfg.is_moe:
        w_read = BYTES_W * ctx.p_active_dense / (tp * ta) \
            + BYTES_W * ctx.p_expert_total * eff / (tp * ta)
    else:
        w_read = BYTES_W * ctx.p_active / (tp * ta)
    kv_read = tok * (kv_ctx / ctx.n_l) / (kv_div / dp)
    t_hbm = (w_read + kv_read) / spec.hbm_bw
    t_comp = max(t_flops, t_hbm)
    q_bytes = tok * cfg.d_model * BYTES_ACT
    t_ring = (sp - 1) * (q_bytes / spec.link_bw
                         + sp_hops * spec.hop_latency) \
        + (ta - 1) * (q_bytes / spec.link_bw
                      + ta_hops * spec.hop_latency)
    ar_bytes = 2 * q_bytes / max(tp, 1)
    t_coll = 2 * 2 * (tp - 1) * (ar_bytes / spec.link_bw
                                 + spec.hop_latency) if tp > 1 else 0.0
    t_sched = ((ta + 1) // 2 * T_DISPATCH if ta > 1 else 0.0) \
        + (T_DISPATCH if sp > 1 else 0.0)
    pair_bytes = q_bytes * cfg.top_k / ep
    t_a2a = 2 * (pair_bytes * a2a_load / spec.link_bw
                 + a2a_hops * spec.hop_latency) if ep > 1 else 0.0
    t_moe = eff * (cfg.n_experts * T_EXPERT_DISPATCH) if cfg.is_moe \
        else 0.0
    t_layer = t_coll + max(t_comp, t_ring) + t_sched + t_moe + t_a2a
    head_read = BYTES_W * cfg.d_model * cfg.vocab_size / (tp * ta)
    t_head = max(ctx.dec_head_flops * tok / (tp * ta)
                 / (spec.flops * DECODE_GEMV_EFF),
                 head_read / spec.hbm_bw)
    lat = ctx.n_l * t_layer + t_head
    thr = B / lat
    flops_step = (ctx.dec_layer_flops * ctx.n_l + ctx.dec_head_flops) * B
    hbm_step = (w_read + kv_read) * ctx.n_l * dp * min(tp * ta, n_dies)
    d2d_step = ctx.n_l * (q_bytes * (sp - 1) * sp_hops
                          + q_bytes * (ta - 1) * ta_hops
                          + (4 * q_bytes * (tp - 1) if tp > 1 else 0.0)) \
        * dp
    d2d_a2a = ctx.n_l * (2 * pair_bytes * (ep - 1) * a2a_hops) * dp \
        if ep > 1 else 0.0
    d2d_step = d2d_step + d2d_a2a
    energy = flops_step * spec.e_flop + hbm_step * spec.e_hbm \
        + d2d_step * spec.e_d2d + 450.0 * n_dies * lat
    power = energy / lat
    bw_cap = n_dies * 4 * spec.link_bw
    bw_util = min(1.0, d2d_step / lat / bw_cap)
    return SimResult(
        step_time=float(lat),
        throughput=float(thr),
        mem_per_die=float(mem),
        oom=bool(oom),
        power=float(power),
        power_eff=float(thr / power) if power > 0 else 0.0,
        bw_util=float(bw_util),
        breakdown={
            "objective": "decode",
            "t_comp_layer": float(t_comp),
            "t_hbm_layer": float(t_hbm),
            "t_ring_layer": float(t_ring),
            "t_coll_layer": float(t_coll),
            "t_head": float(t_head),
            "w_bytes": float(w_bytes),
            "cache_bytes": float(cache_bytes),
            "kv_read_per_iter": float(kv_read),
            "ta_hops": int(ta_hops),
            "sp_hops": int(sp_hops),
            "ep": int(ep),
            "t_a2a_layer": float(t_a2a),
            "a2a_load": int(a2a_load),
            "a2a_hops": int(a2a_hops),
            "expert_read_frac": float(eff),
            "t_moe_disp_layer": float(t_moe),
        },
        degrees=deg,
        engine=ctx.engine,
    )


def simulate_decode_reference(wafer: Wafer, cfg: ModelConfig, batch: int,
                              seq: int, deg: ParallelDegrees,
                              engine: str = "tcme", *,
                              tatp_bidirectional: bool = True,
                              dies: Optional[Sequence[int]] = None
                              ) -> SimResult:
    """Public scalar decode anchor (fresh context, one candidate) —
    the decode twin of :func:`simulate_step_reference`."""
    ctx = StepCostContext(wafer, cfg, batch, seq, engine,
                          tatp_bidirectional=tatp_bidirectional,
                          dies=dies, objective="decode",
                          evaluator="reference")
    return _decode_reference_ctx(ctx, deg)


# ---------------------------------------------------------------------------
# strategy presets (the paper's six baselines + TEMP)
# ---------------------------------------------------------------------------


def divisors(n: int) -> tuple[int, ...]:
    """All positive divisors of ``n``, ascending.

    A true enumeration: the seed's helper returned powers of two regardless
    of divisibility, so degraded wafers with non-power-of-two alive counts
    (e.g. 47 or 92 dies) ended up with an empty candidate space.
    """
    small, large = [], []
    d = 1
    while d * d <= n:
        if n % d == 0:
            small.append(d)
            if d != n // d:
                large.append(n // d)
        d += 1
    return tuple(small + large[::-1])


def candidate_degrees(n_dies: int, allow: dict,
                      seq_par: bool = False) -> list[ParallelDegrees]:
    """Enumerate degree tuples whose product equals the die count."""
    divs = divisors(n_dies)
    dps = divs if allow.get("dp", True) else (1,)
    tps = divs if allow.get("tp", False) else (1,)
    sps = divs if allow.get("sp", False) else (1,)
    ta_ok = allow.get("tatp", False)
    out = []
    for dp in dps:
        for tp in tps:
            if n_dies % (dp * tp):
                continue
            for sp in sps:
                if n_dies % (dp * tp * sp):
                    continue
                ta = n_dies // (dp * tp * sp)
                if ta != 1 and not ta_ok:
                    continue
                out.append(ParallelDegrees(dp, tp, sp, ta,
                                           seq_par=seq_par))
    return out


STRATEGY_SPACES = {
    # Megatron-1: DP × TP (activations replicated in TP, all-reduce)
    "mega": dict(allow={"dp": True, "tp": True}, fsdp=False, seq_par=False),
    # Megatron-3: DP × TP with sequence parallelism inside the TP groups
    "mesp": dict(allow={"dp": True, "tp": True}, fsdp=False, seq_par=True),
    # FSDP
    "fsdp": dict(allow={"dp": True}, fsdp=True, seq_par=False),
    # TEMP: DP × TP × SP(context) × TATP
    "temp": dict(allow={"dp": True, "tp": True, "sp": True, "tatp": True},
                 fsdp=False, seq_par=False),
    # ablation step: FSDP+SMap baseline upgraded with TATP only
    "fsdp+tatp": dict(allow={"dp": True, "tatp": True}, fsdp=False,
                      seq_par=False),
}


def smap_config(n_dies: int, space: str) -> ParallelDegrees:
    """SMap's fixed strategy-priority rule (paper: 'fixed parallel strategy
    order', no adaptation): a canonical tp=8 model-parallel share with DP on
    the remainder, regardless of model size."""
    spec = STRATEGY_SPACES[space]
    allow = spec["allow"]
    tp = 8 if allow.get("tp") and n_dies >= 8 else 1
    ta = 4 if allow.get("tatp") and n_dies >= 8 else 1
    dp = max(1, n_dies // (tp * ta))
    return ParallelDegrees(dp, tp, 1, ta, seq_par=spec["seq_par"])


def best_config(wafer: Wafer, cfg: ModelConfig, batch: int, seq: int,
                space: str, engine: str, **kw) -> SimResult:
    """Config selection per mapping engine: SMap uses its fixed priority
    rule; GMap/TCME search degrees (exhaustive here, batch-scored; DLWS in
    repro_torch.wafer.solver is the scalable search)."""
    n = len(wafer.alive_dies())
    spec = STRATEGY_SPACES[space]
    run_tcme = kw.pop("run_tcme_optimizer", True)
    ctx = StepCostContext(wafer, cfg, batch, seq, engine,
                          fsdp=spec["fsdp"], **kw)
    if engine == "smap":
        deg = smap_config(n, space)
        return simulate_batch(ctx, [deg], run_tcme_optimizer=run_tcme)[0]
    cands = candidate_degrees(n, spec["allow"], spec["seq_par"])
    results = simulate_batch(ctx, cands, run_tcme_optimizer=run_tcme,
                             prune_dominated=True)
    best: Optional[SimResult] = None
    for res in results:
        if not res.ok:
            continue
        if best is None or res.throughput > best.throughput:
            best = res
    if best is None:  # everything OOMs — report the least-bad config
        for res in results:
            if best is None or res.mem_per_die < best.mem_per_die:
                best = res
    return best
