"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``) with
expert parallelism over the TATP ring axis: experts are sharded
contiguously over ``model`` (global expert ``e`` lives on rank ``e //
(E / R)``; at degree 1 every expert is local).

Dispatch is GShard-style with a fixed per-(rank, expert) capacity, as the
reference's::

  route (top-k) -> slot assignment -> scatter into [E, C, D]
  -> all_to_all -> per-expert batched FFN -> all_to_all back
  -> weighted combine.

Tokens above capacity are dropped; the load-balance auxiliary loss keeps
the router near-uniform so drops stay rare.  Routing is flat top-k over
all experts, as in the reference's model path (a config's
``n_expert_groups`` / ``top_k_groups`` only shape its serve engine's
router simulation).  The expert products run in torch, as the reference
computes them with ``jnp.einsum`` outside any Pallas kernel, with its
dtype flow (:func:`expert_bmm`): exact products accumulated and returned
in fp32, as its ``preferred_element_type=float32`` einsums.  The combine
sums each token's k contributions as a reduction over k (no scatter-add),
so forward and backward are deterministic.  Above degree 1 the two
all-to-alls are :meth:`repro_torch.core.dist.Dist.all_to_all` in the
reference's layout (``[R, E / R, C, D]`` out, ``[E / R, R * C, D]`` into
the expert products), differentiable, so the expert shards gather every
rank's tokens' gradients; the capacity and the load-balance loss are each
rank's own, from its own tokens, as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import act_fn, is_gated


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


class Routing(NamedTuple):
    """What the router decided for the flat (token-major, k-minor)
    assignments: expert ids [T, k], keep mask [T * k], capacity, each
    token's margin [T]: its k-th expert's probability less the best
    unchosen one's (inf when every expert is chosen), how near the choice
    was to a tie; and the model layer of the call."""
    experts: torch.Tensor
    keep: torch.Tensor
    cap: int
    margin: torch.Tensor
    layer: int


def router_topk(xf, w_router, n_experts: int, top_k: int):
    """xf: [T, D] -> (weights [T, k], experts [T, k], probs [T, E]).  The
    router's product and softmax in fp32; experts in descending order of
    probability, as ``lax.top_k`` returns them."""
    logits = torch.matmul(xf.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return vals, idx, probs


def load_balance_loss(probs, idx, n_experts: int):
    """GShard aux loss: E * sum_e (token fraction) * (mean prob), the
    fraction counting each token's first expert."""
    sel = torch.nn.functional.one_hot(idx[:, 0], n_experts).float()
    return n_experts * (sel.mean(dim=0) * probs.mean(dim=0)).sum()


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: Python's ``round`` (half to even) of a Python
    float, as the reference computes it."""
    return int(max(1, round(t * top_k / n_experts * capacity_factor)))


def slots(experts, n_experts: int, cap: int):
    """(slot [T * k], keep [T * k]) of the flat assignments: each one's
    running position within its expert, kept below ``cap``; overflow goes
    to the drop slot ``n_experts * cap``.  The reference takes the
    position from a cumsum of one-hots in flat order; here it is the
    assignment's rank in a stable sort by expert less its expert's first
    rank, the same integers without a [T * k, E] scan."""
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    # a count per expert of a static length (bincount's length depends
    # on the ids, which a traced step cannot read)
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(flat_e.numel(), device=flat_e.device)
    pos = torch.empty_like(flat_e).scatter_(0, order,
                                            rank - first[flat_e[order]])
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, n_experts * cap))
    return slot, keep


class _ExpertBmm(torch.autograd.Function):
    """bf16 ``a @ b`` with fp32 accumulation and an fp32 result.  On CUDA
    the forward is one cuBLAS batched GEMM on the bf16 operands
    (``torch.bmm(..., out_dtype=float32)``, which has no derivative); on
    the CPU, which lacks that op, a product of fp32 upcasts (bf16
    products are exact in fp32, so both are the same function).  The
    backward is JAX's transpose of the reference's einsum: the fp32
    cotangent times the operands promoted to fp32, cast back to each
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return da, db


def expert_bmm(a, b):
    """[E, C, K] @ [E, K, N] -> fp32 [E, C, N]: the products of ``a`` and
    ``b`` (one dtype) accumulated in fp32."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _ExpertBmm.apply(a, b)


def moe_ffn(x, params, *, n_experts: int, top_k: int, act: str,
            axis: str, axis_size: int, capacity_factor: float = 1.25,
            routing: list | None = None, layer: int = 0,
            dist=None) -> MoEOut:
    """x: [B, S, D], this rank's tokens.  params: ``router [D, E]``
    (replicated), ``w_gate/w_up [E_loc, D, F]``, ``w_down [E_loc, F, D]``
    (this rank's ``E_loc = E / axis_size`` experts).  Above degree 1
    ``dist`` moves the slots to their experts' ranks and back over
    ``axis``.  ``routing``, if given, gets this call's :class:`Routing`
    appended, labelled with ``layer`` (for checks of the router's
    choices)."""
    r = axis_size
    if r > 1 and (dist is None or n_experts % r):
        raise ValueError(f"expert parallelism over {r} ranks needs the "
                         f"Dist and experts ({n_experts}) that divide "
                         f"over them")
    e_loc = n_experts // r
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)

    weights, experts, probs = router_topk(xf, params["router"], n_experts,
                                          top_k)
    aux = load_balance_loss(probs, experts, n_experts)

    # slot assignment ----------------------------------------------------
    cap = capacity(t, top_k, n_experts, capacity_factor)
    slot, keep = slots(experts, n_experts, cap)
    if routing is not None:
        if top_k < n_experts:
            p = torch.topk(probs.detach(), top_k + 1, dim=-1).values
            margin = p[:, -2] - p[:, -1]
        else:
            margin = torch.full((t,), float("inf"), device=x.device)
        routing.append(Routing(experts, keep, cap, margin, layer))
    # each token's row k times, token-major (an expand: its backward sums
    # over k); the drop row past the end takes every overflow assignment
    x_rep = xf[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)
    buf = x.new_zeros((n_experts * cap + 1, d)).index_put((slot,), x_rep)
    toks = buf[:-1].reshape(n_experts, cap, d)

    # dispatch to the experts' owners: row j of the result holds rank j's
    # slots for this rank's experts
    if r > 1:
        toks = dist.all_to_all(toks.reshape(r, e_loc, cap, d), axis)
        toks = toks.transpose(0, 1).reshape(e_loc, r * cap, d)

    # expert computation ---------------------------------------------------
    f = act_fn(act)
    h_in = toks.to(params["w_up"].dtype)
    up = expert_bmm(h_in, params["w_up"])
    if "w_gate" in params:
        hidden = f(expert_bmm(h_in, params["w_gate"])) * up
    else:
        hidden = f(up)
    out = expert_bmm(hidden.to(h_in.dtype), params["w_down"]).to(x.dtype)

    # back to the slots' source ranks
    if r > 1:
        out = dist.all_to_all(out.reshape(e_loc, r, cap, d).transpose(0, 1),
                              axis)

    # combine ----------------------------------------------------------------
    out = torch.cat([out.reshape(n_experts * cap, d),
                     out.new_zeros((1, d))])
    gathered = torch.where(keep[:, None], out[slot], 0.0)
    y = (gathered.float() * weights.reshape(-1, 1)).reshape(t, top_k, d)
    return MoEOut(y.sum(dim=1).reshape(b, s, d).to(x.dtype), aux)


def moe_param_shapes(cfg, e_loc: int):
    shapes = {
        "router": (cfg.d_model, cfg.n_experts),
        "w_up": (e_loc, cfg.d_model, cfg.d_ff),
        "w_down": (e_loc, cfg.d_ff, cfg.d_model),
    }
    if is_gated(cfg.act):
        shapes["w_gate"] = (e_loc, cfg.d_model, cfg.d_ff)
    return shapes
