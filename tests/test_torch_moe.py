"""repro_torch's MoE slice against repro on the CPU: the router, the
load-balance loss, the capacity law and slot assignment, ``moe_ffn``
(twins of ``tests/test_moe_capacity.py``), the three MoE config copies,
weight conversion of the expert leaves, prefill and decode of the reduced
olmoe-1b-7b, qwen3-moe (grouped queries: 4 query heads over 2 K/V heads)
and deepseek-v3-moe, and one train step's loss, aux loss and gradients,
on converted weights; inputs made with numpy from a seed.

Tolerances (fp32): ``moe_ffn`` outputs and router weights 1e-5 (the same
products in another order); model logits 5e-4, as the serving slice's
tests; the train loss 1e-5 and the gradients 1e-4, as the train slice's.
Greedy tokens and the router's expert choices must be identical."""

from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxPar
from repro.core.dist import Dist as JaxDist
from repro.core.dist import make_mesh
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.dist import Dist
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.tatp_matmul.ref import matmul_ref
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.train.train_loop import loss_and_grads
from repro_torch.weights import params_from_jax

MOE_ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b", "deepseek-v3-moe"]
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol):
    np.testing.assert_allclose(_np(got), _np(ref), **tol)


def _ffn_params(rng, d, e, f, scale=0.3):
    shapes = dict(router=(d, e), w_up=(e, d, f), w_gate=(e, d, f),
                  w_down=(e, f, d))
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


# ---------------------------------------------------------------------------
# router, aux loss, capacity and moe_ffn against repro.models.moe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,k", [(8, 2), (64, 8)])
def test_router_topk_and_load_balance_loss(e, k):
    rng = np.random.default_rng(e)
    x = rng.normal(size=(40, 32)).astype(np.float32)
    w = (rng.normal(size=(32, e)) * 0.2).astype(np.float32)
    jw, ji, jp = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), e, k)
    tw, ti, tp = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(w),
                                  e, k)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    _close(tw, jw, FFN_TOL)
    _close(tp, jp, FFN_TOL)
    _close(tmoe.load_balance_loss(tp, ti, e),
           jmoe.load_balance_loss(jp, ji, e), FFN_TOL)


@pytest.mark.parametrize("t,k,e,cf,want", [
    (4, 8, 64, 1.25, 1),      # olmoe decode: round(0.625) = 1
    (512, 8, 64, 1.25, 80),   # olmoe prefill, batch 4 x 128
    (2048, 8, 64, 1.25, 320),  # olmoe train, batch 4 x 512
    (4, 1, 8, 1.25, 1),       # round(0.625) = 1
    (2, 1, 8, 2.0, 1),        # round(0.5) = 0 (half to even), floor 1
    (20, 1, 8, 1.0, 2),       # round(2.5) = 2 (half to even)
    (28, 1, 8, 1.0, 4),       # round(3.5) = 4 (half to even)
])
def test_capacity_law(t, k, e, cf, want):
    assert tmoe.capacity(t, k, e, cf) == want
    assert want == int(max(1, round(t * k / e * cf)))  # the reference's law


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_ffn_matches_reference(cf, act):
    """y and aux against repro.models.moe.moe_ffn, at capacities that drop
    many assignments, a few and none."""
    rng = np.random.default_rng(7)
    d, e, f, k = 16, 8, 24, 2
    p = _ffn_params(rng, d, e, f)
    if act == "gelu":
        del p["w_gate"]
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    jp, tp = _both(p)
    kw = dict(n_experts=e, top_k=k, act=act, axis="model", axis_size=1,
              capacity_factor=cf)
    jo = jmoe.moe_ffn(jnp.asarray(x), jp, **kw)
    routing = []
    to = tmoe.moe_ffn(torch.from_numpy(x), tp, routing=routing, **kw)
    _close(to.y, jo.y, FFN_TOL)
    _close(to.aux_loss, jo.aux_loss, FFN_TOL)
    (r,) = routing
    assert r.cap == tmoe.capacity(24, k, e, cf)
    if cf == 0.5:
        assert not bool(r.keep.all())  # overflow drops happen here
    if cf == 8.0:
        assert bool(r.keep.all())


def test_moe_ffn_bf16_matches_reference():
    """bf16 activations and experts: the reference's dtype flow (exact
    products accumulated in fp32, up and gate in fp32 before the
    activation, hidden cast to bf16 before w_down, the output in bf16).
    y and every gradient against jax.grad of the reference within 2e-2
    relative to each tensor's largest magnitude (a bf16 rounding of sums
    taken in another order; with capacity 1.25 and 8 experts)."""
    rng = np.random.default_rng(11)
    d, e, f, k = 32, 8, 48, 2
    p = _ffn_params(rng, d, e, f)
    x = rng.normal(size=(2, 16, d)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, act="swiglu", axis="model",
              axis_size=1, capacity_factor=1.25)

    def jf(x, p):
        o = jmoe.moe_ffn(x, p, **kw)
        return (o.y.astype(jnp.float32) ** 2).sum() + o.aux_loss, o.y

    jx = jnp.asarray(x, jnp.bfloat16)
    jp = {n: jnp.asarray(v, jnp.bfloat16) for n, v in p.items()}
    (_, jy), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jx, jp)
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tp = {n: torch.from_numpy(v).bfloat16().requires_grad_(True)
          for n, v in p.items()}
    o = tmoe.moe_ffn(tx, tp, **kw)
    assert o.y.dtype == torch.bfloat16
    loss = (o.y.float() ** 2).sum() + o.aux_loss
    grads = torch.autograd.grad(loss, [tx, *tp.values()])
    pairs = [(o.y, jy), (grads[0], jg[0])]
    pairs += [(g, jg[1][n]) for g, n in zip(grads[1:], tp)]
    for got, want in pairs:
        want = _np(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=2e-2 * scale)


def test_moe_ffn_ring_raises_a3():
    """Expert parallelism over the ring runs (against the reference:
    ``tests/test_torch_ring_moe.py``); without the Dist to move the slots,
    or with experts that do not divide over the ranks, it raises before
    any collective."""
    rng = np.random.default_rng(0)
    _, tp = _both(_ffn_params(rng, 8, 4, 8))
    with pytest.raises(ValueError, match="needs the Dist"):
        tmoe.moe_ffn(torch.zeros(1, 4, 8), tp, n_experts=4, top_k=1,
                     act="swiglu", axis="model", axis_size=2)
    with pytest.raises(ValueError, match="divide"):
        tmoe.moe_ffn(torch.zeros(1, 4, 8), tp, n_experts=4, top_k=1,
                     act="swiglu", axis="model", axis_size=3,
                     dist=Dist(CPU, mesh_shape=(1, 3)))


# twins of tests/test_moe_capacity.py -------------------------------------

E, K, D, F = 4, 1, 4, 8
T = 8  # b=1, s=8


def _cap_params(seed=0):
    """Router pins every token to expert 0 (column 0 is the only nonzero
    and the inputs are strictly positive), experts are random (the same
    draws as tests/test_moe_capacity.py)."""
    rng = np.random.default_rng(seed)
    router = np.zeros((D, E), np.float32)
    router[:, 0] = 1.0
    experts = {n: torch.tensor(rng.normal(size=shape), dtype=torch.float32)
               for n, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)),
                                ("w_down", (E, F, D)))}
    return {"router": torch.from_numpy(router), **experts}


def _cap_x(seed=1):
    rng = np.random.default_rng(seed)
    return torch.tensor(np.abs(rng.normal(size=(1, T, D))) + 0.1,
                        dtype=torch.float32)


def _cap_run(capacity_factor):
    out = tmoe.moe_ffn(_cap_x(), _cap_params(), n_experts=E, top_k=K,
                       act="swiglu", axis="ep", axis_size=1,
                       capacity_factor=capacity_factor)
    return out.y.reshape(T, D).numpy()


def test_slot_cumsum_and_keep_mask():
    cap = 2
    flat_e = torch.tensor([0, 0, 0, 1, 3, 3, 3, 0])
    slot, keep = tmoe.slots(flat_e, E, cap)
    assert keep.tolist() == [True, True, False, True,
                             True, True, False, False]
    assert slot.tolist() == [0, 1, E * cap, 2, 6, 7, E * cap, E * cap]
    kept = slot[keep].tolist()
    assert len(set(kept)) == len(kept) and all(s < E * cap for s in kept)
    assert set(slot[~keep].tolist()) == {E * cap}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slots_equal_the_reference_cumsum(seed):
    """The sort-based slot positions are the reference's cumsum-of-one-hots
    positions (``repro/models/moe.py:64-68``), keep mask and drop slot."""
    rng = np.random.default_rng(seed)
    t, k, e = 37, 3, 8
    experts = rng.integers(0, e, size=(t, k))
    cap = int(rng.integers(1, 8))
    flat_e = jnp.asarray(experts.reshape(-1))
    one_hot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(one_hot, axis=0)[jnp.arange(t * k), flat_e] - 1
    keep = pos < cap
    slot = jnp.where(keep, flat_e * cap + pos, e * cap)
    got_slot, got_keep = tmoe.slots(torch.from_numpy(experts), e, cap)
    assert got_slot.tolist() == np.asarray(slot).tolist()
    assert got_keep.tolist() == np.asarray(keep).tolist()


def test_overflow_tokens_are_dropped():
    y = _cap_run(0.5)
    assert np.any(y[0] != 0.0)
    assert np.all(y[1:] == 0.0)


def test_dropped_tokens_pass_residual_unchanged():
    y = _cap_run(0.5)
    x = _cap_x().reshape(T, D).numpy()
    resid = x + y
    assert np.array_equal(resid[1:], x[1:])
    assert not np.array_equal(resid[0], x[0])


def test_high_capacity_admits_everything():
    """capacity_factor = E lifts cap to 8: no drops.  The admitted token's
    output matches the low-capacity run's within 1e-6 relative: the expert
    products run over buffers of another capacity, and a BLAS may order
    the sums differently by shape (the reference's twin asserts bitwise
    equality, ROADMAP.md §C)."""
    y_lo, y_hi = _cap_run(0.5), _cap_run(float(E))
    assert np.all(np.any(y_hi != 0.0, axis=1))
    np.testing.assert_allclose(y_hi[0], y_lo[0], rtol=1e-6, atol=1e-6)
    x = _cap_x().reshape(T, D).numpy()
    assert not np.isclose(x[1:], x[0]).all(axis=1).any()


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_match_reference(arch):
    assert get_config(arch) == ModelConfig(**asdict(jax_config(arch)))
    assert get_reduced(arch) == ModelConfig(**asdict(jax_reduced(arch)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_jax_carries_expert_leaves(arch):
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    jparams = jax.tree.map(np.asarray, jtf.init_params(jax.random.key(0),
                                                       jcfg))
    params = params_from_jax(jparams, cfg, CPU)
    names = {"mlp.router", "mlp.w_up", "mlp.w_gate", "mlp.w_down",
             "mlp.ln"}
    assert names <= set(params["layers"]["u0"])
    for n in names:
        np.testing.assert_array_equal(params["layers"]["u0"][n].numpy(),
                                      jparams["layers"]["u0"][n])
    assert tuple(params["layers"]["u0"]["mlp.w_down"].shape) == (
        cfg.n_layers, cfg.n_experts, cfg.d_ff, cfg.d_model)
    shapes = ttf.param_shapes(cfg)
    init = ttf.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert {n: tuple(t.shape) for n, t in init["layers"]["u0"].items()} \
        == shapes["layers"]["u0"]


# ---------------------------------------------------------------------------
# serving and training of the reduced MoE models against repro
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    arch = request.param
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return arch, cfg, jcfg, jparams, params


def _serve_ctxs(cfg, jcfg, routing=None):
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=False),
                      JaxDist(make_mesh((1,), ("model",))), phase="decode")
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=False),
                      Dist(CPU), phase="decode", routing=routing)
    return jctx, tctx


def test_prefill_and_decode_match_reference(model):
    arch, cfg, jcfg, jparams, params = model
    if arch.startswith("qwen3"):
        assert cfg.n_kv_heads < cfg.n_heads  # grouped queries
    jctx, tctx = _serve_ctxs(cfg, jcfg)
    b, s, steps = 2, 8, 3
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s))
    jc, jl = jax.jit(lambda p, bt: jlm.prefill(jctx, p, bt))(
        jparams, {"tokens": jnp.asarray(toks)})
    tc, tl = tlm.prefill(tctx, params, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl, LOGIT_TOL)
    _close(tc["u0"]["k"], jc["u0"]["k"], LOGIT_TOL)
    jcache = jax.tree.map(jnp.asarray, jlm.graft_cache_slots(
        jax.device_get(jlm.init_cache(jctx, b, s + steps)),
        jax.device_get(jc), slots=range(b)))
    tcache = tlm.graft_cache_slots(tlm.init_cache(tctx, b, s + steps), tc,
                                   slots=range(b))
    jt = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32) \
        % cfg.vocab_size
    tt = tl[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    step = jax.jit(lambda p, t, c, n: jlm.decode_step(jctx, p, t, c, n))
    for i in range(steps):
        n = s + i + 1
        jt, jlog, jcache = step(jparams, jt, jcache,
                                jnp.full((b,), n, jnp.int32))
        tt, tlog, tcache = tlm.decode_step(tctx, params, tt, tcache,
                                           torch.full((b,), n))
        _close(tlog, jlog, LOGIT_TOL)
        assert np.array_equal(np.asarray(jt), tt.numpy())


def test_routing_is_recorded_per_layer(model):
    """RunCtx.routing collects every MoE layer's expert ids and keep mask
    (the card's parity check compares two runs' routing with it)."""
    arch, cfg, jcfg, _, params = model
    routing = []
    _, tctx = _serve_ctxs(cfg, jcfg, routing=routing)
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 8)))
    tlm.prefill(tctx, params, {"tokens": toks})
    assert [r.layer for r in routing] == list(range(cfg.n_layers))
    for r in routing:
        assert tuple(r.experts.shape) == (16, cfg.top_k)
        assert r.keep.shape[0] == 16 * cfg.top_k


def _train_batch(vocab, b=2, s=16, seed=3):
    from repro.train import data as jdata
    toks = jdata._lcg_tokens(seed, b, s + 1, vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_loss_aux_and_grads_match_reference(model, remat):
    """Loss, aux loss and every gradient leaf of the loss against jax.grad
    of the reference's (nll / count + aux), with and without remat."""
    arch, cfg, jcfg, jparams, params = model
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=remat),
                      JaxDist(make_mesh((1,), ("model",))), phase="train")
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=remat),
                      Dist(CPU), phase="train")
    batch = _train_batch(cfg.vocab_size)

    def jloss(p):
        nll, cnt, aux = jlm.loss_fn(jctx, p, batch)
        return nll / cnt + aux, (nll / cnt, aux)

    (jl, (jnll, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        nll, cnt, aux = tlm.loss_fn(tctx, params, tb)
    _close(aux, jaux, FFN_TOL)
    assert float(aux) > 0
    _close(nll / cnt, jnll, FFN_TOL)
    tnll, tcnt, tg = loss_and_grads(tctx, params, tb)
    _close(tnll / tcnt, jnll, FFN_TOL)
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    flat_t = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat_t[f"{prefix}{k}"] = v

    walk(tg, "")
    assert set(flat_t) == set(flat_j)
    for name, g in flat_t.items():
        _close(g, flat_j[name], GRAD_TOL)
    assert float(flat_t["layers/u0/mlp.router"].abs().sum()) > 0


def test_moe_layer_on_the_ring_raises_a3(model):
    """The MoE layer runs on the ring under ``tatp``
    (``tests/test_torch_ring_moe.py``); under ``megatron`` above degree 1
    the reference cannot run it, so it raises naming ROADMAP.md C5."""
    arch, cfg, jcfg, _, params = model
    _, tctx = _serve_ctxs(cfg, jcfg)
    p = {n: t[0] for n, t in params["layers"]["u0"].items()}
    ring = replace(tctx, dist=_RingDist(CPU),
                   par=ParallelConfig(strategy="megatron"))
    with pytest.raises(NotImplementedError, match="C5"):
        ttf.moe_block(ring, p, torch.zeros(1, 4, cfg.d_model))


class _RingDist(Dist):
    @property
    def model_degree(self) -> int:
        return 2


def test_plain_hooks_give_the_same_moe_logits(model):
    """The GEMM and attention hooks' plain versions leave a MoE prefill
    unchanged (the card's parity swaps them the same way)."""
    arch, cfg, jcfg, _, params = model
    _, tctx = _serve_ctxs(cfg, jcfg)
    plain = replace(tctx, dot=matmul_ref, attention=attention_ref)
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 8)))
    _, a = tlm.prefill(tctx, params, {"tokens": toks})
    _, b = tlm.prefill(plain, params, {"tokens": toks})
    assert torch.equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_expert_bmm_on_the_card(cuda_device):
    """bf16 expert products on the card (one cuBLAS batched GEMM with an
    fp32 result) against the CPU's product of fp32 upcasts: the same
    exact products summed in another order, within 1e-5 of the largest
    magnitude; the backward's gradients, fp32 sums rounded to bf16, within
    one bf16 step (2^-8) of the largest magnitude."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 40, 256, generator=g).bfloat16()
    b = torch.randn(8, 256, 96, generator=g).bfloat16()
    gy = torch.randn(8, 40, 96, generator=g)
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        ad = a.to(dev).requires_grad_(True)
        bd = b.to(dev).requires_grad_(True)
        y = tmoe.expert_bmm(ad, bd)
        assert y.dtype == torch.float32
        outs.append([y, *torch.autograd.grad(y, (ad, bd), gy.to(dev))])
    for i, (want, got) in enumerate(zip(*outs)):
        want, got = want.float(), got.float().cpu()
        tol = (1e-5 if i == 0 else 2.0**-8) * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol

