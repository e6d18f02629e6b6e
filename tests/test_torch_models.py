"""repro_torch model modules against their repro counterparts on the CPU:
norms, rotary embeddings, attention cores, the KV-cache write, the
attention and MLP blocks on converted weights, parameter init and weight
conversion.  Reduced deepseek-7b (2 layers, d_model 64, 4 heads, d_head
16, fp32); inputs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxPar
from repro.core.dist import Dist as JaxDist
from repro.core.dist import make_mesh
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.dist import Dist
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.weights import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-7b"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced(ARCH)
    jcfg = jax_reduced(ARCH)
    jparams = jax.tree.map(np.asarray, jtf.init_params(jax.random.key(0),
                                                       jcfg))
    params = params_from_jax(jparams, cfg, "cpu")
    return cfg, jcfg, jparams, params


def _ctxs(cfg, jcfg, phase):
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=False),
                      JaxDist(make_mesh((1,), ("model",))), phase=phase)
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=False),
                      Dist(torch.device("cpu")), phase=phase)
    return jctx, tctx


def _rep(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs and common blocks
# ---------------------------------------------------------------------------


ALL_ARCHS = ["deepseek-7b", "mamba2-780m", "zamba2-2.7b", "olmoe-1b-7b",
             "qwen3-moe-235b-a22b", "deepseek-v3-moe", "gemma-7b",
             "gemma2-9b", "qwen2-72b", "internvl2-1b",
             "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_match_reference(arch):
    from repro.configs import ARCHITECTURES as JAX_ARCHS
    from repro.configs import get_config as jax_config
    from repro_torch.configs import ARCHITECTURES
    assert set(ARCHITECTURES) == set(JAX_ARCHS) == set(ALL_ARCHS)
    assert get_config(arch) == _as_port(jax_config(arch))
    assert get_reduced(arch) == _as_port(jax_reduced(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def _as_port(jcfg):
    from dataclasses import asdict
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**asdict(jcfg))


def test_rms_norm():
    rng = np.random.RandomState(0)
    x, s = rng.randn(2, 5, 64), rng.randn(64) * 0.1
    _close(tcommon.rms_norm(_t(x), _t(s), 1e-6),
           jcommon.rms_norm(_j(x), _j(s), 1e-6))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 1 if per_row else 7, 4, 16)
    pos = np.array([[5], [9], [130]]) if per_row else np.arange(7) + 3
    _close(tcommon.apply_rope(_t(x), torch.as_tensor(pos), 10_000.0),
           jcommon.apply_rope(_j(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("name", ["swiglu", "geglu", "gelu"])
def test_act_fn(name):
    x = np.linspace(-4, 4, 33)
    _close(tcommon.act_fn(name)(_t(x)), jcommon.act_fn(name)(_j(x)))


def test_softcap():
    x = np.linspace(-100, 100, 21)
    _close(tcommon.softcap(_t(x), 30.0), jcommon.softcap(_j(x), 30.0))
    assert tcommon.softcap(_t(x), None) is not None


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,cap", [(True, None, None),
                                               (False, 4, None),
                                               (True, None, 5.0)])
def test_local_attention_vector_offset_and_valid_len(causal, window, cap):
    rng = np.random.RandomState(2)
    b, sq, sk = 3, 2, 12
    q, k, v = (rng.randn(b, sq, 4, 16), rng.randn(b, sk, 2, 16),
               rng.randn(b, sk, 2, 16))
    off, vl = np.array([3, 7, 10]), np.array([4, 8, 11])
    got = tattn.local_attention(_t(q), _t(k), _t(v), causal=causal,
                                window=window, cap=cap,
                                q_offset=torch.as_tensor(off),
                                valid_len=torch.as_tensor(vl))
    ref = jattn.local_attention(_j(q), _j(k), _j(v), causal=causal,
                                window=window, cap=cap,
                                q_offset=jnp.asarray(off),
                                valid_len=jnp.asarray(vl))
    _close(got, ref)


@pytest.mark.parametrize("vector", [False, True])
def test_decode_attention_r1(vector):
    rng = np.random.RandomState(3)
    b, s = 2, 10
    q, kc, vc = (rng.randn(b, 1, 4, 16), rng.randn(b, s, 4, 16),
                 rng.randn(b, s, 4, 16))
    cl = np.array([4, 9]) if vector else 6
    got = tattn.decode_attention(_t(q), _t(kc), _t(vc), torch.as_tensor(cl),
                                 axis="model", axis_size=1, window=3)
    ref = jattn.decode_attention(_j(q), _j(kc), _j(vc), jnp.asarray(cl),
                                 axis="model", axis_size=1, window=3)
    _close(got, ref)


@pytest.mark.parametrize("pos", [5, np.array([0, 7, 3])])
def test_write_kv_cache(pos):
    rng = np.random.RandomState(4)
    kc, vc = rng.randn(3, 9, 2, 16), rng.randn(3, 9, 2, 16)
    kn, vn = rng.randn(3, 1, 2, 16), rng.randn(3, 1, 2, 16)
    tk, tv = _t(kc), _t(vc)
    got_k, got_v = tattn.write_kv_cache(tk, tv, _t(kn), _t(vn),
                                        torch.as_tensor(pos), axis="model",
                                        axis_size=1)
    ref_k, ref_v = jattn.write_kv_cache(_j(kc), _j(vc), _j(kn), _j(vn),
                                        jnp.asarray(pos), axis="model",
                                        axis_size=1)
    _close(got_k, ref_k)
    _close(got_v, ref_v)
    assert got_k is tk and got_v is tv  # updated in place


def test_ring_paths_raise_with_roadmap_item():
    """A sliding window in ring attention's backward runs (against the
    reference on real ranks: ``tests/test_torch_ring_window_train.py``):
    on rank 0 of a causal ring of two the later block is invisible, so its
    output and gradients are the windowed local attention's."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from test_torch_ring import _mirror_dist

    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 4, h, 16).astype(
        np.float32)) for h in (4, 2, 2, 4))
    dist = _mirror_dist()

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        y = fn(*leaves)
        return (y.detach(), *torch.autograd.grad(y, leaves, do))

    want = grads(lambda a, b, c: tattn.local_attention(a, b, c, window=2))
    for hook in (None, attention_ref):  # the loop and the hook
        got = grads(lambda a, b, c: tattn.ring_attention(
            a, b, c, axis="model", axis_size=2, window=2, dist=dist,
            attention=hook))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# blocks on converted weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_attn_and_mlp_blocks(model, phase):
    cfg, jcfg, jparams, params = model
    jctx, tctx = _ctxs(cfg, jcfg, phase)
    rng = np.random.RandomState(5)
    b, s = 2, (1 if phase == "decode" else 8)
    x = rng.randn(b, s, cfg.d_model)
    jp, tp = _rep(jparams["layers"]["u0"]), _rep(params["layers"]["u0"])
    kw_j, kw_t = {}, {}
    if phase == "decode":
        kc, vc = rng.randn(b, 12, 4, 16), rng.randn(b, 12, 4, 16)
        cl = np.array([5, 9])
        kw_j = dict(cache={"k": _j(kc), "v": _j(vc)}, cache_len=jnp.asarray(cl))
        kw_t = dict(cache={"k": _t(kc), "v": _t(vc)},
                    cache_len=torch.as_tensor(cl))
    ref, ref_c = jtf.attn_block(jctx, jp, _j(x), kind="G", pos_offset=0,
                                **kw_j)
    got, got_c = ttf.attn_block(tctx, tp, _t(x), kind="G", pos_offset=0,
                                **kw_t)
    _close(got, ref, rtol=1e-4, atol=1e-4)
    for n in ("k", "v"):
        _close(got_c[n], ref_c[n], rtol=1e-4, atol=1e-4)
    _close(ttf.mlp_block(tctx, tp, got), jtf.mlp_block(jctx, jp, ref),
           rtol=1e-4, atol=1e-4)


def test_init_params_shapes_and_distributions():
    cfg = get_reduced(ARCH)
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jtf.param_shapes(jax_reduced(ARCH)))
    assert ttf.param_shapes(cfg) == jshapes
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    blk = params["layers"]["u0"]
    assert torch.count_nonzero(blk["ln"]) == 0
    assert torch.count_nonzero(params["final_ln"]) == 0
    assert abs(params["embed"].std().item() - 0.02) < 0.002
    # dense weights: normal x 1/sqrt(fan_in), fan_in = the input width
    assert abs(blk["mlp.w_down"].std().item() - cfg.d_ff**-0.5) < 0.01
    assert abs(blk["wq"].std().item() - cfg.d_model**-0.5) < 0.02
    assert params["embed"].dtype == torch.float32


def test_params_from_jax_consumes_every_leaf(model):
    cfg, _, jparams, params = model
    want = ttf.param_shapes(cfg)

    def leaves(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, pre + k + "/")
            else:
                yield pre + k, v

    jl, tl, wl = dict(leaves(jparams)), dict(leaves(params)), dict(leaves(
        want))
    assert set(jl) == set(tl) == set(wl)
    for n in jl:
        assert tuple(tl[n].shape) == wl[n]
        np.testing.assert_array_equal(tl[n].numpy(), jl[n])
    extra = dict(jparams, shared={"wq": np.zeros((4, 4), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(extra, cfg, "cpu")
    missing = {k: v for k, v in jparams.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, cfg, "cpu")
