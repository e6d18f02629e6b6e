"""The repro_torch serving slice against repro on the CPU: prefill caches and
logits, decode steps with a scalar and a per-row cache_len, the one-shot
serve driver end to end, and the port's isolation from jax and repro.

Reduced deepseek-7b (2 layers, d_model 64, 4 heads, d_head 16, vocab 128
padded to 512, fp32) on weights converted from the reference's tree."""

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import ParallelConfig as JaxPar
from repro.core.dist import Dist as JaxDist
from repro.core.dist import make_mesh
from repro.models import lm as jlm
from repro.models import transformer as jtf
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.dist import Dist
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttf
from repro_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
ARCH = "deepseek-7b"
TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(ARCH)
    cfg = get_reduced(ARCH)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jctx = jtf.RunCtx(jcfg, JaxPar(strategy="tatp", remat=False),
                      JaxDist(make_mesh((1,), ("model",))), phase="decode")
    tctx = ttf.RunCtx(cfg, ParallelConfig(strategy="tatp", remat=False),
                      Dist(torch.device("cpu")), phase="decode")
    return cfg, jctx, jparams, tctx, params


def _prefilled(model, b, s, max_seq, seed=0):
    cfg, jctx, jparams, tctx, params = model
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))
    jc, jl = jax.jit(lambda p, bt: jlm.prefill(jctx, p, bt))(
        jparams, {"tokens": jnp.asarray(toks)})
    tc, tl = tlm.prefill(tctx, params, {"tokens": torch.as_tensor(toks)})
    jbig = jlm.graft_cache_slots(jax.device_get(jlm.init_cache(jctx, b,
                                                               max_seq)),
                                 jax.device_get(jc), slots=range(b))
    tbig = tlm.graft_cache_slots(tlm.init_cache(tctx, b, max_seq), tc,
                                 slots=range(b))
    return (jc, jl, jax.tree.map(jnp.asarray, jbig)), (tc, tl, tbig)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def test_prefill_caches_and_logits(model):
    (jc, jl, jbig), (tc, tl, tbig) = _prefilled(model, 2, 8, 16)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl)
    for n in ("k", "v"):
        assert tuple(tc["u0"][n].shape) == jc["u0"][n].shape
        _close(tc["u0"][n], jc["u0"][n])
        assert tuple(tbig["u0"][n].shape) == jbig["u0"][n].shape
        _close(tbig["u0"][n], jbig["u0"][n])


@pytest.mark.parametrize("vector", [False, True])
def test_decode_steps(model, vector):
    cfg, jctx, jparams, tctx, params = model
    b, s = 2, 8
    (_, jl, jcache), (_, tl, tcache) = _prefilled(model, b, s, 16)
    jt = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32) \
        % cfg.vocab_size
    tt = tl[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    assert np.array_equal(np.asarray(jt), tt.numpy())
    step = jax.jit(lambda p, t, c, n: jlm.decode_step(jctx, p, t, c, n))
    for i in range(3):
        n = s + i + 1
        jn = jnp.full((b,), n, jnp.int32) if vector else jnp.int32(n)
        tn = torch.full((b,), n) if vector else torch.tensor(n)
        jt, jlog, jcache = step(jparams, jt, jcache, jn)
        tt, tlog, tcache = tlm.decode_step(tctx, params, tt, tcache, tn)
        _close(tlog, jlog)
        assert np.array_equal(np.asarray(jt), tt.numpy())
    for n in ("k", "v"):
        _close(tcache["u0"][n], jcache["u0"][n])


def test_decode_mixed_cache_len_rows(model):
    """Rows at different context lengths in one step match the reference
    (per-row rope positions, masks and KV writes)."""
    cfg, jctx, jparams, tctx, params = model
    (_, _, jcache), (_, _, tcache) = _prefilled(model, 2, 10, 16, seed=3)
    toks = np.array([[5], [17]])
    cl = np.array([7, 11])
    jt, jlog, _ = jlm.decode_step(jctx, jparams, jnp.asarray(toks), jcache,
                                  jnp.asarray(cl))
    tt, tlog, _ = tlm.decode_step(tctx, params, torch.as_tensor(toks),
                                  tcache, torch.as_tensor(cl))
    _close(tlog, jlog)
    assert np.array_equal(np.asarray(jt), tt.numpy())


def test_first_token_uses_padded_vocab(model):
    """serve's first token is argmax over the *padded* vocab mod vocab_size
    (as the reference does); decode_step masks padded columns."""
    cfg, _, _, tctx, params = model
    assert ttf.padded_vocab(cfg) == 512 and cfg.vocab_size == 128
    logits = torch.full((1, 1, 512), -1.0)
    logits[0, 0, 300] = 5.0  # a padded column wins the serve argmax
    assert (logits.argmax(-1) % cfg.vocab_size).item() == 300 % 128
    cache = tlm.init_cache(tctx, 1, 4)
    params_pad = dict(params)
    head = params["lm_head"].clone()
    head[:, 128:] = 100.0  # padded columns dominate the raw logits
    params_pad["lm_head"] = head
    tok, _, _ = tlm.decode_step(tctx, params_pad, torch.tensor([[1]]), cache,
                                torch.tensor([1]))
    assert tok.item() < cfg.vocab_size


def _serve_args(**kw):
    base = dict(arch=ARCH, reduced=True, batch=2, prompt_len=16, gen=6,
                mesh=[1, 1], plan=None, auto_plan=False, plan_cache=None,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_serve_matches_reference(model):
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import serve
    _, _, _, _, params = model
    args = _serve_args()
    ref = jax_serve(args)
    got = serve(args, params=params)
    assert set(got) == set(ref)
    assert got["generated_shape"] == ref["generated_shape"] == [2, 7]
    assert got["sample"] == ref["sample"]
    assert got["tokens_per_s"] > 0 and got["ms_per_token"] > 0


def test_serve_main_prints_reference_keys(capsys):
    from repro_torch.launch.serve import main
    main(["--reduced", "--device", "cpu", "--batch", "1", "--prompt-len",
          "4", "--gen", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"generated_shape", "tokens_per_s", "ms_per_token",
                        "sample"}


def test_serve_without_cuda_raises(monkeypatch):
    """The entry point never carries on on the CPU unless asked to."""
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(_serve_args(device="cuda"))


def test_unported_paths_name_their_roadmap_item(model):
    from dataclasses import replace
    cfg, _, _, tctx, _ = model
    moe = replace(cfg, n_experts=8, top_k=2)
    p = {n: t[0] for n, t in ttf.init_params(
        moe, torch.Generator().manual_seed(0), "cpu")["layers"]["u0"].items()}
    ring = replace(tctx, cfg=moe, dist=_RingDist(torch.device("cpu")))
    with pytest.raises(NotImplementedError, match="A3"):
        ttf.moe_block(ring, p, torch.zeros(1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match="A3"):
        tlm.embed_tokens(ring, p["wq"], torch.zeros(1, 4, dtype=torch.long))
    for strategy in ("megatron", "fsdp"):  # run at degree 1, not above
        with pytest.raises(NotImplementedError, match="A3"):
            ttf._linear(replace(ring, par=ParallelConfig(strategy=strategy)),
                        torch.zeros(1, 1, 4), torch.zeros(4, 4))


class _RingDist(Dist):
    """A ring of two (the MoE block's expert all-to-all is not ported)."""

    @property
    def model_degree(self) -> int:
        return 2


# ---------------------------------------------------------------------------
# isolation: the port imports neither jax nor repro
# ---------------------------------------------------------------------------


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.launch.serve" in mods and len(mods) > 15
    assert {"repro_torch.serve", "repro_torch.serve.engine",
            "repro_torch.serve.governor", "repro_torch.serve.migrate",
            "repro_torch.wafer.fault"} <= set(mods)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from repro_torch.kernels import _build\n"
        "from repro_torch.kernels.tatp_matmul.ops import tatp_dot\n"
        "tatp_dot(torch.ones(2, 3), torch.ones(3, 4))\n"
        "assert _build._LIBS == {}, 'import or a CPU call built a kernel'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_sources_never_import_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert PORT / "serve" / "engine.py" in files
    assert PORT / "wafer" / "fault.py" in files
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []
