"""The MoE FFN's expert all-to-all over the TATP ring (model degree above
1) against the reference on the CPU.

As ``tests/test_torch_ring.py``: the port's ranks are processes joined by
gloo (a ``FileStore`` under the test's temporary directory), the reference
runs ``shard_map`` on 4 fake CPU devices in a subprocess, both sides run
this file as a script on the same seeded numpy inputs (:func:`_inputs`,
:func:`_np_params`) and write numpy outputs:

* ``Dist.all_to_all`` and its backward against ``lax.all_to_all`` and
  ``jax.vjp`` at R = 2 and 4, bit for bit (R = 2: each data row of the
  (2, 2) mesh is a ring of two);
* ``moe_ffn`` at R = 2 and 4 at the published capacity factor 1.25 (so
  slots drop): each rank's output and load-balance loss, and the
  gradients of its input, its router copy and its expert shards, at 1e-5;
* the reduced olmoe-1b-7b with ``tests/multidevice/check_model.py``'s
  overrides (no drops, no aux loss) and as registered (capacity 1.25, its
  aux loss per rank): the loss and every gradient leaf (the train step's
  bookkeeping, then a psum over ``data``) at (1, 4) and (2, 2), at 2e-4;
  the reduced qwen3-moe-235b-a22b and deepseek-v3-moe at (1, 4);
* the registered reduced olmoe's prefill (logits, each rank's K/V block)
  and 4 greedy decode steps at (1, 4): identical tokens;

and ``launch.serve`` / ``launch.train`` of olmoe under
``torch.distributed.run``."""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
RINGS = (2, 4)
# moe_ffn alone: experts, top-k, model width, expert hidden width, a rank's
# batch and sequence
E, K, D, F, XB, XS = 8, 2, 16, 24, 2, 4
# the models: which config, which meshes (olmoe_cm: check_model.py's
# overrides; olmoe: the registered reduced config)
MODELS = (("olmoe_cm", (1, 4)), ("olmoe_cm", (2, 2)), ("olmoe", (1, 4)),
          ("olmoe", (2, 2)), ("qwen3-moe-235b-a22b", (1, 4)),
          ("deepseek-v3-moe", (1, 4)))
TB, TS = 4, 32  # the losses' batch and sequence
B, P, GEN, MAX_SEQ = 4, 16, 4, 24  # the serve
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
TIMEOUT = 300


def _config(name, reduced):
    """The config ``name`` stands for, from the package's ``get_reduced``
    (``reduced``)."""
    if name == "olmoe_cm":  # tests/multidevice/check_model.py's overrides
        return replace(reduced("olmoe-1b-7b"), n_experts=8, top_k=2,
                       capacity_factor=8.0, aux_coef=0.0)
    return reduced("olmoe-1b-7b" if name == "olmoe" else name)


def _inputs():
    rng = np.random.RandomState(0)
    out = {}
    for r in RINGS:
        out[f"a2a{r}"] = rng.randn(r * r, 3, 5).astype(np.float32)
        out[f"a2a_ct{r}"] = rng.randn(r * r, 3, 5).astype(np.float32)
        out[f"x{r}"] = rng.randn(XB, r * XS, D).astype(np.float32)
        out[f"dy{r}"] = rng.randn(XB, r * XS, D).astype(np.float32)
    out["router"] = (rng.randn(D, E) / np.sqrt(D)).astype(np.float32)
    for n, shape in (("w_up", (E, D, F)), ("w_gate", (E, D, F)),
                     ("w_down", (E, F, D))):
        out[n] = (rng.randn(*shape) / np.sqrt(shape[1])).astype(np.float32)
    out["prompts"] = rng.randint(0, 128, (B, P))
    return out


def _step_len(t):
    return P + t + 1 + np.arange(B) % 2


def _np_params(shapes, rng=None):
    """Seeded weights for a parameter tree of leaf shapes (sorted walk)."""
    rng = rng or np.random.RandomState(1)
    out = {}
    for k in sorted(shapes):
        v = shapes[k]
        if isinstance(v, dict):
            out[k] = _np_params(v, rng)
            continue
        scale = 0.1 if k.endswith("ln") else (
            1.0 if k == "embed" else 1.0 / np.sqrt(v[-2]))
        out[k] = (rng.randn(*v) * scale).astype(np.float32)
    return out


def _batch(cfg):
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (TB, TS + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tag(name, shape):
    return f"{name}_{shape[0]}x{shape[1]}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as Ps

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.core.dist import Dist, make_mesh
    from repro.models import lm, moe
    from repro.models.transformer import RunCtx, param_shapes, param_specs
    from repro.train.train_loop import (batch_specs, make_serve_fns,
                                        reduce_model_axis_grads,
                                        token_axes)

    x = _inputs()
    res = {}
    devs = jax.devices()
    assert len(devs) == 4, devs

    def smap(f, mesh, ins, outs):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=ins,
                                     out_specs=outs, check_vma=False))

    m0, seq, rep = Ps("model"), Ps(None, "model"), Ps()
    ffn_keys = ("router", "w_up", "w_gate", "w_down")
    for r in RINGS:
        mesh = make_mesh((r,), ("model",), devices=devs[:r])

        def a2a(t, ct):
            y, vjp = jax.vjp(lambda z: lax.all_to_all(
                z, "model", split_axis=0, concat_axis=0), t)
            return y, vjp(ct)[0]

        y, g = smap(a2a, mesh, (m0, m0), (m0, m0))(x[f"a2a{r}"],
                                                   x[f"a2a_ct{r}"])
        res[f"a2a{r}"], res[f"a2a_grad{r}"] = np.asarray(y), np.asarray(g)

        def ffn(xx, dy, router, w_up, w_gate, w_down, r=r):
            def f(xx, *ws):
                out = moe.moe_ffn(xx, dict(zip(ffn_keys, ws)), n_experts=E,
                                  top_k=K, act="swiglu", axis="model",
                                  axis_size=r)
                return out.y, out.aux_loss
            (y, aux), vjp = jax.vjp(f, xx, router, w_up, w_gate, w_down)
            dx, dr, du, dg, dd = vjp((dy, jnp.ones_like(aux)))
            return y, aux[None], dx, dr[None], du, dg, dd

        outs = smap(ffn, mesh, (seq, seq, rep, m0, m0, m0),
                    (seq, m0, seq, m0, m0, m0, m0))(
            x[f"x{r}"], x[f"dy{r}"], *(x[k] for k in ffn_keys))
        for n, o in zip(("y", "aux", "dx", "drouter", "dw_up", "dw_gate",
                         "dw_down"), outs):
            res[f"ffn{r}_{n}"] = np.asarray(o)

    for name, shape in MODELS:
        cfg = _config(name, get_reduced)
        tag = _tag(name, shape)
        dist = Dist(make_mesh(shape, ("data", "model"), devices=devs))
        mesh = dist.mesh
        par = ParallelConfig(strategy="tatp", remat=False)
        ctx = RunCtx(cfg, par, dist)
        shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
        params = jax.tree.map(jnp.asarray, _np_params(shapes))
        pspecs = param_specs(cfg, "tatp")
        bspecs = batch_specs(cfg, ShapeConfig("t", "train", TS, TB), par,
                             dist)
        tax = token_axes(par, dist)
        n_shards = 1
        for a in tax:
            n_shards *= dist.axis_sizes[a]

        def loss_grads(p, bt):
            def local_loss(p):
                nll, cnt, aux = lm.loss_fn(ctx, p, bt)
                for a in tax:
                    cnt = lax.psum(cnt, a)
                cnt = lax.stop_gradient(cnt)
                return nll / cnt + aux / n_shards, nll
            grads, nll = jax.grad(local_loss, has_aux=True)(p)
            grads = reduce_model_axis_grads(grads, pspecs, par, dist)
            grads = jax.tree.map(lambda g: lax.psum(g, "data"), grads)
            cnt = jnp.float32(TB * TS)
            for a in tax:
                nll = lax.psum(nll, a)
            return nll / cnt, grads

        ps = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s), pspecs))
        bt = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh,
                                                              bspecs[k]))
              for k, v in _batch(cfg).items()}
        loss, grads = smap(loss_grads, mesh, (pspecs, bspecs),
                           (rep, pspecs))(ps, bt)
        res[f"{tag}_loss"] = np.asarray(loss)
        for path, g in _flat(grads).items():
            res[f"{tag}_grad_{path}"] = np.asarray(g)

        if name != "olmoe" or shape != (1, 4):
            continue
        sb = make_serve_fns(cfg, par, dist, ShapeConfig("s", "decode",
                                                        MAX_SEQ, B))
        caches, logits = sb.prefill_fn(ps, {"tokens": jnp.asarray(
            x["prompts"])})
        res[f"{tag}_prefill_logits"] = np.asarray(logits)
        big = {}
        for u, leaves in caches.items():
            res.update({f"{tag}_prefill_{u}.{n}": np.asarray(t)
                        for n, t in leaves.items()})
            big[u] = {}
            for n, t in leaves.items():
                t = np.asarray(t)
                z = np.zeros(t.shape[:2] + (MAX_SEQ,) + t.shape[3:], t.dtype)
                z[:, :, :P] = t
                big[u][n] = jnp.asarray(z)
        toks = jnp.argmax(logits[:, -1:, :], axis=-1).astype(
            jnp.int32) % cfg.vocab_size
        steps = [np.asarray(toks)]
        for t in range(GEN):
            toks, lg, big = sb.decode_fn(ps, toks, big,
                                         jnp.asarray(_step_len(t)))
            steps.append(np.asarray(toks))
        res[f"{tag}_tokens"] = np.concatenate(steps, axis=1)
        res[f"{tag}_decode_logits"] = np.asarray(lg)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _port_collectives(dist, r, x, res):
    """``all_to_all`` and ``moe_ffn`` on this rank's ring of ``r``."""
    from repro_torch.models import moe

    t = torch.as_tensor
    i = dist.axis_index("model")
    xa = t(x[f"a2a{r}"])[i * r:(i + 1) * r].clone().requires_grad_(True)
    y = dist.all_to_all(xa, "model")
    (g,) = torch.autograd.grad(y, xa, t(x[f"a2a_ct{r}"])[i * r:(i + 1) * r])
    res[f"a2a{r}"], res[f"a2a_grad{r}"] = y.detach().numpy(), g.numpy()

    el = E // r
    ins = [t(x[f"x{r}"])[:, i * XS:(i + 1) * XS], t(x["router"])]
    ins += [t(x[k])[i * el:(i + 1) * el] for k in ("w_up", "w_gate",
                                                    "w_down")]
    ins = [a.clone().requires_grad_(True) for a in ins]
    out = moe.moe_ffn(ins[0], dict(zip(("router", "w_up", "w_gate",
                                        "w_down"), ins[1:])),
                      n_experts=E, top_k=K, act="swiglu", axis="model",
                      axis_size=r, dist=dist)
    dy = t(x[f"dy{r}"])[:, i * XS:(i + 1) * XS]
    grads = torch.autograd.grad((out.y, out.aux_loss), ins,
                                (dy, torch.ones(())))
    res[f"ffn{r}_y"] = out.y.detach().numpy()
    res[f"ffn{r}_aux"] = out.aux_loss.detach().numpy()[None]
    for n, g in zip(("dx", "drouter", "dw_up", "dw_gate", "dw_down"), grads):
        res[f"ffn{r}_{n}"] = g.numpy()[None] if n == "drouter" else g.numpy()


def _port_model(dist, name, shape, res):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.transformer import RunCtx, param_shapes, \
        param_specs
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_loop import (loss_and_grads,
                                              reduce_model_axis_grads,
                                              shard_batch)
    from repro_torch.weights import params_from_jax, shard_params

    cfg = _config(name, get_reduced)
    tag = _tag(name, shape)
    par = ParallelConfig(strategy="tatp", remat=False)
    params = shard_params(params_from_jax(_np_params(param_shapes(cfg)),
                                          cfg, "cpu"), cfg, "tatp", dist)
    batch = {k: torch.as_tensor(v) for k, v in
             shard_batch(cfg, _batch(cfg), dist).items()}
    nll, cnt, grads = loss_and_grads(RunCtx(cfg, par, dist), params, batch)
    grads = reduce_model_axis_grads(grads, param_specs(cfg), par, dist)
    grads = tree_map(lambda g: dist.psum(g, "data"), grads)
    for a in ("data", "model"):
        nll = dist.psum(nll, a)
    res[f"{tag}_loss"] = (nll / cnt).numpy()
    res[f"{tag}_coords"] = np.array(dist.coords)
    for path, g in tree_leaves(grads):
        res[f"{tag}_grad_{'/'.join(path)}"] = g.numpy()
    if name == "olmoe" and shape == (1, 4):
        _port_serve(dist, cfg, params, tag, res)


def _port_serve(dist, cfg, params, tag, res):
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import lm
    from repro_torch.train.train_loop import make_serve_fns

    x = _inputs()
    sb = make_serve_fns(cfg, ParallelConfig(strategy="tatp", remat=False),
                        dist)
    caches, logits = sb.prefill_fn(params, {"tokens": torch.as_tensor(
        x["prompts"])})
    res[f"{tag}_prefill_logits"] = logits.numpy()
    for u, leaves in caches.items():
        res.update({f"{tag}_prefill_{u}.{n}": t.numpy()
                    for n, t in leaves.items()})
    big = lm.graft_cache_slots(lm.init_cache(sb.ctx, B, MAX_SEQ),
                               lm.shard_prompt_cache(sb.ctx, caches,
                                                     MAX_SEQ),
                               slots=range(B))
    toks = logits[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    steps = [toks]
    for t in range(GEN):
        toks, lg, big = sb.decode_fn(params, toks, big,
                                     torch.as_tensor(_step_len(t)))
        steps.append(toks)
    res[f"{tag}_tokens"] = torch.cat(steps, dim=1).numpy()
    res[f"{tag}_decode_logits"] = lg.numpy()


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.core.dist import init_world, make_mesh_dist

    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    x = _inputs()
    res = {}
    dists = {(1, 4): make_mesh_dist((1, 4), "cpu"),
             (2, 2): make_mesh_dist((2, 2), "cpu")}
    _port_collectives(dists[1, 4], 4, x, res)
    _port_collectives(dists[2, 2], 2, x, res)
    res["coords22"] = np.array(dists[2, 2].coords)
    for name, shape in MODELS:
        _port_model(dists[shape], name, shape, res)
    np.savez(Path(out_dir) / f"{rank}.npz", **res)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the fixture: both sides at once
# ---------------------------------------------------------------------------


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _finish(procs, what):
    for name, p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            raise AssertionError(f"{what} {name} timed out")
        assert p.returncode == 0, (
            f"{what} {name} failed:\n{out[-2000:]}\n{err[-4000:]}")


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_moe")
    me = str(Path(__file__).resolve())
    ref = subprocess.Popen(
        [sys.executable, me, "reference", str(d / "ref.npz")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = [(str(rank), subprocess.Popen(
        [sys.executable, me, "port", "4", str(rank), str(d / "store"),
         str(d)], env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for rank in range(4)]
    _finish(ranks, "port rank")
    _finish([("reference", ref)], "the")
    return (dict(np.load(d / "ref.npz")),
            [dict(np.load(d / f"{k}.npz")) for k in range(4)])


def _ring_ranks(ranks, r):
    """(rank's outputs, its index on a ring of ``r``): the (1, 4) mesh's
    ring, or each data row of the (2, 2) mesh."""
    if r == 4:
        return list(zip(ranks, range(4)))
    return [(p, int(p["coords22"][1])) for p in ranks]


def _coords(p, tag):
    return tuple(int(c) for c in p[f"{tag}_coords"])


# ---------------------------------------------------------------------------
# the all-to-all and the FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", RINGS)
def test_all_to_all_and_its_backward_match_lax(ring, r):
    """Each rank's block of ``lax.all_to_all(split_axis=0, concat_axis=0)``
    and of its transpose, bit for bit."""
    ref, ranks = ring
    for p, i in _ring_ranks(ranks, r):
        blk = slice(i * r, (i + 1) * r)
        np.testing.assert_array_equal(p[f"a2a{r}"], ref[f"a2a{r}"][blk])
        np.testing.assert_array_equal(p[f"a2a_grad{r}"],
                                      ref[f"a2a_grad{r}"][blk])


@pytest.mark.parametrize("r", RINGS)
def test_moe_ffn_over_the_ring_matches_reference(ring, r):
    """Capacity 1.25 (tokens drop): each rank's output, its per-rank
    load-balance loss, and the gradients of its tokens, of its router copy
    (its own tokens' part) and of its expert shards (every rank's
    tokens'), at 1e-5."""
    ref, ranks = ring
    for p, i in _ring_ranks(ranks, r):
        for n, dim, blk in (("y", 1, XS), ("dx", 1, XS), ("aux", 0, 1),
                            ("drouter", 0, 1), ("dw_up", 0, E // r),
                            ("dw_gate", 0, E // r), ("dw_down", 0, E // r)):
            want = np.take(ref[f"ffn{r}_{n}"], range(i * blk, (i + 1) * blk),
                           axis=dim)
            np.testing.assert_allclose(p[f"ffn{r}_{n}"], want, err_msg=n,
                                       **TOL)


# ---------------------------------------------------------------------------
# the reduced MoE models
# ---------------------------------------------------------------------------


def _shard_of(want, spec, coords, shape):
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = shape[0 if axis == "data" else 1]
        c = coords[0 if axis == "data" else 1]
        blk = want.shape[dim] // n
        want = np.take(want, range(c * blk, (c + 1) * blk), axis=dim)
    return want


@pytest.mark.parametrize("name,shape", MODELS,
                         ids=[_tag(n, s) for n, s in MODELS])
def test_loss_and_grads_match_reference(ring, name, shape):
    """The global loss and each rank's shard of every gradient leaf (the
    ring-replicated ones psummed over the ring, then every leaf over
    ``data``), at 2e-4."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import param_specs

    ref, ranks = ring
    tag = _tag(name, shape)
    specs = _flat(param_specs(_config(name, get_reduced)))
    for p in ranks:
        c = _coords(p, tag)
        np.testing.assert_allclose(p[f"{tag}_loss"], ref[f"{tag}_loss"],
                                   **MODEL_TOL)
        for path, spec in specs.items():
            key = f"{tag}_grad_{path}"
            np.testing.assert_allclose(
                p[key], _shard_of(ref[key], spec, c, shape), err_msg=path,
                **MODEL_TOL)
            if "mlp.w_" in path:  # the experts' shards did learn
                assert np.abs(p[key]).max() > 0, path


def test_olmoe_serve_matches_reference(ring):
    """Prefill logits and each rank's K/V block; 4 greedy decode steps
    (one replicated token a row, the same two all-to-alls): identical
    tokens and each rank's vocab block of the last logits."""
    ref, ranks = ring
    tag = _tag("olmoe", (1, 4))
    keys = [k for k in ref if k.startswith(f"{tag}_prefill_")
            and not k.endswith("logits")]
    assert keys
    for m, p in enumerate(ranks):
        np.testing.assert_allclose(p[f"{tag}_prefill_logits"],
                                   ref[f"{tag}_prefill_logits"], **MODEL_TOL)
        for key in keys:
            want = ref[key]
            n = want.shape[2] // 4
            np.testing.assert_allclose(p[key], want[:, :, m * n:(m + 1) * n],
                                       err_msg=key, **MODEL_TOL)
        np.testing.assert_array_equal(p[f"{tag}_tokens"], ref[f"{tag}_tokens"])
        want = ref[f"{tag}_decode_logits"]
        v = want.shape[-1] // 4
        np.testing.assert_allclose(p[f"{tag}_decode_logits"],
                                   want[..., m * v:(m + 1) * v], **MODEL_TOL)


# ---------------------------------------------------------------------------
# the entry points under torchrun
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry,flags", [
    ("serve", ["--mesh", "1", "4", "--batch", "4", "--prompt-len", "8",
               "--gen", "3"]),
    ("train", ["--mesh", "2", "2", "--steps", "2", "--batch", "4", "--seq",
               "16"]),
], ids=["serve", "train"])
def test_olmoe_cli_under_torchrun(tmp_path, entry, flags):
    """olmoe's serve at (1, 4) and train at (2, 2) through the entry
    points: rank 0 alone prints the reference's keys."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", f"repro_torch.launch.{entry}",
           "--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", *flags]
    res = subprocess.run(cmd, env=_env(OMP_NUM_THREADS="1"), cwd=tmp_path,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    if entry == "serve":
        assert out["generated_shape"] == [4, 4]
    else:
        assert out["mesh"] == [2, 2] and out["steps"] == 2
        assert np.isfinite(out["last_loss"])


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
