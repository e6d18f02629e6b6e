"""The Mamba-2 block over the TATP ring (model degree above 1) against the
reference on the CPU.

As ``tests/test_torch_ring.py``: the port's ranks are processes joined by
gloo (a ``FileStore`` under the test's temporary directory), the
reference runs ``shard_map`` on 4 fake CPU devices in a subprocess, both
sides run this file as a script on the same seeded numpy inputs
(:func:`_inputs`, :func:`_np_params`) and write numpy outputs:

* ``ring_exclusive_scan`` at R = 2, 3 and 4, both scan modes (``seq``,
  ``log``) and both state wires (``fp32``, ``bf16``), and its cotangents
  against ``jax.vjp``; ``ssd_sequence_sharded`` (the local pass on the
  plain SSD and on the kernel wrapper's plain path) and ``causal_conv1d``
  with its halo at R = 4, forward and ``jax.vjp``: fp32 at 1e-5;
* the reduced mamba2-780m and zamba2-2.7b (``MMS``) serve at (1, 4) and
  (2, 2), two SSD chunks or more a rank: prefill logits, each rank's
  state head block and conv tail (and zamba2's K/V blocks), and 4 greedy
  decode steps at per-row positions, at 2e-4; the ``log`` scan and the
  bf16 state wire on mamba2's prefill;
* 3-step train trajectories of both models at (1, 4) and (2, 2) against
  the reference's, at 2e-4 (every step finishes on every rank: a
  relay whose result a rank drops would leave its inverse hop unmatched);
* on the port's ranks: the bf16 state wire's gradients within the
  reference's 0.05 of the fp32 wire's, the ``log`` scan's within 2e-4 of
  ``seq``'s, and ``tatp_outputs`` bitwise full remat with the local SSD
  run twice a layer under either policy;

and ``launch.serve`` / ``launch.train --mesh`` under
``torch.distributed.run``, and the sequence check that raises before any
collective."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
ARCHS = ("mamba2-780m", "zamba2-2.7b")
MESHES = ((1, 4), (2, 2))
RINGS = (2, 3, 4)
MODES = ("seq", "log")
SCAN_WIRES = ("fp32", "bf16")
# the scan's segments a rank: G [SB, SH, 1, 1], S [SB, SH, SP, SN]
SB, SH, SP, SN = 2, 3, 4, 5
# the sharded SSD at R = 4: batch, per-rank length (two chunks), heads,
# head dim, state
XB, XL, XH, XP, XN, CHUNK = 2, 16, 4, 8, 8, 8
# the conv at R = 4: batch, per-rank length, channels
CB, CS, CC = 2, 6, 12
# the serves: batch, prompt (two chunks of 8 a rank at R = 4), decode
# steps, decode cache length
B, P, GEN, MAX_SEQ = 4, 64, 4, 72
# the trains: batch, sequence, steps
TB, TS, STEPS = 4, 64, 3
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
WIRE_GRAD_TOL = 0.05  # tests/multidevice/check_wire_grads.py:69
TIMEOUT = 300


def _inputs():
    rng = np.random.RandomState(0)
    out = {}
    for r in RINGS:
        out[f"g{r}"] = np.exp(-np.abs(rng.randn(r * SB, SH, 1, 1))) \
            .astype(np.float32)
        out[f"s{r}"] = rng.randn(r * SB, SH, SP, SN).astype(np.float32)
        out[f"cg{r}"] = rng.randn(r * SB, SH, 1, 1).astype(np.float32)
        out[f"cs{r}"] = rng.randn(r * SB, SH, SP, SN).astype(np.float32)
    L = 4 * XL
    out["x"] = rng.randn(XB, L, XH, XP).astype(np.float32)
    out["dt"] = (np.abs(rng.randn(XB, L, XH)) * 0.1 + 0.01) \
        .astype(np.float32)
    out["a"] = -(np.abs(rng.randn(XH)) + 0.1).astype(np.float32)
    out["bm"] = rng.randn(XB, L, XN).astype(np.float32)
    out["cm"] = rng.randn(XB, L, XN).astype(np.float32)
    out["dy"] = rng.randn(XB, L, XH, XP).astype(np.float32)
    out["dst"] = rng.randn(4 * XB, XH, XP, XN).astype(np.float32)
    out["cx"] = rng.randn(CB, 4 * CS, CC).astype(np.float32)
    out["cw"] = rng.randn(4, CC).astype(np.float32)
    out["cb"] = rng.randn(CC).astype(np.float32)
    out["cct"] = rng.randn(CB, 4 * CS, CC).astype(np.float32)
    out["prompts"] = rng.randint(0, 128, (B, P))
    return out


def _step_len(t):
    """Decode step ``t``'s per-row cache_len (rows at different
    positions)."""
    return P + t + 1 + np.arange(B) % 2


def _np_params(shapes, rng=None):
    """Seeded weights for a parameter tree of leaf shapes (sorted walk).
    The SSM's ``a_log``, ``dt_bias`` and ``d_skip`` follow the models'
    own init (``a = -linspace(1, 16)``, dt in [1e-3, 1e-1], skip 1): with
    normal draws a chunk's decay exponent can pass 88, where the
    reference's gradient is NaN (its ``where`` after the ``exp``,
    ROADMAP.md C) and the port's is finite."""
    rng = rng or np.random.RandomState(1)
    out = {}
    for k in sorted(shapes):
        v = shapes[k]
        if isinstance(v, dict):
            out[k] = _np_params(v, rng)
            continue
        if k == "a_log":
            a = np.broadcast_to(np.log(np.linspace(1.0, 16.0, v[-1])), v)
        elif k == "dt_bias":
            lo, hi = np.log(1e-3), np.log(1e-1)
            a = np.log(np.expm1(np.exp(lo + (hi - lo) * rng.rand(*v))))
        elif k == "d_skip":
            a = np.ones(v)
        else:
            scale = 0.1 if k.endswith("ln") else (
                1.0 if k == "embed" else 1.0 / np.sqrt(v[-2]))
            a = rng.randn(*v) * scale
        out[k] = np.ascontiguousarray(a, dtype=np.float32)
    return out


def _tag(arch, shape):
    return f"{arch}_{shape[0]}x{shape[1]}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# the prefill variants on mamba2 at (1, 4): (tag, scan mode, state wire)
VARIANTS = (("log", "log", "fp32"), ("bf16", "seq", "bf16"))


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Ps

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.core.dist import Dist, make_mesh
    from repro.models import ssm
    from repro.models.transformer import param_shapes
    from repro.train.data import SyntheticDataset
    from repro.train.train_loop import make_serve_fns, make_train_step

    x = _inputs()
    res = {}
    devs = jax.devices()
    assert len(devs) == 4, devs

    def smap(f, mesh, ins, outs):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=ins,
                                     out_specs=outs, check_vma=False))

    m0, seq, rep = Ps("model"), Ps(None, "model"), Ps()
    for r in RINGS:
        mesh = make_mesh((r,), ("model",), devices=devs[:r])

        def scan(g, s, cg, cs, r=r):
            outs = []
            for mode in MODES:
                for wire in SCAN_WIRES:
                    y, vjp = jax.vjp(lambda a, b: ssm.ring_exclusive_scan(
                        (a, b), "model", r, mode, wire), g, s)
                    outs += [*y, *vjp((cg, cs))]
            return tuple(outs)

        n = 4 * len(MODES) * len(SCAN_WIRES)
        outs = smap(scan, mesh, (m0,) * 4, (m0,) * n)(
            x[f"g{r}"], x[f"s{r}"], x[f"cg{r}"], x[f"cs{r}"])
        for k, y in enumerate(outs):
            res[f"scan{r}_{k}"] = np.asarray(y)

    mesh4 = make_mesh((4,), ("model",), devices=devs)

    def ssd_sharded(xx, dt, a, bm, cm, dy, dst):
        outs = []
        for mode in MODES:
            for wire in SCAN_WIRES:
                y, vjp = jax.vjp(lambda *ins: ssm.ssd_sequence_sharded(
                    *ins, CHUNK, axis="model", axis_size=4, scan_mode=mode,
                    wire=wire), xx, dt, a, bm, cm)
                outs += [*y, *vjp((dy, dst))]
        return tuple(outs)

    per = (seq, m0, seq, seq, m0, seq, seq)
    outs = smap(ssd_sharded, mesh4, (seq, seq, rep, seq, seq, seq, m0),
                per * len(MODES) * len(SCAN_WIRES))(
        x["x"], x["dt"], x["a"], x["bm"], x["cm"], x["dy"], x["dst"])
    for k, y in enumerate(outs):
        res[f"ssd_{k}"] = np.asarray(y)

    def conv(xx, w, b, ct):
        y, vjp = jax.vjp(lambda *ins: ssm.causal_conv1d(
            *ins, axis="model", axis_size=4), xx, w, b)
        dx, dw, db = vjp(ct)
        return y, dx, dw[None], db[None]

    outs = smap(conv, mesh4, (seq, rep, rep, seq), (seq, seq, m0, m0))(
        x["cx"], x["cw"], x["cb"], x["cct"])
    for k, y in enumerate(outs):
        res[f"conv_{k}"] = np.asarray(y)

    # the reduced models' serves and trains, from the same weights
    for arch in ARCHS:
        cfg = get_reduced(arch)
        shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
        np_params = _np_params(shapes)
        for shape in MESHES:
            dist = Dist(make_mesh(shape, ("data", "model"), devices=devs))
            runs = [("", ParallelConfig(strategy="tatp", remat=False))]
            if arch == ARCHS[0] and shape == MESHES[0]:
                runs += [(v, ParallelConfig(strategy="tatp", remat=False,
                                            ssm_scan_mode=mode,
                                            ssm_state_wire=wire))
                         for v, mode, wire in VARIANTS]
            for variant, par in runs:
                tag = _tag(arch, shape) + variant
                params = jax.tree.map(jnp.asarray, np_params)
                sb = make_serve_fns(cfg, par, dist,
                                    ShapeConfig("s", "decode", MAX_SEQ, B))
                caches, logits = sb.prefill_fn(
                    params, {"tokens": jnp.asarray(x["prompts"])})
                res[f"{tag}_prefill_logits"] = np.asarray(logits)
                for u, leaves in caches.items():
                    for nm, t in leaves.items():
                        res[f"{tag}_prefill_{u}.{nm}"] = np.asarray(t)
                if variant:
                    continue
                big = {}
                for u, leaves in caches.items():
                    big[u] = {}
                    for nm, t in leaves.items():
                        t = np.asarray(t)
                        if nm in ("k", "v"):  # the prompt into max_seq
                            z = np.zeros(t.shape[:2] + (MAX_SEQ,)
                                         + t.shape[3:], t.dtype)
                            z[:, :, :P] = t
                            t = z
                        big[u][nm] = jnp.asarray(t)
                toks = jnp.argmax(logits[:, -1:, :], axis=-1).astype(
                    jnp.int32) % cfg.vocab_size
                steps = [np.asarray(toks)]
                for t in range(GEN):
                    toks, lg, big = sb.decode_fn(params, toks, big,
                                                 jnp.asarray(_step_len(t)))
                    steps.append(np.asarray(toks))
                res[f"{tag}_tokens"] = np.concatenate(steps, axis=1)
                res[f"{tag}_decode_logits"] = np.asarray(lg)
                for u, leaves in big.items():
                    for nm, t in leaves.items():
                        res[f"{tag}_decode_{u}.{nm}"] = np.asarray(t)

            # three train steps
            tag = _tag(arch, shape)
            tshape = ShapeConfig("t", "train", TS, TB)
            tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                     remat=False), dist,
                                 tshape)
            params = jax.tree.map(jnp.asarray, np_params)
            opt_init = jax.jit(jax.shard_map(
                tb.opt.init, mesh=dist.mesh, in_specs=(tb.pspecs,),
                out_specs=tb.ospecs, check_vma=False))
            state = opt_init(params)
            data = SyntheticDataset(cfg, tshape, dist)
            for step in range(STEPS):
                params, state, m = tb.step_fn(params, state,
                                              data.batch(step, tb.bspecs))
                for k in ("loss", "tokens", "grad_norm"):
                    res[f"{tag}_train_{k}{step}"] = np.asarray(m[k])
            for path, leaf in _flat(params).items():
                res[f"{tag}_train_p_{path}"] = np.asarray(leaf)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _grad_of(fn, inputs, cts):
    """(fn(*inputs), d<fn . cts>/d inputs) by autograd; ``fn`` returns a
    tensor or a tuple, ``cts`` matches it."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    ys = y if isinstance(y, tuple) else (y,)
    cts = cts if isinstance(cts, tuple) else (cts,)
    gs = torch.autograd.grad(ys, leaves, cts)
    return tuple(t.detach() for t in ys), gs


def _port_scan(dist, r, x, res):
    from repro_torch.models import ssm

    t = torch.as_tensor
    i = dist.axis_index("model")
    g, s, cg, cs = (t(x[f"{n}{r}"])[i * SB:(i + 1) * SB]
                    for n in ("g", "s", "cg", "cs"))
    k = 0
    for mode in MODES:
        for wire in SCAN_WIRES:
            ys, gs = _grad_of(lambda a, b: ssm.ring_exclusive_scan(
                (a, b), "model", r, mode, wire, dist=dist), [g, s],
                (cg, cs))
            for y in (*ys, *gs):
                res[f"scan{r}_{k}"] = y.numpy()
                k += 1


def _port_ssd_and_conv(dist, x, res):
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import ssm

    t = torch.as_tensor
    i = dist.axis_index("model")

    def blk(a, n):
        return t(a)[:, i * n:(i + 1) * n]

    ins = [blk(x["x"], XL), blk(x["dt"], XL), t(x["a"]), blk(x["bm"], XL),
           blk(x["cm"], XL)]
    cts = (blk(x["dy"], XL), t(x["dst"])[i * XB:(i + 1) * XB])
    for hook, fn in (("plain", ssm.ssd_chunked), ("kernel",
                                                  ssd_ops.ssd_chunked)):
        k = 0
        for mode in MODES:
            for wire in SCAN_WIRES:
                ys, gs = _grad_of(lambda *a: ssm.ssd_sequence_sharded(
                    *a, CHUNK, axis="model", axis_size=4, scan_mode=mode,
                    wire=wire, dist=dist, ssd=fn), ins, cts)
                for y in (*ys, *gs):
                    res[f"ssd_{hook}_{k}"] = y.numpy()
                    k += 1
    ys, (dx, dw, db) = _grad_of(lambda *a: ssm.causal_conv1d(
        *a, axis="model", axis_size=4, dist=dist),
        [blk(x["cx"], CS), t(x["cw"]), t(x["cb"])], blk(x["cct"], CS))
    for k, y in enumerate((ys[0], dx, dw, db)):
        res[f"conv_{k}"] = y.numpy()


def _port_serve(dist, x, arch, shape, np_params, res):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import lm
    from repro_torch.train.train_loop import batch_rows, make_serve_fns
    from repro_torch.weights import params_from_jax, shard_params

    cfg = get_reduced(arch)
    params = shard_params(params_from_jax(np_params, cfg, "cpu"), cfg,
                          "tatp", dist)
    runs = [("", ParallelConfig(strategy="tatp", remat=False))]
    if arch == ARCHS[0] and shape == MESHES[0]:
        runs += [(v, ParallelConfig(strategy="tatp", remat=False,
                                    ssm_scan_mode=mode,
                                    ssm_state_wire=wire))
                 for v, mode, wire in VARIANTS]
    for variant, par in runs:
        tag = _tag(arch, shape) + variant
        sb = make_serve_fns(cfg, par, dist)
        caches, logits = sb.prefill_fn(
            params, {"tokens": torch.as_tensor(x["prompts"])})
        res[f"{tag}_prefill_logits"] = logits.numpy()
        for u, leaves in caches.items():
            for n, t in leaves.items():
                res[f"{tag}_prefill_{u}.{n}"] = t.numpy()
        if variant:
            continue
        rows = len(range(B)[batch_rows(dist, B)])
        big = lm.graft_cache_slots(
            lm.init_cache(sb.ctx, rows, MAX_SEQ),
            lm.shard_prompt_cache(sb.ctx, caches, MAX_SEQ),
            slots=range(rows))
        toks = logits[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
        steps = [toks]
        for t in range(GEN):
            toks, lg, big = sb.decode_fn(params, toks, big,
                                         torch.as_tensor(_step_len(t)))
            steps.append(toks)
        res[f"{tag}_tokens"] = torch.cat(steps, dim=1).numpy()
        res[f"{tag}_decode_logits"] = lg.numpy()
        for u, leaves in big.items():
            for n, t in leaves.items():
                res[f"{tag}_decode_{u}.{n}"] = t.numpy()


def _port_train(dist, arch, shape, np_params, res):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.weights import params_from_jax, shard_params

    tag = _tag(arch, shape)
    cfg = get_reduced(arch)
    tshape = ShapeConfig("t", "train", TS, TB)
    tb = make_train_step(cfg, ParallelConfig(strategy="tatp", remat=False),
                         dist, tshape)
    params = shard_params(params_from_jax(np_params, cfg, "cpu"), cfg,
                          "tatp", dist)
    state = tb.opt.init(params)
    data = SyntheticDataset(cfg, tshape, dist)
    for step in range(STEPS):
        params, state, m = tb.step_fn(params, state, data.batch(step))
        for k in ("loss", "tokens", "grad_norm"):
            res[f"{tag}_train_{k}{step}"] = m[k].numpy()
    res[f"{tag}_coords"] = np.array(dist.coords)
    for path, leaf in _flat(params).items():
        res[f"{tag}_train_p_{path}"] = leaf.numpy()


def _port_grads(dist, arch, np_params, res):
    """The gradients of one step's loss at (1, 4) under the fp32 and the
    bf16 state wire, the ``log`` scan, and full remat against
    ``tatp_outputs``, each with its count of local SSD passes."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.transformer import RunCtx, param_specs
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import (loss_and_grads,
                                              reduce_model_axis_grads)
    from repro_torch.weights import params_from_jax, shard_params

    cfg = get_reduced(arch)
    params = shard_params(params_from_jax(np_params, cfg, "cpu"), cfg,
                          "tatp", dist)
    batch = SyntheticDataset(cfg, ShapeConfig("t", "train", TS, TB),
                             dist).batch(0)
    calls = [0]

    def ssd(*a, **kw):
        calls[0] += 1
        return ssd_ops.ssd_chunked(*a, **kw)

    out = {}
    runs = {"fp32": {}, "bf16": dict(ssm_state_wire="bf16"),
            "log": dict(ssm_scan_mode="log"),
            "full": dict(remat=True, remat_policy="full"),
            "tatp_outputs": dict(remat=True, remat_policy="tatp_outputs")}
    if arch != ARCHS[0]:
        runs = {k: runs[k] for k in ("full", "tatp_outputs")}
    for name, kw in runs.items():
        par = ParallelConfig(strategy="tatp", **dict(dict(remat=False), **kw))
        calls[0] = 0
        nll, cnt, grads = loss_and_grads(
            RunCtx(cfg, par, dist, phase="train", ssd=ssd), params, batch)
        grads = reduce_model_axis_grads(grads, param_specs(cfg), par, dist)
        out[name] = (nll, dict(tree_leaves(grads)))
        res[f"{arch}_ssd_calls_{name}"] = np.array(calls[0])
    pre = f"{arch}_grads_"
    ref = out.get("fp32")
    for name, (nll, g) in out.items():
        if name in ("fp32", "tatp_outputs"):
            continue
        base = ref if name in ("bf16", "log") else out["tatp_outputs"]
        worst = max(float((g[k] - base[1][k]).abs().max()
                          / max(float(base[1][k].abs().max()), 1e-4))
                    for k in g)
        res[f"{pre}{name}_worst"] = np.array(worst)
        res[f"{pre}{name}_norm_ratio"] = np.array(float(
            torch.sqrt(sum((v ** 2).sum() for v in g.values()))
            / torch.sqrt(sum((v ** 2).sum() for v in base[1].values()))))
        res[f"{pre}{name}_bitwise"] = np.array(
            bool(torch.equal(nll, base[0]))
            and all(torch.equal(g[k], base[1][k]) for k in g))


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.core.dist import init_world, make_mesh_dist
    from repro_torch.models.transformer import param_shapes

    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    x = _inputs()
    res = {}
    if world == 3:
        _port_scan(make_mesh_dist((1, 3), "cpu"), 3, x, res)
    else:
        d14, d22 = make_mesh_dist((1, 4), "cpu"), make_mesh_dist((2, 2),
                                                                 "cpu")
        _port_scan(d14, 4, x, res)
        _port_scan(d22, 2, x, res)
        res["coords22"] = np.array(d22.coords)
        _port_ssd_and_conv(d14, x, res)
        for arch in ARCHS:
            np_params = _np_params(param_shapes(get_reduced(arch)))
            for shape, dist in zip(MESHES, (d14, d22)):
                _port_serve(dist, x, arch, shape, np_params, res)
                _port_train(dist, arch, shape, np_params, res)
            _port_grads(d14, arch, np_params, res)
    np.savez(Path(out_dir) / f"{world}-{rank}.npz", **res)
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
    d = tmp_path_factory.mktemp("ring_ssm")
    me = str(Path(__file__).resolve())
    ref = subprocess.Popen(
        [sys.executable, me, "reference", str(d / "ref.npz")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = []
    for world in (4, 3):
        store = d / f"store{world}"
        for rank in range(world):
            ranks.append((f"{world}-{rank}", subprocess.Popen(
                [sys.executable, me, "port", str(world), str(rank),
                 str(store), str(d)], env=_env(),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _finish(ranks, "port rank")
    _finish([("reference", ref)], "the")
    port = {name: dict(np.load(d / f"{name}.npz")) for name, _ in ranks}
    return dict(np.load(d / "ref.npz")), port


def _ranks(port, world=4):
    return [port[f"{world}-{k}"] for k in range(world)]


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


# ---------------------------------------------------------------------------
# the scan, the sharded SSD and the conv halo
# ---------------------------------------------------------------------------


def _scan_index(mode, wire):
    """Where (mode, wire)'s four outputs (ge, se, dg, ds) start."""
    return 4 * (MODES.index(mode) * len(SCAN_WIRES) + SCAN_WIRES.index(wire))


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wire", SCAN_WIRES)
def test_ring_exclusive_scan_and_cotangents_match_jax_vjp(ring, r, mode,
                                                          wire):
    """(ge, se) and the cotangents of (g, s); each rank's block."""
    ref, port = ring
    k0 = _scan_index(mode, wire)
    for j, what in enumerate(("ge", "se", "dg", "ds")):
        key = f"scan{r}_{k0 + j}"
        want = ref[key]
        if r == 2:  # the (2, 2) mesh: each data row is a ring of two
            for p in _ranks(port):
                m = p["coords22"][1]
                _close(p[key], want[m * SB:(m + 1) * SB], TOL, what)
            continue
        got = np.concatenate([p[key] for p in _ranks(port, r)], axis=0)
        _close(got, want, TOL, what)
    # rank 0's exclusive prefix is the identity
    p0 = _ranks(port, r)[0] if r != 2 else next(
        p for p in _ranks(port) if p["coords22"][1] == 0)
    np.testing.assert_array_equal(p0[f"scan{r}_{k0}"], 1.0)
    np.testing.assert_array_equal(p0[f"scan{r}_{k0 + 1}"], 0.0)


@pytest.mark.parametrize("hook", ["plain", "kernel"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wire", SCAN_WIRES)
def test_ssd_sequence_sharded_matches_reference(ring, hook, mode, wire):
    """y and the state after each rank's block, and the gradients of x,
    dt, a (each rank's part), B and C, at R = 4: the local pass on the
    plain SSD and on the kernel wrapper (its plain path here)."""
    ref, port = ring
    k0 = 7 * (MODES.index(mode) * len(SCAN_WIRES) + SCAN_WIRES.index(wire))
    names = ("y", "state", "dx", "ddt", "da", "dB", "dC")
    dims = (1, 0, 1, 1, 0, 1, 1)
    for j, (what, dim) in enumerate(zip(names, dims)):
        got = np.concatenate([p[f"ssd_{hook}_{k0 + j}"]
                              for p in _ranks(port)], axis=dim)
        _close(got, ref[f"ssd_{k0 + j}"], TOL, what)


def test_causal_conv1d_halo_matches_reference(ring):
    """Each rank's conv output from the rank before's K - 1 inputs, and
    the gradients (the halo's cotangent back to its sender)."""
    ref, port = ring
    for k, (what, dim) in enumerate((("y", 1), ("dx", 1), ("dw", 0),
                                     ("db", 0))):
        parts = [p[f"conv_{k}"] for p in _ranks(port)]
        if dim == 0:
            parts = [a[None] for a in parts]
        _close(np.concatenate(parts, axis=dim), ref[f"conv_{k}"], TOL, what)


# ---------------------------------------------------------------------------
# the reduced models' serves and trains on (1, 4) and (2, 2)
# ---------------------------------------------------------------------------


def _block(a, coords, shape, axis):
    """The reference's global cache leaf ``a``'s block on the rank at
    ``coords``: rows (axis 1) over data, ``axis`` (or None) over model."""
    d, m = coords
    nd, nm = shape
    rows = a.shape[1] // nd
    a = a[:, d * rows:(d + 1) * rows]
    if axis is not None:
        n = a.shape[axis] // nm
        a = np.take(a, range(m * n, (m + 1) * n), axis=axis)
    return a


def _rank_coords(ranks, shape):
    if shape == (1, 4):
        return [(0, k) for k in range(4)]
    return [tuple(p["coords22"]) for p in ranks]


def _cache_axis(key):
    """A cache leaf's axis over model: the state's heads, the K/V's
    sequence; the conv tail is replicated."""
    leaf = key.rsplit(".", 1)[1]
    return {"state": 2, "k": 2, "v": 2, "conv": None}[leaf]


def _cache_keys(res, tag, phase):
    pre = f"{tag}_{phase}_"
    keys = [k for k in res if k.startswith(pre) and k != pre + "logits"]
    assert keys, f"no {phase} cache for {tag}"
    return keys


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_prefill_matches_reference(ring, arch, shape):
    """Logits gathered over both axes; each rank's state head block,
    conv tail and (zamba2) K/V block."""
    ref, port = ring
    tag = _tag(arch, shape)
    ranks = _ranks(port)
    keys = _cache_keys(ranks[0], tag, "prefill")
    assert any(k.endswith(".state") for k in keys)
    for p, c in zip(ranks, _rank_coords(ranks, shape)):
        _close(p[f"{tag}_prefill_logits"], ref[f"{tag}_prefill_logits"],
               MODEL_TOL, "prefill logits")
        for key in keys:
            _close(p[key], _block(ref[key], c, shape, _cache_axis(key)),
                   MODEL_TOL, key)


@pytest.mark.parametrize("variant", [v for v, _, _ in VARIANTS])
def test_prefill_scan_mode_and_state_wire_match_reference(ring, variant):
    """mamba2's prefill at (1, 4) under the ``log`` scan and the bf16
    state wire against the reference's under the same settings."""
    ref, port = ring
    shape = MESHES[0]
    tag = _tag(ARCHS[0], shape) + variant
    ranks = _ranks(port)
    for p, c in zip(ranks, _rank_coords(ranks, shape)):
        _close(p[f"{tag}_prefill_logits"], ref[f"{tag}_prefill_logits"],
               MODEL_TOL, "prefill logits")
        for key in _cache_keys(p, tag, "prefill"):
            _close(p[key], _block(ref[key], c, shape, _cache_axis(key)),
                   MODEL_TOL, key)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_decode_steps_match_reference(ring, arch, shape):
    """4 greedy steps at per-row positions: identical tokens, each rank's
    logits block (its rows and vocab block) and cache block (the updated
    state head block, the conv tail)."""
    ref, port = ring
    tag = _tag(arch, shape)
    ranks = _ranks(port)
    for p, (d, m) in zip(ranks, _rank_coords(ranks, shape)):
        np.testing.assert_array_equal(p[f"{tag}_tokens"],
                                      ref[f"{tag}_tokens"])
        want = ref[f"{tag}_decode_logits"]
        rows, v = want.shape[0] // shape[0], want.shape[-1] // shape[1]
        _close(p[f"{tag}_decode_logits"],
               want[d * rows:(d + 1) * rows, :, m * v:(m + 1) * v],
               MODEL_TOL, "decode logits")
        for key in _cache_keys(p, tag, "decode"):
            _close(p[key], _block(ref[key], (d, m), shape, _cache_axis(key)),
                   MODEL_TOL, key)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_train_trajectory_matches_reference(ring, arch, shape):
    """Every step finished on every rank (the relays' inverse hops all
    met); each step's loss and token count, the grad norm on the ranks at
    model index 0 (the reference's metric is device 0's), and each rank's
    parameter shards after the third step, at 2e-4."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import param_specs

    ref, port = ring
    tag = _tag(arch, shape)
    specs = _flat(param_specs(get_reduced(arch)))
    for p in _ranks(port):
        coords = tuple(p[f"{tag}_coords"])
        keys = ("loss", "grad_norm") if coords[1] == 0 else ("loss",)
        for step in range(STEPS):
            for k in keys:
                _close(p[f"{tag}_train_{k}{step}"],
                       ref[f"{tag}_train_{k}{step}"], MODEL_TOL,
                       f"{k} {step}")
            assert p[f"{tag}_train_tokens{step}"] == TB * TS
        for path, spec in specs.items():
            want = ref[f"{tag}_train_p_{path}"]
            for dim, axis in enumerate(spec):
                if axis is None:
                    continue
                n = shape[0 if axis == "data" else 1]
                c = coords[0 if axis == "data" else 1]
                blk = want.shape[dim] // n
                want = np.take(want, range(c * blk, (c + 1) * blk), axis=dim)
            _close(p[f"{tag}_train_p_{path}"], want, MODEL_TOL, path)


# ---------------------------------------------------------------------------
# the state wire, the scan modes and the remat policies (the port's ranks)
# ---------------------------------------------------------------------------


def test_bf16_state_wire_gradients_stay_close(ring):
    """The reference's own bar for its bf16 state wire
    (``tests/multidevice/check_wire_grads.py``): the worst leaf's largest
    difference over its largest value below 0.05, the gradient norm
    within 5 %."""
    _, port = ring
    for p in _ranks(port):
        pre = f"{ARCHS[0]}_grads_bf16"
        assert p[f"{pre}_worst"] < WIRE_GRAD_TOL, p[f"{pre}_worst"]
        assert 0.95 < p[f"{pre}_norm_ratio"] < 1.05
        assert not p[f"{pre}_bitwise"]  # the wire did round


def test_log_scan_gradients_match_seq(ring):
    _, port = ring
    for p in _ranks(port):
        assert p[f"{ARCHS[0]}_grads_log_worst"] < 2e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_tatp_outputs_is_bitwise_full_remat(ring, arch):
    """One step's loss and every gradient leaf bitwise; the recompute
    replays the conv halo and the scan hops, so the local SSD runs twice
    a Mamba-2 layer under either policy (once without remat)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced

    cfg = get_reduced(arch)
    m_layers = cfg.n_layers * cfg.layer_pattern.count("M") \
        // len(cfg.layer_pattern)
    _, port = ring
    for p in _ranks(port):
        assert bool(p[f"{arch}_grads_full_bitwise"])
        for pol in ("full", "tatp_outputs"):
            assert p[f"{arch}_ssd_calls_{pol}"] == 2 * m_layers
        if arch == ARCHS[0]:
            assert p[f"{arch}_ssd_calls_fp32"] == m_layers


# ---------------------------------------------------------------------------
# the entry points under torchrun, and the sequence check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mesh", [(ARCHS[0], (1, 4)),
                                       (ARCHS[1], (2, 2))])
def test_serve_cli_under_torchrun(tmp_path, arch, mesh):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
           "--arch", arch, "--reduced", "--device", "cpu", "--mesh",
           *map(str, mesh), "--batch", "4", "--prompt-len", "32", "--gen",
           "3"]
    res = subprocess.run(cmd, env=_env(OMP_NUM_THREADS="1"), cwd=tmp_path,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert out["generated_shape"] == [4, 4]


@pytest.mark.parametrize("arch,mesh", [(ARCHS[0], (2, 2)),
                                       (ARCHS[1], (1, 4))])
def test_train_cli_under_torchrun(tmp_path, arch, mesh):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", arch, "--reduced", "--device", "cpu", "--mesh",
           *map(str, mesh), "--steps", "2", "--batch", "4", "--seq", "32"]
    res = subprocess.run(cmd, env=_env(OMP_NUM_THREADS="1"), cwd=tmp_path,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert out["steps"] == 2 and out["mesh"] == list(mesh)
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_sequence_not_whole_chunks_a_rank_raises_before_any_collective():
    """A Mamba-2 model's sequence must be a multiple of the ring degree
    times ``ssm_chunk``; the check raises in :func:`shard_batch` (every
    prefill and train batch passes it) on a mesh without process groups,
    so no collective ran.  A dense model needs only the ring degree."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.dist import Dist
    from repro_torch.train.train_loop import (check_prompt_len,
                                              make_serve_fns, shard_batch)

    dist = Dist(torch.device("cpu"), mesh_shape=(1, 4))
    for arch in ARCHS:
        cfg = get_reduced(arch)
        batch = {"tokens": torch.zeros(2, 48, dtype=torch.long),
                 "labels": torch.zeros(2, 48, dtype=torch.long)}
        with pytest.raises(ValueError, match=r"chunk size 8 .*ring degree 4, "
                                             r"32"):
            shard_batch(cfg, batch, dist)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            make_serve_fns(cfg, ParallelConfig(), dist).prefill_fn(None,
                                                                   batch)
        check_prompt_len(dist, 64, cfg)
    check_prompt_len(dist, 48, get_reduced("deepseek-7b"))


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
