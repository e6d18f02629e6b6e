"""``megatron`` above model degree 1 against the reference on the CPU.

As ``tests/test_torch_ring.py``: the port's ranks are processes joined by
gloo (a ``FileStore`` under the test's temporary directory), the reference
runs ``shard_map`` on 4 fake CPU devices in a subprocess, both sides run
this file as a script on the same seeded weights (:func:`_np_params`) and
the same synthetic batches (the reference's LCG stream, each rank taking
its rows; the sequence replicated over ``model``), and write numpy
outputs.  For the reduced deepseek-7b (4 kv heads, replicated; and 16,
column-parallel), gemma-7b, gemma2-9b, qwen2-72b (QKV bias),
internvl2-1b (vision prefix) and seamless-m4t-large-v2 (encoder-decoder),
each with 4 kv heads or more, at the meshes (1, 4) and (2, 2):

* the loss against the reference's ``megatron`` loss under ``shard_map``,
  at 2e-5;
* every gradient leaf (each rank's shard, after the train step's
  bookkeeping and a psum over ``data``) against the reference's
  *degree-1* ``jax.grad`` of the same weights and batch, at 1e-5: the
  reference's own sharded gradients are R times too large on sharded
  leaves and wrong on replicated ones (ROADMAP.md C), so the port holds
  to the degree-1 ones;
* 3-step trajectories with the clip off (each rank clips by its own
  shards' norm, as the reference does) against the reference's degree-1
  ``make_train_step``, at 2e-4;
* at (1, 4), the prefill's logits and each rank's cache block (its kv
  heads) against the reference's ``megatron`` ``prefill_fn`` per device;

and at (1, 4) on the port's ranks, full remat and ``tatp_outputs`` give
bitwise the same loss and gradients; ``launch.train --strategy megatron
--mesh 1 4`` runs under ``torch.distributed.run``; and for each path the
reference itself cannot run, the reference on fake devices raises and the
port raises naming ROADMAP.md C5 before any collective."""

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
ARCHS = ("deepseek-7b", "deepseek-7b-kv16", "gemma-7b", "gemma2-9b",
         "qwen2-72b", "internvl2-1b", "seamless-m4t-large-v2")
MESHES = ((1, 4), (2, 2))
B, S, STEPS = 4, 16, 3
CLIP_OFF = 1e9
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=2e-4, atol=2e-4)
# the paths the reference cannot run: (name, arch, strategy, what runs)
C5_PATHS = (("fsdp", "deepseek-7b", "fsdp", "loss"),
            ("decode", "deepseek-7b", "megatron", "decode"),
            ("kv2", "deepseek-7b-kv2", "megatron", "loss"),
            ("moe", "olmoe-1b-7b", "megatron", "loss"),
            ("mamba", "mamba2-780m", "megatron", "loss"))
TIMEOUT = 300


def _config(name, reduced):
    """The reduced config ``name`` stands for (``reduced``: the package's
    ``get_reduced``).  Reduced gemma2-9b, qwen2-72b and internvl2-1b have
    2 kv heads, fewer than the ring's 4 ranks (a C5 path); they take
    ``tests/multidevice/check_model.py``'s 4, as the probes did."""
    if name == "deepseek-7b-kv16":
        return replace(reduced("deepseek-7b"), n_heads=16, n_kv_heads=16,
                       d_head=4)
    if name == "deepseek-7b-kv2":
        return replace(reduced("deepseek-7b"), n_kv_heads=2)
    cfg = reduced(name)
    if 0 < cfg.n_kv_heads < 4:
        cfg = replace(cfg, n_kv_heads=4)
    return cfg


def _np_params(shapes, rng=None):
    """Seeded weights for a parameter tree of leaf shapes (sorted walk)."""
    rng = rng or np.random.RandomState(1)
    out = {}
    for k in sorted(shapes):
        v = shapes[k]
        if isinstance(v, dict):
            out[k] = _np_params(v, rng)
            continue
        if k == "a_log":  # the SSM's own init (only the C5 probe runs it)
            a = np.broadcast_to(np.log(np.linspace(1.0, 16.0, v[-1])), v)
        else:
            scale = 0.1 if k.endswith("ln") or len(v) == 1 else (
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
    from repro.models import lm
    from repro.models.transformer import RunCtx, param_shapes, param_specs
    from repro.train.data import SyntheticDataset
    from repro.train.optimizer import AdamWConfig
    from repro.train.train_loop import (batch_specs, cache_shapes,
                                        make_serve_fns, make_train_step,
                                        token_axes)

    devs = jax.devices()
    assert len(devs) == 4, devs
    res = {}
    shape_t = ShapeConfig("t", "train", S, B)
    shape_s = ShapeConfig("s", "decode", S + 4, B)
    tatp = ParallelConfig(strategy="tatp", remat=False)
    meg = ParallelConfig(strategy="megatron", remat=False)
    d1 = Dist(make_mesh((1, 1), ("data", "model"), devices=devs[:1]))

    def placed(dist, params, specs):
        return jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(dist.mesh, s), specs))

    def sharded_loss(cfg, par, dist, params, step=0):
        """The reference's loss on ``dist`` under ``par`` (check_megatron's
        harness)."""
        ctx = RunCtx(cfg, par, dist)
        pspecs = param_specs(cfg, par.strategy)
        bspecs = batch_specs(cfg, shape_t, par, dist)
        batch = SyntheticDataset(cfg, shape_t, dist).batch(step, bspecs)
        tax = token_axes(par, dist)

        def local(p, bt):
            nll, cnt, _ = lm.loss_fn(ctx, p, bt)
            for a in tax:
                nll, cnt = lax.psum(nll, a), lax.psum(cnt, a)
            return nll / cnt

        return jax.jit(jax.shard_map(
            local, mesh=dist.mesh, in_specs=(pspecs, bspecs), out_specs=Ps(),
            check_vma=False))(placed(dist, params, pspecs), batch)

    for arch in ARCHS:
        cfg = _config(arch, get_reduced)
        shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
        np_params = _np_params(shapes)
        params = jax.tree.map(jnp.asarray, np_params)

        # the degree-1 gradient of the loss on the whole batch
        ctx1 = RunCtx(cfg, tatp, d1)
        batch1 = SyntheticDataset(cfg, shape_t, d1).batch(
            0, batch_specs(cfg, shape_t, tatp, d1))

        def loss1(p):
            nll, cnt, _ = lm.loss_fn(ctx1, p, batch1)
            return nll / cnt

        loss, grads = jax.value_and_grad(loss1)(params)
        res[f"{arch}_loss1"] = np.asarray(loss)
        for path, g in _flat(grads).items():
            res[f"{arch}_grad_{path}"] = np.asarray(g)

        for shape in MESHES:
            dist = Dist(make_mesh(shape, ("data", "model"), devices=devs))
            res[f"{_tag(arch, shape)}_loss"] = np.asarray(
                sharded_loss(cfg, meg, dist, params))

        # three degree-1 steps, the clip off
        tb = make_train_step(cfg, tatp, d1, shape_t,
                             AdamWConfig(grad_clip=CLIP_OFF))
        p = jax.tree.map(jnp.asarray, np_params)
        state = jax.jit(jax.shard_map(
            tb.opt.init, mesh=d1.mesh, in_specs=(tb.pspecs,),
            out_specs=tb.ospecs, check_vma=False))(p)
        data = SyntheticDataset(cfg, shape_t, d1)
        for step in range(STEPS):
            p, state, m = tb.step_fn(p, state, data.batch(step, tb.bspecs))
            res[f"{arch}_traj_loss{step}"] = np.asarray(m["loss"])
        for path, leaf in _flat(p).items():
            res[f"{arch}_traj_p_{path}"] = np.asarray(leaf)

        # the megatron prefill at (1, 4), each device's blocks
        dist = Dist(make_mesh((1, 4), ("data", "model"), devices=devs))
        sb = make_serve_fns(cfg, meg, dist, shape_s)
        host = SyntheticDataset(cfg, shape_t, dist)
        pb = {k: v for k, v in host.batch(0, sb.bspecs["prefill"]).items()
              if k != "labels"}
        caches, logits = sb.prefill_fn(
            placed(dist, params, sb.pspecs), pb)
        tag = _tag(arch, (1, 4))
        res[f"{tag}_prefill_logits"] = np.asarray(logits)
        for u, leaves in caches.items():
            for n, t in leaves.items():
                res[f"{tag}_prefill_{u}.{n}"] = np.asarray(t)

    # what the reference itself cannot run
    dist = Dist(make_mesh((1, 4), ("data", "model"), devices=devs))
    for name, arch, strategy, what in C5_PATHS:
        cfg = _config(arch, get_reduced)
        shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
        params = jax.tree.map(jnp.asarray, _np_params(shapes))
        par = ParallelConfig(strategy=strategy, remat=False)
        try:
            if what == "loss":
                sharded_loss(cfg, par, dist, params).block_until_ready()
            else:
                sb = make_serve_fns(cfg, par, dist, shape_s)
                zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     cache_shapes(cfg, shape_s, dist))
                sb.decode_fn(placed(dist, params, sb.pspecs),
                             jnp.zeros((B, 1), jnp.int32), zeros,
                             jnp.full((B,), S + 1, jnp.int32))[0] \
                    .block_until_ready()
            raised = ""
        except Exception as e:  # the failure this test records
            raised = f"{type(e).__name__}: {str(e)[:200]}"
        res[f"c5_{name}"] = np.array(raised)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _port_arch(arch, dists, res):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.models.transformer import RunCtx, param_shapes, \
        param_specs
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves, \
        tree_map
    from repro_torch.train.train_loop import (loss_and_grads,
                                              make_serve_fns,
                                              make_train_step,
                                              reduce_model_axis_grads)
    from repro_torch.weights import params_from_jax, shard_params

    cfg = _config(arch, get_reduced)
    full = _np_params(param_shapes(cfg))
    shape_t = ShapeConfig("t", "train", S, B)
    for shape, dist in dists.items():
        tag = _tag(arch, shape)
        meg = ParallelConfig(strategy="megatron", remat=False)

        def fresh():
            return shard_params(params_from_jax(full, cfg, "cpu"), cfg,
                                "megatron", dist)

        data = SyntheticDataset(cfg, shape_t, dist, strategy="megatron")
        nll, cnt, grads = loss_and_grads(RunCtx(cfg, meg, dist), fresh(),
                                         data.batch(0))
        grads = reduce_model_axis_grads(grads, param_specs(cfg, "megatron"),
                                        meg, dist)
        grads = tree_map(lambda g: dist.psum(g, "data"), grads)
        res[f"{tag}_loss"] = (dist.psum(nll, "data") / cnt).numpy()
        res[f"{tag}_coords"] = np.array(dist.coords)
        for path, g in tree_leaves(grads):
            res[f"{tag}_grad_{'/'.join(path)}"] = g.numpy()

        tb = make_train_step(cfg, meg, dist, shape_t,
                             AdamWConfig(grad_clip=CLIP_OFF))
        params = fresh()
        state = tb.opt.init(params)
        for step in range(STEPS):
            params, state, m = tb.step_fn(params, state, data.batch(step))
            res[f"{tag}_traj_loss{step}"] = m["loss"].numpy()
        for path, leaf in tree_leaves(params):
            res[f"{tag}_traj_p_{'/'.join(path)}"] = leaf.numpy()

        if shape != (1, 4):
            continue
        sb = make_serve_fns(cfg, meg, dist)
        host = SyntheticDataset(cfg, shape_t, dist)._host_batch(0)
        pb = {k: torch.as_tensor(v) for k, v in host.items()
              if k != "labels"}
        caches, logits = sb.prefill_fn(fresh(), pb)
        res[f"{tag}_prefill_logits"] = logits.numpy()
        for u, leaves in caches.items():
            for n, t in leaves.items():
                res[f"{tag}_prefill_{u}.{n}"] = t.numpy()

        if arch == ARCHS[0]:  # the two remat policies, bitwise
            out = {}
            for policy in ("full", "tatp_outputs"):
                par = ParallelConfig(strategy="megatron", remat=True,
                                     remat_policy=policy)
                out[policy] = loss_and_grads(RunCtx(cfg, par, dist),
                                             fresh(), data.batch(0))
            (n1, _, g1), (n2, _, g2) = out["full"], out["tatp_outputs"]
            res["remat_bitwise"] = np.array(bool(torch.equal(n1, n2)) and all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(tree_leaves(g1), tree_leaves(g2))))


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.core.dist import init_world, make_mesh_dist

    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    dists = {shape: make_mesh_dist(shape, "cpu") for shape in MESHES}
    res = {}
    for arch in ARCHS:
        _port_arch(arch, dists, res)
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
    d = tmp_path_factory.mktemp("ring_megatron")
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


def _shard_of(want, spec, coords, shape):
    """The block of the global ``want`` that ``spec`` gives the rank at
    ``coords`` on a mesh of ``shape``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = shape[0 if axis == "data" else 1]
        c = coords[0 if axis == "data" else 1]
        blk = want.shape[dim] // n
        want = np.take(want, range(c * blk, (c + 1) * blk), axis=dim)
    return want


def _specs(arch):
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import param_specs
    return _flat(param_specs(_config(arch, get_reduced), "megatron"))


def _cases():
    return [(a, s) for a in ARCHS for s in MESHES]


def _ids():
    return [_tag(a, s) for a, s in _cases()]


# ---------------------------------------------------------------------------
# loss, gradients, trajectories, prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", _cases(), ids=_ids())
def test_loss_matches_reference_sharded_loss(ring, arch, shape):
    ref, ranks = ring
    tag = _tag(arch, shape)
    for p in ranks:
        np.testing.assert_allclose(p[f"{tag}_loss"], ref[f"{tag}_loss"],
                                   **LOSS_TOL)
    # the reference's sharded loss is its degree-1 loss
    np.testing.assert_allclose(ref[f"{tag}_loss"], ref[f"{arch}_loss1"],
                               **LOSS_TOL)


@pytest.mark.parametrize("arch,shape", _cases(), ids=_ids())
def test_grads_match_reference_degree_one_grads(ring, arch, shape):
    """Each rank's shard of every gradient leaf: the sharded leaves and
    the norm scales complete from the backward, the other replicated
    leaves (biases, replicated ``wk``/``wv``) after the ring's psum."""
    ref, ranks = ring
    tag = _tag(arch, shape)
    for path, spec in _specs(arch).items():
        want = ref[f"{arch}_grad_{path}"]
        for p in ranks:
            c = tuple(int(x) for x in p[f"{tag}_coords"])
            np.testing.assert_allclose(
                p[f"{tag}_grad_{path}"], _shard_of(want, spec, c, shape),
                err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("arch,shape", _cases(), ids=_ids())
def test_trajectory_matches_reference_degree_one(ring, arch, shape):
    """Three steps with the clip off: each step's loss and each rank's
    parameter shards after the third."""
    ref, ranks = ring
    tag = _tag(arch, shape)
    specs = _specs(arch)
    for p in ranks:
        c = tuple(int(x) for x in p[f"{tag}_coords"])
        for step in range(STEPS):
            np.testing.assert_allclose(p[f"{tag}_traj_loss{step}"],
                                       ref[f"{arch}_traj_loss{step}"],
                                       **TRAJ_TOL)
        for path, spec in specs.items():
            np.testing.assert_allclose(
                p[f"{tag}_traj_p_{path}"],
                _shard_of(ref[f"{arch}_traj_p_{path}"], spec, c, shape),
                err_msg=path, **TRAJ_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference_per_device(ring, arch):
    """The last position's logits over the whole vocab, and each rank's
    cache leaves: its kv heads of the prompt's K/V (the reference's out
    spec lays the devices' blocks along the sequence axis)."""
    ref, ranks = ring
    tag = _tag(arch, (1, 4))
    keys = [k for k in ref if k.startswith(f"{tag}_prefill_")
            and not k.endswith("logits")]
    assert keys
    for m, p in enumerate(ranks):
        np.testing.assert_allclose(p[f"{tag}_prefill_logits"],
                                   ref[f"{tag}_prefill_logits"], **TRAJ_TOL)
        for key in keys:
            want = ref[key]
            n = want.shape[2] // 4
            np.testing.assert_allclose(p[key], want[:, :, m * n:(m + 1) * n],
                                       err_msg=key, **TRAJ_TOL)


def test_remat_policies_are_bitwise_equal(ring):
    """Full remat and ``tatp_outputs`` (which under ``megatron`` saves the
    attention core's outputs only, as the reference names only those):
    the loss and every gradient leaf bitwise."""
    _, ranks = ring
    assert all(bool(p["remat_bitwise"]) for p in ranks)


# ---------------------------------------------------------------------------
# the launch, and what the reference cannot run
# ---------------------------------------------------------------------------


def test_megatron_train_cli_under_torchrun(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--reduced", "--device", "cpu", "--strategy", "megatron",
           "--mesh", "1", "4", "--steps", "2", "--batch", "4", "--seq", "16"]
    res = subprocess.run(cmd, env=_env(OMP_NUM_THREADS="1"), cwd=tmp_path,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert out["mesh"] == [1, 4] and out["steps"] == 2
    assert np.isfinite(out["last_loss"])


@pytest.mark.parametrize("entry,strategy", [("train", "fsdp"),
                                            ("serve", "megatron")])
def test_plans_the_reference_cannot_run_raise_before_the_mesh(
        monkeypatch, entry, strategy):
    """A plan that prescribes ``fsdp`` above model degree 1 (train), or
    ``megatron`` there for the one-shot serve, which decodes, raises
    naming C5 once it resolves, before the mesh is built."""
    sys.path.insert(0, str(SRC))
    import importlib

    from repro_torch.configs.base import ParallelConfig

    launch = importlib.import_module(f"repro_torch.launch.{entry}")

    class Plan:
        plan_hash = "stub"

        def parallel_config(self):
            return ParallelConfig(strategy=strategy)

        def mesh_shape_for(self, n):
            return (1, n)

        def summary(self):
            return f"a stub plan: {strategy} over the ring"

    def built(*a, **kw):
        raise AssertionError("the mesh was built")

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(launch, "join_world", lambda args: torch.device(
        "cpu"))
    monkeypatch.setattr(launch, "resolve_rank_plan",
                        lambda *a, **kw: Plan())
    monkeypatch.setattr(launch, "make_plan_dist", built)
    with pytest.raises(NotImplementedError, match="C5"):
        launch.main(["--reduced", "--device", "cpu", "--auto-plan"])


@pytest.mark.parametrize("name,arch,strategy,what", C5_PATHS,
                         ids=[c[0] for c in C5_PATHS])
def test_c5_paths_raise_in_both_packages(ring, name, arch, strategy, what):
    """The reference on 4 fake devices fails on the path; the port raises
    naming ROADMAP.md C5, on a ring Dist with no process group, so before
    any collective."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.models import lm
    from repro_torch.train.train_loop import make_serve_fns, make_train_step

    ref, _ = ring
    assert str(ref[f"c5_{name}"]), f"the reference ran {name}"
    cfg = _config(arch, get_reduced)
    par = ParallelConfig(strategy=strategy, remat=False)
    dist = Dist(torch.device("cpu"), mesh_shape=(1, 4), coords=(0, 1))
    with pytest.raises(NotImplementedError, match="C5"):
        if what == "loss":
            make_train_step(cfg, par, dist, ShapeConfig("t", "train", S, B))
        else:
            make_serve_fns(cfg, par, dist).decode_fn(
                {}, torch.zeros(B, 1, dtype=torch.long), {},
                torch.full((B,), S + 1))
    with pytest.raises(NotImplementedError, match="C5"):
        from repro_torch.models.transformer import RunCtx
        ctx = RunCtx(cfg, par, dist)
        if what == "loss":
            lm.loss_fn(ctx, {}, {})
        else:
            lm.decode_step(ctx, {}, None, {}, S + 1)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
