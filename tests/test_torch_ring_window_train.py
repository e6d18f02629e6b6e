"""Ring training under a sliding window against the reference on the CPU.

As ``tests/test_torch_ring_zigzag.py``: the port's ranks are processes
joined by gloo (a ``FileStore`` under the test's temporary directory), the
reference runs ``shard_map`` on 4 fake CPU devices in a subprocess, both
sides run this file as a script on the same seeded numpy inputs and write
numpy outputs, which the tests compare (fp32 throughout):

* ``ring_attention``'s and ``zigzag_ring_attention``'s output and
  dq/dk/dv under a window at R = 2, 3 and 4, both orders, on the
  online-softmax loop and on the hook (the flash kernel's plain versions
  here: each forward launch and its backward call at the launch's query
  offset), against ``jax.vjp`` of the reference's in its default
  (bidirectional) order, the same function (1e-5), with windows
  that leave rounds whole, cut and empty and one capped GQA case; the
  hook's forward and backward calls a rank both equal its visible
  launches, counted from positions;
* gemma2-9b reduced as ``tests/multidevice/check_zigzag.py`` reduces it
  (window 16, a sequence of 64: past it) at (1, 4) and (2, 2): every
  gradient leaf of one step's loss against the reference's shard_map
  train step's (1e-5), and a 3-step trajectory (2e-4);
* a twin of ``check_zigzag.py`` at (1, 4): the zigzag loss on
  ``zigzag_permutation``-ed data against the contiguous loss (5e-4), on
  the loop and on the hook, and the zigzag step's gradients against the
  contiguous step's (1e-5)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
ARCH = "gemma2-9b"
RINGS = (2, 3, 4)
ORDERS = (True, False)  # bidirectional, naive
AB, ASL, AH, AD = 2, 8, 4, 16  # batch, per-rank sequence, heads, head dim
# name: (window, cap, kv heads), all causal.  With 8 positions a rank
# (zigzag: chunks of 4), window 3 cuts the own block and the next and
# empties the rest, 8 cuts two blocks, 40 covers every pair (no round masks
# by it)
CASES = {"w3": (3, None, 4), "w40": (40, None, 4),
         "w8_capped_gqa": (8, 0.5, 2)}
KINDS = ("ring", "zz")
# the model: check_zigzag.py's reduction of gemma2-9b, a batch of 4 x 64
MODEL = dict(vocab_size=128, d_model=64, d_ff=128, n_heads=4, n_kv_heads=4,
             d_head=16, sliding_window=16)
B, S, STEPS = 4, 64, 3
MESHES = ((1, 4), (2, 2))
TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=2e-4, atol=2e-4)
TIMEOUT = 300


def _inputs():
    rng = np.random.RandomState(0)
    out = {}
    for r in RINGS:
        for name, (_, _, hkv) in CASES.items():
            s = r * ASL
            for p, h in (("q", AH), ("k", hkv), ("v", hkv), ("do", AH)):
                out[f"{p}{r}_{name}"] = rng.randn(AB, s, h, AD).astype(
                    np.float32)
    return out


def _config(get_config, reduced_config):
    return reduced_config(get_config(ARCH), **MODEL)


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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tag(shape):
    return "x".join(map(str, shape))


def _visible_launches(r, i, zigzag, window):
    """Rank ``i``'s causal launches that hold a visible pair, counted from
    the positions of every (query chunk, key chunk) pair of every block."""
    c = ASL // 2 if zigzag else ASL

    def chunks(rank):
        return (rank, 2 * r - 1 - rank) if zigzag else (rank,)

    n = 0
    pos = np.arange(c)
    for j in range(r):
        for qc in chunks(i):
            for kc in chunks(j):
                d = (qc * c + pos)[:, None] - (kc * c + pos)[None, :]
                n += bool(((d >= 0) & (d < window)).any())
    return n


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


def _reference(part, out_path):
    """The reference's outputs of one ``part``, in its own process so the
    parts compile in parallel: ``"attention"`` (every ring), or one mesh's
    gemma2-9b gradients or trajectory (``"1x4_grads"``, ``"2x2_traj"``,
    ...)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as Ps

    sys.path.insert(0, str(SRC))
    from repro.configs import get_config
    from repro.configs.base import ParallelConfig, ShapeConfig, reduced_config
    from repro.core.dist import Dist, make_mesh
    from repro.models import attention as attn
    from repro.models import lm
    from repro.models.transformer import param_shapes
    from repro.train.data import SyntheticDataset
    from repro.train.train_loop import (make_train_step,
                                        reduce_model_axis_grads, token_axes)

    x = _inputs()
    res = {}
    devs = jax.devices()
    assert len(devs) == 4, devs
    seq = Ps(None, "model")
    fns = {"ring": attn.ring_attention, "zz": attn.zigzag_ring_attention}
    for r in RINGS if part == "attention" else ():
        mesh = make_mesh((r,), ("model",), devices=devs[:r])

        def f(*ins, r=r):
            outs = []
            for n, (window, cap, _) in enumerate(CASES.values()):
                q, k, v, do = ins[4 * n:4 * n + 4]
                for kind in KINDS:
                    y, vjp = jax.vjp(
                        lambda a, b, c, fn=fns[kind]: fn(
                            a, b, c, axis="model", axis_size=r,
                            window=window, cap=cap), q, k, v)
                    outs += [y, *vjp(do)]
            return tuple(outs)

        keys = [(name, kind) for name in CASES for kind in KINDS]
        ins = [x[f"{p}{r}_{name}"] for name in CASES
               for p in ("q", "k", "v", "do")]
        outs = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(seq,) * len(ins),
            out_specs=(seq,) * (4 * len(keys)), check_vma=False))(*ins)
        for n, (name, kind) in enumerate(keys):
            for gi, g in enumerate(("o", "dq", "dk", "dv")):
                res[f"{kind}{r}_{name}_{g}"] = np.asarray(outs[4 * n + gi])

    # the reduced gemma2-9b: one step's gradients and three steps
    cfg = _config(get_config, reduced_config)
    shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
    np_params = _np_params(shapes)
    shape = ShapeConfig("t", "train", S, B)
    par = ParallelConfig(strategy="tatp", remat=False)
    for mesh_shape in MESHES:
        tag = _tag(mesh_shape)
        if not part.startswith(tag):
            continue
        dist = Dist(make_mesh(mesh_shape, ("data", "model"), devices=devs))
        tb = make_train_step(cfg, par, dist, shape)
        data = SyntheticDataset(cfg, shape, dist)
        axes = token_axes(par, dist)
        shards = 1
        for a in axes:
            shards *= dist.axis_sizes[a]

        def local_grads(p, bt, tb=tb, dist=dist, axes=axes, shards=shards):
            def local_loss(p):  # as make_train_step's _local_step
                nll, cnt, aux = lm.loss_fn(tb.ctx, p, bt)
                for a in axes:
                    cnt = lax.psum(cnt, a)
                return nll / lax.stop_gradient(cnt) + aux / shards

            g = reduce_model_axis_grads(jax.grad(local_loss)(p), tb.pspecs,
                                        par, dist)
            return jax.tree.map(lambda t: lax.psum(t, "data"), g)

        if part.endswith("grads"):
            grads = jax.jit(jax.shard_map(
                local_grads, mesh=dist.mesh,
                in_specs=(tb.pspecs, tb.bspecs), out_specs=tb.pspecs,
                check_vma=False))(jax.tree.map(jnp.asarray, np_params),
                                  data.batch(0, tb.bspecs))
            for path, g in _flat(grads).items():
                res[f"{tag}_grad_{path}"] = np.asarray(g)
            continue
        params = jax.tree.map(jnp.asarray, np_params)
        state = jax.jit(jax.shard_map(
            tb.opt.init, mesh=dist.mesh, in_specs=(tb.pspecs,),
            out_specs=tb.ospecs, check_vma=False))(params)
        for step in range(STEPS):
            params, state, m = tb.step_fn(params, state,
                                          data.batch(step, tb.bspecs))
            res[f"{tag}_traj{step}"] = np.asarray(m["loss"])
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _grad_of(fn, inputs, ct):
    """(fn(*inputs), d<fn . ct>/d inputs) by autograd."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, ct)


def _port_attention(dist, r, x, res):
    """Ring and zigzag attention and their gradients on the loop and on
    the hook, with the hook's forward and backward calls."""
    from repro_torch.kernels.flash_attention.ops import attention as flash
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.models import attention as attn

    fns = {"ring": attn.ring_attention, "zz": attn.zigzag_ring_attention}
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return flash(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return attention_bwd_ref(*a, **kw)

    i = dist.axis_index("model")
    orig = attn._attention_bwd
    attn._attention_bwd = lambda hook, q: bwd
    try:
        for name, (window, cap, _) in CASES.items():
            q, k, v, do = (torch.as_tensor(x[f"{p}{r}_{name}"])[
                :, i * ASL:(i + 1) * ASL] for p in ("q", "k", "v", "do"))
            for kind in KINDS:
                for o in ORDERS:
                    for hook, fn in (("loop", None), ("hook", fwd)):
                        calls.update(fwd=0, bwd=0)
                        y, gs = _grad_of(
                            lambda a, b, c: fns[kind](
                                a, b, c, axis="model", axis_size=r,
                                window=window, cap=cap, bidirectional=o,
                                dist=dist, attention=fn), [q, k, v], do)
                        key = f"{kind}{r}_{name}_{o}_{hook}"
                        for g, t in zip(("o", "dq", "dk", "dv"), (y, *gs)):
                            res[f"{key}_{g}"] = t.numpy()
                        res[f"{key}_calls"] = np.array([calls["fwd"],
                                                        calls["bwd"]])
    finally:
        attn._attention_bwd = orig


def _port_model(dists, res):
    """The reduced gemma2-9b: one step's gradients and a 3-step trajectory
    on each mesh; the zigzag twin at (1, 4)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (ParallelConfig, ShapeConfig,
                                          reduced_config)
    from repro_torch.kernels.flash_attention.ops import attention as flash
    from repro_torch.models import lm
    from repro_torch.models.attention import zigzag_permutation
    from repro_torch.models.transformer import (RunCtx, param_shapes,
                                                param_specs)
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_loop import (loss_and_grads,
                                              make_train_step,
                                              reduce_model_axis_grads,
                                              shard_batch)
    from repro_torch.weights import params_from_jax, shard_params

    cfg = _config(get_config, reduced_config)
    full = _np_params(param_shapes(cfg))
    shape = ShapeConfig("t", "train", S, B)
    par = ParallelConfig(strategy="tatp", remat=False)

    def fresh(dist):
        return shard_params(params_from_jax(full, cfg, "cpu"), cfg, "tatp",
                            dist)

    def grads_of(dist, params, batch, par=par):
        _, _, g = loss_and_grads(RunCtx(cfg, par, dist, phase="train"),
                                 params, batch)
        g = reduce_model_axis_grads(g, param_specs(cfg), par, dist)
        return dict(tree_leaves(tree_map(lambda t: dist.psum(t, "data"), g)))

    for mesh_shape, dist in dists.items():
        tag = _tag(mesh_shape)
        data = SyntheticDataset(cfg, shape, dist)
        res[f"{tag}_coords"] = np.array(dist.coords)
        for path, g in grads_of(dist, fresh(dist), data.batch(0)).items():
            res[f"{tag}_grad_{'/'.join(path)}"] = g.numpy()
        tb = make_train_step(cfg, par, dist, shape)
        params = fresh(dist)
        state = tb.opt.init(params)
        for step in range(STEPS):
            params, state, m = tb.step_fn(params, state, data.batch(step))
            res[f"{tag}_traj{step}"] = m["loss"].numpy()

    # check_zigzag.py's parity: the zigzag layout of the permuted batch
    dist = dists[(1, 4)]
    host = SyntheticDataset(cfg, shape, dist)._host_batch(0)
    perm = zigzag_permutation(4, S)

    def tensors(zz):
        h = {k: v[:, perm] for k, v in host.items()} if zz else host
        return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                for k, v in shard_batch(cfg, h, dist).items()}

    params = fresh(dist)
    for hook in ("loop", "hook"):
        for zz in (False, True):
            zpar = ParallelConfig(strategy="tatp", remat=False, zigzag=zz)
            ctx = RunCtx(cfg, zpar, dist, phase="train",
                         attention=None if hook == "loop" else flash)
            with torch.no_grad():
                nll, cnt, _ = lm.loss_fn(ctx, params, tensors(zz))
            nll, cnt = dist.psum(nll, "model"), dist.psum(cnt, "model")
            res[f"zzloss_{hook}_{zz}"] = (nll / cnt).numpy()
    for zz in (False, True):
        zpar = ParallelConfig(strategy="tatp", remat=False, zigzag=zz)
        for path, g in grads_of(dist, params, tensors(zz), zpar).items():
            res[f"zzgrad_{zz}_{'/'.join(path)}"] = g.numpy()


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.core.dist import init_world, make_mesh_dist

    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    x = _inputs()
    res = {}
    if world == 3:
        _port_attention(make_mesh_dist((1, 3), "cpu"), 3, x, res)
    else:
        d14, d22 = make_mesh_dist((1, 4), "cpu"), make_mesh_dist((2, 2),
                                                                 "cpu")
        _port_attention(d14, 4, x, res)
        _port_attention(d22, 2, x, res)
        _port_model({(1, 4): d14, (2, 2): d22}, res)
    np.savez(Path(out_dir) / f"{world}-{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})
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
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_window_train")
    me = str(Path(__file__).resolve())
    parts = ["attention"] + [f"{_tag(m)}_{what}" for m in MESHES
                             for what in ("grads", "traj")]
    refs = [(part, subprocess.Popen(
        [sys.executable, me, "reference", part, str(d / f"ref_{part}.npz")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for part in parts]
    ranks = []
    for world in (4, 3):
        store = d / f"store{world}"
        for rank in range(world):
            ranks.append((f"{world}-{rank}", subprocess.Popen(
                [sys.executable, me, "port", str(world), str(rank),
                 str(store), str(d)], env=_env(),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        _finish(ranks, "port rank")
        _finish(refs, "the reference's")
    finally:
        for _, p in refs + ranks:
            if p.poll() is None:
                p.kill()
    port = {name: dict(np.load(d / f"{name}.npz")) for name, _ in ranks}
    ref = {}
    for part in parts:
        ref.update(np.load(d / f"ref_{part}.npz"))
    return ref, port


def _ring_ranks(port, r):
    """The ranks of one ring of size ``r`` in ring order: world 3 for R =
    3, the (1, 4) mesh for R = 4, data row 0 of the (2, 2) mesh for R =
    2 (global ranks 0 and 1)."""
    world = 3 if r == 3 else 4
    return [port[f"{world}-{k}"] for k in range(r)]


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


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bidirectional", ORDERS)
@pytest.mark.parametrize("hook", ["loop", "hook"])
def test_windowed_ring_attention_grads_match_jax_vjp(runs, r, name, kind,
                                                     bidirectional, hook):
    ref, port = runs
    key = f"{kind}{r}_{name}"
    for g in ("o", "dq", "dk", "dv"):
        got = np.concatenate([p[f"{key}_{bidirectional}_{hook}_{g}"]
                              for p in _ring_ranks(port, r)], axis=1)
        np.testing.assert_allclose(got, ref[f"{key}_{g}"], err_msg=g, **TOL)


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_hook_backward_calls_equal_visible_launches(runs, r, name, kind):
    """A backward call for each forward launch: both equal the launches
    that hold a visible pair, counted from positions; the loop makes
    none."""
    _, port = runs
    window = CASES[name][0]
    for i, p in enumerate(_ring_ranks(port, r)):
        n = _visible_launches(r, i, kind == "zz", window)
        for o in ORDERS:
            key = f"{kind}{r}_{name}_{o}"
            assert p[f"{key}_hook_calls"].tolist() == [n, n]
            assert p[f"{key}_loop_calls"].tolist() == [0, 0]


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_gemma2_grads_match_reference_train_step(runs, mesh):
    """Each rank's shard of every gradient leaf of one step's loss."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced_config
    from repro_torch.models.transformer import param_specs

    ref, port = runs
    tag = _tag(mesh)
    specs = _flat(param_specs(_config(get_config, reduced_config)))
    assert specs
    for k in range(4):
        p = port[f"4-{k}"]
        coords = tuple(int(c) for c in p[f"{tag}_coords"])
        for path, spec in specs.items():
            np.testing.assert_allclose(
                p[f"{tag}_grad_{path}"],
                _shard_of(ref[f"{tag}_grad_{path}"], spec, coords, mesh),
                err_msg=path, **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_gemma2_trajectory_matches_reference(runs, mesh):
    ref, port = runs
    tag = _tag(mesh)
    for k in range(4):
        for step in range(STEPS):
            np.testing.assert_allclose(port[f"4-{k}"][f"{tag}_traj{step}"],
                                       ref[f"{tag}_traj{step}"],
                                       err_msg=f"step {step}", **TRAJ_TOL)


@pytest.mark.parametrize("hook", ["loop", "hook"])
def test_gemma2_zigzag_loss_equals_contiguous_loss(runs, hook):
    """``check_zigzag.py``'s parity at (1, 4): the same global loss from
    the zigzag layout of the permuted batch."""
    _, port = runs
    for k in range(4):
        p = port[f"4-{k}"]
        np.testing.assert_allclose(p[f"zzloss_{hook}_True"],
                                   p[f"zzloss_{hook}_False"], rtol=0,
                                   atol=5e-4)


def test_gemma2_zigzag_grads_equal_contiguous_grads(runs):
    """The loss sums over tokens, so the permuted batch in the zigzag
    layout gives the contiguous step's gradients."""
    _, port = runs
    for k in range(4):
        p = port[f"4-{k}"]
        grads = [key[len("zzgrad_True_"):] for key in p
                 if key.startswith("zzgrad_True_")]
        assert grads
        for g in grads:
            np.testing.assert_allclose(p[f"zzgrad_True_{g}"],
                                       p[f"zzgrad_False_{g}"], err_msg=g,
                                       **TOL)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2], sys.argv[3])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
