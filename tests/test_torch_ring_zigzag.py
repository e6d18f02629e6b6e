"""Zigzag ring attention and ``remat_policy="tatp_outputs"`` on the train
ring against the reference on the CPU.

As ``tests/test_torch_ring_grads.py``: the port's ranks are processes
joined by gloo (a ``FileStore`` under the test's temporary directory), the
reference runs ``shard_map`` on 4 fake CPU devices in a subprocess, both
sides run this file as a script on the same seeded numpy inputs and write
numpy outputs, which the tests compare:

* ``zigzag_ring_attention``'s output and dq/dk/dv at R = 2, 3 and 4, both
  orders, on the online-softmax loop and on the hook (the flash kernel's
  plain versions here), against ``jax.vjp`` of the reference's (fp32,
  1e-5); the hook makes 2R + 1 forward and 2R + 1 backward calls a rank;
* a twin of ``tests/multidevice/check_zigzag.py`` on the reduced
  deepseek-7b (no window) at mesh (1, 4): the zigzag loss on
  ``zigzag_permutation``-ed data against the contiguous loss (5e-4), on
  the loop and the hook; and a 3-step zigzag trajectory against the
  reference's (2e-4);
* ``tatp_outputs`` on the ring at (1, 4) and (2, 2): the loss and every
  gradient bitwise equal to full remat's, and its backward runs no forward
  schedule (no TATP forward ring, no ring attention round) and relays no
  byte more than the backward's own rings, where full remat's recompute
  relays the weight and K/V blocks again."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
ARCH = "deepseek-7b"
RINGS = (2, 3, 4)
ORDERS = (True, False)  # bidirectional, naive
AB, ASL, AH, AD = 2, 4, 4, 16  # batch, per-rank sequence, heads, head dim
CASES = {"plain": (None, 4), "capped_gqa": (0.5, 2)}  # cap, kv heads
B, S, STEPS = 4, 16, 3
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 300


def _inputs():
    rng = np.random.RandomState(0)
    out = {}
    for r in RINGS:
        for name, (_, hkv) in CASES.items():
            s = r * ASL
            out[f"q{r}_{name}"] = rng.randn(AB, s, AH, AD).astype(np.float32)
            out[f"k{r}_{name}"] = rng.randn(AB, s, hkv, AD).astype(np.float32)
            out[f"v{r}_{name}"] = rng.randn(AB, s, hkv, AD).astype(np.float32)
            out[f"do{r}_{name}"] = rng.randn(AB, s, AH, AD).astype(np.float32)
    return out


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


def _zigzag(host, r):
    """The host batch with its sequence permuted into the zigzag layout."""
    from repro_torch.models.attention import zigzag_permutation
    perm = zigzag_permutation(r, host["tokens"].shape[1])
    return {k: v[:, perm] for k, v in host.items()}


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as Ps

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.core.dist import Dist, make_mesh
    from repro.models import attention as attn
    from repro.models.transformer import param_shapes
    from repro.train.data import SyntheticDataset
    from repro.train.train_loop import make_train_step

    x = _inputs()
    res = {}
    devs = jax.devices()
    assert len(devs) == 4, devs
    seq = Ps(None, "model")
    for r in RINGS:
        mesh = make_mesh((r,), ("model",), devices=devs[:r])
        for name, (cap, _) in CASES.items():
            def f(q, k, v, do, r=r, cap=cap):
                outs = []
                for o in ORDERS:
                    y, vjp = jax.vjp(
                        lambda a, b, c: attn.zigzag_ring_attention(
                            a, b, c, axis="model", axis_size=r, cap=cap,
                            bidirectional=o), q, k, v)
                    outs += [y, *vjp(do)]
                return tuple(outs)

            outs = jax.jit(jax.shard_map(
                f, mesh=mesh, in_specs=(seq,) * 4, out_specs=(seq,) * 8,
                check_vma=False))(*(x[f"{p}{r}_{name}"]
                                    for p in ("q", "k", "v", "do")))
            for oi, o in enumerate(ORDERS):
                for gi, g in enumerate(("o", "dq", "dk", "dv")):
                    res[f"zz{r}_{name}_{o}_{g}"] = np.asarray(
                        outs[4 * oi + gi])

    # a 3-step zigzag trajectory of the reduced deepseek-7b at (1, 4)
    cfg = get_reduced(ARCH)
    dist = Dist(make_mesh((1, 4), ("data", "model"), devices=devs))
    shape = ShapeConfig("t", "train", S, B)
    tb = make_train_step(cfg, ParallelConfig(strategy="tatp", remat=False,
                                             zigzag=True), dist, shape)
    shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
    params = jax.tree.map(jnp.asarray, _np_params(shapes))
    state = jax.jit(jax.shard_map(
        tb.opt.init, mesh=dist.mesh, in_specs=(tb.pspecs,),
        out_specs=tb.ospecs, check_vma=False))(params)
    data = SyntheticDataset(cfg, shape, dist)
    for step in range(STEPS):
        host = _zigzag(data._host_batch(step), 4)
        batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
            dist.mesh, tb.bspecs[k])) for k, v in host.items()}
        params, state, m = tb.step_fn(params, state, batch)
        res[f"traj{step}"] = np.asarray(m["loss"])
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _grad_of(fn, inputs, ct):
    """(fn(*inputs), d<fn . ct>/d inputs) by autograd."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, ct)


class _Counter:
    """Counts the hook's calls and the bytes the ranks relay, by whether a
    forward schedule (a TATP forward ring, ring attention's rounds) is
    running."""

    def __init__(self, monkeypatch_like):
        from repro_torch.core import tatp
        from repro_torch.core.dist import Dist
        from repro_torch.models import attention as attn

        self.in_fwd = 0
        self.calls = {"fwd_schedules": 0}
        self.bytes = {True: 0, False: 0}
        me = self

        def counted(fn):
            def run(*a, **kw):
                me.calls["fwd_schedules"] += 1
                me.in_fwd += 1
                try:
                    return fn(*a, **kw)
                finally:
                    me.in_fwd -= 1
            return run

        raw = Dist._ppermute_raw

        def ppermute_raw(dist, items, axis):
            n = sum(t.numel() * t.element_size() for x, _ in items
                    for t in (x if isinstance(x, tuple) else (x,)))
            me.bytes[me.in_fwd > 0] += n
            return raw(dist, items, axis)

        monkeypatch_like(tatp, "ag_matmul_stream_w",
                         counted(tatp.ag_matmul_stream_w))
        monkeypatch_like(attn, "_hook_rounds", counted(attn._hook_rounds))
        monkeypatch_like(Dist, "_ppermute_raw", ppermute_raw)

    def reset(self):
        self.calls = {"fwd_schedules": 0}
        self.bytes = {True: 0, False: 0}


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import init_world, make_mesh_dist
    from repro_torch.kernels.flash_attention.ops import attention as flash
    from repro_torch.models import attention as attn
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunCtx, param_shapes
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import make_train_step, shard_batch
    from repro_torch.weights import params_from_jax, shard_params

    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    x = _inputs()
    res = {}
    t = torch.as_tensor
    if world == 3:
        rings = {3: make_mesh_dist((1, 3), "cpu")}
    else:
        d14, d22 = make_mesh_dist((1, 4), "cpu"), make_mesh_dist((2, 2),
                                                                 "cpu")
        rings = {4: d14, 2: d22}
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return flash(*a, **kw)

    def bwd_ref(*a, **kw):
        from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
        calls["bwd"] += 1
        return attention_bwd_ref(*a, **kw)

    for r, dist in rings.items():
        i = dist.axis_index("model")
        for name, (cap, _) in CASES.items():
            def blk(key):
                a = t(x[f"{key}{r}_{name}"])
                return a[:, i * ASL:(i + 1) * ASL]

            q, k_, v_, do = (blk(p) for p in ("q", "k", "v", "do"))
            for o in ORDERS:
                for hook, fn in (("loop", None), ("hook", fwd)):
                    calls.update(fwd=0, bwd=0)
                    orig = attn._attention_bwd
                    attn._attention_bwd = lambda a, qq: bwd_ref
                    try:
                        y, gs = _grad_of(lambda a, b, c: attn
                                         .zigzag_ring_attention(
                                             a, b, c, axis="model",
                                             axis_size=r, cap=cap,
                                             bidirectional=o, dist=dist,
                                             attention=fn),
                                         [q, k_, v_], do)
                    finally:
                        attn._attention_bwd = orig
                    key = f"zz{r}_{name}_{o}_{hook}"
                    res[f"{key}_o"] = y
                    for g, gt in zip(("dq", "dk", "dv"), gs):
                        res[f"{key}_{g}"] = gt
                    res[f"{key}_calls"] = np.array([calls["fwd"],
                                                    calls["bwd"]])
    if world == 4:
        cfg = get_reduced(ARCH)
        full = params_from_jax(_np_params(param_shapes(cfg)), cfg, "cpu")
        shape = ShapeConfig("t", "train", S, B)
        dist = rings[4]

        def tensors(host, dist=dist):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
                    for k, v in shard_batch(cfg, host, dist).items()}

        # contiguous vs zigzag loss, on the loop and the hook
        host = SyntheticDataset(cfg, shape, dist)._host_batch(0)
        params = shard_params(full, cfg, "tatp", dist)
        for hook, fn in (("loop", None), ("hook", flash)):
            for zz in (False, True):
                par = ParallelConfig(strategy="tatp", remat=False, zigzag=zz)
                ctx = RunCtx(cfg, par, dist, phase="train", attention=fn)
                with torch.no_grad():
                    nll, cnt, _ = lm.loss_fn(ctx, params, tensors(
                        _zigzag(host, 4) if zz else host))
                nll, cnt = dist.psum(nll, "model"), dist.psum(cnt, "model")
                res[f"zzloss_{hook}_{zz}"] = (nll / cnt).numpy()
        # a 3-step zigzag trajectory
        tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False, zigzag=True),
                             dist, shape)
        params = shard_params(full, cfg, "tatp", dist)
        state = tb.opt.init(params)
        data = SyntheticDataset(cfg, shape, dist)
        for step in range(STEPS):
            batch = tensors(_zigzag(data._host_batch(step), 4))
            params, state, m = tb.step_fn(params, state, batch)
            res[f"traj{step}"] = m["loss"].numpy()
        # tatp_outputs against full remat, on the hook
        patches = []

        def patch(obj, name, val):
            patches.append((obj, name, getattr(obj, name)))
            setattr(obj, name, val)

        counter = _Counter(patch)
        try:
            for mesh, d in (("1x4", d14), ("2x2", d22)):
                params = shard_params(full, cfg, "tatp", d)
                batch = tensors(host, d)
                for policy in ("full", "tatp_outputs"):
                    par = ParallelConfig(strategy="tatp", remat=True,
                                         remat_policy=policy)
                    ctx = RunCtx(cfg, par, d, phase="train")
                    flat = [p for _, p in tree_leaves(params)]
                    for p in flat:
                        p.requires_grad_(True)
                    nll, cnt, _ = lm.loss_fn(ctx, params, batch)
                    counter.reset()
                    gs = torch.autograd.grad(nll, flat)
                    for p in flat:
                        p.requires_grad_(False)
                    key = f"remat_{mesh}_{policy}"
                    res[f"{key}_loss"] = nll.detach().numpy()
                    for (path, _), g in zip(tree_leaves(params), gs):
                        res[f"{key}_g_{'/'.join(path)}"] = g.numpy()
                    res[f"{key}_fwd_schedules"] = np.array(
                        counter.calls["fwd_schedules"])
                    res[f"{key}_bytes"] = np.array(
                        [counter.bytes[True], counter.bytes[False]])
        finally:
            for obj, name, val in reversed(patches):
                setattr(obj, name, val)
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
    d = tmp_path_factory.mktemp("ring_zigzag")
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
    try:
        _finish(ranks, "port rank")
        _finish([("reference", ref)], "the")
    finally:
        for p in [ref] + [p for _, p in ranks]:
            if p.poll() is None:
                p.kill()
    port = {name: dict(np.load(d / f"{name}.npz")) for name, _ in ranks}
    return dict(np.load(d / "ref.npz")), port


def _ring_ranks(port, r):
    """The ranks of one ring of size ``r`` in ring order: world 3 for R =
    3, the (1, 4) mesh for R = 4, data row 0 of the (2, 2) mesh for R =
    2 (global ranks 0 and 1)."""
    world = 3 if r == 3 else 4
    return [port[f"{world}-{k}"] for k in range(r)]


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("bidirectional", ORDERS)
@pytest.mark.parametrize("hook", ["loop", "hook"])
def test_zigzag_attention_and_grads_match_jax_vjp(runs, r, name,
                                                  bidirectional, hook):
    ref, port = runs
    key = f"zz{r}_{name}_{bidirectional}"
    for g in ("o", "dq", "dk", "dv"):
        got = np.concatenate([p[f"{key}_{hook}_{g}"]
                              for p in _ring_ranks(port, r)], axis=1)
        np.testing.assert_allclose(got, ref[f"{key}_{g}"], err_msg=g, **TOL)
    for p in _ring_ranks(port, r):
        want = [2 * r + 1, 2 * r + 1] if hook == "hook" else [0, 0]
        assert p[f"{key}_{hook}_calls"].tolist() == want


@pytest.mark.parametrize("hook", ["loop", "hook"])
def test_zigzag_loss_equals_contiguous_loss(runs, hook):
    """``check_zigzag.py``'s parity on the reduced deepseek-7b: the same
    global loss from the zigzag layout of the permuted batch."""
    _, port = runs
    for k in range(4):
        p = port[f"4-{k}"]
        np.testing.assert_allclose(p[f"zzloss_{hook}_True"],
                                   p[f"zzloss_{hook}_False"], rtol=0,
                                   atol=5e-4)


def test_zigzag_trajectory_matches_reference(runs):
    ref, port = runs
    for k in range(4):
        for step in range(STEPS):
            np.testing.assert_allclose(port[f"4-{k}"][f"traj{step}"],
                                       ref[f"traj{step}"], rtol=2e-4,
                                       atol=2e-4, err_msg=f"step {step}")


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_tatp_outputs_on_the_ring_is_full_remat_bitwise(runs, mesh):
    _, port = runs
    for k in range(4):
        p = port[f"4-{k}"]
        full, saved = f"remat_{mesh}_full", f"remat_{mesh}_tatp_outputs"
        grads = [key[len(full):] for key in p if key.startswith(full + "_g_")]
        assert grads
        assert np.array_equal(p[f"{saved}_loss"], p[f"{full}_loss"])
        for g in grads:
            assert np.array_equal(p[saved + g], p[full + g]), g


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_tatp_outputs_recompute_relays_nothing(runs, mesh):
    """The backward under ``tatp_outputs`` runs no forward schedule and
    relays no byte in one; full remat's recompute runs them and relays the
    blocks again; both backwards' own rings move the same bytes."""
    _, port = runs
    for k in range(4):
        p = port[f"4-{k}"]
        full, saved = f"remat_{mesh}_full", f"remat_{mesh}_tatp_outputs"
        assert int(p[f"{saved}_fwd_schedules"]) == 0
        assert int(p[f"{full}_fwd_schedules"]) > 0
        assert p[f"{saved}_bytes"][0] == 0 and p[f"{full}_bytes"][0] > 0
        assert p[f"{saved}_bytes"][1] == p[f"{full}_bytes"][1]


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
