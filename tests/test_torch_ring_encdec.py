"""The encoder-decoder and the vision prefix on the train ring against the
reference on the CPU.

As ``tests/test_torch_ring_train.py``: four gloo ranks (a ``FileStore``
under the test's temporary directory) and the reference's
``make_train_step`` under ``shard_map`` on 4 fake CPU devices in a
subprocess, from the same seeded weights and the same synthetic batches
(each rank taking its rows and sequence block, its slice of the stub
``enc_embeds`` over the ring and the whole ``prefix_embeds``, as the
reference's ``batch_specs``).  At mesh (1, 4), three steps of the reduced
seamless-m4t-large-v2 (its encoder's bidirectional ring attention, its
cross blocks streaming the sequence-sharded encoder output) and
internvl2-1b (the image prefix over the first positions) in fp32: each
step's loss and token count, and the final parameters (each rank's
shards), at 2e-4; and the ``launch.train --mesh 1 4`` CLI trains both."""

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
ARCHS = ("seamless-m4t-large-v2", "internvl2-1b")
MESH = (1, 4)
B, S, STEPS = 4, 16, 3
TOL = dict(rtol=2e-4, atol=2e-4)
TIMEOUT = 300


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


def _reference(out_path):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.core.dist import Dist, make_mesh
    from repro.models.transformer import param_shapes
    from repro.train.data import SyntheticDataset
    from repro.train.train_loop import make_train_step

    devs = jax.devices()
    assert len(devs) == 4, devs
    res = {}
    for arch in ARCHS:
        cfg = get_reduced(arch)
        shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
        dist = Dist(make_mesh(MESH, ("data", "model"), devices=devs))
        shape = ShapeConfig("t", "train", S, B)
        tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False), dist, shape)
        params = jax.tree.map(jnp.asarray, _np_params(shapes))
        state = jax.jit(jax.shard_map(
            tb.opt.init, mesh=dist.mesh, in_specs=(tb.pspecs,),
            out_specs=tb.ospecs, check_vma=False))(params)
        data = SyntheticDataset(cfg, shape, dist)
        for step in range(STEPS):
            params, state, m = tb.step_fn(params, state,
                                          data.batch(step, tb.bspecs))
            for k in ("loss", "tokens"):
                res[f"{arch}_{k}{step}"] = np.asarray(m[k])
        for path, leaf in _flat(params).items():
            res[f"{arch}_p_{path}"] = np.asarray(leaf)
    np.savez(out_path, **res)


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import init_world, make_mesh_dist
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.weights import params_from_jax, shard_params

    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    res = {}
    for arch in ARCHS:
        cfg = get_reduced(arch)
        dist = make_mesh_dist(MESH, "cpu")
        shape = ShapeConfig("t", "train", S, B)
        tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False), dist, shape)
        params = shard_params(params_from_jax(
            _np_params(param_shapes(cfg)), cfg, "cpu"), cfg, "tatp", dist)
        state = tb.opt.init(params)
        data = SyntheticDataset(cfg, shape, dist)
        for step in range(STEPS):
            params, state, m = tb.step_fn(params, state, data.batch(step))
            for k in ("loss", "tokens"):
                res[f"{arch}_{k}{step}"] = m[k].numpy()
        res[f"{arch}_coords"] = np.array(dist.coords)
        for path, leaf in _flat(params).items():
            res[f"{arch}_p_{path}"] = leaf.numpy()
    np.savez(Path(out_dir) / f"{rank}.npz", **res)
    torch.distributed.destroy_process_group()


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
    d = tmp_path_factory.mktemp("ring_encdec")
    me = str(Path(__file__).resolve())
    ref = subprocess.Popen(
        [sys.executable, me, "reference", str(d / "ref.npz")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = [(str(rank), subprocess.Popen(
        [sys.executable, me, "port", "4", str(rank), str(d / "store"),
         str(d)], env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for rank in range(4)]
    try:
        _finish(ranks, "port rank")
        _finish([("reference", ref)], "the")
    finally:
        for p in [ref] + [p for _, p in ranks]:
            if p.poll() is None:
                p.kill()
    return dict(np.load(d / "ref.npz")), [dict(np.load(d / f"{r}.npz"))
                                          for r in range(4)]


def _block(a, spec, coords):
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = MESH[0 if axis == "data" else 1]
        c = coords[0 if axis == "data" else 1]
        blk = a.shape[dim] // n
        a = np.take(a, range(c * blk, (c + 1) * blk), axis=dim)
    return a


@pytest.mark.parametrize("arch", ARCHS)
def test_trajectory_matches_reference(runs, arch):
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import param_specs

    ref, ranks = runs
    specs = _flat(param_specs(get_reduced(arch)))
    for p in ranks:
        coords = tuple(p[f"{arch}_coords"])
        for step in range(STEPS):
            np.testing.assert_allclose(p[f"{arch}_loss{step}"],
                                       ref[f"{arch}_loss{step}"],
                                       err_msg=f"loss {step}", **TOL)
            assert p[f"{arch}_tokens{step}"] == \
                ref[f"{arch}_tokens{step}"] == B * S
        for path, spec in specs.items():
            np.testing.assert_allclose(
                p[f"{arch}_p_{path}"],
                _block(ref[f"{arch}_p_{path}"], spec, coords),
                err_msg=path, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_under_torchrun(arch, tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", arch, "--reduced", "--device", "cpu", "--mesh", "1",
           "4", "--steps", "2", "--batch", "4", "--seq", "16"]
    res = subprocess.run(cmd, env=_env(OMP_NUM_THREADS="1"), cwd=tmp_path,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert out["steps"] == 2 and out["mesh"] == [1, 4]
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
