"""The train step on the ring and over the data axis against the reference
on the CPU.

As ``tests/test_torch_ring.py``: four gloo ranks (a ``FileStore`` under
the test's temporary directory) and the reference's ``make_train_step``
under ``shard_map`` on 4 fake CPU devices in a subprocess, both from the
same seeded weights (:func:`_np_params`) and the same synthetic batches
(the reference's LCG stream, each rank taking its rows and its sequence
block).  On the meshes (1, 4), (2, 2) and (4, 1), three steps of the
reduced deepseek-7b in fp32:

* each step's loss, token count and grad norm, and the final parameters
  (each rank's shards), at 2e-4;
* the optimizer state each rank keeps: ZeRO-1's slices of the flattened,
  padded leaves over ``data`` (or the full leaves at data degree 1),
  against each fake device's shard of the reference's state;

the dry-run's trace of each rank on a ``fake`` process group counts the
collectives that rank's gloo run issued; and ``launch.train --mesh 1 4
--device cpu`` under ``torch.distributed.run`` prints the reference's
keys."""

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
ARCH = "deepseek-7b"
MESHES = ((1, 4), (2, 2), (4, 1))
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


def _tag(shape):
    return "x".join(map(str, shape))


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


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
    cfg = get_reduced(ARCH)
    shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
    res = {}
    for mesh_shape in MESHES:
        tag = _tag(mesh_shape)
        dist = Dist(make_mesh(mesh_shape, ("data", "model"), devices=devs))
        shape = ShapeConfig("t", "train", S, B)
        tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False), dist, shape)
        params = jax.tree.map(jnp.asarray, _np_params(shapes))
        opt_init = jax.jit(jax.shard_map(
            tb.opt.init, mesh=dist.mesh, in_specs=(tb.pspecs,),
            out_specs=tb.ospecs, check_vma=False))
        state = opt_init(params)
        data = SyntheticDataset(cfg, shape, dist)
        for step in range(STEPS):
            params, state, m = tb.step_fn(params, state,
                                          data.batch(step, tb.bspecs))
            for k in ("loss", "tokens", "grad_norm"):
                res[f"{tag}_{k}{step}"] = np.asarray(m[k])
        for path, leaf in _flat(params).items():
            res[f"{tag}_p_{path}"] = np.asarray(leaf)
        order = {d: n for n, d in enumerate(devs)}
        for part in ("master", "m", "v"):
            for path, leaf in _flat(getattr(state, part)).items():
                for sh in leaf.addressable_shards:
                    res[f"{tag}_{part}{order[sh.device]}_{path}"] = \
                        np.asarray(sh.data)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import init_world, make_mesh_dist
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.weights import params_from_jax, shard_params

    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    cfg = get_reduced(ARCH)
    res = {}
    for mesh_shape in MESHES:
        tag = _tag(mesh_shape)
        dist = make_mesh_dist(mesh_shape, "cpu")
        shape = ShapeConfig("t", "train", S, B)
        tb = make_train_step(cfg, ParallelConfig(strategy="tatp",
                                                 remat=False), dist, shape)
        params = shard_params(params_from_jax(
            _np_params(param_shapes(cfg)), cfg, "cpu"), cfg, "tatp", dist)
        state = tb.opt.init(params)
        data = SyntheticDataset(cfg, shape, dist)
        for step in range(STEPS):
            batch = data.batch(step)
            dist.census.reset()  # the last step's collectives stay
            params, state, m = tb.step_fn(params, state, batch)
            for k in ("loss", "tokens", "grad_norm"):
                res[f"{tag}_{k}{step}"] = m[k].numpy()
        res[f"{tag}_census"] = np.array(json.dumps(dist.census.as_dict()))
        res[f"{tag}_coords"] = np.array(dist.coords)
        res[f"{tag}_shard_axis"] = np.array(str(tb.opt.shard_axis))
        for path, leaf in _flat(params).items():
            res[f"{tag}_p_{path}"] = leaf.numpy()
        for part in ("master", "m", "v"):
            for path, leaf in tree_leaves(getattr(state, part)):
                res[f"{tag}_{part}_{'/'.join(path)}"] = leaf.numpy()
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
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_train")
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
    return dict(np.load(d / "ref.npz")), [dict(np.load(d / f"{r}.npz"))
                                          for r in range(4)]


def _block(a, spec, coords, shape):
    """The global ``a``'s block on the rank at ``coords`` by ``spec`` (one
    entry a dim: an axis name or None)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = shape[0 if axis == "data" else 1]
        c = coords[0 if axis == "data" else 1]
        blk = a.shape[dim] // n
        a = np.take(a, range(c * blk, (c + 1) * blk), axis=dim)
    return a


@pytest.mark.parametrize("shape", MESHES)
def test_trajectory_matches_reference(runs, shape):
    """Loss and tokens at every step on every rank; each rank's parameter
    shards after the third step.  The grad norm: the reference's AdamW
    psums the squared norm over ``data`` only, so above model degree 1
    each rank clips by the norm of its own shards, and the step's
    ``grad_norm`` metric (out spec ``P()``) is device 0's.  The port
    does the same; the ranks at model index 0 hold that value."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import param_specs

    ref, ranks = runs
    tag = _tag(shape)
    specs = _flat(param_specs(get_reduced(ARCH)))
    for p in ranks:
        coords = tuple(p[f"{tag}_coords"])
        keys = ("loss", "grad_norm") if coords[1] == 0 else ("loss",)
        for step in range(STEPS):
            for k in keys:
                np.testing.assert_allclose(p[f"{tag}_{k}{step}"],
                                           ref[f"{tag}_{k}{step}"],
                                           err_msg=f"{k} {step}", **TOL)
            assert p[f"{tag}_tokens{step}"] == ref[f"{tag}_tokens{step}"] \
                == B * S
        for path, spec in specs.items():
            np.testing.assert_allclose(
                p[f"{tag}_p_{path}"],
                _block(ref[f"{tag}_p_{path}"], spec, coords, shape),
                err_msg=path, **TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_zero1_state_matches_reference_shards(runs, shape):
    """ZeRO-1 over ``data`` (a flat slice of each leaf a rank) where the
    data degree is above 1; the full leaves of the rank's shards at (1,
    4).  Each against that fake device's shard of the reference's state
    (its ``ospecs``), at 2e-4 of the leaf's largest value."""
    ref, ranks = runs
    tag = _tag(shape)
    for g, p in enumerate(ranks):
        assert str(p[f"{tag}_shard_axis"]) == ("None" if shape[0] == 1
                                               else "data")
        n = 0
        for key in p:
            for part in ("master", "m", "v"):
                pre = f"{tag}_{part}_"
                if not key.startswith(pre):
                    continue
                want = ref[f"{tag}_{part}{g}_{key[len(pre):]}"]
                got = p[key]
                assert got.shape == want.shape, key
                if shape[0] > 1:
                    assert got.ndim == 1, key
                scale = max(float(np.abs(want).max()), 1e-30)
                np.testing.assert_allclose(got, want, rtol=2e-4,
                                           atol=2e-4 * scale, err_msg=key)
                n += 1
        assert n > 0


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_fake_trace_census_equals_each_gloo_ranks(runs, shape):
    """The dry-run's trace of a rank on a ``fake`` process group counts the
    collectives that rank's gloo run of the same step issued: kind by
    kind, count and bytes."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import trace_cell

    _, ranks = runs
    tag = _tag(shape)
    for g, p in enumerate(ranks):
        fake = trace_cell(get_reduced(ARCH), ShapeConfig("t", "train", S, B),
                          shape, par_overrides={"remat": False},
                          rank=g)["collectives"]
        assert fake.pop("extrapolated") is False
        assert fake == json.loads(str(p[f"{tag}_census"])), g
        assert fake["total_bytes"] > 0


def test_train_cli_under_torchrun_prints_reference_keys(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "1",
           "4", "--steps", "2", "--batch", "4", "--seq", "16"]
    res = subprocess.run(cmd, env=_env(OMP_NUM_THREADS="1"), cwd=tmp_path,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert set(out) == {"first_loss", "last_loss", "steps", "mean_step_s",
                        "plan_hash", "mesh"}
    assert out["steps"] == 2 and out["mesh"] == [1, 4]
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
