"""Checkpoints over the ranks of a mesh against the reference on the CPU.

As ``tests/test_torch_ring_train.py``: four gloo ranks (a ``FileStore``
under the test's temporary directory) and the reference's
``make_train_step`` under ``shard_map`` on 4 fake CPU devices in a
subprocess, from the same seeded weights (:func:`_np_params`) and the same
synthetic batches, reduced deepseek-7b in fp32.  The two sides run at
once and hand each other checkpoints through the temporary directory
(each waits for the other's ``LATEST``):

* the reference trains 2 steps at (1, 4) and saves; the port's ranks
  restore that checkpoint at (1, 4) and at (2, 2) and save it again at
  once: the files equal the reference's bit for bit (every leaf's global
  array, the ZeRO-1 state at (2, 2) included), and rank 0 alone restores
  the (2, 2) copy at (1, 1) and saves it, equal too;
* from each restore the port trains steps 2 and 3: the losses lie within
  2e-4 of the reference's straight 4-step run at (1, 4);
* the port's ranks train 2 steps at (1, 4) and save; the reference's
  ``restore`` reads that checkpoint on its (1, 4) mesh: every leaf equals
  the file's, and its steps 2 and 3 follow its straight run within 2e-4;
* the reference's ZeRO-1 state written at (2, 2) (its out spec keeps one
  model rank's slices of a ring-sharded leaf) cannot be placed at (4, 1):
  the reference's restore gives shards of another length than its step
  takes, and the port's raises ``ValueError`` naming the leaf;

and ``launch.mesh.make_stage_submeshes`` splits the ranks into a
pipeline's stages, each with its own mesh and groups."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
ARCH = "deepseek-7b"
B, S = 4, 16
SAVE_AT, STEPS = 2, 4
TOL = dict(rtol=2e-4, atol=2e-4)
TIMEOUT = 300
RESTORES = ((1, 4), (2, 2))


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


def _wait_for(ckpt_dir):
    t0 = time.time()
    while not os.path.exists(os.path.join(ckpt_dir, "LATEST")):
        if time.time() - t0 > TIMEOUT:
            raise TimeoutError(f"no checkpoint in {ckpt_dir}")
        time.sleep(0.05)


def _tag(shape):
    return "x".join(map(str, shape))


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


def _reference(d):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.core.dist import Dist, make_mesh
    from repro.models.transformer import param_shapes
    from repro.train import checkpoint as jckpt
    from repro.train.data import SyntheticDataset
    from repro.train.train_loop import make_train_step

    d = Path(d)
    devs = jax.devices()
    assert len(devs) == 4, devs
    cfg = get_reduced(ARCH)
    shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
    shape = ShapeConfig("t", "train", S, B)
    par = ParallelConfig(strategy="tatp", remat=False)

    def bundle(mesh_shape):
        dist = Dist(make_mesh(mesh_shape, ("data", "model"), devices=devs))
        return dist, make_train_step(cfg, par, dist, shape)

    def fresh(dist, tb):
        params = jax.tree.map(jnp.asarray, _np_params(shapes))
        opt_init = jax.jit(jax.shard_map(
            tb.opt.init, mesh=dist.mesh, in_specs=(tb.pspecs,),
            out_specs=tb.ospecs, check_vma=False))
        return params, opt_init(params)

    res = {}
    dist, tb = bundle((1, 4))
    data = SyntheticDataset(cfg, shape, dist)
    params, state = fresh(dist, tb)
    for step in range(STEPS):
        if step == SAVE_AT:
            jckpt.save(str(d / "ref14"), step, (params, state))
        params, state, m = tb.step_fn(params, state,
                                      data.batch(step, tb.bspecs))
        res[f"straight{step}"] = np.asarray(m["loss"])
    # a ZeRO-1 state at (2, 2), then its restore at (4, 1)
    dist22, tb22 = bundle((2, 2))
    jckpt.save(str(d / "ref22"), 0, fresh(dist22, tb22))
    dist41, tb41 = bundle((4, 1))
    template = jax.eval_shape(lambda: tb41.init_fn(jax.random.key(0)))
    n = int(np.prod(shapes["layers"]["u0"]["wq"]))
    res["ref41_step_shard"] = np.array([(n + (-n) % 4) // 4])
    try:
        (_, st41), _ = jckpt.restore(str(d / "ref22"), template, dist41,
                                     (tb41.pspecs, tb41.ospecs))
        res["ref41_shard"] = np.array(st41.master["layers"]["u0"]["wq"]
                                      .addressable_shards[0].data.shape)
    except Exception:  # noqa: BLE001 - a failed placement is the finding
        res["ref41_shard"] = np.array([-1])
    # the port's checkpoint on the reference's (1, 4) mesh
    _wait_for(str(d / "port14"))
    template = jax.eval_shape(lambda: tb.init_fn(jax.random.key(0)))
    (params, state), step = jckpt.restore(str(d / "port14"), template, dist,
                                          (tb.pspecs, tb.ospecs))
    assert step == SAVE_AT, step
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            (params, state))[0]:
        res["restored_" + jckpt._leaf_key(path)] = np.asarray(leaf)
    for step in range(SAVE_AT, STEPS):
        params, state, m = tb.step_fn(params, state,
                                      data.batch(step, tb.bspecs))
        res[f"resumed{step}"] = np.asarray(m["loss"])
    np.savez(d / "ref.npz", **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _port_rank(world, rank, d):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist, init_world, make_mesh_dist
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.weights import params_from_jax, shard_params

    d = Path(d)
    init_world("gloo", store=torch.distributed.FileStore(str(d / "store"),
                                                         world),
               rank=rank, world_size=world)
    cfg = get_reduced(ARCH)
    shape = ShapeConfig("t", "train", S, B)
    par = ParallelConfig(strategy="tatp", remat=False)
    full = params_from_jax(_np_params(param_shapes(cfg)), cfg, "cpu")
    res = {}

    def bundle(dist):
        tb = make_train_step(cfg, par, dist, shape)
        params = shard_params(full, cfg, "tatp", dist)
        return tb, params, tb.opt.init(params)

    def steps(tb, params, state, dist, lo, tag):
        data = SyntheticDataset(cfg, shape, dist)
        for step in range(lo, STEPS):
            params, state, m = tb.step_fn(params, state, data.batch(step))
            res[f"{tag}{step}"] = m["loss"].numpy()
        return params, state

    # the port writes at (1, 4) for the reference
    dist = make_mesh_dist((1, 4), "cpu")
    tb, params, state = bundle(dist)
    data = SyntheticDataset(cfg, shape, dist)
    for step in range(SAVE_AT):
        params, state, _ = tb.step_fn(params, state, data.batch(step))
    ckpt.save(str(d / "port14"), SAVE_AT, (params, state), dist=dist,
              specs=tb.specs(params))
    # the reference's (1, 4) checkpoint on the port's meshes
    _wait_for(str(d / "ref14"))
    for mesh in RESTORES:
        tag = _tag(mesh)
        dist = make_mesh_dist(mesh, "cpu")
        tb, params, state = bundle(dist)
        io = dict(dist=dist, specs=tb.specs(params))
        (params, state), step = ckpt.restore(str(d / "ref14"),
                                             (params, state), **io)
        assert step == SAVE_AT, step
        ckpt.save(str(d / f"again{tag}"), step, (params, state), **io)
        steps(tb, params, state, dist, SAVE_AT, f"loss{tag}_")
    if rank == 0:  # the (2, 2) copy on one device
        dist = Dist(torch.device("cpu"))
        tb, params, state = bundle(dist)
        (params, state), step = ckpt.restore(str(d / "again2x2"),
                                             (params, state))
        ckpt.save(str(d / "again1x1"), step, (params, state))
        steps(tb, params, state, dist, SAVE_AT, "loss1x1_")
    # the reference's ZeRO-1 state of (2, 2) at (4, 1)
    _wait_for(str(d / "ref22"))
    dist = make_mesh_dist((4, 1), "cpu")
    tb, params, state = bundle(dist)
    try:
        ckpt.restore(str(d / "ref22"), (params, state), dist=dist,
                     specs=tb.specs(params))
        res["zero_error"] = np.array("")
    except ValueError as e:
        res["zero_error"] = np.array(str(e))
    # a two-stage plan's submeshes over the four ranks
    from types import SimpleNamespace

    from repro_torch.launch.mesh import make_stage_submeshes
    stage = SimpleNamespace(alive_dies=tuple(range(32)),
                            device_order=tuple(range(32)),
                            mesh_shape_for=lambda n: (1, n))
    subs = make_stage_submeshes(SimpleNamespace(pp=2, stages=[stage] * 2),
                                "cpu")
    res["stage_blocks"] = np.array([b for b, _ in subs])
    (mine,) = [s for _, s in subs if s is not None]
    res["stage_mesh"] = np.array(mine.mesh_shape)
    res["stage_sum"] = mine.psum(torch.tensor([float(rank)]), "model").numpy()
    np.savez(d / f"{rank}.npz", **res)
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
    d = tmp_path_factory.mktemp("ring_ckpt")
    me = str(Path(__file__).resolve())
    ref = subprocess.Popen(
        [sys.executable, me, "reference", str(d)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = [(str(rank), subprocess.Popen(
        [sys.executable, me, "port", "4", str(rank), str(d)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for rank in range(4)]
    try:
        _finish(ranks, "port rank")
        _finish([("reference", ref)], "the")
    finally:
        for p in [ref] + [p for _, p in ranks]:
            if p.poll() is None:
                p.kill()
    return d, dict(np.load(d / "ref.npz")), [dict(np.load(d / f"{r}.npz"))
                                             for r in range(4)]


def _files(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_files(a, b):
    fa = _files(Path(a) / f"step_{SAVE_AT:08d}" / "proc00.npz")
    fb = _files(Path(b) / f"step_{SAVE_AT:08d}" / "proc00.npz")
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("mesh", RESTORES + ((1, 1),))
def test_reference_checkpoint_restores_bitwise(runs, mesh):
    """Restore then save on the port's mesh gives the reference's files,
    every leaf bit for bit (the manifests' leaves too)."""
    d = runs[0]
    _same_files(d / "ref14", d / f"again{_tag(mesh)}")
    import json
    man = [json.load(open(Path(x) / f"step_{SAVE_AT:08d}" / "manifest.json"))
           for x in (d / "ref14", d / f"again{_tag(mesh)}")]
    assert man[0]["leaves"] == man[1]["leaves"]


@pytest.mark.parametrize("mesh", RESTORES + ((1, 1),))
def test_restart_on_another_mesh_follows_reference(runs, mesh):
    """Steps 2 and 3 after the restore, on every rank, against the
    reference's straight run at (1, 4)."""
    _, ref, ranks = runs
    tag = _tag(mesh)
    for p in (ranks[:1] if mesh == (1, 1) else ranks):
        for step in range(SAVE_AT, STEPS):
            np.testing.assert_allclose(p[f"loss{tag}_{step}"],
                                       ref[f"straight{step}"],
                                       err_msg=f"step {step}", **TOL)


def test_port_checkpoint_restores_in_reference(runs):
    """The port's ranks' checkpoint on the reference's (1, 4) mesh: every
    leaf the file's, bit for bit, and the steps after it follow the
    reference's straight run."""
    d, ref, _ = runs
    files = _files(d / "port14" / f"step_{SAVE_AT:08d}" / "proc00.npz")
    files = {k: v for k, v in files.items() if "@" not in k}
    keys = [k for k in ref if k.startswith("restored_")]
    assert sorted(k[len("restored_"):] for k in keys) == sorted(files)
    for k in keys:
        want = files[k[len("restored_"):]]
        assert ref[k].dtype == want.dtype, k
        assert np.array_equal(ref[k], want), k
    for step in range(SAVE_AT, STEPS):
        np.testing.assert_allclose(ref[f"resumed{step}"],
                                   ref[f"straight{step}"], **TOL)


def test_unplaceable_zero1_state_raises_where_reference_fails(runs):
    """The reference's (2, 2) ZeRO-1 state at (4, 1): its restore gives
    shards its step cannot take; the port's raises naming a leaf."""
    _, ref, ranks = runs
    assert tuple(ref["ref41_shard"]) != tuple(ref["ref41_step_shard"])
    for p in ranks:
        msg = str(p["zero_error"])
        assert "cannot be placed as ZeRO-1's slice" in msg, msg
        assert msg.startswith("1/.master/") or msg.startswith("1/.m/"), msg


def test_stage_submeshes_over_ranks(runs):
    """``make_stage_submeshes`` of a two-stage plan on four ranks: the
    blocks [0, 1] and [2, 3], each rank on its stage's (1, 2) mesh, whose
    ring sums over the block alone."""
    _, _, ranks = runs
    for rank, p in enumerate(ranks):
        assert p["stage_blocks"].tolist() == [[0, 1], [2, 3]]
        assert tuple(p["stage_mesh"]) == (1, 2)
        block = [0, 1] if rank < 2 else [2, 3]
        assert p["stage_sum"].tolist() == [float(sum(block))]


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
