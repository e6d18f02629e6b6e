"""The port's dry-run held to the reference's on reduced configs and small
meshes.

The reference side compiles its cells in three subprocesses that import
``repro.launch.dryrun`` (which sets its own ``XLA_FLAGS``), each mesh
built from the first 4 host devices, through the reference's
``_build_lowered(..., unroll_scan=True).compile()``; its census is the
reference's ``collective_census`` of the compiled text and its FLOPs the
``dot`` products of that text (2 x output elements x contracted size,
each operand's shape looked up by name: the compiled text prints none
beside the operand).  The compile runs with XLA's CSE pass off, which
would otherwise merge the dgrad's weight stream with the forward's
identical one (ROADMAP C).  The port's side traces the same cells here,
on a ``fake`` process group.

Cells: reduced deepseek-7b train, prefill and decode at (1, 4) and (2, 1,
2); reduced olmoe-1b-7b train at (1, 4) (the all-to-all); reduced
mamba2-780m prefill at (1, 4) (the state relay).  Train cells run
without remat on both sides; deepseek-7b train at (1, 4) also with it.

Bytes by kind are equal but for the differences ROADMAP C names, each
mapped exactly:

* the reference's program keeps psums over an axis of one device (the
  optimizer's over ``data``) and its census counts them; the port issues
  no collective over an axis of one rank;
* ring attention's backward streams the K/V blocks again (the flash
  backward); the reference keeps them as autodiff residuals;
* the reference's census counts an all-gather's output bytes (the
  compiled text prints no operand shape); the port's counts output less
  input, and its serve steps' final gathers (the logits, the rows) are
  what the reference's ``out_specs`` assemble outside its program;
* under full remat the port's recompute runs each rep's last linear
  (``w_down``), whose output no gradient reads and which XLA drops.

FLOPs agree exactly after one named difference: the flash backward
recomputes each launch's scores (``2 B H Sq Sk D``), which the
reference's autodiff keeps.

Then fidelity: at (1, 1) the fake trace and a real CPU run of the same
step give equal FLOPs and equal peak live bytes under the same dispatch
mode; and the ``pod`` axis: a reduced deepseek-7b train step at (2, 1, 2)
and at (2, 2, 1) on 4 gloo ranks matches the reference's ``shard_map``
step on a ``(pod, data, model)`` mesh of 4 fake devices (the loss and
every gradient leaf within 1e-5), each rank's rows those of the
reference's ``batch_spec``.
"""

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
B, S = 4, 64
POD = (2, 1, 2)
# the pod-axis train steps: the ring under a pod axis, and pod and data
# both above 1, where pod-major and pod-minor rows differ
POD_STEPS = (POD, (2, 2, 1))
TIMEOUT = 300
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
NO_REMAT = {"remat": False}
CELLS = [("deepseek-7b", "train", (1, 4), False),
         ("deepseek-7b", "prefill", (1, 4), True),
         ("deepseek-7b", "decode", (1, 4), True),
         ("deepseek-7b", "train", POD, False),
         ("deepseek-7b", "prefill", POD, True),
         ("deepseek-7b", "decode", POD, True),
         ("olmoe-1b-7b", "train", (1, 4), False),
         ("mamba2-780m", "prefill", (1, 4), True),
         ("deepseek-7b", "train", (1, 4), True)]


def _key(arch, kind, mesh, remat):
    return f"{arch}:{kind}:{','.join(map(str, mesh))}:{int(remat)}"


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------


def _dot_flops(txt):
    """2 x output elements x contracted size over the ``dot`` ops of a
    compiled HLO text."""
    import re

    define = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*[a-z0-9]+"
                        r"\[([0-9,]*)\]")
    shapes = {}
    for line in txt.splitlines():
        m = define.match(line)
        if m:
            shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    total = 0
    for line in txt.splitlines():
        if " dot(" not in line:
            continue
        out = shapes[define.match(line).group(1)]
        lhs = shapes[line.split(" dot(", 1)[1].split(",")[0].strip()
                     .lstrip("%")]
        dims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line)
        total += 2 * int(np.prod(out)) * int(np.prod(
            [lhs[int(d)] for d in dims.group(1).split(",") if d]))
    return total


def _reference_cells(out_path, keys):
    import re

    sys.path.insert(0, str(SRC))
    import repro.launch.dryrun as rd

    os.environ["XLA_FLAGS"] += " --xla_disable_hlo_passes=cse"
    import jax

    from repro.configs import get_reduced
    from repro.configs.base import ShapeConfig
    from repro.core.dist import make_mesh

    singleton = re.compile(r"replica_groups=\{(\{\d+\},?)+\}")
    out = {}
    for key in keys:
        arch, kind, mesh, remat = key.split(":")
        mesh = tuple(int(x) for x in mesh.split(","))
        names = ("data", "model") if len(mesh) == 2 else ("pod", "data",
                                                          "model")
        n = int(np.prod(mesh))
        lowered = rd._build_lowered(
            get_reduced(arch), ShapeConfig("t", kind, S, B),
            make_mesh(mesh, names, devices=jax.devices()[:n]), "tatp", True,
            unroll_scan=True,
            par_overrides=None if int(remat) else NO_REMAT)
        txt = lowered.compile().as_text()
        out[key] = {
            "census": rd.collective_census(txt),
            "singleton": rd.collective_census("\n".join(
                ln for ln in txt.splitlines() if singleton.search(ln))),
            "dot_flops": _dot_flops(txt)}
    Path(out_path).write_text(json.dumps(out))


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


def _reference_pod(out_path, pod):
    """The reference's gradients and loss of one train step on the (pod,
    data, model) mesh ``pod`` of 4 fake devices, and each device's token
    block."""
    import jax
    from jax import lax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.core.dist import Dist, make_mesh
    from repro.models import lm
    from repro.models.transformer import RunCtx, param_shapes, param_specs
    from repro.train.data import SyntheticDataset
    from repro.train.train_loop import (batch_specs, reduce_model_axis_grads,
                                        token_axes)

    mesh = make_mesh(pod, ("pod", "data", "model"), devices=jax.devices())
    dist = Dist(mesh)
    cfg = get_reduced("deepseek-7b")
    par = ParallelConfig(strategy="tatp", remat=False)
    shape = ShapeConfig("t", "train", S, B)
    ctx = RunCtx(cfg, par, dist, phase="train")
    pspecs = param_specs(cfg, "tatp")
    bspecs = batch_specs(cfg, shape, par, dist)
    tok = token_axes(par, dist)
    shards = int(np.prod([dist.axis_sizes[a] for a in tok]))

    def local(params, batch):
        def local_loss(p):
            nll, cnt, aux = lm.loss_fn(ctx, p, batch)
            for a in tok:
                cnt = lax.psum(cnt, a)
            cnt = lax.stop_gradient(cnt)
            return nll / cnt + aux / shards, (nll, cnt)

        grads, (nll, cnt) = jax.grad(local_loss, has_aux=True)(params)
        grads = reduce_model_axis_grads(grads, pspecs, par, dist)
        for a in dist.present_batch_axes:  # the optimizer's DP psum
            grads = jax.tree.map(lambda g: lax.psum(g, a), grads)
        for a in tok:
            nll = lax.psum(nll, a)
        return grads, nll / cnt

    step = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(pspecs, bspecs),
                                 out_specs=(pspecs, P()), check_vma=False))
    shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
    batch = SyntheticDataset(cfg, shape, dist).batch(0, bspecs)
    grads, loss = step(jax.tree.map(np.asarray, _np_params(shapes)), batch)
    res = {"loss": np.asarray(loss),
           "tokens": np.asarray(batch["tokens"])}
    index = NamedSharding(mesh, bspecs["tokens"]).devices_indices_map(
        (B, S))
    for pos, dev in enumerate(mesh.devices.reshape(-1)):
        rows, cols = index[dev]
        res[f"rows{pos}"] = np.array([rows.start or 0, rows.stop or B])
        res[f"cols{pos}"] = np.array([cols.start or 0, cols.stop or S])
    for path, g in _flat(grads).items():
        res[f"g_{path}"] = np.asarray(g)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side of the pod check: four gloo ranks
# ---------------------------------------------------------------------------


def _port_pod_rank(rank, store_path, out_dir, pod):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import init_world, make_mesh_dist
    from repro_torch.models.transformer import (RunCtx, param_shapes,
                                                param_specs)
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.train_loop import (batch_rows, loss_and_grads,
                                              reduce_model_axis_grads,
                                              token_axes)
    from repro_torch.weights import params_from_jax, shard_params

    init_world("gloo", store=torch.distributed.FileStore(store_path, 4),
               rank=rank, world_size=4)
    dist = make_mesh_dist(pod, "cpu")
    cfg = get_reduced("deepseek-7b")
    par = ParallelConfig(strategy="tatp", remat=False)
    shape = ShapeConfig("t", "train", S, B)
    ctx = RunCtx(cfg, par, dist, phase="train")
    params = shard_params(params_from_jax(
        _np_params(param_shapes(cfg)), cfg, "cpu"), cfg, "tatp", dist)
    batch = SyntheticDataset(cfg, shape, dist).batch(0)
    nll, cnt, grads = loss_and_grads(ctx, params, batch)
    grads = reduce_model_axis_grads(grads, param_specs(cfg, "tatp"), par,
                                    dist)
    for a in dist.present_batch_axes:
        grads = tree_map(lambda g: dist.psum(g, a), grads)
    for a in token_axes(par, dist):
        nll = dist.psum(nll, a)
    rows = batch_rows(dist, B)
    res = {"coords": np.array(dist.coords), "loss": (nll / cnt).numpy(),
           "tokens": batch["tokens"].numpy(),
           "rows": np.array([rows.start, rows.stop]),
           "batch_index": np.array(dist.batch_index())}
    for path, g in _flat(grads).items():
        res[f"g_{path}"] = g.numpy()
    np.savez(Path(out_dir) / f"pod{_tag(pod)}_{rank}.npz", **res)
    torch.distributed.destroy_process_group()


def _tag(mesh):
    return "x".join(map(str, mesh))


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
    d = tmp_path_factory.mktemp("dryrun")
    me = str(Path(__file__).resolve())
    keys = [_key(*c) for c in CELLS]
    refs = [(str(w), subprocess.Popen(
        [sys.executable, me, "reference", str(d / f"ref{w}.json"),
         ";".join(keys[w::3])], env=_env(OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for w in range(3)]
    pod_refs = [(_tag(pod), subprocess.Popen(
        [sys.executable, me, "pod_reference", str(d / f"pod_ref{_tag(pod)}"
                                                   ".npz"), _tag(pod)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for pod in POD_STEPS]
    ranks = [(f"{_tag(pod)}:{r}", subprocess.Popen(
        [sys.executable, me, "pod_port", str(r),
         str(d / f"store{_tag(pod)}"), str(d), _tag(pod)],
        env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for pod in POD_STEPS for r in range(4)]
    port = {key: _port_cell(*cell) for key, cell in zip(keys, CELLS)}
    _finish(ranks, "port rank")
    _finish(pod_refs + refs, "reference")
    ref = {}
    for w in range(3):
        ref.update(json.loads((d / f"ref{w}.json").read_text()))
    pods = {_tag(pod): (dict(np.load(d / f"pod_ref{_tag(pod)}.npz")), [
        dict(np.load(d / f"pod{_tag(pod)}_{r}.npz")) for r in range(4)])
        for pod in POD_STEPS}
    return ref, port, pods


# ---------------------------------------------------------------------------
# the port's cells, with the named differences measured as they happen
# ---------------------------------------------------------------------------


def _port_cell(arch, kind, mesh, remat):
    """The traced cell and the figures of each named difference: the ring
    attention backward's K/V restream bytes (``restream``), its scores'
    recompute FLOPs (``scores``), and the all-gathers' output bytes inside
    the model functions (``gather_out``) and outside them
    (``assembly``)."""
    import repro_torch.kernels.flash_attention.ref as fref
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import dist as dmod
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.models import attention, lm

    extra = {"restream": 0, "scores": 0, "gather_out": 0, "assembly": 0}
    state = {"bwd": False, "model": False}
    mp = pytest.MonkeyPatch()
    bwd, rounds = attention._RingAttention.backward, attention._rounds
    bwd_ref, gather = fref.attention_bwd_ref, dmod.Dist.all_gather

    def backward(ctx, do):
        state["bwd"] = True
        try:
            return bwd(ctx, do)
        finally:
            state["bwd"] = False

    def rounds_(k, v, *a):
        for item in rounds(k, v, *a):
            if state["bwd"] and item[0] is not None:
                extra["restream"] += 2 * item[3].numel() * \
                    item[3].element_size()
            yield item

    def bwd_ref_(q, k, *a, **kw):
        b, h, sq, d = q.shape
        extra["scores"] += 2 * b * h * sq * k.shape[2] * d
        return bwd_ref(q, k, *a, **kw)

    def all_gather(self, x, axis, dim=-1):
        r = self.axis_size(axis)
        if r > 1:
            out = r * x.numel() * x.element_size()
            extra["gather_out" if state["model"] else "assembly"] += out
        return gather(self, x, axis, dim)

    def in_model(fn):
        def run(*a, **kw):
            state["model"] = True
            try:
                return fn(*a, **kw)
            finally:
                state["model"] = False
        return run

    mp.setattr(attention._RingAttention, "backward", staticmethod(backward))
    mp.setattr(attention, "_rounds", rounds_)
    mp.setattr(fref, "attention_bwd_ref", bwd_ref_)
    mp.setattr(dmod.Dist, "all_gather", all_gather)
    mp.setattr(lm, "prefill", in_model(lm.prefill))
    mp.setattr(lm, "decode_step", in_model(lm.decode_step))
    try:
        got = trace_cell(get_reduced(arch), ShapeConfig("t", kind, S, B),
                         mesh, par_overrides=None if remat else NO_REMAT)
    finally:
        mp.undo()
    return {**got, **extra}


def _dense_rep_tail(arch, mesh):
    """(FLOPs, collective-permute bytes) of one forward of every rep's
    ``w_down`` on the ring: what full remat recomputes in the port."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import _unit_and_reps

    cfg = get_reduced(arch)
    r = mesh[-1]
    _, reps = _unit_and_reps(cfg)
    tokens = B * S // int(np.prod(mesh))
    flops = 2 * tokens * cfg.d_ff * cfg.d_model
    block = cfg.d_ff * (cfg.d_model // r) * 4  # fp32 weight block
    return reps * flops, reps * (r - 1) * block


@pytest.mark.parametrize("cell", CELLS, ids=[_key(*c) for c in CELLS])
def test_census_matches_reference(runs, cell):
    ref, port = runs[0][_key(*cell)], runs[1][_key(*cell)]
    arch, kind, mesh, remat = cell
    got = port["collectives"]
    tail_flops, tail_bytes = (_dense_rep_tail(arch, mesh)
                              if kind == "train" and remat else (0, 0))
    for k in KINDS:
        want = ref["census"][k]["bytes"] - ref["singleton"][k]["bytes"]
        if k == "all-gather":
            # the reference counts each gather's output inside its program
            assert want == port["gather_out"], (k, want, port)
            continue
        if k == "collective-permute":
            want += port["restream"] + tail_bytes
        assert got[k]["bytes"] == want, (k, got[k], ref["census"][k], port)
    if kind == "train":
        assert ref["singleton"]["all-reduce"]["bytes"] > 0
        if mesh[-1] > 1:
            assert port["restream"] > 0
    if kind == "prefill":  # the logits, gathered on the port
        assert port["assembly"] > 0
    assert got["reduce-scatter"]["bytes"] == 0
    if arch == "olmoe-1b-7b":
        assert got["all-to-all"]["bytes"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=[_key(*c) for c in CELLS])
def test_flops_match_reference(runs, cell):
    """Equal dot FLOPs once the flash backward's score recompute (and, under
    full remat, the recomputed rep tails) are taken off; the serve steps'
    exactly, with no difference to name."""
    ref, port = runs[0][_key(*cell)], runs[1][_key(*cell)]
    arch, kind, mesh, remat = cell
    tail = _dense_rep_tail(arch, mesh)[0] if kind == "train" and remat \
        else 0
    assert port["flops"] - port["scores"] - tail == ref["dot_flops"]
    if kind == "train":
        assert port["scores"] > 0
    else:
        assert port["flops"] == ref["dot_flops"]


def test_fake_trace_equals_a_real_cpu_run():
    """At (1, 1) the fake trace and a real CPU run of the reduced deepseek
    train step (with remat) give equal FLOPs and peak live bytes under
    :class:`MemoryMeter`."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.core.dist import Dist
    from repro_torch.launch.dryrun import measure, trace_cell
    from repro_torch.train.train_loop import make_train_step

    cfg = get_reduced("deepseek-7b")
    shape = ShapeConfig("t", "train", S, B)
    fake = trace_cell(cfg, shape, (1, 1))
    dist = Dist(torch.device("cpu"))
    bundle = make_train_step(cfg, ParallelConfig(), dist, shape)

    def args():
        params, state = bundle.init_fn(torch.Generator().manual_seed(0))
        rng = np.random.RandomState(0)
        toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S + 1)))
        return params, state, {"tokens": toks[:, :-1].clone(),
                               "labels": toks[:, 1:].clone()}

    real = measure(bundle.step_fn, args, dist)
    assert real["flops"] == fake["flops"] > 0
    assert real["memory"] == fake["memory"]
    assert real["memory"]["temp_bytes"] > 0


@pytest.mark.parametrize("pod", POD_STEPS, ids=_tag)
def test_pod_step_matches_reference(runs, pod):
    """``pod`` ((2, 1, 2) or (2, 2, 1)) on 4 gloo ranks against the
    reference's (pod, data, model) mesh: the loss and every gradient leaf
    within 1e-5, each rank's token block the reference device's (rows
    over pod and data together, pod-major)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import param_specs

    ref, ranks = runs[2][_tag(pod)]
    specs = _flat(param_specs(get_reduced("deepseek-7b")))
    for pos, p in enumerate(ranks):
        q, d, m = (int(x) for x in p["coords"])
        assert (q * pod[1] + d) * pod[2] + m == pos
        assert int(p["batch_index"]) == q * pod[1] + d
        np.testing.assert_array_equal(p["rows"], ref[f"rows{pos}"])
        (r0, r1), (c0, c1) = ref[f"rows{pos}"], ref[f"cols{pos}"]
        np.testing.assert_array_equal(p["tokens"], ref["tokens"][r0:r1,
                                                                 c0:c1])
        np.testing.assert_allclose(p["loss"], ref["loss"], rtol=1e-5,
                                   atol=1e-5)
        for path, spec in specs.items():
            want = ref[f"g_{path}"]
            for dim, axis in enumerate(spec):
                if axis == "model":
                    blk = want.shape[dim] // pod[2]
                    want = np.take(want, range(m * blk, (m + 1) * blk),
                                   axis=dim)
            np.testing.assert_allclose(p[f"g_{path}"], want, rtol=1e-5,
                                       atol=1e-5, err_msg=path)


def test_train_cli_takes_a_pod_mesh(tmp_path):
    """``launch.train --mesh P D M`` under ``torch.distributed.run``: the
    (2, 1, 2) mesh trains, and its first loss is the (2, 2) mesh's: both
    split the rows two ways over their batch axes and the sequence over a
    ring of 2."""
    out = {}
    for mesh in (["2", "1", "2"], ["2", "2"]):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
               "--reduced", "--device", "cpu", "--mesh", *mesh, "--steps",
               "2", "--batch", "4", "--seq", "16"]
        res = subprocess.run(cmd, env=_env(OMP_NUM_THREADS="1"),
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=TIMEOUT)
        assert res.returncode == 0, res.stderr[-4000:]
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        assert len(lines) == 1, res.stdout
        out[len(mesh)] = json.loads(lines[0])
    assert out[3]["mesh"] == [2, 1, 2] and out[3]["steps"] == 2
    np.testing.assert_allclose(out[3]["first_loss"], out[2]["first_loss"],
                               rtol=1e-6)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference_cells(sys.argv[2], sys.argv[3].split(";"))
    elif sys.argv[1] == "pod_reference":
        _reference_pod(sys.argv[2], tuple(map(int, sys.argv[3].split("x"))))
    else:
        _port_pod_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                       tuple(map(int, sys.argv[5].split("x"))))
