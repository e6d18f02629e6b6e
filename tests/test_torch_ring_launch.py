"""The training CLI over ranks: restarts and pipeline stages, on the CPU.

``repro_torch.launch.train`` under ``torch.distributed.run`` on four gloo
ranks, reduced deepseek-7b in fp32:

* ``--mesh 1 4 --ckpt-dir ... --fail-at-step 4`` fails after the step-4
  checkpoint; the same command without the failure resumes there and ends
  in the files of a straight 6-step run, bit for bit; a restart of that
  step-4 checkpoint at ``--mesh 2 2`` (ZeRO-1 over ``data``) takes steps
  4 and 5 within 2e-4 of the (1, 4) run's;
* ``--wafers 8 --stage 0`` runs the stage plan's mesh for four ranks and
  its layer count (the checkpoint's leaves);

and :func:`repro_torch.launch.mesh.stage_device_partition` equals the
reference's on ``tests/test_plan.py``'s cases."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
TIMEOUT = 300
COMMON = ["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
          "--batch", "4", "--seq", "16", "--log-every", "100"]


def _env():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _torchrun(args, cwd, ok=True):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *args]
    res = subprocess.run(cmd, env=_env(), cwd=cwd, capture_output=True,
                         text=True, timeout=TIMEOUT)
    if ok:
        assert res.returncode == 0, res.stderr[-4000:]
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        assert len(lines) == 1, res.stdout
        return res.stdout, json.loads(lines[0])
    return res


def _files(ckpt_dir, step):
    with np.load(Path(ckpt_dir) / f"step_{step:08d}" / "proc00.npz") as z:
        return {k: z[k] for k in z.files}


def test_restart_under_torchrun_bitwise_and_on_another_mesh(tmp_path):
    run = COMMON + ["--steps", "6", "--ckpt-every", "2"]
    straight, failed = tmp_path / "straight", tmp_path / "failed"
    _torchrun(run + ["--mesh", "1", "4", "--ckpt-dir", str(straight)],
              tmp_path)
    res = _torchrun(run + ["--mesh", "1", "4", "--ckpt-dir", str(failed),
                           "--fail-at-step", "4"], tmp_path, ok=False)
    assert res.returncode != 0
    assert "simulated node failure at step 4" in res.stderr
    elastic = tmp_path / "elastic"
    shutil.copytree(failed, elastic)
    out, resumed = _torchrun(run + ["--mesh", "1", "4", "--ckpt-dir",
                                    str(failed)], tmp_path)
    assert out.count("resuming from") == 1 and resumed["steps"] == 2
    a, b = _files(straight, 6), _files(failed, 6)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert int(b["1/.step"]) == 6
    _, moved = _torchrun(run + ["--mesh", "2", "2", "--ckpt-dir",
                                str(elastic)], tmp_path)
    assert moved["mesh"] == [2, 2] and moved["steps"] == 2
    for k in ("first_loss", "last_loss"):
        np.testing.assert_allclose(moved[k], resumed[k], rtol=2e-4,
                                   atol=2e-4)
    # the (2, 2) run's checkpoint holds every leaf in its global shape
    c = _files(elastic, 6)
    assert {k: v.shape for k, v in c.items() if "@" not in k} == \
        {k: v.shape for k, v in b.items() if "@" not in k}


def test_wafers_stage_over_ranks_runs_the_stage_plan(tmp_path):
    """``--wafers 8 --stage 0`` on 16 reduced layers: the stage plan's
    mesh for four ranks, and its two layers in the checkpoint."""
    sys.path.insert(0, str(SRC))
    from dataclasses import replace

    from repro_torch.configs import get_reduced
    from repro_torch.launch.planning import resolve_multiwafer_plan

    cache = tmp_path / "plans"
    out, res = _torchrun(COMMON + [
        "--layers", "16", "--wafers", "8", "--stage", "0", "--steps", "2",
        "--plan-cache", str(cache), "--ckpt-dir", str(tmp_path / "ck")],
        tmp_path)
    plan = resolve_multiwafer_plan(
        replace(get_reduced("deepseek-7b"), n_layers=16), 4, 16,
        n_wafers=8, cache_dir=str(cache), remat=False)
    # rank 0 solves first; the other ranks read its cache entry
    assert out.count("[plan] solved fresh") == 1
    assert out.count("[plan] cache hit") == 3
    assert res["plan_hash"] == plan.plan_hash
    assert res["mesh"] == list(plan.stages[0].mesh_shape_for(4))
    with open(tmp_path / "ck" / "step_00000002" / "manifest.json") as f:
        man = json.load(f)
    assert man["meta"]["stage"] == 0
    assert man["meta"]["stage_layers"] == list(plan.stage_layers)
    shapes = {x["key"]: x["shape"] for x in man["leaves"]}
    assert shapes["0/layers/u0/wq"][0] == plan.stage_layers[0]


def _wafers(pkg):
    w = pkg.Wafer(pkg.WaferSpec())
    return [w, pkg.Wafer(pkg.WaferSpec()).with_faults(dies=[7])]


def test_stage_device_partition_matches_reference(tmp_path):
    """``tests/test_plan.py``'s cases: at full scale each stage its die
    count, contiguous and disjoint; at 8 devices proportional, never
    empty; fewer devices than stages raise."""
    from repro.configs import get_config as ref_config
    from repro.core import plan as rplan
    from repro.launch.mesh import stage_device_partition as ref_partition
    from repro.wafer import topology as rtopo
    from repro_torch.configs import get_config
    from repro_torch.core import plan as tplan
    from repro_torch.launch.mesh import stage_device_partition
    from repro_torch.wafer import topology as ttopo

    ref = rplan.compile_multiwafer_plan(
        _wafers(rtopo), ref_config("deepseek-7b"), 4, 512,
        cache_dir=str(tmp_path / "ref"), n_micro_candidates=(8,))
    port = tplan.compile_multiwafer_plan(
        _wafers(ttopo), get_config("deepseek-7b"), 4, 512,
        cache_dir=str(tmp_path / "port"), n_micro_candidates=(8,))
    sizes = [len(s.alive_dies) for s in port.stages]
    assert sizes == [len(s.alive_dies) for s in ref.stages]
    for n in (sum(sizes), 8, port.pp):
        assert stage_device_partition(port, n) == ref_partition(ref, n)
    blocks = stage_device_partition(port, sum(sizes))
    assert [len(b) for b in blocks] == sizes
    assert [i for b in blocks for i in b] == list(range(sum(sizes)))
    with pytest.raises(ValueError, match="cannot host"):
        stage_device_partition(port, port.pp - 1)
