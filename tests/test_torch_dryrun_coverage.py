"""The port's dry-run over every architecture x shape x mesh (the twin of
``tests/test_dryrun_coverage.py``, which reads the reference's sweep).

``repro_torch.launch.dryrun`` traces every cell itself here, into the
test's temporary directory: every registered architecture at full width
with its depth cut to one unit of its layer pattern (and one encoder
layer), on the real ``SHAPES`` and the production meshes (16, 16) and
(2, 16, 16).  Four subprocesses share the architectures; each runs the
CLI's ``main`` with that depth cut.  Every applicable cell must be
``ok`` with 256 or 512 devices, FLOPs above zero, collective-permute
bytes above zero where the step streams over the ring under ``tatp``
(train and prefill), and the keys the reference's test reads; every
``long_500k`` cell of a non-SSM family ``skipped``; no kernel built."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
WORKERS = 4
TIMEOUT = 600
KEYS = ("arch", "shape", "mesh", "status", "n_devices", "flops",
        "flops_raw", "collectives", "memory", "params", "active_params",
        "rank", "trace_s", "strategy", "bidirectional", "variant",
        "par_overrides")


def one_unit(arch):
    """``arch``'s config at full width with one unit of its layer pattern
    (and one encoder layer)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import _unit_and_reps

    cfg = get_config(arch)
    unit, _ = _unit_and_reps(cfg)
    return replace(cfg, n_layers=len(unit),
                   n_enc_layers=1 if cfg.n_enc_layers else 0)


def _worker(out, archs):
    sys.path.insert(0, str(SRC))
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import main

    failed = 0
    for arch in archs:
        for shape in SHAPES:
            failed += main(["--arch", arch, "--shape", shape, "--mesh",
                            "both", "--out", out], cfg_of=one_unit)
    assert _build._LIBS == {}, "the dry-run built a kernel"
    sys.exit(1 if failed else 0)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import ARCHITECTURES

    out = tmp_path_factory.mktemp("dryrun_torch")
    archs = list(ARCHITECTURES)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    me = str(Path(__file__).resolve())
    procs = [subprocess.Popen(
        [sys.executable, me, str(out), ",".join(archs[w::WORKERS])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for w in range(WORKERS)]
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("a dry-run worker timed out")
        assert p.returncode == 0, f"{stdout[-3000:]}\n{stderr[-3000:]}"
    return out


def test_all_cells_present_and_ok(records):
    from repro_torch.configs import (ARCHITECTURES, SHAPES, get_config,
                                     shape_applicable)

    missing, bad = [], []
    n_ok = n_skip = 0
    for arch in ARCHITECTURES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            for mesh in ("pod", "multipod"):
                path = records / f"{arch}__{shape.name}__{mesh}.json"
                if not path.exists():
                    missing.append(path)
                    continue
                rec = json.loads(path.read_text())
                if not shape_applicable(cfg, shape):
                    assert rec.get("status") == "skipped", path
                    assert cfg.family not in ("ssm", "hybrid")
                    n_skip += 1
                    continue
                if rec.get("status") != "ok":
                    bad.append((path.name, rec.get("status"),
                                rec.get("error")))
                    continue
                n_ok += 1
                assert set(KEYS) <= set(rec), path
                assert rec["flops"] > 0 and rec["flops"] == rec["flops_raw"]
                assert rec["n_devices"] == (512 if mesh == "multipod"
                                            else 256)
                assert rec["rank"] == 15
                assert rec["collectives"]["extrapolated"] is False
                if rec["strategy"] == "tatp" and shape.kind != "decode":
                    assert rec["collectives"]["collective-permute"][
                        "bytes"] > 0, path
                mem = rec["memory"]
                assert mem["peak_bytes"] == (mem["argument_bytes"]
                                             + mem["temp_bytes"])
                assert mem["argument_bytes"] > 0
    assert not missing, missing[:5]
    assert not bad, bad[:5]
    n_cells = len(ARCHITECTURES) * len(SHAPES)
    n_runnable = sum(1 for a in ARCHITECTURES for s in SHAPES.values()
                     if shape_applicable(get_config(a), s))
    assert n_ok == 2 * n_runnable
    assert n_skip == 2 * (n_cells - n_runnable)


def test_multipod_halves_each_ranks_rows(records):
    """On the multi-pod mesh the batch spreads over 32 ranks, not 16: a
    train step's rank holds half the rows and does half the FLOPs."""
    for arch in ("deepseek-7b", "mamba2-780m"):
        pod, multi = (json.loads((records / f"{arch}__train_4k__{m}.json")
                                 .read_text()) for m in ("pod", "multipod"))
        assert multi["flops"] * 2 == pytest.approx(pod["flops"], rel=1e-9)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2].split(","))
