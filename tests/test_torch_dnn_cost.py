"""The port's DNN cost surrogate (``repro_torch.wafer.dnn_cost``) against
the reference's (``repro.wafer.dnn_cost``) on the same inputs.

The numpy parts (features, the simulator-drawn dataset, the linear
baseline, the metrics) are copies, compared bitwise.  The MLP is torch
float32 against jax float32, held to stated tolerances:

* one forward pass on the reference's initial weights (converted with
  ``dnn_params_from_jax``): ``rtol = atol = 1e-5``;
* 20 epochs of training from those weights: every parameter within
  ``1e-5`` and every prediction (log-seconds) within ``1e-4`` of the
  reference's ``train_dnn(seed=0)``.

The reference runs in its own float32: other test modules switch jax's
x64 mode on for the cost engine's jitted tiers, which would draw the
reference's weights and run its MLP in float64, so every reference call
here sits inside ``jax.enable_x64(False)``.

Then the reference's own accuracy bar (``tests/test_wafer.py``'s
``test_dnn_cost_model_beats_regression``) on the port's surrogate trained
from its own seeded weights.  Everything runs on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import TABLE_II as REF_TABLE
from repro.wafer import dnn_cost as rdnn
from repro.wafer import simulator as rsim
from repro.wafer.topology import Wafer as RefWafer
from repro.wafer.topology import WaferSpec as RefSpec
from repro_torch.configs.paper_models import TABLE_II
from repro_torch.wafer import dnn_cost as tdnn
from repro_torch.wafer import simulator as tsim
from repro_torch.wafer.topology import Wafer, WaferSpec
from repro_torch.weights import dnn_params_from_jax

MODELS = ("gpt3-6.7b", "llama2-7b", "gpt3-175b")
HIDDEN = (256, 256, 128)
APPLY_TOL = 1e-5  # rtol = atol, one forward pass in fp32
PARAM_ATOL = 1e-5  # after TRAIN_EPOCHS from the same weights
PRED_ATOL = 1e-4  # log-seconds: 0.01 % of a latency
TRAIN_EPOCHS = 20


def _datasets(n, protocol="paper", seed=0):
    ref = rdnn.make_dataset(RefWafer(RefSpec()),
                            [REF_TABLE[m][0] for m in MODELS], n=n,
                            seed=seed, protocol=protocol)
    port = tdnn.make_dataset(Wafer(WaferSpec()),
                             [TABLE_II[m][0] for m in MODELS], n=n,
                             seed=seed, protocol=protocol)
    return ref, port


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def paper_data():
    return _datasets(120)


@pytest.fixture(scope="module")
def ref_init(paper_data):
    (xs, ys), _ = paper_data
    sizes = (xs.shape[1], *HIDDEN, ys.shape[1])
    with jax.enable_x64(False):
        init = jax.tree.map(np.asarray, rdnn._mlp_init(jax.random.key(0),
                                                       sizes))
    assert all(v.dtype == np.float32 for v in init.values())
    return init


def test_names_and_features_match_reference():
    assert tdnn.FEATURES == rdnn.FEATURES
    assert tdnn.TARGETS == rdnn.TARGETS
    for model in MODELS:
        rc, tc = REF_TABLE[model][0], TABLE_II[model][0]
        for deg in ((2, 1, 1, 16, False), (1, 4, 2, 4, True),
                    (32, 1, 1, 1, False), (4, 8, 1, 1, True)):
            for engine, bidir in (("tcme", True), ("smap", False)):
                _same(rdnn.featurize(rc, 64, 2048,
                                     rsim.ParallelDegrees(*deg), engine,
                                     bidir),
                      tdnn.featurize(tc, 64, 2048,
                                     tsim.ParallelDegrees(*deg), engine,
                                     bidir))


@pytest.mark.parametrize("protocol", ("paper", "wide"))
def test_make_dataset_matches_reference(protocol):
    """The same 60 cases drawn from the seeded RNG and priced by each
    package's ``simulate_step``, features and targets bitwise."""
    (rx, ry), (tx, ty) = _datasets(60, protocol, seed=3)
    _same(rx, tx)
    _same(ry, ty)


def test_linear_baseline_and_metrics_match_reference(paper_data):
    (rx, ry), (tx, ty) = paper_data
    lin_r, lin_t = rdnn.fit_linear(rx[:96], ry[:96]), \
        tdnn.fit_linear(tx[:96], ty[:96])
    pr, pt = lin_r(rx[96:]), lin_t(tx[96:])
    _same(pr, pt)
    assert rdnn.evaluate(pr, ry[96:]) == tdnn.evaluate(pt, ty[96:])
    noisy = ty[96:] + np.float32(0.01)
    assert rdnn.evaluate(noisy, ry[96:]) == tdnn.evaluate(noisy, ty[96:])


def test_mlp_apply_matches_reference(paper_data, ref_init):
    (xs, _), _ = paper_data
    with jax.enable_x64(False):
        want = np.asarray(rdnn._mlp_apply(ref_init, xs))
    params = dnn_params_from_jax(ref_init, "cpu")
    assert all(p.dtype == torch.float32 for p in params.values())
    with torch.no_grad():
        got = tdnn._mlp_apply(params, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=APPLY_TOL, atol=APPLY_TOL)


def test_train_dnn_tracks_reference_from_its_weights(paper_data, ref_init):
    """``train_dnn(init=...)`` from the reference's own initial weights
    follows the reference's ``train_dnn(seed=0)`` for 20 epochs of the
    same Adam update (warmup, cosine rate, bias correction)."""
    (rx, ry), (tx, ty) = paper_data
    with jax.enable_x64(False):
        ref = rdnn.train_dnn(rx[:96], ry[:96], epochs=TRAIN_EPOCHS, seed=0)
        ref_pred = ref.predict(rx[96:])
        ref_step = ref.predict_step_time(REF_TABLE["gpt3-6.7b"][0], 64,
                                         2048, rsim.ParallelDegrees(2, 1, 1,
                                                                    16),
                                         "tcme")
    port = tdnn.train_dnn(tx[:96], ty[:96], epochs=TRAIN_EPOCHS,
                          device="cpu",
                          init=dnn_params_from_jax(ref_init, "cpu"))
    assert set(port.params) == set(ref.params)
    for k, p in port.params.items():
        assert np.asarray(ref.params[k]).dtype == np.float32, k
        np.testing.assert_allclose(p.numpy(), np.asarray(ref.params[k]),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    for a in ("x_mu", "x_sd", "y_mu", "y_sd"):
        _same(getattr(ref, a), getattr(port, a))
    got = port.predict(tx[96:])
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref_pred, rtol=0, atol=PRED_ATOL)
    assert port.predict_step_time(TABLE_II["gpt3-6.7b"][0], 64, 2048,
                                  tsim.ParallelDegrees(2, 1, 1, 16),
                                  "tcme") == \
        pytest.approx(ref_step, rel=PRED_ATOL)


def test_dnn_cost_model_beats_regression():
    """Twin of ``tests/test_wafer.py::test_dnn_cost_model_beats_regression``
    (220 gpt3-6.7b cases, 180 to train, 300 epochs), on the port's own
    seeded initial weights."""
    xs, ys = tdnn.make_dataset(Wafer(WaferSpec()), [TABLE_II["gpt3-6.7b"][0]],
                               n=220, seed=0)
    xtr, xte = xs[:180], xs[180:]
    ytr, yte = ys[:180], ys[180:]
    dnn = tdnn.train_dnn(xtr, ytr, epochs=300, device="cpu")
    lin = tdnn.fit_linear(xtr, ytr)
    dnn_m = tdnn.evaluate(dnn.predict(xte), yte)
    lin_m = tdnn.evaluate(lin(xte), yte)
    assert dnn_m["log_step"]["corr"] > 0.97
    assert dnn_m["log_step"]["rel_err"] < lin_m["log_step"]["rel_err"] * 1.1


def test_train_dnn_seeds_its_weights_and_checks_init(paper_data):
    _, (xs, ys) = paper_data
    a = tdnn.train_dnn(xs, ys, epochs=2, seed=7, device="cpu")
    b = tdnn.train_dnn(xs, ys, epochs=2, seed=7, device="cpu")
    c = tdnn.train_dnn(xs, ys, epochs=2, seed=8, device="cpu")
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert not torch.equal(a.params["w0"], c.params["w0"])
    init = tdnn._mlp_init(torch.Generator().manual_seed(7),
                          (xs.shape[1], *HIDDEN, ys.shape[1]))
    for k, w in init.items():
        if k.startswith("w"):  # He-normal: std sqrt(2 / fan_in)
            assert abs(float(w.std()) / (2.0 / w.shape[0]) ** 0.5 - 1) < 0.1
        else:
            assert not w.any()
    with pytest.raises(ValueError, match="shapes"):
        tdnn.train_dnn(xs, ys, epochs=1, device="cpu", hidden=(64,),
                       init=init)
    with pytest.raises(ValueError, match="not an MLP"):
        dnn_params_from_jax({"w0": np.zeros((3, 4)), "b0": np.zeros(5)},
                            "cpu")


def test_train_dnn_needs_a_gpu_or_device_cpu(paper_data, monkeypatch):
    _, (xs, ys) = paper_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdnn.train_dnn(xs, ys, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dnn_params_from_jax({"w0": np.zeros((3, 4)), "b0": np.zeros(4)})


def test_cost_model_is_a_dataclass_of_the_reference_fields():
    assert [f.name for f in dataclasses.fields(tdnn.DNNCostModel)] == \
        [f.name for f in dataclasses.fields(rdnn.DNNCostModel)]
