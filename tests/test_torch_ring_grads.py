"""The train ring's gradients (model degree above 1) against the reference
on the CPU.

As ``tests/test_torch_ring.py``: the port's ranks are processes joined by
gloo (a ``FileStore`` under the test's temporary directory), the
reference runs ``shard_map`` on 4 fake CPU devices in a subprocess, both
sides run this file as a script on the same seeded numpy inputs
(:func:`_inputs`) and write numpy outputs, which the tests compare in
fp32 at 1e-5:

* ``Dist.ppermute`` and ``wire_relay`` (every wire) against ``jax.vjp``
  of ``lax.ppermute`` and the reference's ``wire_relay``;
* ``dgrad_stream_w`` (every wire), ``wgrad_rs`` and ``tatp_matmul``'s
  gradients at R = 2, 3 and 4, both orders, against the reference's
  functions and ``jax.vjp`` of its ``tatp_matmul``;
* ``ring_attention``'s dq/dk/dv for the four attention cases, both
  orders, on the online-softmax loop and on the hook (the flash kernel's
  plain versions here), against ``jax.vjp`` of the reference's;
* ``streamed_vocab_xent`` and its gradients (activations and head shard)
  at mesh (1, 4) on the reduced deepseek-7b.

Also here: the plain flash backward with an outside delta equals its own
delta at degree 1."""

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
M, N, KB = 4, 16, 8  # per-rank rows, contraction, weight columns
RINGS = (2, 3, 4)
WIRES = ("native", "bf16", "fp8")
ORDERS = (True, False)  # bidirectional, naive
SHIFTS = (-1, 1)
# ring attention at R = 4: batch, per-rank sequence, heads, head dim
AB, ASL, AH, AD = 2, 4, 4, 16
ATTN_CASES = {"causal": (True, None, 4), "unmasked": (False, None, 4),
              "capped": (True, 0.5, 4), "gqa": (True, None, 2)}
XB, XS = 2, 8  # the cross-entropy's batch and global sequence
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 300


def _inputs():
    rng = np.random.RandomState(0)
    out = {"relay": rng.randn(4, 3, 5).astype(np.float32),
           "relay_ct": rng.randn(4, 3, 5).astype(np.float32)}
    for r in RINGS:
        out[f"x{r}"] = rng.randn(r * M, N).astype(np.float32)
        out[f"w{r}"] = (rng.randn(N, r * KB)
                        * np.exp(rng.randn(N, r * KB))).astype(np.float32)
        out[f"dy{r}"] = rng.randn(r * M, r * KB).astype(np.float32)
    for name, (_, _, hkv) in ATTN_CASES.items():
        s = 4 * ASL
        out[f"q_{name}"] = rng.randn(AB, s, AH, AD).astype(np.float32)
        out[f"k_{name}"] = rng.randn(AB, s, hkv, AD).astype(np.float32)
        out[f"v_{name}"] = rng.randn(AB, s, hkv, AD).astype(np.float32)
        out[f"do_{name}"] = rng.randn(AB, s, AH, AD).astype(np.float32)
    return out


def _xent_inputs(cfg):
    rng = np.random.RandomState(5)
    from repro_torch.models.transformer import padded_vocab
    vp = padded_vocab(cfg)
    x = (rng.randn(XB, XS, cfg.d_model) * 0.5).astype(np.float32)
    head = (rng.randn(cfg.d_model, vp) / np.sqrt(cfg.d_model)).astype(
        np.float32)
    labels = rng.randint(0, cfg.vocab_size, (XB, XS))
    valid = (rng.rand(XB, XS) > 0.2).astype(np.float32)
    return x, head, labels, valid


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as Ps

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig
    from repro.core import tatp
    from repro.core.dist import Dist, make_mesh
    from repro.models import attention as attn
    from repro.models import lm
    from repro.models.transformer import RunCtx

    x = _inputs()
    res = {}
    devs = jax.devices()
    assert len(devs) == 4, devs

    def smap(f, mesh, ins, outs):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=ins,
                                     out_specs=outs, check_vma=False))

    mesh4 = make_mesh((4,), ("model",), devices=devs)
    m0 = Ps("model")

    def relays(v, ct):
        outs = []
        for s in SHIFTS:
            perm = [((p - s) % 4, p) for p in range(4)]
            outs.append(jax.vjp(lambda a: lax.ppermute(a, "model", perm),
                                v)[1](ct)[0])
        outs.append(jax.vjp(lambda a: lax.ppermute(a, "model", [(0, 1)]),
                            v)[1](ct)[0])
        for w in WIRES:
            for s in SHIFTS:
                y, vjp = jax.vjp(lambda a: tatp.wire_relay(a, "model", 4, s,
                                                           w), v)
                outs += [y, vjp(ct)[0]]
        return tuple(outs)

    n_relay = 3 + 2 * len(WIRES) * len(SHIFTS)
    outs = smap(relays, mesh4, (m0, m0), (m0,) * n_relay)(
        x["relay"], x["relay_ct"])
    for k, y in enumerate(outs):
        res[f"relay{k}"] = np.asarray(y)

    for r in RINGS:
        mesh = make_mesh((r,), ("model",), devices=devs[:r])

        def f(xs, ws, dys, r=r):
            ys = []
            for o in ORDERS:
                for w in WIRES:
                    ys.append(tatp.dgrad_stream_w(dys, ws, "model", r,
                                                  bidirectional=o, wire=w))
                ys.append(tatp.wgrad_rs(xs, dys, "model", r,
                                        bidirectional=o))
                _, vjp = jax.vjp(lambda a, b: tatp.tatp_matmul(
                    a, b, "model", r, o), xs, ws)
                ys += list(vjp(dys))
            return tuple(ys)

        per = len(WIRES) + 3
        specs = ((m0,) * len(WIRES) + (Ps(None, "model"), m0,
                                       Ps(None, "model"))) * len(ORDERS)
        ys = smap(f, mesh, (m0, Ps(None, "model"), m0), specs)(
            x[f"x{r}"], x[f"w{r}"], x[f"dy{r}"])
        for oi, o in enumerate(ORDERS):
            part = ys[oi * per:(oi + 1) * per]
            for wi, w in enumerate(WIRES):
                res[f"dgrad{r}_{o}_{w}"] = np.asarray(part[wi])
            res[f"wgrad{r}_{o}"] = np.asarray(part[len(WIRES)])
            res[f"tdx{r}_{o}"] = np.asarray(part[len(WIRES) + 1])
            res[f"tdw{r}_{o}"] = np.asarray(part[len(WIRES) + 2])

    seq = Ps(None, "model")
    for name, (causal, cap, _) in ATTN_CASES.items():
        def f(q, k, v, do, causal=causal, cap=cap):
            outs = []
            for o in ORDERS:
                _, vjp = jax.vjp(lambda a, b, c: attn.ring_attention(
                    a, b, c, axis="model", axis_size=4, causal=causal,
                    cap=cap, bidirectional=o), q, k, v)
                outs += list(vjp(do))
            return tuple(outs)

        outs = smap(f, mesh4, (seq,) * 4, (seq,) * 6)(
            x[f"q_{name}"], x[f"k_{name}"], x[f"v_{name}"], x[f"do_{name}"])
        for oi, o in enumerate(ORDERS):
            for gi, g in enumerate("qkv"):
                res[f"ring_{name}_{o}_d{g}"] = np.asarray(outs[3 * oi + gi])

    cfg = get_reduced(ARCH)
    dist = Dist(make_mesh((1, 4), ("data", "model"), devices=devs))
    ctx = RunCtx(cfg, ParallelConfig(strategy="tatp", remat=False), dist,
                 phase="train")
    xx, head, labels, valid = _xent_inputs(cfg)

    def xent(xs, w, lab, val):
        def loss(a, b):
            nll, cnt = lm.streamed_vocab_xent(ctx, {"lm_head": b}, a, lab,
                                              val)
            return nll, cnt
        (nll, cnt), vjp = jax.vjp(loss, xs, w)
        dx, dw = vjp((jnp.float32(1.0), jnp.float32(0.0)))
        return nll[None], cnt[None], dx, dw

    outs = smap(xent, dist.mesh, (seq, Ps(None, "model"), seq, seq),
                (m0, m0, seq, Ps(None, "model")))(
        jnp.asarray(xx), jnp.asarray(head), jnp.asarray(labels),
        jnp.asarray(valid))
    for key, y in zip(("nll", "cnt", "dx", "dw"), outs):
        res[f"xent_{key}"] = np.asarray(y)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _grad_of(fn, inputs, ct):
    """(fn(*inputs), d<fn . ct>/d inputs) by autograd."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, ct)


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import tatp
    from repro_torch.core.dist import init_world, make_mesh_dist
    from repro_torch.kernels.flash_attention.ops import attention as flash
    from repro_torch.models import attention as attn
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunCtx

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
        i = d14.axis_index("model")
        v, ct = t(x["relay"][i]), t(x["relay_ct"][i])
        k = 0
        for s in SHIFTS:
            perm = [((p - s) % 4, p) for p in range(4)]
            res[f"relay{k}"] = _grad_of(
                lambda a: d14.ppermute(a, "model", perm), [v], ct)[1][0]
            k += 1
        res[f"relay{k}"] = _grad_of(
            lambda a: d14.ppermute(a, "model", [(0, 1)]), [v], ct)[1][0]
        k += 1
        for w in WIRES:
            for s in SHIFTS:
                y, (g,) = _grad_of(lambda a: tatp.wire_relay(
                    a, "model", 4, s, w, dist=d14), [v], ct)
                res[f"relay{k}"], res[f"relay{k + 1}"] = y, g
                k += 2
    for r, dist in rings.items():
        i = dist.axis_index("model")
        xs = t(x[f"x{r}"])[i * M:(i + 1) * M]
        ws = t(x[f"w{r}"])[:, i * KB:(i + 1) * KB]
        dys = t(x[f"dy{r}"])[i * M:(i + 1) * M]
        for o in ORDERS:
            for w in WIRES:
                res[f"dgrad{r}_{o}_{w}"] = tatp.dgrad_stream_w(
                    dys, ws, "model", r, bidirectional=o, wire=w, dist=dist)
            res[f"wgrad{r}_{o}"] = tatp.wgrad_rs(
                xs, dys, "model", r, bidirectional=o, dist=dist)
            _, (dx, dw) = _grad_of(lambda a, b: tatp.tatp_matmul(
                a, b, "model", r, o, dist=dist), [xs, ws], dys)
            res[f"tdx{r}_{o}"], res[f"tdw{r}_{o}"] = dx, dw
    if world == 4:
        dist = rings[4]
        i = dist.axis_index("model")

        def blk(a):
            n = a.shape[1] // 4
            return t(a)[:, i * n:(i + 1) * n]

        for name, (causal, cap, _) in ATTN_CASES.items():
            q, k_, v_, do = (blk(x[f"{p}_{name}"])
                             for p in ("q", "k", "v", "do"))
            for o in ORDERS:
                for hook, fn in (("loop", None), ("hook", flash)):
                    _, gs = _grad_of(lambda a, b, c: attn.ring_attention(
                        a, b, c, axis="model", axis_size=4, causal=causal,
                        cap=cap, bidirectional=o, dist=dist, attention=fn),
                        [q, k_, v_], do)
                    for g, gt in zip("qkv", gs):
                        res[f"ring_{name}_{o}_{hook}_d{g}"] = gt
        cfg = get_reduced(ARCH)
        ctx = RunCtx(cfg, ParallelConfig(strategy="tatp", remat=False),
                     dist, phase="train")
        xx, head, labels, valid = (t(a) for a in _xent_inputs(cfg))
        vloc = head.shape[1] // 4
        a = blk(xx).clone().requires_grad_(True)
        w = head[:, i * vloc:(i + 1) * vloc].clone().requires_grad_(True)
        nll, cnt = lm.streamed_vocab_xent(ctx, {"lm_head": w}, a,
                                          blk(labels), blk(valid))
        dx, dw = torch.autograd.grad(nll, [a, w])
        res.update(xent_nll=nll.detach(), xent_cnt=cnt, xent_dx=dx,
                   xent_dw=dw)
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
def grads(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_grads")
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
    _finish(ranks, "port rank")
    _finish([("reference", ref)], "the")
    port = {name: dict(np.load(d / f"{name}.npz")) for name, _ in ranks}
    return dict(np.load(d / "ref.npz")), port


def _ranks(port, world=4):
    return [port[f"{world}-{k}"] for k in range(world)]


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


# ---------------------------------------------------------------------------
# the collectives' transposes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", range(3 + 2 * len(WIRES) * len(SHIFTS)))
def test_relay_and_its_gradient_match_jax_vjp(grads, k):
    """ppermute's cotangent on the shifts and a partial permutation, then
    each wire's relay and its straight-through cotangent."""
    ref, port = grads
    got = np.stack([p[f"relay{k}"] for p in _ranks(port)])
    _close(got, ref[f"relay{k}"], f"relay{k}")


# ---------------------------------------------------------------------------
# the GEMM rings' backward
# ---------------------------------------------------------------------------


def _rows(ref_arr, port, r, key, cols=False):
    """Each rank's block (of rows, or of columns for a weight's gradient)
    of ``ref_arr`` against the rank's ``key``.  R = 2 runs on the (2, 2)
    mesh, whose ranks 0, 1 and 2, 3 are two rings (model index g % 2)."""
    n = ref_arr.shape[1 if cols else 0] // r
    ranks = _ranks(port, 4 if r == 2 else r)
    for g, p in enumerate(ranks):
        m = g % r
        want = (ref_arr[:, m * n:(m + 1) * n] if cols
                else ref_arr[m * n:(m + 1) * n])
        _close(p[key], want, key)


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("bidirectional", ORDERS)
@pytest.mark.parametrize("wire", WIRES)
def test_dgrad_stream_w_matches_reference(grads, r, bidirectional, wire):
    ref, port = grads
    key = f"dgrad{r}_{bidirectional}_{wire}"
    _rows(ref[key], port, r, key)


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("bidirectional", ORDERS)
def test_wgrad_rs_matches_reference(grads, r, bidirectional):
    ref, port = grads
    key = f"wgrad{r}_{bidirectional}"
    _rows(ref[key], port, r, key, cols=True)
    if r > 2:  # and the whole dW is x.T @ dy
        x = _inputs()
        got = np.concatenate([p[key] for p in _ranks(port, r)], axis=1)
        np.testing.assert_allclose(got, x[f"x{r}"].T @ x[f"dy{r}"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("bidirectional", ORDERS)
def test_tatp_matmul_gradients_match_jax_vjp(grads, r, bidirectional):
    ref, port = grads
    _rows(ref[f"tdx{r}_{bidirectional}"], port, r, f"tdx{r}_{bidirectional}")
    _rows(ref[f"tdw{r}_{bidirectional}"], port, r, f"tdw{r}_{bidirectional}",
          cols=True)


# ---------------------------------------------------------------------------
# ring attention's backward and the streamed cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ATTN_CASES))
@pytest.mark.parametrize("bidirectional", ORDERS)
@pytest.mark.parametrize("hook", ["loop", "hook"])
def test_ring_attention_grads_match_jax_vjp(grads, name, bidirectional,
                                            hook):
    ref, port = grads
    for g in "qkv":
        got = np.concatenate(
            [p[f"ring_{name}_{bidirectional}_{hook}_d{g}"]
             for p in _ranks(port)], axis=1)
        _close(got, ref[f"ring_{name}_{bidirectional}_d{g}"], f"d{g}")


def test_streamed_vocab_xent_and_grads_match_reference(grads):
    ref, port = grads
    ranks = _ranks(port)
    for k, p in enumerate(ranks):
        _close(p["xent_nll"], ref["xent_nll"][k], "nll")
        _close(p["xent_cnt"], ref["xent_cnt"][k], "count")
    _close(np.concatenate([p["xent_dx"] for p in ranks], axis=1),
           ref["xent_dx"], "dx")
    _close(np.concatenate([p["xent_dw"] for p in ranks], axis=1),
           ref["xent_dw"], "dw")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [None, 0.5])
def test_outside_delta_equals_own_delta_at_degree_one(causal, cap):
    """``attention_bwd_ref`` with delta = rowsum(dO O) from the fp32
    forward gives what it gives forming its own rowsum(P dP)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    rng = np.random.RandomState(7)
    q, k, v, do = (torch.as_tensor(rng.randn(2, 4, 16, 8).astype(
        np.float32)) for _ in range(4))
    k, v = k[:, :2], v[:, :2]
    kw = dict(causal=causal, cap=cap)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    delta = (do * o).sum(-1)
    own = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    outside = attention_bwd_ref(q, k, v, o, lse, do, delta=delta, **kw)
    for a, b in zip(outside, own):
        np.testing.assert_allclose(a, b, **TOL)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
