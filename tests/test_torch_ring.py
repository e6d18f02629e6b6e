"""The serve ring (model degree above 1) against the reference on the CPU.

The port's ranks are processes joined by gloo (a ``FileStore`` under the
test's temporary directory, so parallel test workers share no port); the
reference runs ``shard_map`` on 4 fake CPU devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, which must be set
before jax starts, as ``tests/test_multidevice.py`` does).  Both sides run
this file as a script on the same seeded numpy inputs (:func:`_inputs`)
and write numpy outputs, which the tests compare:

* ``Dist``'s collectives on the ``(1, 4)`` and ``(2, 2)`` meshes against
  numpy, bit for bit;
* ``ag_matmul_stream_w`` at R = 2, 3 and 4, bidirectional and naive, on
  the native, bf16 and fp8 wires, and ``ag_matmul_stream_x``, against the
  reference on the same mesh (fp32, 1e-5); the wire codecs byte for byte;
* ``ring_attention`` (causal, unmasked, soft-capped, GQA; both orders;
  the online-softmax loop and the per-round hook merged by LSE),
  ``decode_attention`` and ``write_kv_cache`` (scalar and [B] ``pos``) at
  R = 4 (fp32, 1e-5);
* the reduced deepseek-7b's prefill (logits and caches) and 4 decode
  steps with per-row ``cache_len`` at mesh (1, 4) and (2, 2), and the
  reduced internvl2-1b (vision prefix) and seamless-m4t-large-v2
  (encoder-decoder, its cross caches) at (1, 4), against the reference's
  ``make_serve_fns`` on the same weights (fp32, 2e-4 as
  ``tests/test_torch_serve.py``'s 5e-4 at half);
* the shards from ``shard_params`` and ``init_sharded_params`` put back
  together equal the full tree bit for bit;
* ``launch.serve --mesh 1 4 --device cpu`` under ``torch.distributed.run``
  prints the reference's keys;

and that the paths this slice leaves unported raise, naming their
ROADMAP.md item (engine mode over the ranks runs:
``tests/test_torch_ring_engine.py``)."""

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
M, N, KB = 4, 16, 8  # per-rank rows, contraction, weight columns
RINGS = (2, 3, 4)
WIRES = ("native", "bf16", "fp8")
ORDERS = (True, False)  # bidirectional, naive
# ring attention at R = 4: batch, per-rank sequence, heads, head dim
AB, ASL, AH, AD = 2, 4, 4, 16
ATTN_CASES = {"causal": (True, None, 4), "unmasked": (False, None, 4),
              "capped": (True, 0.5, 4), "gqa": (True, None, 2)}
# the model runs: batch, prompt, decode steps, decode cache length
B, P, GEN, MAX_SEQ = 4, 16, 4, 24
MESHES = ((1, 4), (2, 2))
# the serve runs: the dense model on both meshes, and the vision-prefixed
# and encoder-decoder models (their stub inputs from _model_batch) on (1, 4)
RUNS = ((ARCH, (1, 4)), (ARCH, (2, 2)), ("internvl2-1b", (1, 4)),
        ("seamless-m4t-large-v2", (1, 4)))
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
TIMEOUT = 300


# ---------------------------------------------------------------------------
# shared inputs (numpy, seeded): both sides and the tests draw the same
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.RandomState(0)
    out = {}
    for r in RINGS:
        out[f"x{r}"] = rng.randn(r * M, N).astype(np.float32)
        # spread magnitudes so fp8's block scale and rounding matter
        out[f"w{r}"] = (rng.randn(N, r * KB)
                        * np.exp(rng.randn(N, r * KB))).astype(np.float32)
    for name, (_, _, hkv) in ATTN_CASES.items():
        s = 4 * ASL
        out[f"q_{name}"] = rng.randn(AB, s, AH, AD).astype(np.float32)
        out[f"k_{name}"] = rng.randn(AB, s, hkv, AD).astype(np.float32)
        out[f"v_{name}"] = rng.randn(AB, s, hkv, AD).astype(np.float32)
    out["dq"] = rng.randn(B, 1, AH, AD).astype(np.float32)
    out["dk"] = rng.randn(B, MAX_SEQ, 2, AD).astype(np.float32)
    out["dv"] = rng.randn(B, MAX_SEQ, 2, AD).astype(np.float32)
    out["knew"] = rng.randn(B, 1, 2, AD).astype(np.float32)
    out["vnew"] = rng.randn(B, 1, 2, AD).astype(np.float32)
    out["prompts"] = rng.randint(0, 128, (B, P))
    return out


DECODE_LEN = np.array([3, 9, 14, 24])  # cache_len per row (owners 0..3)
WRITE_POS = np.array([2, 9, 15, 23])
WRITE_SCALAR = 9


def _step_len(t):
    """Decode step ``t``'s per-row cache_len (rows at different
    positions)."""
    return P + t + 1 + np.arange(B) % 2


def _np_params(shapes, rng=None, prefix=""):
    """Seeded weights for a parameter tree of leaf shapes (sorted walk)."""
    rng = rng or np.random.RandomState(1)
    out = {}
    for k in sorted(shapes):
        v = shapes[k]
        if isinstance(v, dict):
            out[k] = _np_params(v, rng, prefix + k + "/")
            continue
        if k.endswith("ln"):
            scale = 0.1
        elif k == "embed":
            scale = 1.0
        else:
            scale = 1.0 / np.sqrt(v[-2])
        out[k] = (rng.randn(*v) * scale).astype(np.float32)
    return out


def _run_tag(arch, shape):
    return f"{arch}_{shape[0]}x{shape[1]}"


def _model_batch(cfg, x):
    """The prefill batch: the prompts, and the stub frontend inputs the
    config takes, [B, frontend_tokens, D] (seeded)."""
    out = {"tokens": x["prompts"]}
    rng = np.random.RandomState(2)
    shape = (B, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend and cfg.family != "encdec":
        out["prefix_embeds"] = (rng.randn(*shape) * 0.1).astype(np.float32)
    if cfg.n_enc_layers:
        out["enc_embeds"] = (rng.randn(*shape) * 0.1).astype(np.float32)
    return out


def _rep_attn_in(x, name):
    return x[f"q_{name}"], x[f"k_{name}"], x[f"v_{name}"]


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 fake devices)
# ---------------------------------------------------------------------------


def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Ps

    sys.path.insert(0, str(SRC))
    from repro.configs import get_reduced
    from repro.configs.base import ParallelConfig, ShapeConfig
    from repro.core import tatp
    from repro.core.dist import Dist, make_mesh
    from repro.models import attention as attn
    from repro.models.transformer import param_shapes
    from repro.train.train_loop import make_serve_fns

    x = _inputs()
    res = {}
    devs = jax.devices()
    assert len(devs) == 4, devs

    def smap(f, mesh, ins, outs):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=ins,
                                     out_specs=outs, check_vma=False))

    for r in RINGS:
        mesh = make_mesh((r,), ("model",), devices=devs[:r])

        def f(xs, ws, r=r):
            ys = [tatp.ag_matmul_stream_w(xs, ws, "model", r,
                                          bidirectional=o, wire=w)
                  for o in ORDERS for w in WIRES]
            return (*ys, tatp.ag_matmul_stream_x(xs, ws, "model", r))

        ys = smap(f, mesh, (Ps("model"), Ps(None, "model")),
                  (Ps("model"),) * 6 + (Ps(None, "model"),))(
            x[f"x{r}"], x[f"w{r}"])
        for k, (o, w) in enumerate((o, w) for o in ORDERS for w in WIRES):
            res[f"tatp{r}_{o}_{w}"] = np.asarray(ys[k])
        res[f"stream_x{r}"] = np.asarray(ys[-1])

    mesh = make_mesh((4,), ("model",), devices=devs)
    seq = Ps(None, "model")
    for name, (causal, cap, _) in ATTN_CASES.items():
        def f(q, k, v, causal=causal, cap=cap):
            return tuple(attn.ring_attention(
                q, k, v, axis="model", axis_size=4, causal=causal, cap=cap,
                bidirectional=o) for o in ORDERS)

        outs = smap(f, mesh, (seq,) * 3, (seq,) * 2)(*_rep_attn_in(x, name))
        for o, y in zip(ORDERS, outs):
            res[f"ring_{name}_{o}"] = np.asarray(y)

    def dec(q, k, v, cl_vec, cl_scalar):
        return (attn.decode_attention(q, k, v, cl_vec, axis="model",
                                      axis_size=4),
                attn.decode_attention(q, k, v, cl_scalar, axis="model",
                                      axis_size=4))

    outs = smap(dec, mesh, (Ps(), seq, seq, Ps(), Ps()), (Ps(), Ps()))(
        x["dq"], x["dk"], x["dv"], jnp.asarray(DECODE_LEN),
        jnp.asarray(DECODE_LEN[2]))
    res["decode_vec"], res["decode_scalar"] = map(np.asarray, outs)

    def wr(k, v, kn, vn, pos_vec, pos_scalar):
        a = attn.write_kv_cache(k, v, kn, vn, pos_vec, axis="model",
                                axis_size=4)
        b = attn.write_kv_cache(k, v, kn, vn, pos_scalar, axis="model",
                                axis_size=4)
        return (*a, *b)

    outs = smap(wr, mesh, (seq, seq, Ps(), Ps(), Ps(), Ps()), (seq,) * 4)(
        x["dk"], x["dv"], x["knew"], x["vnew"], jnp.asarray(WRITE_POS),
        jnp.asarray(WRITE_SCALAR))
    for key, y in zip(("wvec_k", "wvec_v", "wsc_k", "wsc_v"), outs):
        res[key] = np.asarray(y)

    # the reduced models' serves on each mesh, from the same weights
    par = ParallelConfig(strategy="tatp", remat=False)
    for arch, shape in RUNS:
        tag = "m" + _run_tag(arch, shape)
        cfg = get_reduced(arch)
        shapes = jax.tree.map(lambda s: tuple(s.shape), param_shapes(cfg))
        params = jax.tree.map(jnp.asarray, _np_params(shapes))
        dist = Dist(make_mesh(shape, ("data", "model"), devices=devs))
        sb = make_serve_fns(cfg, par, dist, ShapeConfig("s", "decode",
                                                        MAX_SEQ, B))
        caches, logits = sb.prefill_fn(params, {
            k: jnp.asarray(v) for k, v in _model_batch(cfg, x).items()})
        res[f"{tag}_prefill_logits"] = np.asarray(logits)
        big = {}
        for u, leaves in caches.items():
            big[u] = {}
            for n, t in leaves.items():
                t = np.asarray(t)
                res[f"{tag}_prefill_{u}.{n}"] = t
                if u == "cross":  # the encoder's K/V, decode reads as is
                    big[u][n] = jnp.asarray(t)
                    continue
                z = np.zeros(t.shape[:2] + (MAX_SEQ,) + t.shape[3:], t.dtype)
                z[:, :, :P] = t
                big[u][n] = jnp.asarray(z)
        toks = jnp.argmax(logits[:, -1:, :], axis=-1).astype(jnp.int32) \
            % cfg.vocab_size
        steps = [np.asarray(toks)]
        for t in range(GEN):
            toks, lg, big = sb.decode_fn(params, toks, big,
                                         jnp.asarray(_step_len(t)))
            steps.append(np.asarray(toks))
        res[f"{tag}_tokens"] = np.concatenate(steps, axis=1)
        res[f"{tag}_decode_logits"] = np.asarray(lg)
        for u, leaves in big.items():
            for n, t in leaves.items():
                res[f"{tag}_decode_{u}.{n}"] = np.asarray(t)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port's side (one process a rank)
# ---------------------------------------------------------------------------


def _collectives(dist, tag, res):
    """Each rank contributes its :func:`_contrib`; record what each
    collective gave."""
    from repro_torch.core.dist import DATA_AXIS, MODEL_AXIS
    x, xi, xb = (torch.as_tensor(a) for a in
                 _contrib(torch.distributed.get_rank()))
    xb = xb.to(torch.bfloat16)
    for axis in (MODEL_AXIS, DATA_AXIS):
        r = dist.axis_size(axis)
        if r == 1:
            continue
        pre = f"{tag}_{axis}"
        res[pre + "_shift"] = dist.ppermute(
            x, axis, [((p + 1) % r, p) for p in range(r)]).numpy()
        a, b = dist.ppermute_many(
            [((x, xi), [((p + 1) % r, p) for p in range(r)]),
             (xb, [((p - 1) % r, p) for p in range(r)])], axis)
        res[pre + "_many_x"], res[pre + "_many_i"] = a[0].numpy(), \
            a[1].numpy()
        res[pre + "_many_b"] = b.float().numpy()
        res[pre + "_partial"] = dist.ppermute(x, axis, [(0, 1)]).numpy()
        res[pre + "_psum"] = dist.psum(x, axis).numpy()
        res[pre + "_psum_bf16"] = dist.psum(xb, axis).float().numpy()
        res[pre + "_pmax"] = dist.pmax(x, axis).numpy()
        res[pre + "_pmin"] = dist.pmin(xi, axis).numpy()
        res[pre + "_gather0"] = dist.all_gather(x, axis, dim=0).numpy()
        res[pre + "_gather1"] = dist.all_gather(xb, axis, dim=-1) \
            .float().numpy()
    res[f"{tag}_coords"] = np.array(dist.coords)


def _port_serve(dist, x, arch, shape, res):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import lm
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.train_loop import batch_rows, make_serve_fns
    from repro_torch.weights import params_from_jax, shard_params

    tag = "m" + _run_tag(arch, shape)
    cfg = get_reduced(arch)
    par = ParallelConfig(strategy="tatp", remat=False)
    params = shard_params(params_from_jax(_np_params(param_shapes(cfg)),
                                          cfg, "cpu"), cfg, "tatp", dist)
    sb = make_serve_fns(cfg, par, dist)
    caches, logits = sb.prefill_fn(params, {
        k: torch.as_tensor(v) for k, v in _model_batch(cfg, x).items()})
    res[f"{tag}_prefill_logits"] = logits.numpy()
    for u, leaves in caches.items():
        for n, t in leaves.items():
            res[f"{tag}_prefill_{u}.{n}"] = t.numpy()
    rows = len(range(B)[batch_rows(dist, B)])
    big = lm.graft_cache_slots(
        lm.init_cache(sb.ctx, rows, MAX_SEQ,
                      enc_len=cfg.frontend_tokens or None),
        lm.shard_prompt_cache(sb.ctx, caches, MAX_SEQ), slots=range(rows))
    toks = logits[:, -1:, :].argmax(dim=-1) % cfg.vocab_size
    steps = [toks]
    for t in range(GEN):
        toks, lg, big = sb.decode_fn(params, toks, big,
                                     torch.as_tensor(_step_len(t)))
        steps.append(toks)
    res[f"{tag}_tokens"] = torch.cat(steps, dim=1).numpy()
    res[f"{tag}_decode_logits"] = lg.numpy()
    for u, leaves in big.items():
        for n, t in leaves.items():
            res[f"{tag}_decode_{u}.{n}"] = t.numpy()


def _port_rank(world, rank, store_path, out_dir):
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.core import tatp
    from repro_torch.core.dist import init_world, make_mesh_dist
    from repro_torch.kernels.flash_attention.ops import attention as flash
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import init_params, param_shapes
    from repro_torch.weights import init_sharded_params, shard_params

    init_world("gloo", store=torch.distributed.FileStore(store_path, world),
               rank=rank, world_size=world)
    x = _inputs()
    res = {}
    t = torch.as_tensor
    rings = {}
    if world == 3:
        rings[3] = make_mesh_dist((1, 3), "cpu")
    else:
        d14, d22 = make_mesh_dist((1, 4), "cpu"), make_mesh_dist((2, 2),
                                                                 "cpu")
        rings.update({4: d14, 2: d22})
        _collectives(d14, "1x4", res)
        _collectives(d22, "2x2", res)
        try:
            make_mesh_dist((1, 2), "cpu")
        except ValueError as e:
            res["mismatch"] = np.array(str(e))
    for r, dist in rings.items():
        i = dist.axis_index("model")
        xs = t(x[f"x{r}"])[i * M:(i + 1) * M]
        ws = t(x[f"w{r}"])[:, i * KB:(i + 1) * KB]
        for o in ORDERS:
            for w in WIRES:
                res[f"tatp{r}_{o}_{w}"] = tatp.ag_matmul_stream_w(
                    xs, ws, "model", r, bidirectional=o, wire=w,
                    dist=dist).numpy()
        res[f"stream_x{r}"] = tatp.ag_matmul_stream_x(
            xs, ws, "model", r, dist=dist).numpy()
    if world == 4:
        dist = rings[4]
        i = dist.axis_index("model")
        for way in ("up", "down"):
            res[f"stream_blocks_{way}"] = np.array([
                [step, j, blk.item()] for step, j, blk in tatp.stream_blocks(
                    torch.tensor([float(i)]), "model", 4, 4, way,
                    dist=dist)])

        def blk(a, n):
            return t(a)[:, i * n:(i + 1) * n]

        for name, (causal, cap, _) in ATTN_CASES.items():
            q, k, v = (blk(a, ASL) for a in _rep_attn_in(x, name))
            for o in ORDERS:
                for hook, fn in (("loop", None), ("hook", flash)):
                    res[f"ring_{name}_{o}_{hook}"] = attn.ring_attention(
                        q, k, v, axis="model", axis_size=4, causal=causal,
                        cap=cap, bidirectional=o, dist=dist,
                        attention=fn).numpy()
        sloc = MAX_SEQ // 4
        kc, vc = blk(x["dk"], sloc), blk(x["dv"], sloc)
        for key, cl in (("decode_vec", t(DECODE_LEN)),
                        ("decode_scalar", t(DECODE_LEN[2]))):
            res[key] = attn.decode_attention(
                t(x["dq"]), kc, vc, cl, axis="model", axis_size=4,
                dist=dist).numpy()
        for key, pos in (("wvec", t(WRITE_POS)), ("wsc", t(WRITE_SCALAR))):
            k2, v2 = attn.write_kv_cache(
                kc.clone(), vc.clone(), t(x["knew"]), t(x["vnew"]), pos,
                axis="model", axis_size=4, dist=dist)
            res[key + "_k"], res[key + "_v"] = k2.numpy(), v2.numpy()
        meshes = dict(zip(MESHES, (rings[4], rings[2])))
        for arch, shape in RUNS:
            _port_serve(meshes[shape], x, arch, shape, res)
        cfg = get_reduced(ARCH)
        for shape, d in meshes.items():
            tag = "x".join(map(str, shape))
            gen = torch.Generator().manual_seed(3)
            sharded = init_sharded_params(cfg, gen, d)
            cut = shard_params(init_params(
                cfg, torch.Generator().manual_seed(3), "cpu"), cfg, "tatp",
                d)
            for path, leaf in _flat(sharded).items():
                res[f"shard{tag}_{path}"] = leaf.numpy()
                res[f"cut{tag}_{path}"] = _flat(cut)[path].numpy()
    np.savez(Path(out_dir) / f"{world}-{rank}.npz", **res)
    torch.distributed.destroy_process_group()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the fixture: both sides at once, then the comparisons
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
def ring(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
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


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _contrib(g):
    """Rank ``g``'s values: small integers as fp32 (and as bf16), so every
    order of summing them is exact and the sums compare bit for bit; and
    int64."""
    rng = np.random.RandomState(100 + g)
    x = rng.randint(-20, 20, (3, 5)).astype(np.float32)
    return x, rng.randint(-50, 50, 6), x.copy()


@pytest.mark.parametrize("tag", ["1x4", "2x2"])
def test_collectives_match_numpy_bitwise(ring, tag):
    _, port = ring
    res = _ranks(port)
    coords = [tuple(res[g][f"{tag}_coords"]) for g in range(4)]
    shape = tuple(int(c) for c in tag.split("x"))
    assert sorted(coords) == [(d, m) for d in range(shape[0])
                              for m in range(shape[1])]
    checked = 0
    for axis, pos in (("model", 1), ("data", 0)):
        if shape[pos] == 1:
            continue
        for g in range(4):
            c = coords[g]
            members = sorted((h for h in range(4)
                              if coords[h][1 - pos] == c[1 - pos]),
                             key=lambda h: coords[h][pos])
            r, i = len(members), c[pos]
            xs = np.stack([_contrib(h)[0] for h in members])
            ints = np.stack([_contrib(h)[1] for h in members])
            got = {k[len(f"{tag}_{axis}_"):]: v for k, v in res[g].items()
                   if k.startswith(f"{tag}_{axis}_")}
            want = dict(
                shift=xs[(i + 1) % r], many_x=xs[(i + 1) % r],
                many_i=ints[(i + 1) % r], many_b=xs[(i - 1) % r],
                partial=xs[0] if i == 1 else np.zeros_like(xs[0]),
                psum=xs.sum(0), psum_bf16=xs.sum(0), pmax=xs.max(0),
                pmin=ints.min(0), gather0=np.concatenate(xs, axis=0),
                gather1=np.concatenate(xs, axis=-1))
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            checked += 1
    assert checked == (4 if tag == "1x4" else 8)


def test_mesh_that_is_not_the_world_raises(ring):
    _, port = ring
    for res in _ranks(port):
        assert "world has 4 ranks" in str(res["mismatch"])


# ---------------------------------------------------------------------------
# the TATP ring and its wires
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", RINGS)
@pytest.mark.parametrize("bidirectional", ORDERS)
@pytest.mark.parametrize("wire", WIRES)
def test_ag_matmul_stream_w_matches_reference(ring, r, bidirectional, wire):
    ref, port = ring
    key = f"tatp{r}_{bidirectional}_{wire}"
    if r == 2:  # the (2, 2) mesh: each data row is a ring of two
        for p in _ranks(port):
            m = p["2x2_coords"][1]
            _close(p[key], ref[key][m * M:(m + 1) * M], TOL, key)
        return
    got = np.concatenate([p[key] for p in _ranks(port, r)], axis=0)
    _close(got, ref[key], TOL, key)
    if wire == "native":
        x = _inputs()
        _close(got, x[f"x{r}"] @ x[f"w{r}"], dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("r", RINGS)
def test_ag_matmul_stream_x_matches_reference(ring, r):
    ref, port = ring
    key = f"stream_x{r}"
    if r == 2:
        for p in _ranks(port):
            m = p["2x2_coords"][1]
            _close(p[key], ref[key][:, m * KB:(m + 1) * KB], TOL, key)
        return
    got = np.concatenate([p[key] for p in _ranks(port, r)], axis=1)
    _close(got, ref[key], TOL, key)


@pytest.mark.parametrize("way", ["up", "down"])
def test_stream_blocks_relay_each_block_round_by_round(ring, way):
    """Rank i holds block i + t (up) or i - t (down) at round t, and its
    index names it."""
    _, port = ring
    sign = 1 if way == "up" else -1
    for i, p in enumerate(_ranks(port)):
        want = [[t, (i + sign * t) % 4, (i + sign * t) % 4]
                for t in range(4)]
        np.testing.assert_array_equal(p[f"stream_blocks_{way}"], want)


def test_choose_stream_streams_the_smaller_block():
    sys.path.insert(0, str(SRC))
    from repro_torch.core.tatp import choose_stream
    assert choose_stream(128, 4096, 1024) == "inputs"
    assert choose_stream(2048, 4096, 1024) == "weights"
    assert choose_stream(128, 4096, 1024, "weights") == "weights"


@pytest.mark.parametrize("wire", ["bf16", "fp8"])
def test_wire_encode_is_the_references_bytes(wire):
    import jax.numpy as jnp

    sys.path.insert(0, str(SRC))
    from repro.core import tatp as jtatp
    from repro_torch.core import tatp

    x = _inputs()["w4"]
    want = [np.asarray(a) for a in jtatp.wire_encode(jnp.asarray(x), wire)]
    got = [a.numpy() for a in tatp.wire_encode(torch.as_tensor(x), wire)]
    assert got[0].dtype == np.uint8
    assert got[0].tobytes() == want[0].view(np.uint8).tobytes()
    if wire == "fp8":
        assert got[1].tobytes() == want[1].tobytes()  # the fp32 scale
    back = tatp.wire_decode(tuple(torch.as_tensor(a) for a in got), wire,
                            torch.float32).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jtatp.wire_decode(tuple(want), wire, jnp.float32)))


# ---------------------------------------------------------------------------
# ring attention, sharded decode attention, the owner's cache write
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ATTN_CASES))
@pytest.mark.parametrize("bidirectional", ORDERS)
@pytest.mark.parametrize("hook", ["loop", "hook"])
def test_ring_attention_matches_reference(ring, name, bidirectional, hook):
    ref, port = ring
    got = np.concatenate([p[f"ring_{name}_{bidirectional}_{hook}"]
                          for p in _ranks(port)], axis=1)
    _close(got, ref[f"ring_{name}_{bidirectional}"], TOL, name)


@pytest.mark.parametrize("key", ["decode_vec", "decode_scalar"])
def test_decode_attention_matches_reference(ring, key):
    ref, port = ring
    for p in _ranks(port):
        _close(p[key], ref[key], TOL, key)


@pytest.mark.parametrize("key", ["wvec", "wsc"])
def test_write_kv_cache_owner_writes(ring, key):
    ref, port = ring
    for n in ("k", "v"):
        got = np.concatenate([p[f"{key}_{n}"] for p in _ranks(port)],
                             axis=1)
        np.testing.assert_array_equal(got, ref[f"{key}_{n}"])


# ---------------------------------------------------------------------------
# the reduced model's serve on (1, 4) and (2, 2)
# ---------------------------------------------------------------------------


def _block(a, coords, shape, seq_axis=None, vocab=False):
    """The global reference array ``a``'s block for the rank at
    ``coords`` on ``shape``: rows (axis 0, or 1 for a cache leaf) over
    data, and the sequence or vocab axis over model."""
    d, m = coords
    nd, nm = shape
    row_axis = 1 if seq_axis == 2 else 0
    rows = a.shape[row_axis] // nd
    a = np.take(a, range(d * rows, (d + 1) * rows), axis=row_axis)
    ax = seq_axis if seq_axis is not None else (a.ndim - 1 if vocab
                                                else None)
    if ax is not None:
        n = a.shape[ax] // nm
        a = np.take(a, range(m * n, (m + 1) * n), axis=ax)
    return a


def _cache_keys(res, tag, phase):
    pre = f"{tag}_{phase}_"
    keys = [k for k in res if k.startswith(pre) and k != pre + "logits"]
    assert keys, f"no {phase} cache in {sorted(res)[:8]}"
    return keys


@pytest.mark.parametrize("arch,shape", RUNS)
def test_prefill_matches_reference(ring, arch, shape):
    """Logits gathered over both axes; each rank's cache block."""
    ref, port = ring
    tag = "m" + _run_tag(arch, shape)
    mesh = "x".join(map(str, shape))
    for p in _ranks(port):
        c = tuple(p[f"{mesh}_coords"])
        _close(p[f"{tag}_prefill_logits"], ref[f"{tag}_prefill_logits"],
               MODEL_TOL, "prefill logits")
        for key in _cache_keys(p, tag, "prefill"):
            _close(p[key], _block(ref[key], c, shape, seq_axis=2),
                   MODEL_TOL, key)


@pytest.mark.parametrize("arch,shape", RUNS)
def test_decode_steps_match_reference(ring, arch, shape):
    """4 greedy steps at per-row positions: identical tokens, each rank's
    logits block and cache block (the prompt moved to its owners)."""
    ref, port = ring
    tag = "m" + _run_tag(arch, shape)
    mesh = "x".join(map(str, shape))
    for p in _ranks(port):
        c = tuple(p[f"{mesh}_coords"])
        np.testing.assert_array_equal(p[f"{tag}_tokens"],
                                      ref[f"{tag}_tokens"])
        _close(p[f"{tag}_decode_logits"],
               _block(ref[f"{tag}_decode_logits"], c, shape, vocab=True),
               MODEL_TOL, "decode logits")
        for key in _cache_keys(p, tag, "decode"):
            _close(p[key], _block(ref[key], c, shape, seq_axis=2),
                   MODEL_TOL, key)


@pytest.mark.parametrize("shape", MESHES)
def test_shards_reassemble_the_full_tree(ring, shape):
    """``init_sharded_params``' shards and ``shard_params``' cuts of
    ``init_params``' tree (same seed) put back together equal that tree
    bit for bit."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params, param_specs

    _, port = ring
    tag = "x".join(map(str, shape))
    cfg = get_reduced(ARCH)
    full = _flat(init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    specs = _flat(param_specs(cfg))
    ranks = {tuple(p[f"{tag}_coords"]): p for p in _ranks(port)}
    for path, leaf in full.items():
        dim = specs[path].index("model") if "model" in specs[path] else None
        for kind in ("shard", "cut"):
            parts = [ranks[(0, m)][f"{kind}{tag}_{path}"]
                     for m in range(shape[1])]
            got = parts[0] if dim is None else np.concatenate(parts, dim)
            np.testing.assert_array_equal(got, leaf.numpy(), err_msg=path)


@pytest.mark.parametrize("layout", ["mesh", "auto-plan"])
def test_serve_cli_under_torchrun_prints_reference_keys(tmp_path, layout):
    """Rank 0 alone prints the reference's keys.  Under ``--auto-plan``
    rank 0 solves the plan and the other ranks read its cache entry (the
    reduced plan's mesh is (4, 1): the batch over data)."""
    flags = (["--mesh", "1", "4"] if layout == "mesh" else
             ["--auto-plan", "--plan-cache", str(tmp_path / "plans")])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
           "--arch", ARCH, "--reduced", "--device", "cpu", *flags,
           "--batch", "4", "--prompt-len", "8", "--gen", "3"]
    res = subprocess.run(cmd, env=_env(OMP_NUM_THREADS="1"), cwd=tmp_path,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert set(out) == {"generated_shape", "tokens_per_s", "ms_per_token",
                        "sample"}
    assert out["generated_shape"] == [4, 4]
    if layout == "auto-plan":
        assert res.stdout.count("[plan] solved fresh") == 1, res.stdout
        assert res.stdout.count("[plan] cache hit") == 3, res.stdout


# ---------------------------------------------------------------------------
# what stays unported raises, naming its ROADMAP.md item
# ---------------------------------------------------------------------------


def _ring_dist(r=2):
    from repro_torch.core.dist import Dist
    return Dist(torch.device("cpu"), mesh_shape=(1, r))


def _mirror_dist(r=2):
    """Rank 0 of a ring of ``r`` in one process whose neighbours hold the
    same block: every relay returns what it was given."""
    from repro_torch.core.dist import Dist

    class Mirror(Dist):
        def _ppermute_raw(self, items, axis):
            return [tuple(t.clone() for t in x) if isinstance(x, tuple)
                    else x.clone() for x, _ in items]

    return Mirror(torch.device("cpu"), mesh_shape=(1, r))


def _grads(fn, *inputs):
    """fn's output and the gradients of its sum, by autograd."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    return (y.detach(), *torch.autograd.grad(y.sum(), leaves))


def test_unported_ring_paths_raise(monkeypatch):
    """What the train ring leaves raises before any collective: the flash
    kernel's row LSE under autograd outside ring attention's Functions
    (zigzag attention's backward under a window runs: on real ranks in
    ``tests/test_torch_ring_window_train.py``); sharded checkpoints and a
    stage's
    submesh go on to join the world (the encoder-decoder, the vision
    prefix, zigzag and ``tatp_outputs`` train on the ring:
    ``tests/test_torch_ring_{encdec,zigzag}.py``; the Mamba-2 block serves
    and trains on it: ``tests/test_torch_ring_ssm.py``); the ring's own
    checks hold."""
    sys.path.insert(0, str(SRC))
    import repro_torch.launch.train as launch
    from repro_torch.core.dist import check_transport
    from repro_torch.kernels.flash_attention.ops import attention as flash
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import attention as attn
    from repro_torch.train.train_loop import check_prompt_len

    x = torch.randn(1, 4, 2, 8, generator=torch.Generator().manual_seed(0))
    got = _grads(lambda a, b, c: attn.zigzag_ring_attention(
        a, b, c, axis="model", axis_size=2, window=4, dist=_mirror_dist()),
        x, x, x)
    assert all(g.shape == x.shape and torch.isfinite(g).all()
               for g in got)
    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="ring attention's Functions"):
        flash(q, q, q, return_lse=True)

    def joined(args):
        raise RuntimeError("joined the world")

    monkeypatch.setattr(launch, "join_world", joined)
    monkeypatch.setenv("WORLD_SIZE", "4")
    for extra in (["--ckpt-dir", "ck"], ["--wafers", "2"]):
        # sharded checkpoints and a stage's submesh go on to the world
        with pytest.raises(RuntimeError, match="joined the world"):
            train_main(["--reduced", "--device", "cpu", *extra])
    with pytest.raises(ValueError, match="not a multiple of the ring"):
        check_prompt_len(_ring_dist(4), 18)
    with pytest.raises(ValueError, match="one GPU a rank"):
        check_transport("nccl", ["h:GPU-0", "h:GPU-0"])
    check_transport("nccl", ["h:GPU-0", "h:GPU-1"])
    check_transport("gloo", ["h:GPU-0", "h:GPU-0"])


def test_engine_mode_over_ranks_joins_the_world(monkeypatch):
    """Engine mode over several ranks goes on to join the world (it runs
    there: ``tests/test_torch_ring_engine.py``)."""
    sys.path.insert(0, str(SRC))
    import repro_torch.launch.serve as launch

    def joined(args):
        raise RuntimeError("joined the world")

    monkeypatch.setattr(launch, "join_world", joined)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="joined the world"):
        launch.main(["--serve", "--reduced", "--device", "cpu",
                     "--auto-plan"])


def test_windowed_layer_over_the_ring_raises():
    """Under autograd the backward under a window runs, on the loop and on
    the hook: on rank 0 of a causal ring of two the later block is
    invisible, so the output and gradients are the windowed local
    attention's (against the reference on real ranks:
    ``tests/test_torch_ring_window_train.py``)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention as attn
    q = torch.randn(1, 8, 2, 8, generator=torch.Generator().manual_seed(1))
    want = _grads(lambda a, b, c: attn.local_attention(a, b, c, window=3),
                  q, q, q)
    for hook in (None, attention_ref):
        got = _grads(lambda a, b, c: attn.ring_attention(
            a, b, c, axis="model", axis_size=2, window=3,
            dist=_mirror_dist(), attention=hook), q, q, q)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("argv", [
    ["--arch", "gemma2-9b", "--mesh", "1", "4"],
    ["--arch", "gemma2-9b", "--mesh", "2", "2"],
    ["--arch", "gemma2-9b", "--mesh", "4", "1"],
    ["--arch", "gemma2-9b", "--mesh", "2", "2", "--strategy", "megatron"],
    ["--arch", "deepseek-7b", "--mesh", "1", "4"],
])
def test_windowed_training_on_the_ring_raises_before_joining(
        monkeypatch, argv):
    """``launch.train`` with gemma2-9b's window on the ``tatp`` ring goes
    on to join the world (it trains there:
    ``tests/test_torch_ring_window_train.py``), as it does at model degree
    1, under ``megatron`` and without a window."""
    sys.path.insert(0, str(SRC))
    import repro_torch.launch.train as launch

    def joined(args):
        raise RuntimeError("joined the world")

    monkeypatch.setattr(launch, "join_world", joined)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="joined the world"):
        launch.main(["--reduced", "--device", "cpu", *argv])


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
