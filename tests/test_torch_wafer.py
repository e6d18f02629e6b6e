"""The port's wafer cost engine and DLWS solver (``repro_torch.wafer``)
against the reference (``repro.wafer``) on the same inputs.

The copies keep the reference's float64 arithmetic in its order, so every
comparison here is bitwise: floats are compared through ``float.hex`` (so
``inf`` and ``nan`` compare too), with no tolerance.  Wafers: the default
``WaferSpec()``, one with dead dies, one with dead links, one with both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import paper_models as rpaper
from repro.wafer import mapping as rmap
from repro.wafer import placement as rplace
from repro.wafer import simulator as rsim
from repro.wafer import solver as rsolver
from repro.wafer import tcme as rtcme
from repro.wafer import topology as rtopo
from repro.wafer import traffic as rtraffic
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.configs import paper_models as tpaper
from repro_torch.wafer import mapping as tmap
from repro_torch.wafer import placement as tplace
from repro_torch.wafer import simulator as tsim
from repro_torch.wafer import solver as tsolver
from repro_torch.wafer import tcme as ttcme
from repro_torch.wafer import topology as ttopo
from repro_torch.wafer import traffic as ttraffic

FAULTS = {
    "pristine": ((), ()),
    "dies": ((3, 7, 12), ()),
    "links": ((), ((0, 1), (9, 17), (20, 21))),
    "dies+links": ((5, 22), ((1, 9), (14, 15))),
}


def _wafers(kind: str):
    dies, links = FAULTS[kind]
    ref = rtopo.Wafer(rtopo.WaferSpec()).with_faults(dies=dies, links=links)
    port = ttopo.Wafer(ttopo.WaferSpec()).with_faults(dies=dies, links=links)
    return ref, port


def canon(x):
    """A comparable form of a cost-engine value: floats as their hex bits,
    degree tuples as their keys, containers element by element."""
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x).hex()
    if isinstance(x, (rsim.ParallelDegrees, tsim.ParallelDegrees)):
        return ("deg",) + x.key
    if isinstance(x, (rsim.SimResult, tsim.SimResult)):
        return tuple(canon(getattr(x, f.name)) for f in dataclasses.fields(x)
                     if f.compare)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            canon(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return tuple(sorted((canon(k), canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(canon(v) for v in x))
    if isinstance(x, np.ndarray):
        return canon(x.tolist())
    return x


def _solve_fields(r):
    """Everything of a SolveResult but the wall-clock search time."""
    return canon({f.name: getattr(r, f.name) for f in dataclasses.fields(r)
                  if f.name not in ("search_time_s",
                                    "projected_full_time_s")})


# ---------------------------------------------------------------------------
# topology, mapping, traffic, TCME, placement
# ---------------------------------------------------------------------------


def test_config_accounting_matches_reference():
    for arch in ARCHITECTURES:
        r, t = ref_config(arch), get_config(arch)
        assert dataclasses.astuple(r) == dataclasses.astuple(t), arch
        assert r.param_count() == t.param_count(), arch
        assert r.param_count(active_only=True) == \
            t.param_count(active_only=True), arch
        for ctx in (0, 1, 4095, 4096, 32768):
            assert r.cache_bytes_per_seq(ctx) == t.cache_bytes_per_seq(ctx)
            assert r.cache_bytes_per_token(ctx) == \
                t.cache_bytes_per_token(ctx)


def test_paper_models_match_reference():
    """Table II and the multi-wafer set, field for field."""
    assert canon(rpaper.TABLE_II) == canon(tpaper.TABLE_II)
    assert canon(rpaper.MULTI_WAFER) == canon(tpaper.MULTI_WAFER)
    assert list(rpaper.TABLE_II) == list(tpaper.TABLE_II)
    for key, (cfg, _shape) in tpaper.TABLE_II.items():
        assert rpaper.TABLE_II[key][0].param_count() == cfg.param_count()


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_wafer_topology_matches_reference(kind):
    rw, tw = _wafers(kind)
    assert dataclasses.asdict(rw.spec) == dataclasses.asdict(tw.spec)
    assert canon(rw.spec.bw_eff(1e3)) == canon(tw.spec.bw_eff(1e3))
    assert rw.alive_dies() == tw.alive_dies()
    assert rw.link_universe() == tw.link_universe()
    assert rw.failed_links == tw.failed_links
    n = rw.spec.n_dies
    for a in range(n):
        assert rw.neighbors(a) == tw.neighbors(a), a
        for b in range(n):
            assert rw.xy_path(a, b) == tw.xy_path(a, b), (a, b)
            assert rw.yx_path(a, b) == tw.yx_path(a, b), (a, b)
            assert rw.detour_path(a, b) == tw.detour_path(a, b), (a, b)
            assert rw.hops(a, b) == tw.hops(a, b)
    half = rw.alive_dies()[: len(rw.alive_dies()) // 2]
    rest = rw.alive_dies()[len(half):]
    assert rw.cut_links(half, rest) == tw.cut_links(half, rest)


def test_snake_orders_and_groups_match_reference():
    for rows, cols in ((4, 8), (2, 2), (3, 5), (8, 4), (1, 6)):
        assert rmap.snake_order(rows, cols) == tmap.snake_order(rows, cols)
        assert rmap.rowmajor_order(rows, cols) == \
            tmap.rowmajor_order(rows, cols)
    for data, model in ((1, 1), (2, 16), (4, 8), (8, 4), (32, 1), (3, 5)):
        np.testing.assert_array_equal(rmap.device_order_for_jax(data, model),
                                      tmap.device_order_for_jax(data, model))
    rw, tw = _wafers("dies")
    for size in (1, 2, 4, 7, 8):
        for engine in ("tcme", "smap", "gmap"):
            rg = rmap.make_groups(rw, size, engine)
            assert rg == tmap.make_groups(tw, size, engine)
            assert canon(rmap.ring_contiguity_stats(rg, rw)) == \
                canon(tmap.ring_contiguity_stats(rg, tw))


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_hierarchical_map_matches_reference(kind):
    rw, tw = _wafers(kind)
    n = len(rw.alive_dies())
    for degrees in ({"dp": 2, "tatp": 16}, {"tatp": 8}, {"dp": 4, "tp": 2,
                    "sp": 2}, {"dp": 1}, {"sp": 4, "tatp": 4},
                    {"dp": n}):
        if np.prod(list(degrees.values())) > n:
            continue
        for engine in ("tcme", "smap"):
            assert rmap.hierarchical_map(rw, degrees, engine) == \
                tmap.hierarchical_map(tw, degrees, engine), (degrees, engine)


def _ops(pkg_traffic, pkg_map, wafer):
    ops = []
    for g in pkg_map.make_groups(wafer, 4, "smap"):
        ops.append(pkg_traffic.CommOp("allgather", g, 100e6, tag="fsdp"))
    for c in range(4):
        g = tuple(wafer.die(r, c) for r in range(4)
                  if wafer.alive(wafer.die(r, c)))
        ops.append(pkg_traffic.CommOp("p2p_ring", g, 100e6, tag="tatp"))
    ops.append(pkg_traffic.CommOp("allreduce", tuple(wafer.alive_dies()[:8]),
                                  3e6, tag="dp"))
    return ops


@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_link_loads_phase_time_and_tcme_match_reference(kind):
    rw, tw = _wafers(kind)
    for cached in (True, False):
        rwc = rw if cached else rw.uncached()
        twc = tw if cached else tw.uncached()
        rops, tops = _ops(rtraffic, rmap, rwc), _ops(ttraffic, tmap, twc)
        for weighted in (False, True):
            assert canon(rtraffic.link_loads(rops, rwc, weighted)) == \
                canon(ttraffic.link_loads(tops, twc, weighted))
        assert canon(rtraffic.phase_time(rops, rwc)) == \
            canon(ttraffic.phase_time(tops, twc))
        for op_r, op_t in zip(rops, tops):
            assert rtraffic.max_ring_hops(op_r.group, rwc) == \
                ttraffic.max_ring_hops(op_t.group, twc)
        rrep = rtcme.optimize_phase(rops, rwc)
        trep = ttcme.optimize_phase(tops, twc)
        assert canon(rrep) == canon(trep)


@pytest.mark.parametrize("kind", ("pristine", "dies"))
def test_expert_placement_matches_reference(kind):
    rw, tw = _wafers(kind)
    n = len(rw.alive_dies())
    for dp, ep in ((8, 2), (8, 4), (16, 8), (4, 4)):
        if dp > n:
            continue
        groups = rmap.hierarchical_map(rw, {"dp": dp, "tatp": n // dp},
                                       "tcme")["dp"]
        assert canon(rplace.choose_expert_placement(rw, groups, dp, ep)) \
            == canon(tplace.choose_expert_placement(tw, groups, dp, ep))


# ---------------------------------------------------------------------------
# the simulator's numpy tiers
# ---------------------------------------------------------------------------


def _grid(n_dies: int, space: str, pkg):
    spec = pkg.STRATEGY_SPACES[space]
    return pkg.candidate_degrees(n_dies, spec["allow"], spec["seq_par"])


@pytest.mark.parametrize("arch", ("deepseek-7b", "mamba2-780m",
                                  "olmoe-1b-7b"))
@pytest.mark.parametrize("kind", ("pristine", "dies+links"))
def test_simulate_batch_matches_reference(arch, kind):
    """Every field of every candidate of the solver's grid, in every
    strategy space, search-time and final (TCME optimizer) scoring."""
    rw, tw = _wafers(kind)
    n = len(rw.alive_dies())
    for space in sorted(rsim.STRATEGY_SPACES):
        rc, tc = _grid(n, space, rsim), _grid(n, space, tsim)
        assert [d.key for d in rc] == [d.key for d in tc]
        fsdp = rsim.STRATEGY_SPACES[space]["fsdp"]
        rctx = rsim.StepCostContext(rw, ref_config(arch), 4, 512, "tcme",
                                    fsdp=fsdp)
        tctx = tsim.StepCostContext(tw, get_config(arch), 4, 512, "tcme",
                                    fsdp=fsdp)
        for final in (False, True):
            r = rsim.simulate_batch(rctx, rc, run_tcme_optimizer=final,
                                    prune_oom=not final)
            t = tsim.simulate_batch(tctx, tc, run_tcme_optimizer=final,
                                    prune_oom=not final)
            assert canon(r) == canon(t), (space, final)
        assert canon(rsim.memory_components(rctx, rc[-1])) == \
            canon(tsim.memory_components(tctx, tc[-1]))


@pytest.mark.parametrize("arch", ("deepseek-7b", "olmoe-1b-7b"))
def test_simulate_decode_batch_matches_reference(arch):
    """The decode objective, with the EP axis for the MoE config."""
    rw, tw = _wafers("pristine")
    n = len(rw.alive_dies())
    rc = _grid(n, "temp", rsim)
    tc = _grid(n, "temp", tsim)
    if get_config(arch).is_moe:
        rc = rc + [dataclasses.replace(d, ep=e) for d in rc for e in (2, 4, 8)
                   if d.dp % e == 0]
        tc = tc + [dataclasses.replace(d, ep=e) for d in tc for e in (2, 4, 8)
                   if d.dp % e == 0]
        assert any(d.ep > 1 for d in tc)
    rctx = rsim.StepCostContext(rw, ref_config(arch), 16, 160, "tcme",
                                objective="decode")
    tctx = tsim.StepCostContext(tw, get_config(arch), 16, 160, "tcme",
                                objective="decode")
    for final in (False, True):
        r = rsim.simulate_decode_batch(rctx, rc, final=final)
        t = tsim.simulate_decode_batch(tctx, tc, final=final)
        assert canon(r) == canon(t), final
    deg_r = next(d for d in rc if d.tatp > 1)
    deg_t = next(d for d in tc if d.tatp > 1)
    assert canon(rsim.decode_memory_components(rctx, deg_r)) == \
        canon(tsim.decode_memory_components(tctx, deg_t))


def test_scalar_reference_paths_match_reference():
    rw, tw = _wafers("dies")
    deg_r, deg_t = rsim.ParallelDegrees(dp=2, tatp=8), \
        tsim.ParallelDegrees(dp=2, tatp=8)
    for arch in ("deepseek-7b", "zamba2-2.7b"):
        r = rsim.simulate_step_reference(rw.uncached(), ref_config(arch), 8,
                                         512, deg_r, "tcme")
        t = tsim.simulate_step_reference(tw.uncached(), get_config(arch), 8,
                                         512, deg_t, "tcme")
        assert canon(r) == canon(t), arch
        r = rsim.simulate_decode_reference(rw, ref_config(arch), 8, 256,
                                           deg_r)
        t = tsim.simulate_decode_reference(tw, get_config(arch), 8, 256,
                                           deg_t)
        assert canon(r) == canon(t), arch


# ---------------------------------------------------------------------------
# the torch tiers (stage1 / tierb = "torch:cpu" here; "torch" is the GPU):
# bitwise equal to the numpy tiers and to the reference's jitted "jax" tier
# ---------------------------------------------------------------------------

TORCH_CPU = "torch:cpu"


def _bits(cols: dict) -> dict:
    return {k: canon(np.asarray(v)) for k, v in cols.items()}


@pytest.mark.parametrize("model,batch", (("gpt3-76b", 64),
                                         ("gpt3-6.7b", 1536),
                                         ("llama2-7b", 3)))
def test_stage1_torch_matches_numpy(model, batch):
    """Twin of the reference's ``test_stage1_jax_matches_numpy``, but
    bitwise: every stage-1 field over every strategy space's candidates
    equals the port's and the reference's numpy stage 1 and the
    reference's jitted one (batches whose micro-batch ladder grows and one
    that stays at 1)."""
    rcfg, tcfg = rpaper.TABLE_II[model][0], tpaper.TABLE_II[model][0]
    rw, tw = _wafers("pristine")
    calls = tsim.TIER_CALLS["stage1"]
    for space in sorted(rsim.STRATEGY_SPACES):
        fsdp = rsim.STRATEGY_SPACES[space]["fsdp"]
        cands = _grid(32, space, tsim)
        cols = tsim._degree_columns(cands)[:5]
        rctx = rsim.StepCostContext(rw, rcfg, batch, 2048, fsdp=fsdp)
        tctx = tsim.StepCostContext(tw, tcfg, batch, 2048, fsdp=fsdp,
                                    stage1=TORCH_CPU)
        got = _bits(tsim._stage1_torch(tctx, *cols))
        assert got == _bits(tsim._stage1_numpy(tctx, *cols)), space
        assert got == _bits(rsim._stage1_numpy(rctx, *cols)), space
        assert got == _bits(rsim._stage1_jax(rctx, *cols)), space
    assert tsim.TIER_CALLS["stage1"] == calls + len(rsim.STRATEGY_SPACES)


def _spread(cands, k=9):
    """``tests/test_solver_fast.py``'s structurally diverse subsample."""
    if len(cands) <= k:
        return cands
    picks = {0, len(cands) - 1}
    picks.add(max(range(len(cands)), key=lambda i: cands[i].tatp))
    picks.add(max(range(len(cands)), key=lambda i: cands[i].sp))
    picks.add(max(range(len(cands)), key=lambda i: cands[i].tp))
    step = max(1, len(cands) // k)
    picks.update(range(0, len(cands), step))
    return [cands[i] for i in sorted(picks)][:k + 4]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("stream", ("auto", "weights", "acts"))
def test_tierb_torch_bitwise_on_random_degraded_wafers(seed, stream):
    """Twin of ``test_tierb_jax_bitwise_on_random_degraded_wafers``: the
    fused torch Tier B on a random degraded wafer (dead dies, dead links,
    a snake die subset), every stream policy, both orchestration
    directions, equals the reference's numpy tier and its jitted tier in
    every field and breakdown."""
    from repro.wafer.fault import random_degraded_wafer as rdw_ref
    from repro_torch.wafer.fault import random_degraded_wafer as rdw_port
    rw, dies = rdw_ref(seed)
    tw, tdies = rdw_port(seed)
    assert dies == tdies
    bidir = seed % 2 == 1
    spec = rsim.STRATEGY_SPACES["temp"]
    rc = _spread(rsim.candidate_degrees(len(dies), spec["allow"],
                                        spec["seq_par"]))
    tc = _spread(tsim.candidate_degrees(len(dies), spec["allow"],
                                        spec["seq_par"]))
    assert len(tc) >= tsim._TIER_MIN_BATCH, (seed, len(tc))
    kw = dict(stream=stream, tatp_bidirectional=bidir, dies=dies)
    cfg_r, cfg_t = rpaper.TABLE_II["gpt3-6.7b"][0], \
        tpaper.TABLE_II["gpt3-6.7b"][0]
    calls = tsim.TIER_CALLS["tierb"]
    got = canon(tsim.simulate_batch(
        tsim.StepCostContext(tw, cfg_t, 32, 2048, tierb=TORCH_CPU, **kw),
        tc))
    assert tsim.TIER_CALLS["tierb"] == calls + 1
    for tier in ("numpy", "jax"):
        want = rsim.simulate_batch(rsim.StepCostContext(
            rw, cfg_r, 32, 2048, tierb=tier, **kw), rc)
        assert got == canon(want), tier


@pytest.mark.parametrize("arch", ("gpt3-6.7b", "olmoe-1b-7b"))
def test_tierb_torch_bitwise_on_the_pristine_wafer(arch):
    """Every strategy space's whole grid on the 4 x 8 wafer, search-time
    (the tier) and final scoring (the numpy anchor), against the
    reference's numpy and jitted tiers; both tiers of the port run their
    stage 1 on torch too."""
    rcfg = rpaper.TABLE_II[arch][0] if arch in rpaper.TABLE_II \
        else ref_config(arch)
    tcfg = tpaper.TABLE_II[arch][0] if arch in tpaper.TABLE_II \
        else get_config(arch)
    rw, tw = _wafers("pristine")
    calls = dict(tsim.TIER_CALLS)
    for space in sorted(rsim.STRATEGY_SPACES):
        fsdp = rsim.STRATEGY_SPACES[space]["fsdp"]
        rc, tc = _grid(32, space, rsim), _grid(32, space, tsim)
        tctx = tsim.StepCostContext(tw, tcfg, 32, 2048, fsdp=fsdp,
                                    tierb=TORCH_CPU, stage1=TORCH_CPU)
        for final in (False, True):
            got = canon(tsim.simulate_batch(tctx, tc,
                                            run_tcme_optimizer=final,
                                            prune_oom=not final))
            for tier in ("numpy", "jax"):
                rctx = rsim.StepCostContext(rw, rcfg, 32, 2048, fsdp=fsdp,
                                            tierb=tier)
                assert got == canon(rsim.simulate_batch(
                    rctx, rc, run_tcme_optimizer=final,
                    prune_oom=not final)), (space, final, tier)
    for stage in ("stage1", "tierb"):
        assert tsim.TIER_CALLS[stage] > calls[stage], stage


@pytest.mark.parametrize("seed", (1, 5))
def test_dlws_trajectory_identity_under_tierb_torch(seed):
    """Twin of ``test_dlws_trajectory_identity_under_tierb_jax``: the torch
    tiers walk the reference's search trajectory to the same solution
    (the scalar reference evaluator's and the jitted tier's), with the
    same number of evaluations."""
    from repro.wafer.fault import random_degraded_wafer as rdw_ref
    from repro_torch.wafer.fault import random_degraded_wafer as rdw_port
    rw, dies = rdw_ref(seed)
    tw, _ = rdw_port(seed)
    rcfg, tcfg = rpaper.TABLE_II["llama2-7b"][0], \
        tpaper.TABLE_II["llama2-7b"][0]
    got = tsolver.dlws_solve(tw, tcfg, 16, 2048, space="temp", dies=dies,
                             tierb=TORCH_CPU, stage1=TORCH_CPU)
    ref = rsolver.dlws_solve(rw.uncached(), rcfg, 16, 2048, space="temp",
                             dies=dies, evaluator="reference")
    jx = rsolver.dlws_solve(rw, rcfg, 16, 2048, space="temp", dies=dies,
                            tierb="jax")
    assert _solve_fields(got) == _solve_fields(jx)
    assert got.config.key == ref.config.key
    assert got.best.throughput == ref.best.throughput
    assert got.best.mem_per_die == ref.best.mem_per_die
    assert got.evaluated == ref.evaluated


@pytest.mark.parametrize("arch", ("llama2-7b", "olmoe-1b-7b"))
def test_decode_objective_parity_tierb_torch(arch):
    """Twin of ``test_decode_objective_parity_tierb_jax``, with an MoE
    architecture whose candidates grow the EP axis: the torch decode tier
    equals the reference's numpy and jitted tiers over a whole candidate
    space, and a full decode solve picks the same serving config after
    the same evaluations."""
    rcfg = rpaper.TABLE_II[arch][0] if arch in rpaper.TABLE_II \
        else ref_config(arch)
    tcfg = tpaper.TABLE_II[arch][0] if arch in tpaper.TABLE_II \
        else get_config(arch)
    rc, tc = _grid(64, "temp", rsim), _grid(64, "temp", tsim)
    if tcfg.is_moe:
        rc = rc + [dataclasses.replace(d, ep=e) for d in rc for e in (2, 4, 8)
                   if d.dp % e == 0]
        tc = tc + [dataclasses.replace(d, ep=e) for d in tc for e in (2, 4, 8)
                   if d.dp % e == 0]
        assert any(d.ep > 1 for d in tc)
    assert len(tc) >= tsim._TIER_MIN_BATCH
    rw, tw = _wafers("pristine")
    calls = tsim.TIER_CALLS["decode"]
    got = canon(tsim.simulate_decode_batch(tsim.StepCostContext(
        tw, tcfg, 64, 4096, objective="decode", tierb=TORCH_CPU), tc))
    assert tsim.TIER_CALLS["decode"] == calls + 1
    for tier in ("numpy", "jax"):
        assert got == canon(rsim.simulate_decode_batch(rsim.StepCostContext(
            rw, rcfg, 64, 4096, objective="decode", tierb=tier), rc)), tier
    r = rsolver.dlws_solve(rtopo.Wafer(rtopo.WaferSpec()), rcfg, 64, 4096,
                           space="temp", objective="decode")
    t = tsolver.dlws_solve(ttopo.Wafer(ttopo.WaferSpec()), tcfg, 64, 4096,
                           space="temp", objective="decode", tierb=TORCH_CPU)
    assert _solve_fields(r) == _solve_fields(t)


def test_resident_context_keys_the_tier():
    """Twin of ``test_resident_context_reuse_and_isolation``'s key checks:
    one context per cost-surface identity, the tier part of it."""
    w = ttopo.Wafer(ttopo.WaferSpec())
    cfg = tpaper.TABLE_II["gpt3-6.7b"][0]
    a = tsim.StepCostContext.resident(w, cfg, 16, 2048, tierb="numpy")
    assert tsim.StepCostContext.resident(w, cfg, 16, 2048,
                                         tierb="numpy") is a
    assert tsim.StepCostContext.resident(w, cfg, 16, 2048, tierb="numpy",
                                         stream="weights") is not a
    b = tsim.StepCostContext.resident(w, cfg, 16, 2048, tierb=TORCH_CPU)
    assert b is not a and b.tierb == TORCH_CPU
    assert tsim.StepCostContext.resident(w, cfg, 16, 2048,
                                         tierb=TORCH_CPU) is b
    assert tsim.StepCostContext.resident(w, cfg, 16, 2048, tierb="numpy",
                                         stage1=TORCH_CPU) is not a
    assert tsim.StepCostContext.resident(w, cfg, 32, 2048,
                                         tierb="numpy") is not a
    u = w.uncached()
    assert tsim.StepCostContext.resident(u, cfg, 16, 2048,
                                         tierb=TORCH_CPU) \
        is not tsim.StepCostContext.resident(u, cfg, 16, 2048,
                                             tierb=TORCH_CPU)


@pytest.mark.parametrize("name,value", (("stage1", "jax"),
                                        ("tierb", "jax")))
def test_jitted_tiers_raise_a7(name, value, monkeypatch):
    """The reference's jitted-tier setting ``"jax"`` (ROADMAP.md item A7,
    which once raised here as unported) raises ``ValueError`` naming
    ``"torch"``, by argument and through ``REPRO_STAGE1`` /
    ``REPRO_TIERB``, as does any other unknown backend; ``"torch"`` raises
    without a GPU (never falling back to numpy); and ``"torch:cpu"``, by
    argument and through the variable, gives the reference's solve."""
    tw = ttopo.Wafer(ttopo.WaferSpec())
    cfg = get_config("deepseek-7b")
    for bad in (value, "numba"):
        with pytest.raises(ValueError, match="'torch'"):
            tsim.StepCostContext(tw, cfg, 4, 512, **{name: bad})
        with pytest.raises(ValueError, match="'torch'"):
            tsim.StepCostContext.resident(tw, cfg, 4, 512, **{name: bad})
        with pytest.raises(ValueError, match="'torch'"):
            tsolver.dlws_solve(tw, cfg, 4, 512, **{name: bad})
    monkeypatch.setenv("REPRO_" + name.upper(), value)
    with pytest.raises(ValueError, match="'torch'"):
        tsim.StepCostContext(tw, cfg, 4, 512)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsim.StepCostContext(tw, cfg, 4, 512, **{name: "torch"})
        m.setenv("REPRO_" + name.upper(), "torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsolver.dlws_solve(tw, cfg, 4, 512)
    monkeypatch.setenv("REPRO_" + name.upper(), "numpy")
    assert getattr(tsim.StepCostContext(tw, cfg, 4, 512), name) == "numpy"
    want = _solve_fields(rsolver.dlws_solve(
        rtopo.Wafer(rtopo.WaferSpec()), ref_config("deepseek-7b"), 4, 512))
    calls = dict(tsim.TIER_CALLS)
    got = tsolver.dlws_solve(ttopo.Wafer(ttopo.WaferSpec()), cfg, 4, 512,
                             **{name: TORCH_CPU})
    assert _solve_fields(got) == want
    monkeypatch.setenv("REPRO_" + name.upper(), TORCH_CPU)
    assert getattr(tsim.StepCostContext(tw, cfg, 4, 512), name) == TORCH_CPU
    got = tsolver.dlws_solve(ttopo.Wafer(ttopo.WaferSpec()), cfg, 4, 512)
    assert _solve_fields(got) == want
    assert tsim.TIER_CALLS[name] > calls[name]


# ---------------------------------------------------------------------------
# the DLWS solver, both levels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_dlws_solve_matches_reference(arch):
    """All eleven architectures at one train shape: the same degrees, the
    same objective and the same search trajectory, bitwise."""
    rw, tw = _wafers("pristine")
    r = rsolver.dlws_solve(rw, ref_config(arch), 4, 512)
    t = tsolver.dlws_solve(tw, get_config(arch), 4, 512)
    assert _solve_fields(r) == _solve_fields(t)
    assert canon(rsolver._score(r.best)) == canon(tsolver._score(t.best))


@pytest.mark.parametrize("arch", ("deepseek-7b", "zamba2-2.7b"))
def test_dlws_solve_degraded_matches_reference(arch):
    rw, tw = _wafers("dies+links")
    r = rsolver.dlws_solve(rw, ref_config(arch), 8, 512, space="temp")
    t = tsolver.dlws_solve(tw, get_config(arch), 8, 512, space="temp")
    assert _solve_fields(r) == _solve_fields(t)
    dies = rw.alive_dies()[:13]  # a prime die subset
    r = rsolver.dlws_solve(rw, ref_config(arch), 8, 512, dies=dies)
    t = tsolver.dlws_solve(tw, get_config(arch), 8, 512, dies=dies)
    assert _solve_fields(r) == _solve_fields(t)


@pytest.mark.parametrize("arch", ("gemma-7b", "olmoe-1b-7b"))
def test_dlws_decode_solve_matches_reference(arch):
    """``objective="decode"`` at a serve shape (olmoe's search grows the
    EP axis)."""
    rw, tw = _wafers("pristine")
    r = rsolver.dlws_solve(rw, ref_config(arch), 4, 160, objective="decode")
    t = tsolver.dlws_solve(tw, get_config(arch), 4, 160, objective="decode")
    assert _solve_fields(r) == _solve_fields(t)


@pytest.mark.parametrize("n_wafers", (2, 4, 8))
def test_dlws_solve_multiwafer_matches_reference(n_wafers):
    rws = [rtopo.Wafer(rtopo.WaferSpec()) for _ in range(n_wafers)]
    tws = [ttopo.Wafer(ttopo.WaferSpec()) for _ in range(n_wafers)]
    r = rsolver.dlws_solve_multiwafer(rws, ref_config("deepseek-7b"), 4, 512)
    t = tsolver.dlws_solve_multiwafer(tws, get_config("deepseek-7b"), 4, 512)
    assert (r.pp, r.stage_layers, r.n_micro, r.family) == \
        (t.pp, t.stage_layers, t.n_micro, t.family)
    assert sum(t.stage_layers) == get_config("deepseek-7b").n_layers
    for name in ("stage_wafer", "stage_dies", "step_time", "throughput",
                 "bubble", "peak_inflight", "stage_mem", "oom", "evaluated",
                 "candidates"):
        assert canon(getattr(r, name)) == canon(getattr(t, name)), name
    for rs, ts in zip(r.stages, t.stages):
        assert _solve_fields(rs) == _solve_fields(ts)


def test_solver_helpers_match_reference():
    for n in (1, 7, 23, 32, 47, 92, 512):
        assert rsim.divisors(n) == tsim.divisors(n)
        assert rsolver.refine_values(n) == tsolver.refine_values(n)
    for total, weights in ((30, (32, 32, 32, 32)), (30, (29, 32)),
                           (7, (1.0, 2.0, 3.5)), (8, (5, 5, 5, 5, 5, 5, 5,
                                                      5))):
        assert rsolver.apportion(total, weights) == \
            tsolver.apportion(total, weights)
        assert rsolver.split_layers(total, weights) == \
            tsolver.split_layers(total, weights)
    for arch in ARCHITECTURES:
        assert rsolver.partition_graph(ref_config(arch)) == \
            tsolver.partition_graph(get_config(arch))
        assert dataclasses.astuple(rsolver.stage_config(ref_config(arch), 4)) \
            == dataclasses.astuple(tsolver.stage_config(get_config(arch), 4))
    rw, tw = _wafers("dies")
    for k in (2, 3, 4):
        assert rsolver.stage_die_split(rw, k) == tsolver.stage_die_split(tw, k)
    for space in sorted(rsim.STRATEGY_SPACES):
        assert rsim.smap_config(32, space).key == tsim.smap_config(32,
                                                                   space).key
