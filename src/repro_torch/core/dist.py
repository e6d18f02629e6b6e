"""Distribution context (counterpart of ``repro.core.dist``).

The reference's ``Dist`` wraps a JAX mesh with ``data``/``model`` axes
(and ``pod`` before them on the multi-pod mesh) and its model code runs
inside ``shard_map`` with per-shard arrays and explicit collectives
(``lax.axis_index``, ``ppermute``, ``psum``, ``pmax``, ``pmin``,
``all_gather``).  Here every rank is one process and its model code runs
on its own shards; :class:`Dist` holds the ``(data, model)`` or ``(pod,
data, model)`` mesh, this rank's coordinates on it and one
``torch.distributed`` process group per axis, and gives the same
collectives as methods.  The batch is sharded over ``pod`` and ``data``
together, pod-major (:meth:`Dist.batch_index`).

``Dist(device)`` alone is the one-device mesh ``(1, 1)``: every
collective over an axis of size 1 is the identity, so degree-1 callers
need no process group.  :func:`make_mesh_dist` builds the multi-rank one
(after :func:`init_world`).

Transport: the backend is the caller's choice (``--dist-backend``), never
picked by probing the machine.

* ``gloo`` moves host tensors between processes.  A collective on a CUDA
  tensor therefore copies it to a pinned host buffer (reused from call to
  call, :class:`HostStage`), runs the collective there and copies the
  result back; every copy waits for the device.  Several ranks may share
  one GPU this way: their kernels run on the card, their transfers go
  through the host.  :attr:`HostStage.seconds` clocks the staged
  collectives.
* ``nccl`` moves CUDA tensors in place; ranks that share a GPU raise
  (NCCL refuses them).

* ``fake`` (``torch.testing._internal.distributed.fake_pg``) moves
  nothing: one process traces one rank of a large mesh for the dry-run
  (:mod:`repro_torch.launch.dryrun`).

Every group has a timeout (:data:`GROUP_TIMEOUT_S`), so a lost rank fails
the run instead of hanging it.

Census: every collective a rank issues over an axis of more than one
member adds its kind, one to its count and its bytes to
:attr:`Dist.census` (:class:`Census`), on every backend, staged or not,
by the reference dry-run's per-device conventions.  ``psum_scatter``, an
all-reduce and a slice here, counts as the all-reduce it moves.

Gradients: under autograd :meth:`Dist.ppermute` (and
:meth:`Dist.ppermute_many`), :meth:`Dist.psum` and :meth:`Dist.all_to_all`
are differentiable, with the transposes jax 0.9 gives them under
``shard_map(check_vma=False)`` (checked on fake devices): a
``ppermute``'s cotangent travels the inverse permutation, a ``psum``'s
cotangent is psummed, and an ``all_to_all``'s cotangent takes the same
all-to-all back.  ``megatron``'s tensor parallelism takes Megatron's two
conjugate operators instead of ``psum`` (:meth:`Dist.psum_id_bwd`: psum
forward, identity backward; :meth:`Dist.id_psum_bwd`: identity forward,
psum backward), so its gradients are the degree-1 ones.  Every rank runs
the same graph, so the backward's collectives meet in the same order on
all of them.  The other collectives are not differentiated (the
optimizer's run under ``no_grad``).
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.distributed as tdist

MODEL_AXIS = "model"  # the TATP ring axis
DATA_AXIS = "data"
POD_AXIS = "pod"
BATCH_AXES = ("pod", "data")  # axes that shard the batch dimension
BACKENDS = ("gloo", "nccl")
GROUP_TIMEOUT_S = 300


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device must exist.  Entry points
    call this so a missing GPU raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the GPU by "
            "default — pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


class HostStage:
    """Pinned host buffers for gloo collectives on CUDA tensors, one per
    role, grown to the largest payload and reused; and the clock of the
    staged collectives: ``seconds`` (host time from the device's last
    queued work to the result back on the device, copies included),
    ``calls`` and ``bytes`` (payload bytes this rank sent or
    contributed)."""

    def __init__(self):
        self._buffers: dict = {}
        self.seconds = 0.0
        self.calls = 0
        self.bytes = 0

    def buffer(self, role, nbytes: int) -> torch.Tensor:
        buf = self._buffers.get(role)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._buffers[role] = buf
        return buf[:nbytes]


COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


class Census:
    """The collectives a rank issued, by kind: ``count`` and ``bytes`` a
    kind, in the reference dry-run's per-device wire bytes (its
    ``collective_census``): a collective-permute its output bytes, an
    all-gather output less input, an all-reduce twice its output, a
    reduce-scatter input less output, an all-to-all its output."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.kinds = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}

    def add(self, kind: str, nbytes: int) -> None:
        entry = self.kinds[kind]
        entry["count"] += 1
        entry["bytes"] += int(nbytes)

    def as_dict(self) -> dict:
        """The reference's record: each kind's ``count`` and ``bytes``, and
        ``total_bytes``."""
        out = {k: dict(v) for k, v in self.kinds.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.kinds.values())
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass(frozen=True)
class AxisGroup:
    """One mesh axis's process group and its members' global ranks in
    axis-index order.  ``order`` is each axis member's rank within the
    process group, which numbers its members by global rank: under a
    plan's device order (the snake) the two differ, and the collectives
    whose blocks follow the group's numbering (all-gather, all-to-all)
    put them back in axis order."""

    group: object
    ranks: tuple[int, ...]
    order: tuple[int, ...] = ()

    def axis_ordered(self) -> bool:
        return not self.order or list(self.order) == sorted(self.order)


def _identity_permute(x, perm):
    """``ppermute`` over an axis of size 1."""
    xs = x if isinstance(x, tuple) else (x,)
    outs = tuple(t.clone() if (0, 0) in perm else torch.zeros_like(t)
                 for t in xs)
    return outs if isinstance(x, tuple) else outs[0]


def _inverse(perm):
    return [(d, s) for s, d in perm]


class _PPermute(torch.autograd.Function):
    """:meth:`Dist.ppermute_many` under autograd: ``items`` as ``(x,
    perm)`` with ``x`` flattened into the tensor inputs; the backward moves
    each floating output's cotangent along the inverse permutation (zeros
    where none arrives), in one batch.  An output no gradient reaches (one
    that feeds only a ``detach``) relays nothing, as jax transposes no
    symbolic zero; every rank runs the same graph, so the ranks agree on
    which."""

    @staticmethod
    def forward(ctx, dist, axis, spec, *flat):
        ctx.set_materialize_grads(False)
        ctx.dist, ctx.axis, ctx.spec = dist, axis, spec
        items, k = [], 0
        for n, perm in spec:
            items.append((tuple(flat[k:k + n]), perm))
            k += n
        outs = [t for res in dist._ppermute_raw(items, axis) for t in res]
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        ctx.floats = [t.is_floating_point() for t in flat]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        items, sent, k = [], [], 0
        for n, perm in ctx.spec:
            idx = [j for j in range(k, k + n)
                   if ctx.floats[j] and grads[j] is not None]
            if idx:
                items.append((tuple(grads[j] for j in idx), _inverse(perm)))
                sent += idx
            k += n
        moved = [t for res in ctx.dist._ppermute_raw(items, ctx.axis)
                 for t in res] if items else []
        back = dict(zip(sent, moved))
        return (None, None, None,
                *[back.get(j) for j in range(len(ctx.floats))])


class _PSum(torch.autograd.Function):
    """:meth:`Dist.psum` under autograd: the cotangent is psummed too."""

    @staticmethod
    def forward(ctx, dist, axis, x):
        ctx.dist, ctx.axis = dist, axis
        return dist._all_reduce(x, axis, "SUM")

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.dist._all_reduce(g, ctx.axis, "SUM")


class _PSumIdBwd(torch.autograd.Function):
    """:meth:`Dist.psum_id_bwd`: psum forward, the cotangent as it is."""

    @staticmethod
    def forward(ctx, dist, axis, x):
        return dist._all_reduce(x, axis, "SUM")

    @staticmethod
    def backward(ctx, g):
        return None, None, g


class _IdPSumBwd(torch.autograd.Function):
    """:meth:`Dist.id_psum_bwd`: ``x`` forward, the cotangent psummed."""

    @staticmethod
    def forward(ctx, dist, axis, x):
        ctx.dist, ctx.axis = dist, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.dist._all_reduce(g, ctx.axis, "SUM")


class _AllToAll(torch.autograd.Function):
    """:meth:`Dist.all_to_all` under autograd: the cotangent takes the same
    all-to-all (it is its own transpose)."""

    @staticmethod
    def forward(ctx, dist, axis, x):
        ctx.dist, ctx.axis = dist, axis
        return dist._all_to_all_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.dist._all_to_all_raw(g, ctx.axis)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


@dataclass(frozen=True)
class Dist:
    """This rank's view of the ``(data, model)`` or ``(pod, data,
    model)`` mesh.

    ``coords`` is its index on each axis of ``mesh_shape``; ``groups``
    maps each axis to its :class:`AxisGroup` (empty on one device);
    ``stage`` stages gloo collectives of CUDA tensors (None without a
    process group); ``census`` counts this rank's collectives."""

    device: torch.device
    model_axis: str = MODEL_AXIS
    mesh_shape: tuple[int, ...] = (1, 1)
    coords: tuple[int, ...] = (0, 0)
    backend: Optional[str] = None
    groups: dict = field(default_factory=dict, compare=False, repr=False)
    stage: Optional[HostStage] = field(default=None, compare=False,
                                       repr=False)
    census: Census = field(default_factory=Census, compare=False,
                           repr=False)

    def __post_init__(self):
        if len(self.mesh_shape) not in (2, 3) \
                or len(self.coords) != len(self.mesh_shape):
            raise ValueError(f"mesh {self.mesh_shape} with coordinates "
                             f"{self.coords}: (data, model) or (pod, data, "
                             f"model) expected")

    @property
    def axis_names(self) -> tuple[str, ...]:
        names = (DATA_AXIS, self.model_axis)
        return (POD_AXIS, *names) if len(self.mesh_shape) == 3 else names

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.mesh_shape))

    @property
    def present_batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in BATCH_AXES if a in self.axis_sizes)

    @property
    def model_degree(self) -> int:
        return self.mesh_shape[-1]

    @property
    def batch_degree(self) -> int:
        """The product of the batch axes' sizes (``pod`` times ``data``)."""
        return self.split(self.present_batch_axes)[0]

    @property
    def n_devices(self) -> int:
        return self.batch_degree * self.model_degree

    def axis_size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (``lax.axis_index``)."""
        if axis not in self.axis_sizes:
            raise ValueError(f"no mesh axis {axis!r} in {self.axis_sizes}")
        return self.coords[self.axis_names.index(axis)]

    def split(self, entry) -> tuple[int, int]:
        """``(ranks, index)`` of this rank over a partition-spec entry: an
        axis, a tuple of axes (major first, as ``("pod", "data")``) or
        None (one rank, index 0)."""
        n, i = 1, 0
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            n, i = n * self.axis_size(a), i * self.axis_size(a) + \
                self.axis_index(a)
        return n, i

    def batch_index(self) -> int:
        """This rank's index over the batch axes together, pod-major: its
        block of a batch sharded over ``(pod, data)``."""
        return self.split(self.present_batch_axes)[1]

    # ------------------------------------------------------------------
    # collectives (each returns a new tensor, as its lax counterpart)
    # ------------------------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _clock(self, t: torch.Tensor):
        if self._staged(t):
            torch.cuda.current_stream(t.device).synchronize()
        return time.perf_counter()

    def _tick(self, t: torch.Tensor, t0: float, nbytes: int):
        if self._staged(t):
            self.stage.seconds += time.perf_counter() - t0
            self.stage.calls += 1
            self.stage.bytes += nbytes

    def ppermute(self, x, axis: str, perm: Sequence[tuple[int, int]]):
        """``lax.ppermute``: each ``(src, dst)`` pair of axis indices sends
        ``src``'s value to ``dst``; a rank no pair sends to gets zeros.
        ``x`` is a tensor or a tuple of tensors (moved in one batch)."""
        return self.ppermute_many([(x, perm)], axis)[0]

    def ppermute_many(self, items, axis: str) -> list:
        """Several :meth:`ppermute` calls ``[(x, perm), ...]`` in one batch
        of point-to-point operations (``batch_isend_irecv``), e.g. the two
        directions of a bidirectional ring round.  Between two ranks the
        messages pair up in item order on both sides.  Differentiable
        (:class:`_PPermute`) when a floating input requires grad."""
        flat = [t for x, _ in items
                for t in (x if isinstance(x, tuple) else (x,))]
        if (self.axis_size(axis) > 1 and torch.is_grad_enabled()
                and any(t.requires_grad for t in flat)):
            spec = tuple((len(x) if isinstance(x, tuple) else 1,
                          tuple(perm)) for x, perm in items)
            outs = _PPermute.apply(self, axis, spec, *flat)
            res, k = [], 0
            for (x, _), (n, _) in zip(items, spec):
                part = tuple(outs[k:k + n])
                res.append(part if isinstance(x, tuple) else part[0])
                k += n
            return res
        return self._ppermute_raw(items, axis)

    def _ppermute_raw(self, items, axis: str) -> list:
        """:meth:`ppermute_many` outside autograd."""
        if self.axis_size(axis) == 1:
            return [_identity_permute(x, perm) for x, perm in items]
        ag = self.groups[axis]
        i = self.axis_index(axis)
        moves, results = [], []
        for x, perm in items:
            xs = tuple(t.contiguous()
                       for t in (x if isinstance(x, tuple) else (x,)))
            dst = next((ag.ranks[d] for s, d in perm if s == i), None)
            src = next((ag.ranks[s] for s, d in perm if d == i), None)
            outs = tuple(torch.zeros_like(t) if src is None else
                         torch.empty(t.shape, dtype=t.dtype, device=t.device)
                         for t in xs)
            moves += [(t, o, dst, src) for t, o in zip(xs, outs)]
            results.append(outs if isinstance(x, tuple) else outs[0])
        t0 = self._clock(moves[0][0])
        ops, back, sent = [], [], 0
        # the fake world moves nothing: its ranks build no messages
        for k, (t, o, dst, src) in enumerate(
                [] if self.backend == "fake" else moves):
            send, recv = _bytes(t), _bytes(o)
            if self._staged(t):
                send = self.stage.buffer(("send", k), send.numel()).copy_(send)
                if src is not None:
                    host = self.stage.buffer(("recv", k), recv.numel())
                    back.append((recv, host))
                    recv = host
            if dst is not None:
                ops.append(tdist.P2POp(tdist.isend, send, dst, ag.group))
                sent += send.numel()
            if src is not None:
                ops.append(tdist.P2POp(tdist.irecv, recv, src, ag.group))
        if ops:
            for work in tdist.batch_isend_irecv(ops):
                work.wait()
        for dev_bytes, host in back:
            dev_bytes.copy_(host)
        self._tick(moves[0][0], t0, sent)
        for x, _ in items:
            self.census.add("collective-permute", sum(
                _nbytes(t) for t in (x if isinstance(x, tuple) else (x,))))
        return results

    def _all_reduce(self, x: torch.Tensor, axis: str, op):
        if self.axis_size(axis) == 1:
            return x
        out = x.contiguous().clone()
        t0 = self._clock(out)
        buf = out
        if self._staged(out):
            buf = self.stage.buffer("reduce", out.numel() * out.element_size()
                                    ).view(out.dtype).view(out.shape)
            buf.copy_(out)
        tdist.all_reduce(buf, op=getattr(tdist.ReduceOp, op),
                         group=self.groups[axis].group)
        if buf is not out:
            out.copy_(buf)
        self._tick(out, t0, _nbytes(out))
        self.census.add("all-reduce", 2 * _nbytes(out))
        return out

    def psum(self, x, axis: str):
        """``lax.psum`` over ``axis``, in ``x``'s dtype (differentiable:
        :class:`_PSum`)."""
        if (self.axis_size(axis) > 1 and torch.is_grad_enabled()
                and x.requires_grad):
            return _PSum.apply(self, axis, x)
        return self._all_reduce(x, axis, "SUM")

    def psum_id_bwd(self, x, axis: str):
        """``psum`` over ``axis`` whose backward passes the cotangent on
        unchanged (Megatron's all-reduce after a row-parallel product):
        where every rank's copy of the result feeds the same replicated
        loss, each rank's cotangent is already the whole one."""
        if (self.axis_size(axis) > 1 and torch.is_grad_enabled()
                and x.requires_grad):
            return _PSumIdBwd.apply(self, axis, x)
        return self._all_reduce(x, axis, "SUM")

    def id_psum_bwd(self, x, axis: str):
        """``x`` itself, whose cotangent is psummed over ``axis`` in the
        backward (Megatron's identity before a column-parallel group): a
        replicated activation that each rank multiplies by its own block
        gathers every block's part of its gradient."""
        if (self.axis_size(axis) > 1 and torch.is_grad_enabled()
                and x.requires_grad):
            return _IdPSumBwd.apply(self, axis, x)
        return x

    def all_to_all(self, x, axis: str):
        """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)``: ``x``
        is ``[axis size, ...]``; block ``j`` goes to the axis member ``j``,
        and row ``j`` of the result is what member ``j`` sent this rank
        (gloo's ``all_to_all_single``, staged as the other collectives;
        differentiable, :class:`_AllToAll`)."""
        if (self.axis_size(axis) > 1 and torch.is_grad_enabled()
                and x.requires_grad):
            return _AllToAll.apply(self, axis, x)
        return self._all_to_all_raw(x, axis)

    def _all_to_all_raw(self, x, axis: str):
        r = self.axis_size(axis)
        if x.shape[0] != r:
            raise ValueError(f"all_to_all needs dim 0 of size {r}, got "
                             f"{tuple(x.shape)}")
        if r == 1:
            return x.clone()
        ag = self.groups[axis]
        # block j goes to axis member j, the group's member order[j]
        perm = None if ag.axis_ordered() else list(ag.order)
        inv = None if perm is None else [perm.index(g) for g in range(r)]
        x = (x if perm is None else x[inv]).contiguous()
        nbytes = x.numel() * x.element_size()
        out = torch.empty_like(x)
        t0 = self._clock(x)
        staged = self._staged(x)
        send, recv = _bytes(x), _bytes(out)
        if staged:
            send = self.stage.buffer("a2a_send", nbytes).copy_(send)
            recv = self.stage.buffer("a2a_recv", nbytes)
        tdist.all_to_all_single(recv, send, group=ag.group)
        if staged:
            _bytes(out).copy_(recv)
        self._tick(x, t0, nbytes)
        self.census.add("all-to-all", nbytes)
        return out if perm is None else out[perm]

    def psum_scatter(self, x, axis: str):
        """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=False)``:
        ``x`` is ``[axis size, ...]``; this rank gets row ``axis_index``
        of the sum over the axis.  Built from an all-reduce and a slice
        (gloo has no reduce-scatter), staged as the other collectives, and
        counted in the census as the all-reduce it moves."""
        r = self.axis_size(axis)
        if x.shape[0] != r:
            raise ValueError(f"psum_scatter needs dim 0 of size {r}, got "
                             f"{tuple(x.shape)}")
        return self._all_reduce(x, axis, "SUM")[self.axis_index(axis)].clone()

    def pmax(self, x, axis: str):
        return self._all_reduce(x, axis, "MAX")

    def pmin(self, x, axis: str):
        return self._all_reduce(x, axis, "MIN")

    def all_gather(self, x, axis: str, dim: int = -1):
        """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the axis
        members' blocks concatenated along ``dim`` in axis-index order."""
        r = self.axis_size(axis)
        if r == 1:
            return x
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        out = torch.empty((r, *x.shape), dtype=x.dtype, device=x.device)
        t0 = self._clock(x)
        staged = self._staged(x)
        send, recv = _bytes(x), _bytes(out)
        if staged:
            send = self.stage.buffer("gather_send", nbytes).copy_(send)
            recv = self.stage.buffer("gather_recv", r * nbytes)
        ag = self.groups[axis]
        tdist.all_gather(list(recv.view(r, nbytes).unbind(0)), send,
                         group=ag.group)
        if staged:
            _bytes(out).copy_(recv)
        self._tick(x, t0, nbytes)
        self.census.add("all-gather", (r - 1) * nbytes)
        if not ag.axis_ordered():  # the group's order to the axis's
            out = out[list(ag.order)]
        return torch.cat(out.unbind(0), dim=dim)


# ---------------------------------------------------------------------------
# the multi-rank mesh
# ---------------------------------------------------------------------------


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=GROUP_TIMEOUT_S)


def world_from_env() -> tuple[int, int, int]:
    """``(rank, world_size, local_rank)`` as ``torch.distributed.run``
    sets them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); ``(0, 1, 0)``
    outside it."""
    env = os.environ
    return (int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1)),
            int(env.get("LOCAL_RANK", 0)))


def init_world(backend: str = "gloo", *, store=None, rank=None,
               world_size=None) -> None:
    """``init_process_group`` for ``backend`` with :data:`GROUP_TIMEOUT_S`:
    from ``store``, ``rank`` and ``world_size`` when given (a
    ``FileStore``), else from ``torch.distributed.run``'s environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    kw = dict(backend=backend, timeout=_timeout())
    if store is not None:
        kw.update(store=store, rank=rank, world_size=world_size)
    tdist.init_process_group(**kw)


def device_key(device: torch.device) -> str:
    """Which physical device ``device`` is: host and GPU uuid (or "cpu")."""
    if device.type != "cuda":
        return f"{socket.gethostname()}:cpu"
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}:{props.uuid}"


def check_transport(backend: str, keys: Sequence[str]) -> None:
    """Raise where ``backend`` cannot serve ranks on the devices ``keys``
    (:func:`device_key` of each rank): ``nccl`` needs one GPU a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "nccl":
        return
    if any(k.endswith(":cpu") for k in keys):
        raise ValueError("the nccl backend needs every rank on a GPU")
    if len(set(keys)) < len(keys):
        raise ValueError(
            f"the nccl backend needs one GPU a rank, but ranks share a "
            f"device ({list(keys)}); use the gloo backend, which stages "
            f"through the host")


def _axis_lines(shape: tuple[int, ...], order) -> list:
    """``(axis, members)`` of every line of the mesh ``shape`` along each
    of its axes, members in axis-index order: the ``(data, model)`` lines
    as they have always been created, then the ``pod`` lines of a
    three-axis mesh.  Mesh position ``p`` (row-major over ``shape``)
    holds global rank ``order[p]``."""
    pods, data, model = (1, *shape) if len(shape) == 2 else shape

    def rank(p, d, m):
        return order[(p * data + d) * model + m]

    lines = []
    for p in range(pods):
        lines += [(DATA_AXIS, [rank(p, d, m) for d in range(data)])
                  for m in range(model)]
    for p in range(pods):
        lines += [(MODEL_AXIS, [rank(p, d, m) for m in range(model)])
                  for d in range(data)]
    if len(shape) == 3:
        lines += [(POD_AXIS, [rank(p, d, m) for p in range(pods)])
                  for d in range(data) for m in range(model)]
    return lines


def make_mesh_dist(shape: Sequence[int], device="cuda",
                   order: Optional[Sequence[int]] = None,
                   ranks: Optional[Sequence[int]] = None) -> Optional[Dist]:
    """The :class:`Dist` of this rank on a ``(data, model)`` or ``(pod,
    data, model)`` mesh over the initialised world (:func:`init_world`),
    or over its ``ranks`` (a pipeline stage's block; default every rank).
    Mesh position ``p`` (row-major over the shape, pod-major as the
    reference's ``make_production_mesh`` lays it out: ``p = d * model +
    m``, or ``(q * data + d) * model + m`` on pod ``q``) holds global
    rank ``order[p]`` (default: the ``p``-th of ``ranks``); a lone degree
    is the data axis, as the reference's ``--mesh D``.  Every rank of the
    world calls it and builds every axis group in the same order, as
    ``torch.distributed.new_group`` requires; a rank outside ``ranks``
    gets None.  A mesh whose size is not that of its ranks raises.
    Without a process group, ``(1, 1)`` gives the one-device
    ``Dist(device)``.  Under the ``fake`` backend no rank's device is
    probed: that world moves no bytes."""
    shape = tuple(shape)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh {shape}: (data, model) or (pod, data, "
                         f"model) expected")
    size = 1
    for n in shape:
        size *= n
    dev = resolve_device(device)
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    ranks = list(ranks) if ranks is not None else list(range(world))
    if size != len(ranks):
        raise ValueError(f"mesh {shape} has {size} "
                         f"positions but the world has {len(ranks)} ranks")
    if world == 1:
        return Dist(dev) if len(shape) == 2 else Dist(
            dev, mesh_shape=shape, coords=(0, 0, 0))
    backend = tdist.get_backend()
    order = list(order) if order is not None else ranks
    if sorted(order) != sorted(ranks) or len(set(ranks)) != len(ranks):
        raise ValueError(f"device order {order} is not a permutation of "
                         f"the ranks {ranks}")
    if backend != "fake":
        keys = [None] * world
        probe = tdist.new_group(backend="gloo", timeout=_timeout())
        tdist.all_gather_object(keys, device_key(dev), group=probe)
        check_transport(backend, [keys[g] for g in ranks])
    me = tdist.get_rank()
    groups = {}
    for axis, members in _axis_lines(shape, order):
        # every rank creates every group
        g = tdist.new_group(members, timeout=_timeout())
        if me in members:
            numbered = tdist.get_process_group_ranks(g)
            groups[axis] = AxisGroup(
                g, tuple(members), tuple(numbered.index(m) for m in members))
    if me not in order:
        return None
    pos, coords = order.index(me), []
    for n in reversed(shape):
        coords.insert(0, pos % n)
        pos //= n
    return Dist(dev, mesh_shape=shape, coords=tuple(coords),
                backend=backend, groups=groups,
                stage=HostStage() if dev.type == "cuda" else None)
