"""Distribution context of the port: the ``Dist`` every layer takes.

Port of ``repro.sharding.dist``. In JAX the whole model runs inside one
``shard_map`` region and ``Dist`` wraps the ``lax`` collectives by mesh
axis name. Here every rank is a process of ``torch.distributed``, and
``Dist`` runs each collective over the process group that a
``launch.mesh.Mesh`` built for the named axis (or tuple of axes). On an
axis of size 1 every collective is the identity, so the same layer code
runs on one device under ``NullDist``.

The transport is chosen by the caller, never by this module:
  "nccl"  one rank per card, the collectives on CUDA tensors;
  "gloo"  ranks on the CPU, or several ranks sharing one card. gloo's
          support for CUDA tensors is partial, so a CUDA tensor is copied
          into a pinned host buffer, the collective runs on the host, and
          the result is copied back (``_host``; the one place this happens);
  "fake"  the dry run (``launch.dryrun``): one process traces one rank of a
          mesh under ``FakeTensorMode`` over ``torch.distributed``'s fake
          process group, so no tensor holds data. No copy, no device check.
A ``Dist`` without a mesh answers topology questions from its axis sizes
only; a collective over an axis larger than 1 then raises.

Semantics are those of the tiled ``lax`` collectives: ``all_gather`` and
``reduce_scatter`` concatenate and split along ``dim`` in axis-index
order, ``all_to_all(split_dim, concat_dim)`` sends chunk j of
``split_dim`` to axis index j and concatenates what it receives along
``concat_dim``, and ``ppermute`` leaves zeros on a rank that receives
nothing. ``index`` of a tuple of axes is row-major over the tuple.

Gradients. Every collective of a tensor that wants a gradient is a
``torch.autograd.Function``, so that a training step differentiates
through it on each rank. The convention: the loss is one scalar that
every rank holds (the psums of ``train_loss`` replicate it), each rank's
backward is seeded with 1, and each rank's gradients are the parts of the
single-device gradient that its own inputs produce. ``launch.steps.
reduce_grads`` then sums a leaf's gradient over every mesh axis its spec
does not shard, which completes it. The rules that follow from it:
  all_gather       <-> reduce_scatter (the cotangents of every rank's copy
                       are summed into the shard's owner), and back;
  all_to_all       the inverse all_to_all (split and concat swapped);
  ppermute / roll  the inverse permutation;
  psum             the identity: the summands are partials that the
                   ranks hold apart, and what follows the sum is computed
                   alike on every rank, so every rank's replica of the
                   sum holds the whole cotangent and hands it to its own
                   summand once. (JAX under ``check_vma=False`` transposes
                   a psum to a psum, which counts the seed n times:
                   ROADMAP queue 3);
  psum_for_shards  the sum again (Megatron's pair of all-reduces): for a
                   sum that feeds work each rank does on its own shard,
                   so that each rank's cotangent of the sum is only the
                   part its shard produces, and the summands need all of
                   them. The one layer with such a sum is the
                   tensor-parallel Mamba: B, C and the step sizes' low-rank
                   input are sums over the d_inner shards (``uc @ w_bc``,
                   ``uc @ w_dt_in``) that feed the rank's own channels;
  pmax             no gradient: its input is detached, as JAX's callers
                   ``stop_gradient`` it.
Which psum a layer calls is named at the call: the rule follows from what
the sum feeds, not from a run-time setting. A parameter used after a
psum, in a region every rank computes alike, would get its whole
gradient on each rank and be counted n times by ``reduce_grads``; no
layer of the port has one (the final norm runs before the sequence
gather, on the rank's own positions).
Serving overlap. ``all_to_all_start`` begins an all-to-all and returns a
``PendingAllToAll`` whose ``wait()`` gives what ``all_to_all`` gives for
the same arguments, so that work independent of it (the other
microbatch of a DBO step) is issued while it is in flight: under nccl
the collective runs on NCCL's stream and ``wait()`` makes the current
stream wait for it (no host synchronisation); under gloo it runs on
gloo's thread on the host, and ``wait()`` copies a CUDA tensor's result
back; the fake transport completes at once. Until ``wait()`` the handle
holds the input and output the collective reads and writes. Every rank
must start and wait in one order, as for any collective. ``pending``
counts the handles this Dist made that have not been waited for.
``observer``, when set, is called as ``observer(op, x, axis, **info)``
before each collective with more than one rank (``info``: split_dim and
concat_dim of an all-to-all; backward=True for the gathers, scatters,
all-to-alls and sums a backward runs), and as ``observer("p2p", t, None)`` for each
tensor ``exchange`` sends: ``sharding.counting`` counts bytes with it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as td

AxisName = Union[str, Tuple[str, ...]]
TRANSPORTS = ("nccl", "gloo", "fake")
INT32_MAX = 2 ** 31 - 1


class Dist:
    """Collective ops bound to mesh axis names."""

    def __init__(self, axis_sizes: dict[str, int], *, mesh=None,
                 transport: Optional[str] = None):
        self._sizes = dict(axis_sizes)
        self.mesh = mesh
        self.transport = transport
        self.observer = None
        self.pending = 0
        if mesh is not None and transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r}: one of {TRANSPORTS}")

    @classmethod
    def for_mesh(cls, mesh, transport: str) -> "Dist":
        """The Dist of this process's rank on `mesh`, whose process groups
        must exist (``launch.mesh.make_mesh`` after
        ``init_process_group``). "nccl" needs a card per rank."""
        if transport == "nccl" and torch.cuda.device_count() < mesh.n_ranks:
            raise RuntimeError(
                f"nccl needs one card per rank: {mesh.n_ranks} ranks, "
                f"{torch.cuda.device_count()} cards visible (use gloo to "
                "share a card)")
        return cls(mesh.axis_sizes, mesh=mesh, transport=transport)

    # ------------- topology -------------
    def size(self, axis: Optional[AxisName]) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self._sizes.get(a, 1)
            return n
        return self._sizes.get(axis, 1)

    def index(self, axis: Optional[AxisName]) -> int:
        if self.size(axis) == 1:
            return 0
        return self._need_mesh(axis).index(axis)

    def _need_mesh(self, axis):
        if self.mesh is None:
            raise ValueError(
                f"axis {axis!r} has size {self.size(axis)}: a sharded Dist "
                "needs a Mesh with process groups (Dist.for_mesh)")
        return self.mesh

    # ------------- transport -------------
    def _host(self, x) -> bool:
        """True when `x` must go through host memory: gloo and a CUDA
        tensor. nccl refuses a tensor that is not on a card; the fake
        transport moves nothing."""
        if self.transport == "gloo":
            return x.is_cuda
        if self.transport == "fake":
            return False
        if not x.is_cuda:
            raise ValueError("nccl transport: tensors must be on a card")
        return False

    def _stage(self, x, out_shape):
        """(inp, out, host): `x` made contiguous (a pinned host copy under
        gloo: host True) and a fresh `out_shape` tensor beside it."""
        host = self._host(x)
        if host:
            inp = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            inp.copy_(x)
            out = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
        else:
            inp = x.contiguous()
            out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        return inp, out, host

    def _run(self, op, x, out_shape):
        """op(inp, out) on `x` staged by ``_stage``; returns out on x's
        device."""
        inp, out, host = self._stage(x, out_shape)
        op(inp, out)
        return out.to(x.device) if host else out

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]]):
        """Point-to-point: send each (tensor, global rank) and receive
        into each (buffer, global rank), all at once; buffers are filled
        in place."""
        for t, _ in sends:
            self._observe("p2p", t, None)
        stage = []
        ops = []
        for t, peer in sends:
            if self._host(t):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                t = h.copy_(t)
            ops.append(td.P2POp(td.isend, t.contiguous(), peer))
        for buf, peer in recvs:
            h = buf
            if self._host(buf):
                h = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            elif not buf.is_contiguous():
                raise ValueError("exchange: receive buffers must be contiguous")
            stage.append((buf, h))
            ops.append(td.P2POp(td.irecv, h, peer))
        if ops:
            for req in td.batch_isend_irecv(ops):
                req.wait()
        for buf, h in stage:
            if h is not buf:
                buf.copy_(h)

    def _observe(self, op, x, axis, **info):
        if self.observer is not None:
            self.observer(op, x, axis, **info)

    # ------------- collectives -------------
    # The raw collectives (``_psum`` ...) run on tensors without a graph;
    # the public ones wrap them in autograd Functions when x wants a
    # gradient (a collective over one rank is the identity either way).

    def _reduce(self, x, axis, op, name, backward=False):
        self._observe(name, x, axis, backward=backward)
        group = self._need_mesh(axis).group(axis)

        def run(inp, out):
            out.copy_(inp)
            td.all_reduce(out, op=op, group=group)
        return self._run(run, x, x.shape)

    def _psum(self, x, axis, backward=False):
        return self._reduce(x, axis, td.ReduceOp.SUM, "psum", backward)

    def _all_gather(self, x, axis, dim, backward=False):
        n = self.size(axis)
        self._observe("all_gather", x, axis, backward=backward)
        group = self._need_mesh(axis).group(axis)
        xt = x.movedim(dim, 0)
        out = self._run(lambda i, o: td.all_gather_into_tensor(o, i, group=group),
                        xt, (n * xt.shape[0],) + tuple(xt.shape[1:]))
        return out.movedim(0, dim).contiguous()

    def _reduce_scatter(self, x, axis, dim, backward=False):
        n = self.size(axis)
        xt = x.movedim(dim, 0)
        if xt.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not split {n} ways")
        self._observe("reduce_scatter", x, axis, backward=backward)
        group = self._need_mesh(axis).group(axis)
        out = self._run(
            lambda i, o: td.reduce_scatter_tensor(o, i, op=td.ReduceOp.SUM,
                                                  group=group),
            xt, (xt.shape[0] // n,) + tuple(xt.shape[1:]))
        return out.movedim(0, dim).contiguous()

    def _a2a_begin(self, x, axis, split_dim, concat_dim, backward=False):
        """Check and observe an all-to-all: (n, group, x with the split dim
        first)."""
        n = self.size(axis)
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                             f"does not split {n} ways")
        self._observe("all_to_all", x, axis, split_dim=split_dim,
                      concat_dim=concat_dim, backward=backward)
        return n, self._need_mesh(axis).group(axis), x.movedim(split_dim, 0)

    @staticmethod
    def _a2a_end(out, x, n, split_dim, concat_dim):
        """``all_to_all_single``'s output (the split dim first) laid out as
        the tiled all-to-all of `x`."""
        piece = list(x.shape)
        piece[split_dim] //= n
        # out[i * S/n : (i+1) * S/n] is the chunk from index i
        y = out.reshape((n, piece[split_dim]) + tuple(out.shape[1:]))
        y = y.movedim(1, split_dim + 1)                       # [n, *piece]
        y = y.movedim(0, concat_dim)                          # n before concat dim
        shape = list(piece)
        shape[concat_dim] *= n
        return y.reshape(shape)

    def _all_to_all(self, x, axis, split_dim, concat_dim, backward=False):
        n, group, xs = self._a2a_begin(x, axis, split_dim, concat_dim, backward)
        out = self._run(lambda i, o: td.all_to_all_single(o, i, group=group),
                        xs, xs.shape)
        return self._a2a_end(out, x, n, split_dim, concat_dim)

    def _ppermute(self, x, axis, perm):
        mesh = self._need_mesh(axis)
        me, ranks = mesh.index(axis), mesh.group_ranks(axis)
        out = torch.zeros_like(x).contiguous()
        self.exchange([(x, ranks[d]) for s, d in perm if s == me],
                      [(out, ranks[s]) for s, d in perm if d == me])
        return out

    @staticmethod
    def _grad(x) -> bool:
        return torch.is_grad_enabled() and x.requires_grad

    def psum(self, x, axis: Optional[AxisName]):
        if self.size(axis) == 1:
            return x
        if self._grad(x):
            return _Psum.apply(x, self, axis)
        return self._psum(x, axis)

    def psum_for_shards(self, x, axis: Optional[AxisName]):
        """The sum over `axis` of partials whose sum feeds work each rank
        does on its own shard: its backward is the sum over `axis` too
        (see the module docstring)."""
        if self.size(axis) == 1:
            return x
        if self._grad(x):
            return _PsumForShards.apply(x, self, axis)
        return self._psum(x, axis)

    def pmax(self, x, axis: Optional[AxisName]):
        """No gradient: the input is detached."""
        if self.size(axis) == 1:
            return x
        return self._reduce(x.detach(), axis, td.ReduceOp.MAX, "pmax")

    def all_gather(self, x, axis: Optional[AxisName], dim: int = 0):
        """Tiled all-gather along tensor dim `dim` over mesh axis `axis`."""
        if self.size(axis) == 1:
            return x
        if self._grad(x):
            return _AllGather.apply(x, self, axis, dim)
        return self._all_gather(x, axis, dim)

    def reduce_scatter(self, x, axis: Optional[AxisName], dim: int = 0):
        """Tiled psum_scatter along tensor dim `dim` over mesh axis `axis`."""
        if self.size(axis) == 1:
            return x
        if self._grad(x):
            return _ReduceScatter.apply(x, self, axis, dim)
        return self._reduce_scatter(x, axis, dim)

    def all_to_all(self, x, axis: Optional[AxisName], split_dim: int,
                   concat_dim: int):
        """``lax.all_to_all(..., tiled=True)``: chunk j of `split_dim` goes
        to axis index j; the chunks received from indices 0..n-1 are
        concatenated along `concat_dim`."""
        if self.size(axis) == 1:
            return x
        if self._grad(x):
            return _AllToAll.apply(x, self, axis, split_dim, concat_dim)
        return self._all_to_all(x, axis, split_dim, concat_dim)

    def all_to_all_start(self, x, axis: Optional[AxisName], split_dim: int,
                         concat_dim: int) -> "PendingAllToAll":
        """``all_to_all`` begun (see the module docstring): its handle's
        ``wait()`` returns what ``all_to_all`` returns for the same
        arguments, bit for bit. Observed once, here. For serving only: a
        tensor that wants a gradient is refused (``all_to_all`` is the
        differentiable path)."""
        if self._grad(x):
            raise ValueError("all_to_all_start: the input wants a gradient; "
                             "all_to_all is the differentiable path")
        if self.size(axis) == 1:
            return PendingAllToAll(lambda: x, self)
        if self.transport == "fake":
            y = self._all_to_all(x, axis, split_dim, concat_dim)
            return PendingAllToAll(lambda: y, self)
        n, group, xs = self._a2a_begin(x, axis, split_dim, concat_dim)
        inp, out, host = self._stage(xs, xs.shape)
        work = td.all_to_all_single(out, inp, group=group, async_op=True)

        def finish():
            work.wait()
            got = out.to(x.device) if host else out
            return self._a2a_end(got, x, n, split_dim, concat_dim)
        return PendingAllToAll(finish, self, keep=(inp, out))

    def ppermute(self, x, axis: Optional[AxisName],
                 perm: Sequence[Tuple[int, int]]):
        """Send to axis index dst from axis index src for each (src, dst);
        a rank that receives nothing gets zeros."""
        if self.size(axis) == 1:
            return x
        perm = [tuple(p) for p in perm]
        if self._grad(x):
            return _Ppermute.apply(x, self, axis, perm)
        return self._ppermute(x, axis, perm)

    def roll(self, x, axis: Optional[AxisName], shift: int = 1):
        """Ring shift: rank r -> rank (r + shift) % n."""
        n = self.size(axis)
        if n == 1:
            return x
        return self.ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])


class PendingAllToAll:
    """A started all-to-all (``Dist.all_to_all_start``): ``wait()`` returns
    its result, once. `keep` holds the tensors the collective still reads
    and writes until then; a handle made with `dist` counts in its
    ``pending``."""

    def __init__(self, finish, dist: Optional[Dist] = None, keep=()):
        self._finish, self._dist, self._keep = finish, dist, keep
        if dist is not None:
            dist.pending += 1

    @classmethod
    def done(cls, y) -> "PendingAllToAll":
        """A handle whose result is already there."""
        return cls(lambda: y)

    def wait(self):
        if self._finish is None:
            raise RuntimeError("PendingAllToAll.wait() called twice")
        finish, self._finish = self._finish, None
        y = finish()
        self._keep = ()
        if self._dist is not None:
            self._dist.pending -= 1
        return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis):
        return dist._psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumForShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis):
        ctx.args = (dist, axis)
        return dist._psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        dist, axis = ctx.args
        return dist._psum(g, axis, backward=True), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis, dim):
        ctx.args = (dist, axis, dim)
        return dist._all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        dist, axis, dim = ctx.args
        return dist._reduce_scatter(g, axis, dim, backward=True), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis, dim):
        ctx.args = (dist, axis, dim)
        return dist._reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        dist, axis, dim = ctx.args
        return dist._all_gather(g, axis, dim, backward=True), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis, split_dim, concat_dim):
        ctx.args = (dist, axis, split_dim, concat_dim)
        return dist._all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        dist, axis, split_dim, concat_dim = ctx.args
        return (dist._all_to_all(g, axis, concat_dim, split_dim, backward=True),
                None, None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axis, perm):
        ctx.args = (dist, axis, perm)
        return dist._ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        dist, axis, perm = ctx.args
        return dist._ppermute(g, axis, [(d, s) for s, d in perm]), None, None, None


class NullDist(Dist):
    """Single-device stand-in: every collective is the identity."""

    def __init__(self):
        super().__init__({})

    def size(self, axis):
        return 1


def argmax_across(dist: Dist, values, indices, axis: Optional[AxisName]):
    """Global argmax over a sharded dimension: values/indices are the local
    winners; returns the global winning index (ties -> lowest index)."""
    if dist.size(axis) == 1:
        return indices
    vmax = dist.pmax(values, axis)
    cand = torch.where(values >= vmax, indices, INT32_MAX)
    return -dist.pmax(-cand, axis)
