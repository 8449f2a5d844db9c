"""The (data, model) device mesh, its collectives and the tensor-parallel
rules, on ``torch.distributed``.

Counterpart of ``playaid_core_tpu/parallel/mesh.py``.  A :class:`Mesh` is a
``[data, model]`` grid of positions:

* **distributed** (``torch.distributed`` initialised when it is made): one
  rank per position, rank ``i * model + j`` at position ``(i, j)``.  The
  rank holds the process groups of its row (``model``: the ranks that share
  its batch rows and split the wide layers) and of its column (``data``:
  the ranks that hold the same shards and split the batch).  The backend
  is the caller's: NCCL for one rank per card, gloo for the CPU and for
  ranks that share a card;
* **single-process** (not initialised): a grid of devices in this process,
  which may name one device more than once (``["cpu"] * 4``,
  ``["cuda:0"] * 2``).  ``VodAnalyzer(mesh=)`` keeps a replica of its embed
  on each device of the ``data`` axis.

Where XLA inserts the collectives of a sharded program, the port calls
them itself: :meth:`Mesh.all_reduce_` and :meth:`Mesh.all_gather` over an
axis (the identity on an axis of size 1), Megatron's column and row
parallelism through :func:`to_model` (identity forward, sum of the
gradients backward), :func:`reduce_model` (sum forward, identity backward)
and :func:`gather_model` (all-gather forward, the rank's slice backward),
and batch norm over the ``data`` axis (:func:`data_batch_norm`).  gloo
takes CUDA tensors as they are (all_reduce, all_gather, broadcast and
all_gather_object, two ranks on one H100:
``tools/torch_port_gloo_cuda_probe.py``).  Every collective adds its
payload to ``Mesh.bytes`` (``"all_reduce/data"``, ...) and one to
``Mesh.calls``.

The rules (:data:`DEFAULT_TP_RULES`) are the JAX package's, on the port's
parameter names and torch's ``[out, in]`` layouts: the transformer's
feed-forward (``linear1`` by rows, ``linear2`` by columns), its attention
by whole heads (the rows of each of the q, k and v blocks of the packed
``in_proj``, the matching columns of ``out_proj``), the CNN head's
``temporal_dense``, every ``classifier`` by rows, and the RNN's LSTM by
this rank's rows of each of its i, f, g, o gate blocks (JAX's hidden
columns of each gate's kernel; ``models/rnn_action_detector.StackedLSTM``
then steps the recurrence by hand).  A rule whose dimension does not divide falls back to
replication (the 63-way classifier stays whole).
"""

from __future__ import annotations

import collections
import datetime
import re
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from playaid_core_torch.device import resolve_device

AXES = ("data", "model")
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


class Mesh:
    """A ``[data, model]`` grid of positions (see the module docstring).

    ``devices`` is the grid of devices (``np.ndarray`` of ``torch.device``);
    ``rank`` is this process's rank when the mesh is distributed, else None;
    ``groups`` maps each axis to this rank's process group over it.
    """

    axis_names = AXES

    def __init__(self, devices, rank=None, groups=None, device=None):
        self.devices = devices
        self.rank = rank
        self.groups = groups or {}
        # This rank's device (distributed) or the first device of the grid.
        self.device = device if device is not None else devices.flat[0]
        self.bytes = collections.Counter()
        self.calls = collections.Counter()

    def __repr__(self):
        where = f"rank {self.rank} of {self.size}" if self.distributed else "one process"
        return f"Mesh(shape={self.shape}, {where}, device={self.device})"

    @property
    def shape(self):
        return tuple(self.devices.shape)

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def distributed(self):
        return self.rank is not None

    def axis_size(self, axis):
        return self.shape[AXES.index(axis)]

    def index(self, axis):
        """This rank's index along ``axis`` (0 in a single-process mesh)."""
        if not self.distributed:
            return 0
        return divmod(self.rank, self.shape[1])[AXES.index(axis)]

    def _group(self, axis):
        """This rank's group over ``axis``, or None when the axis has one
        position (every collective over it is then the identity)."""
        if self.axis_size(axis) == 1:
            return None
        if not self.distributed:
            raise ValueError(f"a collective over {axis!r} needs one rank per position; this "
                             f"mesh {self.shape} lives in one process")
        return self.groups[axis]

    def all_reduce_(self, tensor, axis):
        """Sum the contiguous ``tensor`` over ``axis`` in place; return it."""
        group = self._group(axis)
        if group is None:
            return tensor
        self.bytes[f"all_reduce/{axis}"] += tensor.numel() * tensor.element_size()
        self.calls[f"all_reduce/{axis}"] += 1
        dist.all_reduce(tensor, group=group)
        return tensor

    def all_gather_list(self, tensor, axis):
        """Every position's ``tensor`` along ``axis``, in index order (a
        list; ``[tensor]`` on an axis of size 1)."""
        group = self._group(axis)
        if group is None:
            return [tensor]
        tensor = tensor.contiguous()
        n = self.axis_size(axis)
        self.bytes[f"all_gather/{axis}"] += n * tensor.numel() * tensor.element_size()
        self.calls[f"all_gather/{axis}"] += 1
        parts = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(parts, tensor, group=group)
        return parts

    def all_gather(self, tensor, axis, dim=-1):
        """``tensor`` of every position along ``axis``, concatenated on ``dim``."""
        parts = self.all_gather_list(tensor, axis)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    def mean_over(self, axis, *scalars):
        """The mean of each 0-d tensor over ``axis`` (one collective)."""
        n = self.axis_size(axis)
        if n == 1:
            return scalars
        stacked = self.all_reduce_(torch.stack([s.detach() for s in scalars]), axis) / n
        return tuple(stacked.unbind())

    def average_gradients(self, grads):
        """Average the gradients over ``data`` in place, in one flat
        all-reduce (each shard's gradient stays with its rank's shard)."""
        n = self.axis_size("data")
        if n == 1 or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_(flat, "data").div_(n)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def barrier(self):
        if self.distributed:
            dist.barrier()


def make_mesh(devices: Optional[Sequence] = None, data_parallel: Optional[int] = None,
              model_parallel: int = 1, device=None) -> Mesh:
    """Build a ``(data, model)`` mesh; everything data-parallel by default.

    ``devices`` given: a single-process mesh over them (even inside a
    process group).  Otherwise, with ``torch.distributed`` initialised, the
    positions are the world's ranks (every rank must call this, in the same
    order: it creates the process groups of both axes) and ``device`` is
    this rank's device (None: the CUDA device); without a process group,
    the mesh is ``[device]``.
    """
    if devices is None and dist.is_available() and dist.is_initialized():
        return _distributed_mesh(data_parallel, model_parallel, resolve_device(device))
    devices = [resolve_device(d) for d in (devices if devices is not None else [device])]
    data_parallel = _data_parallel(len(devices), data_parallel, model_parallel)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(data_parallel, model_parallel))


def _data_parallel(n, data_parallel, model_parallel):
    if data_parallel is None:
        if model_parallel < 1 or n % model_parallel:
            raise ValueError(f"{n} positions do not split into model_parallel={model_parallel}")
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"data_parallel {data_parallel} x model_parallel {model_parallel} != "
                         f"{n} positions")
    return data_parallel


def _distributed_mesh(data_parallel, model_parallel, device):
    world, rank = dist.get_world_size(), dist.get_rank()
    data_parallel = _data_parallel(world, data_parallel, model_parallel)
    ranks = np.arange(world).reshape(data_parallel, model_parallel)
    groups = {}
    # Every rank creates every group, in one order (new_group's contract).
    for axis, lines in (("model", ranks), ("data", ranks.T)):
        for line in lines:
            group = dist.new_group([int(r) for r in line], timeout=GROUP_TIMEOUT)
            if rank in line:
                groups[axis] = group
    names = [None] * world
    dist.all_gather_object(names, str(device))
    grid = np.empty(world, dtype=object)
    grid[:] = [torch.device(n) for n in names]
    return Mesh(grid.reshape(data_parallel, model_parallel), rank, groups, device)


def batch_sharding(mesh: Mesh):
    """A function that gives this rank's rows of a batch (arrays or tensors
    with the batch first), which must divide over ``data``."""
    n, i = mesh.axis_size("data"), mesh.index("data")

    def rows(x):
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {n} data positions")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    return rows


def replicated(mesh: Mesh):
    """A function that gives every row of a batch (the batch replicated)."""
    return lambda x: x


# ---- tensor-parallel rules ----


class Spec(NamedTuple):
    """How a tensor lies on the mesh: ``axes`` names the mesh axis that
    splits each leading dimension (None: whole; ``()``: replicated).  A
    dimension of ``blocks`` equal blocks (the packed q, k and v of
    ``in_proj``, the LSTM's four gates) splits each block."""

    axes: tuple = ()
    blocks: int = 1

    @property
    def sharded(self):
        return "model" in self.axes

    @property
    def dim(self):
        return self.axes.index("model")


REPLICATED = Spec()

# (name regex, Spec): first match wins; default replicated.  torch layouts:
# a Linear's weight is [out, in], so JAX's column split (kernel [in, out],
# P(None, "model")) splits rows here, and its row split splits columns.
DEFAULT_TP_RULES = (
    (r".*linear1\.weight$", Spec(("model", None))),
    (r".*linear1\.bias$", Spec(("model",))),
    (r".*linear2\.weight$", Spec((None, "model"))),
    # Whole heads per rank: the same rows of each of the q, k, v blocks.
    (r".*self_attn\.in_proj_weight$", Spec(("model", None), blocks=3)),
    (r".*self_attn\.in_proj_bias$", Spec(("model",), blocks=3)),
    (r".*self_attn\.out_proj\.weight$", Spec((None, "model"))),
    (r".*temporal_dense\.weight$", Spec(("model", None))),
    (r".*temporal_dense\.bias$", Spec(("model",))),
    # This rank's rows of each of the i, f, g, o blocks; the biases stay whole.
    (r".*lstm\.weight_(ih|hh)_l\d+$", Spec(("model", None), blocks=4)),
    (r".*classifier\.weight$", Spec(("model", None))),
    (r".*classifier\.bias$", Spec(("model",))),
)


def param_specs(params, mesh: Optional[Mesh] = None, rules=DEFAULT_TP_RULES):
    """``{name: Spec}`` for a mapping of names to tensors (a state dict or
    ``named_parameters()``).  With ``mesh``, a rule whose split dimension
    does not divide into ``blocks`` x the axis's size falls back to
    replication, as the JAX ``param_specs`` does."""
    size = mesh.axis_size("model") if mesh is not None else 1
    specs = {}
    for name, tensor in dict(params).items():
        spec = REPLICATED
        for pattern, candidate in rules:
            if re.match(pattern, name):
                if candidate.sharded:
                    ok = (len(candidate.axes) <= tensor.dim()
                          and tensor.shape[candidate.dim] % (candidate.blocks * size) == 0)
                    spec = candidate if ok else REPLICATED
                else:
                    spec = candidate
                break
        specs[name] = spec
    return specs


def shard_slice(tensor, spec: Spec, index, size):
    """Position ``index`` of ``size``'s slice of the whole ``tensor``."""
    if not spec.sharded or size == 1:
        return tensor
    blocks = tensor.chunk(spec.blocks, spec.dim)
    parts = [b.chunk(size, spec.dim)[index] for b in blocks]
    return parts[0] if len(parts) == 1 else torch.cat(parts, spec.dim)


def unshard(parts, spec: Spec):
    """The whole tensor from every position's slice, in index order."""
    if not spec.sharded or len(parts) == 1:
        return parts[0]
    split = [p.chunk(spec.blocks, spec.dim) for p in parts]
    return torch.cat([s[b] for b in range(spec.blocks) for s in split], spec.dim)


def shard_params(mesh: Mesh, params, rules=DEFAULT_TP_RULES):
    """``{name: this rank's slice}`` of a mapping of whole tensors."""
    specs = param_specs(params, mesh, rules)
    index, size = mesh.index("model"), mesh.axis_size("model")
    return {name: shard_slice(t, specs[name], index, size) for name, t in dict(params).items()}


def gather_params(mesh: Mesh, local, specs):
    """``{name: whole tensor}`` from this rank's slices (a collective over
    ``model``: every rank of the row calls it with the same names)."""
    return {name: unshard(mesh.all_gather_list(t, "model"), specs[name])
            if specs[name].sharded else t for name, t in local.items()}


def attach_mesh(model, mesh: Mesh, split_batch=True, rules=DEFAULT_TP_RULES):
    """Place ``model`` (whole weights, on this rank's device) on ``mesh``:
    each parameter that the rules shard is replaced by this rank's slice
    (same name), every module with a ``mesh`` attribute gets the mesh, and
    every module with ``batch_rows`` gets this rank's ``(index, count)`` of
    the batch's rows (``(0, 1)`` when the batch is replicated).  Returns
    the parameters' specs."""
    specs = param_specs(dict(model.named_parameters()), mesh, rules)
    index, size = mesh.index("model"), mesh.axis_size("model")
    for name, spec in specs.items():
        if spec.sharded and size > 1:
            parent, _, leaf = name.rpartition(".")
            module = model.get_submodule(parent)
            old = getattr(module, leaf)
            new = shard_slice(old.detach(), spec, index, size).clone()
            setattr(module, leaf, torch.nn.Parameter(new, requires_grad=old.requires_grad))
    rows = (mesh.index("data"), mesh.axis_size("data")) if split_batch else (0, 1)
    for module in model.modules():
        if hasattr(module, "mesh"):
            module.mesh = mesh
        if hasattr(module, "batch_rows"):
            module.batch_rows = rows
    return specs


# ---- collectives inside the model ----


def _model_split(mesh):
    return mesh is not None and mesh.axis_size("model") > 1


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                                    "model"), None


class _ReduceModel(torch.autograd.Function):
    """Sum over ``model`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format), "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherModel(torch.autograd.Function):
    """All-gather on the last dimension over ``model`` forward; this rank's
    columns of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.width, ctx.index = x.shape[-1], mesh.index("model")
        return mesh.all_gather(x, "model", -1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.index * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


def to_model(x, mesh):
    """Feed the replicated ``x`` to a column-parallel layer."""
    return _ToModel.apply(x, mesh) if _model_split(mesh) else x


def reduce_model(x, mesh):
    """Sum a row-parallel layer's partial outputs."""
    return _ReduceModel.apply(x, mesh) if _model_split(mesh) else x


def gather_model(x, mesh):
    """The whole width of a column-parallel output (last dimension)."""
    return _GatherModel.apply(x, mesh) if _model_split(mesh) else x


def is_column_split(layer):
    """True when the ``nn.Linear`` holds rows of its weight (this rank's
    output columns)."""
    return layer.weight.shape[0] < layer.out_features


def parallel_linear(layer, x, mesh, gather=False):
    """``layer(x)`` for an ``nn.Linear`` that holds its whole weight, rows of
    it (column-parallel: the output is this rank's columns, or with
    ``gather`` all of them) or columns of it (row-parallel: ``x`` is this
    rank's columns, the output whole)."""
    if is_column_split(layer):
        y = F.linear(to_model(x, mesh), layer.weight, layer.bias)
        return gather_model(y, mesh) if gather else y
    if layer.weight.shape[1] < layer.in_features:
        y = reduce_model(F.linear(x, layer.weight), mesh)
        return y if layer.bias is None else y + layer.bias
    return layer(x)


class _DataBatchNorm(torch.autograd.Function):
    """Training-mode batch norm whose statistics span the whole batch over
    ``data``: the sum, then the sum of squared deviations (two passes), are
    summed over the axis; backward sums the two per-channel sums the input
    gradient needs.  The scale and bias gradients stay this rank's (the
    trainer averages every gradient over ``data``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mesh, eps):
        dims = [0] + list(range(2, x.dim()))
        view = [1, -1] + [1] * (x.dim() - 2)
        count = x.new_full((1,), x.numel() // x.shape[1])
        stats = mesh.all_reduce_(torch.cat([x.sum(dims), count]), "data")
        n = stats[-1]
        mean = stats[:-1] / n
        centred = x - mean.view(view)
        var = mesh.all_reduce_(centred.square().sum(dims), "data") / n
        invstd = torch.rsqrt(var + eps)
        xhat = centred * invstd.view(view)
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.mesh, ctx.dims, ctx.view = mesh, dims, view
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight.view(view) + bias.view(view), mean, var

    @staticmethod
    def backward(ctx, grad, _grad_mean, _grad_var):
        xhat, weight, invstd, n = ctx.saved_tensors
        c = xhat.shape[1]
        local = torch.cat([grad.sum(ctx.dims), (grad * xhat).sum(ctx.dims)])
        sums = ctx.mesh.all_reduce_(local.clone(), "data")
        view = ctx.view
        grad_x = (grad - (sums[:c] / n).view(view) - xhat * (sums[c:] / n).view(view)) * (
            invstd * weight).view(view)
        return grad_x, local[c:], local[:c], None, None


def data_batch_norm(x, weight, bias, mesh, eps):
    """``(y, batch mean, biased batch variance)`` over the whole batch on
    ``mesh``'s ``data`` axis (x ``[N, C, ...]``)."""
    return _DataBatchNorm.apply(x, weight, bias, mesh, eps)
