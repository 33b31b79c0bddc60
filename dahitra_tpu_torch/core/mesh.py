"""Data and space parallelism over several devices: one process per card
under torch.distributed.

Counterpart of dahitra_tpu/core/mesh.py. The JAX package puts the batch on a
``data`` mesh axis and lets GSPMD insert the gradient all-reduce and make
BatchNorm statistics global. Here every device runs a process of its own:

  * ``devices_from_gpu_ids`` reads ``--gpu_ids`` as ``mesh_from_gpu_ids``
    (mesh.py:41-82) does: ordinals de-duplicated in order and dropped when
    out of range, each with a warning, and at least the first device kept;
  * ``launch`` runs a function once per device: one kept device runs it in
    this process with no process group (today's single-process path), two or
    more spawn one process each (``torch.multiprocessing.spawn``), which sets
    its card, joins a group (NCCL on cards, gloo on the CPU) and leaves it on
    every way out; under ``torchrun`` (``WORLD_SIZE`` and ``RANK`` set) the
    process joins the group torchrun describes and spawns nothing;
  * ``Mesh`` is what a rank knows: rank, world size, device, backend and
    its place on the (data, space) grid of ``make_mesh(n_data, n_space)``
    (mesh.py:28-38), laid out as ``create_device_mesh`` lays it out, space
    fastest: rank r is data rank r // n_space and space rank r % n_space.
    Its ``shard`` is the (data rank, n_data) pair ``BatchLoader`` takes,
    whose rank holds the contiguous samples [d B / D, (d + 1) B / D) of each
    global batch, as ``P("data")`` lays a batch out; ``shard_batch`` with
    ``spatial`` also keeps the space rank's rows [s H / S, (s + 1) H / S),
    as ``P("data", "space")`` does (mesh.py:85-108). With n_space > 1 the
    mesh holds one process group per data row (``space_group``: the ranks
    that share samples and split their rows) and one per space column
    (``data_group``: the ranks that split the samples);
  * ``all_reduce_sum`` and ``all_gather_rows`` are collectives with their
    gradients: the sum's backward is the sum of the incoming gradients, the
    gather's is that sum restricted to the rank's own rows. BatchNorm sums
    its moments with the first (``nn/blocks.py``); the trainers gather the
    logits with the second and compute the unchanged loss of the global
    batch on every rank. Each rank's loss is then the whole batch's loss,
    and the factor W of the gather's backward cancels DDP's 1 / W.

gloo has no collective on CUDA tensors but broadcast and all-reduce; these
collectives stage CUDA tensors through host memory under gloo (``STAGED``
counts such calls), which only a two-process run on one card takes.

The ``space`` axis (mesh.py:9-12) shards image rows over the ranks of a
data row: ``nn/space.py`` holds the halo exchanges and the row gathers that
GSPMD inserts there, and the trainers and the evaluator enter its grid. No
CLI of the JAX package passes ``n_space > 1``, and none here does: the
entry points are the library's (``launch(..., n_space=...)``,
``shard_batch``, the trainers' and the evaluator's steps).
"""
from __future__ import annotations

import datetime
import os
import shutil
import socket
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# Collectives staged through host memory (gloo on CUDA tensors).
STAGED = 0
# Process groups this process has joined through ``launch``.
GROUPS_STARTED = 0


@dataclass(frozen=True)
class Mesh:
    rank: int
    world_size: int
    device: torch.device
    backend: str
    n_space: int = 1
    # the grid's process groups (n_space > 1); None at n_space 1, where the
    # data group is the whole world
    space_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_space

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_space

    @property
    def space_rank(self) -> int:
        return self.rank % self.n_space

    @property
    def shard(self):
        return (self.data_rank, self.n_data)


def _block(n: int, parts: int, i: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"shard_batch: {n} {what} do not split over "
                         f"{parts} ranks")
    return slice(i * n // parts, (i + 1) * n // parts)


def shard_batch(batch: dict, mesh: Optional[Mesh], spatial: bool = False
                ) -> dict:
    """The rank's part of a global batch dict of (B, H, W[, C]) arrays or
    tensors (``shard_batch`` / ``batch_sharding``, mesh.py:85-108): its
    samples over ``data`` and, with ``spatial``, its rows over ``space``.
    Entries of fewer than 2 dimensions (a ``valid`` vector) take the
    samples only; other values pass as they are. Without a mesh, the
    batch."""
    if mesh is None:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "ndim") or v.ndim < 1:
            out[k] = v
            continue
        v = v[_block(v.shape[0], mesh.n_data, mesh.data_rank, "samples")]
        if spatial and v.ndim >= 2 and mesh.n_space > 1:
            v = v[:, _block(v.shape[1], mesh.n_space, mesh.space_rank,
                            "rows")]
        out[k] = v
    return out


def devices_from_gpu_ids(gpu_ids: str, device: str = "cuda",
                         visible: Optional[int] = None,
                         n_space: int = 1) -> List[torch.device]:
    """The devices ``--gpu_ids`` selects, one per rank: ``cuda:<id>`` for
    each kept ordinal below ``torch.cuda.device_count()``, or with
    ``device`` ``cpu`` one CPU rank per kept ordinal below
    ``os.cpu_count()``; ``visible`` overrides the count. Raises on a part
    that is not an integer; empty parts are skipped. As
    ``mesh_from_gpu_ids(gpu_ids, n_space)``, the grid's space axis takes
    ``min(n_space, kept)`` devices and the kept devices beyond a multiple
    of it are dropped with a warning; the grid of the result is then
    ``launch(..., n_space=min(n_space, len(result)))``."""
    kind = torch.device(device).type
    if visible is None:
        visible = (torch.cuda.device_count() if kind == "cuda"
                   else os.cpu_count() or 1)
    ids = []
    for t in filter(None, (t.strip() for t in str(gpu_ids).split(","))):
        try:
            ids.append(int(t))
        except ValueError:
            raise ValueError(
                f"--gpu_ids {gpu_ids!r}: {t!r} is not a device ordinal")
    seen: set = set()
    uniq = [i for i in ids if not (i in seen or seen.add(i))]
    if len(uniq) < len(ids):
        print(f"warning: --gpu_ids {gpu_ids!r} has duplicate ordinals; "
              f"using {uniq}")
    sel = [i for i in uniq if 0 <= i < visible]
    oob = [i for i in uniq if not 0 <= i < visible]
    if oob:
        print(f"warning: --gpu_ids ordinals {oob} out of range "
              f"(only {visible} device(s) visible); dropped")
    if not sel:
        sel = [0]
    n_space = min(n_space, len(sel))
    n_used = (len(sel) // n_space) * n_space
    if n_used < len(sel):
        print(f"warning: {len(sel)} selected device(s) not divisible by "
              f"n_space={n_space}; using the first {n_used}")
    return [torch.device(kind, i) if kind == "cuda" else torch.device("cpu")
            for i in sel[:n_used]]


def world_size(group=None) -> int:
    """The size of ``group`` (the whole world by default), 1 without a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``t`` over the ranks of ``group`` (every rank by
    default; no gradient)."""
    global STAGED
    if _staged(t):
        STAGED += 1
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def gather_parts(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank of ``group``'s ``t`` (equal shapes), in the group's rank
    order, on ``t``'s device (no gradient)."""
    global STAGED
    w = dist.get_world_size(group)
    src = t.contiguous()
    if _staged(src):
        STAGED += 1
        parts = [torch.empty_like(src, device="cpu") for _ in range(w)]
        dist.all_gather(parts, src.cpu(), group=group)
        return [p.to(t.device) for p in parts]
    if dist.get_backend(group) == "nccl":
        out = src.new_empty((w, *src.shape))
        dist.all_gather_into_tensor(out, src, group=group)
        return list(out.unbind(0))
    parts = [torch.empty_like(src) for _ in range(w)]
    dist.all_gather(parts, src, group=group)
    return parts


def _gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    return torch.cat(gather_parts(t, group), dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum_(g.clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.n, ctx.group, ctx.dim = x.shape[dim], group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = reduce_sum_(g.contiguous().clone(), ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (every rank by
    default), differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group=None, dim: int = 0
                    ) -> torch.Tensor:
    """Every rank of ``group``'s ``x`` (equal shapes; every rank by
    default) joined along ``dim`` (the samples by default) in rank order,
    differentiable: the backward sums the incoming gradient over the group
    and keeps the rank's part. Without a group of more than one rank,
    ``x``."""
    if world_size(group) == 1:
        return x
    if not x.requires_grad:
        return _gather(x, group, dim)
    return _AllGatherRows.apply(x, group, dim)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing without a mesh)."""
    if mesh is not None:
        dist.barrier()


def wrap_ddp(model: torch.nn.Module, mesh: Optional[Mesh],
             static_graph: bool = True, capture: bool = False):
    """``model`` in ``DistributedDataParallel`` under a mesh, else itself.

    ``broadcast_buffers=False``: the running statistics are equal on every
    rank by construction (global BatchNorm statistics), not copied from
    rank 0. ``static_graph``: every step runs the same graph, and some
    leave parameters without a gradient (Dual-HRNet's loc head, a
    multi-scale model trained on its last head); DDP finds them in the
    first step (their gradients stay None, as in one process) instead of
    searching the autograd graph for them every step
    (``find_unused_parameters``). Without it every parameter must take a
    gradient in every backward. ``capture``: a CUDA graph will capture the
    step (``--scan_epoch``), so DDP is built on the graph's side stream
    (``train/graph.py`` ``capture_stream``)."""
    if mesh is None:
        return model
    import warnings

    from torch.nn.parallel import DistributedDataParallel

    cuda = mesh.device.type == "cuda"
    kw = {"device_ids": [mesh.device.index]} if cuda else {}
    stream = None
    if capture and cuda:
        from dahitra_tpu_torch.train.graph import capture_stream

        stream = capture_stream(mesh.device)
        stream.wait_stream(torch.cuda.current_stream(mesh.device))
    with warnings.catch_warnings(), torch.cuda.stream(stream):
        warnings.simplefilter("ignore", FutureWarning)  # broadcast_buffers
        ddp = DistributedDataParallel(model, broadcast_buffers=False,
                                      static_graph=static_graph, **kw)
    if stream is not None:
        torch.cuda.current_stream(mesh.device).wait_stream(stream)
    return ddp


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _grid_groups(rank: int, world: int, n_space: int):
    """(space group, data group) of ``rank`` on the (world / n_space,
    n_space) grid, space fastest; every rank creates every group, in the
    same order, as ``new_group`` requires."""
    if n_space == 1:
        return None, None
    n_data = world // n_space
    space = [dist.new_group([d * n_space + s for s in range(n_space)])
             for d in range(n_data)]
    data = [dist.new_group([d * n_space + s for d in range(n_data)])
            for s in range(n_space)]
    return space[rank // n_space], data[rank % n_space]


def _run(fn, args, rank: int, world: int, device: torch.device,
         backend: str, init_method: str, timeout: Optional[float],
         n_space: int = 1):
    """Join the group, run ``fn(mesh, *args)``, leave the group."""
    global GROUPS_STARTED
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    GROUPS_STARTED += 1
    try:
        space, data = _grid_groups(rank, world, n_space)
        return fn(Mesh(rank, world, device, backend, n_space, space, data),
                  *args)
    finally:
        dist.destroy_process_group()


def _spawned(rank, fn, args, devices, backend, port, outdir, timeout,
             n_space):
    world = len(devices)
    if devices[rank].type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    out = _run(fn, args, rank, world, devices[rank], backend,
               f"tcp://127.0.0.1:{port}", timeout, n_space)
    torch.save(_to_cpu(out), os.path.join(outdir, f"rank{rank}.pt"))


def launch(fn: Callable, args: tuple = (),
           devices: Sequence = ("cuda:0",), backend: Optional[str] = None,
           timeout: Optional[float] = None, n_space: int = 1) -> list:
    """Run ``fn(mesh, *args)`` once per device and return each rank's
    result (tensors moved to the CPU where ranks ran in processes of their
    own).

    One device and no ``backend``: ``fn(None, *args)`` here, no group. One
    device with a ``backend``: a group of one in this process. Several
    devices: one spawned process per device (``fn`` and ``args`` must
    pickle), NCCL on cards and gloo on the CPU unless ``backend`` says
    otherwise; the kernels are built once before. A failing rank makes the
    launch raise with its traceback and ends the others. ``timeout``
    (seconds) bounds every collective and the whole spawned run. Under
    ``torchrun`` this process is the rank torchrun set, on ``cuda:<local
    rank>`` (or the CPU where ``devices`` are CPUs). ``n_space`` (which
    must divide the world size) lays the ranks out on the (world /
    n_space, n_space) grid of ``Mesh``."""
    devices = [torch.device(d) for d in devices]
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if n_space < 1 or world % n_space:
            raise ValueError(f"launch: n_space={n_space} does not divide "
                             f"the world size {world}")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) \
            if devices[0].type == "cuda" else torch.device("cpu")
        return [_run(fn, args, rank, world, dev, backend or (
            "nccl" if dev.type == "cuda" else "gloo"), "env://", timeout,
            n_space)]
    if n_space < 1 or len(devices) % n_space:
        raise ValueError(f"launch: n_space={n_space} does not divide the "
                         f"{len(devices)} devices")
    if len(devices) == 1 and backend is None:
        return [fn(None, *args)]
    backend = backend or ("nccl" if devices[0].type == "cuda" else "gloo")
    port = _free_port()
    if len(devices) == 1:
        return [_run(fn, args, 0, 1, devices[0], backend,
                     f"tcp://127.0.0.1:{port}", timeout)]
    if any(d.type == "cuda" for d in devices):
        from dahitra_tpu_torch.kernels import _build

        _build.build(_build.sources())  # once, not once per rank
    outdir = tempfile.mkdtemp(prefix="dahitra_mesh_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _spawned, args=(fn, args, devices, backend, port, outdir,
                            timeout, n_space),
            nprocs=len(devices), join=False, start_method="spawn")
        deadline = None if timeout is None else time.time() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.time() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                raise TimeoutError(
                    f"launch: {len(devices)} ranks did not finish within "
                    f"{timeout} s")
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(len(devices))]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def launch_gpu_ids(fn: Callable, args) -> list:
    """``fn(mesh, args)`` on the devices that ``args.gpu_ids`` and
    ``args.device`` select (``launch``): one device runs here, with no
    group and ``args.device`` set to it; several spawn a rank each."""
    devices = devices_from_gpu_ids(args.gpu_ids, args.device)
    if len(devices) == 1:
        args.device = str(devices[0])
    return launch(fn, (args,), devices)
