"""The ``space`` axis: image rows sharded over the ranks of a data row.

Counterpart of what GSPMD inserts into the jitted program when a batch is
placed with ``batch_sharding(mesh, spatial=True)`` (dahitra_tpu/core/
mesh.py:85-89, ``P("data", "space")``): halo exchanges before the
convolutions, pools and resizes that read rows across a shard's edge,
global statistics (BatchNorm's, the tokenizer's softmax over the pixels)
and the gathers of the logits for the loss.

``grid(mesh, spatial)`` is the grid a trainer's or the evaluator's step
runs under (``core/mesh.py`` ``Mesh`` with ``n_space > 1``):

  * ``spatial=True``: each rank holds the rows [s H / S, (s + 1) H / S) of
    its samples and keeps only its own rows of every activation;
    ``rows()`` gives the space group, the rank's place in it and its size,
    which the spatial ops of ``nn/blocks.py`` and the rank-split K3 read;
  * ``spatial=False`` (replicated, the JAX epoch loops' placement): the
    ranks of a data row hold the same whole images; BatchNorm then sums its
    statistics over the data group (``stat_group``), so that each sample
    counts once in the statistics and in their gradient.

``halo(x, top, bottom, fill)`` gives the rank ``top`` rows from the rank
above and ``bottom`` rows from the rank below, with ``fill`` at the global
top and bottom edges: "zero" for a convolution's zero padding, "neg_inf"
for a max-pool's, "edge" (the edge row repeated) for a half-pixel bilinear
resize's clamp. Its backward sends each halo row's gradient back to the
rank that owns the row and adds it there. Each exchange is one all-gather
of the boundary rows over the space group (staged through host memory
under gloo on CUDA tensors, ``core.mesh.STAGED``).

Rows that do not divide raise: the rows per rank must be a multiple of the
model's total stride (``shard_rows`` checks it), so that every level of the model
splits into whole rows and every strided window starts on the rank's first
row. GSPMD reshards uneven rows; this port does not. The models with a
``space_stride`` take row-sharded batches: DAHiTra (``newUNetTrans``,
``xbd_dahitra``, ``xbd_adapt_dahitra``), ``base_resnet18``, the ResNet34
UNets and BIT (``base_transformer_pos_s4*``, ``xbd_bit``); every other
model is refused by name.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, Optional

import torch

from dahitra_tpu_torch.core.mesh import all_gather_rows, gather_parts

FILLS = ("zero", "neg_inf", "edge")

# (mesh, spatial) of the active grid, or None
_GRID = None


@dataclass(frozen=True)
class Rows:
    """The row sharding of the active grid: the space group, the rank's
    place in it and the group's size."""
    group: object
    rank: int
    size: int


@contextlib.contextmanager
def grid(mesh, spatial: bool = False) -> Iterator[None]:
    """Run the block under ``mesh``'s (data, space) grid: row-sharded with
    ``spatial``, else replicated over the space axis. A mesh of one space
    rank (or none) sets no grid."""
    global _GRID
    saved = _GRID
    _GRID = (mesh, bool(spatial)) if mesh is not None and mesh.n_space > 1 \
        else None
    try:
        yield
    finally:
        _GRID = saved


def rows() -> Optional[Rows]:
    """The active row sharding, or None where rows are not sharded."""
    if _GRID is None or not _GRID[1]:
        return None
    mesh = _GRID[0]
    return Rows(mesh.space_group, mesh.space_rank, mesh.n_space)


def stat_group():
    """The process group BatchNorm sums its statistics over: every rank
    (None), but the data group on a replicated grid."""
    if _GRID is None or _GRID[1]:
        return None
    return _GRID[0].data_group


def local_rows(t: torch.Tensor, r: Optional[Rows] = None) -> torch.Tensor:
    """The rank's rows (dim 1) of a whole (B, H, ...) tensor."""
    r = r or rows()
    if r is None:
        return t
    h = t.shape[1]
    if h % r.size:
        raise ValueError(f"{h} rows do not split over {r.size} space ranks")
    return t[:, r.rank * h // r.size:(r.rank + 1) * h // r.size]


def local_pos(pos: torch.Tensor, h: int, name: str) -> torch.Tensor:
    """The rank's rows of a whole-image (1, H, W, C) grid ``pos`` (a decoder
    positional embedding) where each rank holds ``h`` rows, as GSPMD slices
    it; ``pos`` itself without row sharding. Raises, naming ``name``, where
    H is not the ranks' rows together."""
    r = rows()
    if r is None:
        return pos
    if pos.shape[1] != h * r.size:
        raise ValueError(f"{name}: {pos.shape[1]} rows, the ranks hold "
                         f"{h * r.size}")
    return local_rows(pos, r)


def gather_rows(x: torch.Tensor, r: Optional[Rows] = None) -> torch.Tensor:
    """Every space rank's rows (dim 1) joined in rank order, differentiable
    (the backward keeps the rank's rows of the group's summed gradient);
    without row sharding, ``x``."""
    r = r or rows()
    if r is None:
        return x
    return all_gather_rows(x, r.group, dim=1)


def _fill_rows(x: torch.Tensor, n: int, fill: str, edge: torch.Tensor):
    shape = (x.shape[0], n) + tuple(x.shape[2:])
    if fill == "zero":
        return x.new_zeros(shape)
    if fill == "neg_inf":
        return x.new_full(shape, float("-inf"))
    return edge.expand(shape)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, fill, r):
        ctx.top, ctx.bottom, ctx.fill, ctx.r = top, bottom, fill, r
        h = x.shape[1]
        # the first `bottom` rows (the rank above's bottom halo), then the
        # last `top` rows (the rank below's top halo)
        parts = gather_parts(torch.cat([x[:, :bottom], x[:, h - top:]], 1),
                             r.group)
        up = parts[r.rank - 1][:, bottom:] if r.rank > 0 \
            else _fill_rows(x, top, fill, x[:, :1])
        down = parts[r.rank + 1][:, :bottom] if r.rank < r.size - 1 \
            else _fill_rows(x, bottom, fill, x[:, h - 1:])
        return torch.cat([up, x, down], 1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, r = ctx.top, ctx.bottom, ctx.r
        h = g.shape[1] - top - bottom
        g_up, g_down = g[:, :top], g[:, top + h:]
        gx = g[:, top:top + h].clone()
        parts = gather_parts(torch.cat([g_up, g_down], 1), r.group)
        if r.rank < r.size - 1:  # the rank below's top halo: my last rows
            gx[:, h - top:] += parts[r.rank + 1][:, :top]
        elif ctx.fill == "edge" and bottom:
            gx[:, h - 1:] += g_down.sum(1, keepdim=True)
        if r.rank > 0:  # the rank above's bottom halo: my first rows
            gx[:, :bottom] += parts[r.rank - 1][:, top:]
        elif ctx.fill == "edge" and top:
            gx[:, :1] += g_up.sum(1, keepdim=True)
        return gx, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, fill: str = "zero",
         r: Optional[Rows] = None) -> torch.Tensor:
    """x (B, h, ...) with ``top`` rows of the rank above and ``bottom`` of
    the rank below around it, ``fill`` at the global edges; differentiable.
    Without row sharding, or with no halo asked, ``x``."""
    r = r or rows()
    top, bottom = max(top, 0), max(bottom, 0)
    if r is None or not (top or bottom):
        return x
    if fill not in FILLS:
        raise ValueError(f"halo: fill {fill!r}, not one of {FILLS}")
    if max(top, bottom) > x.shape[1]:
        raise ValueError(f"halo: {x.shape[1]} rows per rank cannot give "
                         f"halos of {top} and {bottom} rows")
    return _Halo.apply(x.contiguous(), top, bottom, fill, r)


def shard_rows(model, *ts: torch.Tensor):
    """The rank's rows of whole (B, H, ...) tensors that ``model`` will
    read under the active grid: the tensors as they are without row
    sharding. A ``ValueError`` for a model without a ``space_stride`` (one
    that does not run on row-sharded batches) and, naming the stride, where
    the rows per rank are not a multiple of the model's total stride."""
    r = rows()
    if r is None:
        return ts
    stride = getattr(model, "space_stride", None)
    if stride is None:
        raise ValueError(f"{type(model).__name__} does not run on row-sharded "
                         f"batches (spatial=True); run it with spatial=False")
    out = tuple(local_rows(t, r) for t in ts)
    n_rows = out[0].shape[1]
    if n_rows % stride:
        raise ValueError(
            f"{type(model).__name__}: {n_rows} rows per space rank are not a "
            f"multiple of the model's total stride {stride}; row sharding "
            f"needs rows per rank divisible by {stride}")
    return out


def gather_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch of ``t``, differentiable: every space rank's rows
    (where rows are sharded), then every data rank's samples."""
    return all_gather_rows(gather_rows(t), mesh.data_group if mesh else None)
