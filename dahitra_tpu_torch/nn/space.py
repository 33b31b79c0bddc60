"""The ``space`` axis: image rows sharded over the ranks of a data row.

Counterpart of what GSPMD inserts into the jitted program when a batch is
placed with ``batch_sharding(mesh, spatial=True)`` (dahitra_tpu/core/
mesh.py:85-89, ``P("data", "space")``): halo exchanges before the
convolutions, pools and resizes that read rows across a shard's edge,
global statistics (BatchNorm's, the tokenizer's softmax over the pixels),
the gathers of the logits for the loss, and the reshards of the levels
whose rows do not split.

``grid(mesh, spatial)`` is the grid a trainer's or the evaluator's step
runs under (``core/mesh.py`` ``Mesh`` with ``n_space > 1``):

  * ``spatial=True``: each rank holds the rows [s H / S, (s + 1) H / S) of
    its samples and keeps only its own rows of every activation at the
    levels whose rows split (below); ``rows()`` gives the space group, the
    rank's place in it and its size, which the spatial ops of
    ``nn/blocks.py`` and the rank-split K3 read;
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

Levels. A model's levels are its scales below the input (1, 2, 4, ...).
The rows of a level split over the ranks while every strided op above it
found the rank's rows a multiple of its stride and at least its halo.
Where one does not, the level is gathered over the space group
(``descend``: ``gather_rows``, whose backward sums the group's gradient
and keeps the rank's rows) and that op and every coarser one run on whole
rows, the same on every rank of the data row. Inside a whole level
``rows()`` answers None: the ops run as on one process, the tokenizer runs
the one-process K3, the decoder gates read the whole token count,
``local_pos`` gives the whole grid, and BatchNorm sums its statistics over
the data group, so that each pixel counts once. On the way up, the first
finer level than the first whole one takes the rank's rows again
(``ascend``: a slice, whose backward gives the rank's rows their gradient
and the others zero). So each rank's backward through a whole level
carries its own rows' share of every gradient there, and the reductions
over the ranks (the gathers' backward, the trainers' DDP mean) count each
once. The grid records the current level (``scale``) and the first whole
one; the trunks and the up and down ops of ``nn/blocks.py`` move it
through ``descend`` and ``ascend``, and a model that goes back to a finer
level without an upsampling says so (``at_level``). GSPMD reshards such
levels into padded shards; this port runs them whole, which needs no
other collective than the row gathers it already has.

Reductions over the pixels of the space group: ``pixel_max`` (the max
over H and W, a squeeze-excite's global max pool) and ``pixel_softmax``
(a softmax over the H * W pixels): each rank's (B, C) maxima are gathered
and their max taken, and the softmax divides by the group's sum of exp,
both differentiable. At a whole level, or without row sharding, they are
the one-process ops.

``shard_rows`` gives a model the rank's rows of its input and starts the
levels over. It refuses rows that do not split at the input (H % S; the
JAX package's ``device_put`` refuses them too) and, by name, a model
without a ``space_stride`` (its total stride, the marker of the models
that run on row-sharded batches): DAHiTra (``newUNetTrans``,
``xbd_dahitra``, ``xbd_adapt_dahitra``), ``base_resnet18``, the ResNet34
UNets, BIT (``base_transformer_pos_s4*``, ``xbd_bit``), ``siamUnet_conc``,
the UNet change transformers (``unet_coupled_trans_256``,
``unet_coupled_two_trans_256``) and ChangeFormer (``changeFormer``,
``changeFormerV6``).

A model that jumps between levels (ChangeFormerV6's decoder: 1/32, then
up to 1/4, back to 1/16, ...) calls ``at_level`` before each scale's work;
where it resizes a whole level's map onto a level whose rows split, it
asks for the whole target rows (``rows_at``), which ``ascend`` then
slices. A multi-scale output reaches a loss through ``gather_head``: the
global batch once, whether the head was computed on the rank's rows or on
a whole level (``gather_batch`` of a whole head would stack S copies).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, Optional

import torch

from dahitra_tpu_torch.core.mesh import (all_gather_rows, all_reduce_sum,
                                         gather_parts)

FILLS = ("zero", "neg_inf", "edge")


@dataclass
class _Level:
    """Where a row-sharded forward is: the current level's ``scale`` below
    the model's input and the first whole level's (None while every level
    has split)."""
    scale: float = 1.0
    whole_at: Optional[float] = None

    def whole(self) -> bool:
        return self.whole_at is not None and self.scale >= self.whole_at


# (mesh, spatial, level) of the active grid, or None
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
    _GRID = (mesh, bool(spatial), _Level()) \
        if mesh is not None and mesh.n_space > 1 else None
    try:
        yield
    finally:
        _GRID = saved


def _sharding() -> Optional[Rows]:
    """The row sharding of the active grid at any level, or None."""
    if _GRID is None or not _GRID[1]:
        return None
    mesh = _GRID[0]
    return Rows(mesh.space_group, mesh.space_rank, mesh.n_space)


def _level() -> Optional[_Level]:
    """The level state of a row-sharded grid, or None."""
    return _GRID[2] if _GRID is not None and _GRID[1] else None


def rows() -> Optional[Rows]:
    """The active row sharding, or None where rows are not sharded: no
    grid, a replicated one, or a whole level."""
    lv = _level()
    return None if lv is None or lv.whole() else _sharding()


def stat_group():
    """The process group BatchNorm sums its statistics over: every rank
    (None) where rows are sharded, else (a replicated grid, a whole level)
    the data group."""
    if _GRID is None or rows() is not None:
        return None
    return _GRID[0].data_group


def descend(x: torch.Tensor, stride: int, reach: int = 0) -> torch.Tensor:
    """x at the input of a strided op (or a block of them) that takes the
    level ``stride`` times coarser and reads ``reach`` rows across a
    shard's edge: the rank's rows while they are a multiple of ``stride``
    and at least ``reach``; else every rank's rows gathered, and the next
    level and every coarser one whole. Without row sharding, x."""
    lv = _level()
    if lv is None:
        return x
    r = rows()
    if r is not None and (x.shape[1] % stride or reach > x.shape[1]):
        x = gather_rows(x, r)
        lv.whole_at = lv.scale * stride
    lv.scale *= stride
    return x


def ascend(y: torch.Tensor, factor: float) -> torch.Tensor:
    """y, just upsampled by ``factor`` from the level above: the rank's
    rows of it where it leaves a whole level for one whose rows split,
    else y."""
    lv = _level()
    if lv is None:
        return y
    was_whole = lv.whole()
    lv.scale /= factor
    return local_rows(y, _sharding()) if was_whole and not lv.whole() else y


def at_level(scale: float) -> None:
    """Go back to the level ``scale`` below the input (a model that takes
    up a finer level again without an upsampling)."""
    lv = _level()
    if lv is not None:
        lv.scale = float(scale)


def rows_at(h: int, scale: float) -> int:
    """The rows of the map at level ``scale`` of which the rank holds
    ``h``, as an op at the current level must ask for them: the whole
    rows (h times the space ranks) where the current level is whole and
    ``scale``'s rows split, else ``h``. (A resize from a whole level to the
    rank's ``h`` rows would squeeze the whole map into them.)"""
    lv = _level()
    if lv is None or not lv.whole() or scale >= lv.whole_at:
        return h
    return h * _sharding().size


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
    it; ``pos`` itself without row sharding or at a whole level. Raises,
    naming ``name``, where H is not the ranks' rows together."""
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


def pixel_max(x: torch.Tensor) -> torch.Tensor:
    """The max of NHWC x over its rows and columns, (B, 1, 1, C): over
    every space rank's rows where rows are sharded (the ranks' maxima
    gathered, then their max), else over x's own; differentiable."""
    m = x.amax(dim=(1, 2), keepdim=True)
    r = rows()
    if r is None:
        return m
    return all_gather_rows(m, r.group, dim=1).amax(1, keepdim=True)


def pixel_softmax(x: torch.Tensor) -> torch.Tensor:
    """The softmax over dim 1 of (B, N, C) x, N the pixels (rows times
    columns) x holds: over every space rank's pixels where rows are sharded
    (the group's max, then the group's sum of exp), else
    ``torch.softmax``; differentiable."""
    r = rows()
    if r is None:
        return torch.softmax(x, dim=1)
    m = all_gather_rows(x.detach().amax(1, keepdim=True), r.group,
                        dim=1).amax(1, keepdim=True)
    e = torch.exp(x - m)
    return e / all_reduce_sum(e.sum(1, keepdim=True), r.group)


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
    read under the active grid, the levels started over at the input: the
    tensors as they are without row sharding. A ``ValueError`` for a model
    without a ``space_stride`` (one that does not run on row-sharded
    batches) and where H does not split over the ranks."""
    lv = _level()
    if lv is None:
        return ts
    if getattr(model, "space_stride", None) is None:
        raise ValueError(f"{type(model).__name__} does not run on row-sharded "
                         f"batches (spatial=True); run it with spatial=False")
    lv.scale, lv.whole_at = 1.0, None
    r = rows()
    return tuple(local_rows(t, r) for t in ts)


def gather_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch of ``t``, differentiable: every space rank's rows
    (where rows are sharded), then every data rank's samples."""
    return all_gather_rows(gather_rows(t), mesh.data_group if mesh else None)


def gather_head(t: torch.Tensor, mesh, image) -> torch.Tensor:
    """The global batch of one head (B, h, w, C) of a multi-scale output
    of whole ``image`` = (H, W) inputs, each head once, differentiable.
    Columns never split, so the head's whole rows are H w / W: a head that
    holds them (computed at a whole level, the same on every space rank)
    is gathered over the data ranks only, its gradient on each rank the
    whole one, as a whole level's backward takes it; a head that holds
    the rank's share is gathered over the space group too. Raises where
    its rows are neither."""
    h_img, w_img = image
    r = _sharding()
    if r is None:
        return gather_batch(t, mesh)
    whole, rem = divmod(h_img * t.shape[2], w_img)
    data = mesh.data_group if mesh else None
    if not rem and t.shape[1] == whole:
        return all_gather_rows(t, data)
    if rem or t.shape[1] * r.size != whole:
        raise ValueError(f"gather_head: {t.shape[1]} rows of {t.shape[2]} "
                         f"columns are neither the whole rows of a "
                         f"{h_img} x {w_img} image's head nor a share of "
                         f"them over {r.size} space ranks")
    return all_gather_rows(all_gather_rows(t, r.group, dim=1), data)
