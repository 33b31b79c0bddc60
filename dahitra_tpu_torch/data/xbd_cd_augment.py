"""The opt-in CDDataAugmentation_xBD stage and the elastic jitter, on the
device.

Counterpart of dahitra_tpu/data/xbd_cd_augment.py (the reference's
datasets/data_utils.py:115-248, a class with no call site there, kept as an
opt-in stage, and xBD_code/train_unettransformer.py:93,247-253, the
UNet-transformer recipe's ``--elastic``). Every op takes a batch, images
(B, H, W, C) as floats (0..255 for the photometric ops; the elastic jitter
is scale-free), and reads its random numbers from ``draw_*`` functions on an
explicit ``torch.Generator``; the ops on given draws (``apply`` arguments)
are the JAX functions' arithmetic, op for op, so the tests feed both the
same numbers. The JAX package draws from keys: the numbers differ, their
distributions are the same.

  * blends ``saturation``, ``brightness``, ``contrast`` (the uint8 cast as a
    floor), ``box_blur3`` (cv2.blur 3x3, REFLECT_101), ``gauss_noise``
    (utils.py:17-24, on a given normal field), ``clahe`` (clip 2, 5x5
    tiles, on a luminance proxy; chroma scaled by its gain);
  * ``scale_random_crop``: pair-consistent rescale by u ~ U[1, 1.2] and a
    crop back to size (bilinear images, nearest labels);
  * ``elastic_transform``: displacement fields U(-1, 1), smoothed as scipy's
    ``gaussian_filter(mode="constant")`` (``_gaussian_smooth_const0``),
    scaled by alpha ~ U(0.25, 1.2), bilinear sampling with scipy's
    ``map_coordinates(order=1, mode="constant")`` border
    (``_bilinear_sample_cval0``); ``elastic_gated`` applies it where a
    per-image draw exceeds 0.983;
  * ``photometric_tree`` (data_utils.py:204-226) and
    ``augment_pairs_xbd_cd``, the batched stage.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from dahitra_tpu_torch.data.xbd_augment import bilinear_sample, nearest_sample

Draws = Dict[str, torch.Tensor]
# cv2's RGB -> LAB luminance weights.
_LUMA = (0.212671, 0.715160, 0.072169)
# utils.py:39-41: BGR-ordered weights on RGB images, as the reference has them.
_GRAY = (0.114, 0.587, 0.299)


def _u(generator, device, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _per(v: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    """A (B,) value broadcast over (B, ...) of ``ndim`` dims."""
    return v.reshape(-1, *([1] * (ndim - 1)))


def _weighted(img: torch.Tensor, w) -> torch.Tensor:
    """sum_c img[..., c] * w[c], keeping the channel axis."""
    w = torch.tensor(w, dtype=img.dtype, device=img.device)
    return (img * w).sum(-1, keepdim=True)


# ------------------------------------------------------------ blends

def _blend(img1, img2, alpha):
    return torch.floor(torch.clamp(img1 * alpha + (1.0 - alpha) * img2,
                                   0.0, 255.0))


def saturation(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return _blend(img, _weighted(img, _GRAY), _per(alpha))


def brightness(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), _per(alpha))


def contrast(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    gs = _weighted(img, _GRAY).mean((1, 2, 3), keepdim=True).expand_as(img)
    return _blend(img, gs, _per(alpha))


def box_blur3(img: torch.Tensor) -> torch.Tensor:
    """cv2.blur((3, 3)) with its REFLECT_101 border: the 9-sum over 9."""
    h, w = img.shape[1:3]
    x = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    x = x.permute(0, 2, 3, 1)
    total = sum(x[:, i:i + h, j:j + w] for i in range(3) for j in range(3))
    return total / 9.0


def gauss_noise(img: torch.Tensor, normal: torch.Tensor,
                var: float = 30.0) -> torch.Tensor:
    """``var + sqrt(var) * normal`` ((B, H, W, 3) standard normals), shifted
    to be non-negative per image, truncated to integers, added, clipped."""
    g = var + var ** 0.5 * normal
    g = torch.floor(g - g.amin((1, 2, 3), keepdim=True))
    return torch.clamp(img + g, 0.0, 255.0)


def clahe(img: torch.Tensor, clip_limit: float = 2.0,
          tiles: int = 5) -> torch.Tensor:
    """Clip-limited adaptive histogram equalisation of a luminance proxy:
    per-tile 256-bin histograms (exact counts), clipped at
    ``clip_limit * area / 256`` with the excess spread evenly, each pixel's
    mapping the bilinear blend of its 4 neighbouring tiles' CDFs; RGB scaled
    by the luminance gain."""
    b, h, w = img.shape[:3]
    dev = img.device
    lum = torch.clamp(_weighted(img, _LUMA)[..., 0], 0.0, 255.0)
    lv = lum.long().clamp(0, 255)
    ti = torch.clamp(torch.arange(h, device=dev) * tiles // h, max=tiles - 1)
    tj = torch.clamp(torch.arange(w, device=dev) * tiles // w, max=tiles - 1)
    tile_of = ti[:, None] * tiles + tj[None, :]
    n_tiles = tiles * tiles
    idx = (tile_of[None] * 256 + lv).reshape(b, -1)
    hist = torch.zeros(b, n_tiles * 256, device=dev).scatter_add_(
        1, idx, torch.ones(idx.shape, device=dev)).view(b, n_tiles, 256)
    area = hist.sum(-1, keepdim=True)
    clip = torch.clamp(clip_limit * area / 256.0, min=1.0)
    excess = torch.clamp(hist - clip, min=0.0).sum(-1, keepdim=True)
    hist = torch.minimum(hist, clip) + excess / 256.0
    lut = torch.clamp(hist.cumsum(-1) / torch.clamp(area, min=1.0) * 255.0,
                      0.0, 255.0)
    fy = (torch.arange(h, device=dev) + 0.5) / (h / tiles) - 0.5
    fx = (torch.arange(w, device=dev) + 0.5) / (w / tiles) - 0.5
    y0 = torch.floor(fy).long().clamp(0, tiles - 1)
    x0 = torch.floor(fx).long().clamp(0, tiles - 1)
    y1 = (y0 + 1).clamp(0, tiles - 1)
    x1 = (x0 + 1).clamp(0, tiles - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(fx - x0, 0.0, 1.0)[None, :]
    flat = lut.reshape(b, -1)

    def look(yi, xi):
        t = yi[:, None] * tiles + xi[None, :]
        idx = (t[None] * 256 + lv).reshape(b, -1)
        return flat.gather(1, idx).view(b, h, w)

    new_l = ((1 - wy) * (1 - wx) * look(y0, x0)
             + (1 - wy) * wx * look(y0, x1)
             + wy * (1 - wx) * look(y1, x0)
             + wy * wx * look(y1, x1))
    gain = new_l / torch.clamp(lum, min=1.0)
    return torch.clamp(img * gain[..., None], 0.0, 255.0)


# ------------------------------------------------------------ geometry

def draw_scale_crop(n: int, generator: torch.Generator, device) -> Draws:
    """Per sample the scale u ~ U[1, 1.2] and the crop's fractional offsets
    (U[0, 1) of the room the rescale leaves)."""
    return {"scale": 1.0 + 0.2 * _u(generator, device, n),
            "top": _u(generator, device, n), "left": _u(generator, device, n)}


def scale_random_crop(imgs: Tuple[torch.Tensor, ...], label: torch.Tensor,
                      draws: Draws):
    """Rescale by ``scale`` and crop back to size at (top, left) times the
    room, the same for every image of ``imgs`` ((B, H, W, C) each) and the
    (B, H, W) ``label``; output pixel (i, j) samples the source at
    ((top + i) / scale, (left + j) / scale)."""
    b, h, w = label.shape
    scale = draws["scale"].float()
    top = draws["top"] * (torch.floor(h * scale) - h)
    left = draws["left"] * (torch.floor(w * scale) - w)
    i = torch.arange(h, dtype=torch.float32, device=label.device)
    j = torch.arange(w, dtype=torch.float32, device=label.device)
    rows = ((_per(top, 3) + i.view(1, h, 1)) / _per(scale, 3)).expand(b, h, w)
    cols = ((_per(left, 3) + j.view(1, 1, w)) / _per(scale, 3)).expand(b, h, w)
    out = tuple(bilinear_sample(img, rows, cols) for img in imgs)
    return out, nearest_sample(label[..., None], rows, cols)[..., 0]


# ------------------------------------------------------------ elastic

def _gaussian_smooth_const0(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter(mode="constant", cval=0) over the last
    two axes: the separable correlation with scipy's kernel, radius
    int(4 sigma + 0.5), zero padding."""
    radius = int(4.0 * sigma + 0.5)
    if radius < 1:
        return field
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=field.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()

    def smooth_last(a):
        n = a.shape[-1]
        ap = F.pad(a, (radius, radius))
        return sum(k[i] * ap[..., i:i + n] for i in range(2 * radius + 1))

    return smooth_last(smooth_last(field.transpose(-1, -2)).transpose(-1, -2))


def _bilinear_sample_cval0(img: torch.Tensor, rows: torch.Tensor,
                           cols: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling where any coordinate outside [0, n - 1] on either
    axis gives 0 outright (scipy does not blend with the constant)."""
    h, w = img.shape[1:3]
    inside = ((rows >= 0) & (rows <= h - 1) & (cols >= 0)
              & (cols <= w - 1))[..., None]
    return torch.where(inside, bilinear_sample(img, rows, cols),
                       torch.zeros((), dtype=img.dtype, device=img.device))


def draw_elastic(n: int, h: int, w: int, generator: torch.Generator, device,
                 alpha_range=(0.25, 1.2)) -> Draws:
    """Per image alpha ~ U(alpha_range) and the two fields' U[0, 1) draws
    (``ux`` moves columns, ``uy`` rows)."""
    lo, hi = alpha_range
    return {"alpha": lo + (hi - lo) * _u(generator, device, n),
            "ux": _u(generator, device, n, h, w),
            "uy": _u(generator, device, n, h, w)}


def elastic_transform(img: torch.Tensor, draws: Draws,
                      sigma: float = 0.2) -> torch.Tensor:
    """iaa.ElasticTransformation(alpha, sigma=0.2) on (B, H, W, C) images:
    the output at (y, x) samples the input at (y + dy, x + dx), the fields
    2u - 1 smoothed and scaled by alpha. Images only (the reference never
    moves the masks)."""
    b, h, w = img.shape[:3]
    alpha = _per(draws["alpha"], 3)
    dx = _gaussian_smooth_const0(draws["ux"] * 2.0 - 1.0, sigma) * alpha
    dy = _gaussian_smooth_const0(draws["uy"] * 2.0 - 1.0, sigma) * alpha
    ii = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    jj = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    return _bilinear_sample_cval0(img, ii + dy, jj + dx)


def draw_elastic_gated(n: int, h: int, w: int, generator: torch.Generator,
                       device) -> Draws:
    """The gate's draw per image (U[0, 1)) beside the jitter's draws."""
    return {"gate": _u(generator, device, n),
            **draw_elastic(n, h, w, generator, device)}


def elastic_gated(img: torch.Tensor, draws: Draws,
                  threshold: float = 0.983) -> torch.Tensor:
    """``elastic_transform`` on the images whose gate draw exceeds
    ``threshold`` (p about 0.017 each, train_unettransformer.py:247-253),
    the others unchanged."""
    return torch.where(_per(draws["gate"] > threshold),
                       elastic_transform(img, draws), img)


# ------------------------------------------------------------ photometric

def draw_photometric(n: int, h: int, w: int, generator: torch.Generator,
                     device) -> Draws:
    """Per image the tree's eight gate draws ``r`` (B, 8), the blend factor
    alpha ~ U[0.9, 1.1] and the noise's (B, H, W, 3) standard normals."""
    return {"r": _u(generator, device, n, 8),
            "alpha": 0.9 + 0.2 * _u(generator, device, n),
            "normal": torch.randn((n, h, w, 3), generator=generator,
                                  device=device)}


def photometric_tree(img: torch.Tensor, draws: Draws) -> torch.Tensor:
    """With p 0.02 one of {CLAHE | noise | box blur}, else with p 0.02 one
    of {saturation | brightness | contrast}, each inner pick gated at p
    0.015 in order (data_utils.py:204-226)."""
    r, alpha = draws["r"], draws["alpha"]
    g = [r[:, i] > (0.98 if i in (0, 4) else 0.985) for i in range(8)]
    branch1 = g[0]
    branch2 = ~branch1 & g[4]
    picks = [branch1 & g[1], branch1 & ~g[1] & g[2],
             branch1 & ~g[1] & ~g[2] & g[3],
             branch2 & g[5], branch2 & ~g[5] & g[6],
             branch2 & ~g[5] & ~g[6] & g[7]]
    ops = (clahe, lambda t: gauss_noise(t, draws["normal"]), box_blur3,
           lambda t: saturation(t, alpha), lambda t: brightness(t, alpha),
           lambda t: contrast(t, alpha))
    out = img
    for pick, op in zip(picks, ops):
        if pick.any():
            out = torch.where(_per(pick), op(img), out)
    return out


def augment_pairs_xbd_cd(a_u8: torch.Tensor, b_u8: torch.Tensor,
                         label_u8: torch.Tensor, generator: torch.Generator,
                         with_scale_crop: bool = True,
                         with_photometric: bool = True):
    """(B, H, W, 3) uint8 pair and (B, H, W) labels -> augmented float
    images on the 0..255 scale and int64 labels, on the inputs' device;
    compose before the normalisation."""
    a, b = a_u8.float(), b_u8.float()
    label = label_u8.float()
    n, h, w = label.shape
    dev = a.device
    if with_scale_crop:
        (a, b), label = scale_random_crop(
            (a, b), label, draw_scale_crop(n, generator, dev))
    if with_photometric:
        a = photometric_tree(a, draw_photometric(n, h, w, generator, dev))
        b = photometric_tree(b, draw_photometric(n, h, w, generator, dev))
    return a, b, label.long()
