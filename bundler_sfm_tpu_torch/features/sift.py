"""DoG-SIFT feature extraction in PyTorch — port of
`bundler_sfm_tpu/features/sift.py`.

The reference has no in-tree feature extractor — it shells out to Lowe's
`sift` binary per image (`ImageData::ExtractFeatures`, `src/ImageData.cpp:739`,
driven by `bin/ToSift.sh`).  As in the JAX package the whole detector and
descriptor run on the device: Gaussian pyramids are separable convolutions,
extrema detection is shift-compare reductions, and orientation / descriptor
are fixed-size patch computations batched over keypoints.

Algorithm follows Lowe (IJCV 2004): initial 2x upsample, sigma0 = 1.6,
3 scales/octave, contrast threshold 0.04, edge ratio 10, 36-bin orientation
histogram with 0.8-peak multi-orientation, 4x4x8 descriptor with trilinear
binning, 0.2 clamp, 512 scaling to uint8 — matching the key files the
reference's pipeline consumes (`src/keys2a.h:81-89` format).

Images are processed as a batch ([B, H, W] per shape group).  Keypoints
are compacted to the valid ones after detection, so orientation and
descriptor work runs only for keys that are kept; the histograms are
one-hot contractions (deterministic on every device, unlike atomics).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bundler_sfm_tpu_torch.utils.device import resolve_device

NUM_SCALES = 3          # s: scales per octave
SIGMA0 = 1.6
INIT_SIGMA = 0.5        # assumed blur of the input image
CONTRAST_THR = 0.04
EDGE_THR = 10.0
ORI_BINS = 36
ORI_PEAK_RATIO = 0.8
DESC_WIDTH = 4          # 4x4 spatial bins
DESC_BINS = 8
DESC_SCL_FCTR = 3.0     # bin width = 3 * sigma
DESC_MAG_THR = 0.2
PATCH = 32              # fixed gradient patch (octave pixels) per keypoint

# Keypoints per orientation/descriptor pass: bounds the per-key patch
# tensors (~200 KB per key) whatever the batch.
_KEY_CHUNK = 8192
# Images per batch: the first octave's pyramid holds ~45 f32 planes of the
# upsampled image (~180 bytes per pixel); the budget stays well inside an
# 80 GB card.
_PYRAMID_BYTES_PER_PIXEL = 180
_BATCH_BYTES = {"cuda": 24e9, "cpu": 2e9}


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with edge padding, [B, H, W] float32."""
    radius = max(1, int(np.ceil(3.0 * sigma)))
    k = torch.from_numpy(_gauss_kernel1d(sigma, radius)).to(img.device)
    x = F.pad(img[:, None], (0, 0, radius, radius), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.pad(x, (radius, radius, 0, 0), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    return x[:, 0]


def build_octave(base: torch.Tensor, num_scales: int = NUM_SCALES):
    """From octave base images [B, H, W] (already at sigma0), build the
    Gaussian stacks [B, s+3, H, W], the DoG stacks [B, s+2, H, W], and the
    gradient magnitude / orientation stacks."""
    k = 2.0 ** (1.0 / num_scales)
    imgs = [base]
    sig_prev = SIGMA0
    for i in range(1, num_scales + 3):
        sig_total = SIGMA0 * (k ** i)
        sig_extra = float(np.sqrt(max(sig_total ** 2 - sig_prev ** 2, 1e-8)))
        imgs.append(_blur(imgs[-1], sig_extra))
        sig_prev = sig_total
    gauss = torch.stack(imgs, 1)
    del imgs
    dog = gauss[:, 1:] - gauss[:, :-1]
    dx = torch.zeros_like(gauss)
    dx[..., 1:-1] = 0.5 * (gauss[..., 2:] - gauss[..., :-2])
    dy = torch.zeros_like(gauss)
    dy[..., 1:-1, :] = 0.5 * (gauss[..., 2:, :] - gauss[..., :-2, :])
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx)
    return gauss, dog, mag, ori


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _neighborhood_extrema(dog: torch.Tensor, contrast_thr) -> torch.Tensor:
    """Bool mask [B, s, H, W] of 26-neighborhood extrema for the middle
    scales (strict max or min over the 26 cyclic shifts)."""
    nb_max = None
    nb_min = None
    for ds in (-1, 0, 1):
        for dyy in (-1, 0, 1):
            for dxx in (-1, 0, 1):
                if ds == 0 and dyy == 0 and dxx == 0:
                    continue
                x = torch.roll(dog, (ds, dyy, dxx), dims=(1, 2, 3))
                nb_max = x if nb_max is None else torch.maximum(nb_max, x)
                nb_min = x if nb_min is None else torch.minimum(nb_min, x)
    thr = 0.5 * _f32(contrast_thr, dog.device) / NUM_SCALES
    ext = ((dog > nb_max) | (dog < nb_min)) & (dog.abs() > thr)
    ext = ext[:, 1:-1]                             # middle scales only
    # Kill borders (roll wraps around) and a safety margin.
    B = 5
    ext[:, :, :B, :] = False
    ext[:, :, -B:, :] = False
    ext[:, :, :, :B] = False
    ext[:, :, :, -B:] = False
    return ext


def _top_k_first(score: torch.Tensor, k: int):
    """Top-k of each row of `score` [B, N] (values >= 0) with ties to the
    lowest index, in descending order — `jax.lax.top_k`'s order.  The f32
    bit pattern of a non-negative float is monotone, so (bits, -index)
    packed into one int64 gives a unique sort key."""
    n = score.shape[1]
    bits = score.contiguous().view(torch.int32).to(torch.int64)
    idx = torch.arange(n, device=score.device, dtype=torch.int64)
    key = (bits << 32) | (n - 1 - idx)
    top = torch.topk(key, k, dim=1).values
    top_idx = n - 1 - (top & 0xFFFFFFFF)
    return torch.gather(score, 1, top_idx), top_idx


def detect_octave(base: torch.Tensor, max_keys: int,
                  contrast_thr=CONTRAST_THR, edge_thr=EDGE_THR):
    """Detect + refine keypoints in one octave of a batch [B, H, W].

    Returns (xs, ys, sigma, level, valid, response) each [B, max_keys], the
    mag / ori stacks and the next octave's base."""
    dev = base.device
    gauss, dog, mag, ori = build_octave(base)
    next_base = gauss[:, NUM_SCALES, ::2, ::2].contiguous()
    del gauss
    ext = _neighborhood_extrema(dog, contrast_thr)     # [B, s, H, W]
    Bn, s, H, W = ext.shape
    score = torch.where(ext, dog[:, 1:-1].abs(), torch.zeros((), device=dev))
    del ext
    vals, idx = _top_k_first(score.reshape(Bn, -1), max_keys)
    del score
    valid = vals > 0.0
    si = idx // (H * W)
    rem = idx % (H * W)
    yi = rem // W
    xi = rem % W

    # Sub-pixel refinement: one 3D quadratic step on the 3x3x3 DoG block
    # at (si + 1, yi - 1, xi - 1), start clamped into the stack like
    # `lax.dynamic_slice`.
    si1 = si + 1                                       # dog scale index
    s0 = torch.clamp(si1, max=dog.shape[1] - 3)
    y0 = torch.clamp(yi - 1, 0, H - 3)
    x0 = torch.clamp(xi - 1, 0, W - 3)
    o3 = torch.arange(3, device=dev)
    bidx = torch.arange(Bn, device=dev)[:, None, None, None, None]
    d = dog[bidx,
            (s0[..., None] + o3)[..., :, None, None],
            (y0[..., None] + o3)[..., None, :, None],
            (x0[..., None] + o3)[..., None, None, :]]  # [B, k, 3, 3, 3]

    def at(a, b, c):
        return d[..., a, b, c]

    g0 = 0.5 * (at(2, 1, 1) - at(0, 1, 1))
    g1 = 0.5 * (at(1, 2, 1) - at(1, 0, 1))
    g2 = 0.5 * (at(1, 1, 2) - at(1, 1, 0))
    c = at(1, 1, 1)
    dss = at(2, 1, 1) + at(0, 1, 1) - 2 * c
    dyy = at(1, 2, 1) + at(1, 0, 1) - 2 * c
    dxx = at(1, 1, 2) + at(1, 1, 0) - 2 * c
    dsy = 0.25 * (at(2, 2, 1) - at(2, 0, 1) - at(0, 2, 1) + at(0, 0, 1))
    dsx = 0.25 * (at(2, 1, 2) - at(2, 1, 0) - at(0, 1, 2) + at(0, 1, 0))
    dyx = 0.25 * (at(1, 2, 2) - at(1, 2, 0) - at(1, 0, 2) + at(1, 0, 0))
    # Closed-form symmetric 3x3 solve (adjugate / Cramer).
    a, b_, c_ = dss + 1e-12, dsy, dsx
    e_, f_ = dyy + 1e-12, dyx
    i_ = dxx + 1e-12
    A0 = e_ * i_ - f_ * f_
    A1 = c_ * f_ - b_ * i_
    A2 = b_ * f_ - c_ * e_
    det = a * A0 + b_ * A1 + c_ * A2
    det = torch.where(det.abs() < 1e-30, _f32(1e-30, dev), det)
    A4 = a * i_ - c_ * c_
    A5 = b_ * c_ - a * f_
    A8 = a * e_ - b_ * b_
    off_s = torch.clamp(-(A0 * g0 + A1 * g1 + A2 * g2) / det, -0.5, 0.5)
    off_y = torch.clamp(-(A1 * g0 + A4 * g1 + A5 * g2) / det, -0.5, 0.5)
    off_x = torch.clamp(-(A2 * g0 + A5 * g1 + A8 * g2) / det, -0.5, 0.5)
    contrast = c + 0.5 * (g0 * off_s + g1 * off_y + g2 * off_x)
    # Edge rejection on the 2x2 spatial Hessian.
    et = _f32(edge_thr, dev)
    tr = dyy + dxx
    det2 = dyy * dxx - dyx * dyx
    edge_ok = (det2 > 0) & (tr * tr / torch.clamp(det2, min=1e-12)
                            < (et + 1) ** 2 / et)
    ok = ((contrast.abs() > _f32(contrast_thr, dev) / NUM_SCALES) & edge_ok)
    valid = valid & ok
    xs = xi.float() + off_x
    ys = yi.float() + off_y
    sig = SIGMA0 * 2.0 ** ((si.float() + 1 + off_s) / NUM_SCALES)
    return xs, ys, sig, si1, valid, vals, mag, ori, next_base


def _patch_grid(device):
    r = torch.arange(PATCH, dtype=torch.float32, device=device) - PATCH // 2
    return r[:, None], r[None, :]                      # ry [P,1], rx [1,P]


def orientation_hist(m: torch.Tensor, o: torch.Tensor,
                     sigma: torch.Tensor) -> torch.Tensor:
    """36-bin orientation histograms [N, 36] from pre-sliced [N, P, P]
    patches (m, o) centered at the keypoints; window 1.5*sigma."""
    ry, rx = _patch_grid(m.device)
    sig_w = (1.5 * sigma)[:, None, None]
    r2 = rx * rx + ry * ry
    w = torch.exp(-r2 / (2.0 * sig_w * sig_w))
    w = torch.where(r2 <= ((4.5 * sigma) ** 2)[:, None, None], w,
                    torch.zeros((), device=m.device))
    binf = (o + math.pi) / (2 * math.pi) * ORI_BINS
    b0 = torch.floor(binf).to(torch.int64) % ORI_BINS
    onehot = F.one_hot(b0.reshape(len(m), -1), ORI_BINS).to(m.dtype)
    hist = torch.bmm((m * w).reshape(len(m), 1, -1), onehot)[:, 0]
    # Smooth the circular histogram twice.
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    return hist


def _dominant_orientations(hist: torch.Tensor):
    """Peak + optional second peak >= 0.8*max, with parabolic refinement.
    hist [N, 36].  Returns (ori0, ori1, has_second)."""
    hmax = hist.amax(-1, keepdim=True)
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    is_peak = (hist > left) & (hist > right) & (hist >= ORI_PEAK_RATIO * hmax)
    idx = torch.argmax(hist, -1)

    def refine_bin(i):
        l = hist.gather(1, ((i - 1) % ORI_BINS)[:, None])[:, 0]
        c = hist.gather(1, i[:, None])[:, 0]
        r = hist.gather(1, ((i + 1) % ORI_BINS)[:, None])[:, 0]
        den = l - 2 * c + r
        den = torch.where(den.abs() < 1e-12, _f32(1e-12, hist.device), den)
        off = torch.clamp(0.5 * (l - r) / den, -0.5, 0.5)
        return (i.float() + 0.5 + off) / ORI_BINS * 2 * math.pi - math.pi

    ori0 = refine_bin(idx)
    masked = torch.where(is_peak, hist, _f32(-math.inf, hist.device))
    masked.scatter_(1, idx[:, None], -math.inf)
    idx2 = torch.argmax(masked, -1)
    has2 = torch.isfinite(masked.gather(1, idx2[:, None])[:, 0])
    return ori0, refine_bin(idx2), has2


def descriptor(m, o, fx, fy, sigma, theta) -> torch.Tensor:
    """128-d SIFT descriptors [N, 128] (f32 holding integers 0..255) from
    pre-sliced [N, P, P] gradient patches; (fx, fy) are the keypoints'
    sub-pixel offsets from the patch centers.

    Trilinear binning is the separable contraction
    hist[v,u,o] = Σ_s m_s·w_s·Wv[s,v]·Wu[s,u]·Wo[s,o] (one batched
    matmul), the same weights the JAX package sums through one-hots."""
    N = len(m)
    ry, rx = _patch_grid(m.device)
    ry = ry - fy[:, None, None]
    rx = rx - fx[:, None, None]
    cos_t = torch.cos(-theta)[:, None, None]
    sin_t = torch.sin(-theta)[:, None, None]
    bin_w = (DESC_SCL_FCTR * sigma)[:, None, None]
    u = (cos_t * rx - sin_t * ry) / bin_w + DESC_WIDTH / 2 - 0.5
    v = (sin_t * rx + cos_t * ry) / bin_w + DESC_WIDTH / 2 - 0.5
    obin = (torch.remainder(o - theta[:, None, None] + 3 * math.pi,
                            2 * math.pi) / (2 * math.pi) * DESC_BINS)
    w = torch.exp(-((u - (DESC_WIDTH / 2 - 0.5)) ** 2
                    + (v - (DESC_WIDTH / 2 - 0.5)) ** 2)
                  / (0.5 * DESC_WIDTH ** 2))
    wm = (m * w).reshape(N, -1)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    ob0 = torch.floor(obin)

    def corner_weights(x0, frac, nbins, wrap):
        """[N, S, nbins] weights of each sample's two neighbouring bins."""
        lo = x0.to(torch.int64).reshape(N, -1)
        frac = frac.reshape(N, -1)
        bins = torch.arange(nbins, device=m.device)
        hi = lo + 1
        if wrap:
            lo, hi = lo % nbins, hi % nbins
        return (torch.where(bins == lo[..., None], 1 - frac[..., None], 0.0)
                + torch.where(bins == hi[..., None], frac[..., None], 0.0))

    Wu = corner_weights(u0, u - u0, DESC_WIDTH, False)
    Wv = corner_weights(v0, v - v0, DESC_WIDTH, False)
    Wo = corner_weights(ob0, obin - ob0, DESC_BINS, True)
    P = (Wv[..., :, None] * Wu[..., None, :]).reshape(N, -1, DESC_WIDTH ** 2)
    Q = Wo * wm[..., None]
    d = torch.bmm(P.transpose(1, 2), Q).reshape(N, -1)   # [(v, u), o]
    d = d / torch.clamp(torch.sqrt((d * d).sum(-1, keepdim=True)), min=1e-12)
    d = torch.clamp(d, max=DESC_MAG_THR)
    d = d / torch.clamp(torch.sqrt((d * d).sum(-1, keepdim=True)), min=1e-12)
    return torch.clamp(torch.round(d * 512.0), max=255.0)


def _gather_patches(stack, b, lvl, yi, xi):
    """[B, L, H, W] stack -> [N, P, P] patches at (b, lvl) centered (yi, xi),
    start clamped into the image like `lax.dynamic_slice`."""
    half = PATCH // 2
    H, W = stack.shape[-2:]
    off = torch.arange(PATCH, device=stack.device)
    y0 = torch.clamp(yi - half, 0, H - PATCH)
    x0 = torch.clamp(xi - half, 0, W - PATCH)
    return stack[b[:, None, None], lvl[:, None, None],
                 (y0[:, None] + off)[:, :, None],
                 (x0[:, None] + off)[:, None, :]]


def extract_octave(base: torch.Tensor, max_keys: int,
                   contrast_thr=CONTRAST_THR, edge_thr=EDGE_THR):
    """Full per-octave pipeline on a batch [B, H, W]: detect, orient,
    describe.

    Returns, per image, (info [n, 4] = x, y, sigma, theta in octave coords;
    desc [n, 128] uint8) as host arrays — the keys with their dominant
    orientation in detection order, then the keys with a secondary
    orientation, as the JAX package's valid rows — and the next octave's
    base [B, H/2, W/2]."""
    xs, ys, sig, lvl, valid, _, mag, ori, next_base = detect_octave(
        base, max_keys, contrast_thr, edge_thr)
    Bn, H, W = base.shape
    # Clamp so the PATCH window stays inside the image.
    margin = PATCH // 2 + 1
    valid = valid & (xs > margin) & (xs < W - margin) \
        & (ys > margin) & (ys < H - margin)
    bsel, ksel = torch.nonzero(valid, as_tuple=True)   # row-major: per image
    x = torch.clamp(xs[bsel, ksel], margin, W - margin)
    y = torch.clamp(ys[bsel, ksel], margin, H - margin)
    s = sig[bsel, ksel]
    lv = lvl[bsel, ksel]
    o0_l, o1_l, has2_l, d0_l, d1_l = [], [], [], [], []
    for c0 in range(0, len(x), _KEY_CHUNK):
        sl = slice(c0, c0 + _KEY_CHUNK)
        xi = torch.round(x[sl]).to(torch.int64)
        yi = torch.round(y[sl]).to(torch.int64)
        m = _gather_patches(mag, bsel[sl], lv[sl], yi, xi)
        o = _gather_patches(ori, bsel[sl], lv[sl], yi, xi)
        o0, o1, has2 = _dominant_orientations(orientation_hist(m, o, s[sl]))
        fx = x[sl] - xi
        fy = y[sl] - yi
        o0_l.append(o0)
        o1_l.append(o1)
        has2_l.append(has2)
        d0_l.append(descriptor(m, o, fx, fy, s[sl], o0))
        d1_l.append(descriptor(m[has2], o[has2], fx[has2], fy[has2],
                               s[sl][has2], o1[has2]))
    empty = torch.zeros(0, device=base.device)
    o0 = torch.cat(o0_l) if o0_l else empty
    o1 = torch.cat(o1_l) if o1_l else empty
    has2 = torch.cat(has2_l) if has2_l else empty.bool()
    desc0 = torch.cat(d0_l) if d0_l else empty.reshape(0, 128)
    desc1 = torch.cat(d1_l) if d1_l else empty.reshape(0, 128)
    info0 = torch.stack([x, y, s, o0], 1).cpu().numpy()
    info1 = torch.stack([x, y, s, o1], 1)[has2].cpu().numpy()
    desc0 = desc0.to(torch.uint8).cpu().numpy()
    desc1 = desc1.to(torch.uint8).cpu().numpy()
    img0 = bsel.cpu().numpy()
    img1 = bsel[has2].cpu().numpy()
    out = []
    for b in range(Bn):
        s0, s1 = img0 == b, img1 == b
        out.append((np.concatenate([info0[s0], info1[s1]]),
                    np.concatenate([desc0[s0], desc1[s1]])))
    return out, next_base


def _prepare_bases(stack: torch.Tensor, upsample: bool) -> torch.Tensor:
    """[B, H, W] 0-255 images -> first octave bases at sigma0."""
    img = stack.float() / 255.0
    if upsample:
        H, W = img.shape[1:]
        img = F.interpolate(img[:, None], size=(2 * H, 2 * W),
                            mode="bilinear", align_corners=False)[:, 0]
        sig_extra = float(np.sqrt(max(SIGMA0**2 - (2 * INIT_SIGMA)**2, 0.01)))
    else:
        sig_extra = float(np.sqrt(max(SIGMA0**2 - INIT_SIGMA**2, 0.01)))
    return _blur(img, sig_extra)


def _extract_group(stack: torch.Tensor, max_keys_total: int, upsample: bool,
                   contrast_thr: float, edge_thr: float):
    base = _prepare_bases(stack, upsample)
    per_info = [[] for _ in range(len(stack))]
    per_desc = [[] for _ in range(len(stack))]
    scale = 0.5 if upsample else 1.0
    octave = 0
    while min(base.shape[1:]) >= 2 * PATCH and octave < 6:
        k = max(256, max_keys_total // (2 ** octave))
        res, base = extract_octave(base, k, contrast_thr, edge_thr)
        for b, (info, desc) in enumerate(res):
            info[:, 0:3] *= scale
            per_info[b].append(info)
            per_desc[b].append(desc)
        scale *= 2.0
        octave += 1
    out = []
    for infos, descs in zip(per_info, per_desc):
        info = (np.concatenate(infos) if infos
                else np.zeros((0, 4), np.float32))
        desc = (np.concatenate(descs) if descs
                else np.zeros((0, 128), np.uint8))
        if len(info) > max_keys_total:
            # Deterministic truncation by scale, then position.
            order = np.lexsort((info[:, 1], info[:, 0], info[:, 2]))
            keep = order[:max_keys_total]
            info, desc = info[keep], desc[keep]
        out.append((info.astype(np.float32), desc))
    return out


def extract_sift_batch(images, max_keys_total: int = 4096,
                       upsample: bool = True,
                       contrast_thr: float = CONTRAST_THR,
                       edge_thr: float = EDGE_THR, device="cuda"
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """SIFT keys of many grayscale images [H, W] (uint8 or float 0-255).

    Images are grouped by shape; each group runs the octave cascade as
    batched tensor programs, in batches sized to the device's memory.
    Returns a list of (info [n,4] = x(col), y(row), scale, orientation in
    ORIGINAL image coords, desc [n,128] uint8) in input order — the
    contents of a Lowe .key file."""
    dev = resolve_device(device)
    out = [None] * len(images)
    groups = {}
    for i, im in enumerate(images):
        groups.setdefault(tuple(np.shape(im)), []).append(i)
    for (H, W), idxs in groups.items():
        pixels = H * W * (4 if upsample else 1)
        bmax = max(1, int(_BATCH_BYTES[dev.type]
                          // (_PYRAMID_BYTES_PER_PIXEL * pixels)))
        for c0 in range(0, len(idxs), bmax):
            chunk = idxs[c0:c0 + bmax]
            stack = torch.from_numpy(np.stack(
                [np.asarray(images[i], np.float32) for i in chunk])).to(dev)
            res = _extract_group(stack, max_keys_total, upsample,
                                 contrast_thr, edge_thr)
            for i, r in zip(chunk, res):
                out[i] = r
    return out


def extract_sift(image: np.ndarray, max_keys_total: int = 4096,
                 upsample: bool = True,
                 contrast_thr: float = CONTRAST_THR,
                 edge_thr: float = EDGE_THR, device="cuda"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """SIFT keys of one grayscale image; see `extract_sift_batch`."""
    return extract_sift_batch([image], max_keys_total, upsample,
                              contrast_thr, edge_thr, device)[0]


def load_grayscale(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("L"), dtype=np.float32)
