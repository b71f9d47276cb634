"""Plain PyTorch oracles: the counterpart of `repro.kernels.ref`, for the ops
on the BoW predict and training paths.

They define the semantics the kernels are held to.  The stencil oracle runs
the chain on the extended domain (the input is edge-padded once by the
chain's accumulated halo and every stage is a valid-mode op), vectorised
over planes.  Border policy: BORDER_REPLICATE.

Carried over so far: ``sep_filter``, ``erode`` and single-band ``grad_mag``
stages in ``map`` and ``tap`` modes on an f32 carrier.  The JAX oracle's
other stage ops raise `NotImplementedError` until their slice lands.
"""

from __future__ import annotations

import torch

SUPPORTED_OPS = ("sep_filter", "erode", "grad_mag")


def gaussian_kernel1d(ksize: int, sigma: float | None = None) -> torch.Tensor:
    """OpenCV getGaussianKernel: sigma default 0.3*((ksize-1)*0.5 - 1) + 0.8.
    Returned on the CPU in f32; stages carry it to the data's device."""
    if sigma is None or sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float32) - (ksize - 1) / 2
    k = torch.exp(-(x * x) / (2 * sigma * sigma))
    return k / torch.sum(k)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device (the CUDA kernels'
    ``__fsqrt_rn``).  PyTorch's vectorised CPU sqrt can be one ulp off; the
    square root of an f32 taken in f64 and rounded once to f32 cannot."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _stage_halo(s) -> tuple[int, int]:
    if s.op == "sep_filter":
        kx, ky = s.weights
        return ky.shape[0] // 2, kx.shape[0] // 2
    if s.op == "erode":
        return s.static[0], s.static[0]
    return 1, 1  # grad_mag, single-band central differences


def _walk(stages) -> list:
    """Band-arity walk, kept apart from `stencil.ir` so this stays an
    independent oracle: per stage (mode, halo, normalised tap)."""
    out, n = [], 1
    for s in stages:
        if s.op not in SUPPORTED_OPS:
            raise NotImplementedError(f"chain_ref: stage op {s.op!r} is not ported yet")
        if s.op == "grad_mag" and n >= 2:
            raise NotImplementedError("chain_ref: the grad_mag pair reduction is not ported yet")
        tap = getattr(s, "tap", None)
        if tap is None:
            out.append(("map", _stage_halo(s), None))
            continue
        if not -n <= tap < n:
            raise ValueError(f"chain_ref: stage {s.op!r} tap={tap} out of range for {n} band(s)")
        out.append(("tap", _stage_halo(s), tap % n))
        n += 1
    return out


def _valid_op(s, x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """One stage in valid mode on (N, h + 2ph, w + 2pw) f32 planes.  Sums run
    in tap order with a rounding after every multiply and every add, the
    order the `stencil_chain` kernel keeps."""
    h, w = x.shape[-2] - 2 * ph, x.shape[-1] - 2 * pw
    if s.op == "sep_filter":
        kx, ky = (t.to(device=x.device, dtype=torch.float32) for t in s.weights)
        row = kx[0] * x[..., :, 0:w]
        for j in range(1, kx.shape[0]):
            row = row + kx[j] * x[..., :, j : j + w]
        acc = ky[0] * row[..., 0:h, :]
        for i in range(1, ky.shape[0]):
            acc = acc + ky[i] * row[..., i : i + h, :]
        return acc
    if s.op == "erode":
        acc = x[..., 0:h, 0:w]
        for i in range(2 * ph + 1):
            for j in range(2 * pw + 1):
                acc = torch.minimum(acc, x[..., i : i + h, j : j + w])
        return acc
    dy = (x[..., 2 : 2 + h, 1 : 1 + w] - x[..., 0:h, 1 : 1 + w]) * 0.5
    dx = (x[..., 1 : 1 + h, 2 : 2 + w] - x[..., 1 : 1 + h, 0:w]) * 0.5
    return sqrt_rn(dx * dx + dy * dy)


def pad_replicate(planes: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-pad the last two axes by (ph, pw) per side."""
    h, w = planes.shape[-2:]
    rows = torch.arange(-ph, h + ph, device=planes.device).clamp(0, h - 1)
    cols = torch.arange(-pw, w + pw, device=planes.device).clamp(0, w - 1)
    return planes[..., rows, :][..., cols]


def chain_ref_planes(planes: torch.Tensor, stages) -> tuple:
    """(N, H, W) f32 planes -> tuple of (N, H, W) output bands."""
    if planes.dtype != torch.float32:
        raise NotImplementedError(f"chain_ref: f32 carrier only, got {planes.dtype}")
    walk = _walk(stages)
    ph_acc = sum(halo[0] for _, halo, _ in walk)
    pw_acc = sum(halo[1] for _, halo, _ in walk)
    bands = [pad_replicate(planes, ph_acc, pw_acc)]
    for s, (mode, (ph, pw), tap) in zip(stages, walk):
        if mode == "tap":
            new = _valid_op(s, bands[tap], ph, pw)
            bands = [b[..., ph : b.shape[-2] - ph, pw : b.shape[-1] - pw] for b in bands]
            bands.append(new)
        else:
            bands = [_valid_op(s, b, ph, pw) for b in bands]
    return tuple(bands)


def to_planes(img: torch.Tensor) -> torch.Tensor:
    """(H, W), (H, W, C) or (B, H, W, C) -> contiguous (N, H, W) planes."""
    if img.ndim == 2:
        return img[None].contiguous()
    if img.ndim == 3:
        return img.permute(2, 0, 1).contiguous()
    if img.ndim == 4:
        B, H, W, C = img.shape
        return img.permute(0, 3, 1, 2).reshape(B * C, H, W).contiguous()
    raise ValueError(f"unsupported rank {img.ndim}")


def from_planes(band: torch.Tensor, like_shape) -> torch.Tensor:
    """Inverse of `to_planes` for one (N, H, W) output band."""
    if len(like_shape) == 2:
        return band[0]
    if len(like_shape) == 3:
        return band.permute(1, 2, 0)
    B, C = like_shape[0], like_shape[-1]
    return band.reshape(B, C, *band.shape[1:]).permute(0, 2, 3, 1)


def chain_ref(img: torch.Tensor, stages):
    """Oracle for `stencil.fused_chain`: (H, W), (H, W, C) or (B, H, W, C)
    f32 in; one array out, or a tuple when the chain ends with several
    live bands (taps)."""
    stages = tuple(stages)
    outs = tuple(from_planes(b, img.shape) for b in chain_ref_planes(to_planes(img), stages))
    return outs[0] if len(outs) == 1 else outs


def bow_assign_ref(desc: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment: desc (N, D), centroids (K, D) f32 ->
    (assignments (N,) int32, min squared distance (N,) f32)."""
    d2 = (
        torch.sum(desc * desc, dim=1, keepdim=True)
        - 2.0 * desc @ centroids.T
        + torch.sum(centroids * centroids, dim=1)[None, :]
    )
    idx = torch.argmin(d2, dim=1)
    return idx.to(torch.int32), torch.gather(d2, 1, idx[:, None])[:, 0]


def bow_histogram_ref(assign: torch.Tensor, K: int, *, normalize: bool = True) -> torch.Tensor:
    """Word counts of one image's assignments (N,) -> (K,), divided by their
    sum (at least 1) when `normalize`."""
    h = torch.zeros((K,), dtype=torch.float32, device=assign.device)
    h.index_add_(0, assign.long(), torch.ones(assign.shape, dtype=torch.float32, device=h.device))
    if normalize:
        h = h / torch.clamp(torch.sum(h), min=1.0)
    return h


def svm_decision_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Linear multi-class decision values: x (N, D), w (C, D), b (C,)."""
    return x @ w.T + b[None, :]


def bow_hist_ref(descs, valids, centroids, *, normalize: bool = True) -> torch.Tensor:
    """Staged quantize->histogram oracle: descs (B, N, D), valids (B, N) ->
    (B, K) word histograms.  s = -2 d.c + |c|^2 with |d|^2 dropped, argmin
    ties to the lowest index, histogram counts as sums of valid weights."""
    B, N, D = descs.shape
    d = descs.to(torch.float32).reshape(B * N, D)
    c = centroids.to(torch.float32)
    s = -2.0 * d @ c.T + torch.sum(c * c, dim=1)[None, :]
    idx = torch.argmin(s, dim=1).reshape(B, N)
    h = torch.zeros((B, c.shape[0]), dtype=torch.float32, device=descs.device)
    h.scatter_add_(1, idx, valids.to(torch.float32))
    if normalize:
        h = h / torch.clamp(torch.sum(h, dim=1, keepdim=True), min=1e-6)
    return h


def gbdt_leaf_ref(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Oblivious-tree leaf indices: x (B, F), feat/thr (T, depth) -> (B, T)
    int32.  Level l contributes bit 2^l when x[feat] > thr (strict: x == thr
    goes left)."""
    xv = x.to(torch.float32)[:, feat.long()]  # (B, T, depth)
    bits = (xv > thr.to(torch.float32)[None]).to(torch.int32)
    pw = 2 ** torch.arange(feat.shape[1], dtype=torch.int32, device=x.device)
    return torch.sum(bits * pw[None, None, :], dim=-1).to(torch.int32)


def gbdt_scores_ref(x, feat, thr, leaf, base) -> torch.Tensor:
    """GBDT ensemble scores: leaf (T, 2^depth, C), base (C,) ->
    (B, C) = base + sum_t leaf[t, leaf_index_t]."""
    lidx = gbdt_leaf_ref(x, feat, thr)  # (B, T)
    T = leaf.shape[0]
    picked = leaf.to(torch.float32)[torch.arange(T, device=x.device)[None, :], lidx.long()]
    return base.to(torch.float32)[None, :] + torch.sum(picked, dim=1)
