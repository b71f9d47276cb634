"""Plain PyTorch oracles: the counterpart of `repro.kernels.ref`, for the ops
the port has carried over.

They define the semantics the kernels are held to.  The stencil oracle runs
the chain on the extended domain (the input is edge-padded once by the
chain's accumulated halo and every stage is a valid-mode op), vectorised
over planes.  Border policy: BORDER_REPLICATE.

Carried over so far: ``filter2d``, ``sep_filter``, ``box``, ``erode``,
``dilate``, ``threshold``, ``affine``, single-band ``grad_mag`` and the
strided ``pyr_down`` stages in ``map`` and ``tap`` modes, on a u8 or f32
carrier.  Each band is tracked with the image coordinate of its local
origin, so a strided stage decimates on image-even rows and columns
(OpenCV pyrDown alignment) however much halo the band still carries.  On u8 every stage
widens to f32 and packs back with round-half-even and a clip to [0, 255]
(OpenCV's saturate_cast), as the JAX oracle's `_saturate` does.  The JAX
oracle's other stage ops raise `NotImplementedError` until their slice
lands.  Beside the stencil oracle: the BoW and GBDT oracles and
`attention_ref`.
"""

from __future__ import annotations

import torch

SUPPORTED_OPS = (
    "filter2d", "sep_filter", "box", "erode", "dilate", "threshold", "affine", "grad_mag", "pyr_down",
)
CARRIERS = (torch.uint8, torch.float32)


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


def pack(x: torch.Tensor, carrier: torch.dtype) -> torch.Tensor:
    """A stage's f32 result as the carrier holds it, still in f32: on u8
    rounded half to even and clipped to [0, 255] (``rintf`` and a clamp in
    the kernels); on f32 unchanged."""
    if carrier == torch.uint8:
        return torch.clamp(torch.round(x), 0.0, 255.0)
    return x


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _pad_edge(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-pad the first two axes of an (H, W) or (H, W, C) image."""
    h, w = img.shape[:2]
    rows = torch.arange(-ph, h + ph, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-pw, w + pw, device=img.device).clamp(0, w - 1)
    return img[rows][:, cols]


def _out(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return pack(acc, dtype).to(dtype)


def filter2d_ref(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """2D correlation (OpenCV filter2D), (H, W) or (H, W, C); u8 input
    accumulates in f32 and packs back once, float stays float."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32).to(img.device)
    kh, kw = kernel.shape
    x = _pad_edge(img, kh // 2, kw // 2).to(torch.float32)
    H, W = img.shape[:2]
    out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for i in range(kh):
        for j in range(kw):
            out = out + kernel[i, j] * x[i : i + H, j : j + W]
    return _out(out, img.dtype)


def sep_filter2d_ref(img: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """Separable filter: row pass kx, then column pass ky, f32 throughout
    and one packing at the end."""
    kx = torch.as_tensor(kx, dtype=torch.float32).to(img.device)
    ky = torch.as_tensor(ky, dtype=torch.float32).to(img.device)
    H, W = img.shape[:2]
    x = _pad_edge(img, 0, kx.shape[0] // 2).to(torch.float32)
    row = torch.zeros((H, W) + tuple(img.shape[2:]), dtype=torch.float32, device=img.device)
    for j in range(kx.shape[0]):
        row = row + kx[j] * x[:, j : j + W]
    row = _pad_edge(row, ky.shape[0] // 2, 0)
    out = torch.zeros_like(row[:H])
    for i in range(ky.shape[0]):
        out = out + ky[i] * row[i : i + H]
    return _out(out, img.dtype)


def _morph_ref(img: torch.Tensor, r: int, red) -> torch.Tensor:
    x = _pad_edge(img, r, r)
    H, W = img.shape[:2]
    out = x[0:H, 0:W]
    for i in range(2 * r + 1):
        for j in range(2 * r + 1):
            out = red(out, x[i : i + H, j : j + W])
    return out.to(img.dtype)


def erode_ref(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Morphological erosion with a (2*ksize+1)^2 rectangle (the paper's
    'filter size' is the half-width)."""
    return _morph_ref(img, ksize, torch.minimum)


def dilate_ref(img: torch.Tensor, ksize: int) -> torch.Tensor:
    return _morph_ref(img, ksize, torch.maximum)


def _stage_halo(s) -> tuple[int, int]:
    if s.op == "filter2d":
        kh, kw = s.weights[0].shape
        return kh // 2, kw // 2
    if s.op == "sep_filter":
        kx, ky = s.weights
        return ky.shape[0] // 2, kx.shape[0] // 2
    if s.op in ("erode", "dilate", "box"):
        return s.static[0], s.static[0]
    if s.op == "grad_mag":
        return 1, 1  # single-band central differences
    if s.op == "pyr_down":
        return 2, 2
    return 0, 0  # threshold, affine


def out_hw(op: str, h: int, w: int) -> tuple[int, int]:
    """Image size after one stage: pyrDown halves with ceil (OpenCV), every
    other ported op keeps the size."""
    if op == "pyr_down":
        return (h + 1) // 2, (w + 1) // 2
    return h, w


def _walk(stages) -> list:
    """Band-arity walk, kept apart from `stencil.ir` so this stays an
    independent oracle: per stage (mode, halo, stride, normalised tap)."""
    out, n = [], 1
    for s in stages:
        if s.op not in SUPPORTED_OPS:
            raise NotImplementedError(f"chain_ref: stage op {s.op!r} is not ported yet")
        if s.op == "grad_mag" and n >= 2:
            raise NotImplementedError("chain_ref: the grad_mag pair reduction is not ported yet")
        tap = getattr(s, "tap", None)
        stride = tuple(getattr(s, "stride", (1, 1)))
        if tap is None:
            out.append(("map", _stage_halo(s), stride, None))
            continue
        if not -n <= tap < n:
            raise ValueError(f"chain_ref: stage {s.op!r} tap={tap} out of range for {n} band(s)")
        out.append(("tap", _stage_halo(s), stride, tap % n))
        n += 1
    return out


def _valid_op(s, x: torch.Tensor, ph: int, pw: int, carrier: torch.dtype) -> torch.Tensor:
    """One stage in valid mode on (N, h + 2ph, w + 2pw) f32 planes that hold
    carrier values, packed to the carrier.  Sums run in tap order with a
    rounding after every multiply and every add, the order the kernels
    keep (row pass, then column pass, for the separable ops)."""
    h, w = x.shape[-2] - 2 * ph, x.shape[-1] - 2 * pw
    dev = x.device
    if s.op == "filter2d":
        k = s.weights[0].to(device=dev, dtype=torch.float32)
        kh, kw = k.shape
        acc = k[0, 0] * x[..., 0:h, 0:w]
        for i in range(kh):
            for j in range(kw):
                if i or j:
                    acc = acc + k[i, j] * x[..., i : i + h, j : j + w]
        return pack(acc, carrier)
    if s.op in ("sep_filter", "pyr_down"):
        # pyr_down: the 5-tap Gaussian both ways, before its decimation
        taps = s.weights if s.op == "sep_filter" else s.weights * 2
        kx, ky = (t.to(device=dev, dtype=torch.float32) for t in taps)
        row = kx[0] * x[..., :, 0:w]
        for j in range(1, kx.shape[0]):
            row = row + kx[j] * x[..., :, j : j + w]
        acc = ky[0] * row[..., 0:h, :]
        for i in range(1, ky.shape[0]):
            acc = acc + ky[i] * row[..., i : i + h, :]
        return pack(acc, carrier)
    if s.op == "box":
        k = 2 * s.static[0] + 1
        row = x[..., :, 0:w]
        for j in range(1, k):
            row = row + x[..., :, j : j + w]
        acc = row[..., 0:h, :]
        for i in range(1, k):
            acc = acc + row[..., i : i + h, :]
        return pack(acc * _f32(1.0 / (k * k), dev), carrier)
    if s.op in ("erode", "dilate"):
        red = torch.minimum if s.op == "erode" else torch.maximum
        acc = x[..., 0:h, 0:w]
        for i in range(2 * ph + 1):
            for j in range(2 * pw + 1):
                acc = red(acc, x[..., i : i + h, j : j + w])
        return acc
    if s.op == "threshold":
        t, maxval = s.static
        hi = pack(_f32(maxval, dev), carrier)
        return torch.where(x > _f32(t, dev), hi, _f32(0.0, dev))
    if s.op == "affine":
        scale, offset = s.static
        return pack(x * _f32(scale, dev) + _f32(offset, dev), carrier)
    dy = (x[..., 2 : 2 + h, 1 : 1 + w] - x[..., 0:h, 1 : 1 + w]) * 0.5
    dx = (x[..., 1 : 1 + h, 2 : 2 + w] - x[..., 1 : 1 + h, 0:w]) * 0.5
    return pack(sqrt_rn(dx * dx + dy * dy), carrier)


def pad_replicate(planes: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-pad the last two axes by (ph, pw) per side."""
    h, w = planes.shape[-2:]
    rows = torch.arange(-ph, h + ph, device=planes.device).clamp(0, h - 1)
    cols = torch.arange(-pw, w + pw, device=planes.device).clamp(0, w - 1)
    return planes[..., rows, :][..., cols]


def chain_ref_planes(planes: torch.Tensor, stages) -> tuple:
    """(N, H, W) u8 or f32 planes -> tuple of (N, h_b, w_b) output bands of
    the same dtype: (H, W) for a full-resolution band, (ceil(H/2),
    ceil(W/2)) after a pyrDown.  The bands are held in f32 between stages,
    each holding values of the carrier, with the image coordinate of their
    local origin."""
    carrier = planes.dtype
    if carrier not in CARRIERS:
        raise NotImplementedError(f"chain_ref: u8 and f32 carriers only, got {carrier}")
    walk = _walk(stages)
    # accumulated halo: each stage's halo scaled by the map strides before it
    ph_acc = pw_acc = 0
    ny = nx = 1
    for mode, (ph, pw), stride, _ in walk:
        ph_acc += ph * ny
        pw_acc += pw * nx
        if mode == "map":
            ny, nx = ny * stride[0], nx * stride[1]
    # final size of each band: the full-resolution state, or a tap's own
    h_fin, w_fin = planes.shape[-2:]
    for s, (mode, *_rest) in zip(stages, walk):
        if mode == "map":
            h_fin, w_fin = out_hw(s.op, h_fin, w_fin)
    sizes = [(h_fin, w_fin)]
    for s, (mode, *_rest) in zip(stages, walk):
        if mode == "tap":
            sizes.append(out_hw(s.op, h_fin, w_fin))

    def apply(s, ph, pw, stride, b, oy, ox):
        new = _valid_op(s, b, ph, pw, carrier)
        oy, ox = oy + ph, ox + pw
        if stride != (1, 1):
            s0, s1 = (-oy) % stride[0], (-ox) % stride[1]
            new = new[..., s0 :: stride[0], s1 :: stride[1]]
            oy, ox = (oy + s0) // stride[0], (ox + s1) // stride[1]
        return new, oy, ox

    def crop(b, oy, ox, ph, pw):
        return b[..., ph : b.shape[-2] - ph, pw : b.shape[-1] - pw], oy + ph, ox + pw

    bands = [(pad_replicate(planes, ph_acc, pw_acc).to(torch.float32), -ph_acc, -pw_acc)]
    for s, (mode, (ph, pw), stride, tap) in zip(stages, walk):
        if mode == "tap":
            new = apply(s, ph, pw, stride, *bands[tap])
            bands = [crop(*b, ph, pw) for b in bands] + [new]
        else:
            bands = [apply(s, ph, pw, stride, *b) for b in bands]
    outs = []
    for (b, oy, ox), (hk, wk) in zip(bands, sizes):
        if oy > 0 or ox > 0:
            raise AssertionError("chain_ref: halo over-consumed")
        outs.append(b[..., -oy : -oy + hk, -ox : -ox + wk].to(carrier))
    return tuple(outs)


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
    u8 or f32 in; one array out, or a tuple when the chain ends with several
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


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q/k/v (B, S, H, hd) -> (B, S, H, hd), f32 softmax; causal masks key
    index ki > query index qi (raw indices, also when S != T)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
    s = s / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    if causal:
        S, T = q.shape[1], k.shape[1]
        mask = torch.arange(T, device=q.device)[None, :] <= torch.arange(S, device=q.device)[:, None]
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)
