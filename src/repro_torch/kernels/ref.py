"""Plain PyTorch oracles: the counterpart of `repro.kernels.ref`, for the ops
the port has carried over.

They define the semantics the kernels are held to.  The stencil oracle runs
the chain on the extended domain (the input is edge-padded once by the
chain's accumulated halo and every stage is a valid-mode op), vectorised
over planes.  Border policy: BORDER_REPLICATE.

Carried over so far: ``filter2d``, ``sep_filter``, ``box``, ``erode``,
``dilate``, ``threshold``, ``affine``, ``grad_mag`` (single-band central
differences, and the pair reduction after a Sobel), ``sobel`` (emits a
widened f32 (dx, dy) pair), the strided ``pyr_down`` and ``resize2``, and
the bilinear gathers ``warp_affine`` and ``remap``, and the 2x upsample
``pyr_up``, in ``map``, ``tap``, ``emit`` and ``reduce`` modes, on a u8 or
f32 carrier; a strided or upsampling map stage may sit anywhere in a chain.
Each band is tracked with the image coordinate of its local origin at its
own resolution, so a strided stage decimates on image-even rows and columns
(OpenCV pyrDown alignment), a pyrUp interleaves its phases at the doubled
origin, and a gather samples at absolute image coordinates however much
halo the band still carries; each band keeps its own dtype (a Sobel pair is
f32 on a u8 chain).  On u8 every stage widens to f32 and packs back to its
band's dtype with round-half-even and a clip to [0, 255] (OpenCV's
saturate_cast), as the JAX oracle's `_saturate` does.  `pyramid_ref` chains
the oracle across the links of a multi-octave pyramid.  Beside the stencil
oracle: the BoW and GBDT oracles and `attention_ref`.
"""

from __future__ import annotations

import math

import torch

SUPPORTED_OPS = (
    "filter2d", "sep_filter", "box", "erode", "dilate", "threshold", "affine", "grad_mag", "pyr_down",
    "resize2", "sobel", "warp_affine", "remap", "pyr_up",
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


def _gather_halo(by: float, bx: float) -> tuple[int, int]:
    """Halo of a gather for a (row, col) displacement bound: floor(b) rows
    of reach + 1 for the far bilinear tap."""
    return int(math.floor(by)) + 1, int(math.floor(bx)) + 1


def _stage_halo(s) -> tuple[int, int]:
    if s.op == "filter2d":
        kh, kw = s.weights[0].shape
        return kh // 2, kw // 2
    if s.op == "sep_filter":
        kx, ky = s.weights
        return ky.shape[0] // 2, kx.shape[0] // 2
    if s.op in ("erode", "dilate", "box"):
        return s.static[0], s.static[0]
    if s.op in ("grad_mag", "sobel", "pyr_up"):
        return 1, 1  # central differences; the Sobel 3x3; pyrUp's 3-tap phases
    if s.op == "pyr_down":
        return 2, 2
    if s.op == "warp_affine":
        return _gather_halo(s.static[6], s.static[7])
    if s.op == "remap":
        by, bx, ey, ex = s.static
        return _gather_halo(by + ey, bx + ex)
    return 0, 0  # threshold, affine, resize2


def out_hw(op: str, h: int, w: int) -> tuple[int, int]:
    """Image size after one stage: pyrDown halves with ceil (OpenCV),
    resize2 with floor, pyrUp doubles, every other op keeps the size."""
    if op == "pyr_down":
        return (h + 1) // 2, (w + 1) // 2
    if op == "resize2":
        return h // 2, w // 2
    if op == "pyr_up":
        return 2 * h, 2 * w
    return h, w


def _walk(stages) -> list:
    """Band-arity walk, kept apart from `stencil.ir` so this stays an
    independent oracle: per stage (mode, halo, stride, normalised tap).
    A Sobel emits (replaces the last band with its pair); grad_mag over two
    or more live bands reduces the last two to their magnitude; an
    upsampling stage is map-only."""
    out, n = [], 1
    for s in stages:
        if s.op not in SUPPORTED_OPS:
            raise ValueError(f"chain_ref: unknown stage op {s.op!r}")
        tap = getattr(s, "tap", None)
        stride = tuple(getattr(s, "stride", (1, 1)))
        if s.op == "pyr_up" and tap is not None:
            raise ValueError("chain_ref: upsampling stage 'pyr_up' does not support tap=")
        if s.op == "sobel":
            out.append(("emit", (1, 1), stride, None))
            n += 1
        elif s.op == "grad_mag" and n >= 2:
            out.append(("reduce", (0, 0), stride, None))
            n -= 1
        elif tap is None:
            out.append(("map", _stage_halo(s), stride, None))
        else:
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


def pyr_up_valid(x: torch.Tensor) -> torch.Tensor:
    """Valid-mode pyrUp of (N, h, w) f32 planes -> (N, 2(h - 2), 2(w - 2)):
    per axis the even phase ((a + 6 b) + c) * 0.125 and the odd phase (b +
    c) * 0.5 of the three rows (columns) a, b, c around each source row,
    interleaved, rows first, then columns; every product and sum rounded on
    its own (the kernels' ``__fmul_rn`` / ``__fadd_rn``).  Not packed: the
    caller packs once.  Output local row 2i (2i + 1) is the even (odd)
    phase around input local row i + 1, so the output origin is 2*(origin
    + 1)."""
    h, w = x.shape[-2] - 2, x.shape[-1] - 2
    a, b, c = x[..., :-2, :], x[..., 1:-1, :], x[..., 2:, :]
    ev = ((a + 6.0 * b) + c) * 0.125
    od = (b + c) * 0.5
    t = torch.stack([ev, od], dim=-2).reshape(*x.shape[:-2], 2 * h, w + 2)
    left, mid, right = t[..., :-2], t[..., 1:-1], t[..., 2:]
    evc = ((left + 6.0 * mid) + right) * 0.125
    odc = (mid + right) * 0.5
    return torch.stack([evc, odc], dim=-1).reshape(*x.shape[:-2], 2 * h, 2 * w)


def sobel_pair(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Valid-mode Sobel ksize=3 pair of (N, h + 2, w + 2) f32 planes: dx =
    [1,2,1]^T (x) [-1,0,1] and dy its transpose, as the column difference
    and the column sum (x[j-1] + x[j+1]) + 2 x[j] of each row, then
    (cd[i-1] + 2 cd[i]) + cd[i+1] and cs[i+1] - cs[i-1].  Widened f32:
    never packed to the carrier."""
    h = x.shape[-2] - 2
    cd = x[..., :, 2:] - x[..., :, :-2]
    cs = (x[..., :, :-2] + x[..., :, 2:]) + 2.0 * x[..., :, 1:-1]
    dx = (cd[..., 0:h, :] + 2.0 * cd[..., 1 : 1 + h, :]) + cd[..., 2 : 2 + h, :]
    dy = cs[..., 2 : 2 + h, :] - cs[..., 0:h, :]
    return dx, dy


def resize2_valid(x: torch.Tensor, oy: int, ox: int) -> tuple:
    """2x2 mean of (N, r, c) f32 planes whose local origin sits at image (oy,
    ox): pairs start on image-even rows and columns, (x00 + x10) + (x01 +
    x11), then * 0.25.  -> (means, origin of the decimated band)."""
    s0, s1 = (-oy) % 2, (-ox) % 2
    m, mw = (x.shape[-2] - s0) // 2, (x.shape[-1] - s1) // 2
    rs = x[..., s0 : s0 + 2 * m : 2, :] + x[..., s0 + 1 : s0 + 1 + 2 * m : 2, :]
    cs = rs[..., s1 : s1 + 2 * mw : 2] + rs[..., s1 + 1 : s1 + 1 + 2 * mw : 2]
    return cs * 0.25, (oy + s0) // 2, (ox + s1) // 2


def affine_coords(m, yy: torch.Tensor, xx: torch.Tensor) -> tuple:
    """Source coordinates of an inverse-map affine at integer image
    coordinates: M rounded to f32, then ``x*m00 + y*m01 + m02`` as two
    rounded products and two rounded sums, in that order (the kernels'
    ``__fmul_rn`` / ``__fadd_rn``).  -> (sy, sx)."""
    dev = xx.device
    m00, m01, m02, m10, m11, m12 = (_f32(v, dev) for v in m[:6])
    yf, xf = yy.to(torch.float32), xx.to(torch.float32)
    sx = (xf * m00 + yf * m01) + m02
    sy = (xf * m10 + yf * m11) + m12
    return sy, sx


def bilinear(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor, oy: int, ox: int):
    """Bilinear sample of (N, r, c) f32 planes (local origin at image (oy,
    ox)) at image coordinates (sy, sx) of shape (h, w): floor and frac of
    the *global* coordinate, taps clamped into the band, ``top = v00 + (v01
    - v00)*fx``, ``bot`` likewise, ``top + (bot - top)*fy``."""
    iy, ix = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - iy, sx - ix
    ly = torch.clamp(iy.to(torch.int64) - oy, 0, x.shape[-2] - 2)
    lx = torch.clamp(ix.to(torch.int64) - ox, 0, x.shape[-1] - 2)
    flat = x.reshape(*x.shape[:-2], -1)
    c = x.shape[-1]

    def take(dy, dx):
        idx = ((ly + dy) * c + (lx + dx)).reshape(-1)
        return flat[..., idx].reshape(*x.shape[:-2], *sy.shape)

    v00, v01, v10, v11 = take(0, 0), take(0, 1), take(1, 0), take(1, 1)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def _gather(s, b: torch.Tensor, oy: int, ox: int, hy: int, hx: int) -> torch.Tensor:
    """One gather stage on (N, r, c) planes: evaluate the dst -> src map at
    the output's absolute image coordinates and sample bilinearly; remap's
    out-of-image lookups clamp to the map edge."""
    h, w = b.shape[-2] - 2 * hy, b.shape[-1] - 2 * hx
    dev = b.device
    yy = (oy + hy + torch.arange(h, device=dev))[:, None]
    xx = (ox + hx + torch.arange(w, device=dev))[None, :]
    if s.op == "warp_affine":
        sy, sx = affine_coords(s.static, yy.expand(h, w), xx.expand(h, w))
    else:
        map_x, map_y = (m.to(device=dev, dtype=torch.float32) for m in s.weights)
        hm, wm = map_y.shape
        yc, xc = yy.clamp(0, hm - 1), xx.clamp(0, wm - 1)
        sy, sx = map_y[yc, xc], map_x[yc, xc]
    return bilinear(b, sy, sx, oy, ox)


def pad_replicate(planes: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-pad the last two axes by (ph, pw) per side."""
    h, w = planes.shape[-2:]
    rows = torch.arange(-ph, h + ph, device=planes.device).clamp(0, h - 1)
    cols = torch.arange(-pw, w + pw, device=planes.device).clamp(0, w - 1)
    return planes[..., rows, :][..., cols]


def chain_ref_planes(planes: torch.Tensor, stages) -> tuple:
    """(N, H, W) u8 or f32 planes -> tuple of (N, h_b, w_b) output bands:
    (H, W) for a full-resolution band, (ceil(H/2), ceil(W/2)) after a
    pyrDown, (H//2, W//2) after a resize2; each of its own dtype (the
    carrier, or f32 for a Sobel pair).  The bands are held in f32 between
    stages, each holding values of its dtype, with the image coordinate of
    its local origin."""
    carrier = planes.dtype
    if carrier not in CARRIERS:
        raise NotImplementedError(f"chain_ref: u8 and f32 carriers only, got {carrier}")
    walk = _walk(stages)
    # accumulated halo: each stage's halo scaled by the net resolution
    # factor before it (map strides times, upsamples divide, rounded up)
    ph_acc = pw_acc = 0
    ny = nx = uy = ux = 1
    for s, (mode, (ph, pw), stride, _) in zip(stages, walk):
        ph_acc += -(-ph * ny // uy)
        pw_acc += -(-pw * nx // ux)
        if mode == "map":
            ny, nx = ny * stride[0], nx * stride[1]
            if s.op == "pyr_up":
                uy, ux = uy * 2, ux * 2
    # final size of each band: the full-resolution state, or a tap's own
    h_fin, w_fin = planes.shape[-2:]
    for s, (mode, *_rest) in zip(stages, walk):
        if mode == "map":
            h_fin, w_fin = out_hw(s.op, h_fin, w_fin)
    sizes = [(h_fin, w_fin)]
    for s, (mode, *_rest) in zip(stages, walk):
        if mode == "emit":
            sizes = sizes[:-1] + [(h_fin, w_fin)] * 2
        elif mode == "reduce":
            sizes = sizes[:-2] + [(h_fin, w_fin)]
        elif mode == "tap":
            sizes.append(out_hw(s.op, h_fin, w_fin))

    def apply(s, ph, pw, stride, b, oy, ox, dt):
        """A band is (f32 planes, origin row, origin col, dtype)."""
        if s.op == "resize2":
            new, oy, ox = resize2_valid(b, oy, ox)
            return pack(new, dt), oy, ox, dt
        if s.op in ("warp_affine", "remap"):
            return pack(_gather(s, b, oy, ox, ph, pw), dt), oy + ph, ox + pw, dt
        if s.op == "pyr_up":
            return pack(pyr_up_valid(b), dt), 2 * (oy + 1), 2 * (ox + 1), dt
        new = _valid_op(s, b, ph, pw, dt)
        oy, ox = oy + ph, ox + pw
        if stride != (1, 1):
            s0, s1 = (-oy) % stride[0], (-ox) % stride[1]
            new = new[..., s0 :: stride[0], s1 :: stride[1]]
            oy, ox = (oy + s0) // stride[0], (ox + s1) // stride[1]
        return new, oy, ox, dt

    def crop(b, oy, ox, dt, ph, pw):
        return b[..., ph : b.shape[-2] - ph, pw : b.shape[-1] - pw], oy + ph, ox + pw, dt

    bands = [(pad_replicate(planes, ph_acc, pw_acc).to(torch.float32), -ph_acc, -pw_acc, carrier)]
    for s, (mode, (ph, pw), stride, tap) in zip(stages, walk):
        if mode == "emit":
            b, oy, ox, _ = bands[-1]
            dx, dy = sobel_pair(b)
            bands = [crop(*c, ph, pw) for c in bands[:-1]]
            bands += [(dx, oy + 1, ox + 1, torch.float32), (dy, oy + 1, ox + 1, torch.float32)]
        elif mode == "reduce":
            (a, oy, ox, _), (b, _, _, _) = bands[-2], bands[-1]
            bands = bands[:-2] + [(pack(sqrt_rn(a * a + b * b), carrier), oy, ox, carrier)]
        elif mode == "tap":
            new = apply(s, ph, pw, stride, *bands[tap])
            bands = [crop(*b, ph, pw) for b in bands] + [new]
        else:
            bands = [apply(s, ph, pw, stride, *b) for b in bands]
    outs = []
    for (b, oy, ox, dt), (hk, wk) in zip(bands, sizes):
        if oy > 0 or ox > 0:
            raise AssertionError("chain_ref: halo over-consumed")
        outs.append(b[..., -oy : -oy + hk, -ox : -ox + wk].to(dt))
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
    if C == 1:  # one plane an image: the same values, one view
        return band.unsqueeze(-1)
    return band.reshape(B, C, *band.shape[1:]).permute(0, 2, 3, 1)


def chain_ref(img: torch.Tensor, stages):
    """Oracle for `stencil.fused_chain`: (H, W), (H, W, C) or (B, H, W, C)
    u8 or f32 in; one array out, or a tuple when the chain ends with several
    live bands (taps)."""
    stages = tuple(stages)
    outs = tuple(from_planes(b, img.shape) for b in chain_ref_planes(to_planes(img), stages))
    return outs[0] if len(outs) == 1 else outs


def pyramid_ref(img: torch.Tensor, chains) -> tuple[list, list]:
    """Multi-octave oracle for `stencil.chained_launches`: `chain_ref` per
    link, the last output band of every link but the last (its strided
    terminal tap, the next base) feeding the next link as its input.
    Returns ``(outs, scales)`` as `chained_launches` does: ``outs[k]`` is
    link k's bands without the carry band, ``scales[k]`` the (row, col)
    factor that maps its pixel (y, x) to base-image (y * sy, x * sx)."""
    chains = tuple(tuple(c) for c in chains)
    if not chains:
        raise ValueError("pyramid_ref: need at least one chain")
    outs_all, scales = [], []
    base = img
    sy = sx = 1
    for k, stages in enumerate(chains):
        last = k == len(chains) - 1
        stride = tuple(getattr(stages[-1], "stride", (1, 1)))
        if not last and (getattr(stages[-1], "tap", None) is None or stride == (1, 1)):
            raise ValueError(
                f"pyramid_ref: link {k}'s final stage ({stages[-1].op!r}) is not a strided "
                "terminal tap; every link but the last must emit a next-base band"
            )
        outs = chain_ref(base, stages)
        outs = outs if isinstance(outs, tuple) else (outs,)
        scales.append((sy, sx))
        if last:
            outs_all.append(outs)
        else:
            outs_all.append(outs[:-1])
            base = outs[-1]
            sy, sx = sy * stride[0], sx * stride[1]
    return outs_all, scales


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
