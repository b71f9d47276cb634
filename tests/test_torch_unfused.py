"""The port's seed (pre-fusion) kernels against the JAX package's.

The JAX side loads `benchmarks/unfused_baseline.py` by its path (the
directory is no package) and runs its Pallas kernels in interpret mode with
`VectorConfig(lmul=4)`, as that file runs on the CPU.  The port runs the
wrappers on CPU tensors, which is each kernel's plain version.  Inputs are
made from a numpy seed and handed to both.

Tolerances: erosion, threshold and the pipeline's threshold output are
exact.  The blur is exact but where XLA's fused multiply-add may move a
value across a .5 rounding tie: there a u8 |diff| <= 1 is allowed, and
every such pixel must be a counted near-tie (0 predicted).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.vector import VectorConfig

from repro_torch.kernels import counters, ref as tref, unfused

ROOT = pathlib.Path(__file__).resolve().parents[1]
VC = VectorConfig(lmul=4)
# (thresh, thresh cast to u8 as `seed_threshold_2d` casts it on the CPU);
# 255.99999999 rounds to 256.0 in f32 before the cast
T8_TABLE = [(0, 0), (100.5, 100), (254.5, 254), (255.9, 255), (255.99999999, 0), (256, 0),
            (-0.5, 0), (-1, 255), (-5, 251), (300, 44), (511.7, 255), (-256, 0)]


@pytest.fixture(scope="module")
def ub():
    spec = importlib.util.spec_from_file_location(
        "unfused_baseline_reference", ROOT / "benchmarks" / "unfused_baseline.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plane(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _near_ties(x: np.ndarray, ksize: int) -> np.ndarray:
    """Pixels whose blurred f32 value lies within 1e-3 of a .5 rounding tie."""
    k1 = tref.gaussian_kernel1d(ksize).numpy()
    p = ksize // 2
    xp = np.pad(x.astype(np.float32), p, mode="edge")
    h, w = x.shape
    row = sum(k1[j] * xp[:, j : j + w] for j in range(ksize))
    v = sum(k1[i] * row[i : i + h] for i in range(ksize))
    return np.abs(v - np.floor(v) - 0.5) < 1e-3


@pytest.mark.parametrize("shape", [(40, 72), (37, 53)])
@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_seed_blur_matches_jax(ub, ksize, shape):
    x = _plane(shape, seed=ksize)
    want = np.asarray(ub.seed_gaussian_blur_2d(jnp.asarray(x), ksize, VC))
    got = unfused.seed_gaussian_blur_2d(torch.from_numpy(x), ksize).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert diff.max() <= 1
    assert not (diff > 0)[~_near_ties(x, ksize)].any(), "differs off a .5 tie"


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("shape", [(40, 72), (37, 53)])
def test_seed_erode_matches_jax(ub, r, shape):
    x = _plane(shape, seed=10 + r)
    want = np.asarray(ub.seed_erode_2d(jnp.asarray(x), r, VC))
    got = unfused.seed_erode_2d(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh,t8", T8_TABLE)
def test_seed_threshold_matches_jax(ub, thresh, t8):
    """Every u8 value against each threshold of the table: the threshold
    is cast to u8 first (rounded to f32, truncated, then wrapped), as the
    JAX seed does."""
    x = (np.arange(37 * 53) % 256).astype(np.uint8).reshape(37, 53)
    want = np.asarray(ub.seed_threshold_2d(jnp.asarray(x), thresh, 255.0, VC))
    got = unfused.seed_threshold_2d(torch.from_numpy(x), thresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert unfused.to_u8(thresh) == t8
    np.testing.assert_array_equal(got, np.where(x > t8, 255, 0).astype(np.uint8))


def test_seed_pipeline_matches_jax(ub):
    batch = _plane((2, 40, 72, 3), seed=20)
    want = np.asarray(ub.seed_pipeline(jnp.asarray(batch), blur_ksize=5, erode_r=1,
                                       thresh=100.0, vc=VC))
    counters.reset()
    got = unfused.seed_pipeline(torch.from_numpy(batch), blur_ksize=5, erode_r=1, thresh=100.0)
    np.testing.assert_array_equal(got.numpy(), want)
    for name in ("seed_gaussian_blur", "seed_erode", "seed_threshold"):
        assert counters.PLAIN_CALLS[name] == 6  # B * C planes
    assert sum(counters.LAUNCHES.values()) == 0


def test_seed_pipeline_takes_non_contiguous_channels():
    batch = torch.from_numpy(_plane((1, 21, 30, 2), seed=21))
    got = unfused.seed_pipeline(batch, blur_ksize=3, erode_r=2, thresh=-1)
    for c in range(2):
        p = batch[0, :, :, c].contiguous()
        want = unfused.seed_threshold_2d(unfused.seed_erode_2d(
            unfused.seed_gaussian_blur_2d(p, 3), 2), -1)
        assert torch.equal(got[0, :, :, c], want)


@pytest.mark.parametrize("fn,args", [
    (unfused.seed_gaussian_blur_2d, (5,)),
    (unfused.seed_erode_2d, (1,)),
    (unfused.seed_threshold_2d, (100.0,)),
])
def test_seed_wrappers_take_one_u8_plane(fn, args):
    with pytest.raises(ValueError, match="uint8"):
        fn(torch.zeros((8, 8), dtype=torch.float32), *args)
    with pytest.raises(ValueError, match="uint8"):
        fn(torch.zeros((2, 8, 8), dtype=torch.uint8), *args)
    with pytest.raises(ValueError, match="mode"):
        fn(torch.zeros((8, 8), dtype=torch.uint8), *args, mode="window")


def test_seed_blur_rejects_even_or_huge_kernels():
    for k in (4, 0, 33):
        with pytest.raises(ValueError, match="ksize"):
            unfused.seed_gaussian_blur_2d(torch.zeros((8, 8), dtype=torch.uint8), k)


def test_seed_plain_versions_equal_the_fused_oracles():
    """On the extended domain a single op's chain is the per-op result, so
    each seed plain version equals `kernels.ref`'s per-op oracle."""
    x = torch.from_numpy(_plane((33, 47), seed=22))
    k1 = tref.gaussian_kernel1d(7)
    assert torch.equal(unfused.seed_gaussian_blur_2d(x, 7), tref.sep_filter2d_ref(x, k1, k1))
    assert torch.equal(unfused.seed_erode_2d(x, 2), tref.erode_ref(x, 2))


# ---------------------------------------------------------------------------
# seed_gaussian_blur's strip walk (csrc/unfused.cu), in numpy
# ---------------------------------------------------------------------------

def _replay_blur_strips(x: np.ndarray, ksize: int) -> np.ndarray:
    """`seed_gaussian_blur_kernel<ksize>` over an (H, W) u8 plane: tiles of
    BLUR_ROWS x BLUR_COLS; each window is the tile's rows +- k/2 (clamped)
    by BLUR_PAD columns either side, read in 16-byte segments (raw bytes
    where a segment lies inside a plane of a width that is a multiple of 16,
    else byte by byte with clamped columns); the row pass in strips of 4
    outputs, output j of a strip reading window columns BLUR_PAD - k/2 + c +
    j + q for taps q ascending; the column pass over 4 columns a tap; each
    product and sum rounded to f32; rint and saturate; stores only inside
    the plane, each pixel once."""
    h, w = x.shape
    k1 = tref.gaussian_kernel1d(ksize).numpy()
    hk = ksize // 2
    R, C, P = unfused.BLUR_ROWS, unfused.BLUR_COLS, unfused.BLUR_PAD
    out = np.zeros((h, w), np.uint8)
    stores = np.zeros((h, w), np.int32)
    strips = 4 * np.arange(C // 4)
    for y0 in range(0, h, R):
        for x0 in range(0, w, C):
            rows = np.clip(np.arange(y0 - hk, y0 + R + hk), 0, h - 1)
            win = np.empty((R + 2 * hk, C + 2 * P), np.uint8)
            for sg in range((C + 2 * P) // 16):
                gx = x0 - P + 16 * sg
                if w % 16 == 0 and gx >= 0 and gx + 16 <= w:
                    win[:, 16 * sg:16 * sg + 16] = x[rows, gx:gx + 16]
                else:
                    cols = np.clip(np.arange(gx, gx + 16), 0, w - 1)
                    win[:, 16 * sg:16 * sg + 16] = x[rows][:, cols]
            v = win.astype(np.float32)
            seg = v[:, (P - hk + strips)[:, None] + np.arange(ksize + 3)[None, :]]  # (rows, strip, k+3)
            row = np.empty((R + 2 * hk, C // 4, 4), np.float32)
            for o in range(4):
                acc = k1[0] * seg[:, :, o]
                for q in range(1, ksize):
                    acc = acc + k1[q] * seg[:, :, o + q]
                row[:, :, o] = acc
            row = row.reshape(R + 2 * hk, C)
            acc = k1[0] * row[0:R]
            for q in range(1, ksize):
                acc = acc + k1[q] * row[q:q + R]
            tile = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
            ny, nx = min(R, h - y0), min(C, w - x0)
            out[y0:y0 + ny, x0:x0 + nx] = tile[:ny, :nx]
            stores[y0:y0 + ny, x0:x0 + nx] += 1
    assert (stores == 1).all()
    return out


@pytest.mark.parametrize("ksize", list(range(1, 32, 2)))
@pytest.mark.parametrize("shape", [(1, 1), (1, 300), (37, 53), (511, 513), (48, 512)])
def test_blur_strip_replay_is_bit_equal_to_plain(ksize, shape):
    """Every kernel size, on one pixel, one row, odd sizes and a width that
    is a multiple of 16 (16-byte segments, edge tiles clamped): the strip
    walk equals `seed_gaussian_blur_2d_plain` bit for bit."""
    x = _plane(shape, seed=ksize + shape[0] * 3)
    want = unfused.seed_gaussian_blur_2d(torch.from_numpy(x), ksize).numpy()
    np.testing.assert_array_equal(_replay_blur_strips(x, ksize), want)


def test_blur_block_geometry_matches_the_kernel():
    """The replay's block is the kernel's (csrc/unfused.cu kBlurRows,
    kBlurCols, kBlurPad, kBlurThreads); the pad covers the largest halo
    (15) in one 16-byte segment; a block's static shared memory at k = 31
    (the u8 window and the f32 row pass) stays within 48 KB; a 512x512
    plane is one wave of blocks on 132 SMs."""
    import re

    src = (ROOT / "src" / "repro_torch" / "csrc" / "unfused.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kBlurRows"]), int(consts["kBlurCols"]), int(consts["kBlurPad"]),
            int(consts["kBlurThreads"])) == (unfused.BLUR_ROWS, unfused.BLUR_COLS,
                                             unfused.BLUR_PAD, unfused.BLUR_THREADS)
    assert unfused.BLUR_PAD == 16 and unfused.BLUR_PAD >= 31 // 2 and unfused.BLUR_COLS % 16 == 0
    wh = unfused.BLUR_ROWS + 2 * (31 // 2)
    assert wh * (unfused.BLUR_COLS + 2 * unfused.BLUR_PAD) + 4 * wh * unfused.BLUR_COLS <= 48 * 1024
    assert -(-512 // unfused.BLUR_ROWS) * -(-512 // unfused.BLUR_COLS) <= 132
    for k in range(1, 32, 2):
        assert f"case {k}: return launch_blur<{k}>" in src


# ---------------------------------------------------------------------------
# seed_erode's and seed_threshold's packed-byte walks (csrc/unfused.cu), in numpy
# ---------------------------------------------------------------------------

SEED_SHAPES = [(1, 1), (1, 300), (300, 1), (37, 53), (511, 513), (48, 512)]
ERODE_RADII = [0, 1, 2, 3, 7, 12, 32]


def _words(b: np.ndarray) -> np.ndarray:
    """Bytes (..., 4n) as little-endian 32-bit words (..., n)."""
    return np.ascontiguousarray(b).view("<u4")


def _bytes(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.astype("<u4")).view(np.uint8)


def _vminu4(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`__vminu4`: the unsigned min of each of the 4 byte lanes."""
    return _words(np.minimum(_bytes(a), _bytes(b)))


def _vcmpgtu4(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`__vcmpgtu4`: 0xFF in each byte lane where a > b (unsigned), else 0."""
    return _words(np.where(_bytes(a) > _bytes(b), 255, 0).astype(np.uint8))


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """`__byte_perm(x, y, sel)`: result byte n is byte (sel >> 4n) & 7 of the
    8 bytes x (0-3) then y (4-7)."""
    b = np.concatenate([_bytes(x[..., None]), _bytes(y[..., None])], axis=-1)
    return _words(b[..., [(sel >> (4 * n)) & 7 for n in range(4)]])[..., 0]


def test_packed_byte_emulation_on_known_words():
    """The emulated intrinsics on hand-made words: lanes are bytes of a
    little-endian word, so a shift by b bytes moves byte b of x to byte 0."""
    x, y = np.array([0x44332211], np.uint32), np.array([0x88776655], np.uint32)
    assert _byte_perm(x, y, 0x3210)[0] == 0x44332211
    assert _byte_perm(x, y, 0x4321)[0] == 0x55443322
    assert _byte_perm(x, y, 0x6543)[0] == 0x77665544
    assert _vminu4(np.array([0x01FF7F80], np.uint32), np.array([0x02FE807F], np.uint32))[0] == 0x01FE7F7F
    assert _vcmpgtu4(np.array([0x00FF8064], np.uint32), np.array([0x64646464], np.uint32))[0] == 0x00FFFF00


def _replay_erode(x: np.ndarray, r: int, base: int = 0) -> tuple[np.ndarray, dict]:
    """`seed_erode_kernel<R>` over an (H, W) u8 plane whose first byte lies
    at address `base` (mod 16): tiles of ERODE_ROWS x ERODE_COLS; the window
    is the tile's rows +- r (clamped) by PAD columns either side (16 for a
    window sized for rm <= 16, else 32), copied in 16-byte segments (raw where
    the segment lies inside the plane at a 16-byte aligned address, else
    byte by byte with clamped columns); thread t owns rows t // 8, bytes 16 *
    (t % 8) .. + 15 of the tile; the column pass `__vminu4`s the strip's
    words and HW = ceil(rm / 4) halo words either side over rows i .. i +
    2r, rm = r or the least of ERODE_GENERIC at or above it; the row pass takes, for each output word k and each s = 4d + b in
    [-r, r], word k + d shifted down b bytes by `__byte_perm` with word k +
    d + 1; stores only inside the plane, each pixel once.  Returns the
    output and how many segments and strips went the 16-byte way."""
    h, w = x.shape
    R, C = unfused.ERODE_ROWS, unfused.ERODE_COLS
    assert unfused.ERODE_THREADS == R * C // 16
    rm = r if r in unfused.ERODE_UNROLLED else min(g for g in unfused.ERODE_GENERIC if g >= r)
    pad, hw = -(-rm // 16) * 16, -(-rm // 4)
    ww, wh = C + 2 * pad, R + 2 * r
    nseg, nw = ww // 16, 4 + 2 * hw
    y0s, x0s = np.arange(0, h, R), np.arange(0, w, C)
    ys = np.clip(y0s[:, None] - r + np.arange(wh)[None, :], 0, h - 1)         # (TY, wh)
    gx = x0s[:, None] - pad + 16 * np.arange(nseg)[None, :]                  # (TX, nseg)
    vec = ((gx >= 0) & (gx + 16 <= w))[None, None] & (
        (base + ys[:, :, None, None] * w + gx[None, None]) % 16 == 0)         # (TY, wh, TX, nseg)
    cols = gx[..., None] + np.arange(16)                                     # (TX, nseg, 16)
    assert np.broadcast_to(((cols >= 0) & (cols < w)).all(-1), vec.shape)[vec].all()
    cols = np.where(vec[..., None], cols[None, None], np.clip(cols, 0, w - 1)[None, None])
    win = x[ys[:, :, None, None, None], cols]                                # (TY, wh, TX, nseg, 16)
    win = win.transpose(0, 2, 1, 3, 4).reshape(len(y0s), len(x0s), wh, ww)
    ww4 = _words(win)                                                        # (TY, TX, wh, ww / 4)
    wi = (pad + 16 * np.arange(C // 16))[:, None] // 4 + np.arange(-hw, 4 + hw)[None, :]
    col = ww4[:, :, 0:R][..., wi]                                            # (TY, TX, R, strips, nw)
    for q in range(1, 2 * r + 1):
        col = _vminu4(col, ww4[:, :, q:q + R][..., wi])
    res = []
    for k in range(4):
        m = col[..., k + hw]
        for d in range(-hw, hw + 1):
            for b in range(4):
                s = 4 * d + b
                if s == 0 or (d == hw and b > 0) or not -r <= s <= r:
                    continue
                lo = col[..., k + d + hw]
                m = _vminu4(m, lo if b == 0 else _byte_perm(lo, col[..., k + d + hw + 1],
                                                            0x3210 + 0x1111 * b))
        res.append(m)
    tiles = _bytes(np.stack(res, -1)).reshape(len(y0s), len(x0s), R, C)
    full = tiles.transpose(0, 2, 1, 3).reshape(len(y0s) * R, len(x0s) * C)
    sy, sx = np.meshgrid(np.arange(len(y0s) * R), 16 * np.arange(len(x0s) * C // 16), indexing="ij")
    live = (sy < h) & (sx < w)
    vec_store = live & (sx + 16 <= w) & ((base + sy * w + sx) % 16 == 0)
    return full[:h, :w].copy(), {"vector_segments": int(vec.sum()),
                                 "vector_stores": int(vec_store.sum()), "strips": int(live.sum())}


@pytest.mark.parametrize("r", ERODE_RADII)
@pytest.mark.parametrize("shape", SEED_SHAPES)
def test_erode_packed_replay_is_bit_equal_to_plain(r, shape):
    """r = 0..3 (a kernel each) and the generic bodies at 7, 12 and 32, on one
    pixel, one row, one column, odd sizes (r = 32 on 37x53: every clamped
    index an edge) and a width that is a multiple of 16: the packed walk
    equals `seed_erode_2d_plain` bit for bit on random bytes."""
    x = _plane(shape, seed=100 + r + shape[1])
    want = unfused.seed_erode_2d(torch.from_numpy(x), r).numpy()
    got, ways = _replay_erode(x, r)
    np.testing.assert_array_equal(got, want)
    if shape == (48, 512):  # aligned rows: every interior segment and every strip 16 bytes wide
        assert ways["vector_segments"] > 0 and ways["vector_stores"] == ways["strips"]


@pytest.mark.parametrize("r", ERODE_RADII)
@pytest.mark.parametrize("shape", [(37, 53), (48, 512)])
def test_erode_packed_replay_on_a_ramp(r, shape):
    """A ramp (each byte one more than its left neighbour, wrapping) shows a
    byte slip of a shift that smooth images hide."""
    h, w = shape
    x = ((np.arange(h)[:, None] * 7 + np.arange(w)[None, :]) % 256).astype(np.uint8)
    want = unfused.seed_erode_2d(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(_replay_erode(x, r)[0], want)


@pytest.mark.parametrize("base", [1, 3, 8])
@pytest.mark.parametrize("shape", [(37, 53), (48, 512)])
def test_erode_packed_replay_unaligned(base, shape):
    """A plane at an odd (or 8-byte) address, as a row slice of a larger
    plane is: the byte path everywhere it must be, bit-equal all the same."""
    x = _plane(shape, seed=base + shape[1])
    for r in (1, 7):
        got, ways = _replay_erode(x, r, base=base)
        np.testing.assert_array_equal(got, unfused.seed_erode_2d(torch.from_numpy(x), r).numpy())
        if shape[1] % 16 == 0:
            assert ways["vector_segments"] == 0 and ways["vector_stores"] == 0


def _replay_threshold(x: np.ndarray, thresh: float, maxval: float = 255.0,
                      base_in: int = 0, base_out: int = 0) -> tuple[np.ndarray, dict]:
    """`seed_threshold_kernel` over the plane's n bytes, input at address
    `base_in` and output at `base_out` (mod 16): a head up to the input's
    first 16-byte boundary, whole vectors, a tail; max(1, ceil(nvec / 256))
    blocks of THRESH_THREADS; thread g takes vector g (`__vcmpgtu4` of each
    word against t8 in every byte, ANDed with maxval8 in every byte) and, for
    g < head and g < tail, head byte g and tail byte g; every byte written once."""
    flat = x.reshape(-1)
    n = flat.size
    t8, m8 = unfused.to_u8(thresh), unfused.to_u8(maxval)
    head = min(n, (16 - base_in % 16) % 16)
    nvec = (n - head) // 16
    tail = n - head - 16 * nvec
    o = (base_out + head) % 16
    store = 0 if o == 0 else 1 if o % 4 == 0 else 2
    g = np.arange(max(1, -(-nvec // unfused.THRESH_THREADS)) * unfused.THRESH_THREADS)
    out = np.zeros(n, np.uint8)
    writes = np.zeros(n, np.int32)
    for e in (g[g < head], head + 16 * nvec + g[g < tail]):
        out[e] = np.where(flat[e] > t8, m8, 0)
        writes[e] += 1
    vg = g[g < nvec]
    words = _words(flat[head:head + 16 * nvec].reshape(nvec, 16))[vg]
    out[head:head + 16 * nvec] = _bytes(
        _vcmpgtu4(words, np.full_like(words, t8 * 0x01010101)) & np.uint32(m8 * 0x01010101)).reshape(-1)
    writes[head:head + 16 * nvec] += 1
    assert (writes == 1).all()
    return out.reshape(x.shape), {"head": head, "nvec": nvec, "tail": tail, "store": store}


@pytest.mark.parametrize("thresh,t8", T8_TABLE)
@pytest.mark.parametrize("shape", SEED_SHAPES)
def test_threshold_packed_replay_is_bit_equal_to_plain(thresh, t8, shape):
    """Every threshold of the table on every shape: 16 bytes a thread, one
    packed unsigned compare a word, the head and tail byte by byte, equal
    to `seed_threshold_2d_plain` bit for bit."""
    x = _plane(shape, seed=200 + shape[0] + shape[1])
    x.reshape(-1)[: min(256, x.size)] = np.arange(min(256, x.size))  # every value where room
    want = unfused.seed_threshold_2d(torch.from_numpy(x), thresh).numpy()
    got, split = _replay_threshold(x, thresh)
    np.testing.assert_array_equal(got, want)
    assert split["head"] == 0 and split["tail"] == x.size % 16


@pytest.mark.parametrize("base_in,base_out", [(3, 0), (0, 5), (12, 0), (7, 7), (1, 2)])
@pytest.mark.parametrize("shape", [(1, 1), (1, 300), (37, 53), (48, 512)])
def test_threshold_packed_replay_unaligned(base_in, base_out, shape):
    """Input and output at other byte offsets: the split follows the
    input, the store width the output; bit-equal to the plain version."""
    x = _plane(shape, seed=base_in + 10 * base_out)
    for thresh in (100.5, -1, 0):
        got, split = _replay_threshold(x, thresh, base_in=base_in, base_out=base_out)
        np.testing.assert_array_equal(got, unfused.seed_threshold_2d(torch.from_numpy(x), thresh).numpy())
        assert split["head"] == min(x.size, (16 - base_in) % 16)


def test_erode_and_threshold_geometry_match_the_kernels():
    """The replays' blocks are the kernels' (csrc/unfused.cu kErode*,
    kThreshThreads, the window's PAD and HW formulas, a kernel per r in
    ERODE_UNROLLED and a generic body per size in ERODE_GENERIC, the last
    for ERODE_MAX_R); a 512x512 plane is one wave of either kernel on 132
    SMs; the largest body's static shared memory (sized for r = 32) stays
    within 48 KB; no launch sets a dynamic shared memory attribute."""
    import re

    src = (ROOT / "src" / "repro_torch" / "csrc" / "unfused.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kErodeRows"], consts["kErodeCols"], consts["kErodeThreads"],
            consts["kErodeMaxR"], consts["kThreshThreads"]) == (
        unfused.ERODE_ROWS, unfused.ERODE_COLS, unfused.ERODE_THREADS, unfused.ERODE_MAX_R,
        unfused.THRESH_THREADS)
    assert unfused.ERODE_COLS % 16 == 0 and unfused.ERODE_THREADS == unfused.ERODE_ROWS * unfused.ERODE_COLS // 16
    assert "constexpr int PAD = (RM + 15) / 16 * 16;" in src
    assert "constexpr int HW = (RM + 3) / 4;" in src
    assert -(-512 // unfused.ERODE_ROWS) * -(-512 // unfused.ERODE_COLS) <= 132
    assert -(-512 * 512 // 16 // unfused.THRESH_THREADS) <= 132
    rm = unfused.ERODE_MAX_R
    pad = -(-rm // 16) * 16
    assert (unfused.ERODE_ROWS + 2 * rm) * (unfused.ERODE_COLS + 2 * pad) <= 48 * 1024
    for r in unfused.ERODE_UNROLLED:
        assert f"case {r}: return launch_erode<{r}>" in src
    for rm in unfused.ERODE_GENERIC:
        assert f"return launch_erode<-1, {rm}>" in src
    assert unfused.ERODE_GENERIC[-1] == unfused.ERODE_MAX_R
    assert "cudaFuncSetAttribute" not in src
