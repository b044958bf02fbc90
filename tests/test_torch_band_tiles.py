"""The band kernel's schedule, written out in numpy float32 and held
bit-equal to the plain band chain.

The CUDA kernel (``csrc/band_profiles.cu``) runs only on a card. Its block
takes one column tile of ``tile`` output columns and a run of consecutive
frames; here that schedule is written out step for step as the kernel takes
it:

- the raw band tile of a frame spans the output columns plus a halo of
  ``hp`` columns a side (the halo ``H = k + r_gauss`` rounded up to a
  multiple of 4, so 16-byte copies stay aligned); a column past the image
  is loaded from its mirror image (the triangle wave of period 2W);
- each stage computes only the in-image columns that the later stages
  still need, and a tile at an image edge then fills its out-of-image
  columns with the mirrored values of that stage's own output;
- the passes along rows are sliding windows down a column (the (3, 13)
  instantiation) or reductions in place down the buffer's column (the
  runtime-count one);
- in a run, frame n's tile stays and serves as frame n+1's prior when
  ``prior[n+1] == n``; any other prior (the first frame of a run, -1, a
  non-adjacent one) is loaded into a separate prior tile.

Buffers start as NaN, so a read of a column that no stage computed shows
as a mismatch. The result must equal ``band_profiles_plain`` bit for bit
for every tile width and run length.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hsip_tpu_torch.kernels.cuda_preprocess import band_profiles_plain  # noqa: E402
from hsip_tpu_torch.kernels.preprocess import band_margin, gaussian_taps  # noqa: E402

f32 = np.float32


def _reflect(c, w):
    """The kernel's mirror of an image column: reflect until inside."""
    while c < 0 or c >= w:
        c = -1 - c if c < 0 else 2 * w - 1 - c
    return c


def _extremum_rows(values, k, op):
    """A sliding window of k rows down the columns: yields output row i
    once row i + k - 1 has arrived, as the kernel's register window does."""
    win = []
    for row, v in enumerate(values):
        win = (win + [v])[-k:]
        if row >= k - 1:
            out = win[0]
            for x in win[1:]:
                out = op(out, x)
            yield row - k + 1, out


def _kernel_band_profiles(band, prior, thr, k, sigma, tile, run, registers=True):
    """((sobel, grad, intensity), tiles loaded) as the kernel's blocks
    compute them. ``registers``: the (3, 13) instantiation's row passes,
    sliding windows in registers; else the runtime-count instantiation's,
    which write the pass along W into the buffer (B rows for the erosion,
    B1 for the dilation) and reduce its rows in place, top down."""
    n, b, w = band.shape
    taps = gaussian_taps(sigma)
    ntaps = taps.size
    r = (ntaps - 1) // 2
    h = k + r  # (k - 1) + r_gauss + 1
    assert b == 2 * h + 1 and h <= tile
    hp = (h + 3) // 4 * 4
    s = tile + 2 * hp
    le_e, le_d, re_d = k // 2, k - 1 - k // 2, k // 2
    b1, b2 = b - k + 1, b - 2 * (k - 1)
    thr = f32(thr)
    outs = np.full((3, n, w), np.nan, f32)
    loads = 0

    for c0 in range(0, w, tile):  # blockIdx.x
        base = c0 - hp  # image column of buffer column 0
        hi_out = min(w, c0 + tile)
        src = np.array([_reflect(base + e, w) for e in range(s)])
        cols = base + np.arange(s)
        # Each stage's range of image columns; only its in-image part is
        # computed, the rest mirrored.
        rng_e = (c0 - (1 + r + le_d), hi_out + 1 + r + re_d)
        rng_d = (c0 - 1 - r, hi_out + 1 + r)
        rng_g = (c0 - 1, hi_out + 1)
        edge = c0 < h or hi_out + h > w

        def computed(lo, hi):
            return np.arange(max(0, lo), min(w, hi)) - base

        def mirror(buf, lo, hi):
            m = (cols >= lo) & (cols < hi) & ((cols < 0) | (cols >= w))
            buf[:, np.flatnonzero(m)] = buf[:, src[m] - base]

        def row_pass(along_w, cols, out, op):
            """The VALID pass of k rows down the columns ``cols``."""
            if registers:
                for row, v in _extremum_rows(along_w, k, op):
                    out[row, cols] = v
                return
            out[:len(along_w), cols] = along_w
            for row in range(len(along_w) - k + 1):
                m = out[row, cols]
                for o in range(1, k):
                    m = op(m, out[row + o, cols])
                out[row, cols] = m

        def load(frame):
            nonlocal loads
            loads += 1
            return band[frame][:, src].copy()

        def clamp(p):
            return min(max(int(p), 0), n - 1)

        for n0 in range(0, n, run):  # blockIdx.y
            n1 = min(n, n0 + run)
            slots = [load(n0), np.full((b, s), np.nan, f32)]
            pri_tile = load(clamp(prior[n0]))
            for nn in range(n0, n1):
                i = nn - n0
                cur = slots[i & 1]
                adj = i > 0 and prior[nn] == nn - 1
                pri = slots[(i - 1) & 1] if adj else pri_tile

                # Stage E: diff + threshold + erosion along W, then rows.
                x = np.full((b1 if registers else b, s), np.nan, f32)
                ce = computed(*rng_e)

                ew = None  # erosion along W, all B rows
                for o in range(k):
                    d = cur[:, ce - le_e + o] - pri[:, ce - le_e + o]
                    d = np.where(d < thr, f32(0.0), d)
                    ew = d if ew is None else np.minimum(ew, d)
                row_pass(ew, ce, x, np.minimum)
                # The next frame's tiles load now: this frame's prior tile
                # and the slot of frame n-1 are no longer read.
                if nn + 1 < n1:
                    slots[(i + 1) & 1] = load(nn + 1)
                    if prior[nn + 1] != nn:
                        pri_tile = load(clamp(prior[nn + 1]))
                if edge:  # the erosion's B1 rows
                    mirror(x[:b1], *rng_e)

                # Stage D: dilation along W, then rows.
                y = np.full((b2 if registers else b1, s), np.nan, f32)
                cd = computed(*rng_d)

                dw = x[:b1, cd - le_d]  # dilation along W, all B1 rows
                for o in range(1, k):
                    dw = np.maximum(dw, x[:b1, cd - le_d + o])
                row_pass(dw, cd, y, np.maximum)
                if edge:  # the dilation's B2 rows
                    mirror(y[:b2], *rng_d)

                # Stage G: Gaussian along W; the three output rows
                # accumulate down the columns, taps in order.
                cg = computed(*rng_g)
                gw = taps[0] * y[:b2, cg - r]  # Gaussian along W, all B2 rows
                for j in range(1, ntaps):
                    gw = gw + taps[j] * y[:b2, cg - r + j]
                acc = [None, None, None]
                for row, g in enumerate(gw):
                    for o in range(3):
                        j = row - o
                        if j == 0:
                            acc[o] = taps[0] * g
                        elif 0 < j < ntaps:
                            acc[o] = acc[o] + taps[j] * g
                z = np.full((2, s), np.nan, f32)
                z[0, cg] = (acc[0] + f32(2.0) * acc[1]) + acc[2]
                z[1, cg] = acc[1]
                if edge:
                    mirror(z, *rng_g)

                # Outputs: Sobel onto the center row, np.gradient, intensity.
                c = np.arange(c0, hi_out)
                e = c - base
                b1row = z[1]
                grad = (b1row[e + 1] - b1row[e - 1]) * f32(0.5)
                grad = np.where(c == 0, b1row[e + 1] - b1row[e], grad)
                grad = np.where(c == w - 1, b1row[e] - b1row[e - 1], grad)
                outs[0, nn, c0:hi_out] = z[0, e + 1] - z[0, e - 1]
                outs[1, nn, c0:hi_out] = grad
                outs[2, nn, c0:hi_out] = b1row[e]
    return outs, loads


def _case(k, sigma, w, seed, n=19):
    """Integer-valued 12-bit bands; priors of -1, non-adjacent priors (two
    in a row), a prior later than its frame and one that is the frame."""
    rng = np.random.default_rng(seed)
    b = 2 * band_margin(k, sigma) + 1
    band = rng.integers(0, 4096, (n, b, w)).astype(np.float32)
    prior = np.arange(-1, n - 1, dtype=np.int32)
    prior[[5, 9, 10, 13, 14]] = [-1, 2, 3, 17, 14]
    return band, prior


@pytest.mark.parametrize("w", [2, 7, 129, 136, 250, 1000, 1024])
@pytest.mark.parametrize("k,sigma", [(3, 1.5), (2, 1.5), (5, 2.0), (3, 3.0)])
def test_tiled_schedule_equals_plain(k, sigma, w):
    band, prior = _case(k, sigma, w, seed=10 * k + w)
    want = band_profiles_plain(torch.from_numpy(band), torch.from_numpy(prior),
                               5.0, k, sigma)
    want = np.stack([t.numpy() for t in want])
    for tile in (64, 128, 256):
        for run in (1, 3, 16):  # N = 19 is a multiple of none but 1
            got, _ = _kernel_band_profiles(band, prior, 5.0, k, sigma, tile, run)
            assert np.array_equal(got, want), (tile, run)


@pytest.mark.parametrize("w", [2, 7, 129, 136, 250, 1000, 1024])
@pytest.mark.parametrize("k,sigma", [(3, 1.5), (2, 1.5), (5, 2.0), (3, 3.0)])
def test_runtime_count_schedule_equals_plain(k, sigma, w):
    """The runtime-count instantiation's row passes (in place, in the
    buffers' own columns), at every (k, sigma) it runs and at the (3, 13)
    default, which the probe entry can give it."""
    band, prior = _case(k, sigma, w, seed=10 * k + w + 1)
    want = band_profiles_plain(torch.from_numpy(band), torch.from_numpy(prior),
                               5.0, k, sigma)
    want = np.stack([t.numpy() for t in want])
    for tile, run in ((64, 3), (128, 16), (256, 1)):
        got, _ = _kernel_band_profiles(band, prior, 5.0, k, sigma, tile, run,
                                       registers=False)
        assert np.array_equal(got, want), (tile, run)


def test_mirror_is_a_triangle_wave():
    """The kernel's repeated mirror equals numpy's 'symmetric' padding,
    also where the halo is wider than the image."""
    for w in (1, 2, 3, 7, 16):
        idx = np.arange(-40, w + 40)
        want = np.pad(np.arange(w), 40, mode="symmetric")
        assert [_reflect(int(c), w) for c in idx] == list(want)


@pytest.mark.parametrize("n,run", [(37, 8), (64, 16), (5, 1)])
def test_main_path_priors_read_each_band_about_once(n, run):
    """With the main path's priors (arange(-1, n-1)) a run of F frames
    loads F + 1 tiles, so each band is read about once, not twice; the
    result still equals the plain chain."""
    k, sigma, w, tile = 3, 1.5, 136, 64
    band = np.random.default_rng(n).integers(0, 4096, (n, 19, w)).astype(np.float32)
    prior = np.arange(-1, n - 1, dtype=np.int32)
    got, loads = _kernel_band_profiles(band, prior, 5.0, k, sigma, tile, run)
    runs, tiles = -(-n // run), -(-w // tile)
    assert loads == tiles * (n + runs)
    want = band_profiles_plain(torch.from_numpy(band), torch.from_numpy(prior),
                               5.0, k, sigma)
    assert np.array_equal(got, np.stack([t.numpy() for t in want]))
