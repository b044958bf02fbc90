"""The port's band chain and unpack against the JAX package.

The same numpy inputs go through ``hsip_tpu`` (jnp chain and the Pallas
kernel in interpret mode) and through ``hsip_tpu_torch`` on the CPU (the
plain PyTorch versions). Profiles are held to the bar the Pallas kernel
meets against the jnp chain (atol 1e-4, rtol 1e-5); pixels, counts and raw
center lines must be equal. The CUDA kernel itself is checked on the card
by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hsip_tpu.kernels import preprocess as jpre  # noqa: E402
from hsip_tpu.kernels import unpack as junpack  # noqa: E402
from hsip_tpu.kernels.pallas_preprocess import pallas_band_profiles  # noqa: E402
from hsip_tpu_torch.kernels import preprocess as tpre  # noqa: E402
from hsip_tpu_torch.kernels import unpack as tunpack  # noqa: E402
from hsip_tpu_torch.kernels.cuda_preprocess import (  # noqa: E402
    band_profiles_plain,
    cuda_band_profiles,
)

TOL = dict(atol=1e-4, rtol=1e-5)


def _close(port, ref):
    """Assert the port within TOL of the reference; True when bit-equal."""
    port = [np.asarray(p) for p in port]
    ref = [np.asarray(r) for r in ref]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, **TOL)
    return all(np.array_equal(p, r) for p, r in zip(port, ref))


@pytest.mark.parametrize("k,sigma", [(2, 1.0), (3, 1.5), (4, 2.0), (5, 3.0)])
def test_numpy_helpers_match_jax(k, sigma):
    assert tpre.band_margin(k, sigma) == jpre.band_margin(k, sigma)
    np.testing.assert_array_equal(tpre.gaussian_taps(sigma), jpre.gaussian_taps(sigma))
    assert tpre.gaussian_taps(sigma).dtype == np.float32
    margin = tpre.band_margin(k, sigma)
    for center, n in ((10, 64), (0, 64), (63, 64), (6, 12), (24, 48)):
        np.testing.assert_array_equal(
            tpre.reflect_indices(center, margin, n),
            jpre.reflect_indices(center, margin, n),
        )
        assert tpre.band_folds(center, margin, n) == jpre.band_folds(center, margin, n)
        try:
            jpre._check_band_exactness(k, center, margin, n)
        except ValueError:
            with pytest.raises(ValueError, match="folding"):
                tpre._check_band_exactness(k, center, margin, n)
        else:
            tpre._check_band_exactness(k, center, margin, n)
    assert tunpack.rows_byte_aligned(255, 12) == junpack.rows_byte_aligned(255, 12)
    assert tunpack.rows_byte_aligned(256, 10) == junpack.rows_byte_aligned(256, 10)


def _band_case(k, sigma, w, seed):
    """Integer-valued bands, a -1 prior and priors that are not adjacent."""
    rng = np.random.default_rng(seed)
    n = 4
    b = 2 * tpre.band_margin(k, sigma) + 1
    band = rng.integers(0, 300, (n, b, w)).astype(np.float32)
    prior = np.array([-1, 0, -1, 1], dtype=np.int32)
    return band, prior


@pytest.mark.parametrize("w", [136, 250, 384])
@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0])
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_band_chain_matches_jnp_and_pallas(k, sigma, w):
    band, prior = _band_case(k, sigma, w, seed=100 * k + w)
    thr = np.float32(5.0)
    port = tpre.band_to_profiles(
        torch.from_numpy(band), torch.from_numpy(prior), float(thr), k, sigma
    )
    ref = jpre.band_to_profiles(jnp.asarray(band), jnp.asarray(prior), thr,
                                k, sigma, use_pallas=False)
    _close(port, ref)
    # The unmasked plain version against the Pallas kernel's contract.
    plain = band_profiles_plain(torch.from_numpy(band), torch.from_numpy(prior),
                                float(thr), k, sigma)
    pallas = pallas_band_profiles(band, prior, thr, morphology_kernel_size=k,
                                  gaussian_sigma=sigma, interpret=True)
    _close(plain, pallas)
    # Rows without a prior are zero after masking.
    for line in port:
        assert not np.any(line.numpy()[prior < 0])


@pytest.mark.parametrize("w", [2, 7])
@pytest.mark.parametrize("k,sigma", [(5, 3.0), (2, 1.5)])
def test_band_chain_tiny_widths(k, sigma, w):
    """Windows wider than the image: the reflect boundary bounces more than
    once (numpy 'symmetric' = a triangle wave of period 2W)."""
    band, prior = _band_case(k, sigma, w, seed=w)
    port = tpre.band_to_profiles(torch.from_numpy(band), torch.from_numpy(prior),
                                 5.0, k, sigma)
    ref = jpre.band_to_profiles(jnp.asarray(band), jnp.asarray(prior),
                                np.float32(5.0), k, sigma, use_pallas=False)
    _close(port, ref)


@pytest.mark.parametrize("height,k", [(48, 3), (12, 3), (12, 5), (10, 2)])
def test_batch_centerline_profiles_matches_jnp(height, k):
    """Full frames through the band gather, including bands that fold past
    the image edge (H=12, 10); an even kernel over a folding band raises
    on both sides."""
    rng = np.random.default_rng(height + k)
    n, w, sigma = 5, 136, 1.5
    frames = rng.integers(0, 4096, (n, height, w)).astype(np.uint16)
    prior = np.array([-1, 0, 1, -1, 2], dtype=np.int32)
    args = (np.float32(100.0), prior, np.float32(5.0), np.float32(50.0))
    margin = tpre.band_margin(k, sigma)
    if k % 2 == 0 and tpre.band_folds(height // 2, margin, height):
        with pytest.raises(ValueError, match="folding"):
            tpre.batch_centerline_profiles(
                torch.from_numpy(frames), 100.0, torch.from_numpy(prior), 5.0,
                50.0, morphology_kernel_size=k, gaussian_sigma=sigma)
        return
    ref = jpre.batch_centerline_profiles(
        frames, *args, morphology_kernel_size=k, gaussian_sigma=sigma)
    port = tpre.batch_centerline_profiles(
        torch.from_numpy(frames), float(args[0]), torch.from_numpy(prior),
        float(args[2]), float(args[3]), morphology_kernel_size=k,
        gaussian_sigma=sigma)
    _close(port[:3], ref[:3])
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(port[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("bits", [8, 10, 12, 16])
def test_unpack_matches_jax(bits):
    rng = np.random.default_rng(bits)
    group = {8: 1, 10: 5, 12: 3, 16: 2}[bits]
    packed = rng.integers(0, 256, (3, 4, 20 * group), dtype=np.uint8)
    port = getattr(tunpack, f"unpack_{bits}bit")(torch.from_numpy(packed))
    ref = getattr(junpack, f"unpack_{bits}bit_device")(jnp.asarray(packed))
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).astype(np.float32))


def _pack_rows(pixels, bits):
    """Pack (N, H, W) pixels as the MRAW writer does (flat stream per frame)."""
    from hsip_tpu.io.mraw import pack_10bit, pack_12bit

    flat = pixels.reshape(pixels.shape[0], -1)
    if bits == 8:
        return flat.astype(np.uint8)
    if bits == 16:
        return np.ascontiguousarray(flat.astype("<u2")).view(np.uint8)
    pack = pack_12bit if bits == 12 else pack_10bit
    return np.stack([np.asarray(pack(f), dtype=np.uint8).ravel() for f in flat])


@pytest.mark.parametrize("bits,width", [(8, 136), (10, 256), (10, 250),
                                        (12, 384), (12, 255), (16, 136)])
def test_packed_entries_match_jax(bits, width):
    """Both packed entries, byte-aligned rows and rows that straddle bytes
    (odd-width 12-bit, 10-bit with W % 4 != 0)."""
    rng = np.random.default_rng(bits * 1000 + width)
    n, h = 6, 32
    # Pixel values at the scale of the tolerance's own test (the Pallas
    # kernel against the jnp chain, values below a few hundred): XLA may
    # contract a*b+c into an FMA, so the jnp chain is not bit-equal to an
    # uncontracted one. The decode of every bit is held exactly by
    # test_unpack_matches_jax.
    pixels = rng.integers(0, 400, (n, h, width)).astype(np.uint16)
    pixels = np.minimum(pixels, 2 ** bits - 1)
    packed = _pack_rows(pixels, bits)
    prior = np.arange(-1, n - 1, dtype=np.int32)
    prior[3] = 1  # a prior that is not the adjacent frame
    bg, thr, noise = np.float32(40.0), np.float32(5.0), np.float32(20.0)
    ref = junpack.packed_centerline_profiles(
        jnp.asarray(packed), h, width, bg, prior, thr, noise, bit_depth=bits)
    port = tunpack.packed_centerline_profiles(
        torch.from_numpy(packed), h, width, float(bg), torch.from_numpy(prior),
        float(thr), float(noise), bit_depth=bits)
    _close(port[:3], ref[:3])
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(port[4].numpy(), np.asarray(ref[4]))

    if not tunpack.rows_byte_aligned(width, bits):
        return
    margin = tpre.band_margin(3, 1.5)
    rows = tpre.reflect_indices(h // 2, margin, h)
    row_nbytes = width * bits // 8
    band_bytes = packed.reshape(n, h, row_nbytes)[:, rows, :]
    ref = junpack.packed_band_profiles(jnp.asarray(band_bytes), bg, prior, thr,
                                       bit_depth=bits)
    port = tunpack.packed_band_profiles(torch.from_numpy(band_bytes), float(bg),
                                        torch.from_numpy(prior), float(thr),
                                        bit_depth=bits)
    _close(port[:3], ref[:3])
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))


def test_cuda_band_kernel_rejects_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is refused."""
    band, prior = _band_case(3, 1.5, 136, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_band_profiles(torch.from_numpy(band), torch.from_numpy(prior), 5.0, 3, 1.5)

