"""The yardstick's constants and operation counts.

Peaks are NVIDIA's published numbers for one H100 SXM (data sheet, dense
rates), which assume the card's full 700 W power limit; a run reports the
card's limit beside any share of them.
"""

__all__ = ["H100_HBM_BYTES_PER_S", "band_profiles_bytes"]

H100_HBM_BYTES_PER_S = 3.35e12


def band_profiles_bytes(n: int, b: int, w: int) -> int:
    """Least bytes one launch of the band kernel moves: the (n, b, w)
    float32 background-subtracted band read once, each frame's int32
    prior index read once, and its three (n, w) float32 centerline
    profiles (Sobel, gradient, intensity) written once."""
    return 4 * n * b * w + 4 * n + 3 * 4 * n * w
