"""``kernel.band_profiles_roofline_pct``: the band kernel's share of its
byte bound. The least bytes of every launch in the window (its band read
once, its profiles written once; shapes recorded at the launcher) at the
published HBM rate, over the kernel's device time by name in the trace."""

from harness.counts import H100_HBM_BYTES_PER_S, band_profiles_bytes

KERNEL = "band_profiles_kernel"


def read(record):
    ops = record.get("device_ops") or {}
    launches = record.get("band_launches") or []
    seconds = sum(v["seconds"] for k, v in ops.items() if KERNEL in k)
    if not launches or seconds <= 0:
        return None
    least = sum(band_profiles_bytes(*shape) for shape in launches) / H100_HBM_BYTES_PER_S
    return 100.0 * least / seconds
