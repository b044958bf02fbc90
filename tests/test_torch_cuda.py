"""The port's CUDA kernels on the card (marker ``cuda``; they skip without one).

This file imports neither jax nor the JAX package's device code, so it
runs on a machine with a card and no JAX, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel is held against its plain PyTorch version on the same card
tensors, and both backends are held against the golden table.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hsip_tpu.track import FileCalibration, FlameDetectorConfig, VideoSourceConfig  # noqa: E402
from hsip_tpu_torch.kernels.cuda_preprocess import (  # noqa: E402
    band_profiles_plain,
    cuda_band_profiles,
)
from hsip_tpu_torch.kernels.preprocess import band_margin  # noqa: E402
from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan  # noqa: E402
from hsip_tpu_torch.track.device_scan import METHODS, tracking_scan_plain  # noqa: E402
from hsip_tpu_torch.track.scan import scan_params  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "golden-run-1-001-flame-position.txt"


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,sigma", [(3, 1.5), (2, 1.5), (5, 2.0), (3, 3.0)])
def test_band_kernel_matches_plain(k, sigma):
    dev = _cuda()
    rng = np.random.default_rng(k * 10 + int(sigma * 2))
    for w in (1024, 1000, 250, 136, 7, 2):  # 7, 2: windows wider than W
        n, b = 64, 2 * band_margin(k, sigma) + 1
        band = torch.from_numpy(rng.integers(0, 4096, (n, b, w)).astype(np.float32)).to(dev)
        prior_np = np.arange(-1, n - 1, dtype=np.int32)
        prior_np[[5, 7, 40]] = [-1, 2, 11]  # -1 and priors that are not adjacent
        prior = torch.from_numpy(prior_np).to(dev)
        got = cuda_band_profiles(band, prior, 5.0, k, sigma)
        want = band_profiles_plain(band, prior, 5.0, k, sigma)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_scan_kernel_matches_plain(method):
    dev = _cuda()
    rng = np.random.default_rng(METHODS.index(method))
    v, m, w = 2, 256, 1024
    sob = np.round(rng.normal(0, 30, (v, m, w))).astype(np.float32)
    grad = np.round(rng.normal(0, 15, (v, m, w))).astype(np.float32)
    intens = np.abs(np.round(rng.normal(40, 30, (v, m, w)))).astype(np.float32)
    grad[:, :, 300] = grad[:, :, 700] = -80.0  # tied minima: first index wins
    intens[:, :, 500:504] = intens.max()       # flat peak
    t = [torch.from_numpy(x).to(dev) for x in (sob, grad, intens)]
    fidx = torch.arange(m, dtype=torch.int32, device=dev).repeat(v, 1)
    empty = torch.from_numpy(rng.random((v, m)) < 0.1).to(dev)
    prior = torch.ones((v, m), dtype=torch.bool, device=dev)
    prior[:, 0] = False
    kw = dict(width=w, intensity_lines=t[2],
              **scan_params(FlameDetectorConfig(), 100_000.0, 0.001, method))
    got = cuda_tracking_scan(fidx, t[0], t[1], empty, prior, **kw)
    want = tracking_scan_plain(fidx, t[0], t[1], empty, prior, **kw)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gpu", "device"])
def test_golden_table_on_the_card(tmp_path, backend):
    from hsip_tpu.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording
    from hsip_tpu_torch.pipeline import process_video_file

    _cuda()
    flame = FlameSpec(x0=30.0, v0_px=8.0, accel_px=0.3, ignition_frame=3,
                      ddt_frame=28, v_jump_px=25.0, seed=77)
    frames, _ = synthesize_flame_video(60, height=48, width=512, flame=flame)
    meta = write_recording(tmp_path, "golden-run-1-001", frames, spec=CihxSpec(
        width=512, height=48, total_frames=60, record_rate=100_000,
        bit_depth=12, start_frame=-10))
    cfg = VideoSourceConfig(name="G", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.output_dir = str(tmp_path / "out")
    cfg.file_calibrations = [FileCalibration(calibration=0.000833333,
                                             position_offset=1.0159,
                                             files=["run-1-"])]
    bands, scans = cuda_band_profiles.launches, cuda_tracking_scan.launches
    process_video_file(meta, cfg, backend=backend, verbose=False)
    produced = tmp_path / "out" / "golden-run-1-001-flame-position.txt"
    assert produced.read_bytes() == GOLDEN.read_bytes()
    assert cuda_band_profiles.launches > bands
    assert (cuda_tracking_scan.launches > scans) == (backend == "device")
