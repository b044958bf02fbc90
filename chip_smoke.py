#!/usr/bin/env python3
"""Start the PyTorch + CUDA port (``hsip_tpu_torch``) on one GPU and check it.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each fatal when it fails:

1. the card: CUDA must be available; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles ``hsip_tpu_torch/csrc/*.cu`` with ``nvcc`` into
   ``hsip_tpu_torch/build/`` (first use) and prints the build time;
3. the band kernel against its plain PyTorch version on the card, over
   W ∈ {1024, 1000, 250, 136, 129}, (k, σ) ∈ {(3, 1.5), (2, 1.5),
   (5, 2.0), (3, 3.0)} and N ∈ {1, 37, 4096}, at (3, 1.5) also its
   runtime-count instantiation, and one batch shaped like a library group
   (N = 4·37, no prior at each video's first row): within atol 1e-4,
   rtol 1e-5 and bit-equal;
4. the tracking-scan kernel against its plain version on the card, all
   four detectors at M=2048, W=1024, on random profiles with planted ties,
   on the profiles of the phase-5 recording, on four videos at once
   (V=4, per-video calibration, frame rate and displacement cap), and on
   four videos of ragged lengths (the rows past each length empty): all
   nine fields equal;
5. the slice: ``process_video_file`` with backend 'gpu' and 'device' on a
   2048-frame 128×1024 12-bit recording and on the golden recording; the
   launch counters must show that each run went through its kernels, and
   the tables must equal the port's own CPU run (and the golden table);
6. times: each kernel against its plain version at the main path's shapes
   (CUDA events, median; the scan at V=1, V=8 and about one video per
   SM, with the rate of its whole-row copies there), each beside its bound
   (bytes moved over the memory rate, or operations over the float32 rate,
   whichever is larger), the band kernel's read rate (the bytes of band
   tiles its blocks copy, as the kernel counts them, over its time), its
   (3, 13) instantiation against the runtime-count one at the same
   shapes, the wall clock of both backends and their ``StageTimes``;
7. library mode: ``process_video_source_library`` over a directory of
   eight such recordings (one payload, hard-linked; half the names match
   the source's ``run-1-`` calibration), a 512-frame one of the same shape
   with a dark preamble, and the golden one. Every group must take the
   fused path, both kernels must be launched at least once a group and the
   scan with V > 1, and every table must equal, byte for byte, the per-file
   ``device`` run's of the same recording on the card (the golden one
   ``tests/golden/``) — also on the chunked path (``HSIP_FUSED=0``), with
   one group (``HSIP_FUSED_GROUPS=1``), with the clip off and with the clip
   forced (``HSIP_CLIP_EMPTY=1``); a second run with ``resume=True``
   processes nothing and leaves tables and summary as they were. Then
   times: the per-file source runner against library mode over the eight
   (median of 3 warm runs each, in turns), the library's ``StageTimes`` and
   per-group timeline, peak device memory against the fused budget's
   estimate, and both kernels at the library's shapes;
8. the command line: ``hsip_tpu_torch.cli.main`` over the eight recordings
   of phase 7 (``--no-images --no-sequences``, the card by default): per
   file (the auto backend must be ``device``: both kernels once a file),
   with ``--library`` (fused, the scan with V > 1), and under two ranks
   that share the card (two processes that run ``main`` with
   ``--distributed --coordinator 127.0.0.1:PORT --num-processes 2
   --process-id {0,1}``, per file and with ``--library``, each with a time
   limit; each rank must take a disjoint half and launch both kernels). On
   every route the tables must equal, byte for byte, phase 7's per-file
   ``device`` run. ``--device cuda:99`` must return 2 and write nothing;
   ``--profile-dir`` on one recording must leave a non-empty trace. Then
   times: each CLI route beside the direct runner on the same bytes, in
   turns (median of 3 warm runs a side), and the two-rank runs' walls;
9. the mesh (``hsip_tpu_torch.parallel``), every multi-slot mesh with its
   slots on ``cuda:0``: ``track_video`` over a 2- and a 4-slot frame mesh,
   ``scan='device'`` and ``'host'``, at a chunk size of half the recording
   (two chunks): the band kernel launched slots × chunks times, the
   sharded profiles bit-equal to the unsharded map phase's, the sharded
   band chain on the card bit-equal to its plain version on CPU slots, the
   tables byte-equal to phase 5's; ``process_video_source_library`` over
   phase 7's eight recordings with a one-card mesh and a 2-slot mesh, fused
   and with ``HSIP_FUSED=0``: both kernels launched on every slot, tables
   byte-equal to phase 7's per-file ``device`` run; ``hsip-torch --library
   --mesh`` writes the same tables, and ``--library --mesh N`` with N past
   the cards returns 2 and writes nothing; ``run_multichip_dryrun`` and
   ``run_pipeline_dryrun`` with 4 slots on the card (the dry run's total and
   positions as with 4 CPU slots; a position may differ only at a near-tie,
   printed with its profiles within the tolerance). Then times, medians of
   3 warm runs in turns: library without a mesh, with the one-card mesh and
   with the 2-slot mesh; ``track_video`` unsharded and over a 2-slot frame
   mesh;
10. the benchmark and the stage tools, each in its own process with a time
   limit: ``bench_torch.py --repeat 4 --videos16 0`` must exit 0 with its
   JSON line (under 2000 characters, the headline keys last) naming this
   card, positive ``value``, ``device_compute_fps`` and ``vs_baseline``,
   every library group ``"fused"``, and the kernels launched exactly as
   each route launches them, (band, scan): the per-file loop (8, 8), the
   library (4, 4), device compute (1, 1); ``tools/stage_profile_torch.py
   --repeat 2 --trace`` ((1, 1) per file, (4, 4) over the library; the
   profiled run's idle share and top kernels printed) and
   ``tools/pipeline_trace_torch.py --groups 1 4 --trace`` over the same
   library shape, 8 x 2048 frames of 128x1024 (rows identical across G,
   G launches of each kernel, the timeline, idle share and top kernels).

It prints, before the last line, a JSON object with one entry per kernel,
and as the last line ``{"ok": true, "device": {...}}``. It exits non-zero,
printing no result, when CUDA is unavailable or the port is not beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Main-path shapes: bench.py's default recording.
N_FRAMES, HEIGHT, WIDTH = 2048, 128, 1024
TOL = dict(atol=1e-4, rtol=1e-5)  # the Pallas kernel's bar against jnp
GPU = "cuda"


def log(*args):
    print(*args, flush=True)


def card_info():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, repeats=5):
    """Median over ``repeats`` of the mean CUDA-event time of ``iters`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def band_case(rng, n, k, sigma, w):
    """Integer-valued 12-bit bands, with a -1 prior and non-adjacent priors."""
    import numpy as np

    from hsip_tpu_torch.kernels.preprocess import band_margin

    b = 2 * band_margin(k, sigma) + 1
    band = rng.integers(0, 4096, (n, b, w), dtype=np.int16).astype(np.float32)
    prior = np.arange(-1, n - 1, dtype=np.int32)
    if n > 8:
        prior[5] = -1
        prior[7] = 2
        prior[n - 1] = n // 3
    return band, prior


def check_band_kernel(dev, rng):
    """Phase 3: returns the largest abs diff over the sweep, which must be
    bit-equal. The config default (3, 1.5) runs both instantiations: its
    own and, through the probe entry, the one with runtime counts."""
    import numpy as np
    import torch

    from hsip_tpu_torch.kernels.cuda_preprocess import (
        band_profiles_plain,
        band_profiles_probe,
        cuda_band_profiles,
    )

    def runtime_counts(*args):
        return band_profiles_probe(*args, runtime_counts=True)[0]

    worst_abs = worst_rel = 0.0
    all_equal = True
    cases = 0
    for k, sigma, kernel in ((3, 1.5, cuda_band_profiles), (3, 1.5, runtime_counts),
                             (2, 1.5, cuda_band_profiles), (5, 2.0, cuda_band_profiles),
                             (3, 3.0, cuda_band_profiles)):
        for w in (1024, 1000, 250, 136, 129):
            for n in (1, 37, 4096):
                cases += 1
                band, prior = band_case(rng, n, k, sigma, w)
                band_t = torch.from_numpy(band).to(dev)
                prior_t = torch.from_numpy(prior).to(dev)
                got = kernel(band_t, prior_t, 5.0, k, sigma)
                want = band_profiles_plain(band_t, prior_t, 5.0, k, sigma)
                torch.cuda.synchronize()
                for g, r in zip(got, want):
                    torch.testing.assert_close(g, r, **TOL)
                    d = (g - r).abs()
                    worst_abs = max(worst_abs, float(d.max()))
                    worst_rel = max(worst_rel, float((d / r.abs().clamp_min(1e-30)).max()))
                    all_equal = all_equal and bool(torch.equal(g, r))
                del band_t, got, want
    # A library group's batch: 4 videos of 37 frames, flat, each video's
    # first row without a prior, every other row's prior the row before.
    cases += 1
    n = 4 * 37
    band, _ = band_case(rng, n, 3, 1.5, 1024)
    flat = np.arange(n, dtype=np.int32)
    prior = np.where(flat % 37 > 0, flat - 1, -1).astype(np.int32)
    assert [int(i) for i in np.flatnonzero(prior < 0)] == [0, 37, 74, 111]
    band_t, prior_t = torch.from_numpy(band).to(dev), torch.from_numpy(prior).to(dev)
    got = cuda_band_profiles(band_t, prior_t, 5.0, 3, 1.5)
    want = band_profiles_plain(band_t, prior_t, 5.0, 3, 1.5)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        worst_abs = max(worst_abs, float((g - r).abs().max()))
        all_equal = all_equal and bool(torch.equal(g, r))
    log(f"band kernel vs plain: {cases} cases, max abs {worst_abs:.3e}, "
        f"max rel {worst_rel:.3e}, bit-equal: {all_equal}")
    if not all_equal:
        raise AssertionError("band kernel is not bit-equal to its plain version")
    return worst_abs


def planted_profiles(rng, m, w):
    """Integer-valued profiles with planted ties (equal gradient minima,
    equal |sobel| maxima, flat peaks)."""
    import numpy as np

    sob = np.round(rng.normal(0, 30, (m, w))).astype(np.float32)
    grad = np.round(rng.normal(0, 15, (m, w))).astype(np.float32)
    intens = np.abs(np.round(rng.normal(40, 30, (m, w)))).astype(np.float32)
    for j in range(m):
        a, b = sorted(rng.choice(np.arange(12, w - 12), 2, replace=False))
        grad[j, a] = grad[j, b] = -80.0
        sob[j, a] = -sob[j, b] if sob[j, b] else 90.0
        intens[j, a:a + 4] = intens[j].max()
    return sob, grad, intens


def scan_inputs(profiles, empty, dev):
    """(V=1) scan tensors from map-phase profiles (tensors on ``dev``)."""
    import numpy as np
    import torch

    return (
        torch.from_numpy(profiles.frame_indices.astype(np.int32))[None].to(dev),
        profiles.sobel_lines[None],
        profiles.gradient_lines[None],
        torch.from_numpy(np.asarray(empty, bool))[None].to(dev),
        torch.from_numpy(profiles.has_prior)[None].to(dev),
        profiles.intensity_lines[None],
    )


def check_scan_kernel(dev, rng, real_profiles, real_empty, params_for):
    """Phase 4: all nine fields equal, four methods, three profile sets."""
    import numpy as np
    import torch

    from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan
    from hsip_tpu_torch.track.device_scan import METHODS, tracking_scan_plain

    m, w = N_FRAMES, WIDTH
    sob, grad, intens = (torch.from_numpy(x)[None].to(dev)
                         for x in planted_profiles(rng, m, w))
    empty = torch.from_numpy(rng.random((1, m)) < 0.05).to(dev)
    prior = torch.ones((1, m), dtype=torch.bool, device=dev)
    prior[0, 0] = False
    fidx = torch.from_numpy(np.cumsum(rng.integers(1, 3, m)).astype(np.int32))[None].to(dev)
    worst = 0
    four = four_videos(rng, real_profiles, real_empty, dev)
    sets = {"random+ties": (fidx, sob, grad, empty, prior, intens),
            "recording": scan_inputs(real_profiles, real_empty, dev),
            "4 videos": four,
            "4 ragged": ragged(four, (m, 1500, 37, 1))}
    for label, (fi, s, g, em, hp, it) in sets.items():
        for method in METHODS:
            params = params_for(method)
            if label.startswith("4 "):
                params = four_video_params(params)
            kw = dict(width=w, intensity_lines=it, **params)
            got = cuda_tracking_scan(fi, s, g, em, hp, **kw)
            want = tracking_scan_plain(fi, s, g, em, hp, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip(got._fields, got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"scan kernel != plain: {label} {method} {name}")
                diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
                worst = max(worst, int(diff.max()) if diff.numel() else 0)
            log(f"scan kernel vs plain: {label:12s} {method:13s} 9/9 fields equal, "
                f"{int((got.final_position >= 0).sum())} detections")
    return float(worst)


def ragged(videos, lengths):
    """The (V, ...) scan tensors as a library group pads them: video i has
    ``lengths[i]`` frames, and the rows past them are empty."""
    fi, s, g, em, hp, it = videos
    em = em.clone()
    for i, n in enumerate(lengths):
        em[i, n:] = True
    return fi, s, g, em, hp, it


def four_video_params(params, copies=1):
    """Scan parameters of the V = 4 case: per-video calibration, frame rate
    and displacement cap, the first video's those of ``params`` (the
    recording's own); the four tiled ``copies`` times."""
    import numpy as np

    def per_video(first, rest, dtype):
        return np.tile(np.array([first, *rest], dtype), copies)

    return dict(
        params,
        calibration=per_video(params["calibration"], (0.001, 0.0005, 0.002), np.float32),
        frame_rate=per_video(params["frame_rate"], (50_000, 20_000, 80_000), np.float32),
        max_displacement_px=per_video(params["max_displacement_px"], (5, 8, 40), np.int32),
    )


def four_videos(rng, real_profiles, real_empty, dev):
    """(V=4) scan tensors: the recording's profiles and three planted sets,
    each with its own frame indices, empty frames and priors."""
    import numpy as np
    import torch

    m, w = N_FRAMES, WIDTH
    real = [t[0].cpu().numpy() for t in scan_inputs(real_profiles, real_empty, dev)]
    sets = [real]
    for _ in range(3):
        sob, grad, intens = planted_profiles(rng, m, w)
        fidx = np.cumsum(rng.integers(1, 4, m)).astype(np.int32)
        empty = rng.random(m) < 0.05
        prior = np.ones(m, bool)
        prior[0] = False
        sets.append([fidx, sob, grad, empty, prior, intens])
    return tuple(torch.from_numpy(np.stack([s[i] for s in sets])).to(dev)
                 for i in range(6))


# ---- bounds: the least time the card could take for the same work ----
# NVIDIA H100 SXM, published peaks: HBM3 3.35 TB/s; float32 outside the
# tensor cores 67 TFLOP/s.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, ops / FP32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def band_bound(n, b, w, k, ntaps):
    """Band kernel: the (N, B, W) band and (N,) priors read once, three
    (N, W) lines written once. Operations per band element: subtract and
    threshold (2), separable erosion and dilation (4(k-1) compares), the
    two-pass Gaussian (2(2*ntaps-1)); per output column Sobel and gradient
    (7)."""
    bytes_moved = 4 * (n * b * w + n + 3 * n * w + ntaps)
    ops = n * b * w * (2 + 4 * (k - 1) + 2 * (2 * ntaps - 1)) + 7 * n * w
    return bound(bytes_moved, ops)


def scan_bound(res, width, method):
    """Scan kernel: each input it needs read once, each output written
    once. A step needs only its window's columns of the rows the method
    reads, so the rows count over this run's windows (the outputs' search
    bounds), as the operations do: about 10 per window column for
    'combined' (two rows), 6 for the named methods. Then the per-frame
    indices and flags and the per-video parameters."""
    import torch

    v, m = res.final_position.shape
    nrows = 2 if method == "combined" else 1
    lo = res.search_start.clamp(0, width).to(torch.int64)
    hi = res.search_end.clamp(0, width).to(torch.int64)
    cols = int((hi - lo).clamp_min(0).sum())
    bytes_moved = (4 * nrows * cols + 6 * v * m            # window rows, index, flags
                   + 14 * v * m + 16 * v + 12 * v)         # outputs, latches, params
    return bound(bytes_moved, cols * (10 if nrows == 2 else 6))


def write_bench_recording(directory):
    """bench.py's recording: seed 42, the front crossing ~77% of the image."""
    from hsip_tpu_torch.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording

    flame = FlameSpec(x0=30.0, v0_px=WIDTH / (1.3 * N_FRAMES), accel_px=0.0,
                      ignition_frame=2, seed=42)
    frames, positions = synthesize_flame_video(N_FRAMES, height=HEIGHT,
                                               width=WIDTH, flame=flame)
    spec = CihxSpec(width=WIDTH, height=HEIGHT, total_frames=N_FRAMES,
                    record_rate=100_000, bit_depth=12)
    return write_recording(directory, "bench-run-1-001", frames, spec=spec), positions


def write_golden_recording(directory):
    """The recording of tests/test_golden.py."""
    from hsip_tpu_torch.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording

    flame = FlameSpec(x0=30.0, v0_px=8.0, accel_px=0.3, ignition_frame=3,
                      ddt_frame=28, v_jump_px=25.0, seed=77)
    frames, _ = synthesize_flame_video(60, height=48, width=512, flame=flame)
    spec = CihxSpec(width=512, height=48, total_frames=60, record_rate=100_000,
                    bit_depth=12, start_frame=-10)
    return write_recording(directory, "golden-run-1-001", frames, spec=spec)


def source_config(out_dir):
    from hsip_tpu_torch.track.config import FileCalibration, VideoSourceConfig

    cfg = VideoSourceConfig(name="smoke", save_frame_images=False,
                            save_stacked_sequences=False)
    cfg.output_dir = str(out_dir)
    cfg.file_calibrations = [
        FileCalibration(calibration=0.000833333, position_offset=1.0159,
                        files=["run-1-"]),
    ]
    return cfg


def run_file(meta, out_dir, backend, device):
    """One process_video_file run; (output, wall seconds, tables)."""
    import torch

    from hsip_tpu_torch.pipeline import process_video_file

    t0 = time.perf_counter()
    out = process_video_file(meta, source_config(out_dir), backend=backend,
                             verbose=False, save_images=False, device=device)
    if torch.device(device).type != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, tables_of(out_dir)


def link_recording(meta, directory, stem):
    """``meta``'s recording under another name: the header copied, the
    payload hard-linked (bench.py's way to a library of one payload)."""
    import os
    import shutil

    directory.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(meta, directory / f"{stem}.cihx")
    os.link(Path(meta).with_suffix(".mraw"), directory / f"{stem}.mraw")
    return directory / f"{stem}.cihx"


def write_short_recording(directory):
    """512 frames of the bench shape, dark until frame 128."""
    from hsip_tpu_torch.io import CihxSpec, FlameSpec, synthesize_flame_video, write_recording

    n = 512
    flame = FlameSpec(x0=30.0, v0_px=WIDTH / (1.3 * (n - 128)), accel_px=0.0,
                      ignition_frame=128, seed=43)
    frames, _ = synthesize_flame_video(n, height=HEIGHT, width=WIDTH, flame=flame)
    spec = CihxSpec(width=WIDTH, height=HEIGHT, total_frames=n,
                    record_rate=100_000, bit_depth=12)
    return write_recording(directory, "short-run-1-001", frames, spec=spec)


def library_source(video_dir, out_dir):
    cfg = source_config(out_dir)
    cfg.video_path = str(video_dir)
    return cfg


def tables_of(out_dir):
    return {p.name: p.read_bytes() for p in sorted(Path(out_dir).glob("*.txt"))}


def env_set(**values):
    """Set (or, with None, unset) environment switches; returns the old ones."""
    import os

    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def run_library(video_dir, out_dir, resume=False, mesh=None, **env):
    """One process_video_source_library run on the card (over ``mesh``
    when given) under the given environment switches; (outputs, wall
    seconds, tables, group paths, clipped, pipeline trace)."""
    import contextlib
    import io

    import torch

    from hsip_tpu_torch.pipeline import process_video_source_library
    from hsip_tpu_torch.track import batch, fused

    old = env_set(**env)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # calibration warnings
            outs = process_video_source_library(
                library_source(video_dir, out_dir), verbose=False, resume=resume,
                mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        env_set(**old)
    return (outs, wall, tables_of(out_dir), list(batch.LAST_GROUP_PATHS),
            fused._LAST_CLIPPED, [dict(t) for t in fused._LAST_PIPELINE_TRACE])


def run_loop(video_dir, out_dir):
    """The per-file source runner (backend 'device') on the card;
    (outputs, wall seconds, tables)."""
    import contextlib
    import io

    import torch

    from hsip_tpu_torch.pipeline import process_video_source

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        outs = process_video_source(library_source(video_dir, out_dir),
                                    backend="device", verbose=False)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, tables_of(out_dir)


def library_phase(tmp, meta, golden_meta, card, config):
    """Phase 7. Returns the launch counts of the library run (band, scan,
    scan videos) and what it measured."""
    import torch

    from hsip_tpu_torch import open_collection
    from hsip_tpu_torch.kernels.cuda_preprocess import cuda_band_profiles
    from hsip_tpu_torch.kernels.preprocess import band_margin
    from hsip_tpu_torch.track import batch, fused
    from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan
    from hsip_tpu_torch.utils import StageTimes

    t0 = time.perf_counter()
    lib, lib8 = tmp / "lib", tmp / "lib8"
    for i in range(8):
        # lib-run-1-00x matches the source's "run-1-" calibration, the
        # other half takes the default: per-video calibrations differ.
        stem = f"lib-run-{1 if i < 4 else 2}-{i % 4 + 1:03d}"
        link_recording(meta, lib, stem)
        link_recording(meta, lib8, stem)
    short_meta = write_short_recording(tmp / "short")
    link_recording(short_meta, lib, short_meta.stem)
    link_recording(golden_meta, lib, Path(golden_meta).stem)
    names = sorted(p.name for p in lib.glob("*.cihx"))
    log(f"library of {len(names)} recordings built in {time.perf_counter() - t0:.2f} s")

    # The per-file 'device' run on the card of every recording, each under
    # its own name: what every library table must equal.
    want = {}
    for name in names:
        _, _, tables = run_file(lib / name, tmp / "lib-per-file", "device", GPU)
        want = tables
    golden = (REPO / "tests" / "golden" / "golden-run-1-001-flame-position.txt").read_bytes()
    if want.get("golden-run-1-001-flame-position.txt") != golden:
        raise AssertionError("per-file golden table differs from tests/golden/")
    if len({want[f"lib-run-{r}-001-flame-position.txt"] for r in (1, 2)}) != 2:
        raise AssertionError("the two calibrations wrote the same table")

    # ---- the main path: one library run, the counts set to 0 just before
    cuda_band_profiles.launches = 0
    cuda_tracking_scan.launches = 0
    cuda_tracking_scan.videos = 0
    outs, first_s, tables, paths, clipped, trace = run_library(lib, tmp / "lib-out")
    counts = (cuda_band_profiles.launches, cuda_tracking_scan.launches,
              cuda_tracking_scan.videos)
    n_groups = len(trace) + 1  # the last shape group's trace, and the other group
    log(f"library: {len(outs)} recordings, group paths {paths}, launches: band "
        f"{counts[0]}, scan {counts[1]} over {counts[2]} videos; clip engaged: {clipped}; "
        f"first run {first_s:.4f} s")
    if len(outs) != len(names) or paths != ["fused"] * len(paths) or len(paths) != 2:
        raise AssertionError(f"library run did not fuse both shape groups: {paths}")
    if counts[0] < n_groups or counts[1] < n_groups or counts[2] <= counts[1]:
        raise AssertionError(f"library launches {counts}: expected at least one per "
                             f"group ({n_groups}) and a scan launch with V > 1")
    if tables != want or tables.get("golden-run-1-001-flame-position.txt") != golden:
        raise AssertionError("library tables differ from the per-file device tables")
    summary = (tmp / "lib-out" / "run-summary.json").read_bytes()

    # ---- resume: nothing to do, nothing touched
    r_outs, _, r_tables, *_ = run_library(lib, tmp / "lib-out", resume=True)
    if r_outs or r_tables != tables or \
            (tmp / "lib-out" / "run-summary.json").read_bytes() != summary:
        raise AssertionError("resume=True reprocessed or rewrote a finished library")

    # ---- the switches: same tables on every route
    for label, env, want_path, want_clip in (
            ("HSIP_FUSED=0", dict(HSIP_FUSED="0"), "chunked", None),
            ("HSIP_FUSED_GROUPS=1", dict(HSIP_FUSED_GROUPS="1"), "fused", None),
            ("HSIP_CLIP_EMPTY=off", dict(HSIP_CLIP_EMPTY="off"), "fused", False),
            ("HSIP_CLIP_EMPTY=1", dict(HSIP_CLIP_EMPTY="1"), "fused", True)):
        _, wall, t, p, c, tr = run_library(lib, tmp / f"lib-{label}", **env)
        log(f"library with {label}: paths {p}, clip engaged: {c}, "
            f"{len(tr)} group(s) in the last shape group, {wall:.4f} s")
        if p != [want_path] * 2 or (want_clip is not None and c != want_clip):
            raise AssertionError(f"{label}: paths {p}, clipped {c}")
        if t != tables:
            raise AssertionError(f"{label}: tables differ from the fused run's")
    log(f"library tables ({len(tables)} files) byte-identical to the per-file device "
        f"run on the card, on the chunked path, with one group, with the clip off "
        f"and forced; golden table equal to tests/golden/; resume processed nothing")

    # ---- times: the per-file source runner against library mode, the 8
    # full recordings, in turns; the first pair is the warm-up.
    frames = 8 * N_FRAMES
    loops, libs = [], []
    for i in range(4):
        loop = run_loop(lib8, tmp / f"t-loop-{i}")
        # The run's own peak: over what the earlier phases still hold.
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = run_library(lib8, tmp / f"t-lib-{i}")
        peak = torch.cuda.max_memory_allocated() - held
        if loop[2] != run[2] or len(run[2]) < 8:
            raise AssertionError("library and per-file loop wrote different tables")
        if i:
            loops.append(loop[1])
            libs.append((run[1], run[5], run[4], peak))
    loop_s = statistics.median(loops)
    lib_s, trace, clipped, peak = sorted(libs, key=lambda r: r[0])[1]
    margin = band_margin(config.morphology_kernel_size, config.gaussian_sigma)
    estimate = fused._fused_budget_bytes(8, N_FRAMES, WIDTH, 2 * margin + 1, 12,
                                         fused._fused_group_count(8))
    limit = fused._fused_limit_bytes(torch.device(GPU))
    log(f"[{card}] per-file loop over 8 x {N_FRAMES} frames (process_video_source, "
        f"backend=device): {frames / loop_s:.1f} frames/s, {loop_s:.4f} s "
        f"(median of 3 warm runs: {', '.join(f'{x:.4f}' for x in loops)})")
    log(f"[{card}] library over the same 8 (process_video_source_library): "
        f"{frames / lib_s:.1f} frames/s, {lib_s:.4f} s (median of 3 warm runs: "
        f"{', '.join(f'{x[0]:.4f}' for x in libs)}); {loop_s / lib_s:.2f}x the loop; "
        f"clip engaged: {clipped}")
    log(f"[{card}] library peak device memory {peak} bytes over the {held} held "
        f"before the run; the fused budget's estimate {estimate} bytes "
        f"({peak / estimate:.2f}x); limit {limit} bytes")
    t_first = trace[0]["gather_start_t"]
    for g, t in enumerate(trace):
        stamps = ", ".join(f"{k[:-2]} {1e3 * (t[k] - t_first):.1f}" for k in (
            "gather_start_t", "gather_end_t", "dispatch_t", "inputs_ready_t",
            "finals_ready_t"))
        log(f"[{card}] library group {g} (ms from the first gather): {stamps}")
    # Fused against chunked over the same 8, in turns, 5 warm runs each.
    pair = {"fused": [], "chunked": []}
    for i in range(5):
        for route, env in (("fused", {}), ("chunked", dict(HSIP_FUSED="0"))):
            run = run_library(lib8, tmp / f"t-{route}-{i}", **env)
            if run[3] != [route] or run[2] != loop[2]:
                raise AssertionError(f"{route} run {i}: paths {run[3]} or other tables")
            pair[route].append(run[1])
    fused_s, chunked_s = (statistics.median(pair[r]) for r in ("fused", "chunked"))
    log(f"[{card}] library over the 8, fused against chunked (HSIP_FUSED=0) in "
        f"turns, median of 5 warm runs each: fused {fused_s:.4f} s "
        f"({', '.join(f'{x:.4f}' for x in pair['fused'])}); chunked {chunked_s:.4f} s "
        f"({', '.join(f'{x:.4f}' for x in pair['chunked'])}); "
        f"chunked / fused {chunked_s / fused_s:.3f}")
    # The host-side stages of one more library run, without the runner
    # around it (no table files, no ledger).
    stages = StageTimes()
    with open_collection(str(lib8)) as coll:
        t0 = time.perf_counter()
        batch.track_collection_device(coll, config, source_config=source_config(tmp / "x"),
                                      stage_times=stages)
        torch.cuda.synchronize()
        track_s = time.perf_counter() - t0
    log(f"[{card}] library track_collection_device alone {track_s:.4f} s; "
        f"StageTimes (host seconds) {stages.as_dict()}")
    want8 = {name: data for name, data in want.items() if name.startswith("lib-run-")}
    return counts, dict(loop_s=loop_s, lib_s=lib_s, peak=peak, estimate=estimate,
                        fused_s=fused_s, chunked_s=chunked_s), lib8, want8


def cli_config(tmp, video_dir, tag):
    """A JSON run config for ``--config``: phase 7's source (two
    calibrations by file name) writing into its own output directory."""
    out_dir = tmp / f"cli-{tag}"
    path = tmp / f"cli-{tag}.json"
    path.write_text(json.dumps({"source": [{
        "name": "smoke", "video_path": str(video_dir), "output_dir": str(out_dir),
        "file_calibration": [{"calibration": 0.000833333, "position_offset": 1.0159,
                              "files": ["run-1-"]}],
    }]}))
    return path, out_dir


def run_cli(argv):
    """``hsip_tpu_torch.cli.main(argv)`` on the card; (exit code, wall
    seconds, stdout, stderr)."""
    import contextlib
    import io

    import torch

    from hsip_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t0, out.getvalue(), err.getvalue()


def assert_refused(directory, argv, text):
    """``hsip-torch argv``, run from the new empty ``directory`` (where a
    run would write ./hsip-output), must return 2 with ``text`` on stderr
    and write nothing."""
    import os

    directory.mkdir()
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        rc, _, _, err = run_cli(argv)
    finally:
        os.chdir(cwd)
    if rc != 2 or text not in err or list(directory.iterdir()):
        raise AssertionError(f"hsip-torch {argv[2:]} returned {rc}, wrote "
                             f"{list(directory.iterdir())}: {err[-500:]}")


# One rank of a two-rank run: ``main`` once per config file (the first run
# counted, the later ones warm), then one line with what this rank saw.
_RANK_PROGRAM = r"""
import json, sys, time
import torch
from hsip_tpu_torch.cli import main
from hsip_tpu_torch.kernels.cuda_preprocess import cuda_band_profiles
from hsip_tpu_torch.track import batch
from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan

n_configs = int(sys.argv[1])
configs, flags = sys.argv[2:2 + n_configs], sys.argv[2 + n_configs:]
report = {"rcs": [], "walls": []}
for i, config in enumerate(configs):
    t0 = time.perf_counter()
    report["rcs"].append(main(["--config", config, *flags]))
    torch.cuda.synchronize()
    report["walls"].append(time.perf_counter() - t0)
    if i == 0:
        report.update(band=cuda_band_profiles.launches, scan=cuda_tracking_scan.launches,
                      videos=cuda_tracking_scan.videos, paths=list(batch.LAST_GROUP_PATHS),
                      device=torch.cuda.current_device())
print("RANK_REPORT " + json.dumps(report), flush=True)
sys.exit(max(report["rcs"]))
"""


def run_two_ranks(configs, flags, timeout_s=300):
    """Two processes that share the card, each running the command line
    with ``--distributed`` over a gloo group on 127.0.0.1; returns each
    rank's report and stdout, and the wall from launch to exit."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join(
        x for x in (str(REPO), env.get("PYTHONPATH")) if x)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROGRAM, str(len(configs)), *map(str, configs),
         *flags, "--distributed", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(REPO)) for rank in range(2)]
    results = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout_s)
            if proc.returncode != 0:
                raise AssertionError(
                    f"rank {rank} exited {proc.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
            line = [x for x in out.splitlines() if x.startswith("RANK_REPORT ")][-1]
            results.append((json.loads(line[len("RANK_REPORT "):]), out))
    finally:
        for proc in procs:  # no rank outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
    return results, time.perf_counter() - t0


def rank_files(out_dir):
    """The recordings each rank's run summary lists (rank 0, rank 1)."""
    return [sorted(f["file"] for f in json.loads((out_dir / name).read_text())["files"])
            for name in ("run-summary.json", "run-summary.rank1.json")]


def cli_phase(tmp, meta, lib8, want8, card):
    """Phase 8. Returns the launch counts of the per-file and the library
    run through the command line, and the walls it measured."""
    from hsip_tpu_torch.kernels.cuda_preprocess import cuda_band_profiles
    from hsip_tpu_torch.track import batch
    from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan

    quiet = ["--no-images", "--no-sequences", "--quiet"]
    names = sorted(x.name for x in lib8.glob("*.cihx"))

    def counted(tag, *flags):
        config, out_dir = cli_config(tmp, lib8, tag)
        cuda_band_profiles.launches = 0
        cuda_tracking_scan.launches = 0
        cuda_tracking_scan.videos = 0
        rc, wall, out, err = run_cli(["--config", str(config), *quiet, *flags])
        counts = (cuda_band_profiles.launches, cuda_tracking_scan.launches,
                  cuda_tracking_scan.videos)
        if rc != 0 or "Processing complete!" not in out:
            raise AssertionError(f"hsip-torch {flags} returned {rc}: {err[-2000:]}")
        if tables_of(out_dir) != want8:
            raise AssertionError(f"hsip-torch {flags}: tables differ from the "
                                 f"per-file device run's")
        return counts, wall

    # ---- per file: the auto backend without figures is 'device', so both
    # kernels run once a file (the 'gpu' backend launches no scan kernel).
    file_counts, file_first_s = counted("file")
    log(f"hsip-torch per file over {len(names)} recordings: launches band "
        f"{file_counts[0]}, scan {file_counts[1]} over {file_counts[2]} videos; "
        f"first run {file_first_s:.4f} s")
    if file_counts != (len(names),) * 3:
        raise AssertionError(f"per-file CLI launches {file_counts}: expected both "
                             f"kernels once a file ({len(names)})")

    # ---- --library: fused, the scan with V > 1
    lib_counts, lib_first_s = counted("library", "--library")
    paths = list(batch.LAST_GROUP_PATHS)
    log(f"hsip-torch --library: group paths {paths}, launches band {lib_counts[0]}, "
        f"scan {lib_counts[1]} over {lib_counts[2]} videos; first run {lib_first_s:.4f} s")
    if not paths or paths != ["fused"] * len(paths):
        raise AssertionError(f"hsip-torch --library did not fuse: {paths}")
    if lib_counts[0] < 1 or lib_counts[1] < 1 or lib_counts[2] != len(names) \
            or lib_counts[2] <= lib_counts[1]:
        raise AssertionError(f"library CLI launches {lib_counts}: expected both kernels "
                             f"and a scan launch with V > 1 over {len(names)} videos")

    # ---- a refusal: exit 2, nothing written
    assert_refused(tmp / "cli-refused",
                   ["--video-path", str(lib8), *quiet, "--device", "cuda:99"],
                   "--device cuda:99")
    log("hsip-torch --device cuda:99: exit 2, nothing written")

    # ---- --profile-dir on one recording
    trace_dir = tmp / "cli-trace"
    rc, wall, _, err = run_cli(["--video-path", str(Path(meta).parent), "--output-dir",
                                str(tmp / "cli-profiled"), *quiet,
                                "--profile-dir", str(trace_dir)])
    traces = sorted(trace_dir.glob("*.json"))
    if rc != 0 or len(traces) != 1 or traces[0].stat().st_size == 0:
        raise AssertionError(f"--profile-dir: exit {rc}, traces {traces}: {err[-500:]}")
    text = traces[0].read_text()
    log(f"hsip-torch --profile-dir on one {N_FRAMES}-frame recording: {traces[0].name}, "
        f"{traces[0].stat().st_size} bytes, {wall:.4f} s; names the band kernel: "
        f"{'band_profiles_kernel' in text}, the scan kernel: "
        f"{'tracking_scan_kernel' in text}")
    del text

    # ---- two ranks that share the card, per file and with --library; the
    # first run of each rank is checked, three more are timed.
    two = {}
    for tag, flags in (("ranks-file", []), ("ranks-library", ["--library"])):
        runs = [cli_config(tmp, lib8, f"{tag}-{i}") for i in range(4)]
        results, outer_s = run_two_ranks([c for c, _ in runs], [*quiet, *flags])
        mine, theirs = rank_files(runs[0][1])
        if set(mine) & set(theirs) or sorted(mine + theirs) != names \
                or len(mine) != len(theirs):
            raise AssertionError(f"{tag}: ranks took {mine} and {theirs}")
        for rank, (report, out) in enumerate(results):
            share = len(mine if rank == 0 else theirs)
            ok = (report["band"] >= 1 and report["scan"] >= 1
                  and report["videos"] == share and set(report["rcs"]) == {0})
            if not flags:
                ok = ok and report["band"] == report["scan"] == share
            else:
                ok = ok and report["paths"] == ["fused"] * len(report["paths"]) \
                    and report["paths"]
            if not ok or ("Processing complete!" in out) != (rank == 0):
                raise AssertionError(f"{tag}: rank {rank} reported {report}")
        for _, out_dir in runs:
            if tables_of(out_dir) != want8:
                raise AssertionError(f"{tag}: tables differ from the per-file device run's")
        # Both ranks leave main through one barrier: a run's wall is the
        # slower rank's.
        walls = [max(a, b) for a, b in zip(results[0][0]["walls"], results[1][0]["walls"])]
        two[tag] = dict(first_s=walls[0], warm=walls[1:], outer_s=outer_s,
                        launches=[(r["band"], r["scan"], r["videos"]) for r, _ in results])
        log(f"hsip-torch two ranks on cuda:{results[0][0]['device']}/"
            f"cuda:{results[1][0]['device']}, {'--library' if flags else 'per file'}: "
            f"rank 0 took {len(mine)}, rank 1 {len(theirs)} recordings; launches "
            f"(band, scan, videos) {two[tag]['launches']}; tables byte-identical")

    # ---- times: each route beside the direct runner on the same bytes, in
    # turns; the first round is the warm-up.
    frames = len(names) * N_FRAMES
    walls = {"loop": [], "cli-file": [], "library": [], "cli-library": []}
    for i in range(4):
        round_ = {"loop": run_loop(lib8, tmp / f"t8-loop-{i}")[1]}
        config, _ = cli_config(tmp, lib8, f"t-file-{i}")
        round_["cli-file"] = run_cli(["--config", str(config), *quiet])[1]
        round_["library"] = run_library(lib8, tmp / f"t8-lib-{i}")[1]
        config, _ = cli_config(tmp, lib8, f"t-library-{i}")
        round_["cli-library"] = run_cli(["--config", str(config), *quiet, "--library"])[1]
        if i:
            for key, wall in round_.items():
                walls[key].append(wall)
    med = {key: statistics.median(runs) for key, runs in walls.items()}
    for cli, direct, what in (("cli-file", "loop", "per file"),
                              ("cli-library", "library", "--library")):
        log(f"[{card}] hsip-torch {what} over 8 x {N_FRAMES} frames: {med[cli]:.4f} s, "
            f"{frames / med[cli]:.1f} frames/s (median of 3 warm runs: "
            f"{', '.join(f'{x:.4f}' for x in walls[cli])}); the direct runner in turns "
            f"{med[direct]:.4f} s ({', '.join(f'{x:.4f}' for x in walls[direct])}); "
            f"CLI / runner {med[cli] / med[direct]:.3f}")
    for tag, what, one in (("ranks-file", "per file", "cli-file"),
                           ("ranks-library", "--library", "cli-library")):
        t = two[tag]
        m = statistics.median(t["warm"])
        log(f"[{card}] hsip-torch two ranks on one card, {what}: {m:.4f} s, "
            f"{frames / m:.1f} frames/s (median of 3 warm runs in the ranks' processes: "
            f"{', '.join(f'{x:.4f}' for x in t['warm'])}; first run {t['first_s']:.4f} s; "
            f"launch to exit of all four runs {t['outer_s']:.2f} s); one process "
            f"{med[one]:.4f} s; one / two {med[one] / m:.3f}")
    return file_counts, lib_counts, dict(
        med, ranks_file_s=statistics.median(two["ranks-file"]["warm"]),
        ranks_library_s=statistics.median(two["ranks-library"]["warm"]),
        ranks_file_launches=two["ranks-file"]["launches"],
        ranks_library_launches=two["ranks-library"]["launches"])


def counters_zero():
    from hsip_tpu_torch.kernels.cuda_preprocess import cuda_band_profiles
    from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan

    cuda_band_profiles.launches = 0
    cuda_tracking_scan.launches = 0
    cuda_tracking_scan.videos = 0


def counters():
    """(band launches, scan launches, scan videos) since counters_zero()."""
    from hsip_tpu_torch.kernels.cuda_preprocess import cuda_band_profiles
    from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan

    return (cuda_band_profiles.launches, cuda_tracking_scan.launches,
            cuda_tracking_scan.videos)


def track_tables(video, config, meta, out_dir, **kw):
    """``track_video`` as ``process_video_file`` calls it for phase 5's
    source (its calibration by file name), then its tables written by the
    pipeline's writer; (tables, wall seconds)."""
    import torch

    from hsip_tpu_torch.pipeline import _write_ddt_split_tables
    from hsip_tpu_torch.track.scan import track_video

    cal, off = source_config(out_dir).get_calibration_for_file(Path(meta).name)
    t0 = time.perf_counter()
    out = track_video(video, config, cal, off, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out_dir.mkdir(parents=True)
    _write_ddt_split_tables(out, out_dir, Path(meta).stem, False)
    return tables_of(out_dir), wall


def check_sharded_chain(dev, rng, config):
    """The sharded band chain (halo copies, one band kernel launch a slot)
    with two slots on the card against the same bands on two CPU slots
    (the plain chain), at the map phase's shapes: 2 × 512 frames, B=19,
    W=1024. Returns the largest abs difference; fails unless bit-equal."""
    import torch

    from hsip_tpu_torch.parallel.sharding import shard_band_profiles

    k, sigma = config.morphology_kernel_size, config.gaussian_sigma
    band, _ = band_case(rng, 2 * 512, k, sigma, WIDTH)
    halo = torch.zeros((1,) + band.shape[1:])
    outs = {}
    for where in (dev, torch.device("cpu")):
        bands = [torch.cat([halo, torch.from_numpy(part)]).to(where)
                 for part in (band[:512], band[512:])]
        outs[where.type] = shard_band_profiles(
            bands, 5.0, morphology_kernel_size=k, gaussian_sigma=sigma)
    torch.cuda.synchronize()
    worst = 0.0
    for got, want in zip(outs["cuda"], outs["cpu"]):
        for a, b in zip(got, want):
            worst = max(worst, float((a.cpu() - b).abs().max()))
            if not torch.equal(a.cpu(), b):
                raise AssertionError("sharded band chain on the card != plain on CPU slots")
    return worst


def mesh_phase(tmp, meta, lib8, want8, dev_tables, card, config, rng):
    """Phase 9. Returns the launch counts of the mesh routes and what it
    measured."""
    import numpy as np
    import torch

    from hsip_tpu_torch import open_video
    from hsip_tpu_torch.parallel import make_mesh, video_frame_mesh
    from hsip_tpu_torch.parallel.dryrun import (
        build_multichip_step,
        run_multichip_dryrun,
        run_pipeline_dryrun,
    )
    from hsip_tpu_torch.track.scan import _compute_profiles_sharded, compute_profiles_batched
    from hsip_tpu_torch.utils import StageTimes

    gpu = torch.device(GPU, 0)
    chunk = N_FRAMES // 2
    lines = ("sobel_lines", "gradient_lines", "intensity_lines", "raw_center_lines")

    # ---- (a) track_video over a frame mesh
    chain_err = check_sharded_chain(gpu, rng, config)
    log(f"sharded band chain, 2 slots x 512 frames on the card: bit-equal to the plain "
        f"chain on 2 CPU slots (max abs {chain_err:.3e})")
    tv_launches = {}
    with open_video(str(meta)) as video:
        bg = float(np.max(video[0]))
        _packed, read_band, count_fn, depth = video.staging_paths()
        single = compute_profiles_batched(
            video.read_batch, len(video), video.frame_shape, bg, config,
            chunk_size=4096, read_band=read_band, count_fn=count_fn,
            read_band_counts=video.band_bytes_and_counts, band_bit_depth=depth,
            keep_device=True, device=gpu)
        for slots in (2, 4):
            mesh = make_mesh("frame", devices=[gpu] * slots)
            sharded = _compute_profiles_sharded(video, bg, config, (), mesh,
                                                frames_per_shard=chunk // slots,
                                                keep_device=True)
            torch.cuda.synchronize()
            for name in lines:
                if not torch.equal(getattr(sharded, name), getattr(single, name)):
                    raise AssertionError(f"{slots}-slot sharded {name} != unsharded")
            if not np.array_equal(sharded.signal_counts, single.signal_counts):
                raise AssertionError(f"{slots}-slot sharded counts != unsharded")
            for scan in ("device", "host"):
                counters_zero()
                tables, _ = track_tables(video, config, meta, tmp / f"mesh-tv-{slots}-{scan}",
                                         mesh=mesh, scan=scan, chunk_size=chunk)
                got = counters()
                tv_launches[(slots, scan)] = got
                want = (slots * 2, int(scan == "device"), int(scan == "device"))
                if got != want:
                    raise AssertionError(f"track_video over {slots} slots, scan={scan}: "
                                         f"launches {got}, expected {want}")
                if tables != dev_tables:
                    raise AssertionError(f"track_video over {slots} slots, scan={scan}: "
                                         f"tables differ from phase 5's")
            log(f"track_video over a {slots}-slot frame mesh on {gpu}, chunks of {chunk}: "
                f"profiles and counts bit-equal to the unsharded map phase; launches "
                f"(band, scan, videos) device {tv_launches[(slots, 'device')]}, host "
                f"{tv_launches[(slots, 'host')]}; tables byte-equal to phase 5's")
        del single, sharded

    # ---- (b) library mode over a video mesh
    meshes = {1: make_mesh("video", devices=[gpu]), 2: make_mesh("video", devices=[gpu] * 2)}
    lib_launches = {}
    for slots, env in ((1, {}), (2, {}), (1, dict(HSIP_FUSED="0")), (2, dict(HSIP_FUSED="0"))):
        tag = f"{slots}-slot" + (", HSIP_FUSED=0" if env else "")
        counters_zero()
        outs, wall, tables, paths, _, trace = run_library(
            lib8, tmp / f"mesh-lib-{slots}-{len(env)}", mesh=meshes[slots], **env)
        got = counters()
        lib_launches[tag] = got
        if tables != want8:
            raise AssertionError(f"library over the {tag} mesh: tables differ")
        if env:  # the chunked path: a band launch a video, a scan a slot
            per_slot = "scan launches one each"
            ok = paths == ["chunked"] and got == (8, slots, 8)
        else:
            per_slot = {s: tuple(map(sum, zip(*(t["launches"] for t in trace
                                                  if t["slot"] == s))))
                        for s in range(slots)}
            ok = (paths == ["fused"] and got[2] == 8
                  and all(b >= 1 and c >= 1 for b, c in per_slot.values()))
        if not ok:
            raise AssertionError(f"library over the {tag} mesh: paths {paths}, "
                                 f"launches {got}, a slot {per_slot}")
        log(f"library over the {tag} mesh: paths {paths}, launches (band, scan, "
            f"videos) {got}, a slot {per_slot}, {wall:.4f} s; tables byte-equal to "
            f"the per-file device run")

    # ---- (c) the command line
    config_path, out_dir = cli_config(tmp, lib8, "mesh")
    counters_zero()
    rc, wall, out, err = run_cli(["--config", str(config_path), "--no-images",
                                  "--no-sequences", "--library", "--mesh"])
    cli_launches = counters()
    n_cards = torch.cuda.device_count()
    if rc != 0 or f"Sharding video axis over {n_cards} devices" not in out \
            or tables_of(out_dir) != want8 or min(cli_launches) < 1:
        raise AssertionError(f"hsip-torch --library --mesh returned {rc}, launches "
                             f"{cli_launches}: {err[-2000:]}")
    assert_refused(tmp / "mesh-refused",
                   ["--video-path", str(lib8), "--library", "--mesh", str(n_cards + 1)],
                   f"--mesh {n_cards + 1}: only {n_cards} local device(s)")
    log(f"hsip-torch --library --mesh: {n_cards} card(s), launches {cli_launches}, "
        f"{wall:.4f} s, tables byte-equal; --library --mesh {n_cards + 1}: exit 2, "
        f"nothing written")

    # ---- (d) the dry runs, 4 slots on the card against 4 CPU slots
    got = run_multichip_dryrun(4, devices=[gpu] * 4)
    want = run_multichip_dryrun(4, devices=["cpu"] * 4)
    if got[2] != want[2]:
        raise AssertionError(f"dry run total {got[2]} != {want[2]} on CPU slots")
    differ = np.argwhere((got[0] != want[0]) | (got[1] != want[1]))
    if differ.size:
        # The dry run's frames; a differing position must come with rows
        # that agree within the tolerance: a near-tie.
        frames = np.random.default_rng(0).integers(0, 4096, size=(2, 4, 24, 128),
                                                   dtype=np.uint16)
        rows = {}
        for where in (gpu, torch.device("cpu")):
            step = build_multichip_step(video_frame_mesh(2, [where] * 4), 24, 128)
            rows[where.type] = step(frames, 100.0, 5.0, 50.0)[3:]
        for v, n in differ:
            for i, name in enumerate(("sobel", "gradient")):
                a = rows["cuda"][i][v][n].cpu().numpy()
                b = rows["cpu"][i][v][n].numpy()
                log(f"dry run near-tie at video {v} frame {n}: positions "
                    f"{got[0][v, n], got[1][v, n]} against {want[0][v, n], want[1][v, n]}; "
                    f"{name} rows max abs {np.abs(a - b).max():.3e}")
                if not np.allclose(a, b, **TOL):
                    raise AssertionError(f"dry run position differs beyond a near-tie at "
                                         f"video {v} frame {n}")
    pipeline = run_pipeline_dryrun(4, devices=[gpu] * 4)
    if pipeline != (3, "fused"):
        raise AssertionError(f"run_pipeline_dryrun(4) returned {pipeline}")
    log(f"run_multichip_dryrun(4) on {gpu}: total {got[2]} as on CPU slots, "
        f"{differ.shape[0]} position(s) differing; run_pipeline_dryrun(4): {pipeline}")

    # ---- (e) times, in turns (the order reversed every other round); the
    # first round is the warm-up
    frame_mesh = make_mesh("frame", devices=[gpu] * 2)
    walls = {k: [] for k in ("library", "library-mesh-1", "library-mesh-2",
                             "track_video", "track_video-mesh-2")}
    with open_video(str(meta)) as video:
        runs = {
            "library": lambda i: run_library(lib8, tmp / f"t9-lib-{i}")[1],
            "library-mesh-1": lambda i: run_library(lib8, tmp / f"t9-m1-{i}",
                                                    mesh=meshes[1])[1],
            "library-mesh-2": lambda i: run_library(lib8, tmp / f"t9-m2-{i}",
                                                    mesh=meshes[2])[1],
            "track_video": lambda i: track_tables(video, config, meta, tmp / f"t9-tv-{i}",
                                                  scan="device", device=gpu)[1],
            "track_video-mesh-2": lambda i: track_tables(
                video, config, meta, tmp / f"t9-tvm-{i}", scan="device",
                mesh=frame_mesh)[1],
        }
        for i in range(4):
            for key in (list(runs) if i % 2 else list(runs)[::-1]):
                wall = runs[key](i)
                if i:
                    walls[key].append(wall)
        # The host stages of one more track_video run each.
        stages = {}
        for key, kw in (("track_video", dict(device=gpu)),
                        ("track_video-mesh-2", dict(mesh=frame_mesh))):
            stages[key] = StageTimes()
            track_tables(video, config, meta, tmp / f"t9-stages-{key}", scan="device",
                         stage_times=stages[key], **kw)
    med = {key: statistics.median(x) for key, x in walls.items()}
    for key, st in stages.items():
        log(f"[{card}] {key}: StageTimes (host seconds) of one more run {st.as_dict()}")
    frames8 = 8 * N_FRAMES
    for key, base in (("library-mesh-1", "library"), ("library-mesh-2", "library-mesh-1"),
                      ("track_video-mesh-2", "track_video")):
        n = N_FRAMES if key.startswith("track") else frames8
        log(f"[{card}] {key}: {med[key]:.4f} s, {n / med[key]:.1f} frames/s (median of 3 "
            f"warm runs: {', '.join(f'{x:.4f}' for x in walls[key])}); {base} in turns "
            f"{med[base]:.4f} s ({', '.join(f'{x:.4f}' for x in walls[base])}); "
            f"{key} / {base} {med[key] / med[base]:.3f}")
    return dict(track_video=tv_launches[(2, "device")],
                library=lib_launches["2-slot"], cli=cli_launches), med


def run_script(argv, timeout_s):
    """``python3 argv`` from the checkout's root, with a time limit (the
    child is killed when it runs past it); (stdout, seconds). Fails unless
    it exits 0."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(REPO), env.get("PYTHONPATH")) if x)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *map(str, argv)], capture_output=True,
                          text=True, timeout=timeout_s, cwd=str(REPO), env=env)
    if proc.returncode != 0:
        raise AssertionError(f"{argv[0]} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def check_device(report, kind, what):
    device = report.get("device") or {}
    if device.get("platform") != "gpu" or device.get("kind") != kind:
        raise AssertionError(f"{what} ran on {device}, not the {kind}")


def log_trace(card, what, trace):
    """One line for a profiled run: busy, idle share, the top kernels."""
    top = "; ".join(f"{k['name'][:60]} {k['ms']:.3f} ms x{k['launches']}"
                    for k in trace["top_kernels"])
    log(f"[{card}] {what} under torch.profiler: wall {trace['wall_s']:.4f} s, device busy "
        f"{trace['device_busy_s']:.4f} s ({trace['device_events']} events), idle share "
        f"{trace['idle_share']:.4f}; top kernels: {top}")


def bench_phase(tmp, meta, card, kind):
    """Phase 10: ``bench_torch.py`` and the two stage tools on the card, each
    in its own process. Returns the bench's launches per route and kernel."""
    t_phase = time.perf_counter()
    samples = tmp / "bench-samples.json"
    out, secs = run_script(["bench_torch.py", "--repeat", "4", "--videos16", "0",
                            "--samples-out", samples], timeout_s=300)
    line = out.strip().splitlines()[-1]
    bench = json.loads(line)
    check_device(bench, kind, "bench_torch.py")
    if list(bench)[-5:] != ["metric", "value", "unit", "vs_baseline", "device"]:
        raise AssertionError(f"bench_torch.py's headline keys are not last: {list(bench)}")
    if len(line) >= 2000 or "error" in bench:
        raise AssertionError(f"bench_torch.py line of {len(line)} chars: {line[:300]}")
    for key in ("value", "device_compute_fps", "vs_baseline"):
        if not bench.get(key, 0) > 0:
            raise AssertionError(f"bench_torch.py {key} = {bench.get(key)}")
    launches = bench["launches"]
    # One launch of each kernel a recording on the per-file loop, one a
    # group of the library (G = 4 over 8 videos), one in device compute.
    want = {"per_file": [8, 8], "library": [4, 4], "device_compute": [1, 1]}
    if launches != want or bench["library_group_paths"] != ["fused"]:
        raise AssertionError(f"bench_torch.py launched (band, scan) {launches}, not {want}, "
                             f"groups {bench['library_group_paths']}")
    detail = json.loads(samples.read_text())
    log(f"[{card}] bench_torch.py --repeat 4 --videos16 0 ({secs:.1f} s in its process, "
        f"kernels built in {bench['build_s']} s): library {bench['value']} frames/s, per-file "
        f"loop {bench['single_video_fps']} frames/s, pairwise median "
        f"{bench['library_speedup_pairwise_median']} (IQR "
        f"{bench.get('library_speedup_pairs_iqr')}), device compute "
        f"{bench['device_compute_fps']} frames/s {bench['device_compute_ms']} ms, host "
        f"staging {bench.get('host_staging_fps')} frames/s, host baseline "
        f"{bench['scipy_serial_fps']} frames/s (vs_baseline {bench['vs_baseline']}), "
        f"groups {bench['library_group_paths']}, launches (band, scan) {launches}, "
        f"power limit {bench['device']['power_limit_w']} W; samples {detail['samples']}")
    log(f"bench_torch.py line ({len(line)} chars): {line}")

    # bench.py's recording is the one of phase 5, byte for byte: link it
    # into the tool's cache instead of synthesizing it again.
    cache = tmp / "stage-cache"
    link_recording(meta, cache / f"f{N_FRAMES}-h{HEIGHT}-w{WIDTH}", "bench-run-1-001")
    out, secs = run_script(["tools/stage_profile_torch.py", "--repeat", "2", "--trace",
                            "--cache-dir", cache], timeout_s=240)
    report = json.loads(out)
    check_device(report, kind, "stage_profile_torch.py")
    for mode, want_launches in (("single", [1, 1]), ("library", [4, 4])):
        r = report[mode]
        if r["launches"] != want_launches or not 0.0 <= r["trace"]["idle_share"] < 1.0:
            raise AssertionError(f"stage_profile_torch.py {mode}: launches {r['launches']}, "
                                 f"idle share {r['trace']['idle_share']}")
        log(f"[{card}] stage_profile_torch.py {mode} ({secs:.1f} s in its process): "
            f"{r['fps']:.1f} frames/s, best of 2 {r['end_to_end_s']:.4f} s, launches "
            f"{r['launches']}, StageTimes {r['stages']}")
        log_trace(card, f"stage_profile_torch.py {mode}", r["trace"])

    # The fused groups' timeline over the library's own shape.
    out, secs = run_script(["tools/pipeline_trace_torch.py", "--groups", "1", "4", "--trace",
                            "--videos", "8", "--frames", N_FRAMES, "--height", HEIGHT,
                            "--width", WIDTH], timeout_s=240)
    summary = json.loads(out.strip().splitlines()[-1])
    check_device(summary, kind, "pipeline_trace_torch.py")
    if not summary.get("rows_identical"):
        raise AssertionError("pipeline_trace_torch.py: rows differ across G")
    if sorted(summary["per_group"]) != ["1", "4"]:
        raise AssertionError(f"pipeline_trace_torch.py swept G={sorted(summary['per_group'])}")
    for g, entry in summary["per_group"].items():
        if entry["launches"] != [int(g), int(g)] or entry["groups"] != int(g):
            raise AssertionError(f"pipeline_trace_torch.py G={g}: {entry['groups']} groups, "
                                 f"launches {entry['launches']}")
        log(f"[{card}] pipeline_trace_torch.py G={g} ({secs:.1f} s in its process; "
            f"videos x frames x height x width {summary['shape']}): "
            f"{entry['end_to_end_s']:.4f} s, gather {entry['gather_wall_s']:.4f} s, overlap "
            f"{entry['overlap_s']:.4f} s, tail {entry['tail_s']:.4f} s, launches "
            f"{entry['launches']}")
        log_trace(card, f"pipeline_trace_torch.py G={g}", entry["trace"])
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return {k: {route: launches[route][k] for route in launches} for k in (0, 1)}


def main() -> int:
    if not (REPO / "hsip_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (hsip_tpu_torch/ "
              "beside this script)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np

    from hsip_tpu_torch import open_video
    from hsip_tpu_torch.kernels import _build
    from hsip_tpu_torch.kernels.cuda_preprocess import (
        band_plan,
        band_profiles_plain,
        band_profiles_probe,
        cuda_band_profiles,
    )
    from hsip_tpu_torch.kernels.preprocess import gaussian_taps
    from hsip_tpu_torch.track.config import FlameDetectorConfig
    from hsip_tpu_torch.track.cuda_scan import cuda_tracking_scan
    from hsip_tpu_torch.track.device_scan import tracking_scan_plain
    from hsip_tpu_torch.track.host_scan import MIN_SIGNAL_FRACTION
    from hsip_tpu_torch.track.scan import compute_profiles_batched, scan_params

    # ---- phase 1: the card ----
    dev = torch.device(GPU)
    card = card_info()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in _build.last_build_log().splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  " + line.strip())

    rng = np.random.default_rng(2024)
    config = FlameDetectorConfig()
    with tempfile.TemporaryDirectory(prefix="hsip-chip-smoke-") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        meta, truth = write_bench_recording(tmp / "rec")
        golden_meta = write_golden_recording(tmp / "golden")
        log(f"recordings written in {time.perf_counter() - t0:.2f} s: "
            f"{N_FRAMES}x{HEIGHT}x{WIDTH} 12-bit and the golden one")

        # ---- phase 3: band kernel vs plain ----
        band_err = check_band_kernel(dev, rng)

        # ---- phase 4: scan kernel vs plain (incl. the recording's profiles) ----
        with open_video(str(meta)) as video:
            bg = float(np.max(video[0]))
            read_packed, read_band, count_fn, depth = video.staging_paths()
            real = compute_profiles_batched(
                video.read_batch, len(video), video.frame_shape, bg, config,
                chunk_size=4096, read_packed=read_packed, read_band=read_band,
                count_fn=count_fn,
                read_band_counts=video.band_bytes_and_counts if read_band else None,
                band_bit_depth=depth, keep_device=True, device=dev,
            )
            fps = video.frame_rate
        real_empty = real.signal_counts / real.total_pixels < MIN_SIGNAL_FRACTION
        params_for = lambda method: scan_params(config, fps, 0.000833333, method)  # noqa: E731
        scan_err = check_scan_kernel(dev, rng, real, real_empty, params_for)

        # ---- phase 5: the slice, through the user's entry point ----
        ref = {b: run_file(meta, tmp / f"cpu-{b}", b, "cpu") for b in ("gpu", "device")}
        cuda_band_profiles.launches = 0
        cuda_tracking_scan.launches = 0
        gpu_out, gpu_first_s, gpu_tables = run_file(meta, tmp / "gpu", "gpu", GPU)
        after_gpu = (cuda_band_profiles.launches, cuda_tracking_scan.launches)
        dev_out, dev_first_s, dev_tables = run_file(meta, tmp / "device", "device", GPU)
        launches = (cuda_band_profiles.launches, cuda_tracking_scan.launches)
        log(f"staging route: {gpu_out.phase_timings['staging_route']} (gpu), "
            f"{dev_out.phase_timings['staging_route']} (device)")
        log(f"launches: band kernel {launches[0]}, scan kernel {launches[1]} "
            f"(after the gpu run: {after_gpu[0]}, {after_gpu[1]})")
        if after_gpu[0] < 1 or after_gpu[1] != 0:
            raise AssertionError(f"gpu backend launches {after_gpu}: expected band >= 1, scan 0")
        if launches[0] <= after_gpu[0] or launches[1] < 1:
            raise AssertionError(f"device backend did not launch both kernels: {launches}")
        if gpu_tables != ref["gpu"][2] or dev_tables != ref["device"][2]:
            raise AssertionError("GPU tables differ from the port's CPU tables")
        if gpu_tables != dev_tables or not gpu_tables:
            raise AssertionError("gpu and device backends wrote different tables")
        # The front moves ~0.4 px a frame, so a row lands whenever it has
        # crossed a pixel: rows must run from ignition to the end of the
        # recording, rightward, near the analytic front.
        rows = gpu_out.rows
        frames = [r[0] for r in rows]
        pxs = [r[2] for r in rows]
        errs = [abs(px - truth[f]) for f, _, px, _, _ in rows if np.isfinite(truth[f])]
        med = float(np.median(errs)) if errs else float("inf")
        log(f"recording: {len(rows)} rows over frames {frames[0] if rows else None}.."
            f"{frames[-1] if rows else None} of {N_FRAMES}, median |px - truth| "
            f"{med:.2f}, break: {gpu_out.break_reason}; tables byte-identical "
            f"across gpu, device and cpu ({len(gpu_tables)} files)")
        if (len(rows) < N_FRAMES // 10 or frames[0] > N_FRAMES // 20
                or frames[-1] < N_FRAMES - N_FRAMES // 20
                or any(b < a for a, b in zip(pxs, pxs[1:])) or med > 20):
            raise AssertionError("the flame was not tracked across the recording")

        golden = (REPO / "tests" / "golden" / "golden-run-1-001-flame-position.txt").read_bytes()
        for backend, device in (("gpu", GPU), ("device", GPU), ("gpu", "cpu")):
            _, _, tables = run_file(golden_meta, tmp / f"golden-{backend}-{device}",
                                    backend, device)
            if tables.get("golden-run-1-001-flame-position.txt") != golden:
                raise AssertionError(f"golden table differs ({backend} on {device})")
        log("golden recording: gpu (cuda), device (cuda) and gpu (cpu) tables "
            "byte-identical to tests/golden/")

        # ---- phase 6: times ----
        n = N_FRAMES
        band, prior = band_case(rng, n, config.morphology_kernel_size,
                                config.gaussian_sigma, WIDTH)
        band_t, prior_t = torch.from_numpy(band).to(dev), torch.from_numpy(prior).to(dev)
        k, sigma = config.morphology_kernel_size, config.gaussian_sigma
        band_ms = cuda_ms(lambda: cuda_band_profiles(band_t, prior_t, 5.0, k, sigma), 20)
        band_plain_ms = cuda_ms(lambda: band_profiles_plain(band_t, prior_t, 5.0, k, sigma), 5)
        band_bound_ms, band_bound_by = band_bound(
            n, band.shape[1], WIDTH, k, len(gaussian_taps(sigma)))
        plan = band_plan(n, WIDTH, k, sigma)
        # The bytes of band tiles the blocks copy, as the kernel counts
        # them; then the (3, 13) instantiation against the runtime-count
        # one, both through the probe entry, in the order A, B, B, A.
        band_read = int(band_profiles_probe(band_t, prior_t, 5.0, k, sigma)[1].item())
        band_read_tb_s = band_read / (band_ms * 1e-3) / 1e12
        probe_ms = {}
        for rc in (False, True, True, False):
            probe_ms.setdefault(rc, []).append(cuda_ms(
                lambda: band_profiles_probe(band_t, prior_t, 5.0, k, sigma,
                                            runtime_counts=rc), 20))
        fi, s, g, em, hp, it = scan_inputs(real, real_empty, dev)
        kw = dict(width=WIDTH, intensity_lines=it, **params_for("combined"))
        scan_res = cuda_tracking_scan(fi, s, g, em, hp, **kw)
        scan_bound_ms, scan_bound_by = scan_bound(scan_res, WIDTH, "combined")
        scan_ms = cuda_ms(lambda: cuda_tracking_scan(fi, s, g, em, hp, **kw), 5)
        scan_plain_ms = cuda_ms(lambda: tracking_scan_plain(fi, s, g, em, hp, **kw), 1, repeats=3)
        # V = 8: the V = 4 case twice over, per-video parameters and all.
        f4 = four_videos(rng, real, real_empty, dev)
        f8 = tuple(torch.cat([t, t]).contiguous() for t in f4)
        kw8 = dict(width=WIDTH, intensity_lines=f8[5],
                   **four_video_params(params_for("combined"), copies=2))
        scan8_res = cuda_tracking_scan(*f8[:5], **kw8)
        scan8_bound_ms, _ = scan_bound(scan8_res, WIDTH, "combined")
        scan8_ms = cuda_ms(lambda: cuda_tracking_scan(*f8[:5], **kw8), 5)
        # About a video on every SM (the --library case): the ring's copies
        # of whole rows then move 16.8 MB a video per launch.
        copies = torch.cuda.get_device_properties(0).multi_processor_count // 4
        vs = 4 * copies
        fs = tuple(t.repeat((copies,) + (1,) * (t.dim() - 1)).contiguous() for t in f4)
        kws = dict(width=WIDTH, intensity_lines=fs[5],
                   **four_video_params(params_for("combined"), copies=copies))
        scans_res = cuda_tracking_scan(*fs[:5], **kws)
        scans_bound_ms, _ = scan_bound(scans_res, WIDTH, "combined")
        scans_ms = cuda_ms(lambda: cuda_tracking_scan(*fs[:5], **kws), 5)
        scans_rate = 2 * 4 * vs * n * WIDTH / (scans_ms * 1e-3)  # whole rows, B/s
        del fs, scans_res
        log(f"[{card}] band kernel, N={n} B={band.shape[1]} W={WIDTH}: "
            f"{band_ms:.4f} ms; plain PyTorch {band_plain_ms:.4f} ms; bound "
            f"{band_bound_ms:.4f} ms ({band_bound_by}), "
            f"{band_bound_ms / band_ms:.2%} of it")
        log(f"[{card}] band kernel plan: {plan}; its blocks copy {band_read} bytes "
            f"of band tiles, counted by the kernel ({band_read / band.nbytes:.3f}x "
            f"the band), {band_read_tb_s:.3f} TB/s over its time")
        log(f"[{card}] band kernel through the probe entry (counting its loads): "
            f"(3, 13) instantiation {probe_ms[False][0]:.4f} / {probe_ms[False][1]:.4f} ms, "
            f"runtime-count instantiation {probe_ms[True][0]:.4f} / "
            f"{probe_ms[True][1]:.4f} ms")
        log(f"[{card}] scan kernel, combined, V=1 M={n} W={WIDTH}: {scan_ms:.4f} ms "
            f"({scan_ms * 1e3 / n:.3f} us a step); plain PyTorch {scan_plain_ms:.4f} ms; "
            f"bound {scan_bound_ms:.4f} ms ({scan_bound_by}), "
            f"{scan_bound_ms / scan_ms:.2%} of it")
        log(f"[{card}] scan kernel, combined, V=8 M={n} W={WIDTH}: {scan8_ms:.4f} ms "
            f"({scan8_ms * 1e3 / n:.3f} us a step); bound {scan8_bound_ms:.4f} ms")
        log(f"[{card}] scan kernel, combined, V={vs} M={n} W={WIDTH}: {scans_ms:.4f} ms "
            f"({scans_ms * 1e3 / n:.3f} us a step); bound {scans_bound_ms:.4f} ms; "
            f"whole-row copies {scans_rate / 1e12:.3f} TB/s")
        # The library's shapes, held against the plain versions and timed:
        # the flat band of 2, 3 and 8 videos (phase 7's groups are of 2 and
        # 3; 8 is one group of the whole library), each video's first row
        # without a prior; the scan at V=2 and, ragged, at V=2 and V=3 (V=8
        # is above). The band kernel's plan changes with N.
        lib_ms = {}
        for v in (2, 3, 8):
            nb = v * n
            band_v = band_t.repeat(v, 1, 1)
            flat = torch.arange(nb, dtype=torch.int32, device=dev)
            prior_v = torch.where(flat % n > 0, flat - 1, -1).to(torch.int32)
            got = cuda_band_profiles(band_v, prior_v, 5.0, k, sigma)
            want = band_profiles_plain(band_v, prior_v, 5.0, k, sigma)
            torch.cuda.synchronize()
            for name, a, b in zip(("sobel", "gradient", "intensity"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"band kernel != plain at the library's N={v}x{n}: {name}, "
                        f"max abs {float((a - b).abs().max()):.3e}")
            del got, want
            ms = cuda_ms(lambda: cuda_band_profiles(band_v, prior_v, 5.0, k, sigma), 10)
            b_ms, b_by = band_bound(nb, band.shape[1], WIDTH, k, len(gaussian_taps(sigma)))
            lib_ms[f"band_ms_n{v}x{n}"] = ms
            lib_ms[f"band_bound_ms_n{v}x{n}"] = b_ms
            log(f"[{card}] band kernel, N={v}x{n} B={band.shape[1]} W={WIDTH} (a library "
                f"group's flat batch): bit-equal to plain, plan "
                f"{band_plan(nb, WIDTH, k, sigma)}; {ms:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by}), {b_ms / ms:.2%} of it")
            del band_v, prior_v
        f2 = tuple(t[:2].contiguous() for t in f4)
        kw2 = dict(width=WIDTH, intensity_lines=f2[5], **{
            key: (val[:2] if isinstance(val, np.ndarray) and val.ndim else val)
            for key, val in four_video_params(params_for("combined")).items()})
        scan2_res = cuda_tracking_scan(*f2[:5], **kw2)
        p4 = four_video_params(params_for("combined"))
        for label, videos, lengths in (
                ("V=2", f2, (n, n)),
                ("V=2 ragged", f2, (512, n)),
                ("V=3 ragged", tuple(t[:3].contiguous() for t in f4), (n, 512, n))):
            fi_v, s_v, g_v, em_v, hp_v, it_v = ragged(videos, lengths)
            kw_v = dict(width=WIDTH, intensity_lines=it_v, **{
                key: (val[:len(lengths)] if isinstance(val, np.ndarray) and val.ndim
                      else val) for key, val in p4.items()})
            got = cuda_tracking_scan(fi_v, s_v, g_v, em_v, hp_v, **kw_v)
            want = tracking_scan_plain(fi_v, s_v, g_v, em_v, hp_v, **kw_v)
            torch.cuda.synchronize()
            for name, a, b in zip(got._fields, got, want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"scan kernel != plain at the library's {label}: {name}")
            log(f"scan kernel vs plain at the library's shapes: {label} M={n} "
                f"lengths {lengths}: 9/9 fields equal, "
                f"{int((got.final_position >= 0).sum())} detections")
            del got, want
        scan2_bound_ms, _ = scan_bound(scan2_res, WIDTH, "combined")
        scan2_ms = cuda_ms(lambda: cuda_tracking_scan(*f2[:5], **kw2), 5)
        log(f"[{card}] scan kernel, combined, V=2 M={n} W={WIDTH}: {scan2_ms:.4f} ms "
            f"({scan2_ms * 1e3 / n:.3f} us a step); bound {scan2_bound_ms:.4f} ms")
        from hsip_tpu_torch.track.scan import track_video
        from hsip_tpu_torch.utils import StageTimes

        for backend, first in (("gpu", gpu_first_s), ("device", dev_first_s)):
            runs = sorted((run_file(meta, tmp / f"t-{backend}-{i}", backend, GPU)[:2]
                           for i in range(3)), key=lambda r: r[1])
            out, wall = runs[1]  # the median run
            log(f"[{card}] backend={backend}: {N_FRAMES / wall:.1f} frames/s "
                f"(median of 3 warm runs, {wall:.4f} s: map {out.phase_timings['map_s']} s, "
                f"scan {out.phase_timings['scan_s']} s; first run {first:.4f} s)")
            # The same backend's stages, from track_video on the open video.
            stages = StageTimes()
            with open_video(str(meta)) as video:
                t0 = time.perf_counter()
                track_video(video, config, 0.000833333, 1.0159,
                            scan="device" if backend == "device" else "host",
                            stage_times=stages, device=dev)
                torch.cuda.synchronize()
                tv_s = time.perf_counter() - t0
            log(f"[{card}] backend={backend}: track_video {tv_s:.4f} s, StageTimes "
                f"(host seconds) {stages.as_dict()}")
        del band_t, prior_t, f4, f8, f2, kw, kw2, kw8, kws, fi, s, g, em, hp, it
        del scan_res, scan2_res, scan8_res, real

        # ---- phase 7: library mode ----
        lib_launches, lib_times, lib8, want8 = library_phase(
            tmp, meta, golden_meta, card, config)

        # ---- phase 8: the command line ----
        cli_file, cli_lib, cli_times = cli_phase(tmp, meta, lib8, want8, card)

        # ---- phase 9: the mesh ----
        mesh_launches, mesh_times = mesh_phase(tmp, meta, lib8, want8, dev_tables, card,
                                               config, rng)

        # ---- phase 10: the benchmark and the stage tools ----
        bench_launches = bench_phase(tmp, meta, card, kind)

    log(json.dumps({"library": {
        "frames": 8 * N_FRAMES, "loop_s": lib_times["loop_s"], "library_s": lib_times["lib_s"],
        "peak_device_bytes": lib_times["peak"], "budget_estimate_bytes": lib_times["estimate"],
        "fused_s": lib_times["fused_s"], "chunked_s": lib_times["chunked_s"]}}))
    log(json.dumps({"cli": {
        "frames": 8 * N_FRAMES, "per_file_s": cli_times["cli-file"],
        "per_file_runner_s": cli_times["loop"], "library_s": cli_times["cli-library"],
        "library_runner_s": cli_times["library"],
        "two_ranks_per_file_s": cli_times["ranks_file_s"],
        "two_ranks_library_s": cli_times["ranks_library_s"],
        "two_ranks_per_file_launches": cli_times["ranks_file_launches"],
        "two_ranks_library_launches": cli_times["ranks_library_launches"]}}))
    log(json.dumps({"mesh": {
        "library_s": mesh_times["library"], "library_mesh_1_s": mesh_times["library-mesh-1"],
        "library_mesh_2_slots_s": mesh_times["library-mesh-2"],
        "track_video_s": mesh_times["track_video"],
        "track_video_mesh_2_slots_s": mesh_times["track_video-mesh-2"],
        "launches": mesh_launches}}))
    log(card)
    # No single PyTorch call computes either kernel's function: library_ms
    # is null for both.
    print(json.dumps({"kernels": [
        {"name": "band_profiles", "route": "cuda",
         "source": "hsip_tpu_torch/csrc/band_profiles.cu",
         "replaces": "hsip_tpu/kernels/pallas_preprocess.py:131",
         "launches": launches[0], "launches_library": lib_launches[0],
         "launches_cli": cli_file[0], "launches_cli_library": cli_lib[0],
         "launches_mesh": mesh_launches["track_video"][0],
         "launches_mesh_library": mesh_launches["library"][0],
         "launches_bench": bench_launches[0],
         "max_abs_err": band_err,
         "ms": band_ms, "plain_ms": band_plain_ms,
         "bound_ms": band_bound_ms, "bound_by": band_bound_by,
         "share_of_bound": band_bound_ms / band_ms, "library_ms": None, **lib_ms},
        {"name": "tracking_scan", "route": "cuda",
         "source": "hsip_tpu_torch/csrc/tracking_scan.cu",
         "replaces": "hsip_tpu/track/pallas_scan.py:571",
         "launches": launches[1], "launches_library": lib_launches[1],
         "videos_library": lib_launches[2],
         "launches_cli": cli_file[1], "launches_cli_library": cli_lib[1],
         "videos_cli_library": cli_lib[2],
         "launches_mesh": mesh_launches["track_video"][1],
         "launches_mesh_library": mesh_launches["library"][1],
         "launches_bench": bench_launches[1],
         "max_abs_err": scan_err,
         "ms": scan_ms, "plain_ms": scan_plain_ms,
         "bound_ms": scan_bound_ms, "bound_by": scan_bound_by,
         "share_of_bound": scan_bound_ms / scan_ms, "library_ms": None,
         "ms_v2": scan2_ms, "bound_ms_v2": scan2_bound_ms,
         "ms_v8": scan8_ms, "bound_ms_v8": scan8_bound_ms,
         "v_per_sm": vs, "ms_v_per_sm": scans_ms, "bound_ms_v_per_sm": scans_bound_ms,
         "row_copy_tb_s_v_per_sm": scans_rate / 1e12},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
