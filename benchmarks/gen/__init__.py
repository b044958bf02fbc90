"""The traffic generator: recordings of a library drawn from a seed.

A traffic file (``benchmarks/traffic/<mix>.json``) states the numbers of a
library: how many recordings, how many frames each, the ignition range,
the share that runs to DDT and the speed ranges. A configuration file
(``benchmarks/configs/<config>.json``) states the camera: frame geometry,
bit depth, frame rate and the recording names its calibration entries
match. :func:`plan_library` turns both and a seed into one
:class:`RecordingPlan` a recording; :func:`write_library` renders and
writes them in parallel processes with the frozen writer of
:mod:`gen.synthetic`.

Every seed draws the same sizes and the same number of DDT recordings;
only the ignition frames, speeds, DDT frames, noise and which recordings
run to DDT change with it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["RecordingPlan", "plan_library", "write_recording_plan",
           "write_library"]


@dataclass(frozen=True)
class RecordingPlan:
    """One recording to synthesize: its file stem, geometry and flame."""

    name: str
    frames: int
    height: int
    width: int
    bit_depth: int
    record_rate: int
    flame: dict = field(hash=False)

    @property
    def has_ddt(self) -> bool:
        return self.flame.get("ddt_frame") is not None


def _uniform(rng, bounds, integer: bool = False):
    lo, hi = bounds
    if integer:
        return int(rng.integers(int(lo), int(hi) + 1))
    return float(rng.uniform(float(lo), float(hi)))


def plan_library(traffic: dict, config: dict, seed: int,
                 frames: Optional[int] = None,
                 recordings: Optional[int] = None) -> List[RecordingPlan]:
    """The recordings of one library for ``seed``.

    ``frames`` and ``recordings`` override the traffic file's sizes (the
    CPU rehearsal shrinks them); the frame ranges of the traffic file are
    then scaled by the same factor as the frame count."""
    n_frames = int(traffic["frames"]) if frames is None else int(frames)
    n_rec = int(traffic["recordings"]) if recordings is None else int(recordings)
    scale = n_frames / float(traffic["frames"])
    geometry = config["frame"]
    names = config["recording_names"]
    flame_base = dict(traffic.get("flame", {}))

    def frames_range(key):
        lo, hi = traffic[key]
        lo, hi = int(round(lo * scale)), int(round(hi * scale))
        return (max(lo, 1), max(hi, lo, 1))

    root = np.random.SeedSequence(int(seed) % (1 << 64))
    pick = np.random.default_rng(root.spawn(1)[0])
    n_ddt = int(round(float(traffic["ddt_share"]) * n_rec))
    ddt_set = set(int(i) for i in pick.permutation(n_rec)[:n_ddt])
    plans = []
    for i, child in enumerate(root.spawn(n_rec + 1)[1:]):
        rng = np.random.default_rng(child)
        ignition = _uniform(rng, frames_range("ignition_frame"), integer=True)
        flame = dict(flame_base)
        flame.update(
            x0=float(traffic["x0_px"]),
            v0_px=_uniform(rng, traffic["v0_px"]),
            ignition_frame=ignition,
            seed=int(rng.integers(0, 1 << 32)),
        )
        offset = _uniform(rng, frames_range("ddt_after_ignition"), integer=True)
        jump = _uniform(rng, traffic["v_jump_px"])
        if i in ddt_set:
            flame.update(ddt_frame=ignition + offset, v_jump_px=jump)
        plans.append(RecordingPlan(
            name=names[i % len(names)].format(i=i + 1),
            frames=n_frames,
            height=int(geometry["height"]),
            width=int(geometry["width"]),
            bit_depth=int(geometry["bit_depth"]),
            record_rate=int(geometry["record_rate"]),
            flame=flame,
        ))
    if len(set(p.name for p in plans)) != len(plans):
        raise ValueError("two recordings of one library share a name")
    return plans


def _fsync(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_recording_plan(directory: str, plan: RecordingPlan) -> str:
    """Render and write one recording, then ``fsync`` its two files so
    that writeback does not spill into the measured window. Returns the
    metadata path. Runs in a worker process."""
    from .synthetic import CihxSpec, FlameSpec, synthesize_flame_video, write_recording

    frames, _ = synthesize_flame_video(
        plan.frames, height=plan.height, width=plan.width,
        flame=FlameSpec(**plan.flame), bit_depth=plan.bit_depth,
    )
    spec = CihxSpec(width=plan.width, height=plan.height,
                    total_frames=plan.frames, record_rate=plan.record_rate,
                    bit_depth=plan.bit_depth)
    meta = write_recording(directory, plan.name, frames, spec=spec)
    del frames
    _fsync(meta)
    _fsync(meta.with_suffix(".mraw"))
    return str(meta)


def write_library(directory: str, plans: List[RecordingPlan], pool,
                  wait: bool = True):
    """Write every plan into ``directory`` through ``pool`` (an executor
    of worker processes): the metadata paths in plan order, or with
    ``wait=False`` the futures of them."""
    Path(directory).mkdir(parents=True, exist_ok=True)
    futures = [pool.submit(write_recording_plan, directory, p) for p in plans]
    return [f.result() for f in futures] if wait else futures
