"""Collection layer: batch access to multiple recordings.

Copy of :mod:`hsip_tpu.collection` over this package's
:class:`~hsip_tpu_torch.video.PhotonVideo`: global frame addressing over a
list of videos, directory/file constructors with skip-on-failure, batch
map/iter, shared calibration/trigger setters, and
:meth:`VideoCollection.batch_plan` (pad-and-mask metadata over the video
axis).
"""

from __future__ import annotations

import bisect
from pathlib import Path
from typing import Any, Callable, Iterator, List, Optional, Set, Tuple, Union

import numpy as np

from .video import PhotonVideo, SpatialCalibration

__all__ = ["VideoCollection"]


class VideoCollection:
    """A list of :class:`PhotonVideo` with global frame indexing.

    Frames of all member videos form one contiguous address space, so a
    whole experiment's worth of recordings can be indexed, iterated and
    mapped as if it were a single long video::

        coll = VideoCollection.from_directory("Nova-Video-Files")
        vid_idx, local = coll.global_to_local(1000)
        profiles = coll.map_frames(extract_centerline)
    """

    def __init__(
        self,
        videos: List[PhotonVideo],
        metadata_fields: Optional[Set[str]] = None,
    ):
        self._videos = videos
        self._metadata_fields = metadata_fields
        self._build_index()

    def _build_index(self) -> None:
        """Cumulative-length table for global frame addressing."""
        self._cumulative_lengths = [0]
        for video in self._videos:
            self._cumulative_lengths.append(self._cumulative_lengths[-1] + len(video))
        self._total_frames = self._cumulative_lengths[-1]

    @classmethod
    def from_directory(
        cls,
        directory: Union[str, Path],
        pattern: str = "*.cihx",
        recursive: bool = False,
        metadata_fields: Optional[Set[str]] = None,
        calibration: Optional[SpatialCalibration] = None,
        trigger_frame: Optional[int] = None,
    ) -> "VideoCollection":
        """Open every matching file under ``directory``; unloadable files are
        skipped with a printed warning (never fatal)."""
        path = Path(directory)
        if not path.exists():
            raise FileNotFoundError(f"Directory not found: {directory}")

        files = sorted(path.rglob(pattern) if recursive else path.glob(pattern))

        videos = []
        for f in files:
            try:
                videos.append(
                    PhotonVideo(
                        str(f),
                        metadata_fields=metadata_fields,
                        calibration=calibration,
                        trigger_frame=trigger_frame,
                    )
                )
            except Exception as e:  # noqa: BLE001 — skip-and-warn by contract
                print(f"Warning: skipping unreadable recording {f} ({e})")

        return cls(videos, metadata_fields)

    @classmethod
    def from_files(
        cls,
        filepaths: List[Union[str, Path]],
        metadata_fields: Optional[Set[str]] = None,
        calibration: Optional[SpatialCalibration] = None,
        trigger_frame: Optional[int] = None,
    ) -> "VideoCollection":
        """Open an explicit list of files (failures raise)."""
        videos = [
            PhotonVideo(
                str(fp),
                metadata_fields=metadata_fields,
                calibration=calibration,
                trigger_frame=trigger_frame,
            )
            for fp in filepaths
        ]
        return cls(videos, metadata_fields)

    # -- container protocol ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._videos)

    def __iter__(self) -> Iterator[PhotonVideo]:
        return iter(self._videos)

    def __getitem__(self, idx: int) -> PhotonVideo:
        return self._videos[idx]

    @property
    def videos(self) -> List[PhotonVideo]:
        return self._videos.copy()

    @property
    def total_frames(self) -> int:
        return self._total_frames

    @property
    def filepaths(self) -> List[Path]:
        return [v.filepath for v in self._videos]

    # -- global frame addressing ------------------------------------------------

    def get_global_frame(self, global_idx: int) -> np.ndarray:
        """Frame by global index across the whole collection."""
        video_idx, local_idx = self._resolve_global_index(global_idx)
        return self._videos[video_idx][local_idx]

    def get_global_time(self, global_idx: int) -> float:
        """Trigger-relative time of a global frame index."""
        video_idx, local_idx = self._resolve_global_index(global_idx)
        return self._videos[video_idx].get_time(local_idx)

    def _resolve_global_index(self, global_idx: int) -> Tuple[int, int]:
        """Global index → (video_idx, local_idx); supports negatives.

        O(log n) bisect over the cumulative table (the reference's linear
        scan at collection.py:229-232 is O(n))."""
        if global_idx < 0:
            global_idx = self._total_frames + global_idx
        if global_idx < 0 or global_idx >= self._total_frames:
            raise IndexError(
                f"global frame {global_idx} outside the collection "
                f"(holds {self._total_frames} frames)"
            )
        video_idx = bisect.bisect_right(self._cumulative_lengths, global_idx) - 1
        return video_idx, global_idx - self._cumulative_lengths[video_idx]

    def global_to_local(self, global_idx: int) -> Tuple[int, int]:
        """Public wrapper for global → (video_idx, local_idx)."""
        return self._resolve_global_index(global_idx)

    def local_to_global(self, video_idx: int, local_idx: int) -> int:
        """(video_idx, local_idx) → global index."""
        if video_idx < 0 or video_idx >= len(self._videos):
            raise IndexError(
                f"no video at index {video_idx} "
                f"(collection holds {len(self._videos)})"
            )
        return self._cumulative_lengths[video_idx] + local_idx

    # -- batch operations -----------------------------------------------------------

    def map_frames(
        self,
        func: Callable[[np.ndarray, int, int], Any],
        frame_indices: Optional[List[int]] = None,
        video_indices: Optional[List[int]] = None,
    ) -> List[Any]:
        """Apply ``func(frame, video_idx, frame_idx)`` over frames.

        ``frame_indices`` selects global indices; otherwise all frames of all
        (or the selected) videos are visited in order.
        """
        results = []
        if frame_indices is not None:
            for global_idx in frame_indices:
                video_idx, local_idx = self._resolve_global_index(global_idx)
                frame = self._videos[video_idx][local_idx]
                results.append(func(frame, video_idx, local_idx))
        else:
            videos_to_process = (
                video_indices if video_indices is not None else range(len(self._videos))
            )
            for video_idx in videos_to_process:
                video = self._videos[video_idx]
                for frame_idx in range(len(video)):
                    results.append(func(video[frame_idx], video_idx, frame_idx))
        return results

    def iter_frames(self) -> Iterator[Tuple[np.ndarray, int, int, float]]:
        """Yield (frame, video_idx, frame_idx, trigger-relative time)."""
        for video_idx, video in enumerate(self._videos):
            for frame_idx in range(len(video)):
                yield video[frame_idx], video_idx, frame_idx, video.get_time(frame_idx)

    def set_calibration_all(
        self,
        scale: float,
        units: str = "m",
        origin_x: float = 0.0,
        origin_y: float = 0.0,
    ) -> "VideoCollection":
        """Set the same calibration on every video; returns self."""
        for video in self._videos:
            video.set_calibration(scale, units, origin_x, origin_y)
        return self

    def set_trigger_frame_all(self, frame_index: int) -> "VideoCollection":
        """Set the same trigger frame on every video; returns self."""
        for video in self._videos:
            video.set_trigger_frame(frame_index)
        return self

    # -- batching metadata --------------------------------------------------------------

    def batch_plan(self) -> dict:
        """Static-shape batching metadata for sharded device pipelines.

        Returns dict with ``max_frames``, ``max_height``, ``max_width``,
        ``lengths`` (per-video frame counts) and ``pad_mask`` of shape
        (n_videos, max_frames) — the pad-and-mask contract of a
        fixed-shape video axis.
        """
        lengths = np.array([len(v) for v in self._videos], dtype=np.int32)
        max_frames = int(lengths.max()) if len(lengths) else 0
        heights = [v.height for v in self._videos]
        widths = [v.width for v in self._videos]
        pad_mask = (
            np.arange(max_frames)[None, :] < lengths[:, None]
            if len(lengths)
            else np.zeros((0, 0), dtype=bool)
        )
        return {
            "max_frames": max_frames,
            "max_height": max(heights) if heights else 0,
            "max_width": max(widths) if widths else 0,
            "lengths": lengths,
            "pad_mask": pad_mask,
        }

    # -- reporting & lifecycle ---------------------------------------------------------

    def summary(self) -> str:
        """Human-readable multi-line summary."""
        header = (
            f"VideoCollection \u2014 {len(self)} videos, "
            f"{self.total_frames} frames"
        )
        lines = [header, "=" * len(header)]
        for i, video in enumerate(self._videos):
            lines.append(
                f"  #{i} {video.filepath.name} \u2014 {len(video)} frames "
                f"@ {video.frame_rate:g} fps"
            )
        return "\n".join(lines)

    def close_all(self) -> None:
        for video in self._videos:
            video.close()

    def __enter__(self) -> "VideoCollection":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close_all()

    def __repr__(self) -> str:
        return (
            f"VideoCollection(n_videos={len(self)}, "
            f"n_frames={self.total_frames})"
        )
