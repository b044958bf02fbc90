"""The public surface of the port (``hsip_tpu_torch``), after
``tests/test_api_surface.py``: every exported name resolves, the lazy names
resolve, the package and its tracking layer import without torch, and the
small copies this surface carries equal their originals.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import hsip_tpu.pipeline as jax_pipeline  # noqa: E402
import hsip_tpu.track as jax_track  # noqa: E402

import hsip_tpu_torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("module", [
    "hsip_tpu_torch", "hsip_tpu_torch.io", "hsip_tpu_torch.track",
    "hsip_tpu_torch.parallel", "hsip_tpu_torch.pipeline", "hsip_tpu_torch.utils",
    "hsip_tpu_torch.cli",
])
def test_every_exported_name_resolves(module):
    mod = importlib.import_module(module)
    assert mod.__all__ and len(set(mod.__all__)) == len(mod.__all__)
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name


def test_top_level_exports_follow_the_jax_package():
    import hsip_tpu

    renamed = {"TPUVideoProcessor": "VideoProcessor"}
    # parse_cihx_xml lives in hsip_tpu_torch.io only.
    for name in set(hsip_tpu.__all__) - {"parse_cihx_xml"}:
        assert renamed.get(name, name) in hsip_tpu_torch.__all__, name
    from hsip_tpu_torch.parallel import VideoProcessor
    from hsip_tpu_torch.track import FlameDetector, FlameDetectorConfig

    assert hsip_tpu_torch.VideoProcessor is VideoProcessor
    assert hsip_tpu_torch.FlameDetector is FlameDetector
    assert hsip_tpu_torch.FlameDetectorConfig is FlameDetectorConfig
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        hsip_tpu_torch.nope


def test_track_exports_follow_the_jax_package():
    import hsip_tpu_torch.track as track

    renamed = {"device_tracking_scan": "tracking_scan_plain"}
    assert sorted(track.__all__) == sorted(renamed.get(n, n)
                                           for n in jax_track.__all__)
    for name in ("track_collection_device", "ScanHistory", "tracking_scan_plain",
                 "DeviceScanResult"):
        assert getattr(track, name) is not None, name
    assert track.DETECTION_METHODS == jax_track.DETECTION_METHODS
    with pytest.raises(AttributeError):
        track.device_tracking_scan
    from hsip_tpu_torch.track.scan import compute_profiles_batched, track_video  # noqa: F401


def test_processor_has_the_collective_and_map_methods():
    from hsip_tpu_torch.parallel import VideoProcessor, initialize_distributed

    for name in ("allgather", "process_collection", "process_videos",
                 "reduce_sum", "allreduce_sum", "distribute_indices",
                 "broadcast", "gather", "scatter", "barrier"):
        assert callable(getattr(VideoProcessor, name)), name
    assert callable(VideoProcessor.local_device)
    assert callable(initialize_distributed)
    import hsip_tpu_torch.parallel as par

    # The names of hsip_tpu.parallel, VideoProcessor for TPUVideoProcessor.
    assert sorted(par.__all__) == [
        "VideoProcessor", "frame_sharding", "initialize_distributed",
        "make_mesh", "make_sharded_profile_fn", "sharded_centerline_profiles",
        "video_frame_mesh"]
    for name in par.__all__:
        assert callable(getattr(par, name)), name
    from hsip_tpu_torch.parallel.dryrun import (  # noqa: F401
        build_multichip_step, run_multichip_dryrun, run_pipeline_dryrun)


def test_cli_entry_points():
    from hsip_tpu_torch.cli import build_parser, entry, load_config, main  # noqa: F401

    assert build_parser().prog == "hsip-torch"
    text = (REPO / "pyproject.toml").read_text()
    assert 'hsip-torch = "hsip_tpu_torch.cli:entry"' in text
    assert 'hsip = "hsip_tpu.cli:entry"' in text


def test_utils_profile_trace_is_a_no_op_without_a_directory(tmp_path):
    from hsip_tpu_torch.utils import profile_trace

    with profile_trace(None):
        pass
    assert list(tmp_path.iterdir()) == []
    with profile_trace(str(tmp_path / "t"), device="cpu"):
        torch.ones(4).sum()
    traces = list((tmp_path / "t").iterdir())
    assert len(traces) == 1 and traces[0].stat().st_size > 0


_FRESH = r"""
import sys
import hsip_tpu_torch
import hsip_tpu_torch.track
import hsip_tpu_torch.cli
from hsip_tpu_torch.track import FlameDetectorConfig
from hsip_tpu_torch import FlameDetector
assert hsip_tpu_torch.FlameDetectorConfig is FlameDetectorConfig
heavy = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "hsip_tpu"))
assert heavy == [], heavy[:5]
from hsip_tpu_torch import VideoProcessor
assert "torch" in sys.modules
print("ok")
"""


def test_plain_imports_leave_torch_out():
    """`import hsip_tpu_torch`, `.track` and `.cli` import no torch (nor jax,
    nor the JAX package); the processor, asked for by name, does."""
    proc = subprocess.run([sys.executable, "-c", _FRESH], capture_output=True,
                          text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_write_results_equals_the_original(tmp_path):
    from hsip_tpu_torch.pipeline import write_results

    table = {"#Frame": [0, 1, 2], "Time_s": [0.0, 1e-5, 2e-5],
             "Label": ["a", None, "c"], "Pos": [1.5, float("nan"), 3]}
    for doc in (table, {}, {"only": []}):
        got = write_results(doc, tmp_path / "port.txt")
        want = jax_pipeline.write_results(doc, tmp_path / "jax.txt")
        assert got == tmp_path / "port.txt"
        assert got.read_bytes() == want.read_bytes()
    write_results(table, tmp_path / "port.txt")
    assert (tmp_path / "port.txt").read_text().splitlines()[:2] == \
        ["#Frame Time_s Label Pos", "0 0.0 a 1.5"]


def _code_without_docstrings(path):
    """The file's syntax tree with every docstring dropped."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_video_copy_has_the_originals_code_and_its_own_words():
    port = REPO / "hsip_tpu_torch" / "video.py"
    original = REPO / "hsip_tpu" / "video.py"
    assert _code_without_docstrings(port) == _code_without_docstrings(original)
    text = port.read_text()
    for stale in ("hsip_tpu.io", "hsip_tpu.kernels", "jax.device_put",
                  "unpack_12bit_tpu", "TPU"):
        assert stale not in text, stale
    from hsip_tpu_torch.kernels.unpack import unpack_12bit  # noqa: F401

    assert "hsip_tpu_torch.kernels.unpack.unpack_12bit" in text
