"""The port's process-level runner (``hsip_tpu_torch.parallel``) and the
command line's ``--distributed``, on two real ``torch.distributed`` processes.

In-process: the serial identity of every collective, and the index
distribution and serial maps held against ``hsip_tpu.parallel.
TPUVideoProcessor``. Across a process boundary (gloo over
``tcp://127.0.0.1``, the CPU): the collectives as ``tests/test_distributed.py``
asserts them for the JAX package, and the CLI over three tiny recordings —
each rank writes a disjoint subset, and the union is byte-identical to the
single-process run (tolerance: none), per file and with ``--library``.

Six processes are started in all (three tests, two ranks each): the
collectives' workers also drive the ``--library`` route through
``hsip_tpu_torch.cli.main`` on the group they formed, and the per-file route
runs as ``python -m hsip_tpu_torch.cli``, as does ``--library --mesh 2``
(each rank's two slots on the CPU). Every wait is bounded and every rank
left over is killed.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hsip_tpu.parallel import TPUVideoProcessor  # noqa: E402

import hsip_tpu  # noqa: E402
import hsip_tpu_torch  # noqa: E402
import hsip_tpu_torch.cli as port_cli  # noqa: E402
from hsip_tpu_torch.io import (  # noqa: E402
    CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
)
from hsip_tpu_torch.parallel import VideoProcessor, initialize_distributed  # noqa: E402

_REPO_ROOT = str(Path(__file__).resolve().parent.parent)
_RANK_TIMEOUT_S = 240


# ---- in process ----

def test_serial_collectives_are_the_identity():
    p = VideoProcessor()
    assert (p.rank, p.size, p.is_root, p.is_parallel) == (0, 1, True, False)
    assert repr(p) == "<VideoProcessor rank=0/1 mode=serial>"
    obj = {"k": [1, 2]}
    assert p.broadcast(obj) is obj
    assert p.gather(obj) == [obj] and p.allgather(obj) == [obj]
    assert p.scatter(["a", "b"]) == "a" and p.scatter(None) is None
    arr = np.arange(3.0)
    assert p.allreduce_sum(arr) is arr and p.reduce_sum(arr) is arr
    p.barrier()
    assert VideoProcessor(use_distributed=True).is_parallel is False
    assert hsip_tpu_torch.VideoProcessor is VideoProcessor


def test_distribute_indices_equal_the_jax_class():
    port, ref = VideoProcessor(), TPUVideoProcessor(use_distributed=False)
    cases = 0
    for size in range(1, 5):
        for rank in range(size):
            port._rank = ref._rank = rank
            port._size = ref._size = size
            for total in range(21):
                for strategy in ("round_robin", "contiguous"):
                    assert port.distribute_indices(total, strategy) == \
                        ref.distribute_indices(total, strategy)
                    cases += 1
    assert cases == 10 * 21 * 2
    for proc in (port, ref):
        with pytest.raises(ValueError, match="Unknown distribution strategy: x"):
            proc.distribute_indices(4, "x")
    # Every index lands on exactly one rank.
    for strategy in ("round_robin", "contiguous"):
        seen = []
        for rank in range(3):
            port._rank, port._size = rank, 3
            seen += port.distribute_indices(11, strategy)
        assert sorted(seen) == list(range(11))


def _tiny_collection_dir(directory, n_videos=3):
    for i in range(n_videos):
        frames, _ = synthesize_flame_video(
            16, height=32, width=256,
            flame=FlameSpec(x0=30, v0_px=7 + i, ignition_frame=2, seed=i))
        write_recording(directory, f"dist-run-{i + 1}-a", frames,
                        spec=CihxSpec(width=256, height=32, total_frames=16,
                                      record_rate=100_000, bit_depth=12))
    return directory


def test_serial_maps_equal_the_jax_class(tmp_path):
    d = _tiny_collection_dir(tmp_path / "v", n_videos=2)
    port, ref = VideoProcessor(), TPUVideoProcessor(use_distributed=False)
    with hsip_tpu_torch.open_collection(str(d)) as cp, \
            hsip_tpu.open_collection(str(d)) as cj:
        def frame_fn(frame, g):
            return int(frame.sum()) + g

        def video_fn(video, v):
            return (len(video), int(video[0].max()), v)

        for kw in (dict(), dict(distribution="contiguous"),
                   dict(gather_results=False)):
            got = port.process_collection(cp, frame_fn, **kw)
            assert got == ref.process_collection(cj, frame_fn, **kw)
            assert [g for g, _ in got] == list(range(32))
        assert port.process_videos(cp, video_fn) == ref.process_videos(cj, video_fn)


def test_local_device(monkeypatch):
    p = VideoProcessor()
    assert p.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p.local_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    # Two ranks on a one-card machine share cuda:0.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for rank in (0, 1):
        p._rank = rank
        assert p.local_device("cuda") == torch.device("cuda", 0)
        assert p.local_device(None) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    p._rank = 5
    assert p.local_device("cuda") == torch.device("cuda", 1)
    assert p.local_device("cuda:3") == torch.device("cuda", 3)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert p.local_device("cuda") == torch.device("cuda", 2)
    assert p.local_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device 7"):
        p.local_device("cuda:7")


def test_initialize_needs_an_address_or_the_environment(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        initialize_distributed()
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize_distributed(coordinator_address="127.0.0.1:1")
    assert not torch.distributed.is_initialized()


def test_cli_distributed_without_a_launcher_fails(tmp_path, monkeypatch, capsys):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    out = tmp_path / "o"
    rc = port_cli.main(["--video-path", str(tmp_path), "--output-dir", str(out),
                        "--distributed", "--device", "cpu"])
    assert rc not in (0, None)
    assert "--distributed:" in capsys.readouterr().err
    assert not out.exists()


# ---- two gloo processes ----

_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np

    coord, pid, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    from hsip_tpu_torch.parallel import VideoProcessor, initialize_distributed

    initialize_distributed(coordinator_address=coord, num_processes=2,
                           process_id=pid, timeout_s=120)
    initialize_distributed(coordinator_address=coord, num_processes=2,
                           process_id=pid, timeout_s=120)  # idempotent
    p = VideoProcessor()
    assert p.is_parallel and p.size == 2 and p.rank == pid, (p.rank, p.size)
    assert repr(p) == f"<VideoProcessor rank={pid}/2 mode=parallel>"
    assert str(p.local_device("cpu")) == "cpu"

    # distribute_indices covers all items disjointly.
    mine = p.distribute_indices(7)
    allidx = p.allgather(mine)
    flat = sorted(i for sub in allidx for i in sub)
    assert flat == list(range(7)), flat
    assert allidx[pid] == mine

    # broadcast: root's object everywhere.
    obj = {"token": "root-data", "rank": p.rank} if p.is_root else None
    got = p.broadcast(obj)
    assert got["token"] == "root-data" and got["rank"] == 0, got
    assert p.broadcast(f"from-{p.rank}", root=1) == "from-1"

    # gather: root sees both payloads in rank order.
    g = p.gather(f"payload-{p.rank}")
    if p.is_root:
        assert g == ["payload-0", "payload-1"], g
    else:
        assert g is None

    # scatter: each process gets its element.
    s = p.scatter(["a", "b"] if p.is_root else None)
    assert s == ["a", "b"][p.rank], s

    # allreduce_sum / reduce_sum over arrays.
    arr = np.full(3, float(p.rank + 1))
    total = p.allreduce_sum(arr)
    np.testing.assert_array_equal(total, np.full(3, 3.0))
    assert total.dtype == np.float64
    r = p.reduce_sum(arr)
    assert (r is None) == (not p.is_root)

    # process_videos over a shared list: sorted on root, None elsewhere.
    res = p.process_videos(["x", "y", "z"], lambda v, i: v * (i + 1))
    assert res == ([(0, "x"), (1, "yy"), (2, "zzz")] if p.is_root else None)

    # The serve-mode stop decision: any rank's flag stops all.
    assert any(p.allgather(p.rank == 1))
    p.barrier()

    # The CLI's library route on this group (initialize is idempotent).
    from hsip_tpu_torch.cli import main

    rc = main(["--video-path", work + "/v", "--output-dir", work + "/out-lib",
               "--calibration", "0.000833333", "--no-images", "--no-sequences",
               "--library", "--distributed", "--coordinator", coord,
               "--num-processes", "2", "--process-id", str(pid),
               "--device", "cpu"])
    assert rc == 0, rc
    print(f"RANK{pid}_OK")
    """
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(commands):
    """Start one process per command; (returncode, stdout, stderr) each.
    Every wait is bounded and no rank outlives the call."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p)
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for cmd in commands]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=_RANK_TIMEOUT_S)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
    return outs


def _tables(out):
    return {p.name: p.read_bytes()
            for p in sorted(Path(out).glob("*-flame-position*.txt"))}


def _rank_files(out):
    """The recordings each rank's run summary lists."""
    names = ["run-summary.json", "run-summary.rank1.json"]
    return [sorted(f["file"] for f in json.loads((out / n).read_text())["files"])
            for n in names]


def _single_process_tables(videos, out, *flags):
    assert port_cli.main(["--video-path", str(videos), "--output-dir", str(out),
                          "--calibration", "0.000833333", "--no-images",
                          "--no-sequences", "--quiet", "--device", "cpu",
                          *flags]) == 0
    return _tables(out)


_ALL = ["dist-run-1-a.cihx", "dist-run-2-a.cihx", "dist-run-3-a.cihx"]


def test_two_process_collectives_and_library_route(tmp_path):
    videos = _tiny_collection_dir(tmp_path / "v")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_ranks([[sys.executable, str(script), coord, str(i), str(tmp_path)]
                       for i in range(2)])
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {i} failed:\n{out}\n{err[-3000:]}"
        assert f"RANK{i}_OK" in out
    # Only the root announces the run and its end.
    assert "Running distributed: 2 processes" in outs[0][1]
    assert "Processing complete!" in outs[0][1]
    assert "Processing complete!" not in outs[1][1]
    assert "Running distributed" not in outs[1][1]
    mine, theirs = _rank_files(tmp_path / "out-lib")
    assert mine == [_ALL[0], _ALL[2]] and theirs == [_ALL[1]]
    want = _single_process_tables(videos, tmp_path / "single", "--library")
    assert len(want) >= 3 and _tables(tmp_path / "out-lib") == want


def test_two_rank_cli_per_file(tmp_path, capsys):
    videos = _tiny_collection_dir(tmp_path / "v")
    out = tmp_path / "out"
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_ranks([
        [sys.executable, "-m", "hsip_tpu_torch.cli", "--video-path", str(videos),
         "--output-dir", str(out), "--calibration", "0.000833333",
         "--no-images", "--no-sequences", "--distributed", "--coordinator",
         coord, "--num-processes", "2", "--process-id", str(i),
         "--device", "cpu"]
        for i in range(2)])
    for i, (rc, stdout, err) in enumerate(outs):
        assert rc == 0, f"rank {i} failed:\n{stdout}\n{err[-3000:]}"
    assert "Running distributed: 2 processes" in outs[0][1]
    assert outs[0][1].count("Processing complete!") == 1
    assert "Processing complete!" not in outs[1][1]
    # Disjoint subsets, round robin; verbose output comes from the root only.
    mine, theirs = _rank_files(out)
    assert mine == [_ALL[0], _ALL[2]] and theirs == [_ALL[1]]
    assert outs[0][1].count("Loading:") == 2 and "Loading:" not in outs[1][1]
    want = _single_process_tables(videos, tmp_path / "single")
    assert len(want) >= 3 and _tables(out) == want
    capsys.readouterr()


def test_two_rank_cli_library_mesh(tmp_path, capsys):
    """``--distributed --library --mesh 2``: each rank shards its own
    recordings over its own two CPU slots; the union of the ranks' tables
    is byte-identical to the single-process library run."""
    videos = _tiny_collection_dir(tmp_path / "v")
    out = tmp_path / "out"
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_ranks([
        [sys.executable, "-m", "hsip_tpu_torch.cli", "--video-path", str(videos),
         "--output-dir", str(out), "--calibration", "0.000833333",
         "--no-images", "--no-sequences", "--library", "--mesh", "2",
         "--distributed", "--coordinator", coord, "--num-processes", "2",
         "--process-id", str(i), "--device", "cpu"]
        for i in range(2)])
    for i, (rc, stdout, err) in enumerate(outs):
        assert rc == 0, f"rank {i} failed:\n{stdout}\n{err[-3000:]}"
    assert "Sharding video axis over 2 devices per process" in outs[0][1]
    assert outs[0][1].count("Processing complete!") == 1
    mine, theirs = _rank_files(out)
    assert mine == [_ALL[0], _ALL[2]] and theirs == [_ALL[1]]
    want = _single_process_tables(videos, tmp_path / "single", "--library")
    assert len(want) >= 3 and _tables(out) == want
    capsys.readouterr()
