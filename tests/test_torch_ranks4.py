"""Four ``--distributed`` ranks over one source, as the benchmark's
``nova_ranks4`` deployment runs them: four gloo processes on the CPU, each
``hsip_tpu_torch.cli.main`` with README's manual launch (``--config
<toml> --distributed --coordinator 127.0.0.1:PORT --num-processes 4
--process-id r --library``), over seeded synthetic 12-bit recordings under
the Nova source of ``benchmarks/configs/nova_ranks4.json``.

Two sources: 8 recordings (two a rank) and 3 (fewer than ranks, so rank 3
gets none and must still meet the barriers). The same four processes run
both, one after the other on the group the first formed. Every table must
equal the one-process library run's byte for byte and the plain NumPy
reference's (``benchmarks/reference``) row for row; each recording is
written by exactly one rank; the ranks' ``count.rank_recordings`` add up
to the recordings; each rank times its barriers as ``rank_wait``, and a
run without a processor has none of it.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import hsip_tpu_torch.cli as port_cli  # noqa: E402
import hsip_tpu_torch.pipeline as port_pipeline  # noqa: E402
from hsip_tpu_torch.io import (  # noqa: E402
    CihxSpec, FlameSpec, synthesize_flame_video, write_recording,
)
from hsip_tpu_torch.utils.profiling import StageTimes  # noqa: E402

_REPO = Path(__file__).resolve().parent.parent
_BENCH = _REPO / "benchmarks"
_CONFIG = json.loads((_BENCH / "configs" / "nova_ranks4.json").read_text())
_RANKS = _CONFIG["deployment"]["ranks"]
_RANK_TIMEOUT_S = 180
_CASES = {"8": 8, "3": 3}
_FRAMES, _HEIGHT, _WIDTH = 48, 48, 256

_WORKER = textwrap.dedent(
    """
    import json, sys
    from pathlib import Path

    import hsip_tpu_torch.pipeline as pipeline
    from hsip_tpu_torch.cli import main
    from hsip_tpu_torch.utils.profiling import StageTimes

    coord, rank, ranks = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jobs = json.loads(sys.argv[4])
    library = pipeline.process_video_source_library
    for config, stages_path in jobs:
        stages = StageTimes()

        def tracked(*args, **kwargs):
            kwargs["stage_times"] = stages
            return library(*args, **kwargs)

        pipeline.process_video_source_library = tracked
        rc = main(["--config", config, "--distributed", "--coordinator", coord,
                   "--num-processes", ranks, "--process-id", str(rank),
                   "--library", "--no-images", "--no-sequences", "--quiet",
                   "--device", "cpu"])
        assert rc == 0, rc
        Path(stages_path).write_text(json.dumps(stages.as_dict(ndigits=9)))
    print(f"RANK{rank}_OK")
    """
)


def _toml(value):
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, list):
        return "[" + ", ".join(_toml(v) for v in value) + "]"
    return repr(value)


def _write_config(path, videos, out):
    """A user's TOML for the deployment's source (as ``examples/run.toml``)."""
    src = dict(_CONFIG["source"], video_path=str(videos), output_dir=str(out))
    cals = src.pop("file_calibrations")
    lines = ["[[source]]"] + [f"{k} = {_toml(v)}" for k, v in src.items()]
    for cal in cals:
        lines += ["", "[[source.file_calibration]]"]
        lines += [f"{k} = {_toml(v)}" for k, v in cal.items()]
    lines += ["", "[detector]"]
    lines += [f"{k} = {_toml(v)}" for k, v in _CONFIG["detector"].items()]
    path.write_text("\n".join(lines) + "\n")
    return path


def _write_source(directory, n):
    """``n`` recordings under the configuration's names, every second one
    with a DDT jump."""
    names = _CONFIG["recording_names"]
    spec = CihxSpec(width=_WIDTH, height=_HEIGHT, total_frames=_FRAMES,
                    record_rate=100_000, bit_depth=12)
    for i in range(n):
        # A jump of 24 px/frame is 2000 m/s at the Nova calibration and
        # 100,000 fps, over the reference's 1250 m/s DDT rule.
        ddt = dict(ddt_frame=24 + i % 4, v_jump_px=24.0) if i % 2 else {}
        flame = FlameSpec(x0=30.0, v0_px=0.4 + 0.05 * i, ignition_frame=2 + i % 5,
                          seed=1000 + i, **ddt)
        frames, _ = synthesize_flame_video(_FRAMES, height=_HEIGHT, width=_WIDTH,
                                           flame=flame)
        write_recording(directory, names[i % len(names)].format(i=i + 1), frames,
                        spec=spec)
    return sorted(Path(directory).glob("*.cihx"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tables(out):
    return {p.name: p.read_bytes()
            for p in sorted(Path(out).glob("*-flame-position*.txt"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's recordings, the four ranks' output and stages, and the
    one-process library run's tables and stages."""
    root = tmp_path_factory.mktemp("ranks4")
    cases, jobs = {}, []
    for case, n in _CASES.items():
        videos = root / case / "videos"
        metas = _write_source(videos, n)
        out = root / case / "out"
        config = _write_config(root / case / "run.toml", videos, out)
        cases[case] = {"metas": metas, "out": out, "config": config,
                       "stages": [root / case / f"stages.rank{r}.json"
                                  for r in range(_RANKS)]}
        jobs.append([[str(config), str(s)] for s in cases[case]["stages"]])

    script = root / "worker.py"
    script.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(r), str(_RANKS),
         json.dumps([job[r] for job in jobs])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(_RANKS)]
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
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}\n{err[-3000:]}"
        assert f"RANK{r}_OK" in out

    for case, c in cases.items():
        c["rank_stages"] = [json.loads(p.read_text()) for p in c["stages"]]
        single = c["out"].parent / "single"
        config = _write_config(c["out"].parent / "single.toml",
                               c["metas"][0].parent, single)
        stages = StageTimes()
        library = port_pipeline.process_video_source_library

        def tracked(*args, **kwargs):
            kwargs["stage_times"] = stages
            return library(*args, **kwargs)

        port_pipeline.process_video_source_library = tracked
        try:
            assert port_cli.main(["--config", str(config), "--library",
                                  "--no-images", "--no-sequences", "--quiet",
                                  "--device", "cpu"]) == 0
        finally:
            port_pipeline.process_video_source_library = library
        c["single"] = _tables(single)
        c["single_stages"] = stages.as_dict(ndigits=9)
    cases["stdout"] = [out for _, out, _ in outs]
    return cases


def _reference():
    spec = importlib.util.spec_from_file_location(
        "hsip_bench_reference", _BENCH / "reference" / "__init__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", sorted(_CASES))
def test_four_ranks_write_the_one_process_tables(runs, case):
    c = runs[case]
    # Every recording ignites, so each writes at least its full table.
    assert len(c["single"]) >= _CASES[case]
    assert _tables(c["out"]) == c["single"]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_four_ranks_match_the_plain_reference(runs, case):
    reference = _reference()
    c = runs[case]
    post_ddt = 0
    for meta in c["metas"]:
        expect = reference.reference_tables(meta, _CONFIG["source"],
                                            _CONFIG["detector"])
        for kind in reference.TABLE_KINDS:
            path = c["out"] / f"{meta.stem}{reference.table_suffix(kind)}"
            got = path.read_text() if path.exists() else None
            assert (got is None) == (kind not in expect), (meta.name, kind)
            if got is not None:
                rows = [r for r in got.splitlines() if not r.startswith("#")]
                want = [r for r in expect[kind].splitlines() if not r.startswith("#")]
                assert rows == want, (meta.name, kind)
        post_ddt += "post_ddt" in expect
    assert post_ddt >= 1  # the DDT split is exercised


@pytest.mark.parametrize("case", sorted(_CASES))
def test_each_recording_is_written_by_one_rank(runs, case):
    c = runs[case]
    given = []
    for r in range(_RANKS):
        name = "run-summary.json" if r == 0 else f"run-summary.rank{r}.json"
        path = c["out"] / name
        files = ([f["file"] for f in json.loads(path.read_text())["files"]]
                 if path.exists() else [])
        # Round robin over the sorted source.
        assert files == [m.name for m in c["metas"][r::_RANKS]], r
        given += files
    assert sorted(given) == [m.name for m in c["metas"]]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_rank_counters_add_up(runs, case):
    stages = runs[case]["rank_stages"]
    per_rank = [s["count.rank_recordings"] for s in stages]
    assert per_rank == [len(range(r, _CASES[case], _RANKS)) for r in range(_RANKS)]
    assert sum(per_rank) == _CASES[case]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_every_rank_times_its_waits(runs, case):
    for r, stages in enumerate(runs[case]["rank_stages"]):
        assert "rank_wait" in stages, r
        # rank_wait nests inside the ledger stage
        assert 0 <= stages["rank_wait"] <= stages["ledger"], r


def test_without_a_processor_there_is_no_rank_wait(runs):
    for case in _CASES:
        stages = runs[case]["single_stages"]
        assert "ledger" in stages
        assert not {"rank_wait", "count.rank_recordings"} & set(stages)


def test_only_the_root_announces_the_run(runs):
    root, *others = runs["stdout"]
    assert root.count(f"Running distributed: {_RANKS} processes") == len(_CASES)
    assert root.count("Processing complete!") == len(_CASES)
    for out in others:
        assert "Running distributed" not in out and "Processing complete!" not in out
