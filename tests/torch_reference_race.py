"""The JAX reference's staging race on the CPU (ROADMAP C.10), measured.

Not collected by a plain ``pytest tests/``; two ways to run it:

- As a script, the probe: ``python tests/torch_reference_race.py --loops
  300 --pipelined [--pin]``. Each loop empties the reference's staging pool
  and runs ``hsip_tpu``'s fused library over the recordings of the two
  parity cases that failed in whole runs, then holds each result against
  the port's per-file run. It prints the route's link answer and, per case
  and per alignment of the pooled buffer (64-byte or not), how many
  reference results were wrong. ``--pipelined`` holds the reference's link
  answer at False (pipelined groups, the route the race lives on);
  ``--aligned`` (with ``--pipelined``) seeds the emptied pool with a
  64-byte-aligned buffer of the groups' shape; ``--pin`` puts private
  copies (``test_torch_library.pin_reference_puts``).
- Given to pytest by name, the parity loops:
  ``LOOPS=50 [EAGER=1] python -m pytest -p no:xdist -p no:randomly
  tests/test_torch_host.py tests/torch_reference_race.py`` runs
  ``test_fused_matches_jax_and_per_file`` and
  ``test_fused_bit_depths_match`` LOOPS times in one process after
  ``test_torch_host.py`` (the order their worker ran them in whole runs),
  with the pin as in ``test_torch_library.py``; ``EAGER=1`` holds the link
  answer at False.
"""

import os
import sys

if __name__ == "__main__":  # under pytest, rootdir and conftest do this
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_max_isa=AVX2")
    import jax

    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hsip_tpu.track.fused as jax_fused  # noqa: E402
import test_torch_library as L  # noqa: E402
from test_torch_library import _reference_puts_copy  # noqa: E402,F401  (autouse pin)

LOOPS = int(os.environ.get("LOOPS", "50"))


@pytest.fixture(autouse=True)
def _eager(monkeypatch):
    if os.environ.get("EAGER") == "1":
        monkeypatch.setattr(jax_fused, "_puts_are_lazy", lambda: False)


@pytest.mark.parametrize("loop", range(LOOPS))
def test_parity_loop(loop, tmp_path, monkeypatch):
    for i, (lengths, mode) in enumerate([((40, 40, 40), None), ((40, 25), None),
                                          ((40, 25, 33), "interpret")]):
        with monkeypatch.context() as mp:
            L.test_fused_matches_jax_and_per_file(tmp_path / f"m{i}", mp, lengths, mode)
    for depth in (8, 10, 12, 16):
        L.test_fused_bit_depths_match(tmp_path / f"b{depth}", depth)


def _probe(loops, pipelined, aligned_pool, pin):
    import tempfile
    from pathlib import Path

    import hsip_tpu.track.batch as jax_batch

    if pipelined:
        jax_fused._puts_are_lazy = lambda: False
    if pin:
        L.pin_reference_puts(pytest.MonkeyPatch())
    print(f"link lazy: {jax_fused._puts_are_lazy()}, aligned pool: {aligned_pool}, "
          f"pin: {pin}", flush=True)
    root = Path(tempfile.mkdtemp(prefix="reference-race-"))
    cases = {"lengths2-interpret": (root / "l2", "interpret"),
             "bit_depths8": (root / "b8", "auto")}
    for i, n in enumerate((40, 25, 33)):
        L._write(root / "l2", f"nova-run-{i + 1}-001", n_frames=n, seed=i + 1)
    L._write(root / "b8", "nova-run-1-001", seed=5, bit_depth=8)
    L._write(root / "b8", "nova-run-2-001", n_frames=28, seed=6, bit_depth=8)
    truth = {name: L._port_per_file(d) for name, (d, _mode) in cases.items()}
    det = L.JaxDetectorConfig()
    band_rows = 2 * L.jax_band_margin(det.morphology_kernel_size,
                                      det.gaussian_sigma) + 1
    depth = {"lengths2-interpret": 12, "bit_depths8": 8}
    counts = {}
    for loop in range(loops):
        for name, (d, mode) in cases.items():
            jax_fused._STAGING_POOL.clear()
            if aligned_pool:  # the one-video groups' buffer
                key = ("buf", (1, 40, band_rows, 384 * depth[name] // 8))
                jax_fused._STAGING_POOL[key] = L._aligned_empty(key[1])
            jax_batch._PALLAS_MODE = mode
            got = L._jax_library(d)
            aligned = any(b.ctypes.data % 64 == 0
                          for b in jax_fused._STAGING_POOL.values())
            try:
                L._assert_same(got, truth[name], "reference library against port per-file")
                wrong = 0
            except (AssertionError, pytest.fail.Exception) as exc:
                wrong = 1
                print(f"loop {loop} {name}: {str(exc)[:300]}", flush=True)
            runs = counts.setdefault((name, aligned), [0, 0])
            runs[0] += 1
            runs[1] += wrong
    for (name, aligned), (runs, wrong) in sorted(counts.items()):
        print(f"{name} aligned={aligned}: {wrong} wrong of {runs}", flush=True)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--loops", type=int, default=100)
    parser.add_argument("--pipelined", action="store_true")
    parser.add_argument("--aligned", action="store_true")
    parser.add_argument("--pin", action="store_true")
    args = parser.parse_args()
    if args.aligned and not args.pipelined:
        parser.error("--aligned seeds the pipelined groups' buffer: add --pipelined")
    _probe(args.loops, args.pipelined, args.aligned, args.pin)
