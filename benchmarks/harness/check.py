"""What decides ``correct``: the tables the window's calls wrote against
the plain reference's.

Every call of the window writes into a directory of its own, so every
answer that came due is compared, not only the last. The numbers compared
are two shares:

* ``rows_off_pct``: of all the data rows the reference expects over every
  table of every recording that every call handled, the share (in
  percent) that the program wrote differently, did not write, or wrote
  beyond them. Rows are compared as text, in order; a table the program
  should have written and did not counts all its rows, one it wrote and
  should not have counts all of its own.
* ``answers_wrong_pct``: of the answers (one recording's tables from one
  call), the share (in percent) with any row off.
* ``answers_missing``: the answers due that never came: a recording a
  call was due to process and for which it wrote none of the tables the
  reference expects, as where the program warns and skips it. Its limit
  is 0.

Only delivered answers (every expected table on disk) count towards the
frames of ``frames_per_s``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["reference_for", "compare_calls", "rows_of", "checks_of",
           "is_correct"]


def rows_of(text: Optional[str]) -> List[str]:
    """The data rows of a table (the header is not compared)."""
    if text is None:
        return []
    return [line for line in text.splitlines() if not line.startswith("#")]


def _reference_one(args):
    path, source, detector, precision = args
    from reference import reference_tables

    return reference_tables(path, source, detector, precision=precision)


def reference_for(paths: Sequence[str], source: dict, detector: dict, pool,
                  precision: str = "float64") -> List[Dict[str, str]]:
    """The reference's tables of each recording, computed in ``pool``."""
    jobs = [(p, source, detector, precision) for p in paths]
    return list(pool.map(_reference_one, jobs))


def _diff_rows(expect: List[str], got: List[str]) -> int:
    off = sum(a != b for a, b in zip(expect, got))
    return off + abs(len(expect) - len(got))


def compare_calls(calls: List[dict], paths: Sequence[str],
                  expected: List[Dict[str, str]],
                  read_table) -> dict:
    """Compare every call's tables with the reference's.

    ``calls`` holds, a call, ``out_dir`` and ``recordings`` (indices into
    ``paths``: the recordings the call was due to process);
    ``read_table(out_dir, stem, kind)`` returns the text the program wrote
    or None. Returns the counts, the failed answers and, a call, the
    recordings whose expected tables it delivered."""
    from reference import TABLE_KINDS

    rows_expected = rows_off = answers = missing = 0
    wrong = []
    delivered = []
    for call in calls:
        here = []
        for k in call["recordings"]:
            stem = Path(paths[k]).stem
            answers += 1
            off_here = 0
            wrote_any = False
            wrote_expected = True
            for kind in TABLE_KINDS:
                got = read_table(call["out_dir"], stem, kind)
                wrote_any = wrote_any or got is not None
                if kind in expected[k] and got is None:
                    wrote_expected = False
                expect = rows_of(expected[k].get(kind))
                rows_expected += len(expect)
                off_here += _diff_rows(expect, rows_of(got))
            if not wrote_any and expected[k]:
                missing += 1
            if wrote_expected:
                here.append(k)
            if off_here:
                wrong.append((call["index"], stem, off_here))
            rows_off += off_here
        delivered.append(here)
    return {
        "answers": answers,
        "answers_missing": missing,
        "answers_wrong": len(wrong),
        "rows_expected": rows_expected,
        "rows_off": rows_off,
        "rows_off_pct": 100.0 * rows_off / max(rows_expected, 1),
        "answers_wrong_pct": 100.0 * len(wrong) / max(answers, 1),
        "first_wrong": wrong[:5],
        "delivered": delivered,
    }


def checks_of(verdict: dict, limits: Dict[str, float]) -> dict:
    """Each number compared, beside its limit (the configuration's)."""
    return {name: {"value": verdict[name], "limit": limit}
            for name, limit in limits.items()}


def is_correct(verdict: dict, limits: Dict[str, float]) -> bool:
    """``correct``: something was compared, no answer due is missing, and
    every compared number is within its limit."""
    checks = checks_of(verdict, limits)
    return bool(verdict["rows_expected"] > 0 and verdict["answers"] > 0
                and verdict["answers_missing"] == 0
                and all(c["value"] <= c["limit"] for c in checks.values()))


def read_table_file(out_dir, stem, kind) -> Optional[str]:
    from reference import table_suffix

    path = Path(out_dir) / f"{stem}{table_suffix(kind)}"
    try:
        return path.read_text()
    except FileNotFoundError:
        return None
