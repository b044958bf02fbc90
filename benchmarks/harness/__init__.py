"""The benchmark's harness: the cell's files, the set-up, the window, the
traced run and the check of the tables. ``benchmarks/run.py`` is its
entry point."""
