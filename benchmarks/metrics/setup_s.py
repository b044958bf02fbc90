"""``setup_s``: seconds from the process's start to the window's start
(imports, the card's start, synthesizing the recordings, the warm pass
that builds or loads the kernels). Host clock."""


def read(record):
    return record.get("setup_s")
