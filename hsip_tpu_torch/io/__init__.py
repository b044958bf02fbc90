"""IO layer (L0): CIHX/CIH metadata parsing, MRAW payload access, synthetic data.

Reference parity: the pyMRAW bridge + CIHX XML parser layer of the reference
(``src/photron/video.py:20-150,332``), rebuilt with an in-tree MRAW decoder
(no pyMRAW dependency) and a packed-bytes staging path for on-device decode.
"""

from .cihx import (
    parse_cihx_xml,
    read_cih_header,
    read_cihx_header,
    read_header,
    extract_cihx_xml_bytes,
)
from .mraw import (
    MRAWReader,
    unpack_12bit,
    pack_12bit,
    unpack_10bit,
    pack_10bit,
    find_mraw_payload,
    frame_nbytes,
)
from .synthetic import (
    CihxSpec,
    FlameSpec,
    write_cihx,
    write_cih,
    write_mraw,
    write_recording,
    synthesize_flame_video,
)

__all__ = [
    "parse_cihx_xml",
    "read_cih_header",
    "read_cihx_header",
    "read_header",
    "extract_cihx_xml_bytes",
    "MRAWReader",
    "unpack_12bit",
    "pack_12bit",
    "unpack_10bit",
    "pack_10bit",
    "find_mraw_payload",
    "frame_nbytes",
    "CihxSpec",
    "FlameSpec",
    "write_cihx",
    "write_cih",
    "write_mraw",
    "write_recording",
    "synthesize_flame_video",
]
