"""Metadata field filtering for Photron recordings.

Controls which acquisition-header fields a :class:`~hsip_tpu.video.PhotonVideo`
exposes through its ``metadata`` property. Behavior parity target: reference
``src/photron/metadata.py`` (category sets, minimal/full/for_processing
presets, whitelist filtering).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Set

__all__ = ["MetadataConfig", "FIELD_CATEGORIES"]

# Acquisition-header keys, grouped by how often a workflow needs them. Keys
# follow the Photron/pyMRAW naming convention.
FIELD_CATEGORIES: Dict[str, FrozenSet[str]] = {
    "essential": frozenset(
        ["Total Frame", "Image Width", "Image Height",
         "EffectiveBit Depth", "File Format"]
    ),
    "recording": frozenset(["Record Rate(fps)", "Shutter Speed(s)"]),
    "device": frozenset(["Camera Type", "Date"]),
    "extended": frozenset(
        ["Original Total Frame", "EffectiveBit Side", "Color Bit",
         "Comment Text"]
    ),
}


class MetadataConfig:
    """Whitelist over the acquisition-header dict.

    Example:
        >>> MetadataConfig.minimal()                       # essential only
        >>> MetadataConfig.full()                          # everything known
        >>> MetadataConfig.for_processing()                # essential + recording
        >>> MetadataConfig(fields={"Record Rate(fps)"})    # custom + essential
    """

    # Category aliases kept as class attributes for API familiarity.
    ESSENTIAL = FIELD_CATEGORIES["essential"]
    RECORDING = FIELD_CATEGORIES["recording"]
    DEVICE = FIELD_CATEGORIES["device"]
    EXTENDED = FIELD_CATEGORIES["extended"]
    ALL_FIELDS = frozenset().union(*FIELD_CATEGORIES.values())

    def __init__(
        self,
        fields: Optional[Set[str]] = None,
        include_essential: bool = True,
    ):
        selected: Set[str] = set(fields or ())
        if include_essential:
            selected |= self.ESSENTIAL
        self._fields = selected

    # -- presets ---------------------------------------------------------

    @classmethod
    def minimal(cls) -> "MetadataConfig":
        """Essential fields only."""
        return cls()

    @classmethod
    def full(cls) -> "MetadataConfig":
        """Every known field."""
        return cls(fields=set(cls.ALL_FIELDS))

    @classmethod
    def for_processing(cls) -> "MetadataConfig":
        """Essential + recording fields — the default for processing runs."""
        return cls(fields=set(cls.RECORDING))

    @classmethod
    def categories(cls, *names: str) -> "MetadataConfig":
        """Build from named categories ('essential', 'recording', ...)."""
        picked: Set[str] = set()
        for name in names:
            if name not in FIELD_CATEGORIES:
                raise ValueError(
                    f"Unknown metadata category {name!r}; "
                    f"expected one of {sorted(FIELD_CATEGORIES)}"
                )
            picked |= FIELD_CATEGORIES[name]
        return cls(fields=picked)

    # -- filtering ---------------------------------------------------------

    @property
    def fields(self) -> Set[str]:
        return set(self._fields)

    def should_include(self, field_name: str) -> bool:
        return field_name in self._fields

    def filter_metadata(self, raw_metadata: dict) -> dict:
        """Keep only whitelisted keys of the raw header dict."""
        keep = self._fields
        return {k: v for k, v in raw_metadata.items() if k in keep}

    def __repr__(self) -> str:
        return f"MetadataConfig(fields={sorted(self._fields)})"
