from .model import (
    ChipTopology,
    SliceCandidate,
    SliceScore,
    format_shape,
    pad3,
    parse_shape,
    shape_size,
)

__all__ = [
    "ChipTopology",
    "SliceCandidate",
    "SliceScore",
    "format_shape",
    "pad3",
    "parse_shape",
    "shape_size",
]
