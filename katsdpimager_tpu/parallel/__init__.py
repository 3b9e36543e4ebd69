"""Multi-device scaling: mesh construction and channel/vis-sharded imaging.

The reference is single-GPU (SURVEY.md §2.3/§5.8); this subsystem is new
architecture: frequency channels map to a mesh axis (embarrassingly
parallel), visibility buckets within a channel map to a second axis with
psum grid reductions.
"""

from .mesh import make_mesh  # noqa: F401
from .multichannel import (  # noqa: F401
    MultiChannelConfig, make_imaging_step, make_example_batch,
)
