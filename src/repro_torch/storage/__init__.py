"""Storage tier of the port (counterpart of ``repro/storage``): artifacts,
delta pagers, simulated links, progressive delivery and the fault tier."""
from .artifact import (Artifact, ArtifactError, load_store, open_artifact,
                       save_artifact)
from .pager import (ChaosPager, CorruptStreamError, DeltaPager, FilePager, InMemoryPager,
                    LinkBudget, Outage, PagerError, ResilientPager, RetryPolicy,
                    StreamHealth, ThrottledPager, TransientPagerError, VirtualClock,
                    WallClock)

__all__ = ["Artifact", "ArtifactError", "ChaosPager", "CorruptStreamError", "DeltaPager",
           "FilePager", "InMemoryPager", "LinkBudget", "Outage", "PagerError",
           "ResilientPager", "RetryPolicy", "StreamHealth", "ThrottledPager",
           "TransientPagerError", "VirtualClock", "WallClock", "load_store",
           "open_artifact", "save_artifact"]
