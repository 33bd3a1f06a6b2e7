"""Storage tier of the port (counterpart of ``repro/storage``): artifacts,
delta pagers, simulated links and progressive delivery."""
from .artifact import (Artifact, ArtifactError, load_store, open_artifact,
                       save_artifact)
from .pager import (CorruptStreamError, DeltaPager, FilePager, InMemoryPager,
                    LinkBudget, PagerError, ThrottledPager, TransientPagerError,
                    VirtualClock, WallClock)

__all__ = ["Artifact", "ArtifactError", "CorruptStreamError", "DeltaPager",
           "FilePager", "InMemoryPager", "LinkBudget", "PagerError",
           "ThrottledPager", "TransientPagerError", "VirtualClock", "WallClock",
           "load_store", "open_artifact", "save_artifact"]
