"""Delta-stream storage tier of the port (counterpart of ``repro/storage``)."""
from .pager import (CorruptStreamError, DeltaPager, InMemoryPager, PagerError,
                    TransientPagerError)

__all__ = ["CorruptStreamError", "DeltaPager", "InMemoryPager", "PagerError",
           "TransientPagerError"]
