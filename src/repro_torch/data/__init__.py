"""Host-side data pipeline of the port: the prefetching loader."""
from .loader import PrefetchLoader

__all__ = ["PrefetchLoader"]
