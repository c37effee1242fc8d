"""Host-side data pipeline of the port: the prefetching loader and the
LM families' synthetic token data (``tokens``)."""
from .loader import PrefetchLoader

__all__ = ["PrefetchLoader"]
