"""Route tuning: the cache format (see `cache.py`)."""
