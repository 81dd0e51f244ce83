"""Process groups, coordinator-only IO and tracing (``dist.py``,
``profiling.py``)."""
