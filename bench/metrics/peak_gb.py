"""Device memory the process held at most during the window: the caching
allocator's reserved bytes, counted from what the window's state holds
(set-up's cached blocks are returned first).  They hold the captured CUDA
graphs' pools, which a replay never allocates, so allocated bytes leave
them out."""

from bench.lib.readings import peak_gb as read  # noqa: F401
