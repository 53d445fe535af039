"""Asset cache: keeps prefiltered facet splines (device arrays) alive
across streamed jobs.

Same life-cycle as the reference's asset_handler_t
(environment.h:84-227): assets found by key stay active; `cycle()`
moves the active set to limbo; a `find` revives limbo entries; anything
still in limbo at the next `cycle()` is dropped (device memory freed).
Keys are the facet's asset_key (filename + mask suffixes,
envutil_main.cc:895-903) plus the spline parameterization, since a
different degree needs different coefficients.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class AssetCache:
    def __init__(self):
        self._active: Dict[Any, Any] = {}
        self._limbo: Dict[Any, Any] = {}

    def find(self, key) -> Optional[Any]:
        if key in self._limbo:
            self._active[key] = self._limbo.pop(key)
        return self._active.get(key)

    def add(self, key, value) -> None:
        self._active[key] = value

    def remove(self, key) -> None:
        self._active.pop(key, None)
        self._limbo.pop(key, None)

    def cycle(self) -> None:
        """Drop limbo, demote active (environment.h:196-212)."""
        self._limbo = self._active
        self._active = {}

    def clear(self) -> None:
        self._active.clear()
        self._limbo.clear()


# the process-wide cache (like the reference's static asset_handler)
cache = AssetCache()


def conclude_cycle() -> None:
    cache.cycle()
