"""The kernel wrappers' launch counters.

Each wrapper module keeps a ``launches`` table, one count a kernel, and
adds one where it launches its kernel (``count``). A CUDA graph's
capture runs the wrappers but launches nothing, and its replays launch
without running them. So a capture is made inside ``tally(launched=False)``:
the counts of this thread go to the tally and not to the tables, and
whoever replays the graph adds the tally once a replay (``Tally.add``).
Tallies are per thread, so a capture on one thread never sees another
thread's launches.
"""

from __future__ import annotations

import collections
import contextlib
import threading

_local = threading.local()


class Tally:
    """The counts one thread made inside ``tally()``: kernel name by
    launch table."""

    def __init__(self, launched: bool):
        #: whether the counted calls launched (else they were captured)
        self.launched = launched
        self.seen: collections.Counter = collections.Counter()
        self._tables: dict[int, dict] = {}

    def note(self, table: dict, name: str) -> None:
        self.seen[id(table), name] += 1
        self._tables[id(table)] = table

    def add(self, times: int = 1) -> None:
        """Add the tally `times` over to the launch tables."""
        for (key, name), n in self.seen.items():
            self._tables[key][name] += n * times

    def by_name(self) -> dict[str, int]:
        return {name: n for (_, name), n in self.seen.items()}

    def __eq__(self, other) -> bool:
        return isinstance(other, Tally) and self.seen == other.seen


def count(table: dict, name: str) -> None:
    """One launch of kernel `name` in its module's table (a captured call
    only notes it in the open tallies)."""
    stack = getattr(_local, "stack", [])
    for t in stack:
        t.note(table, name)
    if all(t.launched for t in stack):
        table[name] += 1


@contextlib.contextmanager
def tally(launched: bool = True):
    """Collect this thread's counts in the yielded Tally; with
    launched=False they stay out of the tables (a graph's capture)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    t = Tally(launched)
    stack.append(t)
    try:
        yield t
    finally:
        stack.remove(t)
