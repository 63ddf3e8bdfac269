"""Host->device input streaming with double buffering.

The reference reads one column at a time from text files
(rrtmg_lw.1col.f90:447); the GCM mode receives arrays by argument.  At
device scale the input pipeline must overlap H2D copies with compute:
``prefetch`` keeps ``depth`` batches in flight on a background
transfer thread, so the radiation step never waits on PCIe.

The transfers run on a dedicated thread rather than relying on
``jax.device_put`` being asynchronous: device_put releases the GIL
during the copy, so the overlap holds even on transports where the
put blocks until the bytes land.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import jax

from .mesh import shardings_for

_STOP = object()


def prefetch(batches: Iterable, mesh, depth: int = 2,
             sharding=None) -> Iterator:
    """Yield device-resident batches, keeping ``depth`` transfers in
    flight ahead of the consumer on a background thread.  Shardings
    are layout-aware per sub-tree (compact cloud masks carry columns
    on their last axis — see mesh.shardings_for)."""
    if sharding is not None:
        put = lambda tree: jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sharding), tree)
    else:
        def put(tree):
            sh = shardings_for(tree, mesh)
            return jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, s), tree, sh)
    it = iter(batches)

    def feed():
        # only the worker thread touches the iterator, so generator
        # re-entrancy is never an issue
        try:
            nxt = next(it)
        except StopIteration:
            return _STOP
        return put(nxt)

    ex = ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="rrtmg-prefetch")
    try:
        queue = collections.deque(ex.submit(feed) for _ in range(depth))
        while queue:
            ready = queue.popleft().result()
            if ready is _STOP:
                break            # FIFO: everything behind is _STOP too
            queue.append(ex.submit(feed))
            yield ready
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def run_epoch(step_fn: Callable, batches: Iterable, mesh,
              depth: int = 2, callback: Optional[Callable] = None):
    """Drive step_fn over a stream of host batches with prefetch."""
    out = None
    for dev_batch in prefetch(batches, mesh, depth=depth):
        # splat only plain tuples: NamedTuple batches (Atmosphere,
        # cloud pytrees) are single arguments
        splat = (isinstance(dev_batch, tuple)
                 and not hasattr(dev_batch, "_fields"))
        out = step_fn(*dev_batch) if splat else step_fn(dev_batch)
        if callback is not None:
            callback(out)
    return out
