"""Incremental facet updates.

The facet -> subgrid map is linear in the facets, so a K-of-J facet
update costs ~K/J of a streamed forward plus a patch of the recorded
subgrid stream — this package is that update path (the port of the JAX
package's ``swiftly_tpu.delta``):

* `ledger.FacetDeltaLedger` — content-hashed facet-stack versioning;
  the monotone ``stream_version`` it stamps into the spill cache is
  what invalidates stale feeds;
* `engine.IncrementalForward` — record once, then ``update()`` streams
  only the changed facets' deltas and patches the cached stream
  (falling back to a full re-record on any patch failure, and under
  ``SWIFTLY_DELTA_EXACT=1``).

`plan.plan_delta` prices the break-even.
"""

from .engine import IncrementalForward, facet_delta
from .ledger import FacetDeltaLedger, config_hash, facet_hash

__all__ = [
    "FacetDeltaLedger",
    "IncrementalForward",
    "config_hash",
    "facet_delta",
    "facet_hash",
]
