"""Replay chip_smoke.py's train_emb_cache id stream through the hot-row
cache's bookkeeping on the CPU, at full size: the same zipf windows (the
smoke's seed and `_dlrm_batch`), the same order of prefetch and
prepare_feed, a 1-wide table (hits, misses and evictions do not depend on
the width). Prints the steady hit rate over the timed windows beside the
zipf coverage of the slab, the evictions and the flush bytes a step at the
smoke's width. These are the counts the card run should show; no time.

    python tests/torch_emb_cache_replay.py
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.parallel import emb_cache  # noqa: E402


def main():
    c = cs.DLRM
    rows = c["rows"]
    names = ["emb_table", "emb_table_moment1_0", "emb_table_moment2_0"]
    slab = emb_cache.rows_for_budget(cs.EMB_BUDGET, c["dim"], 4, len(names))
    t = emb_cache._CachedTable("emb_table", rows, 1, slab, names, ["ids"])
    slabs = {n: torch.zeros(slab, 1) for n in names}
    for n in names:
        t.host[n] = torch.zeros(rows, 1)
    cache = emb_cache.EmbCache(None, [t], slabs.get)
    rng = np.random.default_rng(cs.SEED + 22)
    windows = cs.EMB_WARM_WINDOWS + cs.EMB_TIMED_WINDOWS
    batches = [cs._dlrm_batch(rng, rows, c["batch"], cs.EMB_ZIPF)
               for _ in range(windows * cs.EMB_WINDOW)]
    ids = [np.stack([b["ids"] for b in batches[w * cs.EMB_WINDOW:
                                               (w + 1) * cs.EMB_WINDOW]])
           for w in range(windows)]
    t0 = time.perf_counter()
    cache.prepare_feed({"ids": ids[0]})
    steady = None
    for w in range(windows):
        if w + 1 < windows:
            cache.prefetch({"ids": np.unique(ids[w + 1])}).wait()
            cache.prepare_feed({"ids": ids[w + 1]})
        if w + 1 == cs.EMB_WARM_WINDOWS:
            steady = cache.stats()
    s = cache.stats()
    hits, misses = s["hits"] - steady["hits"], s["misses"] - steady["misses"]
    evicted = s["evictions"] - steady["evictions"]
    steps = cs.EMB_TIMED_WINDOWS * cs.EMB_WINDOW
    flush = (s["flush_bytes"] - steady["flush_bytes"]) * c["dim"] / steps
    print(f"slab {slab} rows of {rows}; steady hit rate {hits / (hits + misses):.4f}"
          f" (zipf coverage {cs._zipf_coverage(cs.EMB_ZIPF, rows, slab):.4f});"
          f" {evicted / cs.EMB_TIMED_WINDOWS:.0f} evictions a timed window;"
          f" flush {flush:.0f} bytes a step at width {c['dim']};"
          f" {time.perf_counter() - t0:.1f} s of bookkeeping on this host")


if __name__ == "__main__":
    main()
