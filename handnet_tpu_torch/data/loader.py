"""Host-side prefetching data loader.

The port's copy of ``handnet_tpu/data/loader.py``:

* deterministic per-epoch shuffling (seeded),
* per-host sharding (``shard_id``/``num_shards``, the DistributedSampler
  equivalent),
* a thread pool decoding samples ahead of the consumer (the num_workers
  equivalent),
* batch collation to stacked numpy arrays; ``device_put`` (optional)
  runs on each batch in the producer thread, so that a caller can pin or
  copy it there.

It yields numpy batches (or what ``device_put`` makes of them), with no
sharding over devices.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


def collate_stack(samples: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Stack same-shape sample dicts into batch arrays."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class PrefetchLoader:
    """Iterable over batches of an indexable source.

    Args:
      source: indexable dataset returning dict[str, np.ndarray].
      batch_size: per-host batch size.
      shuffle: reshuffle each epoch (seeded, epoch-dependent).
      num_workers: decode threads.
      prefetch: batches to keep in flight.
      shard_id / num_shards: this host's slice (DistributedSampler equiv).
      drop_last: drop the ragged final batch (required for fixed shapes).
      device_put: optional fn(batch) -> batch, run in the producer thread.
    """

    def __init__(self, source, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, prefetch: int = 2,
                 shard_id: int = 0, num_shards: int = 1,
                 drop_last: bool = True, seed: int = 0,
                 collate: Callable = collate_stack,
                 device_put: Optional[Callable] = None):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.seed = seed
        self.collate = collate
        self.device_put = device_put
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.source)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # pad so every shard sees the same count (DistributedSampler behavior)
        per_shard = -(-n // self.num_shards)
        padded = np.resize(idx, per_shard * self.num_shards)
        return padded[self.shard_id::self.num_shards]

    def __len__(self) -> int:
        per_shard = len(self._indices())
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        n_batches = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out_q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    futures = [pool.submit(self.source.__getitem__, int(i))
                               for i in batch_idx]
                    samples = [f.result() for f in futures]
                    batch = self.collate(samples)
                    if self.device_put is not None:
                        batch = self.device_put(batch)
                    out_q.put(batch)
                out_q.put(None)
            except Exception as e:  # propagate to consumer
                out_q.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)
