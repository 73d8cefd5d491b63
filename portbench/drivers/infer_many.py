"""Entry driver: ``ser_tpu_torch.parallel.batch_inference.infer_many``, one call a batch of files.

The library call of a batch job over a folder of recordings: the files are decoded on
host threads, encoded in batches, and each file's windows pooled, classified and
postprocessed. A file whose row carries an error failed; a call that raises fails all
its files.
"""

from __future__ import annotations

import time

from portbench.harness.driving import CallRecord


class Driver:
    def __init__(self, settings, config: dict, corpus, traffic: dict) -> None:
        from ser_tpu_torch.parallel.batch_inference import infer_many

        self._infer_many = infer_many
        self._settings = settings
        self._profile = config["profile"]
        self._paths = [str(p) for p in corpus.paths]
        self.per_call = traffic["call_files"]

    def call(self, indices: list[int]) -> CallRecord:
        started = time.perf_counter()
        try:
            rows = self._infer_many([self._paths[i] for i in indices], profile=self._profile, settings=self._settings)
        except Exception as err:  # noqa: BLE001 - a failed call is counted, not fatal
            return CallRecord(indices, started, time.perf_counter(), [None] * len(indices), error=repr(err))
        ended = time.perf_counter()
        return CallRecord(indices, started, ended, [row.result if row.error is None else None for row in rows],
                          error="; ".join(row.error for row in rows if row.error) or None)
