"""Entry driver: ``ser_tpu_torch.api.infer``, one request a file, transcript off.

The library or command-line user with one recording: the whole pipeline (settings,
the profile's boundary, the emotion pass, the timeline) runs per request. The
request's phase timings (``InferenceExecution.phase_timings_seconds``) are kept for the
per-layer metrics. The timeline it prints goes to standard error with the rest of the
program's output.
"""

from __future__ import annotations

import time

from portbench.harness.driving import CallRecord


class Driver:
    per_call = 1

    def __init__(self, settings, config: dict, corpus, traffic: dict) -> None:
        from ser_tpu_torch import api

        self._api = api
        self._settings = settings
        self._profile = config["profile"]
        self._paths = [str(p) for p in corpus.paths]

    def call(self, indices: list[int]) -> CallRecord:
        (index,) = indices
        started = time.perf_counter()
        try:
            execution = self._api.infer(self._paths[index], profile=self._profile, include_transcript=False,
                                        settings=self._settings)
        except Exception as err:  # noqa: BLE001 - a failed request is counted, not fatal
            return CallRecord(indices, started, time.perf_counter(), [None], error=repr(err))
        ended = time.perf_counter()
        return CallRecord(indices, started, ended, [execution.detailed_result],
                          phases=dict(execution.phase_timings_seconds))
