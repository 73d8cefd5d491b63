"""Whole tiny runs with the timed path broken underneath: each fault must read as not correct.

The faults an inference cell can have: a step that returns its state unchanged (an
encoder layer skipped), half of a batch left out (its files given the other half's
answers), an answer altered where it is produced (a frame's probabilities), and a pooling
that takes the mean over half the frames. The exchange between chips does not exist in
one-chip cells.
"""

from __future__ import annotations

import dataclasses
import time

import pytest

from portbench.harness import runner


def _skip_first_layer(monkeypatch, family):
    if family == "whisper":
        from ser_tpu_torch.models import whisper as module

        block, original = module.EncoderBlock, module.EncoderBlock.forward
    else:
        from ser_tpu_torch.models import wav2vec2 as module

        block, original = module.TransformerLayer, module.TransformerLayer.forward
    calls = []

    def forward(self, x, *args, **kwargs):
        calls.append(1)
        return x if len(calls) % 2 == 1 else original(self, x, *args, **kwargs)

    monkeypatch.setattr(block, "forward", forward)


def _half_batch_left_out(monkeypatch, family):
    from ser_tpu_torch.parallel import batch_inference

    original = batch_inference._indexed_rows

    def rows(indexed_paths, *args, **kwargs):
        half = len(indexed_paths) // 2 or 1
        kept = original(indexed_paths[:half], *args, **kwargs)
        return kept + [(index, dataclasses.replace(kept[0][1], file_path=path)) for index, path in indexed_paths[half:]]

    monkeypatch.setattr(batch_inference, "_indexed_rows", rows)


def _answer_altered(monkeypatch, family):
    from ser_tpu_torch._internal.runtime import profile_execution

    original = profile_execution.predict_frames

    def predict(*args, **kwargs):
        labels, confidences, probabilities = original(*args, **kwargs)
        first = dict(probabilities[0])
        low, high = min(first, key=first.get), max(first, key=first.get)
        first[low], first[high] = first[high], first[low]
        return [low] + labels[1:], confidences, [first] + probabilities[1:]

    monkeypatch.setattr(profile_execution, "predict_frames", predict)


def _half_the_frames_pooled(monkeypatch, family):
    from ser_tpu_torch._internal.repr.backend import EncodedSequence
    from ser_tpu_torch._internal.runtime import profile_execution

    original = profile_execution.mean_std_pool

    def pool(encoded, windows):
        kept = slice(0, None, 2)
        thinned = EncodedSequence(embeddings=encoded.embeddings[kept],
                                  frame_start_seconds=encoded.frame_start_seconds[kept],
                                  frame_end_seconds=encoded.frame_end_seconds[kept], backend_id=encoded.backend_id)
        return original(thinned, windows)

    monkeypatch.setattr(profile_execution, "mean_std_pool", pool)


FAULTS = {"layer_skipped": _skip_first_layer, "half_batch_left_out": _half_batch_left_out,
          "answer_altered": _answer_altered, "half_the_frames_pooled": _half_the_frames_pooled}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", ["large-v3.long-files", "xlsr-300m.mixed-files"])
def test_fault_is_not_correct(tiny_cell, benchmark, monkeypatch, name, fault):
    cell = tiny_cell(name, files=4)
    FAULTS[fault](monkeypatch, cell.config["family"])
    result, lines, readings = runner.run(cell, 2**36 + 5, 0.5, False, started=time.perf_counter(), device="cpu",
                                         benchmark=benchmark)
    assert not result["correct"], (fault, readings)
