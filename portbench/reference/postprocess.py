"""Plain reference of the frame → segment postprocessing, read to judge the program's segments.

The published rules of the system's timeline (smoothing, hysteresis, segment assembly,
short-segment merge, same-label merge), applied to the frames the program returned: the
segments it returned must be exactly these.
"""

from __future__ import annotations

from collections import Counter
from statistics import fmean


def _smooth(labels: list[str], window: int) -> list[str]:
    """Centered majority vote; a tie keeps the current label, then the previous output, then the
    lexically smallest."""
    if window <= 1:
        return list(labels)
    radius, out = window // 2, []
    for i, label in enumerate(labels):
        counts = Counter(labels[max(0, i - radius) : i + radius + 1])
        top = max(counts.values())
        candidates = [item for item, count in counts.items() if count == top]
        if label in candidates:
            out.append(label)
            continue
        previous = out[-1] if out else labels[0]
        out.append(previous if previous in candidates else sorted(candidates)[0])
    return out


def _hysteresis(labels: list[str], confidences: list[float], enter: float, leave: float) -> list[str]:
    """A switch needs the candidate at or above ``enter`` and the incumbent at or below ``leave``
    or no more confident than the candidate."""
    if enter <= 0.0 and leave <= 0.0:
        return list(labels)
    incumbent, held, out = labels[0], confidences[0], [labels[0]]
    for candidate, confidence in zip(labels[1:], confidences[1:]):
        if candidate == incumbent:
            held = confidence
        elif confidence >= enter and (held <= leave or confidence >= held):
            incumbent, held = candidate, confidence
        out.append(incumbent)
    return out


def _mean_maps(maps: list[dict]) -> dict:
    labels = sorted({label for item in maps for label in item})
    return {label: float(fmean(float(item.get(label, 0.0)) for item in maps)) for label in labels}


def _duration(segment: dict) -> float:
    return max(0.0, float(segment["end"]) - float(segment["start"]))


def _merge_into(target: dict, source: dict) -> dict:
    a, b = _duration(target), _duration(source)
    total = a + b
    confidence = (float(fmean([target["confidence"], source["confidence"]])) if total <= 0.0
                  else (target["confidence"] * a + source["confidence"] * b) / total)
    wa, wb = max(a, 1e-12), max(b, 1e-12)
    labels = sorted(set(target["probabilities"]) | set(source["probabilities"]))
    probabilities = {
        label: float((target["probabilities"].get(label, 0.0) * wa + source["probabilities"].get(label, 0.0) * wb)
                     / (wa + wb))
        for label in labels
    }
    return {"emotion": target["emotion"], "start": min(target["start"], source["start"]),
            "end": max(target["end"], source["end"]), "confidence": float(confidence),
            "probabilities": probabilities}


def segments(frames: list[dict], runtime: dict) -> list[dict]:
    """Segments of ``frames`` (each: start, end, emotion, confidence, probabilities)."""
    if not frames:
        return []
    labels = _smooth([f["emotion"] for f in frames], runtime["post_smoothing_window_frames"])
    labels = _hysteresis(labels, [float(f["confidence"]) for f in frames],
                         runtime["post_hysteresis_enter_confidence"], runtime["post_hysteresis_exit_confidence"])
    cuts = [0] + [i for i in range(1, len(labels)) if labels[i] != labels[i - 1]] + [len(labels)]
    built = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        run = frames[lo:hi]
        built.append({"emotion": labels[lo], "start": float(run[0]["start"]), "end": float(run[-1]["end"]),
                      "confidence": float(fmean(f["confidence"] for f in run)),
                      "probabilities": _mean_maps([f["probabilities"] for f in run])})
    shortest = runtime["post_min_segment_duration_seconds"]
    if shortest > 0.0 and len(built) > 1:
        index = 0
        while index < len(built) and len(built) > 1:
            if _duration(built[index]) >= shortest:
                index += 1
                continue
            if index == 0:
                target = 1
            elif index == len(built) - 1:
                target = index - 1
            else:
                target = index - 1 if built[index - 1]["confidence"] >= built[index + 1]["confidence"] else index + 1
            built[target] = _merge_into(built[target], built[index])
            del built[index]
            index = max(0, target) if target < index else max(0, target - 1)
    merged = [built[0]]
    for segment in built[1:]:
        if segment["emotion"] != merged[-1]["emotion"]:
            merged.append(segment)
        else:
            merged[-1] = _merge_into(merged[-1], segment)
    return merged
