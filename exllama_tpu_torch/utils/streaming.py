"""Streaming detokenization helpers for the generators (a copy of
exllama_tpu/utils/streaming.py: the port imports nothing of the JAX
package).

The core primitive is the *withhold split*: given the text produced so far
plus a fresh chunk, split it into an unambiguous front (safe to emit now)
and the shortest tail that could still grow into a stop string (held back).
This streams the maximum prefix at once, while a stop string never leaks to
the consumer.
"""

from __future__ import annotations


def split_on_stop_strings(
    text: str, stops, fold_case: bool = False
) -> "tuple[str, str, bool]":
    """Split ``text`` -> ``(safe, held, matched)``.

    ``matched`` True: a full stop string occurs in ``text``; ``safe`` is
    everything before the earliest occurrence (generation should end,
    nothing is held). Otherwise ``held`` is the shortest suffix that is a
    prefix of some stop string (possibly empty) and ``safe`` the rest.
    ``fold_case`` matches case-insensitively (the serving engine's
    convention; the generators match exactly).
    """
    if not stops:
        return text, "", False
    hay = text.lower() if fold_case else text
    needles = [s.lower() if fold_case else s for s in stops]

    earliest = -1
    for n in needles:
        i = hay.find(n)
        if i >= 0 and (earliest < 0 or i < earliest):
            earliest = i
    if earliest >= 0:
        return text[:earliest], "", True

    for cut in range(len(text)):
        tail = hay[cut:]
        if any(n.startswith(tail) for n in needles):
            return text[:cut], text[cut:], False
    return text, "", False
