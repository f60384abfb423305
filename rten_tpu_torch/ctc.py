"""CTC decoding: greedy and prefix beam search over a [seq, classes]
(log-)probability matrix; class 0 is the blank label.

A numpy copy of ``rten_tpu/ctc.py`` (reference: src/ctc.rs,
CtcDecoder::decode_greedy :139, decode_beam :170, decode_beam_nbest :211,
CtcHypothesis :89), so that the port turns a model's CTC logits (for
example ``models.wav2vec2.ctc_logits``, copied to the host) into text
without the JAX package. ``decode_beam`` runs the native library's prefix
beam search (``rten_tpu_torch.native``) as the JAX package does, and the
Python one only where the library is not available (no C++ compiler).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

BLANK = 0


@dataclasses.dataclass
class CtcHypothesis:
    """A decoded label sequence with its (log-domain) score."""

    steps: list[tuple[int, int]]  # (label, time_step of first emission)
    log_prob: float

    @property
    def labels(self) -> list[int]:
        return [l for l, _ in self.steps]

    def text(self, alphabet: str) -> str:
        """Map labels to characters; label i ↦ alphabet[i-1] (0 is blank),
        matching the reference's alphabet convention."""
        return "".join(alphabet[l - 1] for l in self.labels if 0 < l <= len(alphabet))


class CtcDecoder:
    def __init__(self, blank: int = BLANK):
        self.blank = blank

    def _log_probs(self, probs: np.ndarray) -> np.ndarray:
        probs = np.asarray(probs, dtype=np.float64)
        if probs.size and probs.max() <= 0.0:
            return probs  # already log-domain
        with np.errstate(divide="ignore"):
            return np.log(probs)

    def decode_greedy(self, probs: np.ndarray) -> CtcHypothesis:
        """Best-path decoding: per-step argmax, collapse repeats, drop blanks
        (reference: ctc.rs:139)."""
        lp = self._log_probs(probs)
        best = np.argmax(lp, axis=1)
        score = float(lp[np.arange(len(best)), best].sum())
        steps: list[tuple[int, int]] = []
        prev = self.blank
        for t, label in enumerate(best):
            label = int(label)
            if label != self.blank and label != prev:
                steps.append((label, t))
            prev = label
        return CtcHypothesis(steps, score)

    def decode_beam(self, probs: np.ndarray, beam_size: int = 10) -> CtcHypothesis:
        """The best hypothesis of the prefix beam search: the native
        library's, else ``decode_beam_nbest``'s."""
        from rten_tpu_torch.native.bindings import ctc_beam_search_native

        lp = self._log_probs(probs)
        native = ctc_beam_search_native(lp.astype(np.float32), beam_size, self.blank)
        if native is not None:
            labels, times, score = native
            return CtcHypothesis(list(zip(labels, times)), score)
        return self.decode_beam_nbest(probs, beam_size, 1)[0]

    def decode_beam_nbest(
        self, probs: np.ndarray, beam_size: int = 10, n_best: int = 1
    ) -> list[CtcHypothesis]:
        """Prefix beam search (reference: ctc.rs:170-211): tracks per-prefix
        probability split into blank-ending / non-blank-ending mass."""
        lp = self._log_probs(probs)
        n_steps, n_classes = lp.shape

        # Prefixes are keyed on the LABEL sequence only — paths that emit the
        # same labels at different times are the same hypothesis and their
        # probability mass must be summed. First-emission timestamps ride
        # along as metadata. State: labels → [p_blank, p_non_blank, times].
        beams: dict[tuple[int, ...], list] = {(): [0.0, -math.inf, ()]}

        for t in range(n_steps):
            next_beams: dict[tuple[int, ...], list] = {}

            def add(labels, pb, pnb, times):
                cur = next_beams.get(labels)
                if cur is None:
                    next_beams[labels] = [pb, pnb, times]
                else:
                    cur[0] = _logaddexp(cur[0], pb)
                    cur[1] = _logaddexp(cur[1], pnb)

            # Prune classes: consider only the top candidates this step.
            top = np.argsort(-lp[t])[: max(beam_size, 8)]
            for labels, (pb, pnb, times) in beams.items():
                total = _logaddexp(pb, pnb)
                for c in top:
                    c = int(c)
                    p = lp[t, c]
                    if p == -math.inf:
                        continue
                    if c == self.blank:
                        add(labels, total + p, -math.inf, times)
                    elif labels and labels[-1] == c:
                        # repeat: extends only after a blank
                        add(labels, -math.inf, pnb + p, times)
                        add(labels + (c,), -math.inf, pb + p, times + (t,))
                    else:
                        add(labels + (c,), -math.inf, total + p, times + (t,))

            ranked = sorted(
                next_beams.items(),
                key=lambda kv: -_logaddexp(kv[1][0], kv[1][1]),
            )
            beams = dict(ranked[:beam_size])

        out = [
            CtcHypothesis(list(zip(labels, times)), _logaddexp(pb, pnb))
            for labels, (pb, pnb, times) in beams.items()
        ]
        out.sort(key=lambda h: -h.log_prob)
        return out[:n_best]


def _logaddexp(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))
