"""Speculative decode drafting: deterministic CPU-runnable proposal models.

A drafter proposes the next few tokens of a sequence from information that is
already on the host — no extra model forward, no accelerator round-trip. The
engine then *verifies* the proposals in one batched multi-token step through
the prefill-mode paged-attention op (DESIGN.md §7): every accepted proposal
replaces a whole decode step, i.e. a full batched KV read across memory
domains — the dominant Eq.-1 serving cost BWAP balances.

Correctness contract: drafters only ever *propose*; the engine accepts a
proposal exactly when it equals the model's own greedy argmax at that
position. Output tokens are therefore identical to plain greedy decoding for
any drafter (``tests/test_spec_decode.py`` pins this), and a drafter's
quality only moves the acceptance rate / steps saved, never the text.

``PromptLookupDrafter`` is prompt-lookup / n-gram self-drafting: find the
most recent earlier occurrence of the sequence's trailing n-gram and propose
its historical continuation. Repetitive contexts — templated prompts,
code, the copy-heavy tails LLM serving traces are full of — make this
drafter accept at high rates for zero model cost.
"""

from __future__ import annotations

from typing import Sequence


class Drafter:
    """Interface: ``draft(tokens)`` -> proposed continuation (possibly
    empty), at most ``max_tokens`` long, deterministic in ``tokens``."""

    max_tokens: int = 0

    def draft(self, tokens: Sequence[int]) -> list[int]:
        raise NotImplementedError


class PromptLookupDrafter(Drafter):
    """N-gram self-drafting over the sequence's own history (prompt +
    generated tokens).

    Longest-match-first: try the trailing ``max_ngram``-gram, fall back to
    shorter n-grams down to ``min_ngram``; within one n, the *most recent*
    earlier occurrence wins (recency tracks the local pattern — loops,
    templates — better than the first occurrence). Proposes the tokens that
    historically followed the match, capped at ``max_tokens``.
    """

    def __init__(self, max_tokens: int = 4, max_ngram: int = 3,
                 min_ngram: int = 1, max_scan: int = 512):
        assert max_tokens >= 1 and 1 <= min_ngram <= max_ngram
        assert max_scan >= 1
        self.max_tokens = max_tokens
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        # backward-scan window: drafting runs on the decode hot path every
        # step, so an unbounded scan of a long history would be O(n) per
        # call with nothing to show for it on non-repetitive text — local
        # patterns (runs, cycles, templates) live near the tail anyway
        self.max_scan = max_scan

    def draft(self, tokens: Sequence[int]) -> list[int]:
        n_tok = len(tokens)
        k = self.max_tokens
        scan_lo = max(0, n_tok - self.max_scan)
        for n in range(min(self.max_ngram, n_tok - 1), self.min_ngram - 1,
                       -1):
            tail = tuple(tokens[n_tok - n:])
            # rightmost j with tokens[j:j+n] == tail; j == n_tok - n is the
            # trivial self-match
            for j in range(n_tok - n - 1, scan_lo - 1, -1):
                if tuple(tokens[j:j + n]) == tail:
                    # unroll from the match: position n_tok + m predicts
                    # tokens[j + n + m], reading back into just-predicted
                    # tokens once the continuation runs past the end of
                    # history — a constant run or short cycle extends to
                    # the full draft depth instead of stopping where the
                    # recorded continuation does
                    ext = list(tokens)
                    src = j + n
                    for _ in range(k):
                        ext.append(ext[src])
                        src += 1
                    return [int(t) for t in ext[n_tok:]]
        return []
