"""Self-speculative drafting: propose the next tokens from the request's
OWN token history, with no draft model (counterpart of
``mxnet_tpu/serve/speculate.py``, numpy, the same functions line for line).

The draft source is n-gram prompt lookup: find the most recent earlier
occurrence of the history's longest suffix n-gram and copy the tokens that
followed it. The engine's verify step
(``models/generation.spec_verify_tokens``) recomputes the exact token the
non-speculative path would emit at every drafted position, so a wrong
draft costs verify compute, never correctness. Both functions are
deterministic in their inputs: token exactness rests on it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as onp

__all__ = ["draft_from_history", "constrain_draft"]


def draft_from_history(history: Sequence[int], n_draft: int,
                       window: int) -> List[int]:
    """Propose ``n_draft`` continuation tokens for ``history`` (prompt +
    generated so far, last element = the current token) by n-gram lookup:
    try suffix n-grams from ``min(window, len-1)`` down to 1, and for the
    longest one that re-occurs earlier in the history, copy the tokens
    that followed its most recent earlier occurrence.

    Always returns exactly ``n_draft`` tokens — when the matched
    continuation is short (or nothing matches) the tail repeats the last
    known token, a cheap guess that greedy loops frequently accept and
    that the exact verify step discards otherwise. Deterministic in
    ``history`` (the token-exactness contract needs a draft source with
    no hidden state)."""
    n_draft = int(n_draft)
    if n_draft <= 0:
        return []
    h = onp.asarray(history, dtype=onp.int64)
    hl = h.size
    cont: List[int] = []
    # every suffix n-gram ends with the current token, so its earlier
    # occurrences can only END where that token re-occurs — one O(len)
    # pass finds the candidates, and each n-gram length verifies only
    # those rows (vectorized gather-compare)
    ends = onp.nonzero(h[:hl - 1] == h[hl - 1])[0] if hl else \
        onp.zeros(0, onp.int64)
    if ends.size:
        for n in range(min(int(window), hl - 1), 0, -1):
            starts = ends - (n - 1)
            starts = starts[starts >= 0]
            if not starts.size:
                continue
            suffix = h[hl - n:]
            gat = h[starts[:, None] + onp.arange(n)]
            ok = onp.nonzero((gat == suffix).all(axis=1))[0]
            if ok.size:
                i = int(starts[ok[-1]])     # most recent earlier match
                cont = h[i + n:i + n + n_draft].tolist()
                if cont:
                    break
    if not cont:
        cont = [int(h[-1])] if hl else [0]
    while len(cont) < n_draft:
        cont.append(cont[-1])
    return cont[:n_draft]


def constrain_draft(draft: Sequence[int], grammar, state: int
                    ) -> Tuple[List[int], List[int], int]:
    """Walk ``draft`` through the grammar automaton from ``state`` and
    rewrite it grammar-alive: the first forbidden token (and everything
    after it — the verify discards past a mismatch anyway) is replaced by
    the lowest legal token of the state reached, so every draft position
    has a well-defined automaton state and the per-position verify masks
    exist. On conformant traffic the lookup drafts are already legal and
    pass through untouched — acceptance never drops below the
    unconstrained baseline because a forbidden draft would have been
    REJECTED by the masked verify regardless; rewriting it merely gives
    the slot a chance at a bonus accept.

    Returns ``(draft', states, rejected)``: the rewritten draft, the
    automaton state BEFORE each draft position (``len(draft) + 1``
    entries — index 0 is ``state``, the verify's t0 column), and how many
    tokens were rewritten.
    States park (stay put) once only EOS remains legal — those tail
    positions mask to EOS-only, exactly the sequential constrained
    path's behavior."""
    states = [int(state)]
    out: List[int] = []
    rejected = 0
    q = int(state)
    for tok in draft:
        tok = int(tok)
        nq = grammar.advance(q, tok)
        if nq < 0:
            rejected += 1
            alt = grammar.first_allowed(q)
            if alt >= 0:
                tok = alt
                nq = grammar.advance(q, alt)
            else:
                # only EOS continues: park (the mask allows EOS alone)
                tok = draft[0] if not out else out[-1]
                nq = q
        out.append(tok)
        q = int(nq)
        states.append(q)
    return out, states, rejected
